"""K5 (the fused bf16-row decode MoE on K1's core) on the CPU:

* ``plan_k5`` at the hybrid's, V2-Lite's (int4 and int8) and the T = 8
  probe's shapes: stage 1's column tiles cover every w13 column once and
  pair gate column c with up column I + c; stage 2's ranks split each
  token's picks' packed w2 rows pick-major on whole steps that never
  straddle two picks, every (pick, row) once; both launches' shared memory
  within the card's 227 KB;
* ``moe_bf16_plain`` (K5's plain version, which the wrapper runs on the
  CPU) against JAX ``moe_gathered_pallas`` in interpret mode: int4 and int8,
  groups of 32 and 16, SwiGLU at T = 1 with a folded shared expert and
  GPT-OSS's clamped form at T = 2 with two picks of one expert, within 3e-2
  element by element (|Δ| ≤ 3e-2 · (|want| + rms(want)), as chip_smoke
  holds the kernel); the plain version without one pick must fail that
  limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.ops.moe_pallas import moe_gathered_pallas
from krasis_tpu.quant import random_qtensor as jrandom_qtensor
from krasis_tpu_torch.ops import moe_cuda, qmm_cuda
from krasis_tpu_torch.quant import QTensor

from torch_port_util import f32, t, tq

MAX_SMEM = 227 * 1024

# (T, k, H, I, bits, gs)
PLANS = {"hybrid": (1, 11, 2048, 512, 4, 128), "v2lite": (1, 8, 2048, 1408, 4, 128),
         "v2lite_q8": (1, 8, 2048, 1408, 8, 128), "probe_T8": (8, 6, 2048, 1408, 4, 128),
         "gs16_T4": (4, 6, 256, 128, 4, 16)}


def _stage1_columns(I: int, tile: int):
    """The global w13 columns of stage 1's column tile `tile`, in the
    order a CTA stages them (csrc/qmm.cu gcol): 64 gate columns, then their
    64 up columns."""
    n0 = tile * 64
    return list(range(n0, n0 + 64)) + list(range(I + n0, I + n0 + 64))


def _stage2_steps(plan: qmm_cuda.Plan, k: int, rows: int, z: int):
    """The (pick, first packed row) of each step of stage 2's rank z."""
    r0, r1 = plan.split_rows(k * rows)[z]
    return [(r // rows, r % rows) for r in range(r0, r1, plan.pk)]


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_k5_covers_every_column_and_pick_row(name):
    T, k, H, I, bits, gs = PLANS[name]
    plan = moe_cuda.plan_k5(T, k, H, I, bits, gs)
    s1, s2 = plan.w13, plan.w2
    # stage 1: K1's plan over the picks, 64 gate + 64 up columns a tile
    assert s1 == qmm_cuda.plan(1, H, 2 * I, bits, gs, picks=T * k)
    assert s1.grid == (I // 64, T * k, s1.ks)
    cols = [_stage1_columns(I, tile) for tile in range(s1.grid[0])]
    assert sorted(c for tile in cols for c in tile) == list(range(2 * I))
    for tile in cols:
        assert [u - gcol for gcol, u in zip(tile[:64], tile[64:])] == [I] * 64
    rows13 = H // 2 if bits == 4 else H
    ranges = s1.split_rows(rows13)
    assert ranges[0][0] == 0 and ranges[-1][1] == rows13
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    # stage 2: whole steps, pick-major, each (pick, packed row) once
    rows2 = I // 2 if bits == 4 else I
    assert s2.grid == (H // 128, T, s2.ks) and s2.unit == s2.pk and rows2 % s2.pk == 0
    assert 1 <= s2.ks <= 8 and s2.ks <= k * rows2 // s2.pk
    seen = []
    for z in range(s2.ks):
        steps = _stage2_steps(s2, k, rows2, z)
        assert steps and steps == sorted(steps)
        assert all(r0 + s2.pk <= rows2 for _, r0 in steps)
        seen += [(p, r0 + r) for p, r0 in steps for r in range(s2.pk)]
    assert seen == [(p, r) for p in range(k) for r in range(rows2)]
    assert all(0 < m <= MAX_SMEM for m in plan.smem)


def test_plan_k5_matches_k1_at_the_hybrid():
    """The hybrid's T = 1 call: stage 1 as K1 plans 11 picks' rows, stage 2
    at 16 column tiles in clusters of 8 over 22 128-row steps."""
    plan = moe_cuda.plan_k5(*PLANS["hybrid"])
    assert plan.w13.grid == (8, 11, 4) and plan.w13.pk == 64
    assert plan.w2.grid == (16, 1, 8) and plan.w2.pk == 128


def test_k5_refuses_odd_groups_and_uncut_widths():
    """K1's mma fragment shares a scale between a k pair: K5 takes even
    groups only, and its plan refuses widths its stages cannot cut."""
    def stack(e, k, n, gs):
        return QTensor(torch.zeros((e, k // 2, n), dtype=torch.int8),
                       torch.zeros((e, k // gs, n), dtype=torch.bfloat16), 4, gs)

    w2 = stack(2, 64, 384, 2)
    assert moe_cuda.supported(stack(2, 384, 128, 6), w2)
    assert not moe_cuda.supported(stack(2, 384, 128, 3), w2)     # groups of 3 rows
    with pytest.raises(ValueError):
        moe_cuda.plan_k5(1, 2, 128, 96, 4, 32)       # I not a multiple of 64
    assert moe_cuda.plan_k5(1, 2, 128, 64, 4, 64).w2.pk == 32


def _bf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def _close_ratio(got, want, tol=3e-2):
    diff = np.abs(got - want)
    return float((diff / (tol * (np.abs(want) + np.sqrt(np.mean(want ** 2))))).max())


# (T, form): SwiGLU at T = 1 with the folded shared expert (the last stack
# row, weight 1); GPT-OSS's clamped form at T = 2, token 1 picking token 0's
# first expert twice over
FORMS = {"swiglu_T1_shared": (1, False), "gpt_oss_T2_repeat": (2, True)}


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("gs", [32, 16])
@pytest.mark.parametrize("bits", [4, 8])
def test_moe_bf16_plain_matches_pallas(bits, gs, form):
    T, gpt_oss = FORMS[form]
    E, Hd, I, k = 9, 256, 128, 4
    rng = np.random.default_rng(200 + bits + gs + T)
    k13, k2 = jax.random.split(jax.random.PRNGKey(200 + bits + gs))
    mag = 0.03 if bits == 4 else 0.002
    w13 = jrandom_qtensor(k13, (E, Hd, 2 * I), bits, group_size=gs, scale_mag=mag)
    w2 = jrandom_qtensor(k2, (E, I, Hd), bits, group_size=gs, scale_mag=mag)
    x = _bf16(rng.standard_normal((T, Hd)) * (4.0 if gpt_oss else 0.5))
    routed = np.stack([rng.permutation(8)[:k - 1] for _ in range(T)])
    if T == 2:
        routed[1, 1] = routed[1, 0] = routed[0, 0]
    idx = np.concatenate([routed, np.full((T, 1), 8)], 1).astype(np.int32)
    wts = np.concatenate([rng.uniform(0.2, 0.8, (T, k - 1)), np.ones((T, 1))], 1)
    wts = wts.astype(np.float32)
    limit = 7.0 if gpt_oss else 0.0
    want = f32(moe_gathered_pallas(x, w13, w2, jnp.asarray(idx), jnp.asarray(wts),
                                   swiglu_limit=limit, gpt_oss=gpt_oss, interpret=True))
    args = (t(x), tq(w13), tq(w2), t(idx))
    got = moe_cuda.moe_bf16(*args, t(wts), limit, gpt_oss)
    assert got.dtype == torch.bfloat16 and got.shape == (T, Hd)
    assert _close_ratio(f32(got), want) <= 1.0
    dropped = wts.copy()
    dropped[:, -1] = 0.0                                  # the shared pick
    control = moe_cuda.moe_bf16_plain(*args, t(dropped), limit, gpt_oss)
    assert _close_ratio(f32(control), want) > 1.0
