"""The int8 grouped prefill form (K7a's path) on the CPU against the JAX
package:

* ``moe_prefill(activation="int8")`` against ``moe_prefill_pallas(...,
  activation="int8", interpret=True)`` for int4 and int8 stacks at groups of
  32 and 16, on 64- and 128-row plans, and under ``pick_valid``, on f32 rows
  of bf16 values (both quantize their bf16 rounding; the f32 output has no
  last bf16 rounding to flip). The limit, max|Δ| ≤ 1e-3 · max|want|, tells
  the int8 form from the bf16 one: the
  port takes the reference's int8 form wherever the reference's predicate
  (``gmm_a8_supported``: int4 / int8, K a whole number of groups) takes both
  stacks, groups of 16 included (ROADMAP C-3), where the bf16 form is ~1e-2
  away;
* ``tile_rows`` with int8 rows: 64 and 128 against the reference's
  ``tile_rows``, 256 and 512 refused;
* ``gmm_a8_plain`` (K7a's plain version) against JAX ``gmm_a8`` in
  interpret mode on tile-aligned rows at both heights, with a 64-column
  tail;
* the dispatch: a gs-16 call makes two ``gmm_a8`` calls and no bf16
  grouped call; ``expert_class.grouped_int8`` is the reference's predicate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.ops import gmm_pallas as jgp
from krasis_tpu.quant import random_qtensor as jrandom_qtensor
from krasis_tpu_torch.ops import expert_class, gmm_cuda
from krasis_tpu_torch.ops.moe_cuda import quantize_activations

from torch_port_util import f32, t, tq

E, H, I, K_TOP = 4, 256, 128, 2
# T of each plan height at E = 4, k = 2: choose_tm gives 128 rows once
# T·k ≥ 128·E
ROWS = {64: 40, 128: 256}


def _bf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def _stack(seed, e, k, n, bits, gs):
    return jrandom_qtensor(jax.random.PRNGKey(seed), (e, k, n), bits, group_size=gs,
                           scale_mag=0.03 if bits == 4 else 0.002)


def _case(seed, bits, gs, T, masked=False):
    rng = np.random.default_rng(seed)
    w13 = _stack(seed, E, H, 2 * I, bits, gs)
    w2 = _stack(seed + 1, E, I, H, bits, gs)
    x = _bf16(rng.standard_normal((T, H)) * 0.5).astype(jnp.float32)
    idx = np.stack([rng.permutation(E)[:K_TOP] for _ in range(T)]).astype(np.int32)
    wts = rng.uniform(0.1, 1.0, (T, K_TOP)).astype(np.float32)
    pv = None
    if masked:
        pv = np.ones((T, K_TOP), bool)
        pv[1, 0] = pv[5, 1] = False
        wts[1, 0] = wts[5, 1] = 0.0
    return w13, w2, x, idx, wts, pv


def _run(case, **kw):
    w13, w2, x, idx, wts, pv = case
    want = jgp.moe_prefill_pallas(x, w13, w2, jnp.asarray(idx), jnp.asarray(wts),
                                  pick_valid=None if pv is None else jnp.asarray(pv),
                                  interpret=True, activation="int8", **kw)
    got = gmm_cuda.moe_prefill(t(x), tq(w13), tq(w2), t(idx), t(wts),
                               pick_valid=None if pv is None else t(pv), activation="int8",
                               **kw)
    return f32(got), f32(want)


def _within(got, want, frac=1e-3):
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= frac * top, (err, top)


@pytest.mark.parametrize("tm", [64, 128])
@pytest.mark.parametrize("gs", [32, 16])
@pytest.mark.parametrize("bits", [4, 8])
def test_int8_prefill_matches_the_reference_int8_form(bits, gs, tm):
    T = ROWS[tm]
    case = _case(100 + bits + gs + tm, bits, gs, T)
    assert gmm_cuda.choose_tm(T * K_TOP, E) == tm
    assert jgp.gmm_a8_supported(case[0]) and jgp.gmm_a8_supported(case[1])
    got, want = _run(case)
    _within(got, want)


def test_int8_prefill_with_pick_valid():
    got, want = _run(_case(140, 4, 16, ROWS[64], masked=True))
    _within(got, want)


@pytest.mark.parametrize("tm", [64, 128])
def test_int8_tile_rows_match_the_reference(tm):
    got, want = _run(_case(150 + tm, 4, 32, ROWS[64]), tile_rows=tm)
    _within(got, want)


@pytest.mark.parametrize("tm", [256, 512])
def test_int8_tile_rows_past_128_are_refused(tm):
    w13, w2, x, idx, wts, _ = _case(160, 4, 32, 8)
    with pytest.raises(ValueError, match="S-4a"):
        gmm_cuda.moe_prefill(t(x), tq(w13), tq(w2), t(idx), t(wts), activation="int8",
                             tile_rows=tm)
    # the bf16 form keeps every height
    out = gmm_cuda.moe_prefill(t(x).to(torch.bfloat16), tq(w13), tq(w2), t(idx), t(wts),
                               tile_rows=tm)
    assert out.shape == (8, H)


@pytest.mark.parametrize("tm", [64, 128])
@pytest.mark.parametrize("bits", [4, 8])
def test_gmm_a8_plain_matches_pallas_gmm_a8(bits, tm):
    """Tile-aligned int8 rows of a 64-row and a 128-row plan against N = 192
    columns (a 64-column tail at 128-column CTAs), groups of 16."""
    K, N, gs, T = 256, 192, 16, 150
    rng = np.random.default_rng(170 + bits + tm)
    w = _stack(170 + bits, E, K, N, bits, gs)
    idx = np.stack([rng.permutation(E)[:K_TOP] for _ in range(T)]).astype(np.int32)
    plan = gmm_cuda.plan_tiles(t(idx), E, tm)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32)).to(torch.bfloat16)
    xq, sx = quantize_activations(x, gs)
    xq_t, sx_t = gmm_cuda._tile_rows(xq, plan.row_src), gmm_cuda._tile_rows(sx, plan.row_src)
    Mp = plan.n_tiles * tm
    want = jgp.gmm_a8(jnp.asarray(xq_t.numpy()), jnp.asarray(sx_t.numpy()), w,
                      jnp.asarray(plan.tile_e.numpy()), jnp.asarray(plan.tile_valid.numpy()),
                      interpret=True, tm=tm)[:Mp]
    got = gmm_cuda.gmm_a8_plain(xq_t, sx_t, None, tq(w), plan)
    live = (plan.row_src >= 0).numpy()
    np.testing.assert_allclose(f32(got)[live], f32(want)[live], rtol=1e-5, atol=1e-5)
    # rows gathered through row_src give the same tile rows
    assert torch.equal(gmm_cuda.gmm_a8_plain(xq, sx, plan.row_src, tq(w), plan), got)


def test_groups_of_16_take_two_int8_launches(monkeypatch):
    """C-3's dispatch: two gmm_a8 calls, no bf16 grouped call."""
    calls = {"gmm_a8": 0, "gmm": 0, "gmm_two_stage": 0}
    for name in calls:
        monkeypatch.setattr(gmm_cuda, name, lambda *a, _n=name, _f=getattr(gmm_cuda, name), **kw:
                            calls.__setitem__(_n, calls[_n] + 1) or _f(*a, **kw))
    w13, w2, x, idx, wts, _ = _case(180, 4, 16, ROWS[64])
    gmm_cuda.moe_prefill(t(x).to(torch.bfloat16), tq(w13), tq(w2), t(idx), t(wts),
                         activation="int8")
    assert calls == {"gmm_a8": 2, "gmm": 0, "gmm_two_stage": 0}


@pytest.mark.parametrize("bits,gs,k_dim", [(4, 16, 256), (8, 32, 256), (4, 128, 384),
                                           (4, 8, 256), (4, 96, 256)])
def test_grouped_int8_is_the_reference_predicate(bits, gs, k_dim):
    w = _stack(190, 2, k_dim, 128, bits, gs) if k_dim % gs == 0 else None
    if w is None:   # K not a whole number of groups: both refuse
        from krasis_tpu.quant import QTensor as JQ
        w = JQ(jnp.zeros((2, k_dim // 2 if bits == 4 else k_dim, 128), jnp.int8),
               jnp.zeros((2, -(-k_dim // gs), 128), jnp.bfloat16), bits, gs)
    assert expert_class.grouped_int8(tq(w)) == jgp.gmm_a8_supported(w)
