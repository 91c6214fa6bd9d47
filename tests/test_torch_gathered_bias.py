"""K6 on K1's core and the routes of ``moe_forward``, on the CPU against the
JAX package:

* ``gathered_qmm_plain`` at widths that are not whole 128-column blocks
  (the partial column tile K6 takes now), int4 and int8, groups of 32 and
  16, against JAX ``quant.dequantize`` and an f32 product (2e-2, the
  reference's qmm tolerance);
* the biased bf16 chain (GPT-OSS's experts: ``moe_gathered_tiled`` with
  biases, the clamped activation) against JAX ``moe_forward_gathered`` with
  the same biases (3e-2, the reference's MoE tolerance), with a control
  that drops the w13 bias and must fail that limit;
* the dispatch: biased decode takes exactly two K6 calls, biased prefill
  the ragged form on two K7 calls (no plain route), unbiased stacks of the
  repository's models the kernels they took before;
* K6's launch plan: every column, the 64-column tail included, and every
  pick;
* groups of 16 (ROADMAP C-2): in every regime the port's form is the one
  the reference's dispatch takes, that form's card kernel takes the
  stacks (no plain route), and the result is within the form's tolerance
  of the reference's; the reference's XLA path and its interpret-mode
  kernels within 5e-2 of each other on the same stacks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.ops import gmm_pallas as jgp
from krasis_tpu.ops import moe as jmoe
from krasis_tpu.ops import moe_pallas as jmp
from krasis_tpu.quant import dequantize as jdequantize
from krasis_tpu.quant import random_qtensor as jrandom_qtensor
from krasis_tpu_torch.ops import expert_class, gmm_cuda, moe, moe_cuda, qmm_cuda
from krasis_tpu_torch.quant import QTensor

from torch_port_util import f32, t, tq

TOL_QMM = 2e-2
TOL_MOE = 3e-2
TOL_XLA = 5e-2    # the reference's XLA path has bf16 rows where its int8 forms quantize


def _bf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def _stack(seed, e, k, n, bits, gs, mag=None):
    mag = mag or (0.03 if bits == 4 else 0.002)
    return jrandom_qtensor(jax.random.PRNGKey(seed), (e, k, n), bits, group_size=gs,
                           scale_mag=mag)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "pick_valid"])
@pytest.mark.parametrize("gs", [32, 16])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("N", [320, 192])
def test_gathered_qmm_plain_at_column_tails(N, bits, gs, masked):
    E, K, P = 6, 256, 5
    rng = np.random.default_rng(N + bits + gs)
    w = _stack(N + gs, E, K, N, bits, gs)
    x = _bf16(rng.standard_normal((P, K)) * 0.5)
    eids = rng.integers(0, E, P).astype(np.int32)
    valid = None
    if masked:
        valid = np.ones(P, np.int32)
        valid[[1, P - 1]] = 0
    wd = np.asarray(jdequantize(w, jnp.bfloat16), np.float32)            # [E, K, N]
    want = np.einsum("pk,pkn->pn", np.asarray(x, np.float32), wd[eids])
    if masked:
        want[valid == 0] = 0.0
    got = moe_cuda.gathered_qmm_plain(t(x), tq(w), t(eids), None if valid is None else t(valid))
    assert got.dtype == torch.float32 and tuple(got.shape) == (P, N)
    np.testing.assert_allclose(f32(got), want, rtol=TOL_QMM, atol=TOL_QMM)
    if masked:
        assert not got[torch.from_numpy(valid == 0)].any()


def _biased_case(seed, T=2, k=4, E=8, H=320, I=160):
    """GPT-OSS-shaped biased experts at a width that is not whole 128-column
    blocks: int4 gs 32, biases of about the size of h, gate and up values
    past the clamp."""
    rng = np.random.default_rng(seed)
    w13 = _stack(seed, E, H, 2 * I, 4, 32)
    w2 = _stack(seed + 1, E, I, H, 4, 32)
    x = _bf16(rng.standard_normal((T, H)) * 2.0)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    wts = rng.dirichlet(np.ones(k), T).astype(np.float32)
    b13 = _bf16(rng.standard_normal((E, 2 * I)) * 0.5)
    b2 = _bf16(rng.standard_normal((E, H)) * 0.5)
    return w13, w2, x, idx, wts, b13, b2


def _jax_gathered(case, limit=7.0):
    w13, w2, x, idx, wts, b13, b2 = case
    return f32(jmoe.moe_forward_gathered(x, w13, w2, jnp.asarray(idx), jnp.asarray(wts),
                                         swiglu_limit=limit, gpt_oss=True, w13_bias=b13,
                                         w2_bias=b2))


def test_biased_chain_matches_moe_forward_gathered():
    """moe_gathered_tiled with biases (K6's chain, here on its plain
    products) is the reference's plain gathered form; without the w13 bias
    it is not."""
    case = _biased_case(5)
    w13, w2, x, idx, wts, b13, b2 = case
    want = _jax_gathered(case)
    args = (t(x), tq(w13), tq(w2), t(idx), t(wts), 7.0, True)
    got = moe_cuda.moe_gathered_tiled(*args, w13_bias=t(b13), w2_bias=t(b2))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), want, rtol=TOL_MOE, atol=TOL_MOE)
    dropped = f32(moe_cuda.moe_gathered_tiled(*args, w2_bias=t(b2)))
    assert not np.allclose(dropped, want, rtol=TOL_MOE, atol=TOL_MOE)


@pytest.mark.parametrize("activation", ["bf16", "int8"])
def test_moe_forward_runs_biased_decode_on_two_k6_calls(monkeypatch, activation):
    """A biased T = 1 call: exactly two K6 calls whatever `activation`
    says (the reference's form has bf16 rows), no plain route, and the
    result of the reference's moe_forward."""
    calls = []
    real = moe_cuda.gathered_qmm

    def counted(*a, **kw):
        calls.append(a[1].n_dim)
        return real(*a, **kw)

    monkeypatch.setattr(moe_cuda, "gathered_qmm", counted)
    w13, w2, x, idx, wts, b13, b2 = _biased_case(6, T=1)
    moe.plain_routes.update(ragged_plain=0, gathered_plain=0)
    got = moe.moe_forward(t(x), tq(w13), tq(w2), t(idx), t(wts), 7.0, True,
                          w13_bias=t(b13), w2_bias=t(b2), activation=activation)
    assert calls == [w13.n_dim, w2.n_dim]
    assert moe.plain_routes == {"ragged_plain": 0, "gathered_plain": 0}
    want = jmoe.moe_forward(x, w13, w2, jnp.asarray(idx), jnp.asarray(wts), swiglu_limit=7.0,
                            gpt_oss=True, w13_bias=b13, w2_bias=b2, activation=activation)
    np.testing.assert_allclose(f32(got), f32(want), rtol=TOL_MOE, atol=TOL_MOE)


def test_moe_forward_keeps_biased_prefill_on_the_ragged_path(monkeypatch):
    """A biased call in the grouped regime takes the reference's ragged
    form, now on K7: two K7 calls with the biases between, no K6 call, no
    call of the plain moe_forward_ragged and no plain route (I = 192: a K7
    step is 32 packed int4 rows)."""
    calls = []
    monkeypatch.setattr(moe_cuda, "gathered_qmm", lambda *a, **kw: calls.append("K6"))
    real_k7 = gmm_cuda.gmm_two_stage
    monkeypatch.setattr(gmm_cuda, "gmm_two_stage",
                        lambda *a, **kw: calls.append("K7") or real_k7(*a, **kw))
    real = moe.moe_forward_ragged
    monkeypatch.setattr(moe, "moe_forward_ragged",
                        lambda *a, **kw: calls.append("ragged_plain") or real(*a, **kw))
    w13, w2, x, idx, wts, b13, b2 = _biased_case(7, T=6, k=4, E=8, I=192)
    moe.plain_routes.update(ragged_plain=0, gathered_plain=0)
    got = moe.moe_forward(t(x), tq(w13), tq(w2), t(idx), t(wts), 7.0, True, w13_bias=t(b13),
                          w2_bias=t(b2))
    assert calls == ["K7", "K7"]
    assert moe.plain_routes == {"ragged_plain": 0, "gathered_plain": 0}
    want = jmoe.moe_forward_ragged(x, w13, w2, jnp.asarray(idx), jnp.asarray(wts),
                                   swiglu_limit=7.0, gpt_oss=True, w13_bias=b13, w2_bias=b2)
    np.testing.assert_allclose(f32(got), f32(want), rtol=TOL_MOE, atol=TOL_MOE)


def _meta_stack(e, k, n, bits, gs):
    rows = k // 2 if bits == 4 else k
    return QTensor(torch.empty((e, rows, n), dtype=torch.int8, device="meta"),
                   torch.empty((e, k // gs, n), dtype=torch.bfloat16, device="meta"), bits, gs)


def _route(E, H, I, bits, gs, T, k, activation, biased=False):
    x = torch.empty((T, H), dtype=torch.bfloat16, device="meta")
    idx = torch.empty((T, k), dtype=torch.int32, device="meta")
    return moe.route(x, _meta_stack(E, H, 2 * I, bits, gs), _meta_stack(E, I, H, bits, gs), idx,
                     biased, activation)


# (E with the folded shared experts, H, I, bits, gs, decode picks, prefill
# picks) → the route of decode with int8 and bf16 rows, and of prefill
MODELS = {
    "v2-lite-q4": ((66, 2048, 1408, 4, 128, 8, 6), ["fused_int8", "fused_bf16", "grouped"]),
    "v2-lite-q8": ((66, 2048, 1408, 8, 128, 8, 6), ["tiled_int8", "tiled_bf16", "grouped"]),
    "qwen3-coder-next": ((513, 2048, 512, 4, 128, 11, 10),
                         ["fused_int8", "fused_bf16", "grouped"]),
}
# the card predicate of each kernel form
CARD = {"fused_int8": moe_cuda.w4a8_supported, "tiled_int8": moe_cuda.w4a8_supported,
        "fused_bf16": moe_cuda.supported,
        "tiled_bf16": lambda a, b: (moe_cuda.gathered_qmm_supported(a)
                                    and moe_cuda.gathered_qmm_supported(b)),
        "grouped": lambda a, b: gmm_cuda.gmm_supported(a) and gmm_cuda.gmm_supported(b)}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_unbiased_routes_of_the_models_are_the_kernels(model):
    """The repository's unbiased expert stacks take the kernels they took
    before this dispatch was split into form and implementation, and each
    kernel's card predicate takes them."""
    (E, H, I, bits, gs, k_dec, k_pre), want = MODELS[model]
    got = [_route(E, H, I, bits, gs, 1, k_dec, "int8"), _route(E, H, I, bits, gs, 1, k_dec, "bf16"),
           _route(E, H, I, bits, gs, 2048, k_pre, "bf16")]
    assert got == want
    w13, w2 = _meta_stack(E, H, 2 * I, bits, gs), _meta_stack(E, I, H, bits, gs)
    assert all(CARD[form](w13, w2) for form in got)


def test_gpt_oss_routes():
    """GPT-OSS-20B's biased experts (32, H 2880, I 2880, int4 gs 32): the
    plain gathered form on K6 in decode under both activations; the plain
    ragged form on K7 in prefill (w2's 2880 columns: a 64-column tail), at
    both plan heights."""
    for act in ("int8", "bf16"):
        assert _route(32, 2880, 2880, 4, 32, 1, 4, act, biased=True) == "gathered"
    for T in (2048, 452, 40):
        assert _route(32, 2880, 2880, 4, 32, T, 4, "bf16", biased=True) == "ragged"
    w13, w2 = _meta_stack(32, 2880, 5760, 4, 32), _meta_stack(32, 2880, 2880, 4, 32)
    assert gmm_cuda.gmm_supported(w13) and gmm_cuda.gmm_supported(w2)
    assert [gmm_cuda.choose_tm(T * 4, 32) for T in (2048, 452, 40)] == [128, 64, 64]


@pytest.mark.parametrize("P,K,N,bits,gs", [
    (4, 2880, 5760, 4, 32), (4, 2880, 2880, 4, 32), (8, 2880, 2880, 4, 32),
    (8, 2048, 2816, 8, 128), (8, 1408, 2048, 8, 128), (2, 32, 64, 4, 32),
    (3, 256, 192, 4, 16), (5, 160, 320, 8, 32)])
def test_k6_plan_covers_every_column_and_pick(P, K, N, bits, gs):
    p = moe_cuda.plan_gq(P, K, N, bits, gs)
    tiles = p.grid[0]
    assert (tiles - 1) * qmm_cuda.COLS < N <= tiles * qmm_cuda.COLS
    assert p.grid[1] == P and p.grid[2] == p.ks and p.tt == 1
    rows = K // 2 if bits == 4 else K
    splits = p.split_rows(rows)
    assert splits[0][0] == 0 and splits[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(splits, splits[1:]))
    assert all(r1 > r0 for r0, r1 in splits)
    if N == 2880:
        assert N - (tiles - 1) * qmm_cuda.COLS == 64            # the column tail
    assert moe_cuda.gathered_qmm_supported(_meta_stack(8, K, N, bits, gs))


# groups of 16 (ROADMAP C-2): E 4, H 256, I 128, int4
C2 = dict(E=4, H=256, I=128, bits=4, gs=16)
# regime → (T, k, activation, two-stage class)
REGIMES = {
    "fused_int8": (1, 2, "int8", False),
    "tiled_int8": (1, 2, "int8", True),
    "fused_bf16": (1, 2, "bf16", False),
    "tiled_bf16": (1, 2, "bf16", True),
    "grouped": (64, 2, "bf16", False),
}


def _reference_form(monkeypatch, w13, w2, x, idx, wts, activation):
    """The form the reference's moe_forward takes, recorded at the function
    it calls (the recorders compute nothing)."""
    seen = []

    def rec(name):
        def f(*a, **kw):
            form = name
            if name == "tiled":
                form = "tiled_int8" if kw.get("activation") == "int8" else "tiled_bf16"
            seen.append(form)
            return a[0]
        return f

    monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    with monkeypatch.context() as m:
        for mod, name, form in ((jgp, "moe_prefill_pallas", "grouped"),
                                (jmoe, "moe_forward_ragged", "ragged"),
                                (jmp, "moe_gathered_w4a8_pallas", "fused_int8"),
                                (jmp, "moe_gathered_tiled", "tiled"),
                                (jmp, "moe_gathered_pallas", "fused_bf16"),
                                (jmoe, "moe_forward_gathered", "gathered")):
            m.setattr(mod, name, rec(form))
        jmoe.moe_forward(x, w13, w2, jnp.asarray(idx), jnp.asarray(wts), activation=activation)
    assert len(seen) == 1, seen
    return seen[0]


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_groups_of_16_take_the_reference_form(monkeypatch, regime):
    """In each regime the port takes the reference's form, whose card
    kernel's own predicate takes the stacks (no plain route), and agrees
    with the reference's result (its Pallas kernels in interpret mode)
    within 3e-2."""
    T, k, activation, two_stage = REGIMES[regime]
    form = regime
    if two_stage:
        monkeypatch.setattr(jmp, "_MAX_W_BYTES", 1024)
        monkeypatch.setattr(expert_class, "MAX_FUSED_PICK_BYTES", 1024)
    rng = np.random.default_rng(16 + T)
    w13 = _stack(61, C2["E"], C2["H"], 2 * C2["I"], C2["bits"], C2["gs"])
    w2 = _stack(62, C2["E"], C2["I"], C2["H"], C2["bits"], C2["gs"])
    x = _bf16(rng.standard_normal((T, C2["H"])) * 0.5)
    idx = np.stack([rng.permutation(C2["E"])[:k] for _ in range(T)]).astype(np.int32)
    wts = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    assert _reference_form(monkeypatch, w13, w2, x, idx, wts, activation) == form
    pw13, pw2 = tq(w13), tq(w2)
    assert moe.route(t(x), pw13, pw2, t(idx), False, activation) == form
    assert CARD[form](pw13, pw2)
    moe.plain_routes.update(ragged_plain=0, gathered_plain=0)
    got = moe.moe_forward(t(x), pw13, pw2, t(idx), t(wts), activation=activation)
    assert moe.plain_routes == {"ragged_plain": 0, "gathered_plain": 0}
    want = jmoe.moe_forward(x, w13, w2, jnp.asarray(idx), jnp.asarray(wts),
                            activation=activation)
    np.testing.assert_allclose(f32(got), f32(want), rtol=TOL_MOE, atol=TOL_MOE)
    # the reference's own two paths agree here too: its XLA path (bf16 rows
    # in every regime) against its Pallas kernels in interpret mode, within
    # the int8 rows' quantization
    monkeypatch.delenv("KRASIS_TPU_PALLAS_INTERPRET")
    monkeypatch.setenv("KRASIS_TPU_NO_PALLAS", "1")
    xla = jmoe.moe_forward(x, w13, w2, jnp.asarray(idx), jnp.asarray(wts), activation=activation)
    np.testing.assert_allclose(f32(xla), f32(want), rtol=TOL_XLA, atol=TOL_XLA)
