"""The two-stage gathered decode MoE of the port (K6 gathered_qmm, K6a
gathered_qmm_a8, moe_gathered_tiled) in its plain PyTorch versions against
the Pallas kernels they replace, run in interpret mode on the CPU on the
same numpy inputs; and the rule that sends an expert stack to the fused or
to the two-stage form.

Tolerances: 2e-2 with bf16 activations, 3e-2 with int8 activations, as the
reference's own kernel tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.ops import moe_pallas as jmp
from krasis_tpu.quant import random_qtensor as jrandom_qtensor
from krasis_tpu_torch.ops import expert_class, moe, moe_cuda
from krasis_tpu_torch.quant import QTensor

from torch_port_util import f32, t, tq

E, HD, I = 8, 256, 128


def _bf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def _experts(seed, bits, e=E, hd=HD, i=I):
    k13, k2 = jax.random.split(jax.random.PRNGKey(seed))
    mag = 0.03 if bits == 4 else 0.002
    return (jrandom_qtensor(k13, (e, hd, 2 * i), bits, group_size=128, scale_mag=mag),
            jrandom_qtensor(k2, (e, i, hd), bits, group_size=128, scale_mag=mag))


def _picks(rng, P, masked):
    """Expert ids [P] and pick_valid [P] (None when not masked). A skipped
    pick carries the id of the valid pick before it, as the reference's
    callers arrange."""
    eids = rng.integers(0, E, P).astype(np.int32)
    if not masked:
        return eids, None
    valid = np.ones(P, np.int32)
    valid[[2, P - 1]] = 0
    eids[2], eids[P - 1] = eids[1], eids[P - 2]
    return eids, valid


@pytest.mark.parametrize("masked", [False, True], ids=["all", "pick_valid"])
@pytest.mark.parametrize("bits", [4, 8])
def test_gathered_qmm_plain_matches_pallas(bits, masked):
    rng = np.random.default_rng(20 + bits)
    w13, _ = _experts(3, bits)
    P = 6
    x = _bf16(rng.standard_normal((P, HD)) * 0.5)
    eids, valid = _picks(rng, P, masked)
    want = jmp.gathered_qmm_pallas(x, w13, jnp.asarray(eids),
                                   pick_valid=None if valid is None else jnp.asarray(valid),
                                   interpret=True)
    got = moe_cuda.gathered_qmm(t(x), tq(w13), t(eids), None if valid is None else t(valid))
    assert got.dtype == torch.float32 and got.shape == (P, 2 * I)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)
    if masked:
        assert not f32(got)[[2, P - 1]].any() and f32(got)[0].any()


@pytest.mark.parametrize("masked", [False, True], ids=["all", "pick_valid"])
@pytest.mark.parametrize("bits", [4, 8])
def test_gathered_qmm_a8_plain_matches_pallas(bits, masked):
    rng = np.random.default_rng(30 + bits)
    w13, _ = _experts(4, bits)
    P = 6
    x = _bf16(rng.standard_normal((P, HD)) * 0.5)
    xq, sx = jmp.quantize_activations(x, w13.group_size)
    eids, valid = _picks(rng, P, masked)
    want = jmp.gathered_qmm_a8_pallas(xq, sx, w13, jnp.asarray(eids),
                                      pick_valid=None if valid is None else jnp.asarray(valid),
                                      interpret=True)
    got = moe_cuda.gathered_qmm_a8(t(xq), t(sx), tq(w13), t(eids),
                                   None if valid is None else t(valid))
    np.testing.assert_allclose(f32(got), f32(want), rtol=3e-2, atol=3e-2)
    if masked:
        assert not f32(got)[[2, P - 1]].any() and f32(got)[0].any()


def test_quantize_activations_matches_reference():
    rng = np.random.default_rng(2)
    x = _bf16(rng.standard_normal((5, HD)) * 3.0)
    wq, ws = jmp.quantize_activations(x, 128)
    gq, gs = moe_cuda.quantize_activations(t(x), 128)
    assert np.array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)


def _moe_case(seed, bits, masked, T=4, k=3):
    rng = np.random.default_rng(seed)
    w13, w2 = _experts(seed, bits)
    x = _bf16(rng.standard_normal((T, HD)) * 0.5)
    idx = rng.integers(0, E, (T, k)).astype(np.int32)
    wts = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    pv = None
    if masked:
        pv = np.ones((T, k), bool)
        pv[1, 1] = False
        wts[1, 1] = 0.0
        idx[1, 1] = idx[1, 0]
    return w13, w2, x, idx, wts, pv


@pytest.mark.parametrize("masked", [False, True], ids=["all", "pick_valid"])
@pytest.mark.parametrize("activation,tol", [("bf16", 2e-2), ("int8", 3e-2)])
@pytest.mark.parametrize("bits", [4, 8])
def test_moe_gathered_tiled_plain_matches_pallas(bits, activation, tol, masked):
    w13, w2, x, idx, wts, pv = _moe_case(40 + bits, bits, masked)
    want = jmp.moe_gathered_tiled(x, w13, w2, jnp.asarray(idx), jnp.asarray(wts),
                                  pick_valid=None if pv is None else jnp.asarray(pv),
                                  interpret=True, activation=activation)
    got = moe_cuda.moe_gathered_tiled(t(x), tq(w13), tq(w2), t(idx), t(wts),
                                      pick_valid=None if pv is None else t(pv),
                                      activation=activation)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def test_bf16_tiled_form_rounds_h_before_swiglu():
    """The two forms with bf16 activations are different functions: the
    two-stage form rounds the f32 h to bf16 before SwiGLU, the fused one
    (K5) applies SwiGLU to the f32 h. On one input the port's two-stage
    form agrees with the reference's moe_gathered_tiled to the last bit of
    the bf16 output, while K5's function differs from both in many
    elements: a model of the big-expert class sent to K5 computes another
    function than the reference."""
    w13, w2, x, idx, wts, _ = _moe_case(7, 8, False, T=8)
    want = f32(jmp.moe_gathered_tiled(x, w13, w2, jnp.asarray(idx), jnp.asarray(wts),
                                      interpret=True))
    args = (t(x), tq(w13), tq(w2), t(idx), t(wts))
    tiled = f32(moe_cuda.moe_gathered_tiled(*args))
    fused = f32(moe_cuda.moe_bf16(*args))
    off_tiled = int((tiled != want).sum())
    off_fused = int((fused != want).sum())
    assert off_tiled == 0, off_tiled
    assert off_fused > 0
    np.testing.assert_allclose(fused, want, rtol=2e-2, atol=2e-2)    # close, not equal


def _meta_stack(e, k, n, bits, gs=128):
    rows = k // 2 if bits == 4 else k
    return QTensor(torch.empty((e, rows, n), dtype=torch.int8, device="meta"),
                   torch.empty((e, k // gs, n), dtype=torch.bfloat16, device="meta"), bits, gs)


@pytest.mark.parametrize("bits,fused", [(4, True), (8, False)])
def test_expert_class_of_v2_lite(bits, fused):
    """DeepSeek-V2-Lite's experts (H 2048, I 1408, 64 + 2 of them): the
    fused class at int4 (4.33 MB a pick), the two-stage class at int8
    (8.65 MB a pick, 5.77 MB the w13 block), as in the reference."""
    w13, w2 = _meta_stack(66, 2048, 2816, bits), _meta_stack(66, 1408, 2048, bits)
    assert expert_class.decode_fused(w13, w2) is fused
    assert expert_class.decode_fused_int8(w13, w2) is fused
    assert expert_class.prefill_fused(w13, w2) is fused
    assert expert_class.MAX_FUSED_PICK_BYTES == jmp._MAX_W_BYTES
    from krasis_tpu.ops import gmm_pallas
    assert expert_class.MAX_FUSED_BLOCK_BYTES == gmm_pallas._MAX_FUSED_BLOCK


@pytest.mark.parametrize("activation", ["int8", "bf16"])
@pytest.mark.parametrize("big", [False, True], ids=["fused_class", "two_stage_class"])
def test_moe_forward_takes_the_form_of_the_class(monkeypatch, activation, big):
    """moe_forward sends the same stacks to the fused wrappers or to the
    two-stage ones by the class limits alone, in both regimes."""
    if big:
        monkeypatch.setattr(expert_class, "MAX_FUSED_PICK_BYTES", 1024)
        monkeypatch.setattr(expert_class, "MAX_FUSED_BLOCK_BYTES", 1024)
    calls = []
    for mod, name in ((moe_cuda, "moe_w4a8"), (moe_cuda, "moe_bf16"),
                      (moe_cuda, "gathered_qmm"), (moe_cuda, "gathered_qmm_a8"),
                      (moe.gmm_cuda, "gmm"), (moe.gmm_cuda, "gmm_two_stage")):
        def counted(*a, _f=getattr(mod, name), _n=name, **kw):
            calls.append(_n)
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    w13, w2, x, idx, wts, _ = _moe_case(11, 4, False, T=1)
    moe.moe_forward(t(x), tq(w13), tq(w2), t(idx), t(wts), activation=activation)
    decode = {("int8", False): ["moe_w4a8"], ("bf16", False): ["moe_bf16"],
              ("int8", True): ["gathered_qmm_a8"] * 2, ("bf16", True): ["gathered_qmm"] * 2}
    assert calls == decode[activation, big]
    calls.clear()
    rng = np.random.default_rng(1)
    xs = t(_bf16(rng.standard_normal((64, HD)) * 0.5))
    idx = torch.from_numpy(rng.integers(0, E, (64, 2)).astype(np.int32))
    moe.moe_forward(xs, tq(w13), tq(w2), idx, torch.full((64, 2), 0.5), activation=activation)
    assert calls == (["gmm_two_stage"] * 2 if big else ["gmm"] * 2)


def test_fused_kernels_refuse_gpt_oss():
    """The fused decode forms no longer refuse GPT-OSS's clamped activation:
    moe_forward takes them (K3 with int8 activations, K5 with bf16) and
    matches the reference's Pallas kernels with gpt_oss=True."""
    w13, w2, x, idx, wts, _ = _moe_case(12, 4, False, T=1)
    x = _bf16(f32(x) * 8.0)          # gate and up values past the clamp
    for activation, ref, tol in (("int8", jmp.moe_gathered_w4a8_pallas, 3e-2),
                                 ("bf16", jmp.moe_gathered_pallas, 3e-2)):
        got = moe.moe_forward(t(x), tq(w13), tq(w2), t(idx), t(wts), swiglu_limit=7.0,
                              gpt_oss=True, activation=activation)
        want = ref(x, w13, w2, jnp.asarray(idx), jnp.asarray(wts), swiglu_limit=7.0,
                   gpt_oss=True, interpret=True)
        np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)
