"""The two-stage grouped MoE of the port (K7 gmm_two_stage, K7a gmm_a8,
through moe_prefill) in its plain PyTorch versions against the reference's
moe_prefill_pallas in interpret mode, the tile plan with pick_valid, the
plain ragged and gathered paths with biases, and swiglu's GPT-OSS form.

Tolerances: 2e-2 with bf16 activations and for the plain paths, 3e-2 with
int8 activations, as the reference's own tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.ops import moe as jmoe
from krasis_tpu.ops.activations import swiglu as jswiglu
from krasis_tpu.ops.gmm_pallas import gmm_fused_supported, moe_prefill_pallas
from krasis_tpu.quant import random_qtensor as jrandom_qtensor
from krasis_tpu_torch.ops import expert_class, gmm_cuda, moe
from krasis_tpu_torch.ops.activations import swiglu

from torch_port_util import f32, t, tq

E, HD, I, T, K = 8, 256, 128, 48, 3


def _bf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def _case(seed, bits, masked):
    rng = np.random.default_rng(seed)
    k13, k2 = jax.random.split(jax.random.PRNGKey(seed))
    mag = 0.03 if bits == 4 else 0.002
    w13 = jrandom_qtensor(k13, (E, HD, 2 * I), bits, group_size=128, scale_mag=mag)
    w2 = jrandom_qtensor(k2, (E, I, HD), bits, group_size=128, scale_mag=mag)
    x = _bf16(rng.standard_normal((T, HD)) * 0.5)
    idx = rng.integers(0, E, (T, K)).astype(np.int32)
    wts = rng.uniform(0.1, 1.0, (T, K)).astype(np.float32)
    pv = None
    if masked:
        pv = np.ones((T, K), bool)
        pv[2, 1] = pv[7, 0] = False
        wts[2, 1] = wts[7, 0] = 0.0
    return w13, w2, x, idx, wts, pv


def _both(case, activation):
    w13, w2, x, idx, wts, pv = case
    want = moe_prefill_pallas(x, w13, w2, jnp.asarray(idx), jnp.asarray(wts),
                              pick_valid=None if pv is None else jnp.asarray(pv),
                              interpret=True, activation=activation)
    got = gmm_cuda.moe_prefill(t(x), tq(w13), tq(w2), t(idx), t(wts),
                               pick_valid=None if pv is None else t(pv),
                               activation=activation)
    return f32(got), f32(want)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "pick_valid"])
@pytest.mark.parametrize("bits", [4, 8])
def test_two_stage_prefill_plain_matches_pallas_gmm(monkeypatch, bits, masked):
    """bf16 rows through gmm twice with SwiGLU between: the reference under
    KRASIS_TPU_GMM=legacy, the port with the fused class closed."""
    monkeypatch.setenv("KRASIS_TPU_GMM", "legacy")
    monkeypatch.setattr(expert_class, "MAX_FUSED_BLOCK_BYTES", 0)
    calls = []
    monkeypatch.setattr(gmm_cuda, "gmm_two_stage",
                        lambda *a, _f=gmm_cuda.gmm_two_stage: calls.append(1) or _f(*a))
    got, want = _both(_case(50 + bits, bits, masked), "bf16")
    assert len(calls) == 2
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "pick_valid"])
@pytest.mark.parametrize("bits", [4, 8])
def test_int8_prefill_plain_matches_pallas_gmm_a8(monkeypatch, bits, masked):
    calls = []
    monkeypatch.setattr(gmm_cuda, "gmm_a8",
                        lambda *a, _f=gmm_cuda.gmm_a8: calls.append(1) or _f(*a))
    got, want = _both(_case(60 + bits, bits, masked), "int8")
    assert len(calls) == 2
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("bits", [4, 8])
def test_two_stage_equals_fused_bit_for_bit(monkeypatch, bits):
    """Rounding the f32 h to bf16 and applying SwiGLU between the stages is
    what the fused epilogue does: the two forms agree exactly."""
    w13, w2, x, idx, wts, _ = _case(70 + bits, bits, False)
    assert gmm_fused_supported(w13, w2) and expert_class.prefill_fused(tq(w13), tq(w2))
    args = (t(x), tq(w13), tq(w2), t(idx), t(wts))
    fused = gmm_cuda.moe_prefill(*args)
    monkeypatch.setattr(expert_class, "MAX_FUSED_BLOCK_BYTES", 0)
    assert not expert_class.prefill_fused(tq(w13), tq(w2))
    assert torch.equal(gmm_cuda.moe_prefill(*args), fused)


def test_plan_tiles_leaves_invalid_picks_out():
    idx = torch.tensor([[0, 2], [2, 1], [2, 0]], dtype=torch.int32)
    pv = torch.tensor([[True, True], [False, True], [True, True]])
    plan = gmm_cuda.plan_tiles(idx, 4, pick_valid=pv)
    Mp = plan.n_tiles * gmm_cuda.TM
    dest = plan.dest.reshape(3, 2)
    assert dest[1, 0] == Mp and int((plan.dest < Mp).sum()) == 5
    # expert 2 keeps its two valid picks, in token order, in the third tile
    assert plan.row_src[2 * gmm_cuda.TM:2 * gmm_cuda.TM + 3].tolist() == [0, 2, -1]
    assert int((plan.row_src >= 0).sum()) == 5
    assert plan.tile_e[:3].tolist() == [0, 1, 2] and plan.tile_valid.tolist()[:4] == [1, 1, 1, 0]
    whole = gmm_cuda.plan_tiles(idx, 4)
    assert int((whole.row_src >= 0).sum()) == 6 and int(whole.dest.max()) < Mp


@pytest.mark.parametrize("biased", [False, True], ids=["plain", "biased"])
@pytest.mark.parametrize("path", ["ragged", "gathered"])
@pytest.mark.parametrize("bits", [4, 8])
def test_plain_paths_match_reference(bits, path, biased):
    """moe_forward_ragged / moe_forward_gathered, the paths of biased
    experts and of stacks the kernels decline."""
    w13, w2, x, idx, wts, _ = _case(80 + bits, bits, False)
    rng = np.random.default_rng(3)
    b13 = b2 = None
    if biased:
        b13 = _bf16(rng.standard_normal((E, 2 * I)) * 0.2)
        b2 = _bf16(rng.standard_normal((E, HD)) * 0.2)
    jfn = jmoe.moe_forward_ragged if path == "ragged" else jmoe.moe_forward_gathered
    fn = moe.moe_forward_ragged if path == "ragged" else moe.moe_forward_gathered
    want = jfn(x, w13, w2, jnp.asarray(idx), jnp.asarray(wts), w13_bias=b13, w2_bias=b2)
    got = fn(t(x), tq(w13), tq(w2), t(idx), t(wts),
             w13_bias=None if b13 is None else t(b13), w2_bias=None if b2 is None else t(b2))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)


def test_moe_forward_sends_biased_experts_to_the_plain_paths(monkeypatch):
    """Biased experts take the reference's plain forms: the ragged path in
    the grouped regime, which the port runs on K7's two launches with the
    biases (moe_prefill) where K7 takes the stacks; in the gathered one the
    plain gathered form, which the port runs on K6's chain with the biases
    (moe_gathered_tiled) where K6 takes the stacks."""
    w13, w2, x, idx, wts, _ = _case(90, 4, False)
    b13 = t(_bf16(np.full((E, 2 * I), 0.1)))
    calls = []
    for mod, name in ((moe, "moe_forward_ragged"), (moe, "moe_forward_gathered"),
                      (moe.gmm_cuda, "moe_prefill"), (moe.moe_cuda, "moe_gathered_tiled")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **kw: calls.append(
            (_n, kw.get("w13_bias") is b13)))
    moe.moe_forward(t(x), tq(w13), tq(w2), t(idx), t(wts), w13_bias=b13)
    moe.moe_forward(t(x)[:1], tq(w13), tq(w2), t(idx)[:1], t(wts)[:1], w13_bias=b13)
    assert calls == [("moe_prefill", True), ("moe_gathered_tiled", True)]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("gpt_oss", [False, True])
def test_swiglu_matches_reference(gpt_oss, dtype):
    rng = np.random.default_rng(4)
    h = jnp.asarray(rng.standard_normal((6, 64)) * 6.0, jnp.float32).astype(dtype)
    want = jswiglu(h, swiglu_limit=7.0, gpt_oss=gpt_oss)
    got = swiglu(t(h), swiglu_limit=7.0, gpt_oss=gpt_oss)
    assert got.dtype == t(h).dtype
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5 if dtype == jnp.float32 else 8e-3,
                               atol=1e-6)
