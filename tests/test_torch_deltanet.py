"""The port's Gated DeltaNet (plain PyTorch) against the JAX package's, on
the same numpy inputs on the CPU, plus the small ops the hybrid adds
(gated RMSNorm, qk-norm on head dims, partial rotary).

Tolerances: the un-interleave and the conv are exact; the f32 state math is
held to 2e-5 (the two frameworks sum in different orders); `fast=True`
rounds operands to bf16 at the same points on both sides, so it is held to
1e-3 of the output scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.config import preset_config as jax_preset_config
from krasis_tpu.models import model as jax_model
from krasis_tpu.models.params import init_synthetic_params as jax_init
from krasis_tpu.ops import deltanet as jdn
from krasis_tpu.ops import norm as jnorm
from krasis_tpu.ops import rope as jrope
from krasis_tpu_torch.config import preset_config
from krasis_tpu_torch.models import model as port_model
from krasis_tpu_torch.ops import deltanet as dn
from krasis_tpu_torch.ops.norm import gated_rms_norm, rms_norm
from krasis_tpu_torch.ops.rope import apply_rope, rope_cos_sin

from torch_port_util import f32, port_params, t

DIMS = dict(num_k_heads=2, num_v_heads=4, head_k_dim=32, head_v_dim=16, conv_kernel=4)


def _bf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def test_fix_qkvz_ordering_matches_jax():
    """A wrong reshape still gives finite output, so every element is
    compared: the inputs are a running count."""
    jd, td = jdn.DeltaNetDims(**DIMS), dn.DeltaNetDims(**DIMS)
    B, S = 2, 3
    qkvz = np.arange(B * S * (2 * jd.key_dim + 2 * jd.value_dim), dtype=np.float32
                     ).reshape(B, S, -1)
    ba = np.arange(B * S * 2 * jd.num_v_heads, dtype=np.float32).reshape(B, S, -1) + 0.5
    want = jdn.fix_qkvz_ordering(jnp.asarray(qkvz), jnp.asarray(ba), jd)
    got = dn.fix_qkvz_ordering(torch.from_numpy(qkvz), torch.from_numpy(ba), td)
    assert (td.key_dim, td.value_dim, td.conv_dim) == (jd.key_dim, jd.value_dim, jd.conv_dim)
    for g, w, name in zip(got, want, "qkvzba"):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(f32(g), f32(w), err_msg=name)


@pytest.mark.parametrize("S", [1, 9])
def test_causal_conv_matches_jax(S):
    rng = np.random.default_rng(S)
    C, K = 24, 4
    x = _bf16(rng.standard_normal((2, S, C)))
    w = _bf16(rng.standard_normal((C, K)) * 0.2)
    state = _bf16(rng.standard_normal((2, K - 1, C)))
    want_y, want_s = jdn.causal_conv(x, w, state)
    got_y, got_s = dn.causal_conv(t(x), t(w), t(state))
    np.testing.assert_allclose(f32(got_y), f32(want_y), rtol=0, atol=1e-2)  # one bf16 ulp of silu
    np.testing.assert_array_equal(f32(got_s), f32(want_s))


def _rule_inputs(seed, S, B=2):
    rng = np.random.default_rng(seed)
    hk, hv, dk, dv = (DIMS[k] for k in ("num_k_heads", "num_v_heads", "head_k_dim", "head_v_dim"))
    q = rng.standard_normal((B, S, hk, dk)).astype(np.float32)
    k = rng.standard_normal((B, S, hk, dk)).astype(np.float32)
    v = rng.standard_normal((B, S, hv, dv)).astype(np.float32)
    g = -np.abs(rng.standard_normal((B, S, hv))).astype(np.float32) * 0.3
    beta = rng.uniform(0.1, 0.9, (B, S, hv)).astype(np.float32)
    state = (rng.standard_normal((B, hv, dk, dv)) * 0.1).astype(np.float32)
    return q, k, v, g, beta, state


def _both(fn_j, fn_t, args, **kw):
    want = fn_j(*(jnp.asarray(a) for a in args), **kw)
    got = fn_t(*(torch.from_numpy(a.copy()) for a in args), **kw)
    return got, want


def test_recurrent_matches_jax():
    args = _rule_inputs(0, 7)
    (o, s), (jo, js) = _both(jdn.gated_delta_rule_recurrent, dn.gated_delta_rule_recurrent, args)
    np.testing.assert_allclose(f32(o), f32(jo), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(f32(s), f32(js), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("fast,tol", [(False, 2e-5), (True, 1e-3)])
@pytest.mark.parametrize("S", [64, 150])
def test_chunked_matches_jax(fast, tol, S):
    """S = 150 pads the last of three chunks."""
    args = _rule_inputs(1 + S, S)
    (o, s), (jo, js) = _both(jdn.gated_delta_rule_chunked, dn.gated_delta_rule_chunked, args,
                             fast=fast)
    assert o.shape == (2, S, DIMS["num_v_heads"], DIMS["head_v_dim"])
    np.testing.assert_allclose(f32(o), f32(jo), rtol=tol, atol=tol * float(np.abs(jo).max()))
    np.testing.assert_allclose(f32(s), f32(js), rtol=tol, atol=tol * float(np.abs(js).max()))


def test_chunked_matches_recurrent():
    """The chunked f32 form is the recurrence, within f32 summation noise."""
    args = [torch.from_numpy(a) for a in _rule_inputs(2, 100)]
    o1, s1 = dn.gated_delta_rule_recurrent(*args)
    o2, s2 = dn.gated_delta_rule_chunked(*args, fast=False)
    np.testing.assert_allclose(f32(o2), f32(o1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f32(s2), f32(s1), rtol=1e-4, atol=1e-4)


def test_l2norm_and_gated_rms_norm_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(f32(dn.l2norm(torch.from_numpy(x))), f32(jdn.l2norm(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    xb, gate = _bf16(x), _bf16(rng.standard_normal(x.shape))
    w = _bf16(1 + 0.1 * rng.standard_normal(16))
    for plus_one in (False, True):
        want = jnorm.gated_rms_norm(xb, gate, w, 1e-6, plus_one=plus_one)
        got = gated_rms_norm(t(xb), t(gate), t(w), 1e-6, plus_one=plus_one)
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-2, atol=1e-3)   # one bf16 ulp


def test_qk_norm_and_partial_rotary_match_jax():
    """rms_norm with (1 + w) on the head dim, then NEOX rotation of the
    first 8 of 32 dims only; the other 24 pass through bit for bit."""
    rng = np.random.default_rng(4)
    x = _bf16(rng.standard_normal((2, 6, 4, 32)))
    w = _bf16(0.1 * rng.standard_normal(32))
    pos = np.arange(6)[None, :] + np.array([[3], [100]])
    want = jnorm.rms_norm(x, w, 1e-6, plus_one=True)
    got = rms_norm(t(x), t(w), 1e-6, plus_one=True)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-2, atol=1e-3)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 8, 1e7, {})
    tc, ts = rope_cos_sin(torch.from_numpy(pos), 8, 1e7, {})
    want = jrope.apply_rope(want, jc, js)
    got2 = apply_rope(t(np.asarray(jnorm.rms_norm(x, w, 1e-6, plus_one=True))), tc, ts)
    np.testing.assert_allclose(f32(got2), f32(want), rtol=1e-2, atol=1e-3)
    np.testing.assert_array_equal(f32(got2)[..., 8:], f32(jnorm.rms_norm(x, w, 1e-6, plus_one=True))[..., 8:])


HYBRID = dict(hidden_size=128, intermediate_size=256, moe_intermediate_size=128,
              num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
              vocab_size=512, head_dim=32,
              layer_types=["linear_attention"] * 3 + ["full_attention"],
              linear_num_key_heads=2, linear_num_value_heads=4,
              linear_key_head_dim=32, linear_value_head_dim=32,
              n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
              shared_expert_intermediate_size=128)
QUANT = dict(expert_bits=4, group_size=128, kv_cache_dtype="bf16", attention="int8")


def _la_layer():
    jcfg = jax_preset_config("qwen3-coder-next", **HYBRID)
    jparams = jax_init(jcfg, JaxQuantConfig(**QUANT), jax.random.PRNGKey(0))
    assert not jparams["pattern"]              # 4 layers: all unrolled, unstacked
    cfg = preset_config("qwen3-coder-next", **HYBRID)
    return jcfg, jparams["prefix_layers"][0], cfg, port_params(jparams)["layers"][0]


def _la_state(rng):
    st = (rng.standard_normal((1, 4, 32, 32)) * 0.1).astype(np.float32)
    cv = _bf16(rng.standard_normal((1, 3, 256)))
    return ({"state": jnp.asarray(st), "conv": cv},
            {"state": torch.from_numpy(st.copy()), "conv": t(cv)})


@pytest.mark.parametrize("S,n_valid,prefill", [(128, 40, True), (128, 128, True), (1, 1, False)])
def test_la_attention_matches_jax_layer(monkeypatch, S, n_valid, prefill):
    """The whole DeltaNet layer from a non-zero state and conv window; the
    JAX side runs fast=True (interpret mode), as the port always does."""
    monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    jcfg, jlp, cfg, lp = _la_layer()
    rng = np.random.default_rng(5 + S + n_valid)
    x = _bf16(rng.standard_normal((1, S, 128)))
    valid = np.arange(S)[None, :] < n_valid
    jlc, lc = _la_state(rng)
    want, jnew = jax_model._la_attention(jlp, jlc, x, jnp.asarray(valid), jcfg, prefill)
    got = port_model._la_attention(lp, lc, t(x), torch.from_numpy(valid), cfg, prefill)
    scale = float(np.abs(f32(want)).max())
    np.testing.assert_allclose(f32(got)[:, :n_valid], f32(want)[:, :n_valid], rtol=0,
                               atol=1e-2 * scale)
    np.testing.assert_allclose(f32(lc["state"]), f32(jnew["state"]), rtol=1e-3, atol=1e-5)
    np.testing.assert_array_equal(f32(lc["conv"]), f32(jnew["conv"]))


def test_padded_tail_leaves_state_and_window_untouched():
    """A chunk of 40 valid tokens padded to 128 rows ends in the same state
    and conv window as the 40 tokens alone padded to 64: padding rows write
    nothing (β = 0), decay nothing (g = 0) and stay out of the window."""
    _, _, cfg, lp = _la_layer()
    rng = np.random.default_rng(6)
    x = t(_bf16(rng.standard_normal((1, 128, 128))))
    _, lc_a = _la_state(np.random.default_rng(7))
    _, lc_b = _la_state(np.random.default_rng(7))
    valid = torch.arange(128)[None, :] < 40
    out_a = port_model._la_attention(lp, lc_a, x, valid, cfg, True)
    out_b = port_model._la_attention(lp, lc_b, x[:, :64], valid[:, :64], cfg, True)
    np.testing.assert_array_equal(f32(lc_a["conv"]), f32(lc_b["conv"]))
    np.testing.assert_array_equal(f32(lc_a["conv"]), f32(
        torch.where(valid[..., None], _mixed(lp, x, cfg), torch.zeros(()))[:, 37:40]))
    np.testing.assert_allclose(f32(lc_a["state"]), f32(lc_b["state"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(f32(out_a)[:, :40], f32(out_b)[:, :40], rtol=0, atol=1e-6)
    # and a chunk with no valid token at all changes nothing
    before = {k: v.clone() for k, v in lc_a.items()}
    port_model._la_attention(lp, lc_a, x, torch.zeros((1, 128), dtype=torch.bool), cfg, True)
    for k in before:
        np.testing.assert_array_equal(f32(lc_a[k]), f32(before[k]))


def _mixed(lp, x, cfg):
    """The conv input [q; k; v] of the layer, recomputed from its projections."""
    from krasis_tpu_torch.ops.qmm import linear
    dims = dn.DeltaNetDims(cfg.linear_num_key_heads, cfg.linear_num_value_heads,
                           cfg.linear_key_head_dim, cfg.linear_value_head_dim,
                           cfg.linear_conv_kernel_dim)
    q, k, v, *_ = dn.fix_qkvz_ordering(linear(x, lp["qkvz_proj"]), linear(x, lp["ba_proj"]), dims)
    B, S = x.shape[:2]
    return torch.cat([q.reshape(B, S, -1), k.reshape(B, S, -1), v.reshape(B, S, -1)], dim=-1)
