"""K2's sliding-window, sink and fp8-cache forms, in their plain PyTorch
versions, against the JAX package's `flash_attention` / `decode_attention`
in interpret mode on the same numpy inputs; the port's fp8 cache cast
against the reference's; and `compute_routing` on each of its branches
against the JAX function.

Tolerance 2e-2 for attention, the reference's own (tests/test_pallas.py).
Sinks are random and nonzero."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.config import preset_config as jax_preset_config
from krasis_tpu.ops import flash_attention as jfa
from krasis_tpu.ops.attention import attend as jattend
from krasis_tpu.ops.attention import build_mask as jbuild_mask
from krasis_tpu.ops.routing import compute_routing as jax_routing
from krasis_tpu_torch.config import preset_config
from krasis_tpu_torch.ops import flash_attention as tfa
from krasis_tpu_torch.ops.attention import attend, build_mask
from krasis_tpu_torch.ops.routing import compute_routing
from krasis_tpu_torch.runtime.kv_cache import to_cache

from torch_port_util import f32, t

TOL = 2e-2
L, DR, DP = 512, 64, 640        # MLA: scores over L + DR lanes of DP, V = first L


def _bf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def _gqa(rng, B, Sq, S, Hq=4, Hkv=2, d=64, dp=64, q_std=1.0):
    """q [B, Sq, Hq, dp] and k, v [B, Hkv, S, dp] in bf16, d real lanes."""
    def rows(shape, std):
        a = np.zeros(shape[:-1] + (dp,), np.float32)
        a[..., :d] = std * rng.standard_normal(shape[:-1] + (d,))
        return _bf16(a)
    return (rows((B, Sq, Hq, d), q_std), rows((B, Hkv, S, d), 1.0),
            rows((B, Hkv, S, d), 1.0))


# (name, B, Sq, S, q_offset, kv_len, window): the first chunk of a prompt, a
# chunk over the cache at q_off > window, and S = 4 with window 4
PREFILL = [("first_chunk", 1, 128, 128, [0], [100], 32),
           ("chunk_over_cache", 2, 64, 256, [160, 96], [224, 150], 64),
           ("s4_window4", 1, 4, 4, [0], [4], 4)]


@pytest.mark.parametrize("sinks_on", [True, False], ids=["sinks", "no_sinks"])
@pytest.mark.parametrize("name,B,Sq,S,qo,kl,window", PREFILL, ids=[c[0] for c in PREFILL])
def test_flash_window_sinks_match_jax(name, B, Sq, S, qo, kl, window, sinks_on):
    """The one-launch form's plain version with a window (and sinks)
    against JAX flash_attention on the cache layout."""
    rng = np.random.default_rng(len(name) + Sq)
    q, k, v = _gqa(rng, B, Sq, S, q_std=0.4)
    sinks = jnp.asarray(rng.standard_normal(4).astype(np.float32)) if sinks_on else None
    qo, kl = jnp.asarray(qo, jnp.int32), jnp.asarray(kl, jnp.int32)
    scale = 64 ** -0.5
    want = jfa.flash_attention(q, k, v, qo, kl, scale, window=window, sinks=sinks,
                               block_q=64, block_k=64, interpret=True, kv_layout="bhsd")
    got = tfa.flash_attention(t(q), t(k), t(qo), t(kl), scale, 64, v=t(v), window=window,
                              sinks=None if sinks is None else t(sinks))
    _close(got[:, :, :, :], want)
    # the window changes the answer at these shapes: the check can see it
    if window < S:
        full = tfa.flash_attention_plain(t(q), t(k), t(qo), t(kl), scale, 64, t(v),
                                         sinks=None if sinks is None else t(sinks))
        assert float((full.float() - got.float()).abs().max()) > 10 * TOL


def test_mask_and_attend_window_sinks_match_jax():
    """The dense f32 semantics: build_mask with a window, attend with sinks."""
    rng = np.random.default_rng(5)
    q = _bf16(rng.standard_normal((2, 6, 4, 32)))
    k = _bf16(rng.standard_normal((2, 10, 2, 32)))
    v = _bf16(rng.standard_normal((2, 10, 2, 16)))
    sinks = rng.standard_normal(4).astype(np.float32)
    qpos = np.array([[4, 5, 6, 7, 8, 9], [0, 1, 2, 3, 4, 5]], np.int32)
    kl = np.array([10, 4], np.int32)
    jm = jbuild_mask(jnp.asarray(qpos), jnp.arange(10), jnp.asarray(kl), window=3)
    m = build_mask(torch.from_numpy(qpos), torch.arange(10), torch.from_numpy(kl), window=3)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(f32(attend(t(q), t(k), t(v), m, 0.2, t(sinks))),
                               f32(jattend(q, k, v, jm, 0.2, jnp.asarray(sinks))),
                               rtol=TOL, atol=TOL)


# (Sq, kv_len per row): rows below and above the window of 64
DECODE = [(1, [40, 200]), (2, [63, 180])]


@pytest.mark.parametrize("Sq,kl", DECODE, ids=["sq1", "sq2"])
def test_split_decode_sinks_window_match_jax(Sq, kl):
    """decode_split_plain + decode_combine_plain, the sink joining once in
    the combine, against JAX decode_attention (interpret); and a combine
    that adds the sink in every split disagrees."""
    rng = np.random.default_rng(Sq)
    B, S, Hq, Hkv, window = 2, 256, 8, 2, 64
    q, k, v = _gqa(rng, B, Sq, S, Hq, Hkv)
    # sinks near the rows' largest scores, so that the sink term weighs
    sinks = jnp.asarray(3.0 + rng.standard_normal(Hq).astype(np.float32))
    kl = jnp.asarray(kl, jnp.int32)
    scale = 64 ** -0.5
    want = jfa.decode_attention(q, k, v, kl, scale, window=window, sinks=sinks,
                                block_k=64, interpret=True)
    chunk, n = tfa.split_plan(S, Hkv, B)
    o, m, l = tfa.decode_split_plain(t(q), t(k), t(kl) - Sq, t(kl), scale, 64, chunk, t(v),
                                     window=window)
    got = tfa._unstack(tfa.decode_combine_plain(o, m, l, t(sinks)), Sq)
    _close(got, want)
    # the second row's first split lies wholly before its window: no key
    assert bool((m[1, :, 0] <= tfa.NEG_INF / 2).all())
    # a sink added inside each live split counts it several times
    live = (m > tfa.NEG_INF / 2).to(torch.float32)
    rs = tfa._row_sinks(t(sinks), Hkv, Sq * Hq // Hkv)
    ms = m.amax(dim=2)
    wrong = tfa._unstack(tfa.decode_combine_plain(
        o, m, l + live * torch.exp(rs[None, :, None] - torch.where(
            m > tfa.NEG_INF / 2, m, torch.zeros_like(m)))), Sq)
    assert live.sum(dim=2).max() > 1 and torch.isfinite(ms).all()
    rms = float(t(want).float().square().mean().sqrt())
    assert float((wrong.float() - t(want).float()).abs().max()) > 5 * TOL * rms


def test_split_matches_one_launch_with_sinks_and_window():
    """Both launch forms compute one function: split + combine equals the
    one-launch plain version within rounding."""
    rng = np.random.default_rng(3)
    q, k, v = _gqa(rng, 1, 1, 512, 8, 1, q_std=0.5)
    sinks = t(rng.standard_normal(8).astype(np.float32))
    kl = torch.tensor([300], dtype=torch.int32)
    chunk, _ = tfa.split_plan(512, 1, 1)
    o, m, l = tfa.decode_split_plain(t(q), t(k), kl - 1, kl, 0.125, 64, chunk, t(v), window=128)
    got = tfa._unstack(tfa.decode_combine_plain(o, m, l, sinks), 1)
    want = tfa.flash_attention_plain(t(q), t(k), kl - 1, kl, 0.125, 64, t(v), window=128,
                                     sinks=sinks)
    _close(got, want)


def _fp8(a):
    """A bf16 JAX array cast as the reference casts its cache rows."""
    return jnp.asarray(a).astype(jnp.float8_e4m3fn)


def test_fp8_cast_matches_reference_on_every_bf16():
    """to_cache rounds all 65,536 bf16 values to the bytes the reference's
    cast gives, NaN where it gives NaN (torch alone would saturate)."""
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    want = jnp.asarray(bits).view(jnp.bfloat16).astype(jnp.float8_e4m3fn)
    got = to_cache(torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16),
                   torch.float8_e4m3fn)
    want_b = np.asarray(want.view(jnp.uint8))
    got_b = got.view(torch.uint8).numpy()
    nan_w = np.isnan(np.asarray(want.astype(jnp.float32)))
    nan_g = torch.isnan(got.to(torch.float32)).numpy()
    assert (nan_w == nan_g).all()
    assert (want_b[~nan_w] == got_b[~nan_g]).all()
    assert nan_w.sum() > 1000          # |x| > 464, the infinities and the NaNs


@pytest.mark.parametrize("form", ["prefill", "decode"])
def test_fp8_gqa_cache_matches_jax(form):
    """GQA over an e4m3 cache with 64 real lanes of 128, V in its own buffer:
    the port's plain versions against the JAX kernels reading the same
    bytes, and the fp8 form equal to the bf16 form on the widened cache."""
    rng = np.random.default_rng(11)
    B, S, Sq = 1, 256, (64 if form == "prefill" else 1)
    q, k, v = _gqa(rng, B, Sq, S, 8, 2, d=64, dp=128, q_std=0.4)
    k8, v8 = _fp8(k), _fp8(v)
    tk8, tv8 = to_cache(t(k), torch.float8_e4m3fn), to_cache(t(v), torch.float8_e4m3fn)
    assert (tk8.view(torch.uint8).numpy() == np.asarray(k8.view(jnp.uint8))).all()
    sinks = jnp.asarray(rng.standard_normal(8).astype(np.float32))
    kl = jnp.asarray([200], jnp.int32)
    scale = 64 ** -0.5
    if form == "prefill":
        qo = jnp.asarray([136], jnp.int32)
        want = jfa.flash_attention(q, k8, v8, qo, kl, scale, window=128, sinks=sinks,
                                   block_q=64, block_k=64, interpret=True, kv_layout="bhsd")
        got = tfa.flash_attention(t(q), tk8, t(qo), t(kl), scale, 64, tv8, 64, window=128,
                                  sinks=t(sinks))
        wide = tfa.flash_attention(t(q), tk8.to(torch.bfloat16), t(qo), t(kl), scale, 64,
                                   tv8.to(torch.bfloat16), 64, window=128, sinks=t(sinks))
    else:
        want = jfa.decode_attention(q, k8, v8, kl, scale, window=128, sinks=sinks,
                                    block_k=64, interpret=True)
        chunk, _ = tfa.split_plan(S, 2, B)
        o, m, l = tfa.decode_split_plain(t(q), tk8, t(kl) - 1, t(kl), scale, 64, chunk, tv8,
                                         64, window=128)
        got = tfa._unstack(tfa.decode_combine_plain(o, m, l, t(sinks)), 1)
        o, m, l = tfa.decode_split_plain(t(q), tk8.to(torch.bfloat16), t(kl) - 1, t(kl), scale,
                                         64, chunk, tv8.to(torch.bfloat16), 64, window=128)
        wide = tfa._unstack(tfa.decode_combine_plain(o, m, l, t(sinks)), 1)
    _close(got[..., :64], want[..., :64])
    assert torch.equal(got, wide)


@pytest.mark.parametrize("form", ["prefill", "decode"])
def test_fp8_mla_cache_matches_jax(form):
    """MLA over an e4m3 [ckv; kpe] cache, 576 real lanes of 640, V the first
    512 lanes of K (v_from_k)."""
    rng = np.random.default_rng(12)
    B, S, Sq = 1, 256, (64 if form == "prefill" else 1)
    q = np.zeros((B, Sq, 16, DP), np.float32)
    q[..., :L + DR] = 0.15 * rng.standard_normal((B, Sq, 16, L + DR))
    cache = np.zeros((B, 1, S, DP), np.float32)
    cache[..., :L + DR] = rng.standard_normal((B, 1, S, L + DR))
    q, cache = _bf16(q), _bf16(cache)
    c8 = _fp8(cache)
    tc8 = to_cache(t(cache), torch.float8_e4m3fn)
    kl = jnp.asarray([230], jnp.int32)
    scale = (128 + DR) ** -0.5
    if form == "prefill":
        qo = jnp.asarray([166], jnp.int32)
        want = jfa.flash_attention(q, c8, None, qo, kl, scale, v_from_k=True, v_dim=L,
                                   block_q=64, block_k=64, interpret=True, kv_layout="bhsd")
        got = tfa.flash_attention(t(q), tc8, t(qo), t(kl), scale, L, qk_dim=L + DR)
        wide = tfa.flash_attention(t(q), tc8.to(torch.bfloat16), t(qo), t(kl), scale, L,
                                   qk_dim=L + DR)
    else:
        want = jfa.decode_attention(q, c8, None, kl, scale, v_from_k=True, v_dim=L,
                                    interpret=True)
        chunk, _ = tfa.split_plan(S, 1, B)
        o, m, l = tfa.decode_split_plain(t(q), tc8, t(kl) - 1, t(kl), scale, L, chunk,
                                         qk_dim=L + DR)
        got = tfa._unstack(tfa.decode_combine_plain(o, m, l), 1)
        o, m, l = tfa.decode_split_plain(t(q), tc8.to(torch.bfloat16), t(kl) - 1, t(kl), scale,
                                         L, chunk, qk_dim=L + DR)
        wide = tfa._unstack(tfa.decode_combine_plain(o, m, l), 1)
    _close(got, want)
    assert torch.equal(got, wide)


# compute_routing: (preset, overrides, correction bias, logit bias)
ROUTING = {
    "softmax": ("deepseek-v2-lite", dict(n_routed_experts=16, num_experts_per_tok=4), False,
                False),
    "softmax_norm_scaled": ("deepseek-v2-lite", dict(n_routed_experts=16, num_experts_per_tok=4,
                                                     norm_topk_prob=True,
                                                     routed_scaling_factor=2.5), False, False),
    "sigmoid_bias": ("deepseek-v2-lite", dict(n_routed_experts=16, num_experts_per_tok=4,
                                              scoring_func="sigmoid", norm_topk_prob=True,
                                              has_router_bias=True), True, False),
    "group_limited": ("deepseek-v2-lite", dict(n_routed_experts=32, num_experts_per_tok=4,
                                               scoring_func="sigmoid", n_group=4, topk_group=2,
                                               norm_topk_prob=True, has_router_bias=True,
                                               routed_scaling_factor=2.5), True, False),
    "gpt_oss": ("gpt-oss-20b", {}, False, True),
}


@pytest.mark.parametrize("case", list(ROUTING))
def test_compute_routing_matches_jax(case):
    preset, over, corr, logit = ROUTING[case]
    cfg, jcfg = preset_config(preset, **over), jax_preset_config(preset, **over)
    E, H, T = cfg.n_routed_experts, 64, 24
    rng = np.random.default_rng(len(case))
    x = _bf16(rng.standard_normal((T, H)))
    gate = jnp.asarray(rng.standard_normal((H, E)).astype(np.float32) * 0.3)
    cb = jnp.asarray(rng.standard_normal(E).astype(np.float32) * 0.2) if corr else None
    lb = jnp.asarray(rng.standard_normal(E).astype(np.float32) * 0.5) if logit else None
    want = jax_routing(x, gate, jcfg, cb, logit_bias=lb)
    got = compute_routing(t(x), t(gate), cfg, None if cb is None else t(cb),
                          logit_bias=None if lb is None else t(lb))
    np.testing.assert_array_equal(got.topk_idx.numpy(), np.asarray(want.topk_idx))
    np.testing.assert_allclose(got.topk_weights.numpy(), np.asarray(want.topk_weights),
                               rtol=1e-6, atol=1e-6)
    if case == "group_limited":
        # every pick lies in one of the topk_group groups
        groups = got.topk_idx.numpy() // (E // cfg.n_group)
        assert max(len(set(row)) for row in groups) <= cfg.topk_group


@pytest.mark.parametrize("name", ["gpt-oss-20b", "gpt-oss-120b"])
def test_gptoss_presets_equal_reference(name):
    cfg, jcfg = preset_config(name), jax_preset_config(name)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
