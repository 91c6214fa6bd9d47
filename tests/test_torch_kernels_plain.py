"""Each port kernel's plain PyTorch version against the Pallas kernel it
replaces, run in interpret mode on the CPU, on the same numpy inputs.

Tolerances are the reference's own kernel tests' (tests/test_pallas.py):
2e-2 for qmm and attention, 3e-2 for the MoE kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.ops import flash_attention as jfa
from krasis_tpu.ops.gmm_pallas import gmm_fused_supported, moe_prefill_pallas
from krasis_tpu.ops.moe_pallas import moe_gathered_pallas, moe_gathered_w4a8_pallas
from krasis_tpu.ops.qmm_pallas import qmm_pallas
from krasis_tpu.quant import quantize as jquantize
from krasis_tpu.quant import random_qtensor as jrandom_qtensor
from krasis_tpu_torch.ops import flash_attention as tfa
from krasis_tpu_torch.ops.gmm_cuda import moe_prefill
from krasis_tpu_torch.ops.moe_cuda import moe_bf16, moe_w4a8
from krasis_tpu_torch.ops.qmm_cuda import qmm

from torch_port_util import f32, t, tq


def _bf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("T", [1, 8])
def test_qmm_plain_matches_pallas(bits, T):
    rng = np.random.default_rng(10 + bits + T)
    K, N = 256, 384
    w = jquantize(jnp.asarray(rng.standard_normal((K, N)) * 0.05, jnp.float32),
                  bits=bits, group_size=128)
    x = _bf16(rng.standard_normal((T, K)) * 0.5)
    want = qmm_pallas(x, w, out_dtype=jnp.float32, interpret=True)
    got = qmm(t(x), tq(w), out_dtype=torch.float32)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)


H, L, DR = 4, 512, 64           # MLA absorbed: D = L + DR, V = first L lanes
SCALE = (128 + DR) ** -0.5


def test_flash_plain_matches_pallas_mla_first_chunk():
    rng = np.random.default_rng(1)
    S = 128
    q = _bf16(rng.standard_normal((1, S, H, L + DR)))
    k = _bf16(rng.standard_normal((1, S, 1, L + DR)))
    qo = jnp.zeros((1,), jnp.int32)
    kl = jnp.full((1,), S, jnp.int32)
    want = jfa.flash_attention(q, k, None, qo, kl, SCALE, v_from_k=True, v_dim=L,
                               interpret=True)
    got = tfa.flash_attention(t(q), t(k).transpose(1, 2), t(qo), t(kl), SCALE, L)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)


def test_flash_plain_matches_pallas_chunked_bhsd():
    """Second chunk at q_off > 0 over the cache prefix in kernel layout."""
    rng = np.random.default_rng(2)
    Sq, Skv, Dp = 128, 256, 640
    q = np.zeros((1, Sq, H, Dp), np.float32)
    q[..., :L + DR] = rng.standard_normal((1, Sq, H, L + DR))
    cache = np.zeros((1, 1, Skv, Dp), np.float32)
    cache[..., :L + DR] = rng.standard_normal((1, 1, Skv, L + DR))
    q, cache = _bf16(q), _bf16(cache)
    qo = jnp.full((1,), 128, jnp.int32)
    kl = jnp.full((1,), 200, jnp.int32)
    want = jfa.flash_attention(q, cache, None, qo, kl, SCALE, v_from_k=True, v_dim=L,
                               kv_layout="bhsd", interpret=True)
    got = tfa.flash_attention(t(q), t(cache), t(qo), t(kl), SCALE, L)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)


def test_flash_plain_matches_pallas_ragged_kv_len():
    rng = np.random.default_rng(3)
    S = 128
    q = _bf16(rng.standard_normal((2, S, H, L + DR)))
    k = _bf16(rng.standard_normal((2, S, 1, L + DR)))
    qo = jnp.zeros((2,), jnp.int32)
    kl = jnp.asarray([100, 37], jnp.int32)
    want = jfa.flash_attention(q, k, None, qo, kl, SCALE, v_from_k=True, v_dim=L,
                               interpret=True)
    got = tfa.flash_attention(t(q), t(k).transpose(1, 2), t(qo), t(kl), SCALE, L)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)


def test_decode_plain_matches_pallas_mla():
    rng = np.random.default_rng(4)
    S, Dp = 512, 640
    q = np.zeros((2, 1, H, Dp), np.float32)
    q[..., :L + DR] = rng.standard_normal((2, 1, H, L + DR))
    cache = np.zeros((2, 1, S, Dp), np.float32)
    cache[..., :L + DR] = rng.standard_normal((2, 1, S, L + DR))
    q, cache = _bf16(q), _bf16(cache)
    kl = jnp.asarray([300, 17], jnp.int32)
    want = jfa.decode_attention(q, cache, None, kl, SCALE, v_from_k=True, v_dim=L,
                                interpret=True)
    got = tfa.decode_attention(t(q), t(cache), t(kl), SCALE, L)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)


def _experts(seed, E, Hd, I, bits=4):
    k13, k2 = jax.random.split(jax.random.PRNGKey(seed))
    w13 = jrandom_qtensor(k13, (E, Hd, 2 * I), bits, group_size=128, scale_mag=0.03)
    w2 = jrandom_qtensor(k2, (E, I, Hd), bits, group_size=128, scale_mag=0.03)
    return w13, w2


def test_moe_w4a8_plain_matches_pallas_with_virtual_experts():
    """8 picks per token: 6 routed of 8 experts plus the 2 folded shared
    experts (stack rows 8, 9) with weight 1."""
    rng = np.random.default_rng(5)
    E, Hd, I, T = 10, 256, 128, 2
    w13, w2 = _experts(5, E, Hd, I)
    x = _bf16(rng.standard_normal((T, Hd)) * 0.5)
    routed = np.stack([rng.permutation(8)[:6] for _ in range(T)])
    idx = jnp.asarray(np.concatenate([routed, np.tile([8, 9], (T, 1))], 1), jnp.int32)
    wts = np.concatenate([rng.uniform(0.05, 0.3, (T, 6)), np.ones((T, 2))], 1)
    wts = jnp.asarray(wts, jnp.float32)
    want = moe_gathered_w4a8_pallas(x, w13, w2, idx, wts, interpret=True)
    got = moe_w4a8(t(x), tq(w13), tq(w2), t(idx), t(wts))
    np.testing.assert_allclose(f32(got), f32(want), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("bits", [4, 8])
def test_moe_bf16_plain_matches_pallas_with_virtual_expert(bits):
    """K5: 3 picks per token, 2 routed of 8 experts plus the folded shared
    expert (stack row 8) weighted by a per-token gate."""
    rng = np.random.default_rng(7 + bits)
    E, Hd, I, T = 9, 256, 128, 2
    w13, w2 = _experts(7, E, Hd, I, bits)
    x = _bf16(rng.standard_normal((T, Hd)) * 0.5)
    routed = np.stack([rng.permutation(8)[:2] for _ in range(T)])
    idx = jnp.asarray(np.concatenate([routed, np.full((T, 1), 8)], 1), jnp.int32)
    wts = jnp.asarray(np.concatenate([rng.uniform(0.2, 0.8, (T, 2)),
                                      rng.uniform(0.3, 0.7, (T, 1))], 1), jnp.float32)
    want = moe_gathered_pallas(x, w13, w2, idx, wts, interpret=True)
    got = moe_bf16(t(x), tq(w13), tq(w2), t(idx), t(wts))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), rtol=3e-2, atol=3e-2)


def test_moe_prefill_plain_matches_fused_pallas():
    rng = np.random.default_rng(6)
    E, Hd, I, T, k = 8, 256, 128, 48, 2
    w13, w2 = _experts(6, E, Hd, I)
    assert gmm_fused_supported(w13, w2)      # not the legacy gmm path
    x = _bf16(rng.standard_normal((T, Hd)) * 0.5)
    idx = jnp.asarray(np.stack([rng.permutation(E)[:k] for _ in range(T)]), jnp.int32)
    wts = jnp.asarray(rng.uniform(0.1, 1.0, (T, k)), jnp.float32)
    want = moe_prefill_pallas(x, w13, w2, idx, wts, interpret=True)
    got = moe_prefill(t(x), tq(w13), tq(w2), t(idx), t(wts))
    np.testing.assert_allclose(f32(got), f32(want), rtol=3e-2, atol=3e-2)
