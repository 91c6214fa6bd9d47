"""The port's leaf ops against the JAX package's functions on the same
numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.ops.activations import swiglu as jswiglu
from krasis_tpu.ops.attention import attend as jattend
from krasis_tpu.ops.attention import build_mask as jbuild_mask
from krasis_tpu.ops.norm import rms_norm as jrms_norm
from krasis_tpu.ops.qmm import qmm_ref as jqmm_ref
from krasis_tpu.ops.rope import apply_rope as japply_rope
from krasis_tpu.ops.rope import rope_cos_sin as jrope_cos_sin
from krasis_tpu.ops.rope import yarn_softmax_scale as jyarn_scale
from krasis_tpu.ops.routing import compute_routing as jrouting
from krasis_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from krasis_tpu.ops.sampling import sample as jsample
from krasis_tpu.quant import quantize as jquantize
from krasis_tpu_torch.config import preset_config
from krasis_tpu_torch.models.synthetic import tiny_config
from krasis_tpu_torch.ops.activations import swiglu
from krasis_tpu_torch.ops.attention import attend, build_mask
from krasis_tpu_torch.ops.norm import rms_norm
from krasis_tpu_torch.ops.qmm import linear
from krasis_tpu_torch.ops.rope import apply_rope, rope_cos_sin, yarn_softmax_scale
from krasis_tpu_torch.ops.routing import compute_routing
from krasis_tpu_torch.ops.sampling import SamplingParams, sample, sample_batched

from torch_port_util import f32, t, tq

V2 = preset_config("deepseek-v2-lite")


def _bf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = _bf16(rng.standard_normal((3, 5, 512)) * 3)
    w = _bf16(rng.uniform(0.5, 1.5, 512))
    np.testing.assert_allclose(f32(rms_norm(t(x), t(w), 1e-6)), f32(jrms_norm(x, w, 1e-6)),
                               rtol=1e-2, atol=1e-2)


def test_interleaved_yarn_rope_matches():
    rng = np.random.default_rng(1)
    pos = np.array([[0, 1, 7, 4095], [100, 2047, 3000, 9]], np.int32)
    x = _bf16(rng.standard_normal((2, 4, 16, 64)))
    jc, js = jrope_cos_sin(jnp.asarray(pos), 64, V2.rope_theta, V2.rope_scaling)
    c, s = rope_cos_sin(torch.from_numpy(pos), 64, V2.rope_theta, V2.rope_scaling)
    np.testing.assert_allclose(f32(c), f32(jc), atol=1e-5)
    want = japply_rope(x, jc, js, interleaved=True)
    got = apply_rope(t(x), c, s, interleaved=True)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-2, atol=1e-2)
    base = (V2.qk_nope_head_dim + V2.qk_rope_head_dim) ** -0.5
    assert yarn_softmax_scale(base, V2.rope_scaling) == jyarn_scale(base, V2.rope_scaling)


def test_swiglu_matches():
    rng = np.random.default_rng(2)
    h = _bf16(rng.standard_normal((7, 256)) * 2)
    np.testing.assert_array_equal(f32(swiglu(t(h))), f32(jswiglu(h)))


def test_routing_matches():
    rng = np.random.default_rng(3)
    cfg = tiny_config("deepseek-v2-lite", n_routed_experts=16, num_experts_per_tok=6)
    x = _bf16(rng.standard_normal((32, 128)))
    g = jnp.asarray(rng.standard_normal((128, 16)) * 0.3, jnp.float32)
    want = jrouting(x, g, cfg)
    got = compute_routing(t(x), t(g), cfg)
    np.testing.assert_array_equal(got.topk_idx.numpy(), np.asarray(want.topk_idx))
    np.testing.assert_allclose(got.topk_weights.numpy(), np.asarray(want.topk_weights),
                               atol=1e-6)


def test_greedy_sample_matches():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 1000)).astype(np.float32)
    logits[1, 17] = logits[1, 900] = 50.0           # a tie: the first index wins
    want = jsample(None, jnp.asarray(logits), JaxSamplingParams(temperature=0.0))
    got = sample(torch.from_numpy(logits), SamplingParams(temperature=0.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    temp = torch.tensor([0.0, 0.0, 0.0])
    got_b = sample_batched(torch.from_numpy(logits), temp, torch.full((3,), 0.9),
                           torch.zeros(3), torch.zeros((3, 1000), dtype=torch.bool))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want))


def test_temperature_sample_stays_in_nucleus():
    logits = torch.full((1, 50), -10.0)
    logits[0, [3, 5, 9]] = torch.tensor([2.0, 1.9, 1.8])
    gen = torch.Generator().manual_seed(0)
    draws = {int(sample(logits, SamplingParams(0.7, top_k=3, top_p=0.95), gen)[0])
             for _ in range(200)}
    assert draws == {3, 5, 9}


def test_mask_and_attend_match():
    rng = np.random.default_rng(5)
    q = _bf16(rng.standard_normal((2, 6, 4, 32)))
    k = _bf16(rng.standard_normal((2, 10, 2, 32)))
    v = _bf16(rng.standard_normal((2, 10, 2, 16)))
    qpos = np.array([[4, 5, 6, 7, 8, 9], [0, 1, 2, 3, 4, 5]], np.int32)
    kl = np.array([10, 4], np.int32)
    jm = jbuild_mask(jnp.asarray(qpos), jnp.arange(10), jnp.asarray(kl))
    m = build_mask(torch.from_numpy(qpos), torch.arange(10), torch.from_numpy(kl))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(f32(attend(t(q), t(k), t(v), m, 0.2)),
                               f32(jattend(q, k, v, jm, 0.2)), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("bits", [4, 8])
def test_linear_many_rows_matches_qmm_ref(bits):
    """Past the few-row kernel's threshold a quantized linear is the
    reference's qmm_ref: dequantize, then one f32-accumulated product."""
    rng = np.random.default_rng(6)
    w = jquantize(jnp.asarray(rng.standard_normal((256, 384)) * 0.05, jnp.float32),
                  bits=bits, group_size=128)
    x = _bf16(rng.standard_normal((64, 256)))
    np.testing.assert_allclose(f32(linear(t(x), tq(w))), f32(jqmm_ref(x, w)),
                               rtol=2e-2, atol=2e-2)
