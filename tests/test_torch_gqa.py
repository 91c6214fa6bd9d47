"""K2 with a separate V tensor (GQA): its plain version against the Pallas
`flash_attention` / `decode_attention` in interpret mode at GQA grouping
(8 query heads on 2 kv heads), and the port's `_gqa_attention` against the
JAX layer: first chunk, a chunk over history, and decode. Tolerance 2e-2,
the reference's own for its attention kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.config import preset_config as jax_preset_config
from krasis_tpu.models import model as jax_model
from krasis_tpu.models.params import init_synthetic_params as jax_init
from krasis_tpu.models.params import layer_specs as jax_layer_specs
from krasis_tpu.ops import flash_attention as jfa
from krasis_tpu_torch.config import QuantConfig, preset_config
from krasis_tpu_torch.models import model as port_model
from krasis_tpu_torch.models.params import init_synthetic_params
from krasis_tpu_torch.ops import flash_attention as tfa

from torch_port_util import f32, port_params, t

HQ, HKV, D, DP = 8, 2, 32, 128        # head dim 32 in a 128-lane cache row


def _bf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def _padded(rng, shape, d=D, dp=DP):
    a = np.zeros(shape[:-1] + (dp,), np.float32)
    a[..., :d] = rng.standard_normal(shape[:-1] + (d,))
    return _bf16(a)


def test_flash_plain_separate_v_matches_pallas_first_chunk():
    rng = np.random.default_rng(1)
    S = 128
    q = _bf16(rng.standard_normal((2, S, HQ, D)))
    k = _bf16(rng.standard_normal((2, S, HKV, D)))
    v = _bf16(rng.standard_normal((2, S, HKV, D)))
    qo = jnp.zeros((2,), jnp.int32)
    kl = jnp.asarray([S, 77], jnp.int32)
    want = jfa.flash_attention(q, k, v, qo, kl, D ** -0.5, interpret=True)
    got = tfa.flash_attention(t(q), t(k).transpose(1, 2), t(qo), t(kl), D ** -0.5, D,
                              v=t(v).transpose(1, 2))
    assert got.shape == (2, S, HQ, D)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)


def test_flash_plain_separate_v_matches_pallas_chunk_over_cache():
    """Second chunk at q_off = 128 over lane-padded K and V caches."""
    rng = np.random.default_rng(2)
    Sq, Skv = 128, 256
    q = _padded(rng, (1, Sq, HQ, D))
    k, v = _padded(rng, (1, HKV, Skv, D)), _padded(rng, (1, HKV, Skv, D))
    qo = jnp.full((1,), 128, jnp.int32)
    kl = jnp.full((1,), 200, jnp.int32)
    want = jfa.flash_attention(q, k, v, qo, kl, D ** -0.5, kv_layout="bhsd",
                               interpret=True)[..., :D]
    got = tfa.flash_attention(t(q), t(k), t(qo), t(kl), D ** -0.5, D, v=t(v))
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)
    # V really is the second tensor: with V = K lanes the result differs
    wrong = tfa.flash_attention(t(q), t(k), t(qo), t(kl), D ** -0.5, D)
    assert float(np.abs(f32(wrong) - f32(want)).max()) > 0.1


def test_decode_plain_separate_v_matches_pallas():
    rng = np.random.default_rng(3)
    S = 512
    q = _padded(rng, (2, 1, HQ, D))
    k, v = _padded(rng, (2, HKV, S, D)), _padded(rng, (2, HKV, S, D))
    kl = jnp.asarray([300, 17], jnp.int32)
    want = jfa.decode_attention(q, k, v, kl, D ** -0.5, interpret=True)[..., :D]
    got = tfa.decode_attention(t(q), t(k), t(kl), D ** -0.5, D, v=t(v))
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)


HYBRID = dict(hidden_size=128, intermediate_size=256, moe_intermediate_size=128,
              num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
              vocab_size=512, head_dim=32,
              layer_types=["linear_attention"] * 3 + ["full_attention"],
              linear_num_key_heads=2, linear_num_value_heads=4,
              linear_key_head_dim=32, linear_value_head_dim=32,
              n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
              shared_expert_intermediate_size=128)
MAX_LEN = 256


@pytest.mark.parametrize("attention", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("S,n_valid,hist,prefill", [(128, 40, 0, True), (128, 90, 128, True),
                                                    (1, 1, 50, False)])
def test_gqa_attention_matches_jax_layer(monkeypatch, attention, S, n_valid, hist, prefill):
    """The Qwen3-Next attention layer (gated q, qk-norm with 1 + w, 8 of 32
    dims rotated) from a cache that already holds `hist` rows: the layer's
    output at the valid rows and the K / V rows it wrote."""
    monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    jcfg = jax_preset_config("qwen3-coder-next", **HYBRID)
    jquant = JaxQuantConfig(expert_bits=4, group_size=128, kv_cache_dtype="bf16",
                            attention=attention)
    jparams = jax_init(jcfg, jquant, jax.random.PRNGKey(1))
    jlp = jparams["prefix_layers"][3]
    # non-trivial norm weights (the synthetic ones are all zero)
    rng = np.random.default_rng(S + n_valid)
    jlp = {**jlp, "q_norm": _bf16(0.2 * rng.standard_normal(D)),
           "k_norm": _bf16(0.2 * rng.standard_normal(D))}
    cfg = preset_config("qwen3-coder-next", **HYBRID)
    lp = port_params({**jparams, "prefix_layers": [jlp]})["layers"][0]

    x = _bf16(rng.standard_normal((1, S, 128)))
    k0, v0 = _padded(rng, (1, 2, MAX_LEN, D)), _padded(rng, (1, 2, MAX_LEN, D))
    # the reference's first chunk attends within the chunk only; the port
    # always reads the cache, which then holds nothing older
    fresh = prefill and hist == 0
    lc = {"k": torch.zeros_like(t(k0)) if fresh else t(k0).clone(),
          "v": torch.zeros_like(t(v0)) if fresh else t(v0).clone()}
    pos = hist + np.arange(S)[None, :]
    kvl = np.asarray([hist + n_valid], np.int32)
    want, jnew = jax_model._gqa_attention(
        jlp, {"k": k0, "v": v0}, x, jnp.asarray(pos), jnp.asarray(kvl), jcfg,
        jax_layer_specs(jcfg)[3], prefill, history=hist if prefill else 0)
    got = port_model._gqa_attention(lp, lc, t(x), torch.from_numpy(pos),
                                    torch.from_numpy(kvl), cfg)
    scale = float(np.abs(f32(want)).max())
    np.testing.assert_allclose(f32(got)[:, :n_valid], f32(want)[:, :n_valid], rtol=0,
                               atol=2e-2 * scale)
    rows = slice(hist, hist + S)
    for name in ("k", "v"):
        np.testing.assert_allclose(f32(lc[name])[:, :, rows], f32(jnew[name])[:, :, rows],
                                   rtol=1e-2, atol=1e-3)    # one bf16 ulp


def test_gqa_cache_scatter_drops_rows_past_the_end():
    """A padded chunk whose tail runs past the cache writes only the rows
    that exist."""
    cfg = preset_config("qwen3-coder-next", **HYBRID)
    lp = init_synthetic_params(cfg, QuantConfig(expert_bits=4), seed=0, device="cpu")["layers"][3]
    lc = {"k": torch.zeros((1, 2, 160, DP), dtype=torch.bfloat16),
          "v": torch.zeros((1, 2, 160, DP), dtype=torch.bfloat16)}
    x = torch.randn((1, 128, 128), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    pos = 100 + torch.arange(128)[None, :]
    out = port_model._gqa_attention(lp, lc, x, pos, torch.tensor([110], dtype=torch.int32), cfg)
    assert torch.isfinite(out.float()).all()
    assert float(lc["k"][:, :, :100].abs().max()) == 0.0
    assert float(lc["k"][:, :, 100:160, :D].abs().sum(dim=-1).min()) > 0.0
