"""GPT-OSS through the port against the JAX package, on the tiny GPT-OSS of
tests/test_model.py (alternating sliding (window 4, so the mask truncates)
and full GQA layers, sinks, biased projections and experts, the clamped
gpt-oss activation, a softmax over the top-k router logits), with random
nonzero sinks and biases on both sides, and the Pallas kernels of the
reference in interpret mode: the attention layer on sliding and full
layers and `forward` logits for prefill chunks and decode, each with a bf16 and an fp8 cache; and `resolve_kv_quant` under "auto"
and KRASIS_TPU_KV_BYTES. The engines are in tests/test_torch_fp8_engine.py.

The tiny experts are not calmed (`calm_experts` is not needed): the
prompt seeds below give no router near-tie at the tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.config import preset_config as jax_preset_config
from krasis_tpu.models import model as jax_model
from krasis_tpu.models.params import init_synthetic_params as jax_init
from krasis_tpu.models.params import layer_specs as jax_layer_specs
from krasis_tpu.runtime import kv_cache as jax_kv
from krasis_tpu_torch.config import preset_config
from krasis_tpu_torch.models import model as port_model
from krasis_tpu_torch.runtime import kv_cache

from torch_port_util import f32, port_params, t
from torch_port_util import gptoss_cfgs as cfgs
from torch_port_util import gptoss_quants as quants
from torch_port_util import randomize_gptoss as randomize

KV = ["bf16", "fp8"]
TOL = 2e-2
MAX_LEN = 512
# fresh k / v rows may differ by one bf16 ulp between the packages; in the
# fp8 cache that is at most one e4m3 step (2^-3 relative, 2^-9 absolute)
ROW_TOL = {"bf16": (1e-2, 1e-3), "fp8": (0.13, 2e-3)}


def test_tiny_gptoss_has_its_leaves():
    jcfg, cfg = cfgs()
    jquant, quant = quants("bf16")
    params = port_params(randomize(jax_init(jcfg, jquant, jax.random.PRNGKey(0))))
    for i, lp in enumerate(params["layers"]):
        assert lp["sinks"].shape == (4,) and lp["sinks"].dtype == torch.float32
        assert float(lp["sinks"].abs().min()) > 0
        assert lp["w13_bias"].shape == (8, 64) and lp["w2_bias"].shape == (8, 64)
        assert lp["gate_logit_bias"].shape == (8,)
        assert {"q_bias", "k_bias", "v_bias", "o_bias"} <= set(lp)
        assert "shared_w13" not in lp and lp["w13"].q.shape[0] == 8
    from krasis_tpu_torch.models.params import init_synthetic_params
    own = init_synthetic_params(cfg, quant, seed=0)
    assert set(own["layers"][0]) == set(params["layers"][0])


def _rows(rng, shape, kv):
    """A random cache in the reference's layout and dtype, and the port's
    copy of the same bytes."""
    jk = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.5).astype(jnp.bfloat16)
    jk = jk.at[..., 16:].set(0)
    if kv == "fp8":
        jk = jk.astype(jnp.float8_e4m3fn)
        return jk, torch.from_numpy(np.array(jk.view(jnp.uint8))).view(torch.float8_e4m3fn)
    return jk, t(jk)


# (name, prefill, history, S, valid rows): the first chunk attends to its
# own rows, a later chunk and a decode step read the cache
STEPS = [("first_chunk", True, 0, 128, 20), ("later_chunk", True, 20, 128, 9),
         ("decode", False, 29, 1, 1)]


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("layer", [0, 1], ids=["sliding", "full"])
@pytest.mark.parametrize("name,prefill,hist,S,n", STEPS, ids=[s[0] for s in STEPS])
def test_gqa_layer_matches_jax(monkeypatch, name, prefill, hist, S, n, layer, kv):
    monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    jcfg, cfg = cfgs()
    jquant, _ = quants(kv)
    jparams = randomize(jax_init(jcfg, jquant, jax.random.PRNGKey(1)), seed=layer)
    jlp = {k: v[0] for k, v in jparams["pattern"][layer].items() if k not in ("w13", "w2")}
    lp = port_params(jparams)["layers"][layer]
    rng = np.random.default_rng(hist + layer)
    x = jnp.asarray(rng.standard_normal((1, S, 64)).astype(np.float32)).astype(jnp.bfloat16)
    jk, pk = _rows(rng, (1, 2, MAX_LEN, 128), kv)
    jv, pv = _rows(rng, (1, 2, MAX_LEN, 128), kv)
    lc = {"k": pk.clone(), "v": pv.clone()}
    pos = hist + np.arange(S)[None, :]
    kvl = np.asarray([hist + n], np.int32)
    spec = jax_layer_specs(jcfg)[layer]
    assert spec.sliding == (layer == 0)
    want, jnew = jax_model._gqa_attention(jlp, {"k": jk, "v": jv}, x, jnp.asarray(pos),
                                          jnp.asarray(kvl), jcfg, spec, prefill, history=hist)
    got = port_model._gqa_attention(lp, lc, t(x), torch.from_numpy(pos), torch.from_numpy(kvl),
                                    cfg, spec.sliding, prefill and hist == 0)
    scale = float(np.abs(f32(want)).max())
    np.testing.assert_allclose(f32(got)[:, :n], f32(want)[:, :n], rtol=0, atol=TOL * scale)
    rows = slice(hist, hist + n)
    rtol, atol = ROW_TOL[kv]
    for key in ("k", "v"):
        assert lc[key].dtype == (torch.float8_e4m3fn if kv == "fp8" else torch.bfloat16)
        np.testing.assert_allclose(f32(lc[key])[:, :, rows],
                                   np.asarray(jnew[key], np.float32)[:, :, rows],
                                   rtol=rtol, atol=atol)


def _jax_forward(jparams, tok, n, jcache, jcfg, jquant, prefill, history):
    return jax_model.forward(jparams, jnp.asarray(tok), jnp.asarray([n], jnp.int32), jcache,
                             jcfg, jquant, prefill=prefill, history=history)


@pytest.mark.parametrize("kv", KV)
def test_forward_matches_jax(monkeypatch, kv):
    """Two prefill chunks (40 and 30 tokens, each padded to 128 rows, the
    second over the first's cache), then three greedy decode steps fed the
    JAX side's tokens: logits within 2e-2 of the larger of 1 and their
    largest magnitude, as tests/test_torch_model.py."""
    monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    jcfg, cfg = cfgs()
    jquant, quant = quants(kv)
    jparams = randomize(jax_init(jcfg, jquant, jax.random.PRNGKey(0)))
    params = port_params(jparams)
    cache = kv_cache.init_cache(cfg, quant, 1, MAX_LEN, "cpu")
    jcache = jax_kv.init_cache(jcfg, jquant, 1, MAX_LEN)
    assert cache["layers"][0]["k"].dtype == (torch.float8_e4m3fn if kv == "fp8"
                                             else torch.bfloat16)

    def close(got, want, what):
        err = float(np.abs(f32(got) - f32(want)).max())
        scale = max(1.0, float(np.abs(f32(want)).max()))
        assert err <= TOL * scale, f"{what}: max|Δ| {err} vs scale {scale}"

    rng = np.random.default_rng(5)
    n1, n2 = 40, 30
    prompt = rng.integers(1, 256, size=n1 + n2)
    for n, chunk, hist in ((n1, prompt[:n1], 0), (n2, prompt[n1:], n1)):
        tok = np.zeros((1, 128), np.int32)
        tok[0, :n] = chunk
        jl, jcache = _jax_forward(jparams, tok, n, jcache, jcfg, jquant, True,
                                  0 if hist == 0 else 128)
        pl_ = port_model.forward(params, torch.from_numpy(tok).long(),
                                 torch.tensor([n], dtype=torch.int32), cache, cfg, quant,
                                 prefill=True, history=hist)
        close(pl_, jl, f"prefill logits after {hist + n} tokens")
    nxt = int(np.argmax(f32(jl)[0]))
    for step in range(3):
        jl, jcache = _jax_forward(jparams, np.asarray([[nxt]], np.int32), 1, jcache, jcfg,
                                  jquant, False, 0)
        pl_ = port_model.forward(params, torch.tensor([[nxt]]), torch.ones(1, dtype=torch.int32),
                                 cache, cfg, quant, prefill=False)
        assert torch.isfinite(pl_).all()
        close(pl_, jl, f"decode step {step} logits")
        nxt = int(np.argmax(f32(jl)[0]))


@pytest.mark.parametrize("budget", [None, str(1 << 20)])
@pytest.mark.parametrize("preset,max_len", [("gpt-oss-20b", 4096), ("gpt-oss-20b", 131072),
                                            ("deepseek-v2-lite", 4096),
                                            ("deepseek-v2-lite", 131072)])
def test_resolve_kv_quant_matches_reference(monkeypatch, preset, max_len, budget):
    if budget is None:
        monkeypatch.delenv("KRASIS_TPU_KV_BYTES", raising=False)
    else:
        monkeypatch.setenv("KRASIS_TPU_KV_BYTES", budget)
    jcfg, cfg = jax_preset_config(preset), preset_config(preset)
    jquant, quant = quants("auto")
    want = jax_kv.resolve_kv_quant(jcfg, jquant, 1, max_len).kv_cache_dtype
    got = kv_cache.resolve_kv_quant(cfg, quant, 1, max_len).kv_cache_dtype
    assert got == want
    assert kv_cache.kv_bytes_per_token(cfg) == jax_kv.kv_bytes_per_token(jcfg)
    if budget is None and preset == "gpt-oss-20b":
        # 24 layers x 2 buffers x 8 kv heads x 128 lanes: 12.9 GB in bf16 at
        # 131,072 tokens, past the 4 GiB budget; 6.4 GB in e4m3
        assert got == ("fp8" if max_len == 131072 else "bf16")
        assert kv_cache.kv_bytes_per_token(cfg, 1) * 131072 == 6442450944


@pytest.mark.parametrize("T", [1, 16])
def test_lm_head_qmm_matches_jax(monkeypatch, T):
    """The int8 lm_head's shape class, K = 2880 at gs 32 (K/gs = 90, which
    qmm_pallas declines, so the reference takes qmm_ref): the port's qmm
    (K1's plain version at T ≤ 16) against JAX linear on the same bytes."""
    monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    from krasis_tpu.ops.qmm import linear as jax_linear
    from krasis_tpu.quant import quantize as jax_quantize
    from krasis_tpu_torch.ops.qmm import linear

    from torch_port_util import tq

    rng = np.random.default_rng(T)
    w = jax_quantize(jnp.asarray(rng.standard_normal((2880, 384)).astype(np.float32) * 0.02),
                     bits=8, group_size=32)
    x = jnp.asarray(rng.standard_normal((T, 2880)).astype(np.float32)).astype(jnp.bfloat16)
    want = jax_linear(x, w, out_dtype=jnp.float32)
    got = linear(t(x), tq(w), out_dtype=torch.float32)
    np.testing.assert_allclose(f32(got), f32(want), rtol=TOL, atol=TOL)
