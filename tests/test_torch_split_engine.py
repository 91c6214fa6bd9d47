"""K2's split decode form at model level (ROADMAP C, the check owed since
split-KV decode came to the card): the port's decode attention runs through
`decode_split_plain` + `decode_combine_plain`, the functions of the split
and combine launches that the card runs for Sq·G ≤ 64 stacked rows, by a
test-local replacement of the wrapper's CPU branch (the package has no such
switch), against the JAX engine with Pallas decode in interpret mode. Tiny
GPT-OSS (sinks, window 4) and tiny DeepSeek-V2-Lite, on prompts without
router near-ties: identical greedy streams, and teacher-forced decode logits
within 5e-2 of the larger of 1 and their largest magnitude."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.models import model as jax_model
from krasis_tpu.models.synthetic import build_synthetic_engine as jax_build
from krasis_tpu.models.synthetic import tiny_config as jax_tiny_config
from krasis_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from krasis_tpu.runtime import kv_cache as jax_kv
from krasis_tpu_torch.config import QuantConfig
from krasis_tpu_torch.models import model as port_model
from krasis_tpu_torch.models.synthetic import tiny_config
from krasis_tpu_torch.ops import flash_attention as tfa
from krasis_tpu_torch.runtime import kv_cache
from krasis_tpu_torch.runtime.engine import Engine

from torch_port_util import f32, gptoss_cfgs, gptoss_quants, port_params, randomize_gptoss

LOGIT_TOL = 5e-2
V2L = dict(moe_intermediate_size=128, num_hidden_layers=4)


def split_form(monkeypatch):
    """Route the model's attention calls of at most MAX_SPLIT_ROWS stacked
    rows through the split form's plain versions; returns their count."""
    whole = tfa.flash_attention
    calls = {"split": 0}

    def attention(q, kv, q_offset, kv_len, scale, v_dim, v=None, qk_dim=None, window=0,
                  sinks=None):
        B, Sq, Hq, _ = q.shape
        Hkv, S = kv.shape[1], kv.shape[2]
        if Sq * (Hq // Hkv) > tfa.MAX_SPLIT_ROWS:
            return whole(q, kv, q_offset, kv_len, scale, v_dim, v, qk_dim, window, sinks)
        calls["split"] += 1
        chunk, _ = tfa.split_plan(S, Hkv, B)
        o, m, l = tfa.decode_split_plain(q, kv, q_offset, kv_len, scale, v_dim, chunk, v,
                                         qk_dim, window)
        return tfa._unstack(tfa.decode_combine_plain(o, m, l, sinks), Sq)

    monkeypatch.setattr(port_model, "flash_attention", attention)
    return calls


def models(family):
    """(JAX engine, port engine, port config, port quant) on the same
    weights, bf16 caches."""
    if family == "gpt-oss":
        (jcfg, cfg), (jquant, quant) = gptoss_cfgs(), gptoss_quants("bf16")
    else:
        kw = dict(expert_bits=4, group_size=128, kv_cache_dtype="bf16")
        jcfg, cfg = jax_tiny_config("deepseek-v2-lite", **V2L), tiny_config("deepseek-v2-lite",
                                                                               **V2L)
        jquant, quant = JaxQuantConfig(**kw), QuantConfig(**kw)
    jeng = jax_build(jcfg, jquant, max_len=1024, seed=0)
    if family == "gpt-oss":
        jeng.params = randomize_gptoss(jeng.params)
    eng = Engine(cfg, quant, port_params(jeng.params), max_len=1024, device="cpu")
    return jeng, eng, jcfg, jquant


# (family, prompt length, prompt seed, vocabulary)
CASES = [("gpt-oss", 100, 21, 256), ("v2-lite", 100, 13, 512)]


@pytest.mark.parametrize("family,n,seed,vocab", CASES, ids=[c[0] for c in CASES])
def test_split_decode_matches_jax_engine(monkeypatch, family, n, seed, vocab):
    monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    jeng, eng, jcfg, jquant = models(family)
    calls = split_form(monkeypatch)
    prompt = np.random.default_rng(seed).integers(1, vocab, size=n).tolist()
    want = jeng.generate(prompt, max_new_tokens=16, stop_ids={-1},
                         sampling=JaxSamplingParams(temperature=0.0))
    got = eng.generate(prompt, max_new_tokens=16, stop_ids={-1})
    # every decode forward took the split form in every attention layer
    assert calls["split"] >= (len(got.tokens) - 1) * jcfg.num_hidden_layers
    assert got.finite
    assert got.tokens == want.tokens

    # teacher-forced: the same prefill, then 8 decode steps fed the stream
    tok = np.zeros((1, 128), np.int32)
    tok[0, :n] = prompt
    cache = kv_cache.init_cache(eng.cfg, eng.quant, 1, 512, "cpu")
    jcache = jax_kv.init_cache(jcfg, jquant, 1, 512)
    _, jcache = jax_model.forward(jeng.params, jnp.asarray(tok), jnp.asarray([n], jnp.int32),
                                  jcache, jcfg, jquant, prefill=True)
    port_model.forward(eng.params, torch.from_numpy(tok).long(),
                       torch.tensor([n], dtype=torch.int32), cache, eng.cfg, eng.quant,
                       prefill=True)
    before = calls["split"]
    for step, nxt in enumerate(want.tokens[:8]):
        jl, jcache = jax_model.forward(jeng.params, jnp.asarray([[nxt]], jnp.int32),
                                       jnp.asarray([1], jnp.int32), jcache, jcfg, jquant,
                                       prefill=False)
        pl_ = port_model.forward(eng.params, torch.tensor([[nxt]]),
                                 torch.ones(1, dtype=torch.int32), cache, eng.cfg, eng.quant,
                                 prefill=False)
        err = float(np.abs(f32(pl_) - f32(jl)).max())
        scale = max(1.0, float(np.abs(f32(jl)).max()))
        assert err <= LOGIT_TOL * scale, f"decode step {step}: max|Δ| {err} vs scale {scale}"
    assert calls["split"] - before == 8 * jcfg.num_hidden_layers
