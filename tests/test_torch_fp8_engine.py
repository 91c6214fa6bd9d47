"""Engine.generate over bf16 and fp8 KV caches against the JAX engine (the
reference's Pallas kernels in interpret mode), greedy, on the same weights:
the tiny GPT-OSS of tests/test_model.py with random nonzero sinks and biases
(window 4; a 300-token prompt in chunks of 128, so the later chunks read the
cache across the window, then 16 tokens), and a tiny DeepSeek-V2-Lite with
an fp8 cache (the MLA e4m3 form at model level, V inside K). Streams must be
identical; each case's seed leaves no greedy step within the logit
tolerance of a tie (`min_top2_gap`)."""

import numpy as np
import pytest
import torch

from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.models.synthetic import build_synthetic_engine as jax_build
from krasis_tpu.models.synthetic import tiny_config as jax_tiny_config
from krasis_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from krasis_tpu_torch.config import QuantConfig
from krasis_tpu_torch.models.synthetic import tiny_config
from krasis_tpu_torch.runtime.engine import Engine

from torch_port_util import gptoss_cfgs as cfgs
from torch_port_util import gptoss_quants as quants
from torch_port_util import port_params
from torch_port_util import randomize_gptoss as randomize

KV = ["bf16", "fp8"]
TOL = 2e-2
FP8 = torch.float8_e4m3fn


def engines(kv, max_len=1024, chunk=128):
    """(JAX engine, port engine) on the same randomized tiny GPT-OSS, both
    prefilling in chunks of `chunk` tokens."""
    jcfg, cfg = cfgs()
    jquant, quant = quants(kv)
    jeng = jax_build(jcfg, jquant, max_len=max_len, seed=0)
    jeng.params = randomize(jeng.params)
    jeng.chunk = chunk
    eng = Engine(cfg, quant, port_params(jeng.params), max_len=max_len, device="cpu")
    eng.chunk = chunk
    return jeng, eng


def min_top2_gap(eng, prompt, tokens) -> float:
    """The smallest gap between the two largest logits over the teacher-
    forced steps of `tokens` through the port."""
    eng.reset(1024)
    gaps = []
    with torch.inference_mode():
        logits = eng._prefill_prompt(prompt)
        for tok in tokens:
            top = torch.topk(logits[0], 2).values
            gaps.append(float(top[0] - top[1]))
            logits = eng._forward(torch.tensor([[tok]]), torch.ones(1, dtype=torch.int32),
                                  prefill=False)
    return min(gaps)


@pytest.mark.parametrize("kv", KV)
def test_generate_matches_jax_engine(monkeypatch, kv):
    """A 300-token prompt in chunks of 128 (the later chunks read the cache
    across the window), then 16 greedy tokens: identical streams."""
    monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    jeng, eng = engines(kv)
    assert eng.cache["layers"][1]["k"].dtype == (FP8 if kv == "fp8" else torch.bfloat16)
    prompt = np.random.default_rng(21).integers(1, 256, size=300).tolist()
    want = jeng.generate(prompt, max_new_tokens=16, stop_ids={-1},
                         sampling=JaxSamplingParams(temperature=0.0))
    got = eng.generate(prompt, max_new_tokens=16, stop_ids={-1})
    assert got.finite
    assert got.tokens == want.tokens
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=5e-2)
    assert min_top2_gap(eng, prompt, want.tokens) > TOL


V2L = dict(moe_intermediate_size=128, num_hidden_layers=4)


def test_v2lite_fp8_generate_matches_jax_engine(monkeypatch):
    """MLA over an e4m3 [ckv; kpe] cache: a 300-token prompt in chunks of
    128, whose first chunk attends to its own bf16 rows while the later
    chunks and decode read the fp8 cache."""
    n, chunk, seed = 300, 128, 15
    monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    kw = dict(expert_bits=4, group_size=128, kv_cache_dtype="fp8")
    jeng = jax_build(jax_tiny_config("deepseek-v2-lite", **V2L), JaxQuantConfig(**kw),
                     max_len=1024, seed=0)
    jeng.chunk = chunk
    eng = Engine(tiny_config("deepseek-v2-lite", **V2L), QuantConfig(**kw),
                 port_params(jeng.params), max_len=1024, device="cpu")
    eng.chunk = chunk
    assert eng.cache["layers"][0]["kv"].dtype == FP8
    prompt = np.random.default_rng(seed).integers(1, 512, size=n).tolist()
    want = jeng.generate(prompt, max_new_tokens=16, stop_ids={-1},
                         sampling=JaxSamplingParams(temperature=0.0))
    got = eng.generate(prompt, max_new_tokens=16, stop_ids={-1})
    assert got.finite
    assert got.tokens == want.tokens
    assert min_top2_gap(eng, prompt, want.tokens) > TOL
