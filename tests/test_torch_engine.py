"""The port's Engine.generate against the JAX engine (Pallas kernels in
interpret mode) on a tiny DeepSeek-V2-Lite: identical greedy streams over
16 tokens for a short prompt and for a prompt chunked at 128 tokens."""

import numpy as np
import pytest
import torch

from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.models.synthetic import build_synthetic_engine as jax_build
from krasis_tpu.models.synthetic import tiny_config as jax_tiny_config
from krasis_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from krasis_tpu_torch.config import QuantConfig
from krasis_tpu_torch.models.synthetic import build_synthetic_engine, tiny_config
from krasis_tpu_torch.runtime.engine import Engine

from torch_port_util import port_params

OVERRIDES = dict(moe_intermediate_size=128, num_hidden_layers=4)
QUANT = dict(expert_bits=4, group_size=128, kv_cache_dtype="bf16")
NEW = 16
LOGIT_TOL = 2e-2

# (prompt length, chunk, prompt seed, smallest top-2 logit gap over the 16
# compared steps, measured with the port). Seeds were chosen so that no
# step's greedy choice lies within the logit tolerance of a tie, so a
# mismatch is a fault, not a rounding coin-flip.
CASES = [(100, 2048, 13, 0.0674), (300, 128, 15, 0.0476)]


def _min_top2_gap(eng: Engine, prompt, tokens) -> float:
    """Teacher-force the stream through the port and return the smallest
    gap between the two largest logits at each step."""
    eng.reset(2048)
    gaps = []
    with torch.inference_mode():
        logits = eng._prefill_prompt(prompt)
        for tok in tokens:
            top = torch.topk(logits[0], 2).values
            gaps.append(float(top[0] - top[1]))
            logits = eng._forward(torch.tensor([[tok]]), torch.ones(1, dtype=torch.int32),
                                  prefill=False)
    return min(gaps)


@pytest.mark.parametrize("n,chunk,seed,gap", CASES)
def test_generate_matches_jax_engine(monkeypatch, n, chunk, seed, gap):
    monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    jcfg = jax_tiny_config("deepseek-v2-lite", **OVERRIDES)
    jeng = jax_build(jcfg, JaxQuantConfig(**QUANT), max_len=4096, seed=0)
    jeng.chunk = chunk
    eng = Engine(tiny_config("deepseek-v2-lite", **OVERRIDES), QuantConfig(**QUANT),
                 port_params(jeng.params), max_len=4096, device="cpu")
    eng.chunk = chunk

    prompt = np.random.default_rng(seed).integers(1, 512, size=n).tolist()
    want = jeng.generate(prompt, max_new_tokens=NEW, stop_ids={-1},
                         sampling=JaxSamplingParams(temperature=0.0)).tokens
    got = eng.generate(prompt, max_new_tokens=NEW, stop_ids={-1})
    assert got.finite
    assert got.tokens == want
    smallest = _min_top2_gap(eng, prompt, want)
    assert smallest > LOGIT_TOL, smallest
    assert smallest == pytest.approx(gap, abs=5e-3)


def test_build_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_synthetic_engine(tiny_config("deepseek-v2-lite", **OVERRIDES),
                               QuantConfig(**QUANT))
