"""The port's Engine.generate against the JAX engine (Pallas kernels in
interpret mode) on the tiny Qwen3-Coder-Next hybrid: identical greedy
streams for attention bf16, int8 and int4 and for bf16 expert activations,
for a prompt of one chunk and for one prefilled in three chunks of 128
(each later chunk starts from the DeltaNet state and conv window the
earlier one left)."""

import numpy as np
import pytest
import torch

from krasis_tpu.models.synthetic import build_synthetic_engine as jax_build
from krasis_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from krasis_tpu_torch.runtime.engine import Engine

from torch_port_util import calm_experts, hybrid_cfgs, hybrid_quants, port_params

NEW = 8
# The two sides' logits agree to 0.01 - 0.03 (test_torch_hybrid); a greedy
# choice is only comparable where the two best logits lie further apart.
LOGIT_TOL = 3.5e-2

# (attention, expert activation, prompt length, chunk, prompt seed): seeds
# were chosen so that no step's greedy choice lies within LOGIT_TOL of a
# tie, so a mismatch is a fault and not a rounding coin-flip.
CASES = [
    ("bf16", "int8", 100, 2048, 36),
    ("int8", "int8", 100, 2048, 36),
    ("int4", "int8", 100, 2048, 36),
    ("int8", "bf16", 100, 2048, 36),
    ("bf16", "int8", 300, 128, 5),
    ("int8", "int8", 300, 128, 5),
    ("int4", "int8", 300, 128, 7),
]


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


def _engines(attention, activation, chunk):
    jcfg, cfg = hybrid_cfgs()
    jquant, quant = hybrid_quants(attention, activation)
    jeng = jax_build(jcfg, jquant, max_len=4096, seed=0)
    jeng.params = calm_experts(jeng.params)
    jeng.chunk = chunk
    eng = Engine(cfg, quant, port_params(jeng.params), max_len=4096, device="cpu")
    eng.chunk = chunk
    return jeng, eng


@pytest.mark.parametrize("attention,activation,n,chunk,seed", CASES)
def test_hybrid_generate_matches_jax_engine(monkeypatch, attention, activation, n, chunk, seed):
    monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    jeng, eng = _engines(attention, activation, chunk)
    prompt = np.random.default_rng(seed).integers(1, 512, size=n).tolist()
    want = jeng.generate(prompt, max_new_tokens=NEW, stop_ids={-1},
                         sampling=JaxSamplingParams(temperature=0.0)).tokens
    got = eng.generate(prompt, max_new_tokens=NEW, stop_ids={-1})
    assert got.finite and len(got.tokens) == NEW
    assert got.tokens == want
    assert _min_top2_gap(eng, prompt, want) > LOGIT_TOL
