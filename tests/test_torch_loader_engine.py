"""Greedy generation on loaded checkpoints: the port's Engine.generate on
the port's load against the JAX engine on the reference's load of the same
tiny checkpoint, at the default QuantConfig (int4 experts, int8 decode
activations, folded shared experts). The tiny random models' logits are
nearly flat (std ~0.16, port and JAX within ~0.007 of each other), so most
prompts put some greedy step on a near-tie. The prompt seeds and token
counts (SEEDS) were picked, with the port, so that no compared step's
choice lies within LOGIT_TOL of a tie; the test measures that smallest
top-2 logit gap again and requires it above LOGIT_TOL, so a mismatch is a
fault, not a rounding coin-flip."""

import numpy as np
import pytest
import torch

from krasis_tpu.config import ModelConfig as JaxModelConfig
from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.models.loader import load_params as jax_load_params
from krasis_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from krasis_tpu.runtime.engine import Engine as JaxEngine
from krasis_tpu_torch.config import ModelConfig, QuantConfig
from krasis_tpu_torch.models.loader import load_params
from krasis_tpu_torch.runtime.engine import Engine

from torch_ckpt_util import FAMILIES, write_checkpoint

QUANT = dict(kv_cache_dtype="bf16")
LOGIT_TOL = 2e-2
# family → (prompt seed, new tokens)
SEEDS = {"qwen3_moe": (10, 4), "deepseek_v2": (5, 6), "qwen3_next": (5, 6),
         "gpt_oss": (13, 6), "deepseek_v3": (7, 6), "glm4_moe": (25, 6),
         "gpt_oss_mxfp4": (19, 6), "fp8": (14, 6), "ct_int4": (18, 4)}


def _min_top2_gap(eng: Engine, prompt, tokens) -> float:
    eng.reset(256)
    gaps = []
    with torch.inference_mode():
        logits = eng._prefill_prompt(prompt)
        for tok in tokens:
            top = torch.topk(logits[0], 2).values
            gaps.append(float(top[0] - top[1]))
            logits = eng._forward(torch.tensor([[tok]]), torch.ones(1, dtype=torch.int32),
                                  prefill=False)
    return min(gaps)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("ckpts")


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_tokens_equal_jax_engine(root, tmp_path, monkeypatch, family):
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path / "home"))
    path = write_checkpoint(family, root)
    jcfg = JaxModelConfig.from_model_path(path)
    jeng = JaxEngine(jcfg, JaxQuantConfig(**QUANT), jax_load_params(jcfg, JaxQuantConfig(**QUANT)),
                     max_len=256)
    cfg = ModelConfig.from_model_path(path)
    eng = Engine(cfg, QuantConfig(**QUANT), load_params(cfg, QuantConfig(**QUANT), device="cpu"),
                 max_len=256, device="cpu")

    seed, new = SEEDS[family]
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=12).tolist()
    want = jeng.generate(prompt, max_new_tokens=new, stop_ids={-1},
                         sampling=JaxSamplingParams(temperature=0.0)).tokens
    got = eng.generate(prompt, max_new_tokens=new, stop_ids={-1})
    assert got.finite
    gap = _min_top2_gap(eng, prompt, want)
    assert got.tokens == want, gap
    assert gap > LOGIT_TOL, gap
