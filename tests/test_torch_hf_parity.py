"""Full-model parity of the port against HuggingFace transformers on tiny
random checkpoints: the six cases of tests/test_hf_parity.py (Qwen3-MoE,
DeepSeek-V2, Qwen3-Next, GPT-OSS, DeepSeek-V3 with q-LoRA and group-limited
sigmoid routing, GLM-4 MoE with partial rotary), each written with
save_pretrained, loaded through the port's loader at the reference's
FP32_QUANT in f32 leaves with 16-bit experts, and run through the port's
forward over an f32 cache: all-position logits within the reference's
tolerances and the same argmax."""

import numpy as np
import pytest
import torch

from krasis_tpu_torch.config import ModelConfig, QuantConfig
from krasis_tpu_torch.models.loader import load_params
from krasis_tpu_torch.models.model import forward
from krasis_tpu_torch.runtime.kv_cache import init_cache

from torch_ckpt_util import hf_model

pytest.importorskip("transformers")
torch.set_grad_enabled(False)

FP32_QUANT = QuantConfig(expert_bits=16, lm_head="bf16", attention="bf16",
                         shared_expert="bf16", dense_mlp="bf16", kv_cache_dtype="bf16")
# family → (atol, rtol), as tests/test_hf_parity.py holds the reference
TOLS = {"qwen3_moe": (2e-2, 2e-2), "deepseek_v2": (2e-2, 2e-2), "qwen3_next": (4e-2, 4e-2),
        "gpt_oss": (4e-2, 4e-2), "deepseek_v3": (4e-2, 4e-2), "glm4_moe": (4e-2, 4e-2)}


def _run_port(path, ids):
    cfg = ModelConfig.from_model_path(path)
    params = load_params(cfg, FP32_QUANT, dtype=torch.float32, device="cpu")
    cache = init_cache(cfg, FP32_QUANT, 1, 32, "cpu")
    for lc in cache["layers"]:              # an f32 cache, as the reference's test casts it
        for k, v in lc.items():
            if v.dtype == torch.bfloat16:
                lc[k] = v.to(torch.float32)
    logits = forward(params, torch.from_numpy(ids.astype(np.int32)),
                     torch.tensor([ids.shape[1]]), cache, cfg, FP32_QUANT, prefill=True,
                     return_all_logits=True)
    return logits[0].numpy()


@pytest.mark.parametrize("family", sorted(TOLS))
def test_hf_parity(tmp_path, family):
    model = hf_model(family)
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    ids = np.random.default_rng(0).integers(0, model.config.vocab_size, size=(1, 12))
    want = model(input_ids=torch.from_numpy(ids)).logits[0].float().numpy()
    got = _run_port(str(tmp_path), ids)
    atol, rtol = TOLS[family]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
