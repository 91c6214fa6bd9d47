"""Slot cache for MLA models (PyTorch).

Layout as the reference's (``krasis_tpu/runtime/kv_cache.py``): one
``[B, 1, S, pad128(L + Dr)]`` buffer per MLA layer holding ``[ckv ; kpe ; 0]``
rows, so attention reads one buffer and V is the latent prefix of K, plus
the per-slot valid ``length``. The port updates the cache in place (the
reference returns a new cache that XLA aliases through donation).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict

import torch

from ..config import ModelConfig, QuantConfig
from ..models.params import layer_specs

# "auto" kv dtype: bf16 caches up to this many bytes, fp8 beyond.
DEFAULT_KV_BUDGET = 4 << 30


def lane_pad(d: int) -> int:
    return -(-d // 128) * 128


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    total = 0
    for spec in layer_specs(cfg):
        if spec.attn_kind == "gqa":
            total += 2 * cfg.num_key_value_heads * lane_pad(cfg.qk_head_dim)
        elif spec.attn_kind == "mla":
            total += lane_pad(cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    return total * dtype_bytes


def resolve_kv_quant(cfg: ModelConfig, quant: QuantConfig, batch: int,
                     max_len: int) -> QuantConfig:
    """"auto" → bf16 when the full cache fits DEFAULT_KV_BUDGET, else fp8."""
    if quant.kv_cache_dtype != "auto":
        return quant
    need = batch * max_len * kv_bytes_per_token(cfg, 2)
    return replace(quant, kv_cache_dtype="bf16" if need <= DEFAULT_KV_BUDGET else "fp8")


def init_cache(cfg: ModelConfig, quant: QuantConfig, batch: int, max_len: int,
               device) -> Dict[str, Any]:
    """Zeroed cache: {"layers": [{"kv": [B, 1, S, Dp]}], "length": [B] int32}."""
    quant = resolve_kv_quant(cfg, quant, batch, max_len)
    if quant.kv_cache_dtype != "bf16":
        raise NotImplementedError("the fp8 KV cache is not ported yet")
    layers = []
    for spec in layer_specs(cfg):
        if spec.attn_kind != "mla":
            raise NotImplementedError(f"{spec.attn_kind} caches are not ported yet")
        Dp = lane_pad(cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        layers.append({"kv": torch.zeros((batch, 1, max_len, Dp),
                                         dtype=torch.bfloat16, device=device)})
    return {"layers": layers,
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}
