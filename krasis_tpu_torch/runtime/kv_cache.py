"""Slot cache: KV buffers and recurrent state per layer (PyTorch).

Layouts as the reference's (``krasis_tpu/runtime/kv_cache.py``), one dict
per layer, plus the per-slot valid ``length``:

* MLA: ``{"kv": [B, 1, S, pad128(L + Dr)]}`` holding ``[ckv ; kpe ; 0]``
  rows, so attention reads one buffer and V is the latent prefix of K;
* GQA: ``{"k", "v": [B, Hkv, S, pad128(d)]}`` bf16, two buffers;
* Gated DeltaNet: ``{"state": [B, Hv, dk, dv] f32, "conv": [B, K-1,
  conv_dim] bf16}``: O(1) per sequence, no KV.

The port updates the cache in place (the reference returns a new cache
that XLA aliases through donation).
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
    """Zeroed cache: {"layers": [one dict per layer], "length": [B] int32}."""
    quant = resolve_kv_quant(cfg, quant, batch, max_len)
    if quant.kv_cache_dtype != "bf16":
        raise NotImplementedError("the fp8 KV cache is not ported yet")

    def zeros(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = []
    for spec in layer_specs(cfg):
        if spec.attn_kind == "mla":
            Dp = lane_pad(cfg.kv_lora_rank + cfg.qk_rope_head_dim)
            layers.append({"kv": zeros((batch, 1, max_len, Dp))})
        elif spec.attn_kind == "gqa":
            shape = (batch, cfg.num_key_value_heads, max_len, lane_pad(cfg.qk_head_dim))
            layers.append({"k": zeros(shape), "v": zeros(shape)})
        else:
            hk, hv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
            dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
            conv_dim = 2 * hk * dk + hv * dv
            layers.append({
                "state": zeros((batch, hv, dk, dv), torch.float32),
                "conv": zeros((batch, cfg.linear_conv_kernel_dim - 1, conv_dim)),
            })
    return {"layers": layers,
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}
