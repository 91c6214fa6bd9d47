"""Slot cache: KV buffers and recurrent state per layer (PyTorch).

Layouts as the reference's (``krasis_tpu/runtime/kv_cache.py``), one dict
per layer, plus the per-slot valid ``length``:

* MLA: ``{"kv": [B, 1, S, pad128(L + Dr)]}`` holding ``[ckv ; kpe ; 0]``
  rows, so attention reads one buffer and V is the latent prefix of K;
* GQA: ``{"k", "v": [B, Hkv, S, pad128(d)]}``, two buffers;
* Gated DeltaNet: ``{"state": [B, Hv, dk, dv] f32, "conv": [B, K-1,
  conv_dim] bf16}``: O(1) per sequence, no KV.

KV buffers hold bf16 or, with ``kv_cache_dtype="fp8"``, e4m3
(``torch.float8_e4m3fn``), written through ``to_cache`` and widened to
bf16 inside K2. The port updates the cache in place (the reference returns
a new cache that XLA aliases through donation).
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..config import ModelConfig, QuantConfig
from ..models.params import layer_specs, mtp_layer_spec
from ..parallel.mesh import copy_row, slot_layers

# "auto" kv dtype: bf16 caches up to this many bytes (KRASIS_TPU_KV_BYTES
# overrides), fp8 beyond.
DEFAULT_KV_BUDGET = 4 << 30
# bf16 values past this magnitude round beyond e4m3's largest finite value
# (448); the reference's cast gives NaN there, torch's saturates.
_FP8_OVERFLOW = 464.0


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
    """"auto" → bf16 when the full cache fits the budget
    (``KRASIS_TPU_KV_BYTES``, default DEFAULT_KV_BUDGET), else fp8."""
    if quant.kv_cache_dtype != "auto":
        return quant
    budget = int(os.environ.get("KRASIS_TPU_KV_BYTES", DEFAULT_KV_BUDGET))
    need = batch * max_len * kv_bytes_per_token(cfg, 2)
    return replace(quant, kv_cache_dtype="bf16" if need <= budget else "fp8")


def kv_dtype(quant: QuantConfig) -> torch.dtype:
    return torch.float8_e4m3fn if quant.kv_cache_dtype == "fp8" else torch.bfloat16


def to_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows rounded to the cache's dtype as the reference's cast of its
    bf16 rows rounds them: through bf16, and for e4m3 round to nearest
    even with NaN where the value rounds past 448 (torch would saturate).
    An f32 cache (the parity tests') takes the rows as they are."""
    if dtype == torch.float32:
        return x.to(dtype)
    x = x.to(torch.bfloat16)
    if dtype == torch.float8_e4m3fn:
        x = torch.where(x.abs() > _FP8_OVERFLOW, torch.full_like(x, float("nan")), x)
    return x.to(dtype)


def store(buf: torch.Tensor, index, rows: torch.Tensor) -> None:
    """buf[index] = to_cache(rows, buf.dtype); an fp8 buffer is written
    through its bytes."""
    rows = to_cache(rows, buf.dtype)
    if buf.dtype == torch.float8_e4m3fn:
        buf, rows = buf.view(torch.uint8), rows.view(torch.uint8)
    buf[index] = rows


class CacheRows(NamedTuple):
    """Where one pass writes its new rows in the cache buffers [B, H, S, D]:
    batch row `b` and position `pos` of each row written. Decode writes
    every row, a position past the end clamped to the last with `keep`
    False there; prefill writes the rows inside the cache, `take` their flat
    indices among the pass's B·n rows."""
    b: torch.Tensor
    pos: torch.Tensor
    keep: Optional[torch.Tensor] = None
    take: Optional[torch.Tensor] = None


def cache_rows(positions: torch.Tensor, S: int, decode: Optional[bool] = None) -> CacheRows:
    """The writes of rows at positions [B, n] into buffers of S rows: rows
    at positions ≥ S are dropped, as the reference's scatter drops them.
    The decode form (`decode`, by default when n == 1: a decode step's row
    or a verify step's n) takes no host sync; the prefill form one (the
    count of rows kept). Every layer's buffers share S, so a pass computes
    this once."""
    B, n = positions.shape
    bidx = torch.arange(B, device=positions.device)[:, None].expand(B, n)
    keep = positions < S
    if n == 1 if decode is None else decode:
        return CacheRows(bidx, positions.clamp(max=S - 1), keep)
    take = keep.reshape(-1).nonzero()[:, 0]
    return CacheRows(bidx.reshape(-1)[take], positions.reshape(-1)[take], take=take)


def settle_dropped(new: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor,
                   last: int) -> torch.Tensor:
    """new [B, n, ...]: the values of writes at the clamped positions pos [B,
    n], where the dropped ones (keep False) sit at `last` and carry the
    value there before the write. With n > 1 a row may write `last` twice
    (a kept row there and dropped ones); give every such write the value
    the kept one writes, or the old one where none does, so that duplicate
    writes agree."""
    if new.shape[1] == 1:
        return new
    at_last = pos == last
    j = (2 * (at_last & keep).to(torch.int32) + at_last.to(torch.int32)).argmax(dim=1)
    final = new[torch.arange(new.shape[0], device=new.device), j]
    wide = at_last.reshape(at_last.shape + (1,) * (new.dim() - 2))
    return torch.where(wide, final[:, None], new)


def store_rows(buf: torch.Tensor, at: CacheRows, rows: torch.Tensor,
               head=slice(None)) -> None:
    """buf[b, head, pos] = rows [B, n, ...] where `at` writes them; in decode
    a dropped row rewrites the last cache row with the bytes it ends with."""
    if at.take is not None:
        store(buf, (at.b, head, at.pos), rows.reshape((-1,) + rows.shape[2:])[at.take])
        return
    rows = to_cache(rows, buf.dtype)
    if buf.dtype == torch.float8_e4m3fn:
        buf, rows = buf.view(torch.uint8), rows.view(torch.uint8)
    index = (at.b, head, at.pos)
    old = buf[index]
    new = torch.where(at.keep.reshape(at.keep.shape + (1,) * (old.dim() - 2)), rows, old)
    buf[index] = settle_dropped(new, at.pos, at.keep, buf.shape[2] - 1)


def insert_slot(decode_cache: Dict[str, Any], prefill_cache: Dict[str, Any],
                slot: int, key: str = "layers") -> None:
    """Copy the batch-1 `prefill_cache` into row `slot` of `decode_cache`, in
    place: every layer's buffers (MLA kv, GQA k / v, DeltaNet state and
    conv) and the slot's length. The counterpart of the reference's
    ``krasis_tpu/runtime/scheduler.py`` ``insert_slot``. Caches laid out
    over a mesh (``parallel/mesh.cache_shardings``) copy into the slot's dp
    group, shard by shard."""
    layers, row = slot_layers(decode_cache, slot, key)
    copy_row(layers, prefill_cache[key], row)
    decode_cache["length"][slot] = prefill_cache["length"][0]


def insert_mtp_slot(decode_mtp: Dict[str, Any], prefill_mtp: Dict[str, Any],
                    slot: int) -> None:
    """``insert_slot`` for the MTP module's cache (``init_mtp_cache``)."""
    insert_slot(decode_mtp, prefill_mtp, slot, key="layer")


def _layer_cache(cfg: ModelConfig, spec, kdt: torch.dtype, batch: int, max_len: int,
                 device) -> Dict[str, torch.Tensor]:
    def zeros(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=device)

    if spec.attn_kind == "mla":
        Dp = lane_pad(cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        return {"kv": zeros((batch, 1, max_len, Dp), kdt)}
    if spec.attn_kind == "gqa":
        shape = (batch, cfg.num_key_value_heads, max_len, lane_pad(cfg.qk_head_dim))
        return {"k": zeros(shape, kdt), "v": zeros(shape, kdt)}
    hk, hv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
    conv_dim = 2 * hk * dk + hv * dv
    return {"state": zeros((batch, hv, dk, dv), torch.float32),
            "conv": zeros((batch, cfg.linear_conv_kernel_dim - 1, conv_dim))}


def init_cache(cfg: ModelConfig, quant: QuantConfig, batch: int, max_len: int,
               device) -> Dict[str, Any]:
    """Zeroed cache: {"layers": [one dict per layer], "length": [B] int32}."""
    kdt = kv_dtype(resolve_kv_quant(cfg, quant, batch, max_len))
    return {"layers": [_layer_cache(cfg, spec, kdt, batch, max_len, device)
                       for spec in layer_specs(cfg)],
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


def init_mtp_cache(cfg: ModelConfig, quant: QuantConfig, batch: int, max_len: int,
                   device) -> Dict[str, Any]:
    """Zeroed cache of the MTP module (``models/mtp.py``): its one layer and
    its own valid length, {"layer": ..., "length": [B] int32}. The length
    trails the main cache's by one until the first sampled token arrives."""
    kdt = kv_dtype(resolve_kv_quant(cfg, quant, batch, max_len))
    return {"layer": _layer_cache(cfg, mtp_layer_spec(cfg), kdt, batch, max_len, device),
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}
