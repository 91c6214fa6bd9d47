"""Dense masked attention in float32: the plain semantics of attention
(``krasis_tpu/ops/attention.py`` ``build_mask`` / ``attend``), kept as the
reference that the kernel's plain version and the tests read against."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def build_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, kv_len: torch.Tensor,
               window: int = 0) -> torch.Tensor:
    """Boolean [B, Sq, Skv]: True = attend (causal, below kv_len and, with
    a window, kp > q − window)."""
    if kv_pos.dim() == 1:
        kv_pos = kv_pos[None, :]
    qp = q_pos[:, :, None]
    kp = kv_pos[:, None, :]
    mask = (kp <= qp) & (kp < kv_len[:, None, None])
    if window > 0:
        mask &= kp > qp - window
    return mask


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
           scale: float, sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,Sq,Hq,Dk], k [B,Skv,Hkv,Dk], v [B,Skv,Hkv,Dv] → [B,Sq,Hq,Dv].
    sinks [Hq]: a per-head logit that joins each softmax denominator and
    contributes no value (GPT-OSS)."""
    B, Sq, Hq, Dk = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qf = q.to(torch.float32).reshape(B, Sq, Hkv, G, Dk)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(torch.float32)) * scale
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    if sinks is not None:
        sink = sinks.to(torch.float32).reshape(1, Hkv, G, 1, 1)
        m = torch.maximum(scores.amax(dim=-1, keepdim=True), sink)
        e = torch.exp(scores - m)
        p = e / (e.sum(dim=-1, keepdim=True) + torch.exp(sink - m))
    else:
        p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, Hq, -1).to(q.dtype)
