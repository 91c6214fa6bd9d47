"""Dense masked attention in float32: the plain semantics of attention
(``krasis_tpu/ops/attention.py`` ``build_mask`` / ``attend``), kept as the
reference that the kernel's plain version and the tests read against."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def build_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
               kv_len: torch.Tensor) -> torch.Tensor:
    """Boolean [B, Sq, Skv]: True = attend (causal and below kv_len)."""
    if kv_pos.dim() == 1:
        kv_pos = kv_pos[None, :]
    qp = q_pos[:, :, None]
    kp = kv_pos[:, None, :]
    return (kp <= qp) & (kp < kv_len[:, None, None])


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q [B,Sq,Hq,Dk], k [B,Skv,Hkv,Dk], v [B,Skv,Hkv,Dv] → [B,Sq,Hq,Dv]."""
    B, Sq, Hq, Dk = q.shape
    Hkv = k.shape[2]
    qf = q.to(torch.float32).reshape(B, Sq, Hkv, Hq // Hkv, Dk)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(torch.float32)) * scale
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, Hq, -1).to(q.dtype)
