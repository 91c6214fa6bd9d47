"""MLP activations: SwiGLU and the GPT-OSS clamped variant (f32 math,
output in the input dtype).

GPT-OSS: ``gate·sigmoid(1.702·gate)·(up + 1)`` with gate clamped to
(-inf, limit] and up to [-limit, limit] (``swiglu_limit``, typically 7.0).
"""

from __future__ import annotations

import torch


def swiglu(h: torch.Tensor, swiglu_limit: float = 0.0, gpt_oss: bool = False) -> torch.Tensor:
    """h = [..., 2I] with gate in the first half, up in the second."""
    gate, up = torch.chunk(h, 2, dim=-1)
    g = gate.to(torch.float32)
    u = up.to(torch.float32)
    if gpt_oss:
        g = torch.clamp(g, max=swiglu_limit)
        u = torch.clamp(u, -swiglu_limit, swiglu_limit)
        out = g * torch.sigmoid(1.702 * g) * (u + 1.0)
    else:
        out = g * torch.sigmoid(g) * u
    return out.to(h.dtype)
