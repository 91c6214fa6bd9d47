"""MLP activation: SwiGLU (f32 math, output in the input dtype)."""

from __future__ import annotations

import torch


def swiglu(h: torch.Tensor) -> torch.Tensor:
    """h = [..., 2I] with gate in the first half, up in the second."""
    gate, up = torch.chunk(h, 2, dim=-1)
    g = gate.to(torch.float32)
    u = up.to(torch.float32)
    return (g * torch.sigmoid(g) * u).to(h.dtype)
