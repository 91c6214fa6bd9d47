"""RMSNorm, the fused residual add + RMSNorm, and the gated RMSNorm of
Gated DeltaNet, with the reduction in float32; all return the input dtype.
``rms_norm`` normalises the last axis, so it also serves the per-head q/k
norm."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    wf = w.to(torch.float32)
    if plus_one:
        wf = wf + 1.0
    return (normed * wf).to(x.dtype)


def add_rms_norm(x: torch.Tensor, residual: Optional[torch.Tensor], w: torch.Tensor,
                 eps: float = 1e-6, plus_one: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rms_norm(x + residual), x + residual)``; with no residual (the
    first layer) the new residual is ``x`` itself."""
    if residual is not None:
        x = x + residual
    return rms_norm(x, w, eps, plus_one), x


def gated_rms_norm(x: torch.Tensor, gate: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6, plus_one: bool = True) -> torch.Tensor:
    """``rmsnorm(x) * silu(gate)`` over the last (per-head) axis."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    wf = w.to(torch.float32)
    if plus_one:
        wf = wf + 1.0
    g = gate.to(torch.float32)
    return (normed * wf * (g * torch.sigmoid(g))).to(x.dtype)
