"""RMSNorm and the gated RMSNorm of Gated DeltaNet, with the reduction in
float32; both return the input dtype. ``rms_norm`` normalises the last
axis, so it also serves the per-head q/k norm."""

from __future__ import annotations

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
