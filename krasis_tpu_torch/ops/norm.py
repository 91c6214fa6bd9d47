"""RMSNorm with the reduction in float32; returns the input dtype."""

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
