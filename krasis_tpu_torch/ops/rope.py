"""Rotary position embeddings: half rotation, DeepSeek's interleaved rope
dims, and YaRN NTK-by-parts scaling with its mscale corrections.

``compute_inv_freq`` is a copy of ``krasis_tpu.ops.rope.compute_inv_freq``
(numpy, float64 then float32), so both packages rotate by the same
frequencies.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch


def yarn_get_mscale(scale: float, mscale: float) -> float:
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def compute_inv_freq(rot_dim: int, rope_theta: float,
                     rope_scaling: Dict[str, Any] | None) -> Tuple[np.ndarray, float]:
    """(inv_freq[rot_dim/2] float32, mscale for cos/sin)."""
    half = rot_dim // 2
    inv_freq = 1.0 / (rope_theta ** (np.arange(0, half, dtype=np.float64) * 2 / rot_dim))
    mscale = 1.0
    rs = rope_scaling or {}
    rtype = rs.get("type", rs.get("rope_type", ""))
    if rtype == "yarn":
        factor = float(rs.get("factor", 1.0))
        orig_max = float(rs.get("original_max_position_embeddings", 4096))
        beta_fast = float(rs.get("beta_fast", 32))
        beta_slow = float(rs.get("beta_slow", 1))

        def find_correction_dim(num_rot: float) -> float:
            return (rot_dim * math.log(orig_max / (num_rot * 2 * math.pi))
                    / (2 * math.log(rope_theta)))

        low = math.floor(find_correction_dim(beta_fast))
        high = math.ceil(find_correction_dim(beta_slow))
        low, high = max(low, 0), min(high, half - 1)
        if low == high:
            high += 0.001
        ramp = np.clip((np.arange(half, dtype=np.float64) - low) / (high - low), 0.0, 1.0)
        inv_freq = inv_freq * (1 - ramp) + (inv_freq / factor) * ramp
        m = float(rs.get("mscale", 1.0))
        m_all = float(rs.get("mscale_all_dim", 0.0))
        if m_all:
            mscale = yarn_get_mscale(factor, m) / yarn_get_mscale(factor, m_all)
        else:
            mscale = yarn_get_mscale(factor, m)
    elif rtype == "linear":
        inv_freq = inv_freq / float(rs.get("factor", 1.0))
    return inv_freq.astype(np.float32), float(mscale)


def rope_cos_sin(positions: torch.Tensor, rot_dim: int, rope_theta: float,
                 rope_scaling: Dict[str, Any] | None = None):
    """cos/sin tables for integer positions [...]: each [..., rot_dim/2] f32."""
    inv_freq, mscale = compute_inv_freq(rot_dim, rope_theta, rope_scaling)
    inv = torch.from_numpy(inv_freq).to(positions.device)
    freqs = positions.to(torch.float32).unsqueeze(-1) * inv
    return torch.cos(freqs) * mscale, torch.sin(freqs) * mscale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               interleaved: bool = False) -> torch.Tensor:
    """Half-rotation RoPE on the last ``2 * cos.shape[-1]`` dims of
    x [..., H, D]; cos/sin [..., rot/2] get the head axis inserted.
    interleaved=True de-interleaves (x0, y0, x1, y1, ...) pairs first."""
    rot = 2 * cos.shape[-1]
    d = x.shape[-1]
    xf = x[..., :rot].to(torch.float32)
    if interleaved:
        pairs = xf.reshape(*xf.shape[:-1], rot // 2, 2)
        xf = torch.cat([pairs[..., 0], pairs[..., 1]], dim=-1)
    x1, x2 = xf[..., : rot // 2], xf[..., rot // 2:]
    c = cos.unsqueeze(-2) if cos.dim() < x.dim() else cos
    s = sin.unsqueeze(-2) if sin.dim() < x.dim() else sin
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
    if d > rot:
        out = torch.cat([out, x[..., rot:]], dim=-1)
    return out


def yarn_softmax_scale(base_scale: float, rope_scaling: Dict[str, Any] | None) -> float:
    """Softmax scale with YaRN's mscale_all_dim correction squared."""
    rs = rope_scaling or {}
    if rs.get("type", rs.get("rope_type", "")) == "yarn":
        m_all = float(rs.get("mscale_all_dim", 0.0))
        if m_all:
            m = yarn_get_mscale(float(rs.get("factor", 1.0)), m_all)
            return base_scale * m * m
    return base_scale
