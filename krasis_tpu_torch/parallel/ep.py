"""Expert-parallel MoE: each ep shard runs the ordinary MoE kernels on its
contiguous slice of the expert stacks (PyTorch).

The port of ``krasis_tpu/parallel/ep.py``. Every shard holds E / ep
experts, turns the router's global top-k ids into ids of its slice, runs
``ops/moe.moe_forward`` on its own device with ``pick_valid`` marking its
picks, and the f32 partial outputs are summed on the rows' home device
(the reference's ``psum`` in f32). No capacity factor, no token dropped:
every pick is computed by exactly one shard; a remote pick carries weight 0
and is skipped by the forms that take ``pick_valid`` (K4 / K7's tile plan,
K6 and K6a's picks). One thread launches every shard's kernels in turn, so
an ep-n layer costs n MoE calls of launches.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from ..quant import QTensor
from .mesh import Mesh, expert_shards, experts_shardable


def ep_supported(mesh: Optional[Mesh], w13, w2) -> bool:
    """Whether a mesh splits these stacks over its ep axis: ep > 1, both
    stacks quantized [E, ...], E divisible by ep."""
    if mesh is None or "ep" not in mesh.axis_names:
        return False
    return experts_shardable({"w13": w13, "w2": w2}, mesh.ep,
                             w13.q.shape[0] if isinstance(w13, QTensor) else 0)


def local_picks(topk_idx: torch.Tensor, topk_weights: torch.Tensor, rank: int, E_local: int):
    """Global picks [T, k] → (ids, weights, valid) of shard `rank`'s slice:
    its picks sorted first in their order, an invalid pick with weight 0 and
    the row's last valid local id (a row with no local pick: id 0), so the
    kernels' reads stay on an expert already read."""
    local = topk_idx.to(torch.int64) - rank * E_local
    valid = (local >= 0) & (local < E_local)
    order = torch.argsort((~valid).to(torch.int32), dim=1, stable=True)
    local_s = torch.gather(local, 1, order)
    valid_s = torch.gather(valid, 1, order)
    wts_s = torch.where(valid_s, torch.gather(topk_weights, 1, order),
                        torch.zeros((), dtype=topk_weights.dtype, device=topk_weights.device))
    nv = valid_s.sum(dim=1, keepdim=True)
    fill = torch.gather(local_s, 1, (nv - 1).clamp(min=0))
    fill = torch.where(nv > 0, fill, torch.zeros_like(fill))
    ids = torch.where(valid_s, local_s, fill).to(torch.int32)
    return ids, wts_s, valid_s


def moe_forward_ep_local(x: torch.Tensor, w13_l, w2_l, topk_idx: torch.Tensor,
                         topk_weights: torch.Tensor, rank: int, *,
                         swiglu_limit: float = 0.0, gpt_oss: bool = False,
                         w13_bias=None, w2_bias=None, activation: str = "bf16") -> torch.Tensor:
    """Shard `rank`'s partial output, f32 [T, H], on x's device: the picks
    of its slice w13_l / w2_l [E / ep, ...] through ``moe_forward``."""
    from ..ops.moe import moe_forward

    ids, wts, valid = local_picks(topk_idx, topk_weights, rank, w13_l.q.shape[0])
    out = moe_forward(x, w13_l, w2_l, ids, wts, swiglu_limit=swiglu_limit, gpt_oss=gpt_oss,
                      w13_bias=w13_bias, w2_bias=w2_bias, pick_valid=valid,
                      activation=activation)
    return out.to(torch.float32)


def ep_combine(x: torch.Tensor, shards: Sequence[Dict[str, Any]], topk_idx: torch.Tensor,
               topk_weights: torch.Tensor, **kw) -> torch.Tensor:
    """Every shard of `shards` (dicts of ``w13``, ``w2``, their biases and
    ``_device``) on its device, the f32 partials summed on x's device, in
    x's dtype."""
    total = None
    for rank, sh in enumerate(shards):
        dev = sh["_device"]
        part = moe_forward_ep_local(
            x.to(dev), sh["w13"], sh["w2"], topk_idx.to(dev), topk_weights.to(dev), rank,
            w13_bias=sh.get("w13_bias"), w2_bias=sh.get("w2_bias"), **kw).to(x.device)
        total = part if total is None else total + part
    return total.to(x.dtype)


def moe_forward_ep(x: torch.Tensor, w13, w2, topk_idx: torch.Tensor,
                   topk_weights: torch.Tensor, *, mesh: Mesh, swiglu_limit: float = 0.0,
                   gpt_oss: bool = False, w13_bias=None, w2_bias=None,
                   activation: str = "bf16") -> torch.Tensor:
    """``moe_forward`` over `mesh`: the stacks [E, ...] split over ep, each
    shard on its device, and the rows split over dp when T divides (each
    group on its own devices); the output on x's device."""
    T = x.shape[0]
    lp = {"w13": w13, "w2": w2, "w13_bias": w13_bias, "w2_bias": w2_bias}
    kw = dict(swiglu_limit=swiglu_limit, gpt_oss=gpt_oss, activation=activation)
    dp = mesh.dp if T % mesh.dp == 0 else 1
    b = T // dp
    outs = []
    for d in range(dp):
        home, rows = mesh.home(d), slice(d * b, (d + 1) * b)
        out = ep_combine(x[rows].to(home), expert_shards(lp, mesh.devices[d]),
                         topk_idx[rows].to(home), topk_weights[rows].to(home), **kw)
        outs.append(out.to(x.device))
    return torch.cat(outs)
