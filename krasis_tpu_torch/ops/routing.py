"""MoE router: scoring, top-k selection and weight normalization.

The port of ``krasis_tpu/ops/routing.py`` ``compute_routing``, every
variant:

* softmax scoring (DeepSeek V2, Qwen3): top-k over the softmax;
* sigmoid scoring with ``correction_bias`` (DeepSeek V3 / Kimi): selection
  on ``sigmoid(logits) + bias``, weights from the unbiased sigmoid;
* group-limited top-k (``n_group > 1``): only the ``topk_group`` groups
  with the largest sums of their top-2 scores stay eligible, the others
  are zero-filled (not -inf), as HF does;
* GPT-OSS (``moe_router_softmax_after_topk``): ``logit_bias`` added, top-k
  over the raw logits, then a softmax over the k selected logits;
* ``norm_topk_prob`` and ``routed_scaling_factor``.

The router matmul runs in true f32 (the card's TF32 is switched off by
``device.set_exact_matmul_flags``): routing is precision-critical, and a
different pick changes the whole expert output.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import ModelConfig


class RoutingResult(NamedTuple):
    topk_idx: torch.Tensor      # [T, k] int32
    topk_weights: torch.Tensor  # [T, k] float32


def compute_routing(x: torch.Tensor, gate_w: torch.Tensor, cfg: ModelConfig,
                    correction_bias: Optional[torch.Tensor] = None,
                    logit_bias: Optional[torch.Tensor] = None) -> RoutingResult:
    logits = torch.matmul(x.to(torch.float32), gate_w.to(torch.float32))      # [T, E]
    if logit_bias is not None:
        logits = logits + logit_bias.to(torch.float32)
    k, E = cfg.num_experts_per_tok, cfg.n_routed_experts

    if cfg.scoring_func == "sigmoid":
        scores = torch.sigmoid(logits)
    elif cfg.moe_router_softmax_after_topk:
        scores = logits
    else:
        scores = torch.softmax(logits, dim=-1)

    select = scores
    if correction_bias is not None:
        select = scores + correction_bias.to(torch.float32)
    if cfg.n_group > 1 and cfg.topk_group > 0:
        T = select.shape[0]
        grouped = select.reshape(T, cfg.n_group, E // cfg.n_group)
        top2 = torch.topk(grouped, 2, dim=-1).values.sum(dim=-1)             # [T, n_group]
        top_groups = torch.topk(top2, cfg.topk_group, dim=-1).indices
        group_mask = torch.zeros_like(top2, dtype=torch.bool).scatter_(1, top_groups, True)
        expert_mask = group_mask.repeat_interleave(E // cfg.n_group, dim=-1)
        select = torch.where(expert_mask, select, torch.zeros_like(select))

    topk_idx = torch.topk(select, k, dim=-1).indices
    if cfg.moe_router_softmax_after_topk:
        weights = torch.softmax(torch.gather(logits, -1, topk_idx), dim=-1)
    else:
        weights = torch.gather(scores, -1, topk_idx)
        if cfg.norm_topk_prob:
            weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    weights = weights * cfg.routed_scaling_factor
    return RoutingResult(topk_idx.to(torch.int32), weights.to(torch.float32))
