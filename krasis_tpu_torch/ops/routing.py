"""MoE router for the main path: softmax scoring and greedy top-k.

The router matmul runs in true f32 (the card's TF32 is switched off by
``device.set_exact_matmul_flags``): routing is precision-critical, and a
different pick changes the whole expert output.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ModelConfig


class RoutingResult(NamedTuple):
    topk_idx: torch.Tensor      # [T, k] int32
    topk_weights: torch.Tensor  # [T, k] float32


def compute_routing(x: torch.Tensor, gate_w: torch.Tensor,
                    cfg: ModelConfig) -> RoutingResult:
    if (cfg.scoring_func != "softmax" or cfg.moe_router_softmax_after_topk
            or cfg.n_group > 1 or cfg.has_router_bias):
        raise NotImplementedError(
            "only softmax greedy top-k routing is ported so far")
    logits = torch.matmul(x.to(torch.float32), gate_w.to(torch.float32))
    scores = torch.softmax(logits, dim=-1)
    weights, topk_idx = torch.topk(scores, cfg.num_experts_per_tok, dim=-1)
    if cfg.norm_topk_prob:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    weights = weights * cfg.routed_scaling_factor
    return RoutingResult(topk_idx.to(torch.int32), weights.to(torch.float32))
