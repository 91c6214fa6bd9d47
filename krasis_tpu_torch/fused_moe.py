"""Standalone fused-MoE module for embedding krasis_tpu_torch in other stacks.

The port of ``krasis_tpu/fused_moe.py``: an external framework hands over
hidden states and routing results (or raw router weights) and gets the
routed-expert output back, with expert-ID masking for experts the host
framework computes elsewhere (id -1). The experts run through
``ops/moe.moe_forward``, so on the card each call takes the port's kernel
for its form (K5 for a few bf16 rows of an int4 / int8 stack, K4 for a
prefill's grouped rows, ...). A masked pick is a pick that is not valid
(``pick_valid``) with weight 0, on expert 0: the reference's clamp-and-zero.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .config import ModelConfig
from .ops.moe import moe_forward
from .ops.routing import compute_routing
from .quant import QTensor, quantize


class KrasisTpuMoE(nn.Module):
    """One MoE layer's routed experts, callable from any PyTorch program."""

    def __init__(
        self,
        w13,                     # [E, H, 2I] tensor or QTensor
        w2,                      # [E, I, H]
        num_experts_per_tok: int,
        expert_bits: int = 0,    # quantize on ingest when > 0
        group_size: int = 128,
        swiglu_limit: float = 0.0,
        gpt_oss: bool = False,
    ):
        super().__init__()
        if expert_bits and not isinstance(w13, QTensor):
            w13 = quantize(torch.as_tensor(w13), expert_bits, group_size)
            w2 = quantize(torch.as_tensor(w2), expert_bits, group_size)
        self.w13, self.w2 = w13, w2
        self.top_k = num_experts_per_tok
        self.swiglu_limit = swiglu_limit
        self.gpt_oss = gpt_oss

    def forward(
        self,
        hidden: torch.Tensor,          # [T, H]
        topk_idx: torch.Tensor,        # [T, k] int; -1 = handled elsewhere
        topk_weights: torch.Tensor,    # [T, k] f32
    ) -> torch.Tensor:
        masked = topk_idx < 0
        idx = torch.where(masked, 0, topk_idx).to(torch.int32)
        wts = torch.where(masked, 0.0, topk_weights.to(torch.float32))
        return moe_forward(hidden, self.w13, self.w2, idx, wts,
                           swiglu_limit=self.swiglu_limit, gpt_oss=self.gpt_oss,
                           pick_valid=~masked)

    def forward_routed(self, hidden: torch.Tensor, gate_w: torch.Tensor, cfg: ModelConfig,
                       correction_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Routing (``compute_routing``, from the host's gate weights) and the
        experts in one call."""
        r = compute_routing(hidden, gate_w, cfg, correction_bias)
        return self(hidden, r.topk_idx, r.topk_weights)
