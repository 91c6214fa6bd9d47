"""MoE expert forward and the dense MLP.

``moe_forward`` picks the regime by batch size with the reference's
predicate (``krasis_tpu/ops/moe.py`` ``use_grouped_path``): many rows go
through the grouped K4 kernel with bf16 activations, few rows through the
gathered W4A8 K3 kernel.
"""

from __future__ import annotations

import torch

from ..quant import QTensor
from . import gmm_cuda, moe_cuda
from .activations import swiglu
from .qmm import Weight, linear


def use_grouped_path(T: int, k: int, E: int) -> bool:
    """Grouped (prefill) vs gathered (decode): grouped once the picks would
    hit most experts anyway (T·k ≥ 0.75·E) or T ≥ 64."""
    return 4 * T * k >= 3 * E or T >= 64


def moe_forward(x: torch.Tensor, w13: QTensor, w2: QTensor,
                topk_idx: torch.Tensor, topk_weights: torch.Tensor,
                activation: str = "bf16") -> torch.Tensor:
    """x [T, H] through the experts topk_idx [T, k] of the stacks
    w13 [E, H(/2), 2I] and w2 [E, I(/2), H], weighted by topk_weights."""
    T = x.shape[0]
    k = topk_idx.shape[-1]
    E = w13.q.shape[0]
    if use_grouped_path(T, k, E):
        # the grouped regime runs bf16 activations whatever `activation` says
        return gmm_cuda.moe_prefill(x, w13, w2, topk_idx, topk_weights)
    if activation == "int8":
        return moe_cuda.moe_w4a8(x, w13, w2, topk_idx, topk_weights)
    raise NotImplementedError(
        "the bf16-activation gathered MoE (moe_gathered_pallas) is not ported yet")


def mlp_forward(x: torch.Tensor, w13: Weight, w2: Weight) -> torch.Tensor:
    """Dense MLP / shared expert: swiglu(x @ w13) @ w2."""
    return linear(swiglu(linear(x, w13)), w2)
