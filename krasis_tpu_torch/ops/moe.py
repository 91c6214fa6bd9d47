"""MoE expert forward and the dense MLP.

``moe_forward`` decides a call's numeric form with the reference's own
predicates (``krasis_tpu/ops/moe.py`` ``moe_forward``, copied in
``route``): by batch size (``use_grouped_path``) the grouped regime (bf16
rows) or the gathered one; then biases, the reference's gathered-kernel
predicate (``expert_class.gathered``), the expert class
(``ops/expert_class.py``) and ``activation``. A form the reference runs on
its Pallas kernels runs on the port's kernels: grouped on K4 / K7
(``gmm_cuda.moe_prefill``), fused int8 on K3, two-stage int8 on K6a,
fused bf16 on K5, two-stage bf16 on K6 twice. Their wrappers run the plain
versions for tensors on the CPU and raise on the card for stacks their
kernels do not take; every stack of these forms that the reference's
predicates admit at groups of a multiple of 16 rows is taken.

Biased experts and stacks the reference's kernels decline take the
reference's plain forms: ``moe_forward_ragged`` in the grouped regime, and
in the gathered one ``moe_forward_gathered``. The port runs each on its
regime's kernel with the biases added between the two launches, a
departure in dispatch with the same rounding points (bf16 rows, h rounded
to bf16, + the bf16 w13 bias, the activation, + the f32 w2 bias): the
gathered form on K6 wherever K6 takes both stacks (form "gathered"), the
ragged one on K7 (``gmm_cuda.moe_prefill`` with the biases; form
"ragged") wherever K7 takes both stacks and the rows are bf16. Only the
summation order differs from the reference's. Elsewhere they run as they
are (forms "gathered_plain" and "ragged_plain"), and ``plain_routes``
counts the calls of these two plain forms.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..quant import QTensor, dequantize
from . import expert_class, gmm_cuda, moe_cuda
from .activations import swiglu
from .qmm import Weight, linear


def use_grouped_path(T: int, k: int, E: int) -> bool:
    """Grouped (prefill) vs gathered (decode): grouped once the picks would
    hit most experts anyway (T·k ≥ 0.75·E) or T ≥ 64."""
    return 4 * T * k >= 3 * E or T >= 64


def _deq_stack(w, dtype) -> torch.Tensor:
    """An expert stack [E, K, N] (QTensor or plain tensor) in `dtype`; above
    8 experts one at a time, so the f32 transient stays one expert's size."""
    if not isinstance(w, QTensor):
        return w.to(dtype)
    if w.q.dim() >= 3 and w.q.shape[0] > 8:
        return torch.stack([dequantize(w[e], dtype) for e in range(w.q.shape[0])])
    return dequantize(w, dtype)


def _f32_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b on values already rounded to their dtype, accumulated in f32."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def moe_forward_ragged(x: torch.Tensor, w13, w2, topk_idx: torch.Tensor,
                       topk_weights: torch.Tensor, swiglu_limit: float = 0.0,
                       gpt_oss: bool = False, w13_bias: Optional[torch.Tensor] = None,
                       w2_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain grouped path: picks sorted by expert, one product per expert
    that was hit over its rows, on the dequantized stacks. w13_bias [E, 2I]
    and w2_bias [E, H] are added per pick."""
    T, H = x.shape
    k = topk_idx.shape[-1]
    flat = topk_idx.reshape(-1).to(torch.int64)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    x_sorted = x[order // k]
    w13_d, w2_d = _deq_stack(w13, x.dtype), _deq_stack(w2, x.dtype)
    E = w13_d.shape[0]
    bounds = [0] + torch.cumsum(torch.bincount(flat, minlength=E), 0).tolist()

    def ragged(rows, stack):
        out = torch.zeros((rows.shape[0], stack.shape[-1]), dtype=torch.float32,
                          device=rows.device)
        for e in range(E):
            lo, hi = bounds[e], bounds[e + 1]
            if hi > lo:
                out[lo:hi] = _f32_dot(rows[lo:hi], stack[e])
        return out

    h = ragged(x_sorted, w13_d).to(x.dtype)
    if w13_bias is not None:
        h = h + w13_bias[sorted_e].to(h.dtype)
    a = swiglu(h, swiglu_limit, gpt_oss)
    out_sorted = ragged(a, w2_d)
    if w2_bias is not None:
        out_sorted = out_sorted + w2_bias[sorted_e].to(out_sorted.dtype)
    out_rep = torch.empty_like(out_sorted)
    out_rep[order] = out_sorted
    out = (out_rep.reshape(T, k, H) * topk_weights[..., None].to(torch.float32)).sum(dim=1)
    return out.to(x.dtype)


def moe_forward_gathered(x: torch.Tensor, w13, w2, topk_idx: torch.Tensor,
                         topk_weights: torch.Tensor, swiglu_limit: float = 0.0,
                         gpt_oss: bool = False, w13_bias: Optional[torch.Tensor] = None,
                         w2_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain gathered path: only the picked experts are dequantized, one
    small product per (token, pick)."""
    idx = topk_idx.to(torch.int64)
    w13_g = _deq_stack(w13[idx], x.dtype)                     # [T, k, H, 2I]
    w2_g = _deq_stack(w2[idx], x.dtype)                       # [T, k, I, H]
    h = torch.einsum("th,tkhi->tki", x.to(torch.float32), w13_g.to(torch.float32))
    h = h.to(x.dtype)
    if w13_bias is not None:
        h = h + w13_bias[idx].to(h.dtype)
    a = swiglu(h, swiglu_limit, gpt_oss)
    out = torch.einsum("tki,tkih->tkh", a.to(torch.float32), w2_g.to(torch.float32))
    if w2_bias is not None:
        out = out + w2_bias[idx].to(out.dtype)
    out = (out * topk_weights[..., None].to(out.dtype)).sum(dim=1)
    return out.to(x.dtype)


# moe_forward calls of each plain form since the caller last set them to 0
plain_routes = {"ragged_plain": 0, "gathered_plain": 0}


def route(x: torch.Tensor, w13, w2, topk_idx: torch.Tensor, biased: bool,
          activation: str = "bf16") -> str:
    """The form of a call, from predicates alone, before anything is
    launched: "grouped" (K4 / K7), "fused_int8" (K3), "tiled_int8" (K6a),
    "fused_bf16" (K5), "tiled_bf16" (K6 twice), "ragged" (K7 twice with the
    biases), "gathered" (K6 twice with the biases), or one of the plain
    forms "ragged_plain" (``moe_forward_ragged``) and "gathered_plain"
    (``moe_forward_gathered``)."""
    T, k = x.shape[0], topk_idx.shape[-1]
    quant = isinstance(w13, QTensor) and isinstance(w2, QTensor)
    E = w13.q.shape[0] if isinstance(w13, QTensor) else w13.shape[0]
    ref = not biased and quant and expert_class.gathered(w13) and expert_class.gathered(w2)
    if use_grouped_path(T, k, E):
        if ref:
            return "grouped"
        if (quant and x.dtype == torch.bfloat16 and w13.q.dim() == 3 and w2.q.dim() == 3
                and gmm_cuda.gmm_supported(w13) and gmm_cuda.gmm_supported(w2)):
            return "ragged"
        return "ragged_plain"
    if not biased and quant:
        if activation == "int8":
            if expert_class.decode_fused_int8(w13, w2):
                return "fused_int8"
            if expert_class.gathered_int8(w13) and expert_class.gathered_int8(w2):
                return "tiled_int8"
        if expert_class.decode_fused(w13, w2):
            return "fused_bf16"
        if ref:
            return "tiled_bf16"
    if (quant and x.dtype == torch.bfloat16 and moe_cuda.gathered_qmm_supported(w13)
            and moe_cuda.gathered_qmm_supported(w2)):
        return "gathered"
    return "gathered_plain"


def moe_forward(x: torch.Tensor, w13, w2, topk_idx: torch.Tensor,
                topk_weights: torch.Tensor, swiglu_limit: float = 0.0,
                gpt_oss: bool = False, w13_bias: Optional[torch.Tensor] = None,
                w2_bias: Optional[torch.Tensor] = None,
                pick_valid: Optional[torch.Tensor] = None,
                activation: str = "bf16") -> torch.Tensor:
    """x [T, H] through the experts topk_idx [T, k] of the stacks
    w13 [E, H(/2), 2I] and w2 [E, I(/2), H], weighted by topk_weights.
    `pick_valid` [T, k] marks the picks to compute; a pick that is not
    valid carries weight 0, so every form is right without it, and the
    two-stage forms also skip its work."""
    if activation not in ("bf16", "int8"):
        raise ValueError(f"unknown expert activation {activation!r}")
    form = route(x, w13, w2, topk_idx, w13_bias is not None or w2_bias is not None, activation)
    act = (swiglu_limit, gpt_oss)
    bias = dict(w13_bias=w13_bias, w2_bias=w2_bias)
    if form in plain_routes:
        plain_routes[form] += 1
        fn = moe_forward_ragged if form == "ragged_plain" else moe_forward_gathered
        return fn(x, w13, w2, topk_idx, topk_weights, *act, **bias)
    if form in ("grouped", "ragged"):
        # the grouped regime runs bf16 activations whatever `activation`
        # says; its int8 form stays an A/B entry of moe_prefill. "ragged"
        # passes the biases, which select K7 whatever the expert class says
        return gmm_cuda.moe_prefill(x, w13, w2, topk_idx, topk_weights, *act, pick_valid,
                                    **bias)
    if form == "fused_int8":
        return moe_cuda.moe_w4a8(x, w13, w2, topk_idx, topk_weights, *act)
    if form == "fused_bf16":
        return moe_cuda.moe_bf16(x, w13, w2, topk_idx, topk_weights, *act)
    # "tiled_int8", "tiled_bf16", and "gathered" on K6 with the biases
    return moe_cuda.moe_gathered_tiled(x, w13, w2, topk_idx, topk_weights, *act, pick_valid,
                                       "int8" if form == "tiled_int8" else "bf16", **bias)


def mlp_forward(x: torch.Tensor, w13: Weight, w2: Weight, swiglu_limit: float = 0.0,
                gpt_oss: bool = False) -> torch.Tensor:
    """Dense MLP / shared expert: swiglu(x @ w13) @ w2."""
    return linear(swiglu(linear(x, w13), swiglu_limit, gpt_oss), w2)
