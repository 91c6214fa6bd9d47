"""Quantized and plain linear layers.

``linear`` takes a bf16 weight (projections the quant policy keeps at
full precision) or a ``QTensor``. Few-row products of a quantized weight
go through the K1 kernel (``qmm_cuda``); many-row products dequantize and
use one matrix product, as the reference leaves them to XLA
(``krasis_tpu/ops/qmm.py`` ``qmm_ref``). Both compute the same function.
"""

from __future__ import annotations

from typing import Union

import torch

from ..quant import QTensor, dequantize
from . import qmm_cuda

Weight = Union[torch.Tensor, QTensor]

# Rows up to which the bandwidth-bound K1 kernel beats dequantize + GEMM.
QMM_MAX_T = 16


def matmul_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 x @ bf16 w with f32 accumulation, rounded once to bf16. On the
    card this is cuBLAS (reduced-precision reductions switched off); the
    CPU's bf16 GEMM is not specified to accumulate in f32, so there the
    product is taken in f32."""
    if x.is_cuda:
        return torch.matmul(x, w)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(torch.bfloat16)


def qmm_ref(x: torch.Tensor, qt: QTensor, out_dtype=None) -> torch.Tensor:
    """Dequantize W to bf16, then one f32-accumulated product."""
    w = dequantize(qt, torch.bfloat16)
    if out_dtype in (None, torch.bfloat16):
        return matmul_bf16(x, w)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(out_dtype)


def qmm(x: torch.Tensor, qt: QTensor, out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or x.dtype
    if x.shape[0] <= QMM_MAX_T:
        return qmm_cuda.qmm(x, qt, out_dtype)
    return qmm_ref(x, qt, out_dtype)


def linear(x: torch.Tensor, w: Weight, out_dtype=None) -> torch.Tensor:
    """x[..., K] @ w[K, N]."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(w, QTensor):
        y = qmm(x2, w, out_dtype)
    elif out_dtype in (None, torch.bfloat16):
        y = matmul_bf16(x2, w.to(torch.bfloat16))
    else:
        y = torch.matmul(x2.to(torch.float32), w.to(torch.float32)).to(out_dtype)
    return y.reshape(*lead, y.shape[-1])
