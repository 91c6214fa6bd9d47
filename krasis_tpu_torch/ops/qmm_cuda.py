"""K1: dequant-fused quantized matmul for few rows (``csrc/qmm.cu``).

Replaces ``krasis_tpu/ops/qmm_pallas.py`` ``qmm_pallas``. ``qmm`` launches
the CUDA kernel for tensors on the card and runs ``qmm_plain`` — the same
function in plain PyTorch — for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from ..quant import QTensor, dequantize

SOURCE = "krasis_tpu_torch/csrc/qmm.cu"
REPLACES = "krasis_tpu/ops/qmm_pallas.py:203"
launches = 0          # kernel launches since the caller last set it to 0

_COLS = 128
_SMS = 132


def qmm_plain(x: torch.Tensor, qt: QTensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """x[T, K] @ dequant(qt): weights dequantized in f32 and rounded to
    bf16, products accumulated in f32."""
    w = dequantize(qt, torch.bfloat16)
    return torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                        w.to(torch.float32)).to(out_dtype)


def _lib():
    lib = build.load("qmm")
    fn = lib.qmm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def split_k(K: int, N: int, gs: int) -> int:
    """K splits so that about two blocks per SM pull weight bytes."""
    blocks = -(-N // _COLS)
    ks = max(1, min(16, (2 * _SMS) // blocks))
    return max(1, min(ks, K // max(gs, 64)))


def qmm(x: torch.Tensor, qt: QTensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """out[T, N] = x[T, K] @ dequant(qt[K, N]) in `out_dtype`."""
    if x.device.type == "cpu":
        return qmm_plain(x, qt, out_dtype)
    global launches
    T, K = x.shape
    N = qt.n_dim
    if qt.q.dim() != 2 or qt.k_dim != K:
        raise ValueError(f"qmm: x {tuple(x.shape)} vs weight {tuple(qt.q.shape)}")
    if qt.bits not in (4, 8) or N % 4 or K % qt.group_size:
        raise ValueError(f"qmm: unsupported weight bits={qt.bits} K={K} N={N}")
    if not (x.is_cuda and qt.q.is_cuda and qt.scales.is_cuda):
        raise ValueError("qmm: x and the weight must be on the same CUDA device")
    x = x.to(torch.bfloat16).contiguous()
    q = qt.q.contiguous()
    s = qt.scales.contiguous()
    ks = split_k(K, N, qt.group_size)
    part = torch.empty((ks, T, N), dtype=torch.float32, device=x.device)
    err = _lib()(x.data_ptr(), q.data_ptr(), s.data_ptr(), part.data_ptr(),
                 T, K, N, qt.bits, qt.group_size, ks,
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "qmm")
    launches += 1
    out = part[0] if ks == 1 else part.sum(dim=0)
    return out.to(out_dtype)
