"""K1: dequant-fused quantized matmul for few rows (``csrc/qmm.cu``).

Replaces ``krasis_tpu/ops/qmm_pallas.py`` ``qmm_pallas`` (``qmm``) and
``qmm_stacked_pallas`` (``qmm_stacked``, K1s: one layer of a
``[L, K(/2), N]`` stack, picked inside the kernel, so no per-layer copy of
the weights is made). Each launches the CUDA kernel for tensors on the card
and runs ``qmm_plain`` — the same function in plain PyTorch — for tensors
on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from ..quant import QTensor, dequantize

SOURCE = "krasis_tpu_torch/csrc/qmm.cu"
REPLACES = "krasis_tpu/ops/qmm_pallas.py:203"
REPLACES_STACKED = "krasis_tpu/ops/qmm_pallas.py:172"
launches = 0          # qmm launches since the caller last set it to 0
launches_stacked = 0  # qmm_stacked launches, likewise

_COLS = 128
_SMS = 132


def qmm_plain(x: torch.Tensor, qt: QTensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """x[T, K] @ dequant(qt): weights dequantized in f32 and rounded to
    bf16, products accumulated in f32."""
    w = dequantize(qt, torch.bfloat16)
    return torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                        w.to(torch.float32)).to(out_dtype)


def _lib():
    """The one entry point: a [K, N] weight goes in as a stack of one layer."""
    fn = build.load("qmm").qmm_stacked_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_long] * 2 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def split_k(K: int, N: int, gs: int) -> int:
    """K splits so that about two blocks per SM pull weight bytes."""
    blocks = -(-N // _COLS)
    ks = max(1, min(16, (2 * _SMS) // blocks))
    return max(1, min(ks, K // max(gs, 64)))


def _launch(x: torch.Tensor, qt: QTensor, layer: int, out_dtype) -> torch.Tensor:
    """x [T, K] against layer `layer` of the stack qt [L, K(/2), N], read
    in place through the stack's base pointers and layer strides."""
    T, K = x.shape
    N = qt.n_dim
    L = qt.q.shape[0]
    if qt.k_dim != K or not 0 <= layer < L:
        raise ValueError(f"qmm: x {tuple(x.shape)} vs weight {tuple(qt.q.shape)}, "
                         f"layer {layer}")
    if qt.bits not in (4, 8) or N % 4 or K % qt.group_size:
        raise ValueError(f"qmm: unsupported weight bits={qt.bits} K={K} N={N}")
    if not (x.is_cuda and qt.q.is_cuda and qt.scales.is_cuda):
        raise ValueError("qmm: x and the weight must be on the same CUDA device")
    for w in (qt.q, qt.scales):
        if w.stride(-1) != 1 or w.stride(-2) != N or w.data_ptr() % 4:
            raise ValueError("qmm: each layer of the weight must be contiguous")
    x = x.to(torch.bfloat16).contiguous()
    ks = split_k(K, N, qt.group_size)
    part = torch.empty((ks, T, N), dtype=torch.float32, device=x.device)
    err = _lib()(x.data_ptr(), qt.q.data_ptr(), qt.scales.data_ptr(), part.data_ptr(),
                 T, K, N, qt.bits, qt.group_size, ks,
                 qt.q.stride(0), qt.scales.stride(0), layer,
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "qmm")
    out = part[0] if ks == 1 else part.sum(dim=0)
    return out.to(out_dtype)


def qmm(x: torch.Tensor, qt: QTensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """out[T, N] = x[T, K] @ dequant(qt[K, N]) in `out_dtype`."""
    if x.device.type == "cpu":
        return qmm_plain(x, qt, out_dtype)
    global launches
    if qt.q.dim() != 2:
        raise ValueError(f"qmm: weight {tuple(qt.q.shape)} is not [K, N]")
    out = _launch(x, QTensor(qt.q.contiguous()[None], qt.scales.contiguous()[None],
                             qt.bits, qt.group_size), 0, out_dtype)
    launches += 1
    return out


def qmm_stacked(x: torch.Tensor, qt: QTensor, layer_idx: int,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """out[T, N] = x[T, K] @ dequant(qt[layer_idx]) for a stack
    qt [L, K(/2), N]; the kernel offsets into the stack itself."""
    if x.device.type == "cpu":
        return qmm_plain(x, qt[layer_idx], out_dtype)
    global launches_stacked
    if qt.q.dim() != 3:
        raise ValueError(f"qmm_stacked: weight {tuple(qt.q.shape)} is not [L, K, N]")
    out = _launch(x, qt, int(layer_idx), out_dtype)
    launches_stacked += 1
    return out
