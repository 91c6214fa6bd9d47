"""K1: dequant-fused quantized matmul for few rows (``csrc/qmm.cu``).

Replaces ``krasis_tpu/ops/qmm_pallas.py`` ``qmm_pallas`` (``qmm``) and
``qmm_stacked_pallas`` (``qmm_stacked``, K1s: one layer of a
``[L, K(/2), N]`` stack, picked inside the kernel, so no per-layer copy of
the weights is made). Each launches the CUDA kernel for tensors on the card
— one launch a call: split K is reduced on the chip — and runs
``qmm_plain`` — the same function in plain PyTorch — for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from .. import build
from ..quant import QTensor, dequantize

SOURCE = "krasis_tpu_torch/csrc/qmm.cu"
REPLACES = "krasis_tpu/ops/qmm_pallas.py:203"
REPLACES_STACKED = "krasis_tpu/ops/qmm_pallas.py:172"
launches = 0          # qmm launches since the caller last set it to 0
launches_stacked = 0  # qmm_stacked launches, likewise

COLS = 128            # output columns of a CTA
MAX_SPLITS = 8        # the portable thread-block cluster size
SMS = 132             # the H100's streaming multiprocessors
MAX_T = 16


def qmm_plain(x: torch.Tensor, qt: QTensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """x[T, K] @ dequant(qt): weights dequantized in f32 and rounded to
    bf16, products accumulated in f32."""
    w = dequantize(qt, torch.bfloat16)
    return torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                        w.to(torch.float32)).to(out_dtype)


class Plan(NamedTuple):
    """How one call is cut: `tt` is T rounded up to an instance (1, 2, 4,
    8, 16); the packed rows split into `ks` ranges (one thread-block
    cluster per column tile and pick) on boundaries of `unit` rows, a group
    or, for int4 with K/2 not a multiple of the group, half a group; `pk`
    packed rows a pipeline stage; `grid` = (column tiles, picks, ks), the
    last column tile partial where N % 128 != 0; picks is 1 but for K6."""
    tt: int
    unit: int
    ks: int
    pk: int
    grid: Tuple[int, int, int]

    def split_rows(self, rows: int):
        """The packed-row range [r0, r1) of each split, as the kernel cuts it."""
        units = rows // self.unit
        return [(units * z // self.ks * self.unit, units * (z + 1) // self.ks * self.unit)
                for z in range(self.ks)]


def plan(T: int, K: int, N: int, bits: int, gs: int, sms: int = SMS, picks: int = 1) -> Plan:
    """Enough CTAs to keep two or three on each SM pulling bytes: the
    column tiles (of every pick: K6 has `picks` of one row each), times
    the fewest K splits (a power of two up to 8, at most one per unit) that
    reach 2.5 x `sms` CTAs. Where even that leaves fewer than two CTAs an
    SM, each stage takes 128 packed rows instead of 64, so a CTA keeps
    more bytes in flight."""
    if not 1 <= T <= MAX_T:
        raise ValueError(f"qmm: T = {T} rows, the kernel takes 1..{MAX_T}")
    rows = K // 2 if bits == 4 else K
    unit = gs if rows % gs == 0 else gs // 2
    if unit <= 0 or rows % unit:
        unit = rows
    units = rows // unit
    tiles = -(-N // COLS)
    ctas = tiles * picks
    ks = 1
    while ks < MAX_SPLITS and 2 * ctas * ks < 5 * sms and 2 * ks <= units:
        ks *= 2
    pk = 128 if ctas * ks < 2 * sms else 64
    tt = next(n for n in (1, 2, 4, 8, 16) if n >= T)
    return Plan(tt, unit, ks, pk, (tiles, picks, ks))


STAGES = 4            # csrc/qmm.cu: the ring's stages, a staged weight row's byte pitch,
LDB = COLS + 16       # an x row's bf16 pad
XPAD = 8


def smem(pk: int, tt: int, bits: int, gs: int) -> int:
    """Dynamic shared memory of a launch of K1's kernel (csrc/qmm.cu
    ``launch``): the ring, or the cluster's partial if that is larger."""
    halves = 2 if bits == 4 else 1
    scale_rows = (pk + gs - 1) // gs + 1
    stage = pk * LDB + halves * tt * (pk + XPAD) * 2 + halves * scale_rows * COLS * 2
    return max(STAGES * stage, tt * COLS * 4)


def _lib():
    fn = build.load("qmm").qmm_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_long] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


# Checked call signatures: weight pointers, shapes, strides, dtypes, T,
# output type → the launch's fixed arguments.
_checked: dict = {}


def _signature(q: torch.Tensor, s: torch.Tensor, bits: int, gs: int, T: int, K: int,
               out_dtype) -> tuple:
    """Check a weight once per call signature and plan its launch. q, s are
    [L, K(/2), N] / [L, K/gs, N] stacks (L = 1 for a single weight)."""
    key = (q.data_ptr(), s.data_ptr(), tuple(q.shape), q.stride(), tuple(s.shape), s.stride(),
           q.dtype, s.dtype, bits, gs, T, K, out_dtype)
    hit = _checked.get(key)
    if hit is not None:
        return hit
    N = q.shape[-1]
    rows = K // 2 if bits == 4 else K
    if q.shape[-2] != rows or s.shape[-1] != N or s.shape[-2] * gs != K:
        raise ValueError(f"qmm: x has K = {K}, weight {tuple(q.shape)}, scales "
                         f"{tuple(s.shape)}, group {gs}")
    if bits not in (4, 8) or N % 4 or K % gs or (bits == 4 and K % 2):
        raise ValueError(f"qmm: unsupported weight bits={bits} K={K} N={N} gs={gs}")
    if q.dtype != torch.int8 or s.dtype != torch.bfloat16:
        raise ValueError(f"qmm: weight {q.dtype} / scales {s.dtype}, want int8 / bf16")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"qmm: output type {out_dtype}, want bf16 or f32")
    if not (q.is_cuda and s.is_cuda):
        raise ValueError("qmm: the weight must be on the CUDA device")
    for w in (q, s):
        if w.stride(-1) != 1 or w.stride(-2) != N or w.data_ptr() % 4:
            raise ValueError("qmm: each layer of the weight must be contiguous")
    p = plan(T, K, N, bits, gs)
    x_vec_ok = K % 16 == 0 and p.unit % 8 == 0
    hit = (p, N, x_vec_ok, q.stride(0), s.stride(0), int(out_dtype == torch.float32))
    if len(_checked) > 4096:
        _checked.clear()
    _checked[key] = hit
    return hit


def _launch(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, bits: int, gs: int,
            layer: int, out_dtype) -> torch.Tensor:
    """x [T, K] against layer `layer` of the stacks q, s, read in place."""
    T, K = x.shape
    if not 0 <= layer < q.shape[0]:
        raise ValueError(f"qmm: layer {layer} of a stack of {q.shape[0]}")
    if not x.is_cuda or x.device != q.device:
        raise ValueError("qmm: x and the weight must be on the same CUDA device")
    p, N, x_vec_ok, q_lstride, s_lstride, out_f32 = _signature(q, s, bits, gs, T, K, out_dtype)
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        x = x.to(torch.bfloat16).contiguous()
    out = torch.empty((T, N), dtype=out_dtype, device=x.device)
    err = _lib()(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                 T, K, N, bits, gs, p.unit, p.ks, p.pk, q_lstride, s_lstride, layer, out_f32,
                 int(x_vec_ok and x.data_ptr() % 16 == 0),
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "qmm")
    return out


def qmm(x: torch.Tensor, qt: QTensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """out[T, N] = x[T, K] @ dequant(qt[K, N]) in `out_dtype`."""
    if x.device.type == "cpu":
        return qmm_plain(x, qt, out_dtype)
    global launches
    if qt.q.dim() != 2:
        raise ValueError(f"qmm: weight {tuple(qt.q.shape)} is not [K, N]")
    q, s = qt.q, qt.scales
    if not (q.is_contiguous() and s.is_contiguous()):
        q, s = q.contiguous(), s.contiguous()
    out = _launch(x, q[None], s[None], qt.bits, qt.group_size, 0, out_dtype)
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
    out = _launch(x, qt.q, qt.scales, qt.bits, qt.group_size, int(layer_idx), out_dtype)
    launches_stacked += 1
    return out
