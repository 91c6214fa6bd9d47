"""K4: grouped expert GEMM over expert-sorted row tiles (``csrc/gmm.cu``),
and the prefill MoE built on it.

Replaces ``krasis_tpu/ops/gmm_pallas.py`` ``gmm13_fused`` (SwiGLU epilogue)
and ``gmm2_fused`` (f32 epilogue), with the glue of ``moe_prefill_pallas``.
The tile plan differs from ``_plan_tiles``: tiles are 64 rows, there is no
spare trash tile, and the w13 launch gathers token rows itself; every
row's result is the same. ``gmm`` launches the CUDA kernel for tensors on
the card and runs ``gmm_plain`` for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import build
from ..quant import QTensor, dequantize

SOURCE = "krasis_tpu_torch/csrc/gmm.cu"
REPLACES = "krasis_tpu/ops/gmm_pallas.py:365"
REPLACES_W2 = "krasis_tpu/ops/gmm_pallas.py:411"
launches = 0          # kernel launches since the caller last set it to 0

TM = 64


class TilePlan(NamedTuple):
    row_src: torch.Tensor     # [Mp] int32 token row of each tile row, -1 = padding
    dest: torch.Tensor        # [T*k] tile row of each (token, pick)
    tile_e: torch.Tensor      # [n_tiles] int32 expert of each tile
    tile_valid: torch.Tensor  # [n_tiles] int32 1 = compute
    n_tiles: int


def plan_tiles(topk_idx: torch.Tensor, E: int, tm: int = TM) -> TilePlan:
    """Sort the T*k picks by expert and give each expert whole tm-row tiles.
    n_tiles is a static bound (no host sync): Σ ceil(c_e / tm) ≤ M/tm + E."""
    T, k = topk_idx.shape
    M = T * k
    dev = topk_idx.device
    flat = topk_idx.reshape(-1).to(torch.int64)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    counts = torch.bincount(flat, minlength=E)
    padded = (counts + tm - 1) // tm * tm
    cum_padded = torch.cumsum(padded, 0)
    pad_off = cum_padded - padded
    raw_off = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(M, device=dev) - raw_off[sorted_e]
    sorted_dest = pad_off[sorted_e] + ranks
    n_tiles = M // tm + E + 1
    Mp = n_tiles * tm
    row_src = torch.full((Mp,), -1, dtype=torch.int32, device=dev)
    row_src[sorted_dest] = (order // k).to(torch.int32)
    dest = torch.empty_like(sorted_dest)
    dest[order] = sorted_dest
    starts = torch.arange(n_tiles, device=dev) * tm
    tile_e = torch.searchsorted(cum_padded, starts, right=True).clamp(max=E - 1)
    tile_valid = starts < cum_padded[-1]
    return TilePlan(row_src, dest, tile_e.to(torch.int32),
                    tile_valid.to(torch.int32), n_tiles)


def gmm_plain(x: torch.Tensor, row_src: Optional[torch.Tensor], w: QTensor,
              plan: TilePlan, swiglu: bool) -> torch.Tensor:
    """The kernel's function: per valid tile, rows @ bf16-dequantized expert
    weights with f32 accumulation; swiglu rounds h to bf16 and returns bf16
    [Mp, N/2], else f32 [Mp, N]. Skipped tiles are left at zero."""
    Mp = plan.n_tiles * TM
    N = w.n_dim
    if row_src is not None:
        src = row_src.to(torch.int64)
        rows = torch.where((src >= 0)[:, None], x[src.clamp(min=0)],
                           torch.zeros((), dtype=x.dtype, device=x.device))
    else:
        rows = x
    h = torch.zeros((Mp, N), dtype=torch.float32, device=x.device)
    valid = plan.tile_valid.to(torch.bool).tolist()
    experts = plan.tile_e.tolist()
    for t in range(plan.n_tiles):
        if not valid[t]:
            continue
        wt = dequantize(w[experts[t]], torch.bfloat16).to(torch.float32)
        sl = slice(t * TM, (t + 1) * TM)
        h[sl] = torch.matmul(rows[sl].to(torch.float32), wt)
    if not swiglu:
        return h
    hb = h.to(torch.bfloat16).to(torch.float32)
    g, u = hb[:, : N // 2], hb[:, N // 2:]
    return (g * torch.sigmoid(g) * u).to(torch.bfloat16)


def _lib():
    fn = build.load("gmm").gmm_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_long] * 2 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def gmm(x: torch.Tensor, row_src: Optional[torch.Tensor], w: QTensor,
        plan: TilePlan, swiglu: bool) -> torch.Tensor:
    """x [rows, K] bf16; row_src gathers tile rows from x (None: x is
    already tile-aligned [Mp, K]); w [E, K(/2), N]."""
    if x.device.type == "cpu":
        return gmm_plain(x, row_src, w, plan, swiglu)
    global launches
    K, N = w.k_dim, w.n_dim
    Mp = plan.n_tiles * TM
    if x.shape[-1] != K or K % 32 or w.bits not in (4, 8):
        raise ValueError(f"gmm: x {tuple(x.shape)} vs weight {tuple(w.q.shape)}")
    if (swiglu and (N // 2) % 64) or (not swiglu and N % 128):
        raise ValueError(f"gmm: unsupported output width {N}")
    if row_src is None and x.shape[0] != Mp:
        raise ValueError("gmm: x must hold the tile rows when row_src is None")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("gmm: x must be contiguous, aligned bf16")
    for t in (w.q, w.scales):
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError("gmm: expert stacks must be contiguous on the card")
    if swiglu:
        out = torch.empty((Mp, N // 2), dtype=torch.bfloat16, device=x.device)
    else:
        out = torch.empty((Mp, N), dtype=torch.float32, device=x.device)
    err = _lib()(x.data_ptr(), 0 if row_src is None else row_src.data_ptr(),
                 w.q.data_ptr(), w.scales.data_ptr(), plan.tile_e.data_ptr(),
                 plan.tile_valid.data_ptr(), out.data_ptr(), plan.n_tiles, K, N,
                 w.bits, w.group_size, w.q.stride(0), w.scales.stride(0), int(swiglu),
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "gmm")
    launches += 1
    return out


def moe_prefill(x: torch.Tensor, w13: QTensor, w2: QTensor,
                topk_idx: torch.Tensor, topk_weights: torch.Tensor) -> torch.Tensor:
    """Grouped MoE: w13 GEMM + SwiGLU, w2 GEMM, then the f32 weighted
    combine of each token's k picks, cast to x.dtype."""
    T, H = x.shape
    k = topk_idx.shape[1]
    plan = plan_tiles(topk_idx, w13.q.shape[0])
    a = gmm(x.contiguous(), plan.row_src, w13, plan, swiglu=True)
    o = gmm(a, None, w2, plan, swiglu=False)
    o_rep = o[plan.dest].reshape(T, k, H)
    return (o_rep * topk_weights[..., None].to(torch.float32)).sum(dim=1).to(x.dtype)
