"""K4, K7 and K7a: grouped expert GEMMs over expert-sorted row tiles
(``csrc/gmm.cu``), and the prefill MoE built on them.

``gmm`` (K4) replaces ``krasis_tpu/ops/gmm_pallas.py`` ``gmm13_fused``
(SwiGLU epilogue) and ``gmm2_fused`` (f32 epilogue). ``gmm_two_stage`` (K7)
replaces ``gmm``, the grouped GEMM that the reference runs twice with
SwiGLU between for experts too large for its fused kernels: it is K4's f32
entry at both call shapes, under its own launch count. ``gmm_a8`` (K7a)
replaces ``gmm_a8``: the same tiles with int8 rows and per-group scales,
on the int8 tensor cores, at 64- and 128-row tiles.
``moe_prefill`` has the glue and the three branches of
``moe_prefill_pallas``, and its ``tile_rows`` knob; with expert biases it
runs the reference's plain ragged form (``moe_forward_ragged``) on K7's two
launches, the biases added between them at that form's rounding points. K7
takes widths that are not whole CTAs (N % 64 == 0: GPT-OSS's w2 has 2880
columns), K4 whole CTAs only. The tile plan differs
from ``_plan_tiles``: tiles are 64 or 128 rows unless the caller asks for
256 or 512 (``choose_tm``, from shapes alone), there is no spare trash
tile, and the w13 launches gather token rows themselves; every row's
result is the same, and K4 / K7 give the same rows bit for bit at every
height. ``gmm_probe`` launches the probe forms of the same kernel
(``probes/probe_gmm_terms.py``, ``probes/probe_unpack_variants.py``). Each
wrapper launches its CUDA kernel for tensors on the card and runs its
plain version for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import build
from ..quant import QTensor, dequantize, unpack
from . import expert_class
from .activations import swiglu as swiglu_fn
from .moe_cuda import quantize_activations

SOURCE = "krasis_tpu_torch/csrc/gmm.cu"
REPLACES = "krasis_tpu/ops/gmm_pallas.py:365"
REPLACES_W2 = "krasis_tpu/ops/gmm_pallas.py:411"
REPLACES_TWO_STAGE = "krasis_tpu/ops/gmm_pallas.py:119"
REPLACES_A8 = "krasis_tpu/ops/gmm_pallas.py:205"
REPLACES_TERMS = "benchmarks/probe_gmm_terms.py:109"
REPLACES_V2 = "benchmarks/probe_unpack_variants.py:134"
launches = 0              # K4 kernel launches since the caller last set it to 0
launches_two_stage = 0    # K7, likewise
launches_a8 = 0           # K7a
# the probe forms (gmm_probe), by mode; its "full" term is a K7 launch
launches_copy = 0
launches_nounpack = 0
launches_unpackonly = 0
launches_v2 = 0

TM = 64                   # tile rows of the default plan
TM_LARGE = 128
TILE_HEIGHTS = (64, 128, 256, 512)    # K4 / K7
TILE_HEIGHTS_A8 = (64, 128)           # K7a: the heights choose_tm picks
PROBE_MODES = {"copy": 1, "nounpack": 2, "unpackonly": 3, "v2": 4}   # csrc/gmm.cu Mode


class TilePlan(NamedTuple):
    row_src: torch.Tensor     # [Mp] int32 token row of each tile row, -1 = padding
    dest: torch.Tensor        # [T*k] tile row of each (token, pick); Mp = in no tile
    tile_e: torch.Tensor      # [n_tiles] int32 expert of each tile
    tile_valid: torch.Tensor  # [n_tiles] int32 1 = compute
    n_tiles: int
    tm: int                   # rows of a tile; Mp = n_tiles * tm


def cta_cols(tm: int) -> int:
    """Output columns of one CTA of gmm_kernel: 128, or 64 at 512 rows.
    The f32 epilogue (K7) takes a partial last CTA: N is a multiple of 64,
    not of this (up to 256 rows the last CTA owns 64 live columns); that
    CTA reads no weight or scale byte and writes no output past N. The
    SwiGLU epilogue (K4) takes whole CTAs only."""
    return 64 if tm == 512 else 128


def pick_tile(N: int) -> int:
    """Largest multiple-of-128 divisor of N up to 512, else N: the TPU
    probes' lane tile (``moe_pallas.pick_tile(N, 512)``), which the copy
    probe form reads x through."""
    for t in range(512, 127, -128):
        if N % t == 0:
            return t
    return N


def choose_tm(M: int, E: int) -> int:
    """Tile rows for M picks over E experts, from shapes alone: 128 when an
    expert gets 128 rows on average (its weights then stream once per 128
    rows instead of per 64), else 64, so few-row experts waste little."""
    return TM_LARGE if M >= TM_LARGE * E else TM


def plan_tiles(topk_idx: torch.Tensor, E: int, tm: int = TM,
               pick_valid: Optional[torch.Tensor] = None) -> TilePlan:
    """Sort the T*k picks by expert and give each expert whole tm-row tiles.
    n_tiles is a static bound (no host sync): Σ ceil(c_e / tm) ≤ M/tm + E.
    A pick with pick_valid == 0 belongs to no tile: it is left out of the
    counts and its dest is Mp, one past the tile rows."""
    T, k = topk_idx.shape
    M = T * k
    dev = topk_idx.device
    flat = topk_idx.reshape(-1).to(torch.int64)
    if pick_valid is not None:
        flat = torch.where(pick_valid.reshape(-1) != 0, flat, E)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    counts = torch.bincount(flat, minlength=E + 1)[:E]
    padded = (counts + tm - 1) // tm * tm
    cum_padded = torch.cumsum(padded, 0)
    pad_off = cum_padded - padded
    raw_off = torch.cumsum(counts, 0) - counts
    n_tiles = M // tm + E + 1
    Mp = n_tiles * tm
    live = sorted_e < E
    se = sorted_e.clamp(max=E - 1)
    ranks = torch.arange(M, device=dev) - raw_off[se]
    sorted_dest = torch.where(live, pad_off[se] + ranks, Mp)
    row_src = torch.full((Mp + 1,), -1, dtype=torch.int32, device=dev)
    row_src[sorted_dest] = torch.where(live, order // k, -1).to(torch.int32)
    dest = torch.empty_like(sorted_dest)
    dest[order] = sorted_dest
    starts = torch.arange(n_tiles, device=dev) * tm
    tile_e = torch.searchsorted(cum_padded, starts, right=True).clamp(max=E - 1)
    tile_valid = starts < cum_padded[-1]
    return TilePlan(row_src[:Mp], dest, tile_e.to(torch.int32),
                    tile_valid.to(torch.int32), n_tiles, tm)


def _tile_rows(x: torch.Tensor, row_src: Optional[torch.Tensor]) -> torch.Tensor:
    """The tile rows of x: gathered through row_src, padding rows zero."""
    if row_src is None:
        return x
    src = row_src.to(torch.int64)
    return torch.where((src >= 0)[:, None], x[src.clamp(min=0)],
                       torch.zeros((), dtype=x.dtype, device=x.device))


def gmm_plain(x: torch.Tensor, row_src: Optional[torch.Tensor], w: QTensor,
              plan: TilePlan, swiglu: bool, swiglu_limit: float = 0.0,
              gpt_oss: bool = False) -> torch.Tensor:
    """The kernel's function: per valid tile, rows @ bf16-dequantized expert
    weights with f32 accumulation; swiglu rounds h to bf16, applies the
    activation (SwiGLU, or GPT-OSS's clamped form) in f32 and returns bf16
    [Mp, N/2], else f32 [Mp, N]. Skipped tiles are left at zero."""
    tm = plan.tm
    Mp = plan.n_tiles * tm
    N = w.n_dim
    rows = _tile_rows(x, row_src)
    h = torch.zeros((Mp, N), dtype=torch.float32, device=x.device)
    valid = plan.tile_valid.to(torch.bool).tolist()
    experts = plan.tile_e.tolist()
    for t in range(plan.n_tiles):
        if not valid[t]:
            continue
        wt = dequantize(w[experts[t]], torch.bfloat16).to(torch.float32)
        sl = slice(t * tm, (t + 1) * tm)
        h[sl] = torch.matmul(rows[sl].to(torch.float32), wt)
    if not swiglu:
        return h
    hb = h.to(torch.bfloat16).to(torch.float32)
    return swiglu_fn(hb, swiglu_limit, gpt_oss).to(torch.bfloat16)


def gmm_a8_plain(xq: torch.Tensor, sx: torch.Tensor, row_src: Optional[torch.Tensor],
                 w: QTensor, plan: TilePlan) -> torch.Tensor:
    """K7a's function: per valid tile and K-group, the exact integer dot of
    the int8 rows with the unscaled integer weights, then
    acc += d * sx[:, g] * sw[g] in f32, groups in order. f32 [Mp, N];
    skipped tiles are left at zero."""
    tm = plan.tm
    Mp = plan.n_tiles * tm
    N, gs = w.n_dim, w.group_size
    G = w.k_dim // gs
    rows = _tile_rows(xq, row_src).to(torch.float32).reshape(Mp, G, gs)
    scales = _tile_rows(sx.to(torch.float32), row_src)
    out = torch.zeros((Mp, N), dtype=torch.float32, device=xq.device)
    valid = plan.tile_valid.to(torch.bool).tolist()
    experts = plan.tile_e.tolist()
    for t in range(plan.n_tiles):
        if not valid[t]:
            continue
        we = w[experts[t]]
        wi = unpack(we).to(torch.float32).reshape(G, gs, N)
        sw = we.scales.to(torch.float32)
        sl = slice(t * tm, (t + 1) * tm)
        d = torch.einsum("mgk,gkn->mgn", rows[sl], wi)       # exact: |d| < 2^24
        acc = torch.zeros((tm, N), dtype=torch.float32, device=xq.device)
        for g in range(G):
            acc = acc + d[:, g] * scales[sl, g:g + 1] * sw[g]
        out[sl] = acc
    return out


def _fns():
    """The launchers of K4 / K7, K7a and the probe forms."""
    lib = build.load("gmm")
    fn, fa, fp = lib.gmm_launch, lib.gmm_a8_launch, lib.gmm_probe_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_long] * 2
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fa.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_long] * 2 + [ctypes.c_void_p])
        fp.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_long] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
        fn.restype = fa.restype = fp.restype = ctypes.c_int
    return fn, fa, fp


def _check_rows(name: str, x: torch.Tensor, row_src: Optional[torch.Tensor], w: QTensor,
                plan: TilePlan, dtype: torch.dtype) -> None:
    K = w.k_dim
    if x.shape[-1] != K or K % 32 or w.bits not in (4, 8):
        raise ValueError(f"{name}: x {tuple(x.shape)} vs weight {tuple(w.q.shape)}")
    if row_src is None and x.shape[0] != plan.n_tiles * plan.tm:
        raise ValueError(f"{name}: x must hold the tile rows when row_src is None")
    if x.dtype != dtype or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous, aligned {dtype}")
    for t in (w.q, w.scales):
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError(f"{name}: expert stacks must be contiguous on the card")


def gmm_supported(w: QTensor) -> bool:
    """Stacks gmm_kernel's f32 epilogue (K7) takes: a step is 32 packed
    rows (for int4 both halves: K/2 a multiple of 32) whose 16-row halves
    each lie in one scale group (groups of a multiple of 16 rows; below 32
    the kernel's FULL16 form stages a scale row per half), N a multiple of
    64 columns (a last CTA of 64 where N is no whole number of CTAs; the
    SwiGLU epilogue also needs whole CTAs, which ``_launch`` checks)."""
    packed = w.k_dim // 2 if w.bits == 4 else w.k_dim
    return (w.bits in (4, 8) and packed % 32 == 0 and w.group_size % 16 == 0
            and w.k_dim % w.group_size == 0 and w.n_dim % 64 == 0)


def _launch(x: torch.Tensor, row_src: Optional[torch.Tensor], w: QTensor,
            plan: TilePlan, swiglu: bool, swiglu_limit: float = 0.0,
            gpt_oss: bool = False) -> torch.Tensor:
    """One launch of gmm_kernel with either epilogue."""
    K, N = w.k_dim, w.n_dim
    Mp = plan.n_tiles * plan.tm
    _check_rows("gmm", x, row_src, w, plan, torch.bfloat16)
    if not gmm_supported(w) or plan.tm not in TILE_HEIGHTS:
        raise ValueError(f"gmm: unsupported stack {tuple(w.q.shape)}, bits {w.bits}, "
                         f"group {w.group_size}, tile rows {plan.tm}")
    if swiglu and (N // 2) % (cta_cols(plan.tm) // 2):
        raise ValueError(f"gmm: unsupported output width {N} at {plan.tm}-row tiles")
    if swiglu:
        out = torch.empty((Mp, N // 2), dtype=torch.bfloat16, device=x.device)
    else:
        out = torch.empty((Mp, N), dtype=torch.float32, device=x.device)
    err = _fns()[0](x.data_ptr(), 0 if row_src is None else row_src.data_ptr(),
                    w.q.data_ptr(), w.scales.data_ptr(), plan.tile_e.data_ptr(),
                    plan.tile_valid.data_ptr(), out.data_ptr(), plan.n_tiles, plan.tm, K, N,
                    w.bits, w.group_size, w.q.stride(0), w.scales.stride(0), int(swiglu),
                    float(swiglu_limit), int(gpt_oss),
                    torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "gmm")
    return out


def gmm(x: torch.Tensor, row_src: Optional[torch.Tensor], w: QTensor,
        plan: TilePlan, swiglu: bool, swiglu_limit: float = 0.0,
        gpt_oss: bool = False) -> torch.Tensor:
    """K4. x [rows, K] bf16; row_src gathers tile rows from x (None: x is
    already tile-aligned [Mp, K]); w [E, K(/2), N]. The SwiGLU epilogue
    takes GPT-OSS's clamped form with gpt_oss."""
    if x.device.type == "cpu":
        return gmm_plain(x, row_src, w, plan, swiglu, swiglu_limit, gpt_oss)
    global launches
    out = _launch(x, row_src, w, plan, swiglu, swiglu_limit, gpt_oss)
    launches += 1
    return out


def gmm_two_stage(x: torch.Tensor, row_src: Optional[torch.Tensor], w: QTensor,
                  plan: TilePlan) -> torch.Tensor:
    """K7: one stage of the two-stage form, f32 [Mp, N] at either call
    shape (w13 with row_src, w2 on tile-aligned rows)."""
    if x.device.type == "cpu":
        return gmm_plain(x, row_src, w, plan, False)
    global launches_two_stage
    out = _launch(x, row_src, w, plan, False)
    launches_two_stage += 1
    return out


def gmm_probe_plain(x: torch.Tensor, w: QTensor, plan: TilePlan, mode: str,
                    row_src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The probe forms' functions over the tile rows of x (row_src gathers
    them, as for gmm; None: x is tile-aligned [Mp, K]) → f32 [Mp, N],
    skipped tiles zero: "full" and "v2" are K7's (gmm_plain); "copy"
    out[r, n] = rows[r, n mod pick_tile(N)]; "nounpack" rows @ S with S[k, n] =
    s[k // gs, n] of the tile's expert; "unpackonly" out[t·tm + r, n] =
    dequant(W[e_t])[r, n] for r < tm."""
    if mode in ("full", "v2"):
        return gmm_plain(x, row_src, w, plan, False)
    if mode not in PROBE_MODES:
        raise ValueError(f"gmm_probe: mode {mode!r}")
    x_tiles = _tile_rows(x, row_src)
    tm, N = plan.tm, w.n_dim
    cols = torch.arange(N, device=x_tiles.device) % pick_tile(N)
    out = torch.zeros((plan.n_tiles * tm, N), dtype=torch.float32, device=x_tiles.device)
    valid = plan.tile_valid.to(torch.bool).tolist()
    experts = plan.tile_e.tolist()
    for t in range(plan.n_tiles):
        if not valid[t]:
            continue
        sl, we = slice(t * tm, (t + 1) * tm), w[experts[t]]
        if mode == "copy":
            out[sl] = x_tiles[sl][:, cols].to(torch.float32)
        elif mode == "nounpack":
            S = we.scales.repeat_interleave(w.group_size, dim=0).to(torch.float32)
            out[sl] = torch.matmul(x_tiles[sl].to(torch.float32), S)
        else:
            out[sl] = dequantize(we, torch.bfloat16)[:tm].to(torch.float32)
    return out


def gmm_probe(x: torch.Tensor, w: QTensor, plan: TilePlan, mode: str,
              row_src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of a probe form of gmm_kernel over the tile rows of x
    (bf16; tile-aligned [Mp, K] as in the TPU probes, or gathered through
    row_src as K4 / K7 take them) → f32 [Mp, N] (rows of skipped tiles
    undefined): "copy", "nounpack" and "unpackonly" at 128-row tiles, the
    terms of ``benchmarks/probe_gmm_terms.py``, whose "full" term is K7
    (``gmm_two_stage``) itself; "v2" (the shift unpack,
    ``benchmarks/probe_unpack_variants.py``) at 128, 256 or 512 rows."""
    if mode == "full":
        return gmm_two_stage(x, row_src, w, plan)
    if x.device.type == "cpu":
        return gmm_probe_plain(x, w, plan, mode, row_src)
    K, N, tm = w.k_dim, w.n_dim, plan.tm
    tn = pick_tile(N)
    if (mode not in PROBE_MODES or tm not in (TILE_HEIGHTS[1:] if mode == "v2" else (TM_LARGE,))
            or (mode == "copy" and tn > K) or not gmm_supported(w) or w.group_size % 32
            or N % cta_cols(tm)):
        raise ValueError(f"gmm_probe: mode {mode!r} at {tm}-row tiles, stack "
                         f"{tuple(w.q.shape)}, bits {w.bits}, group {w.group_size}")
    _check_rows("gmm_probe", x, row_src, w, plan, torch.bfloat16)
    out = torch.empty((plan.n_tiles * tm, N), dtype=torch.float32, device=x.device)
    err = _fns()[2](x.data_ptr(), 0 if row_src is None else row_src.data_ptr(),
                    w.q.data_ptr(), w.scales.data_ptr(), plan.tile_e.data_ptr(),
                    plan.tile_valid.data_ptr(), out.data_ptr(), plan.n_tiles, tm, K, N, w.bits,
                    w.group_size, w.q.stride(0), w.scales.stride(0), PROBE_MODES[mode], tn,
                    None, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"gmm_probe({mode})")
    globals()[f"launches_{mode}"] += 1
    return out


def gmm_a8_supported(w: QTensor) -> bool:
    """Stacks K7a takes, the same as K7's (``gmm_supported``): a step is 32
    packed rows, groups a multiple of 16 rows (groups of a multiple of 32
    run the k32 int8 product, others the k16 one, so no product spans two
    groups), K a whole number of groups, N a multiple of 64 (at 64-row
    tiles a last CTA of 64 live columns). Its tiles are 64 or 128 rows
    (``TILE_HEIGHTS_A8``)."""
    return gmm_supported(w)


def gmm_a8(xq: torch.Tensor, sx: torch.Tensor, row_src: Optional[torch.Tensor],
           w: QTensor, plan: TilePlan) -> torch.Tensor:
    """K7a. xq [rows, K] int8 with f32 scales sx [rows, K/gs]; row_src
    gathers the tile rows of both (None: they are tile-aligned) → f32
    [Mp, N]. Tiles of 64 or 128 rows."""
    if xq.device.type == "cpu":
        return gmm_a8_plain(xq, sx, row_src, w, plan)
    global launches_a8
    if not gmm_a8_supported(w) or plan.tm not in TILE_HEIGHTS_A8:
        raise ValueError(f"gmm_a8: unsupported stack {tuple(w.q.shape)}, bits {w.bits}, "
                         f"group {w.group_size}, tile rows {plan.tm}")
    _check_rows("gmm_a8", xq, row_src, w, plan, torch.int8)
    sx = sx.to(torch.float32).contiguous()
    if tuple(sx.shape) != (xq.shape[0], w.k_dim // w.group_size) or not sx.is_cuda:
        raise ValueError(f"gmm_a8: scales {tuple(sx.shape)} for rows {tuple(xq.shape)}")
    out = torch.empty((plan.n_tiles * plan.tm, w.n_dim), dtype=torch.float32,
                      device=xq.device)
    err = _fns()[1](xq.data_ptr(), sx.data_ptr(),
                    0 if row_src is None else row_src.data_ptr(), w.q.data_ptr(),
                    w.scales.data_ptr(), plan.tile_e.data_ptr(), plan.tile_valid.data_ptr(),
                    out.data_ptr(), plan.n_tiles, plan.tm, w.k_dim, w.n_dim, w.bits,
                    w.group_size, w.q.stride(0), w.scales.stride(0),
                    torch.cuda.current_stream(xq.device).cuda_stream)
    build.check(err, "gmm_a8")
    launches_a8 += 1
    return out


def _add_tile_bias(y: torch.Tensor, bias: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """y [Mp, N] + the bias row [E, N] of each tile's expert, in y's dtype."""
    n = y.shape[1]
    return (y.view(plan.n_tiles, plan.tm, n) + bias[plan.tile_e.long()][:, None, :]).view(-1, n)


def moe_prefill(x: torch.Tensor, w13: QTensor, w2: QTensor,
                topk_idx: torch.Tensor, topk_weights: torch.Tensor,
                swiglu_limit: float = 0.0, gpt_oss: bool = False,
                pick_valid: Optional[torch.Tensor] = None,
                activation: str = "bf16", tile_rows: Optional[int] = None,
                w13_bias: Optional[torch.Tensor] = None,
                w2_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped MoE: w13 GEMM, SwiGLU, w2 GEMM, then the f32 weighted combine
    of each token's k picks, cast to x.dtype. Three forms, as the
    reference's ``moe_prefill_pallas``: int8 rows (K7a) when asked for and
    the reference's predicate takes both stacks
    (``expert_class.grouped_int8``: int4 / int8, K a whole number of
    groups; on the card K7a takes groups of a multiple of 16 rows and
    N % 64 == 0, and raises for other such stacks); the fused SwiGLU
    epilogue (K4) for experts of the fused class; else two f32 stages (K7)
    with the h rounded to bf16 before SwiGLU. With
    w13_bias [E, 2I] or w2_bias [E, H] (GPT-OSS) it is the reference's
    plain ragged form (``moe_forward_ragged``) on K7 whatever the class or
    `activation` say: h = K7(w13) in f32, rounded to bf16, + the bf16 w13
    bias of each tile's expert, the activation, o = K7(w2) in f32, + the
    f32 w2 bias, then the combine. Padding rows and skipped tiles get a
    bias too; the combine reads neither. A pick with pick_valid == 0 is in
    no tile and adds nothing. tile_rows is the reference's A/B knob for the
    tile height: 64, 128, 256 or 512 rows for K4 / K7, 64 or 128 for K7a
    (None: ``choose_tm``, for every form)."""
    T, H = x.shape
    k = topk_idx.shape[1]
    E = w13.q.shape[0]
    biased = w13_bias is not None or w2_bias is not None
    int8_rows = (activation == "int8" and not biased and expert_class.grouped_int8(w13)
                 and expert_class.grouped_int8(w2))
    heights = TILE_HEIGHTS_A8 if int8_rows else TILE_HEIGHTS
    if tile_rows is not None and tile_rows not in heights:
        raise ValueError(f"moe_prefill: tile_rows={tile_rows} is not taken "
                         + (f"with int8 rows: K7a takes {TILE_HEIGHTS_A8} (whether 256- and "
                            "512-row tiles stay at all is ROADMAP S-4a's question)"
                            if int8_rows else f"(K4 / K7 take {TILE_HEIGHTS})"))
    tm = tile_rows or choose_tm(T * k, E)
    plan = plan_tiles(topk_idx, E, tm, pick_valid=pick_valid)
    Mp = plan.n_tiles * tm
    x = x.contiguous()
    if int8_rows:
        xq, sx = quantize_activations(x.to(torch.bfloat16), w13.group_size)
        h = gmm_a8(xq, sx, plan.row_src, w13, plan)
        a = swiglu_fn(h, swiglu_limit, gpt_oss)
        aq, sa = quantize_activations(a, w2.group_size)
        o = gmm_a8(aq, sa, None, w2, plan)
    elif not biased and expert_class.prefill_fused(w13, w2):
        a = gmm(x, plan.row_src, w13, plan, True, swiglu_limit, gpt_oss)
        o = gmm(a, None, w2, plan, swiglu=False)
    else:
        hb = gmm_two_stage(x, plan.row_src, w13, plan).to(torch.bfloat16)
        if w13_bias is not None:
            hb = _add_tile_bias(hb, w13_bias.to(torch.bfloat16), plan)
        a = swiglu_fn(hb, swiglu_limit, gpt_oss)
        o = gmm_two_stage(a, None, w2, plan)
        if w2_bias is not None:
            o = _add_tile_bias(o, w2_bias.to(torch.float32), plan)
    if pick_valid is None:
        o_rep = o[plan.dest]
    else:
        o_rep = torch.where((plan.dest < Mp)[:, None], o[plan.dest.clamp(max=Mp - 1)],
                            torch.zeros((), dtype=o.dtype, device=o.device))
    o_rep = o_rep.reshape(T, k, H)
    return (o_rep * topk_weights[..., None].to(torch.float32)).sum(dim=1).to(x.dtype)

