"""K3, K5, K6 and K6a: the gathered expert kernels for decode.

``moe_w4a8`` (K3, int8 activations, ``csrc/moe_w4a8.cu``) replaces
``krasis_tpu/ops/moe_pallas.py`` ``moe_gathered_w4a8_pallas``: the fused
expert MLP of a token's picks in two launches, cut as ``plan_w4a8`` says.
``moe_bf16`` (K5, bf16 activations) replaces ``moe_gathered_pallas`` on
K1's core (``csrc/qmm.cu``, two instances of its gathered form, planned by
``plan_k5``): two device kernels a call, the activation, the routing
weights and the pick sum inside them.
``gathered_qmm`` (K6) replaces ``gathered_qmm_pallas`` on K1's core
(``csrc/qmm.cu``, planned by ``qmm_cuda.plan`` with a pick per grid row):
one gathered product per launch, which ``moe_gathered_tiled`` composes with
the activation between for the experts the fused kernels do not take
(``ops/expert_class.py``), and with the biases of GPT-OSS's experts at the
plain gathered path's rounding points. K6a replaces
``gathered_qmm_a8_pallas`` on K3's core (``csrc/moe_w4a8.cu``): the int8
chain ``moe_gathered_tiled(activation="int8")`` in K3's two launches with
pick_valid, and the one product ``gathered_qmm_a8`` in one launch of its
stage 1 (``plan_gq_a8``). Each wrapper launches its kernel for tensors on
the card and runs its plain version — the same function in plain PyTorch —
for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .. import build
from ..quant import QTensor, dequantize, unpack
from . import expert_class, qmm_cuda
from .activations import swiglu

SOURCE = qmm_cuda.SOURCE                                      # K5, on K1's core
SOURCE_W4A8 = "krasis_tpu_torch/csrc/moe_w4a8.cu"
SOURCE_GQ = qmm_cuda.SOURCE                                   # K6, on K1's core
REPLACES = "krasis_tpu/ops/moe_pallas.py:391"
REPLACES_BF16 = "krasis_tpu/ops/moe_pallas.py:226"
REPLACES_GQ = "krasis_tpu/ops/moe_pallas.py:517"
REPLACES_GQ_A8 = "krasis_tpu/ops/moe_pallas.py:605"
K3_KERNELS = ("w4a8_stage1_kernel", "w4a8_stage2_kernel")   # K3's device kernels, by name
# K5's device kernels, by name: K1's kernel with the ACT (w13) or PSUM (w2) flag
K5_KERNELS = tuple(f"qmm_kernel<1, {bits}, __nv_bfloat16, true, {flags}>"
                   for flags in ("true, false", "false, true") for bits in (4, 8))
K6A_KERNELS = ("gq_a8_stage1_kernel", "gq_a8_stage2_kernel")  # K6a's chain
K6A_PRODUCT_KERNEL = "gq_a8_product_kernel"                   # K6a's one product
launches = 0          # K3 kernel launches (two a call) since the caller last set it to 0
launches_bf16 = 0     # K5 kernel launches (two a call), likewise
k5_casts = 0          # K5 calls whose rows or picks needed a PyTorch cast first
launches_gq = 0       # K6
launches_gq_a8 = 0    # K6a's chain, two a call
launches_gq_a8_product = 0    # K6a's one product


_i8_max: dict = {}    # device → 0-dim f32 tensor 127


def quantize_activations(x: torch.Tensor, gs: int):
    """[T, K] → (int8 [T, K], f32 scales [T, K/gs]): per row and K-group,
    scale max|x|/127 clamped at 1e-8, round half to even, clip to ±127.
    The 127 is a tensor on x's device: PyTorch's CUDA division by a Python
    number multiplies by its reciprocal, which rounds some scales one bit
    off the division the reference and the kernels take."""
    T, K = x.shape
    xg = x.to(torch.float32).reshape(T, K // gs, gs)
    d = _i8_max.get(x.device)
    if d is None:
        d = _i8_max[x.device] = torch.tensor(127.0, device=x.device)
    s = torch.clamp(xg.abs().amax(dim=-1) / d, min=1e-8)
    q = torch.clamp(torch.round(xg / s[..., None]), -127, 127).to(torch.int8)
    return q.reshape(T, K), s


def _grouped_dot_plain(xq, sx, w_i8, sw, gs):
    """Σ_g float(int32 dot of group g) * sx[:, g] * sw[:, g], groups in
    order. xq [P, K] int8, sx [P, G], w_i8 [P, K, N] int8, sw [P, G, N].
    Group dots are exact in f32: |d| < 2^24."""
    P, K = xq.shape
    G = K // gs
    d = torch.einsum("pgk,pgkn->pgn",
                     xq.to(torch.float32).reshape(P, G, gs),
                     w_i8.to(torch.float32).reshape(P, G, gs, -1))
    acc = torch.zeros_like(d[:, 0])
    for g in range(G):
        acc = acc + d[:, g] * sx[:, g:g + 1] * sw[:, g].to(torch.float32)
    return acc


def moe_w4a8_plain(x: torch.Tensor, w13: QTensor, w2: QTensor,
                   topk_idx: torch.Tensor, topk_weights: torch.Tensor,
                   swiglu_limit: float = 0.0, gpt_oss: bool = False) -> torch.Tensor:
    """K3's function: int8 group dots into an f32 h, the activation on the
    f32 h (SwiGLU, or GPT-OSS's clamped form), the hidden requantized, and
    the picks' weighted f32 outputs added in pick order, as the reference
    adds them (a sum over the picks takes an order of its own on the card)."""
    T, H = x.shape
    k = topk_idx.shape[1]
    I = w2.k_dim
    gs = w13.group_size
    e = topk_idx.reshape(-1).to(torch.int64)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    xq, sx = quantize_activations(x, gs)
    h = _grouped_dot_plain(xq[tok], sx[tok], unpack(w13[e]), w13.scales[e], gs)
    a = swiglu(h, swiglu_limit, gpt_oss)
    aq, sa = quantize_activations(a, w2.group_size)
    o = _grouped_dot_plain(aq, sa, unpack(w2[e]), w2.scales[e], w2.group_size)
    o = (o * topk_weights.reshape(-1, 1).to(torch.float32)).reshape(T, k, H)
    acc = torch.zeros_like(o[:, 0])
    for j in range(k):
        acc = acc + o[:, j]
    return acc.to(x.dtype)


def moe_bf16_plain(x: torch.Tensor, w13: QTensor, w2: QTensor,
                   topk_idx: torch.Tensor, topk_weights: torch.Tensor,
                   swiglu_limit: float = 0.0, gpt_oss: bool = False) -> torch.Tensor:
    """K5's function at its rounding points: bf16 x and bf16-rounded
    dequantized weights with f32 accumulation, the activation on the f32 h, the
    hidden rounded to bf16 before the w2 product, f32 picks summed in order."""
    T, H = x.shape
    k = topk_idx.shape[1]
    I = w2.k_dim
    e = topk_idx.reshape(-1).to(torch.int64)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    xf = x.to(torch.bfloat16).to(torch.float32)[tok]                     # [P, H]
    h = torch.einsum("ph,phn->pn", xf, dequantize(w13[e], torch.bfloat16).to(torch.float32))
    a = swiglu(h, swiglu_limit, gpt_oss).to(torch.bfloat16).to(torch.float32)
    o = torch.einsum("pi,pih->ph", a, dequantize(w2[e], torch.bfloat16).to(torch.float32))
    o = o * topk_weights.reshape(-1, 1).to(torch.float32)
    return o.reshape(T, k, H).sum(dim=1).to(x.dtype)


UNIT = 32             # packed rows of a K3 unit
GROUP_ROWS = 16       # K3's groups are whole 16-row halves of a unit
K3_COLS = (128, 64, 32)   # weight columns a K3 CTA may stream, widest first
MAX_SPLITS = 8        # the portable thread-block cluster size
SMS = 132             # the H100's streaming multiprocessors
K3_STAGES = (6, 4)    # ring stages of K3's two kernels
MAX_SMEM = 227 * 1024


class StagePlan(NamedTuple):
    """One K3 kernel: each CTA streams `cols` weight columns (stage 1:
    cols/2 gate and cols/2 up columns) of the `units` 32-row units of its
    cluster (stage 1: one pick's packed rows; stage 2: a token's k picks
    times their packed rows, pick-major), which the cluster's `ks` ranks
    split into contiguous ranges; grid = (column tiles, picks or tokens,
    ks)."""
    cols: int
    ks: int
    units: int
    grid: Tuple[int, int, int]

    def unit_range(self, z: int) -> Tuple[int, int]:
        """The units [u0, u1) of rank z, as the kernel cuts them."""
        return self.units * z // self.ks, self.units * (z + 1) // self.ks

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


class W4A8Plan(NamedTuple):
    w13: StagePlan
    w2: StagePlan


def _rank_picks(units: int, ks: int, nb: int, kk: int) -> int:
    """The picks a rank's units can reach (csrc/moe_w4a8.cu rank_picks)."""
    return min(kk, (-(-units // ks) + nb - 1) // nb + 1)


def _k3_smem(stages: int, cols: int, kk: int, G: int, K: int, cr: int, np_: int,
             act_bytes: int) -> int:
    """Shared memory of a K3 CTA: csrc/moe_w4a8.cu ``layout`` in Python,
    for plans made off the card."""
    def al(n):
        return (n + 15) // 16 * 16
    ring = stages * (128 // cols) * UNIT * (cols + 16)
    return (al(max(ring, kk * cr * 4)) + al(kk * G * cr * 4) + al(kk * G * 4)
            + al(kk * G * cr * 2) + al(np_ * K) + al(act_bytes) + al(kk * G) + al(kk * 4))


def k3_smem(stage: int, plan: StagePlan, k: int, H: int, I: int, bits: int, gs: int) -> int:
    """Shared memory of a CTA of K3's stage 1 or 2 under `plan`."""
    if stage == 1:
        return _k3_smem(K3_STAGES[0], plan.cols, 1, H // gs, H, plan.cols // plan.ks, 1, 2 * H)
    nb = (I // 2 if bits == 4 else I) // UNIT
    np_ = _rank_picks(plan.units, plan.ks, nb, k)
    return _k3_smem(K3_STAGES[1], plan.cols, k, I // gs, I, plan.cols // plan.ks, np_,
                    np_ * I * 4)


def _k3_stage(rows: int, tiles_of, units: int, smem_of) -> StagePlan:
    """The widest column tile, then the fewest ranks (a power of two up to 8,
    at most one per unit), that give 2.5 CTAs an SM; else the most CTAs."""
    best = None
    for cols in K3_COLS:
        tiles = tiles_of(cols)
        if tiles is None:
            continue
        ks = 1
        while ks < MAX_SPLITS and 2 * tiles * rows * ks < 5 * SMS and 2 * ks <= units:
            ks *= 2
        p = StagePlan(cols, ks, units, (tiles, rows, ks))
        if smem_of(p) > MAX_SMEM:
            continue
        if 2 * p.ctas >= 5 * SMS:
            return p
        if best is None or p.ctas > best.ctas:
            best = p
    if best is None:
        raise ValueError("moe_w4a8: no K3 tile fits the shared memory")
    return best


def plan_w4a8(T: int, k: int, H: int, I: int, bits: int, gs13: int, gs2: int,
              bits2: Optional[int] = None, smem=k3_smem) -> W4A8Plan:
    """How a K3 call of T tokens with k picks each is cut. Stage 1 has a
    CTA per (a-column tile, pick, rank): its rank's units of the pick's
    packed w13 rows, gate and up columns; stage 2 a CTA per (column tile,
    token, rank): its rank's units of the token's k picks of packed w2 rows,
    so the pick sum stays in one cluster. A group cut between two ranks is
    summed in int32 before it is scaled. `smem(stage, plan, k, H, I, bits,
    gs)` is a CTA's shared memory: the wrapper asks the built kernel
    (``moe_w4a8_smem``), the CPU tests take ``k3_smem``, which the card
    tests hold equal to it."""
    bits2 = bits if bits2 is None else bits2
    if bits not in (4, 8) or bits2 not in (4, 8) or gs13 % GROUP_ROWS or gs2 % GROUP_ROWS:
        raise ValueError(f"moe_w4a8: bits {bits}/{bits2}, groups {gs13}/{gs2}: K3 takes int4 "
                         f"or int8 and groups of a multiple of {GROUP_ROWS} rows")
    if H % 64 or I % 64 or H % gs13 or I % gs2:
        raise ValueError(f"moe_w4a8: H {H}, I {I}, groups {gs13}/{gs2}")
    u13 = (H // 2 if bits == 4 else H) // UNIT
    u2 = k * (I // 2 if bits2 == 4 else I) // UNIT
    s1 = _k3_stage(T * k, lambda c: I // (c // 2) if I % (c // 2) == 0 else None, u13,
                   lambda p: smem(1, p, k, H, I, bits, gs13))
    s2 = _k3_stage(T, lambda c: H // c if H % c == 0 else None, u2,
                   lambda p: smem(2, p, k, H, I, bits2, gs2))
    return W4A8Plan(s1, s2)


def plan_gq_a8(P: int, K: int, N: int, bits: int, gs: int, smem=k3_smem) -> StagePlan:
    """How a K6a product call of P int8 rows against [K, N] blocks is cut:
    K3's stage 1 in its product form, a CTA per (column tile, pick, rank)
    over the rank's units of the pick's packed rows; its shared memory is
    stage 1's at H = K."""
    packed = K // 2 if bits == 4 else K
    if bits not in (4, 8) or gs % UNIT or K % gs or packed % UNIT or N % K3_COLS[-1]:
        raise ValueError(f"gathered_qmm_a8: K {K}, N {N}, bits {bits}, group {gs}: K6a takes "
                         f"int4 or int8, groups of a multiple of {UNIT} rows and whole "
                         f"{UNIT}-row units")
    return _k3_stage(P, lambda c: N // c if N % c == 0 else None, packed // UNIT,
                     lambda p: smem(1, p, 1, K, 0, bits, gs))


def _launcher(name: str, tail: list):
    """A ``moe_w4a8`` library entry with its argument types set: K3's
    arguments, then `tail`."""
    fn = getattr(build.load("moe_w4a8"), name)
    if fn.argtypes is None:
        p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        fn.argtypes = [p, l, p, p, p, p, l, l, p, p, l, l, p, p] + [i] * 12 + [
            ctypes.c_float, i] + tail
        fn.restype = ctypes.c_int
    return fn


def _product_fn():
    fn = build.load("moe_w4a8").gq_a8_product_launch
    if fn.argtypes is None:
        p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        fn.argtypes = [p] * 6 + [l, l, p] + [i] * 7 + [p]
        fn.restype = ctypes.c_int
    return fn


def k3_smem_card(stage: int, plan: StagePlan, k: int, H: int, I: int, bits: int,
                 gs: int) -> int:
    """``k3_smem`` as the built kernel lays its shared memory out."""
    fn = build.load("moe_w4a8").moe_w4a8_smem
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 8
        fn.restype = ctypes.c_int
    return fn(stage, bits, plan.cols, plan.ks, k, H, I, gs)


@functools.lru_cache(maxsize=1024)
def _card_plan(T: int, k: int, H: int, I: int, bits: int, gs13: int, gs2: int,
               bits2: int) -> W4A8Plan:
    return plan_w4a8(T, k, H, I, bits, gs13, gs2, bits2, smem=k3_smem_card)


@functools.lru_cache(maxsize=1024)
def _card_plan_gq(P: int, K: int, N: int, bits: int, gs: int) -> StagePlan:
    return plan_gq_a8(P, K, N, bits, gs, smem=k3_smem_card)


class K5Plan(NamedTuple):
    """K5's two launches, each a K1 plan (``qmm_cuda.Plan``): `w13` over the
    T·k picks' rows, grid (I / 64 column tiles of 64 gate and 64 up
    columns, picks, ks); `w2` over the T tokens, grid (H / 128 column
    tiles, tokens, ks), whose ranks split the token's k picks' packed rows
    pick-major on `unit` = `pk` rows, which divide a pick's packed rows, so
    no step straddles two picks. `smem` is each launch's dynamic shared
    memory, as the kernel sizes it."""
    w13: qmm_cuda.Plan
    w2: qmm_cuda.Plan
    smem: Tuple[int, int]


def plan_k5(T: int, k: int, H: int, I: int, bits: int, gs: int,
            bits2: Optional[int] = None, gs2: Optional[int] = None) -> K5Plan:
    """How a K5 call of T tokens with k picks each is cut. Stage 1 is K1's
    plan over the 2I columns with a grid row per pick. Stage 2 has T·(H/128)
    clusters; a step takes 128 packed rows where even the largest split
    leaves few CTAs and 128 divides a pick's rows, else 64 or 32 (whichever
    divides them), and the fewest ranks (a power of two up to 8, at most one
    per unit) that reach 2.5 CTAs an SM, as K1's plan."""
    bits2 = bits if bits2 is None else bits2
    gs2 = gs if gs2 is None else gs2
    if bits not in (4, 8) or bits2 not in (4, 8) or I % 64 or H % 128 or H % gs or I % gs2:
        raise ValueError(f"moe_bf16: H {H}, I {I}, bits {bits}/{bits2}, groups {gs}/{gs2}")
    s1 = qmm_cuda.plan(1, H, 2 * I, bits, gs, picks=T * k)
    rows = I // 2 if bits2 == 4 else I
    tiles = H // qmm_cuda.COLS
    ctas = tiles * T
    few = ctas * MAX_SPLITS < 2 * SMS
    pk = next(p for p in ((128, 64, 32) if few else (64, 32)) if rows % p == 0)
    units = k * rows // pk
    ks = 1
    while ks < MAX_SPLITS and 2 * ctas * ks < 5 * SMS and 2 * ks <= units:
        ks *= 2
    s2 = qmm_cuda.Plan(1, pk, ks, pk, (tiles, T, ks))
    return K5Plan(s1, s2, (qmm_cuda.smem(s1.pk, 1, bits, gs), qmm_cuda.smem(pk, 1, bits2, gs2)))


@functools.lru_cache(maxsize=1024)
def _k5_plan(T: int, k: int, H: int, I: int, bits: int, gs: int, bits2: int,
             gs2: int) -> K5Plan:
    return plan_k5(T, k, H, I, bits, gs, bits2, gs2)


def _k5_fn():
    fn = build.load("qmm").k5_launch
    if fn.argtypes is None:
        p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        fn.argtypes = [i] + [p] * 6 + [i] * 9 + [l, l, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def supported(w13: QTensor, w2: QTensor) -> bool:
    """K5's stacks: int4 / int8 w13 [E, H(/2), 2I] and w2 [E, I(/2), H],
    I a multiple of 64 and H of 128, K a whole number of groups of an even
    size (a k pair of K1's mma fragment shares one scale)."""
    H, N13 = w13.k_dim, w13.n_dim
    I, H2 = w2.k_dim, w2.n_dim
    return (H == H2 and N13 == 2 * I and w13.bits in (4, 8) and w2.bits in (4, 8)
            and I % 64 == 0 and H % 128 == 0 and H % w13.group_size == 0
            and I % w2.group_size == 0 and w13.group_size % 2 == 0
            and w2.group_size % 2 == 0)


def w4a8_supported(w13: QTensor, w2: QTensor) -> bool:
    """K3's stacks, and K6a's chain's: those of ``supported`` whose groups
    are whole 16-row halves of a 32-row unit (every model of the
    repository: 32 or 128; groups of 16 take the kernels' G16 form)."""
    return (supported(w13, w2) and w13.group_size % GROUP_ROWS == 0
            and w2.group_size % GROUP_ROWS == 0)


def _check(name: str, x: torch.Tensor, w13: QTensor, w2: QTensor, ok: bool) -> None:
    if not ok:
        raise ValueError(f"{name}: unsupported expert shapes {tuple(w13.q.shape)}, "
                         f"{tuple(w2.q.shape)} (groups {w13.group_size}, {w2.group_size})")
    if not (x.is_cuda and w13.q.is_cuda and w2.q.is_cuda):
        raise ValueError(f"{name}: inputs must be on one CUDA device")
    for t in (w13.q, w13.scales, w2.q, w2.scales):
        if not t.is_contiguous():
            raise ValueError(f"{name}: expert stacks must be contiguous")


def _k3_core(name: str, fn, x: torch.Tensor, w13: QTensor, w2: QTensor,
             topk_idx: torch.Tensor, topk_weights: torch.Tensor, swiglu_limit: float,
             gpt_oss: bool, *tail) -> torch.Tensor:
    """One call of K3's two kernels (K3's own, or K6a's chain with its pick
    flags in `tail`): checked, planned, allocated and launched."""
    T = x.shape[0]
    k = topk_idx.shape[-1]
    H, I = w13.k_dim, w2.k_dim
    _check(name, x, w13, w2, w4a8_supported(w13, w2) and x.shape[1] == H)
    for t in (w13.q, w13.scales, w2.q, w2.scales):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: expert stacks must be 16-byte aligned")
    plan = _card_plan(T, k, H, I, w13.bits, w13.group_size, w2.group_size, w2.bits)
    xb = x
    if x.dtype != torch.bfloat16 or x.stride(-1) != 1 or x.stride(0) % 2 or x.data_ptr() % 4:
        xb = x.to(torch.bfloat16, memory_format=torch.contiguous_format, copy=True)
    idx = topk_idx.reshape(-1).to(torch.int32).contiguous()
    wt = topk_weights.reshape(-1).to(torch.float32).contiguous()
    if idx.numel() != T * k or wt.numel() != T * k or not (idx.is_cuda and wt.is_cuda):
        raise ValueError(f"{name}: picks {tuple(topk_idx.shape)} / "
                         f"{tuple(topk_weights.shape)} on the card for {T} tokens")
    a = torch.empty((T * k, I), dtype=torch.float32, device=x.device)
    out = torch.empty((T, H), dtype=torch.bfloat16, device=x.device)
    err = fn(xb.data_ptr(), xb.stride(0), idx.data_ptr(), wt.data_ptr(),
             w13.q.data_ptr(), w13.scales.data_ptr(), w13.q.stride(0),
             w13.scales.stride(0), w2.q.data_ptr(), w2.scales.data_ptr(),
             w2.q.stride(0), w2.scales.stride(0),
             a.data_ptr(), out.data_ptr(), T, k, H, I, w13.bits, w2.bits,
             w13.group_size, w2.group_size, plan.w13.cols, plan.w13.ks,
             plan.w2.cols, plan.w2.ks, float(swiglu_limit), int(gpt_oss), *tail,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, name)
    return out if x.dtype == torch.bfloat16 else out.to(x.dtype)


def moe_w4a8(x: torch.Tensor, w13: QTensor, w2: QTensor,
             topk_idx: torch.Tensor, topk_weights: torch.Tensor,
             swiglu_limit: float = 0.0, gpt_oss: bool = False) -> torch.Tensor:
    """x [T, H] bf16, stacks w13 [E, H(/2), 2I] and w2 [E, I(/2), H], picks
    [T, k] (int32 indices, f32 weights, as routing gives them) → [T, H]
    bf16: exactly two device kernels a call."""
    if x.device.type == "cpu":
        return moe_w4a8_plain(x, w13, w2, topk_idx, topk_weights, swiglu_limit, gpt_oss)
    global launches
    out = _k3_core("moe_w4a8", _launcher("moe_w4a8_launch", [ctypes.c_void_p]), x, w13, w2,
                   topk_idx, topk_weights, swiglu_limit, gpt_oss)
    launches += 2
    return out


def moe_bf16(x: torch.Tensor, w13: QTensor, w2: QTensor,
             topk_idx: torch.Tensor, topk_weights: torch.Tensor,
             swiglu_limit: float = 0.0, gpt_oss: bool = False) -> torch.Tensor:
    """K5, the same call with bf16 activations: x [T, H] bf16, stacks
    w13 [E, H(/2), 2I] and w2 [E, I(/2), H], picks [T, k] (int32 ids and f32
    weights, as the router gives them) → [T, H] bf16: exactly two device
    kernels a call, instances of K1's kernel (``plan_k5``)."""
    if x.device.type == "cpu":
        return moe_bf16_plain(x, w13, w2, topk_idx, topk_weights, swiglu_limit, gpt_oss)
    global launches_bf16, k5_casts
    T, H = x.shape
    _check("moe_bf16", x, w13, w2, supported(w13, w2) and H == w13.k_dim)
    for w in (w13, w2):
        if w.q.dtype != torch.int8 or w.scales.dtype != torch.bfloat16 or w.q.data_ptr() % 4:
            raise ValueError("moe_bf16: stacks must be int8 storage with bf16 scales, "
                             "4-byte aligned")
    k = topk_idx.shape[-1]
    I = w2.k_dim
    # the kernels read the router's dtypes (int32 ids, f32 weights) and bf16
    # rows; anything else takes a PyTorch cast first, counted in k5_casts
    xb, idx, wt = x, topk_idx, topk_weights
    cast = False
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        xb, cast = x.to(torch.bfloat16).contiguous(), True
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        idx, cast = idx.to(torch.int32).contiguous(), True
    if wt.dtype != torch.float32 or not wt.is_contiguous():
        wt, cast = wt.to(torch.float32).contiguous(), True
    k5_casts += cast
    if idx.numel() != T * k or wt.numel() != T * k or not (idx.is_cuda and wt.is_cuda):
        raise ValueError(f"moe_bf16: picks {tuple(topk_idx.shape)} / "
                         f"{tuple(topk_weights.shape)} on the card for {T} tokens")
    plan = _k5_plan(T, k, H, I, w13.bits, w13.group_size, w2.bits, w2.group_size)
    a = torch.empty((T * k, I), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((T, H), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = _k5_fn()
    for stage, p, rows, src, w, dst, K, N in (
            (1, plan.w13, T * k, xb, w13, a, H, 2 * I),
            (2, plan.w2, T, a, w2, out, I, H)):
        x_vec = int(K % 16 == 0 and p.unit % 8 == 0 and src.data_ptr() % 16 == 0)
        err = fn(stage, src.data_ptr(), idx.data_ptr(), wt.data_ptr(), w.q.data_ptr(),
                 w.scales.data_ptr(), dst.data_ptr(), rows, k, K, N, w.bits, w.group_size,
                 p.unit, p.ks, p.pk, w.q.stride(0), w.scales.stride(0), x_vec,
                 float(swiglu_limit), int(gpt_oss), stream)
        build.check(err, f"moe_bf16 stage {stage}")
        launches_bf16 += 1
    return out if x.dtype == torch.bfloat16 else out.to(x.dtype)


def gathered_qmm_supported(w: QTensor) -> bool:
    """Stacks K6 takes on K1's core: int4 / int8 experts [E, K(/2), N] with
    K a whole number of groups, N % 4 == 0 (the last column tile may be
    partial), int8 storage and bf16 scales, contiguous on 4-byte
    boundaries, as K1 checks a weight. A k pair of an mma fragment shares
    one scale, so groups are even and, for int4, K/2 is too."""
    if not (isinstance(w, QTensor) and w.q.dim() == 3 and w.bits in (4, 8)):
        return False
    K, N, gs = w.k_dim, w.n_dim, w.group_size
    return (K % gs == 0 and gs % 2 == 0 and N % 4 == 0 and (w.bits == 8 or K % 4 == 0)
            and w.q.dtype == torch.int8 and w.scales.dtype == torch.bfloat16
            and w.q.is_contiguous() and w.scales.is_contiguous()
            and w.q.data_ptr() % 4 == 0 and w.scales.data_ptr() % 4 == 0)


def gathered_qmm_a8_supported(w: QTensor) -> bool:
    """K6a's product runs on K3's core (``plan_gq_a8``), which takes less
    than K6: whole 128-column blocks, K a whole number of groups, and
    groups and packed rows in whole 32-row units."""
    if not (isinstance(w, QTensor) and w.q.dim() == 3 and w.bits in (4, 8)):
        return False
    packed = w.k_dim // 2 if w.bits == 4 else w.k_dim
    return (w.n_dim % 128 == 0 and w.k_dim % w.group_size == 0
            and w.group_size % UNIT == 0 and packed % UNIT == 0)


def _skip_invalid(out: torch.Tensor, pick_valid: Optional[torch.Tensor]) -> torch.Tensor:
    if pick_valid is None:
        return out
    return torch.where(pick_valid.reshape(-1, 1) != 0, out, torch.zeros_like(out))


def gathered_qmm_plain(x_rows: torch.Tensor, w: QTensor, expert_ids: torch.Tensor,
                       pick_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6's function: out[p] = bf16(x[p]) @ bf16(dequant(W[e[p]])) in f32,
    zeros for the picks with pick_valid[p] == 0."""
    e = expert_ids.reshape(-1).to(torch.int64)
    xf = x_rows.to(torch.bfloat16).to(torch.float32)
    out = torch.einsum("pk,pkn->pn", xf, dequantize(w[e], torch.bfloat16).to(torch.float32))
    return _skip_invalid(out, pick_valid)


def gathered_qmm_a8_plain(xq: torch.Tensor, sx: torch.Tensor, w: QTensor,
                          expert_ids: torch.Tensor,
                          pick_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6a's function: per K-group int32 dots of the int8 rows xq [P, K]
    with the unscaled integer weights, acc += d * sx * sw in f32, groups in
    order; zeros for the picks with pick_valid[p] == 0."""
    e = expert_ids.reshape(-1).to(torch.int64)
    out = _grouped_dot_plain(xq, sx.to(torch.float32), unpack(w[e]), w.scales[e],
                             w.group_size)
    return _skip_invalid(out, pick_valid)


def _gq_fn():
    fn = build.load("qmm").gathered_qmm_launch
    if fn.argtypes is None:
        p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        fn.argtypes = [p] * 6 + [i] * 8 + [l, l, i, p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=1024)
def plan_gq(P: int, K: int, N: int, bits: int, gs: int) -> qmm_cuda.Plan:
    """How a K6 call of P picks against [K, N] experts is cut: K1's plan
    with the column tiles of every pick, grid (tiles, P, ks)."""
    return qmm_cuda.plan(1, K, N, bits, gs, picks=P)


def _gq_args(name: str, rows: torch.Tensor, w: QTensor, expert_ids: torch.Tensor,
             pick_valid: Optional[torch.Tensor], ok: bool):
    """Checked launch operands shared by K6 and K6a: (idx, valid, out)."""
    P, K = rows.shape
    if not ok or K != w.k_dim:
        raise ValueError(f"{name}: rows {tuple(rows.shape)} vs stack {tuple(w.q.shape)} "
                         f"(bits {w.bits}, group {w.group_size})")
    for t in (rows, w.q, w.scales):
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError(f"{name}: rows and expert stacks must be contiguous on the card")
    idx = expert_ids.reshape(-1).to(torch.int32).contiguous()
    if idx.shape[0] != P:
        raise ValueError(f"{name}: {idx.shape[0]} expert ids for {P} rows")
    valid = None
    if pick_valid is not None:
        valid = pick_valid.reshape(-1).to(torch.int32).contiguous()
        if valid.shape[0] != P:
            raise ValueError(f"{name}: {valid.shape[0]} pick_valid flags for {P} rows")
    out = torch.empty((P, w.n_dim), dtype=torch.float32, device=rows.device)
    return idx, valid, out


def gathered_qmm(x_rows: torch.Tensor, w: QTensor, expert_ids: torch.Tensor,
                 pick_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6. x_rows [P, K] bf16, stack w [E, K(/2), N] read in place at
    expert_ids [P], pick_valid [P] (1 = compute) → f32 [P, N]: one launch
    of K1's core."""
    if x_rows.device.type == "cpu":
        return gathered_qmm_plain(x_rows, w, expert_ids, pick_valid)
    global launches_gq
    xb = x_rows.to(torch.bfloat16).contiguous()
    idx, valid, out = _gq_args("gathered_qmm", xb, w, expert_ids, pick_valid,
                               gathered_qmm_supported(w))
    P, K = xb.shape
    p = plan_gq(P, K, w.n_dim, w.bits, w.group_size)
    x_vec = int(K % 16 == 0 and p.unit % 8 == 0 and xb.data_ptr() % 16 == 0)
    err = _gq_fn()(xb.data_ptr(), idx.data_ptr(), 0 if valid is None else valid.data_ptr(),
                   w.q.data_ptr(), w.scales.data_ptr(), out.data_ptr(), P, K, w.n_dim, w.bits,
                   w.group_size, p.unit, p.ks, p.pk, w.q.stride(0), w.scales.stride(0), x_vec,
                   torch.cuda.current_stream(xb.device).cuda_stream)
    build.check(err, "gathered_qmm")
    launches_gq += 1
    return out


def gathered_qmm_a8(xq: torch.Tensor, sx: torch.Tensor, w: QTensor,
                    expert_ids: torch.Tensor,
                    pick_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6a's one product. xq [P, K] int8 with f32 scales sx [P, K/gs] (per
    row and K-group, ``quantize_activations``) → f32 [P, N]: one launch of
    K3's stage 1 in its product form."""
    if xq.device.type == "cpu":
        return gathered_qmm_a8_plain(xq, sx, w, expert_ids, pick_valid)
    global launches_gq_a8_product
    if xq.dtype != torch.int8:
        raise ValueError(f"gathered_qmm_a8: rows must be int8, got {xq.dtype}")
    xq = xq.contiguous()
    idx, valid, out = _gq_args("gathered_qmm_a8", xq, w, expert_ids, pick_valid,
                               gathered_qmm_a8_supported(w))
    sx = sx.to(torch.float32).contiguous()
    if tuple(sx.shape) != (xq.shape[0], w.k_dim // w.group_size) or not sx.is_cuda:
        raise ValueError(f"gathered_qmm_a8: scales {tuple(sx.shape)} for rows "
                         f"{tuple(xq.shape)}, group {w.group_size}")
    if xq.data_ptr() % 4 or w.q.data_ptr() % 16 or w.scales.data_ptr() % 4:
        raise ValueError("gathered_qmm_a8: rows must be 4-byte and stacks 16-byte aligned")
    P = xq.shape[0]
    plan = _card_plan_gq(P, w.k_dim, w.n_dim, w.bits, w.group_size)
    err = _product_fn()(xq.data_ptr(), sx.data_ptr(), idx.data_ptr(),
                        0 if valid is None else valid.data_ptr(), w.q.data_ptr(),
                        w.scales.data_ptr(), w.q.stride(0), w.scales.stride(0),
                        out.data_ptr(), P, w.k_dim, w.n_dim, w.bits, w.group_size,
                        plan.cols, plan.ks, torch.cuda.current_stream(xq.device).cuda_stream)
    build.check(err, "gathered_qmm_a8")
    launches_gq_a8_product += 1
    return out


def moe_gathered_a8_plain(x: torch.Tensor, w13: QTensor, w2: QTensor,
                          topk_idx: torch.Tensor, topk_weights: torch.Tensor,
                          swiglu_limit: float = 0.0, gpt_oss: bool = False,
                          pick_valid: Optional[torch.Tensor] = None,
                          product=None) -> torch.Tensor:
    """K6a's chain, the reference's ``moe_gathered_tiled(activation="int8")``:
    x quantized per K-group, the w13 product, the activation on the f32 h,
    the hidden requantized, the w2 product, the picks weighted in f32 and
    added in pick order (a sum over the picks takes an order of its own on
    the card). `product` is the one-product function,
    ``gathered_qmm_a8_plain`` unless given."""
    product = product or gathered_qmm_a8_plain
    T, H = x.shape
    k = topk_idx.shape[-1]
    eids = topk_idx.reshape(-1)
    pv = None if pick_valid is None else pick_valid.reshape(-1)
    xq, sx = quantize_activations(x.to(torch.bfloat16), w13.group_size)
    h = product(xq.repeat_interleave(k, dim=0), sx.repeat_interleave(k, dim=0), w13, eids, pv)
    a = swiglu(h, swiglu_limit, gpt_oss)
    aq, sa = quantize_activations(a, w2.group_size)
    o = product(aq, sa, w2, eids, pv)
    o = o.reshape(T, k, H) * topk_weights[..., None].to(torch.float32)
    acc = torch.zeros_like(o[:, 0])
    for j in range(k):
        acc = acc + o[:, j]
    return acc.to(x.dtype)


def moe_gathered_bf16_plain(x: torch.Tensor, w13: QTensor, w2: QTensor,
                            topk_idx: torch.Tensor, topk_weights: torch.Tensor,
                            swiglu_limit: float = 0.0, gpt_oss: bool = False,
                            pick_valid: Optional[torch.Tensor] = None,
                            w13_bias: Optional[torch.Tensor] = None,
                            w2_bias: Optional[torch.Tensor] = None,
                            product=None) -> torch.Tensor:
    """The bf16-row chain, the reference's ``moe_gathered_tiled`` in bf16 and,
    with biases, its ``moe_forward_gathered``: the w13 product in f32,
    h rounded to bf16, + w13_bias[e] in bf16, the activation, the w2 product
    in f32, + w2_bias[e] in f32, the routing weights in f32, the sum over
    the picks cast to x's dtype. w13_bias [E, 2I], w2_bias [E, H]. `product`
    is the one-product function, ``gathered_qmm_plain`` unless given."""
    product = product or gathered_qmm_plain
    T, H = x.shape
    k = topk_idx.shape[-1]
    eids = topk_idx.reshape(-1)
    pv = None if pick_valid is None else pick_valid.reshape(-1)
    h = product(x.repeat_interleave(k, dim=0), w13, eids, pv).to(torch.bfloat16)
    if w13_bias is not None:
        h = h + w13_bias[eids.long()].to(torch.bfloat16)
    a = swiglu(h, swiglu_limit, gpt_oss)
    o = product(a, w2, eids, pv)
    if w2_bias is not None:
        o = o + w2_bias[eids.long()].to(torch.float32)
    o = o.reshape(T, k, H) * topk_weights[..., None].to(torch.float32)
    return o.sum(dim=1).to(x.dtype)


def moe_gathered_tiled(x: torch.Tensor, w13: QTensor, w2: QTensor,
                       topk_idx: torch.Tensor, topk_weights: torch.Tensor,
                       swiglu_limit: float = 0.0, gpt_oss: bool = False,
                       pick_valid: Optional[torch.Tensor] = None,
                       activation: str = "bf16", w13_bias: Optional[torch.Tensor] = None,
                       w2_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode MoE as two gathered products with the activation between: the
    form of experts too large for the fused kernels, at the rounding points
    of the reference's ``moe_gathered_tiled``. int8 (where the reference's
    predicate takes both stacks, ``expert_class.gathered_int8``): rows
    quantized per K-group, the activation on the f32 h, the hidden
    requantized — on the card K6a's two kernels and nothing else; bf16: two
    K6 launches, the f32 h rounded to bf16 before the activation, with
    GPT-OSS's expert biases where given (``moe_gathered_bf16_plain``).
    x [T, H], picks [T, k], pick_valid [T, k] → [T, H]."""
    global launches_gq_a8
    T, H = x.shape
    k = topk_idx.shape[-1]
    if (activation == "int8" and expert_class.gathered_int8(w13)
            and expert_class.gathered_int8(w2)):
        if w13_bias is not None or w2_bias is not None:
            raise ValueError("moe_gathered_tiled: the int8 form takes no expert biases")
        if x.device.type == "cpu":
            return moe_gathered_a8_plain(x, w13, w2, topk_idx, topk_weights, swiglu_limit,
                                         gpt_oss, pick_valid, product=gathered_qmm_a8)
        valid = 0
        if pick_valid is not None:
            pv = pick_valid.reshape(-1).to(torch.int32).contiguous()
            if pv.numel() != T * k or not pv.is_cuda:
                raise ValueError(f"moe_gathered_tiled: pick_valid {tuple(pick_valid.shape)} "
                                 f"for {T} tokens of {k} picks")
            valid = pv.data_ptr()
        out = _k3_core("moe_gathered_tiled", _launcher("gq_a8_launch", [ctypes.c_void_p] * 2),
                       x, w13, w2, topk_idx, topk_weights, swiglu_limit, gpt_oss, valid)
        launches_gq_a8 += 2
        return out
    return moe_gathered_bf16_plain(x, w13, w2, topk_idx, topk_weights, swiglu_limit, gpt_oss,
                                   pick_valid, w13_bias, w2_bias, product=gathered_qmm)
