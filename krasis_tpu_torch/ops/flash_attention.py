"""K2: causal online-softmax attention over the KV cache
(``csrc/attention.cu``), serving both prefill and decode.

Replaces ``krasis_tpu/ops/flash_attention.py`` ``flash_attention`` and
``decode_attention``. The cache arrives in kernel layout ``[B, Hkv, S, D]``,
bf16 or ``torch.float8_e4m3fn`` (widened to bf16 inside the kernel; q stays
bf16).
V is its first ``v_dim`` lanes (MLA's ``[ckv; kpe]`` rows), or, when ``v`` is
given, the first ``v_dim`` lanes of that separate ``[B, Hkv, S, Dv]`` tensor
(GQA's K and V buffers). The scores use the first ``qk_dim`` lanes (the real
ones; the lane pad up to D is zero). Query s of row b sits at position
``q_offset[b] + s``; ``decode_attention`` is the same call with
``q_offset = kv_len - Sq``. A ``window`` W > 0 hides the keys at
kp ≤ pos − W (GPT-OSS's sliding layers); ``sinks`` [Hq] (f32) add
exp(sink − m) to each row's softmax denominator and no value.

Two launch forms, chosen from shapes alone. With Sq·G ≤ 64 stacked query
rows per kv head (decode, verify steps) the cache is cut into splits
(``split_plan``, from the cache view's length S, never from ``kv_len``,
which lives on the card): one launch writes an f32 partial output with its
row max and row sum per split, a second merges them
(``decode_combine_plain`` is that merge, and the only place a sink joins
in this form). Longer queries (prefill, chunks)
take one launch. The wrapper launches the CUDA kernels for tensors on the
card and runs ``flash_attention_plain`` for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from .. import build

SOURCE = "krasis_tpu_torch/csrc/attention.cu"
REPLACES = "krasis_tpu/ops/flash_attention.py:281"
REPLACES_DECODE = "krasis_tpu/ops/flash_attention.py:533"
launches = 0          # kernel launches since the caller last set it to 0
form_launches: Dict[str, int] = {}   # the same launches, by form_name

NEG_INF = -1e30
FP8 = torch.float8_e4m3fn
MAX_SPLIT_ROWS = 64   # stacked query rows (Sq·G) up to which the split form runs
SMS = 132             # H100 SXM streaming multiprocessors
_MAX_SMEM = 232448
_MAX_DV = 512


def split_plan(S: int, Hkv: int, B: int, sms: int = SMS) -> Tuple[int, int]:
    """(chunk, n): the S cache rows cut into n splits of `chunk` rows (the
    last one shorter), chunk a multiple of 64 and at least 64, with n·Hkv·B
    about twice the card's SM count. Split i covers [i·chunk,
    min((i + 1)·chunk, S))."""
    target = max(1, round(2 * sms / max(1, Hkv * B)))
    per = -(-S // target)
    chunk = max(64, -(-per // 64) * 64)
    return chunk, max(1, -(-S // chunk))


def form_name(split: bool, window: int, sinks: bool, fp8: bool) -> str:
    """The launch form of a call, e.g. "split+window+sinks+fp8"."""
    return ("split" if split else "one-launch") + "".join(
        tag for tag, on in (("+window", window > 0), ("+sinks", sinks), ("+fp8", fp8)) if on)


def _stack_q(q: torch.Tensor, Hkv: int) -> torch.Tensor:
    """[B, Sq, Hq, D] → [B, Hkv, Sq·G, D]: row r is query r // G, head
    hk·G + r % G."""
    B, Sq, Hq, D = q.shape
    G = Hq // Hkv
    return q.reshape(B, Sq, Hkv, G, D).transpose(1, 2).reshape(B, Hkv, Sq * G, D)


def _unstack(o: torch.Tensor, Sq: int) -> torch.Tensor:
    """[B, Hkv, Sq·G, Dv] → [B, Sq, Hq, Dv]."""
    B, Hkv, R, Dv = o.shape
    G = R // Sq
    return o.reshape(B, Hkv, Sq, G, Dv).transpose(1, 2).reshape(B, Sq, Hkv * G, Dv)


def _mask(qp: torch.Tensor, S: int, kv_len: torch.Tensor, window: int) -> torch.Tensor:
    """[B, Q, S]: key kp is seen by the query at qp [B, Q] iff kp ≤ qp,
    kp < kv_len and, with a window, kp > qp − window."""
    kp = torch.arange(S, device=qp.device)[None, None, :]
    qp = qp[:, :, None]
    mask = (kp <= qp) & (kp < kv_len.to(torch.int64)[:, None, None])
    if window > 0:
        mask &= kp > qp - window
    return mask


def _scores(q, kv, q_offset, kv_len, scale, qk_dim, window=0):
    """The split form's stacked bf16 scores in f32, scaled after the dot,
    with the causal, kv_len and window mask: (s [B, Hkv, R, S], mask
    [B, 1, R, S])."""
    B, Sq, Hq, _ = q.shape
    Hkv, S = kv.shape[1], kv.shape[2]
    G = Hq // Hkv
    qf = _stack_q(q[..., :qk_dim].to(torch.bfloat16).to(torch.float32), Hkv)
    kf = kv[..., :qk_dim].to(torch.bfloat16).to(torch.float32)
    s = torch.einsum("bhrd,bhkd->bhrk", qf, kf) * scale
    rows = torch.arange(Sq * G, device=q.device) // G
    qp = q_offset.to(torch.int64)[:, None] + rows                      # [B, R]
    return s, _mask(qp, S, kv_len, window)[:, None]


def _values(kv: torch.Tensor, v: Optional[torch.Tensor], v_dim: int) -> torch.Tensor:
    return (kv if v is None else v)[..., :v_dim].to(torch.bfloat16).to(torch.float32)


def _row_sinks(sinks: torch.Tensor, Hkv: int, R: int) -> torch.Tensor:
    """sinks [Hq] → [Hkv, R] f32: stacked row r of kv head hk belongs to
    head hk·G + r % G."""
    G = sinks.shape[0] // Hkv
    return sinks.to(torch.float32).reshape(Hkv, G).repeat(1, R // G)


def flash_attention_plain(q: torch.Tensor, kv: torch.Tensor, q_offset: torch.Tensor,
                          kv_len: torch.Tensor, scale: float, v_dim: int,
                          v: Optional[torch.Tensor] = None,
                          qk_dim: Optional[int] = None, window: int = 0,
                          sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The one-launch form's function at its rounding points: bf16 q and k
    (an fp8 cache widened to bf16, exactly), f32 scores scaled after the
    dot over the first qk_dim lanes (q's lanes past them are zeroed, so the
    sum keeps its shape), p rounded to bf16 for the PV product, f32 row
    sums, the sink term exp(sink − m) added to them once, and 0 for a row
    that sees no key. The output is bf16, or f32 for f32 q (the reference
    kernel's output takes q's dtype)."""
    B, Sq, Hq, D = q.shape
    Hkv, S = kv.shape[1], kv.shape[2]
    G = Hq // Hkv
    qf = q.to(torch.bfloat16).to(torch.float32)
    if qk_dim is not None and qk_dim < D:
        qf = torch.nn.functional.pad(qf[..., :qk_dim], (0, D - qk_dim))
    qf = qf.reshape(B, Sq, Hkv, G, D)
    kf = kv.to(torch.bfloat16).to(torch.float32)
    s = torch.einsum("bqhgd,bhkd->bhgqk", qf, kf) * scale
    qp = q_offset.to(torch.int64)[:, None] + torch.arange(Sq, device=q.device)
    mask = _mask(qp, S, kv_len, window)[:, None, None]       # [B,1,1,Sq,S]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(mask, torch.exp(s - m_safe), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    if sinks is not None:
        l = l + torch.exp(sinks.to(torch.float32).reshape(1, Hkv, G, 1, 1) - m_safe)
    o = torch.einsum("bhgqk,bhkd->bhgqd",
                     p.to(torch.bfloat16).to(torch.float32), _values(kv, v, v_dim))
    o = o / torch.where(l == 0.0, torch.ones_like(l), l)
    odt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, v_dim).to(odt)


def decode_split_plain(q: torch.Tensor, kv: torch.Tensor, q_offset: torch.Tensor,
                       kv_len: torch.Tensor, scale: float, v_dim: int, chunk: int,
                       v: Optional[torch.Tensor] = None, qk_dim: Optional[int] = None,
                       window: int = 0):
    """The split launch's function: per split of `chunk` cache rows, the f32
    output not yet divided by its row sum, p rounded to bf16 against the
    split's own row max; a split that sees no key (past kv_len, or wholly
    before the window) has m = NEG_INF, l = 0 and O = 0. No sink here: it
    joins in the combine. Returns O [B, Hkv, n, R, v_dim], m and l
    [B, Hkv, n, R]."""
    B, Hkv, S = kv.shape[:3]
    n = -(-S // chunk)
    s, mask = _scores(q, kv, q_offset, kv_len, scale, qk_dim or q.shape[-1], window)
    R = s.shape[2]
    pad = n * chunk - S
    s = torch.nn.functional.pad(s, (0, pad)).reshape(B, Hkv, R, n, chunk).transpose(2, 3)
    mask = torch.nn.functional.pad(mask, (0, pad)).reshape(B, 1, R, n, chunk).transpose(2, 3)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                                  # [B, Hkv, n, R]
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(mask, torch.exp(s - m_safe[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    vf = torch.nn.functional.pad(_values(kv, v, v_dim), (0, 0, 0, pad))
    o = torch.einsum("bhnrk,bhnkd->bhnrd", p.to(torch.bfloat16).to(torch.float32),
                     vf.reshape(B, Hkv, n, chunk, v_dim))
    return o, m, l


def decode_combine_plain(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                         sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The combine launch's function: m* = max m_i, weights e^(m_i - m*) (0
    for a split with m_i ≤ NEG_INF/2), l = Σ w_i l_i plus, with sinks [Hq],
    e^(sink − m*) once (m* taken as 0 where no split saw a key), O = Σ w_i
    O_i / l, 0 where l == 0, rounded to bf16 once. O [B, Hkv, n, R, Dv], m
    and l [B, Hkv, n, R] → [B, Hkv, R, Dv] bf16."""
    m_star = m.amax(dim=2, keepdim=True)
    w = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), torch.exp(m - m_star))
    lsum = (w * l).sum(dim=2)
    if sinks is not None:
        ms = m_star[:, :, 0]
        ms = torch.where(ms <= NEG_INF / 2, torch.zeros_like(ms), ms)
        lsum = lsum + torch.exp(_row_sinks(sinks, m.shape[1], m.shape[3]) - ms)
    # a split of weight 0 is not read: its O may hold anything
    acc = torch.where(w[..., None] > 0, w[..., None] * o, torch.zeros_like(o)).sum(dim=2)
    out = torch.where(lsum[..., None] == 0.0, torch.zeros_like(acc),
                      acc / torch.where(lsum == 0.0, torch.ones_like(lsum), lsum)[..., None])
    return out.to(torch.bfloat16)


_fns = None
_checked = set()


def _lib():
    global _fns
    if _fns is None:
        lib = build.load("attention")
        fn, smem = lib.attention_launch, lib.attention_smem_bytes
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_long] * 3
                       + [ctypes.c_void_p] + [ctypes.c_long] * 3
                       + [ctypes.c_void_p] + [ctypes.c_long] * 3
                       + [ctypes.c_void_p] * 4 + [ctypes.c_float]
                       + [ctypes.c_int] * 12 + [ctypes.c_void_p] * 2)
        smem.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_int
        smem.restype = ctypes.c_long
        _fns = fn, smem
    return _fns


@functools.lru_cache(maxsize=None)
def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check(q, kv, v, v_dim, qk, sinks) -> None:
    """The launch's requirements on shapes, types, layout and device,
    checked once per distinct signature (decode calls repeat one)."""
    B, Sq, Hq, D = q.shape
    Hkv, S, Dk = kv.shape[1], kv.shape[2], kv.shape[3]
    v_width = D if v is None else v.shape[-1]
    f8 = kv.dtype == FP8
    if (Dk != D or Hq % Hkv or qk % 16 or qk > D or v_dim % 16 or v_dim > v_width
            or v_dim > _MAX_DV or (f8 and (D % 16 or v_width % 16))):
        raise ValueError(f"attention: q {tuple(q.shape)} kv {tuple(kv.shape)} v_dim {v_dim} "
                         f"qk_dim {qk}")
    if v is not None and tuple(v.shape[:3]) != (B, Hkv, S):
        raise ValueError(f"attention: v {tuple(v.shape)} vs kv {tuple(kv.shape)}")
    cache = (kv,) if v is None else (kv, v)
    if q.dtype != torch.bfloat16 or any(t.dtype not in (torch.bfloat16, FP8)
                                        or t.dtype != kv.dtype for t in cache):
        raise ValueError("attention: q must be bf16, the cache bf16 or float8_e4m3fn")
    if sinks is not None and (sinks.dtype != torch.float32 or tuple(sinks.shape) != (Hq,)
                              or not sinks.is_contiguous()):
        raise ValueError(f"attention: sinks must be contiguous f32 [{Hq}]")
    tensors = (q, *cache) + (() if sinks is None else (sinks,))
    if any(t.stride(-1) != 1 or any(st * t.element_size() % 16 for st in t.stride()[:-1])
           for t in (q, *cache)):
        raise ValueError("attention: the feature dim must be contiguous, rows 16-byte aligned")
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError("attention: q, the cache and the sinks must be on one CUDA device")
    if _lib()[1](Sq * (Hq // Hkv), qk, v_dim, int(v is None), int(f8)) > _MAX_SMEM:
        raise ValueError(f"attention: qk_dim {qk}, v_dim {v_dim} exceed shared memory")


def flash_attention(q: torch.Tensor, kv: torch.Tensor, q_offset: torch.Tensor,
                    kv_len: torch.Tensor, scale: float, v_dim: int,
                    v: Optional[torch.Tensor] = None,
                    qk_dim: Optional[int] = None, window: int = 0,
                    sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, Sq, Hq, D] over the cache kv [B, Hkv, S, D], with V =
    kv[..., :v_dim] or, when given, v[..., :v_dim] of v [B, Hkv, S, Dv];
    scores over the first qk_dim lanes (default D), keys at kp ≤ pos −
    window hidden when window > 0, sinks [Hq] f32 in the denominators →
    [B, Sq, Hq, v_dim] bf16. On the CPU: ``flash_attention_plain``, the
    function both launch forms compute (the split form rounds p against
    each split's maximum, the one-launch form against the running one)."""
    B, Sq, Hq, D = q.shape
    Hkv, S = kv.shape[1], kv.shape[2]
    qk = qk_dim or D
    if q.device.type == "cpu":
        return flash_attention_plain(q, kv, q_offset, kv_len, scale, v_dim, v, qk, window,
                                     sinks)
    if q.dtype == torch.float32:
        # an f32 model: the kernel takes q and the keys in bf16, where the
        # plain version rounds them too; its output is bf16, which comes
        # back in f32 as the plain version's does
        def bf16(t):
            return t.to(torch.bfloat16) if t.dtype == torch.float32 else t
        return flash_attention(bf16(q), bf16(kv), q_offset, kv_len, scale, v_dim,
                               None if v is None else bf16(v), qk_dim, window,
                               sinks).to(torch.float32)
    global launches
    key = (q.shape, q.stride(), kv.shape, kv.stride(), q.dtype, kv.dtype, q.device,
           kv.device, v_dim, qk,
           None if v is None else (v.shape, v.stride(), v.dtype, v.device),
           None if sinks is None else (sinks.shape, sinks.dtype, sinks.device,
                                       sinks.is_contiguous()))
    if key not in _checked:
        _check(q, kv, v, v_dim, qk, sinks)
        _checked.add(key)
    vptr = 0 if v is None else v.data_ptr()
    if (q.data_ptr() | kv.data_ptr() | vptr) % 16:
        raise ValueError("attention: q and the cache must be 16-byte aligned")
    qo = q_offset.to(device=q.device, dtype=torch.int32).contiguous()
    # the kernel walks keys up to kv_len, not to S: a decode row past the
    # cache end (whose row was dropped) must not read past the buffer
    kl = torch.clamp(kv_len.to(device=q.device, dtype=torch.int32), max=S).contiguous()
    out = torch.empty((B, Sq, Hq, v_dim), dtype=torch.bfloat16, device=q.device)
    R = Sq * (Hq // Hkv)
    ws = 0
    chunk, n = 0, 0
    if R <= MAX_SPLIT_ROWS:
        # one f32 workspace: partial O [B, Hkv, n, R, v_dim], then m and l [B, Hkv, n, R]
        chunk, n = split_plan(S, Hkv, B, _sms(q.device))
        part = torch.empty(B * Hkv * n * R * (v_dim + 2), dtype=torch.float32,
                           device=q.device)
        ws = part.data_ptr()
    qs, ks = q.stride(), kv.stride()
    vs = (0, 0, 0) if v is None else v.stride()
    err = _lib()[0](q.data_ptr(), qs[0], qs[1], qs[2], kv.data_ptr(), ks[0], ks[1], ks[2],
                    vptr, vs[0], vs[1], vs[2], out.data_ptr(), qo.data_ptr(), kl.data_ptr(),
                    0 if sinks is None else sinks.data_ptr(), float(scale), B, Sq, Hq, Hkv,
                    D, D if v is None else v.shape[-1], qk, v_dim, int(window),
                    int(kv.dtype == FP8), chunk, n, ws,
                    torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "attention")
    launches += 2 if chunk else 1
    form = form_name(chunk > 0, window, sinks is not None, kv.dtype == FP8)
    form_launches[form] = form_launches.get(form, 0) + (2 if chunk else 1)
    return out


def decode_attention(q: torch.Tensor, kv: torch.Tensor, kv_len: torch.Tensor,
                     scale: float, v_dim: int, v: Optional[torch.Tensor] = None,
                     qk_dim: Optional[int] = None, window: int = 0,
                     sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sq new tokens at positions kv_len - Sq .. kv_len - 1."""
    return flash_attention(q, kv, kv_len - q.shape[1], kv_len, scale, v_dim, v, qk_dim,
                           window, sinks)
