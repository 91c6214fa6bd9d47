"""K2: causal online-softmax attention over the KV cache
(``csrc/attention.cu``), serving both prefill and decode.

Replaces ``krasis_tpu/ops/flash_attention.py`` ``flash_attention`` and
``decode_attention``. The cache arrives in kernel layout ``[B, Hkv, S, D]``
and V is its first ``v_dim`` lanes (MLA's ``[ckv; kpe]`` rows). Query s of
row b sits at position ``q_offset[b] + s``; ``decode_attention`` is the same
call with ``q_offset = kv_len - Sq``. ``flash_attention`` launches the CUDA
kernel for tensors on the card and runs ``flash_attention_plain`` for
tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

SOURCE = "krasis_tpu_torch/csrc/attention.cu"
REPLACES = "krasis_tpu/ops/flash_attention.py:281"
REPLACES_DECODE = "krasis_tpu/ops/flash_attention.py:533"
launches = 0          # kernel launches since the caller last set it to 0

NEG_INF = -1e30
_BQ, _BK = 32, 64
_MAX_SMEM = 232448


def smem_bytes(D: int, Dv: int) -> int:
    return (_BQ * (D + 8) * 2 + _BK * (D + 8) * 2 + _BQ * (_BK + 4) * 4
            + _BQ * (_BK + 8) * 2 + _BQ * (Dv + 4) * 4 + _BQ * 12)


def flash_attention_plain(q: torch.Tensor, kv: torch.Tensor, q_offset: torch.Tensor,
                          kv_len: torch.Tensor, scale: float, v_dim: int) -> torch.Tensor:
    """The kernel's function at its rounding points: bf16 q and k, f32
    scores scaled after the dot, p rounded to bf16 for the PV product, f32
    row sums, and 0 for a row that sees no key."""
    B, Sq, Hq, D = q.shape
    Hkv, S = kv.shape[1], kv.shape[2]
    G = Hq // Hkv
    qf = q.to(torch.bfloat16).to(torch.float32).reshape(B, Sq, Hkv, G, D)
    kf = kv.to(torch.bfloat16).to(torch.float32)
    s = torch.einsum("bqhgd,bhkd->bhgqk", qf, kf) * scale
    qp = q_offset.to(torch.int64)[:, None] + torch.arange(Sq, device=q.device)
    kp = torch.arange(S, device=q.device)
    mask = (kp[None, None, :] <= qp[:, :, None]) & (
        kp[None, None, :] < kv_len.to(torch.int64)[:, None, None])
    mask = mask[:, None, None]                               # [B,1,1,Sq,S]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(mask, torch.exp(s - m_safe), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd",
                     p.to(torch.bfloat16).to(torch.float32), kf[..., :v_dim])
    o = o / torch.where(l == 0.0, torch.ones_like(l), l)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, v_dim).to(torch.bfloat16)


def _lib():
    fn = build.load("attention").attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_long] * 3
                       + [ctypes.c_void_p] + [ctypes.c_long] * 3
                       + [ctypes.c_void_p] * 3 + [ctypes.c_float]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, kv: torch.Tensor, q_offset: torch.Tensor,
                    kv_len: torch.Tensor, scale: float, v_dim: int) -> torch.Tensor:
    """q [B, Sq, Hq, D] over the cache kv [B, Hkv, S, D] (V = kv[..., :v_dim])
    → [B, Sq, Hq, v_dim] bf16."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, kv, q_offset, kv_len, scale, v_dim)
    global launches
    B, Sq, Hq, D = q.shape
    _, Hkv, S, Dk = kv.shape
    if Dk != D or Hq % Hkv or D % 16 or v_dim % 16 or v_dim > D:
        raise ValueError(f"attention: q {tuple(q.shape)} kv {tuple(kv.shape)} v_dim {v_dim}")
    if q.dtype != torch.bfloat16 or kv.dtype != torch.bfloat16:
        raise ValueError("attention: q and the cache must be bf16")
    if smem_bytes(D, v_dim) > _MAX_SMEM:
        raise ValueError(f"attention: D={D}, Dv={v_dim} exceed shared memory")
    if q.stride(-1) != 1 or kv.stride(-1) != 1:
        raise ValueError("attention: the feature dim must be contiguous")
    for t in (q, kv):
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:-1]):
            raise ValueError("attention: rows must be 16-byte aligned")
    if not (q.is_cuda and kv.is_cuda and kv.device == q.device):
        raise ValueError("attention: q and the cache must be on one CUDA device")
    qo = q_offset.to(device=q.device, dtype=torch.int32).contiguous()
    kl = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, Sq, Hq, v_dim), dtype=torch.bfloat16, device=q.device)
    qs, ks = q.stride(), kv.stride()
    err = _lib()(q.data_ptr(), qs[0], qs[1], qs[2], kv.data_ptr(), ks[0], ks[1], ks[2],
                 out.data_ptr(), qo.data_ptr(), kl.data_ptr(), float(scale),
                 B, Sq, Hq, Hkv, S, D, v_dim,
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "attention")
    launches += 1
    return out


def decode_attention(q: torch.Tensor, kv: torch.Tensor, kv_len: torch.Tensor,
                     scale: float, v_dim: int) -> torch.Tensor:
    """Sq new tokens at positions kv_len - Sq .. kv_len - 1."""
    return flash_attention(q, kv, kv_len - q.shape[1], kv_len, scale, v_dim)
