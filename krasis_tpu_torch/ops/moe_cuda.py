"""K3: W4A8 gathered expert MLP for decode (``csrc/moe_decode.cu``).

Replaces ``krasis_tpu/ops/moe_pallas.py`` ``moe_gathered_w4a8_pallas``.
``moe_w4a8`` launches the two CUDA stages for tensors on the card and runs
``moe_w4a8_plain`` — the same function in plain PyTorch — for tensors on
the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from ..quant import QTensor, unpack

SOURCE = "krasis_tpu_torch/csrc/moe_decode.cu"
REPLACES = "krasis_tpu/ops/moe_pallas.py:391"
launches = 0          # kernel launches since the caller last set it to 0


def quantize_activations(x: torch.Tensor, gs: int):
    """[T, K] → (int8 [T, K], f32 scales [T, K/gs]): per row and K-group,
    scale max|x|/127 clamped at 1e-8, round half to even, clip to ±127."""
    T, K = x.shape
    xg = x.to(torch.float32).reshape(T, K // gs, gs)
    s = torch.clamp(xg.abs().amax(dim=-1) / 127.0, min=1e-8)
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
                   topk_idx: torch.Tensor, topk_weights: torch.Tensor) -> torch.Tensor:
    T, H = x.shape
    k = topk_idx.shape[1]
    I = w2.k_dim
    gs = w13.group_size
    e = topk_idx.reshape(-1).to(torch.int64)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    xq, sx = quantize_activations(x, gs)
    h = _grouped_dot_plain(xq[tok], sx[tok], unpack(w13[e]), w13.scales[e], gs)
    g, u = h[:, :I], h[:, I:]
    a = g * torch.sigmoid(g) * u
    aq, sa = quantize_activations(a, w2.group_size)
    o = _grouped_dot_plain(aq, sa, unpack(w2[e]), w2.scales[e], w2.group_size)
    o = o * topk_weights.reshape(-1, 1).to(torch.float32)
    return o.reshape(T, k, H).sum(dim=1).to(x.dtype)


def _fns():
    lib = build.load("moe_decode")
    f13, f2 = lib.moe_w13_launch, lib.moe_w2_launch
    if f13.argtypes is None:
        f13.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                        + [ctypes.c_long] * 2 + [ctypes.c_void_p])
        f13.restype = ctypes.c_int
        f2.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_long] * 2 + [ctypes.c_void_p])
        f2.restype = ctypes.c_int
    return f13, f2


def supported(w13: QTensor, w2: QTensor) -> bool:
    H, N13 = w13.k_dim, w13.n_dim
    I, H2 = w2.k_dim, w2.n_dim
    gs13, gs2 = w13.group_size, w2.group_size
    return (H == H2 and N13 == 2 * I and w13.bits in (4, 8) and w2.bits in (4, 8)
            and I % 64 == 0 and H % 128 == 0 and H % gs13 == 0 and I % gs2 == 0
            and gs13 % 4 == 0 and gs2 % 32 == 0)


def moe_w4a8(x: torch.Tensor, w13: QTensor, w2: QTensor,
             topk_idx: torch.Tensor, topk_weights: torch.Tensor) -> torch.Tensor:
    """x [T, H] bf16, stacks w13 [E, H(/2), 2I] and w2 [E, I(/2), H], picks
    [T, k] → [T, H] bf16."""
    if x.device.type == "cpu":
        return moe_w4a8_plain(x, w13, w2, topk_idx, topk_weights)
    global launches
    if not supported(w13, w2):
        raise ValueError(f"moe_w4a8: unsupported expert shapes {tuple(w13.q.shape)}, "
                         f"{tuple(w2.q.shape)}")
    if not (x.is_cuda and w13.q.is_cuda and w2.q.is_cuda):
        raise ValueError("moe_w4a8: inputs must be on one CUDA device")
    T, H = x.shape
    k = topk_idx.shape[1]
    P = T * k
    I = w2.k_dim
    for t in (w13.q, w13.scales, w2.q, w2.scales):
        if not t.is_contiguous():
            raise ValueError("moe_w4a8: expert stacks must be contiguous")
    xq, sx = quantize_activations(x, w13.group_size)
    idx = topk_idx.reshape(-1).to(torch.int32).contiguous()
    wt = topk_weights.reshape(-1).to(torch.float32).contiguous()
    a = torch.empty((P, I), dtype=torch.float32, device=x.device)
    o = torch.empty((P, H), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    f13, f2 = _fns()
    err = f13(xq.data_ptr(), sx.data_ptr(), idx.data_ptr(), w13.q.data_ptr(),
              w13.scales.data_ptr(), a.data_ptr(), P, k, H, I, w13.bits,
              w13.group_size, w13.q.stride(0), w13.scales.stride(0), stream)
    build.check(err, "moe_w13")
    launches += 1
    err = f2(a.data_ptr(), idx.data_ptr(), wt.data_ptr(), w2.q.data_ptr(),
             w2.scales.data_ptr(), o.data_ptr(), P, H, I, w2.bits, w2.group_size,
             w2.q.stride(0), w2.scales.stride(0), stream)
    build.check(err, "moe_w2")
    launches += 1
    return o.reshape(T, k, H).sum(dim=1).to(x.dtype)
