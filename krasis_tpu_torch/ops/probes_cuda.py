"""P4-P8: the probe kernels of ``csrc/probes.cu``, counterparts of the TPU
probes in ``benchmarks/probe_int4_mxu.py``.

They run on no serving path: ``probes/probe_int4_mxu.py`` drives them.
``stream`` (P4, ``stream_once``) column-sums the packed bytes of the
picked experts, the gathered decode pattern's bandwidth floor;
``unpack_colsum`` (P8, ``unpack_once``) unpacks one expert's int4 w13 in
one of two ways and column-sums it; ``int4_dot`` (P6,
``try_int4_pallas_cast``) and ``int4_dot_native`` (P5, ``try_int4_pallas``)
multiply int8 rows by an int4 matrix in the quantizer's layout, through s8
and s4 tensor-core products; ``int4_view_shape`` (P7, ``try_bitcast``) is
the shape of a byte block seen as int4. Every sum is of small integers, so
each kernel equals its plain version exactly. Each wrapper launches its
kernel for tensors on the card and runs its plain version for tensors on
the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from ..quant import unpack_int4

SOURCE = "krasis_tpu_torch/csrc/probes.cu"
REPLACES_STREAM = "benchmarks/probe_int4_mxu.py:114"
REPLACES_UNPACK = "benchmarks/probe_int4_mxu.py:223"
REPLACES_NATIVE = "benchmarks/probe_int4_mxu.py:152"
REPLACES_CAST = "benchmarks/probe_int4_mxu.py:171"
REPLACES_VIEW = "benchmarks/probe_int4_mxu.py:192"
UNPACK_MODES = {"maskxor": 1, "shift": 2}
# kernel launches since the caller last set each to 0
launches_stream = 0
launches_unpack_maskxor = 0
launches_unpack_shift = 0
launches_int4_native = 0
launches_int4_cast = 0
launches_int4_view = 0


def stream_plain(q13: torch.Tensor, q2: torch.Tensor, eids: torch.Tensor,
                 H: int) -> torch.Tensor:
    """The column sums of the picked experts' packed bytes as signed
    integers: Σ over picks and rows of q13[e, :, :H] and of q2[e] → f32
    [1, H]."""
    e = eids.reshape(-1).to(torch.int64)
    s13 = q13[e][..., :H].to(torch.float32).sum(dim=(0, 1))
    s2 = q2[e].to(torch.float32).sum(dim=(0, 1))
    return (s13 + s2)[None]


def unpack_colsum_plain(q: torch.Tensor, mode: str) -> torch.Tensor:
    """One packed int4 block [K/2, N] unpacked to [K, N] — mask-xor-sub or
    shift sign-extension, at int32 width — then column sums → f32 [1, N]."""
    b = q.to(torch.int32)
    if mode == "maskxor":
        lo = ((b & 0xF) ^ 8) - 8
        hi = (((b >> 4) & 0xF) ^ 8) - 8
    elif mode == "shift":
        lo = (b << 28) >> 28
        hi = (b << 24) >> 28
    else:
        raise ValueError(f"unpack mode {mode!r}")
    w = torch.cat([lo, hi], dim=0).to(torch.int8)
    return w.to(torch.float32).sum(dim=0, keepdim=True)


def int4_dot_plain(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x int8 [M, K] · w int4 [K, N] (q the split-half packed [K/2, N]) →
    int32 [M, N], exact (in f64)."""
    w = unpack_int4(q)
    return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)


def int4_view_shape_plain(q: torch.Tensor) -> torch.Tensor:
    """The shape of a byte block [R, N] seen as int4: int32 [1, 2] = [2R, N]."""
    R, N = q.shape
    return torch.tensor([[2 * R, N]], dtype=torch.int32, device=q.device)


def _lib():
    lib = build.load("probes")
    if lib.stream_launch.argtypes is None:
        lib.stream_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                                      + [ctypes.c_long] * 2 + [ctypes.c_int]
                                      + [ctypes.c_void_p] * 3)
        lib.unpack_launch.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p] * 2)
        lib.int4_dot_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                                        + [ctypes.c_void_p])
        lib.int4_view_launch.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                                         + [ctypes.c_void_p] * 2)
        for fn in (lib.stream_launch, lib.unpack_launch, lib.int4_dot_launch,
                   lib.int4_view_launch):
            fn.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _bytes_on_card(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if not (t.is_cuda and t.is_contiguous() and t.element_size() == 1):
            raise ValueError(f"{name}: byte tensors must be contiguous on the card")


def stream(q13: torch.Tensor, q2: torch.Tensor, eids: torch.Tensor, H: int) -> torch.Tensor:
    """P4. q13 [E, rows13, N13] and q2 [E, rows2, N2] packed bytes, eids [k]
    → f32 [1, H]; every byte of the k picks is read."""
    if q13.device.type == "cpu":
        return stream_plain(q13, q2, eids, H)
    global launches_stream
    _bytes_on_card("stream", q13, q2)
    if q13.shape[-1] % 16 or q2.shape[-1] % 16 or H > min(q13.shape[-1], q2.shape[-1]):
        raise ValueError(f"stream: columns {q13.shape[-1]}, {q2.shape[-1]} for H {H}")
    e = eids.reshape(-1).to(torch.int32).contiguous()
    out = torch.zeros((1, H), dtype=torch.float32, device=q13.device)
    err = _lib().stream_launch(q13.data_ptr(), q2.data_ptr(), e.data_ptr(), e.numel(),
                               q13.shape[-2], q13.shape[-1], q2.shape[-2], q2.shape[-1],
                               q13.stride(0), q2.stride(0), H, out.data_ptr(), None,
                               _stream(q13))
    build.check(err, "stream")
    launches_stream += 1
    return out


def unpack_colsum(q: torch.Tensor, mode: str) -> torch.Tensor:
    """P8. One expert's packed int4 block [K/2, N] → f32 [1, N]."""
    if q.device.type == "cpu":
        return unpack_colsum_plain(q, mode)
    global launches_unpack_maskxor, launches_unpack_shift
    _bytes_on_card("unpack_colsum", q)
    if mode not in UNPACK_MODES or q.dim() != 2 or q.shape[1] % 16:
        raise ValueError(f"unpack_colsum: mode {mode!r}, block {tuple(q.shape)}")
    out = torch.zeros((1, q.shape[1]), dtype=torch.float32, device=q.device)
    err = _lib().unpack_launch(q.data_ptr(), q.shape[0], q.shape[1], UNPACK_MODES[mode],
                               out.data_ptr(), _stream(q))
    build.check(err, "unpack_colsum")
    if mode == "maskxor":
        launches_unpack_maskxor += 1
    else:
        launches_unpack_shift += 1
    return out


def _int4_dot(x: torch.Tensor, q: torch.Tensor, native: bool) -> torch.Tensor:
    name = "int4_dot_native" if native else "int4_dot"
    M, K = x.shape
    if (x.dtype != torch.int8 or M > 16 or K % 64 or tuple(q.shape[:1]) != (K // 2,)
            or q.dim() != 2 or q.shape[1] % 8):
        raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype}, q {tuple(q.shape)}")
    _bytes_on_card(name, x, q)
    out = torch.empty((M, q.shape[1]), dtype=torch.int32, device=x.device)
    err = _lib().int4_dot_launch(x.data_ptr(), q.data_ptr(), out.data_ptr(), M, K, q.shape[1],
                                 int(native), _stream(x))
    build.check(err, name)
    return out


def int4_dot(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P6. x int8 [M ≤ 16, K] · int4 w [K, N] (q packed [K/2, N]) → int32
    [M, N]: the nibbles become s8 in registers, then s8 tensor-core
    products."""
    if x.device.type == "cpu":
        return int4_dot_plain(x, q)
    global launches_int4_cast
    out = _int4_dot(x, q, native=False)
    launches_int4_cast += 1
    return out


def int4_dot_native(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P5. The same product with both operands as s4 in the tensor cores:
    the packed nibbles as they lie. Only x in [-8, 7] fits s4; other x
    raise."""
    if x.device.type == "cpu":
        return int4_dot_plain(x, q)
    global launches_int4_native
    if bool(((x < -8) | (x > 7)).any()):
        raise ValueError("int4_dot_native: x must lie in [-8, 7] to be an s4 operand")
    out = _int4_dot(x, q, native=True)
    launches_int4_native += 1
    return out


def int4_view_shape(q: torch.Tensor) -> torch.Tensor:
    """P7. A byte block [R, N] read through its int4 view → int32 [1, 2]."""
    if q.device.type == "cpu":
        return int4_view_shape_plain(q)
    global launches_int4_view
    _bytes_on_card("int4_view_shape", q)
    if q.dim() != 2:
        raise ValueError(f"int4_view_shape: block {tuple(q.shape)}")
    out = torch.zeros((1, 2), dtype=torch.int32, device=q.device)
    err = _lib().int4_view_launch(q.data_ptr(), q.shape[0], q.shape[1], -8, out.data_ptr(),
                                  _stream(q))
    build.check(err, "int4_view_shape")
    launches_int4_view += 1
    return out
