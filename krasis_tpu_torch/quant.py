"""Weight-only quantization: symmetric group-wise INT4 / INT8 (PyTorch).

Storage is bit-identical to ``krasis_tpu.quant``:

* weights in math orientation ``[K, N]`` (forward is ``x[M,K] @ w[K,N]``);
* INT8 stored ``[K, N]``;
* INT4 split-half packed ``[K/2, N]``: byte ``[r, n]`` holds element
  ``(r, n)`` in its low nibble and ``(r + K/2, n)`` in its high nibble,
  each sign-extended with ``((b & 0xF) ^ 8) - 8``;
* scales bf16 ``[K/gs, N]``, one per (K-group, column); quantization uses
  the bf16-rounded scale.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class QTensor:
    """q: int8 ``[..., K, N]`` (int8) or ``[..., K/2, N]`` (packed int4);
    scales: bf16 ``[..., K/gs, N]``. Leading dims stack layers
    (``[L, K(/2), N]`` projections) or experts (``[E, K(/2), N]``);
    ``k_dim``, ``n_dim``, indexing and ``dequantize`` read the last two."""

    q: torch.Tensor
    scales: torch.Tensor
    bits: int
    group_size: int

    @property
    def k_dim(self) -> int:
        k = self.q.shape[-2]
        return k * 2 if self.bits == 4 else k

    @property
    def n_dim(self) -> int:
        return self.q.shape[-1]

    def __getitem__(self, idx) -> "QTensor":
        """Index the leading (layer / expert) dims: a view, no copy."""
        return QTensor(self.q[idx], self.scales[idx], self.bits, self.group_size)

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scales.to(device),
                       self.bits, self.group_size)


def pick_group_size(K: int, group_size: int) -> int:
    """Largest divisor of K that is <= group_size (halving), else K."""
    g = group_size
    while g >= 16 and K % g:
        g //= 2
    return g if (g >= 16 and K % g == 0) else K


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Split-half pack int8-held values in [-8, 7]: [..., K, N] → [..., K/2, N]."""
    half = q.shape[-2] // 2
    lo = q[..., :half, :].to(torch.int16) & 0xF
    hi = (q[..., half:, :].to(torch.int16) & 0xF) << 4
    return (lo | hi).to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., K/2, N] int8 → [..., K, N] int8 in [-8, 7]."""
    b = packed.view(torch.uint8).to(torch.int16)
    lo = ((b & 0xF) ^ 8) - 8
    hi = ((b >> 4) ^ 8) - 8
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def unpack(qt: QTensor) -> torch.Tensor:
    """Integer weights [..., K, N] int8, no scaling."""
    return unpack_int4(qt.q) if qt.bits == 4 else qt.q


def dequantize(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """[..., K, N] in `dtype`: multiply in f32, one rounding at the end."""
    q = unpack(qt)
    *lead, K, N = q.shape
    gs = qt.group_size
    w = q.to(torch.float32).reshape(*lead, K // gs, gs, N)
    w = w * qt.scales.to(torch.float32).unsqueeze(-2)
    return w.reshape(*lead, K, N).to(dtype)


def quantize(w: torch.Tensor, bits: int, group_size: int = 128) -> QTensor:
    """Same numerics as ``krasis_tpu.quant.quantize_np``: bf16 scale
    ``amax/qmax`` (1 for an all-zero group), round half to even, clip. qmax
    is a 0-dim tensor on w's device: PyTorch's CUDA division by a Python
    number multiplies by its reciprocal, which can round a quotient one
    bit off the IEEE division the reference takes."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    *lead, K, N = w.shape
    group_size = pick_group_size(K, group_size)
    g = w.to(torch.float32).reshape(*lead, K // group_size, group_size, N)
    amax = g.abs().amax(dim=-2, keepdim=True)
    qmax = torch.full((), 7.0 if bits == 4 else 127.0, device=w.device)
    scale = torch.where(amax == 0.0, torch.ones_like(amax), amax / qmax)
    scale = scale.to(torch.bfloat16)
    inv = 1.0 / scale.to(torch.float32)
    lo, hi = (-8, 7) if bits == 4 else (-128, 127)
    q = torch.clamp(torch.round(g * inv), lo, hi).to(torch.int8)
    q = q.reshape(*lead, K, N)
    if bits == 4:
        q = pack_int4(q)
    return QTensor(q, scale.squeeze(-2), bits, group_size)


# e2m1 codes: the sign is the nibble's high bit
FP4_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
              -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0)


def e8m0_pow2(e: torch.Tensor) -> torch.Tensor:
    """2^(e - 127) in f32 for uint8 exponents, as the reference computes it:
    numpy's f32 exp2, on the host, looked up on e's device. That function
    is not exact everywhere (2^127 comes out one ulp high, and 255 gives
    inf); a power of two built from the bits would differ there."""
    with np.errstate(over="ignore"):
        table = np.exp2(np.arange(-127, 129, dtype=np.int32).astype(np.float32))
    return torch.from_numpy(table).to(e.device)[e.to(torch.int64)]


def dequant_mxfp4(blocks: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """MXFP4 (GPT-OSS's experts) → f32 [..., G·2B], the bits of
    ``krasis_tpu.quant.dequant_mxfp4_np``. blocks uint8 [..., G, B] hold two
    e2m1 codes a byte, the low nibble first (out[0::2] low, out[1::2]
    high); scales uint8 [..., G] are e8m0 exponents (bias 127)."""
    *lead, G, B = blocks.shape
    table = torch.tensor(FP4_VALUES, dtype=torch.float32, device=blocks.device)
    b = blocks.to(torch.int64)
    out = torch.stack([table[b & 0xF], table[b >> 4]], dim=-1).reshape(*lead, G, 2 * B)
    out = out * e8m0_pow2(scales)[..., None]
    return out.reshape(*lead, G * 2 * B)


def dequant_compressed_int4(packed: torch.Tensor, scale: torch.Tensor,
                            group_size: int) -> torch.Tensor:
    """compressed-tensors "pack-quantized" symmetric int4 → f32 [out, in],
    the bits of ``krasis_tpu.quant.dequant_compressed_int4_np``: packed
    int32 [out, in/8] holds column w·8 + i in nibble i of word w (two's
    complement), scale [out, in/gs] one per input group."""
    out_dim, words = packed.shape
    p = packed.to(torch.int32)
    nib = torch.stack([(p >> (4 * i)) & 0xF for i in range(8)], dim=-1)
    q = ((nib ^ 8) - 8).reshape(out_dim, words * 8)
    w = q.to(torch.float32).reshape(out_dim, -1, group_size)
    w = w * scale.to(torch.float32)[:, :, None]
    return w.reshape(out_dim, words * 8)


def dequant_fp8_block(w8: torch.Tensor, scale_inv: torch.Tensor,
                      block: int = 128) -> torch.Tensor:
    """DeepSeek-V3 fp8 block quantization → f32 [out, in], the bits of
    ``krasis_tpu.quant.dequant_fp8_block_np``: e4m3 w8 [out, in] times
    scale_inv [ceil(out/B), ceil(in/B)], one scale a B x B block."""
    out_dim, in_dim = w8.shape
    s = scale_inv.to(torch.float32)
    s = s.repeat_interleave(block, dim=0)[:out_dim].repeat_interleave(block, dim=1)[:, :in_dim]
    return w8.to(torch.float32) * s


def random_qtensor(
    shape: Tuple[int, ...],
    bits: int,
    group_size: int,
    generator: torch.Generator,
    device: torch.device,
    scale_mag: float = 0.02,
) -> QTensor:
    """A random tensor made directly in quantized form (synthetic weights):
    uniform random bytes and scales uniform in scale_mag·[0.5, 1.5)."""
    *lead, K, N = shape
    group_size = pick_group_size(K, group_size)
    rows = K // 2 if bits == 4 else K
    q = torch.randint(-128, 128, (*lead, rows, N), generator=generator,
                      device=device, dtype=torch.int8)
    u = torch.rand((*lead, K // group_size, N), generator=generator,
                   device=device, dtype=torch.float32)
    scales = (scale_mag * (0.5 + u)).to(torch.bfloat16)
    return QTensor(q, scales, bits, group_size)


def slice_n(qt: QTensor, start: int, size: int) -> QTensor:
    """Bit-exact column slice."""
    return QTensor(qt.q[..., :, start:start + size],
                   qt.scales[..., :, start:start + size],
                   qt.bits, qt.group_size)


def slice_k(qt: QTensor, start: int, size: int) -> QTensor:
    """Bit-exact group-aligned K (row) slice; packed int4 re-pairs nibbles
    so the slice holds the same values in its own split-half layout."""
    gs = qt.group_size
    if start % gs or size % gs:
        raise ValueError(f"K slice [{start}, {start + size}) not aligned to {gs}")
    scales = qt.scales[..., start // gs:(start + size) // gs, :]
    if qt.bits != 4:
        return QTensor(qt.q[..., start:start + size, :], scales, qt.bits, gs)
    rows = unpack_int4(qt.q)[..., start:start + size, :]
    return QTensor(pack_int4(rows), scales, qt.bits, gs)


def cat_leading(parts, dim: int) -> QTensor:
    """Concatenate QTensors along a leading (expert / column) dim."""
    return QTensor(torch.cat([p.q for p in parts], dim=dim),
                   torch.cat([p.scales for p in parts], dim=dim),
                   parts[0].bits, parts[0].group_size)


def stack_leading(parts, dim: int) -> QTensor:
    return QTensor(torch.stack([p.q for p in parts], dim=dim),
                   torch.stack([p.scales for p in parts], dim=dim),
                   parts[0].bits, parts[0].group_size)


def qtensor_bytes(qt: Optional[QTensor]) -> int:
    if qt is None:
        return 0
    return qt.q.numel() * qt.q.element_size() + qt.scales.numel() * 2
