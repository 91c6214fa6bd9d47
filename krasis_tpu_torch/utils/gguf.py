"""GGUF v2 / v3 reader and block dequantizers (PyTorch).

The port of ``krasis_tpu/utils/gguf.py``: the metadata table, the tensor
infos and the mmap'd data section, and the codecs F32, F16, BF16, Q8_0,
Q4_0, Q5_0, Q4_K, Q5_K and Q6_K (with the K-quants' packed 6-bit scale /
min table). The codecs run on torch tensors on the data's device and take
the reference's operations in its order, each rounded to f32 on its own,
so they give its bits on the CPU and on the card.
"""

from __future__ import annotations

import math
import struct
from typing import Any, Dict, Tuple

import torch

from .safetensors_io import map_file, view

# ggml type ids (public ggml / gguf spec)
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0, GGML_Q8_1 = 8, 9
GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K, GGML_Q8_K = 10, 11, 12, 13, 14, 15
GGML_BF16 = 30

TYPE_NAMES = {
    GGML_F32: "F32", GGML_F16: "F16", GGML_BF16: "BF16",
    GGML_Q4_0: "Q4_0", GGML_Q5_0: "Q5_0", GGML_Q8_0: "Q8_0",
    GGML_Q4_K: "Q4_K", GGML_Q5_K: "Q5_K", GGML_Q6_K: "Q6_K",
}

# (block_elems, block_bytes)
BLOCK_INFO = {
    GGML_F32: (1, 4), GGML_F16: (1, 2), GGML_BF16: (1, 2),
    GGML_Q4_0: (32, 18), GGML_Q5_0: (32, 22), GGML_Q8_0: (32, 34),
    GGML_Q4_K: (256, 144), GGML_Q5_K: (256, 176), GGML_Q6_K: (256, 210),
}

_VT_SCALAR = {
    0: ("<B", 1), 1: ("<b", 1), 2: ("<H", 2), 3: ("<h", 2),
    4: ("<I", 4), 5: ("<i", 4), 6: ("<f", 4), 7: ("<?", 1),
    10: ("<Q", 8), 11: ("<q", 8), 12: ("<d", 8),
}


class GgufFile:
    """A parsed GGUF file; tensors served as raw bytes or dequantized."""

    def __init__(self, path: str):
        self.path = path
        self._mm = map_file(path)
        self._pos = 0
        if self._read(4) != b"GGUF":
            raise ValueError(f"not a GGUF file: {path}")
        self.version = self._u32()
        if self.version < 2:
            raise ValueError(f"unsupported GGUF version {self.version}")
        n_tensors, n_kv = self._u64(), self._u64()
        self.metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = self._string()
            self.metadata[key] = self._value(self._u32())
        self.tensors: Dict[str, Tuple[Tuple[int, ...], int, int]] = {}
        for _ in range(n_tensors):
            name = self._string()
            dims = tuple(self._u64() for _ in range(self._u32()))
            ttype, offset = self._u32(), self._u64()
            # GGUF dims are innermost first; the shape is the reverse
            self.tensors[name] = (tuple(reversed(dims)), ttype, offset)
        align = int(self.metadata.get("general.alignment", 32))
        self._data_start = (self._pos + align - 1) // align * align

    def _read(self, n: int) -> bytes:
        b = self._mm[self._pos:self._pos + n]
        self._pos += n
        return b

    def _u32(self) -> int:
        return struct.unpack("<I", self._read(4))[0]

    def _u64(self) -> int:
        return struct.unpack("<Q", self._read(8))[0]

    def _string(self) -> str:
        return self._read(self._u64()).decode("utf-8", errors="replace")

    def _value(self, vt: int):
        if vt in _VT_SCALAR:
            fmt, size = _VT_SCALAR[vt]
            return struct.unpack(fmt, self._read(size))[0]
        if vt == 8:
            return self._string()
        if vt == 9:
            et, count = self._u32(), self._u64()
            if et in _VT_SCALAR and et != 7:
                fmt, size = _VT_SCALAR[et]
                return list(struct.unpack(f"<{count}{fmt[1:]}", self._read(size * count)))
            return [self._value(et) for _ in range(count)]
        raise ValueError(f"unknown gguf value type {vt}")

    def tensor_type(self, name: str) -> int:
        return self.tensors[name][1]

    def shape(self, name: str) -> Tuple[int, ...]:
        return self.tensors[name][0]

    def raw(self, name: str) -> torch.Tensor:
        """The tensor's bytes, a uint8 view of the mapping."""
        shape, ttype, offset = self.tensors[name]
        be, bb = BLOCK_INFO[ttype]
        nbytes = math.prod(shape) // be * bb
        return view(self._mm, self._data_start + offset, nbytes, torch.uint8, (nbytes,))

    def dequantize(self, name: str, device="cpu") -> torch.Tensor:
        """f32 in the tensor's shape, decoded on `device`."""
        shape, ttype, _ = self.tensors[name]
        out = dequantize_raw(self.raw(name).to(device), ttype, math.prod(shape))
        return out.reshape(shape)

    def close(self):
        self._mm = None     # unmapped once the last view is gone


def _f16(b: torch.Tensor) -> torch.Tensor:
    """[B, 2] little-endian bytes → f32 [B, 1]."""
    return b.contiguous().view(torch.float16).to(torch.float32)


def dequantize_raw(data: torch.Tensor, ttype: int, n_elems: int) -> torch.Tensor:
    """uint8 bytes of `ttype` → the first n_elems values, f32."""
    if ttype in (GGML_F32, GGML_F16, GGML_BF16):
        dt = {GGML_F32: torch.float32, GGML_F16: torch.float16, GGML_BF16: torch.bfloat16}
        return data.view(dt[ttype])[:n_elems].to(torch.float32)
    fn = {GGML_Q8_0: dequant_q8_0, GGML_Q4_0: dequant_q4_0, GGML_Q5_0: dequant_q5_0,
          GGML_Q4_K: dequant_q4_k, GGML_Q5_K: dequant_q5_k, GGML_Q6_K: dequant_q6_k}.get(ttype)
    if fn is None:
        raise ValueError(f"unsupported ggml type {ttype} ({TYPE_NAMES.get(ttype)})")
    return fn(data)[:n_elems]


def dequant_q8_0(data: torch.Tensor) -> torch.Tensor:
    blocks = data.reshape(-1, 34)
    d = _f16(blocks[:, :2])
    q = blocks[:, 2:].contiguous().view(torch.int8).to(torch.float32)
    return (q * d).reshape(-1)


def dequant_q4_0(data: torch.Tensor) -> torch.Tensor:
    blocks = data.reshape(-1, 18)
    d = _f16(blocks[:, :2])
    qs = blocks[:, 2:]
    lo = (qs & 0xF).to(torch.float32) - 8.0          # elements 0..15
    hi = (qs >> 4).to(torch.float32) - 8.0           # elements 16..31
    return (torch.cat([lo, hi], dim=1) * d).reshape(-1)


def dequant_q5_0(data: torch.Tensor) -> torch.Tensor:
    blocks = data.reshape(-1, 22)
    d = _f16(blocks[:, :2])
    b = blocks[:, 2:6].to(torch.int64)
    qh = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    bits = (qh[:, None] >> torch.arange(32, device=data.device)) & 1
    qs = blocks[:, 6:].to(torch.int64)
    lo = (qs & 0xF) | (bits[:, :16] << 4)
    hi = (qs >> 4) | (bits[:, 16:] << 4)
    return ((torch.cat([lo, hi], dim=1).to(torch.float32) - 16.0) * d).reshape(-1)


def _kquant_scale_min(scales12: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 12-byte table of 6-bit (scale, min) pairs of Q4_K / Q5_K →
    (sc [B, 8], m [B, 8])."""
    q = scales12.to(torch.int32)
    sc = [q[:, j] & 63 for j in range(4)]
    m = [q[:, j + 4] & 63 for j in range(4)]
    for j in range(4, 8):
        sc.append((q[:, j + 4] & 0xF) | ((q[:, j - 4] >> 6) << 4))
        m.append((q[:, j + 4] >> 4) | ((q[:, j] >> 6) << 4))
    return torch.stack(sc, dim=1), torch.stack(m, dim=1)


def _kquant_head(blocks: torch.Tensor):
    """(scf, mf) [B, 8]: d·sc and dmin·m of each 32-element sub-block."""
    d, dmin = _f16(blocks[:, 0:2]), _f16(blocks[:, 2:4])
    sc, m = _kquant_scale_min(blocks[:, 4:16])
    return d * sc.to(torch.float32), dmin * m.to(torch.float32)


def dequant_q4_k(data: torch.Tensor) -> torch.Tensor:
    blocks = data.reshape(-1, 144)
    scf, mf = _kquant_head(blocks)
    qs = blocks[:, 16:144].to(torch.int32)
    parts = []
    for j in range(4):                               # 64-element pairs
        qb = qs[:, j * 32:(j + 1) * 32]
        for s, v in ((2 * j, qb & 0xF), (2 * j + 1, qb >> 4)):
            parts.append(v.to(torch.float32) * scf[:, s:s + 1] - mf[:, s:s + 1])
    return torch.cat(parts, dim=1).reshape(-1)


def dequant_q5_k(data: torch.Tensor) -> torch.Tensor:
    blocks = data.reshape(-1, 176)
    scf, mf = _kquant_head(blocks)
    qh = blocks[:, 16:48].to(torch.int32)
    qs = blocks[:, 48:176].to(torch.int32)
    parts = []
    for j in range(4):
        qb = qs[:, j * 32:(j + 1) * 32]
        for s, low, hbit in ((2 * j, qb & 0xF, (qh >> (2 * j)) & 1),
                             (2 * j + 1, qb >> 4, (qh >> (2 * j + 1)) & 1)):
            v = low.to(torch.float32) + hbit.to(torch.float32) * 16.0
            parts.append(v * scf[:, s:s + 1] - mf[:, s:s + 1])
    return torch.cat(parts, dim=1).reshape(-1)


def dequant_q6_k(data: torch.Tensor) -> torch.Tensor:
    blocks = data.reshape(-1, 210)
    ql = blocks[:, :128].to(torch.int32)             # low 4 bits
    qh = blocks[:, 128:192].to(torch.int32)          # high 2 bits
    scales = blocks[:, 192:208].contiguous().view(torch.int8).to(torch.float32)   # [B, 16]
    d = _f16(blocks[:, 208:210])
    halves = []
    for half in range(2):                            # two 128-element halves
        lo = ql[:, half * 64:half * 64 + 64]
        hi = qh[:, half * 32:half * 32 + 32]
        q = torch.cat([(lo[:, :32] & 0xF) | (((hi >> 0) & 3) << 4),
                       (lo[:, 32:] & 0xF) | (((hi >> 2) & 3) << 4),
                       (lo[:, :32] >> 4) | (((hi >> 4) & 3) << 4),
                       (lo[:, 32:] >> 4) | (((hi >> 6) & 3) << 4)], dim=1) - 32
        sc = scales[:, half * 8:half * 8 + 8].repeat_interleave(16, dim=1)
        halves.append(q.to(torch.float32) * sc)
    return (torch.cat(halves, dim=1) * d).reshape(-1)
