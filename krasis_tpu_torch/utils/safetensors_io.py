"""Zero-copy safetensors reader and a minimal writer (PyTorch).

The port of ``krasis_tpu/utils/safetensors_io.py``: the JSON header is
parsed once and tensors are served as torch views of a private (copy on
write) mapping of the file, so reading a shard costs page-cache traffic,
not a parse. bf16 and fp8 e4m3 come back as ``torch.bfloat16`` and
``torch.float8_e4m3fn``. A view keeps the mapping alive after ``close``.
The writer takes torch tensors, so checkpoints can be written without the
``safetensors`` package.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterator, List, Tuple

import torch

DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "U16": torch.uint16,
    "U32": torch.uint32,
    "BOOL": torch.bool,
}
NAMES = {v: k for k, v in DTYPES.items()}


def map_file(path: str) -> mmap.mmap:
    """A private mapping of the whole file: writable as a buffer (so torch
    takes views of it without a copy or a warning), never written back."""
    with open(path, "rb") as f:
        return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)


def view(mm: mmap.mmap, offset: int, nbytes: int, dtype: torch.dtype,
         shape: Tuple[int, ...]) -> torch.Tensor:
    """`nbytes` bytes of `mm` at `offset` as a tensor, without a copy."""
    if nbytes == 0:
        return torch.empty(shape, dtype=dtype)
    raw = torch.frombuffer(mm, dtype=torch.uint8, count=nbytes, offset=offset)
    return raw.view(dtype).reshape(shape)


class SafetensorsFile:
    """One shard, mmap-backed."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (hlen,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(hlen))
        self._meta = header.pop("__metadata__", {})
        self._data_offset = 8 + hlen
        self._mm = map_file(path)
        self._infos: Dict[str, Tuple[torch.dtype, Tuple[int, ...], int, int]] = {}
        for name, info in header.items():
            b0, b1 = info["data_offsets"]
            self._infos[name] = (DTYPES[info["dtype"]], tuple(info["shape"]), b0, b1)

    def keys(self) -> List[str]:
        return list(self._infos)

    def __contains__(self, name: str) -> bool:
        return name in self._infos

    def shape(self, name: str) -> Tuple[int, ...]:
        return self._infos[name][1]

    def dtype(self, name: str) -> torch.dtype:
        return self._infos[name][0]

    def tensor(self, name: str) -> torch.Tensor:
        """A CPU view of the mapping."""
        dt, shape, b0, b1 = self._infos[name]
        return view(self._mm, self._data_offset + b0, b1 - b0, dt, shape)

    def close(self):
        self._mm = None     # unmapped once the last view is gone


class ShardedSafetensors:
    """A checkpoint directory: the index routes each name to its shard,
    opened on first use."""

    def __init__(self, model_path: str):
        self.model_path = model_path
        index_path = os.path.join(model_path, "model.safetensors.index.json")
        self._files: Dict[str, SafetensorsFile] = {}
        if os.path.exists(index_path):
            with open(index_path) as f:
                self.weight_map: Dict[str, str] = json.load(f)["weight_map"]
        else:
            st = self._open("model.safetensors")
            self.weight_map = {k: "model.safetensors" for k in st.keys()}

    def _open(self, shard: str) -> SafetensorsFile:
        if shard not in self._files:
            self._files[shard] = SafetensorsFile(os.path.join(self.model_path, shard))
        return self._files[shard]

    def keys(self) -> List[str]:
        return list(self.weight_map)

    def __contains__(self, name: str) -> bool:
        return name in self.weight_map

    def shape(self, name: str) -> Tuple[int, ...]:
        return self._open(self.weight_map[name]).shape(name)

    def dtype(self, name: str) -> torch.dtype:
        return self._open(self.weight_map[name]).dtype(name)

    def tensor(self, name: str) -> torch.Tensor:
        return self._open(self.weight_map[name]).tensor(name)

    def items(self) -> Iterator[Tuple[str, torch.Tensor]]:
        for name in self.weight_map:
            yield name, self.tensor(name)

    def close(self):
        for f in self._files.values():
            f.close()
        self._files.clear()


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]):
    """Write `tensors` (any device) as one safetensors file, in order."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    hjson = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for t in tensors.values():
            if t.numel():
                raw = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
                f.write(memoryview(raw.numpy()))
