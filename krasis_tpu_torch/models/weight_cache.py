"""Mmap-able quantized-weight disk cache, format version 2 (PyTorch).

The port of ``krasis_tpu/models/weight_cache.py``, byte for byte the same
format: one binary file per parameter group (``head``, ``prefix_NN``,
``pattern_NN``, ``mtp``) with 64-byte aligned leaf regions, and a JSON
index ``meta.json`` of (group, offset, shape, dtype[, bits, group_size])
per flat leaf key (``head/embed``, ``prefix/0/o_proj``,
``pattern/1/w13.q``; a QTensor is split into ``.q`` and ``.scales``).

* The build streams: stacked expert regions are reserved first and
  written one expert at a time (``write_at``), so a build holds about two
  expert tensors at once, never a layer's stack. It writes into
  ``<dir>.tmp`` and publishes the directory with ``os.replace``.
* Reads are torch views of a private mapping of each group file: a hit
  costs page-in and the copy to the device, not a parse, and any expert of
  a stacked leaf can be read alone.
* ``BuildLock`` (pid and time in a lock file) serialises concurrent
  builds: the loser waits for the winner's cache.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import time
from typing import Any, Dict, Iterator, Tuple

import torch

from ..quant import QTensor
from ..utils.safetensors_io import map_file, view

FORMAT_VERSION = 2
ALIGN = 64

DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "int32": torch.int32,
    "uint8": torch.uint8,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def _dtype_name(dt: torch.dtype) -> str:
    if dt not in _NAMES:
        raise ValueError(f"unsupported cache dtype {dt}")
    return _NAMES[dt]


def _bytes(t: torch.Tensor) -> memoryview:
    return memoryview(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy())


class CacheWriter:
    """Builds a cache directory atomically (writes `<dir>.tmp`, publishes
    it with os.replace in finalize)."""

    def __init__(self, path: str):
        self.path = path
        self.tmp = path + ".tmp"
        os.makedirs(self.tmp, exist_ok=True)
        self.index: Dict[str, Dict[str, Any]] = {}
        self.meta: Dict[str, Any] = {}
        self._sizes: Dict[str, int] = {}

    def _group_path(self, group: str) -> str:
        return os.path.join(self.tmp, f"{group}.bin")

    def alloc(self, key: str, group: str, shape, dtype: torch.dtype, **extra) -> str:
        """Reserve an aligned region for `key`; fill it with write_at."""
        if key in self.index:
            raise ValueError(f"duplicate cache key {key}")
        off = (self._sizes.get(group, 0) + ALIGN - 1) // ALIGN * ALIGN
        nbytes = math.prod(shape) * dtype.itemsize
        self._sizes[group] = off + nbytes
        with open(self._group_path(group), "ab") as f:
            f.truncate(off + nbytes)
        self.index[key] = dict(group=group, offset=off, shape=[int(s) for s in shape],
                               dtype=_dtype_name(dtype), **extra)
        return key

    def write_at(self, key: str, idx: Tuple[int, ...], t: torch.Tensor):
        """Write `t` (any device) into the region at leading indices `idx`."""
        e = self.index[key]
        shape, dt = e["shape"], DTYPES[e["dtype"]]
        if list(t.shape) != shape[len(idx):]:
            raise ValueError(f"{key}{list(idx)}: shape {list(t.shape)}, "
                             f"region wants {shape[len(idx):]}")
        flat = 0
        for i, n in zip(idx, shape):
            flat = flat * n + i
        start = e["offset"] + flat * math.prod(shape[len(idx):]) * dt.itemsize
        with open(self._group_path(e["group"]), "r+b") as f:
            f.seek(start)
            f.write(_bytes(t.to(dt)))

    def add(self, key: str, group: str, t: torch.Tensor, **extra):
        self.alloc(key, group, t.shape, t.dtype, **extra)
        self.write_at(key, (), t)

    def add_leaf(self, key: str, group: str, leaf):
        """Store a tensor or QTensor under `key`."""
        if isinstance(leaf, QTensor):
            for part in ("q", "scales"):
                self.add(f"{key}.{part}", group, getattr(leaf, part),
                         bits=leaf.bits, group_size=leaf.group_size)
        else:
            self.add(key, group, leaf)

    def alloc_qtensor(self, key: str, group: str, q_shape, scales_shape,
                      bits: int, group_size: int):
        self.alloc(f"{key}.q", group, q_shape, torch.int8, bits=bits, group_size=group_size)
        self.alloc(f"{key}.scales", group, scales_shape, torch.bfloat16,
                   bits=bits, group_size=group_size)

    def finalize(self, **meta):
        self.meta = dict(version=FORMAT_VERSION, index=self.index, **meta)
        with open(os.path.join(self.tmp, "meta.json"), "w") as f:
            json.dump(self.meta, f)
        if os.path.exists(self.path):
            shutil.rmtree(self.path)
        os.replace(self.tmp, self.path)

    def abort(self):
        shutil.rmtree(self.tmp, ignore_errors=True)


class CacheReader:
    """Zero-copy reads from a finalized cache directory."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta.get("version") != FORMAT_VERSION:
            raise ValueError(f"cache version {self.meta.get('version')} != {FORMAT_VERSION}")
        self.index: Dict[str, Dict[str, Any]] = self.meta["index"]
        self._maps: Dict[str, Any] = {}

    def get(self, key: str) -> torch.Tensor:
        """A CPU view of the key's region."""
        e = self.index[key]
        if e["group"] not in self._maps:
            self._maps[e["group"]] = map_file(os.path.join(self.path, f"{e['group']}.bin"))
        dt, shape = DTYPES[e["dtype"]], tuple(e["shape"])
        return view(self._maps[e["group"]], e["offset"], math.prod(shape) * dt.itemsize,
                    dt, shape)

    def get_leaf(self, key: str):
        """Tensor, or QTensor when `key.q` exists."""
        if f"{key}.q" in self.index:
            e = self.index[f"{key}.q"]
            return QTensor(self.get(f"{key}.q"), self.get(f"{key}.scales"),
                           e["bits"], e["group_size"])
        return self.get(key)

    def leaf_keys(self) -> Iterator[str]:
        seen = set()
        for k in self.index:
            base = k[:-2] if k.endswith(".q") else (k[:-7] if k.endswith(".scales") else k)
            if base not in seen:
                seen.add(base)
                yield base

    def as_pytree(self) -> Dict[str, Any]:
        """The reference's tree (``prefix_layers``, ``pattern`` with a
        leading reps dim, head leaves, ``mtp``) of mmap-backed leaves."""
        params: Dict[str, Any] = {
            "prefix_layers": [{} for _ in range(self.meta["n_prefix"])],
            "pattern": [{} for _ in range(self.meta["n_pattern"])],
        }
        for base in self.leaf_keys():
            parts = base.split("/")
            leaf = self.get_leaf(base)
            if parts[0] == "head":
                params[parts[1]] = leaf
            elif parts[0] == "prefix":
                params["prefix_layers"][int(parts[1])][parts[2]] = leaf
            elif parts[0] == "pattern":
                params["pattern"][int(parts[1])][parts[2]] = leaf
            elif parts[0] == "mtp":
                mtp = params.setdefault("mtp", {})
                if parts[1] == "layer":
                    mtp.setdefault("layer", {})[parts[2]] = leaf
                else:
                    mtp[parts[1]] = leaf
            else:
                raise ValueError(f"unknown cache key {base}")
        return params


_LOCK_STALE_S = 1800.0


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True       # exists, owned by someone else
    except OSError:
        return False
    return True


class BuildLock:
    """Exclusive cache-build lock: the losing process waits for the
    winner's finalized cache instead of quantizing the checkpoint again."""

    def __init__(self, cache_path: str):
        self.lockfile = cache_path + ".lock"
        self.cache_path = cache_path
        self.acquired = False

    def acquire(self, poll_s: float = 2.0, timeout_s: float = 7200.0) -> str:
        """'acquired' (the caller builds, then releases) or 'built' (another
        process finished the cache while this one waited). A lock whose pid
        is dead, or that is older than 30 minutes, is stolen."""
        deadline = time.time() + timeout_s
        while True:
            try:
                fd = os.open(self.lockfile, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, f"{os.getpid()} {time.time()}".encode())
                os.close(fd)
                self.acquired = True
                return "acquired"
            except FileExistsError:
                pass
            try:
                with open(self.lockfile) as f:
                    pid_s, t_s = f.read().split()
                stale = (time.time() - float(t_s) > _LOCK_STALE_S
                         or not _pid_alive(int(pid_s)))
            except (OSError, ValueError):
                stale = True
            if stale:
                try:
                    os.unlink(self.lockfile)
                except OSError:
                    pass
                continue
            if os.path.exists(os.path.join(self.cache_path, "meta.json")):
                return "built"
            if time.time() > deadline:
                raise TimeoutError(f"cache build lock {self.lockfile} held too long")
            time.sleep(poll_s)

    def release(self):
        if self.acquired:
            try:
                os.unlink(self.lockfile)
            except OSError:
                pass
            self.acquired = False

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()
