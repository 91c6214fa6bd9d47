"""Host C++ code of the port, built with g++ at first use.

``load_hostmoe`` builds and binds the offload tier's host expert engine
(``hostmoe.cpp``); a failed build raises.

``build_library`` compiles one source into ``lib<name>.so`` under the
port's ignored build directory (``build/krasis_tpu_torch`` at the
repository root, ``krasis_tpu_torch/build.py``) and loads it. Processes
and threads may build at once: each holds an ``fcntl`` lock on the build
directory while it checks and builds, compiles to a name of its own and
moves the library into place with ``os.replace``, so a reader never sees
a half-written file.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

from ..build import BUILD_DIR

_thread_lock = threading.Lock()


def build_library(src: Path, name: str, flags: Sequence[str],
                  build_dir: Optional[Path] = None, timeout: float = 180.0) -> ctypes.CDLL:
    """``lib<name>.so`` built from `src` with ``g++ <flags>`` when missing or
    older than the source, then loaded. Raises when g++ fails."""
    d = Path(build_dir or BUILD_DIR)
    d.mkdir(parents=True, exist_ok=True)
    so = d / f"lib{name}.so"
    with _thread_lock:
        fd = os.open(d, os.O_RDONLY)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            if not so.exists() or so.stat().st_mtime < Path(src).stat().st_mtime:
                tmp = d / f"lib{name}.so.{os.getpid()}.tmp"
                try:
                    subprocess.run(["g++", *flags, str(src), "-o", str(tmp)], check=True,
                                   capture_output=True, timeout=timeout)
                    os.replace(tmp, so)
                finally:
                    if tmp.exists():
                        tmp.unlink()
            return ctypes.CDLL(str(so))
        finally:
            os.close(fd)            # releases the lock


def build_error(exc: BaseException) -> str:
    """One line on why a build failed, with the compiler's last words."""
    if isinstance(exc, subprocess.CalledProcessError):
        err = (exc.stderr or b"").decode("utf-8", "replace").strip()
        return f"g++ failed: {err[-2000:]}" if err else "g++ failed"
    if isinstance(exc, FileNotFoundError):
        return f"{exc} (is g++ installed and on PATH?)"
    return repr(exc)


HOSTMOE_SRC = Path(__file__).resolve().parent / "hostmoe.cpp"
HOSTMOE_FLAGS = ("-O3", "-march=native", "-fopenmp", "-std=c++17", "-shared", "-fPIC")
_hostmoe: Optional[ctypes.CDLL] = None


def load_hostmoe() -> ctypes.CDLL:
    """The host expert engine (``libkrasis_hostmoe.so``), built on first use
    with the reference's flags and its six C entry points bound. Raises
    when the build fails: the offload tier has no silent fallback."""
    global _hostmoe
    if _hostmoe is not None:
        return _hostmoe
    try:
        lib = build_library(HOSTMOE_SRC, "krasis_hostmoe", HOSTMOE_FLAGS)
    except Exception as exc:
        raise RuntimeError("the host expert engine (native/hostmoe.cpp) did not build: "
                           + build_error(exc)) from exc
    c_void_p, c_int, c_int64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.krasish_create.restype = c_void_p
    lib.krasish_create.argtypes = [c_int64, c_int64, c_int64, c_int64, c_int, c_int, c_int,
                                   c_int, ctypes.c_float, c_int]
    lib.krasish_set_layer.restype = c_int
    lib.krasish_set_layer.argtypes = [c_void_p, c_int64] + [c_void_p] * 6
    lib.krasish_forward.restype = c_int
    lib.krasish_forward.argtypes = [c_void_p, c_int64, c_int64, c_int64] + [c_void_p] * 4
    lib.krasish_destroy.restype = None
    lib.krasish_destroy.argtypes = [c_void_p]
    lib.krasish_tier.restype = c_int
    lib.krasish_tier.argtypes = [c_void_p]
    lib.krasish_threads.restype = c_int
    lib.krasish_threads.argtypes = [c_void_p]
    _hostmoe = lib
    return lib
