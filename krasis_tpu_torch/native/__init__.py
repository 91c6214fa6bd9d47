"""Host C++ code of the port, built with g++ at first use.

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
