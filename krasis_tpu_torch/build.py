"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/krasis_tpu_torch/
lib<name>.so`` at the repository root, at first use. The sources are
built in parallel (one ``nvcc`` each; the longest, named in ``PARTS``, as
that many parts, ``-DKRASIS_PART=i``, linked into the one library) and
rebuilt when a source or the shared header is newer than the library. A
failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "krasis_tpu_torch"
KERNELS = ("qmm", "attention", "moe_w4a8", "gmm", "probes")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
# sources compiled as parts in parallel: each holds about half the template
# instances of the source (its IN_PART blocks), so the build takes about as
# long as the next-longest source
PARTS = {"qmm": 2, "moe_w4a8": 2}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _stale(name: str) -> bool:
    lib = BUILD_DIR / f"lib{name}.so"
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in
                 [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return newest > lib.stat().st_mtime


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile the stale kernels, all nvcc processes started together.
    Returns {name: compiler output} for the sources that were built."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.so.{os.getpid()}.tmp"
        base = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC)]
        if n in PARTS:
            outs = [BUILD_DIR / f"{n}.{i}.{os.getpid()}.o" for i in range(PARTS[n])]
            cmds = [[*(f for f in base if f != "-shared"), "-c", f"-DKRASIS_PART={i}",
                     "-o", str(o), str(CSRC / f"{n}.cu")] for i, o in enumerate(outs)]
        else:
            outs = []
            cmds = [[*base, "-o", str(tmp), str(CSRC / f"{n}.cu")]]
        procs[n] = (tmp, outs, [subprocess.Popen(c, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)
                                for c in cmds])
    logs, failed = {}, []
    for n, (tmp, outs, ps) in procs.items():
        logs[n] = "".join(p.communicate()[0] for p in ps)
        ok = all(p.returncode == 0 for p in ps)
        if ok and outs:
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, outs)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs[n] += link.stdout
            ok = link.returncode == 0
        for o in outs:
            o.unlink(missing_ok=True)
        if not ok:
            failed.append(n)
        else:
            os.replace(tmp, BUILD_DIR / f"lib{n}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
