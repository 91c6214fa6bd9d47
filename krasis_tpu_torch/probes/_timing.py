"""What the probes share: their options, their timing on the card and their
report. The counterpart of ``benchmarks/_timing.py``, whose relay-readback
correction means nothing on the card: times are CUDA events and profiler
device time (``krasis_tpu_torch.timing``).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from ..timing import device_per_call, timeit_ms

OUT_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "probes"
ITERS = 30              # launches timed a kernel


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def report(name: str, results: dict, dev: torch.device, out=None) -> None:
    """Print the results as one JSON line and write them to
    build/probes/<name>.json, or to `out`."""
    record = {"probe": name, "device": device_name(dev), **results}
    path = Path(out) if out else OUT_DIR / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps(record), flush=True)


def time_on(dev: torch.device, fn, n: int = ITERS, flush=None, kernel=None):
    """(ms, device us) of a call of fn: timeit_ms on the card and, when
    `kernel` names the call's kernels (as for device_per_call), the device
    time a call from the profiler, else None. On the CPU fn runs once and
    both are None (not measured): a host clock is no device time."""
    if dev.type != "cuda":
        fn()
        return None, None
    ms = timeit_ms(fn, n, flush)
    return ms, None if kernel is None else device_per_call(fn, kernel, flush, calls=10)[0]


def arguments(description: str):
    """The probes' common options."""
    import argparse

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="the card (default) or cpu, which runs the plain versions")
    ap.add_argument("--small", action="store_true",
                    help="tiny shapes, for a run of the plain versions on the CPU")
    ap.add_argument("--out", default=None, help="JSON file (default build/probes/<name>.json)")
    return ap
