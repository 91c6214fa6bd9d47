"""Profiling and tracing hooks, the port of ``krasis_tpu/tracing.py``.

* ``capture_trace(out_dir)`` — context manager around ``torch.profiler``
  (CPU and, on the card, CUDA activity) that writes a Chrome trace
  (``trace.json``, loadable in Perfetto) into `out_dir`. On the card the
  tracer can lose the first kernel records of a recording
  (``timing.HEAD_LAUNCHES``), so the recording opens with that many
  throwaway launches, which take the loss.
* ``annotate(name)`` — a named region (``torch.profiler.record_function``),
  so that engine phases (prefill / decode / sample) show in the trace.
* ``phase_timer`` — wall-clock phase logger, for when profiling is too
  heavy.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

from .timing import HEAD_LAUNCHES

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def capture_trace(out_dir: str) -> Iterator[None]:
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        if cuda:
            for _ in range(HEAD_LAUNCHES):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(out_dir, TRACE_NAME))


def annotate(name: str):
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def phase_timer(name: str, enabled: bool = True) -> Iterator[None]:
    if not enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        print(f"[timing] {name}: {(time.perf_counter() - t0) * 1e3:.2f} ms")
