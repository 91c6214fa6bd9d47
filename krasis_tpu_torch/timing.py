"""Kernel times on the card, for chip_smoke.py and the probes, and the
reference's timing and diagnostics flags.

``timeit_ms`` is the median of CUDA-event times around single launches
after a warm-up, with a buffer rewritten before each launch when the launch
must find the 50 MB L2 cache cold. ``device_per_call`` is device time a
call from ``torch.profiler``.

``TIMING`` holds the diagnostics flag of ``krasis_tpu/timing.py``, read
from the environment at import, off by default:
  KRASIS_TPU_DIAG=1 — per-layer activation RMS diagnostics, printed by the
  layer step (``models/model.py``)
"""

from __future__ import annotations

import os

import torch


class _Timing:
    def __init__(self):
        self.diag = os.environ.get("KRASIS_TPU_DIAG", "") == "1"


TIMING = _Timing()

# After large profiles earlier in a process, the tracer on the card leaves
# out the first kernel records of a recorded profiler step: none at first,
# later a few, at times all of a short profile. The kernels it keeps carry
# the right times, and neither idle time nor a host pause at the head of the
# step brings the lost ones back. So each recorded step opens with this
# many throwaway launches (ATen's `spin_kernel`), which take the loss.
HEAD_LAUNCHES = 256
head_kept = 0     # throwaway launches the tracer kept, since the caller last set it to 0
head_made = 0     # and made


def flush_buffer(dev: torch.device):
    """A 256 MB buffer rewritten before a launch that must find L2 cold;
    None off the card."""
    return torch.empty(256 << 20, dtype=torch.uint8, device=dev) if dev.type == "cuda" else None


def timeit_ms(fn, n: int = 30, flush=None) -> float:
    """Milliseconds a call of fn on the card: the median of CUDA-event
    times around each of n calls, after two calls of warm-up; `flush` (a
    large buffer) is rewritten before each call."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def recorded_step(prof) -> None:
    """Close the profiler's warm-up step and open the recorded one with
    HEAD_LAUNCHES throwaway launches."""
    torch.cuda.synchronize()
    prof.step()
    for _ in range(HEAD_LAUNCHES):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def traced_kernels(prof) -> list:
    """The device kernels of a profile opened by recorded_step, as (name,
    device us, count), without the step markers and the throwaway
    launches, which are counted into head_kept / head_made."""
    global head_kept, head_made
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key.startswith("ProfilerStep"):
            continue
        if "spin_kernel" in e.key:
            head_kept += e.count
        else:
            rows.append((e.key, e.self_device_time_total, e.count))
    head_made += HEAD_LAUNCHES
    return rows


def device_per_call(fn, name_part, flush=None, calls: int = 20, tries: int = 8):
    """Device time of one call, from torch.profiler: for each kernel whose
    name contains `name_part` (a string, or a tuple of strings of which one
    must occur), its mean device time a launch over `calls` calls (with
    `flush` rewritten before each, as for the event times) times its
    launches a call; and the number of device kernels one call launches,
    from a second profile of `calls` calls with nothing between them. Each
    profile records its second step (the first warms the tracer up), opened
    by ``recorded_step``. A profile that does not hold a whole
    number of launches a call is taken again, up to `tries` times, and
    otherwise the one that saw the most launches is used, its counts a call
    rounded. Returns (us, kernels a call, whether both profiles were
    whole); raises if no `name_part` launch was seen at all."""
    from torch.profiler import ProfilerActivity, profile, schedule

    parts = (name_part,) if isinstance(name_part, str) else tuple(name_part)

    def named(key):
        return any(p in key for p in parts)

    def rows(between):
        best = []
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                         schedule=schedule(wait=0, warmup=1, active=1)) as prof:
                for _ in range(calls):
                    between()
                    fn()
                recorded_step(prof)
                for _ in range(calls):
                    between()
                    fn()
                torch.cuda.synchronize()
                prof.step()
            got = traced_kernels(prof)
            hits = sum(n for key, _, n in got if named(key))
            if hits > 0 and hits % calls == 0 and sum(n for _, _, n in got) % calls == 0:
                return got, True
            print(f"[profiler] {calls} calls of {name_part}: saw "
                  f"{[(key[:60], n) for key, _, n in got]}; taken again", flush=True)
            if sum(n for _, _, n in got) > sum(n for _, _, n in best):
                best = got
        return best, False

    fn()
    torch.cuda.synchronize()
    timed, whole_timed = rows(flush.zero_ if flush is not None else (lambda: None))
    counted, whole_counted = rows(lambda: None)
    seen = {}
    for key, us, n in timed:
        if named(key):
            t, c = seen.get(key, (0.0, 0))
            seen[key] = (t + us, c + n)
    if not seen:
        raise AssertionError(f"the profiler never saw a launch of {name_part}")
    per_call = {key: n for key, _, n in counted if named(key)}
    us = sum(t / c * max(1, round(per_call.get(key, calls) / calls))
             for key, (t, c) in seen.items())
    return (us, round(sum(n for _, _, n in counted) / calls), whole_timed and whole_counted)
