"""Startup environment checks, the port of ``krasis_tpu/syscheck.py``.

Reports: torch and its CUDA build, the cards with their memory, host RAM,
CPU count, native-quantizer availability, and a model-fit check against
the budget model (``budget.py``). The card's memory is read through
``budget.card_memory``; off the card there is none to report, and the fit
check is skipped. The RAM watchdog (``start_ram_watchdog``) is the reference's thread.
"""

from __future__ import annotations

import os
from typing import Dict

HEADROOM = 0.92      # of the device memory (and of host RAM) a fit may use


def _host_mem_gb() -> float:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) / (1 << 20)
    except OSError:
        pass
    return 0.0


def host_report() -> Dict:
    """Host-side hardware summary (the launcher's hardware screen)."""
    return {
        "cpus": os.cpu_count() or 0,
        "ram_gb": round(_host_mem_gb(), 1),
    }


def device_report() -> Dict:
    """torch and the cards: each card's name, memory and the bytes torch
    holds on it; without a card, the CPU and no device memory."""
    import torch

    from .budget import card_memory

    cuda = torch.cuda.is_available()
    per_dev = []
    if cuda:
        for i in range(torch.cuda.device_count()):
            per_dev.append({
                "id": i, "kind": torch.cuda.get_device_name(i), "platform": "cuda",
                "memory_gb": round(card_memory(i) / (1 << 30), 2),
                "memory_in_use_gb": round(torch.cuda.memory_allocated(i) / (1 << 30), 2),
            })
    else:
        per_dev.append({"id": 0, "kind": "cpu", "platform": "cpu"})
    return {
        "backend": "cuda" if cuda else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "n_devices": torch.cuda.device_count() if cuda else 0,
        "devices": per_dev,
        "host_ram_gb": round(_host_mem_gb(), 1),
        "cpus": os.cpu_count(),
    }


def run_startup_checks(cfg=None, quant=None, verbose: bool = True,
                       offload: bool = False) -> Dict:
    """Environment + (optional) model-fit check. Returns the report; raises
    RuntimeError if the model cannot fit (refuse to start). With `offload`,
    the fit check splits into the device bytes without the experts against
    the device memory and the experts against host RAM. The device memory
    is `device_memory` (bytes) where given, else the smallest card's; with
    neither the fit check is skipped, and the report says so."""
    rep = device_report()
    # the reference's OpenMP quantizer (native/quant.cpp) is not ported
    rep["native_quantizer"] = False

    if cfg is not None and quant is not None:
        from .budget import card_memory, compute_budget

        b = compute_budget(cfg, quant)
        n = rep["n_devices"]
        rep["model_weight_gb"] = round(b.total_weight_bytes / (1 << 30), 2)
        if not n:
            rep["fit_check"] = "skipped: no card"
            return _finish_report(rep, verbose)
        hbm = min(card_memory(i) for i in range(n))
        rep["device_memory_gb"] = round(hbm / (1 << 30), 2)
        if offload:
            from .models.params import pattern_info

            dev, host = b.offload_split(max(pattern_info(cfg).period, 1))
            rep["per_chip_gb"] = round(dev / (1 << 30), 2)
            rep["host_expert_gb"] = round(host / (1 << 30), 2)
            host_gb = _host_mem_gb()
            if dev > hbm * HEADROOM:
                raise RuntimeError(
                    f"offload mode still needs {dev / (1 << 30):.1f} GiB "
                    f"HBM (non-expert weights + stream buffers) but HBM "
                    f"is {hbm / (1 << 30):.1f} GiB — refusing to start"
                )
            if host / (1 << 30) > host_gb * HEADROOM:
                raise RuntimeError(
                    f"host experts need {host / (1 << 30):.1f} GiB RAM but "
                    f"host has {host_gb:.1f} GiB — refusing to start"
                )
            return _finish_report(rep, verbose)
        per_chip = b.per_chip(n)
        rep["per_chip_gb"] = round(per_chip / (1 << 30), 2)
        rep["max_context"] = b.max_context_tokens(n, hbm)
        if per_chip > hbm * HEADROOM:
            raise RuntimeError(
                f"model needs {per_chip / (1 << 30):.1f} GiB/chip but HBM is "
                f"{hbm / (1 << 30):.1f} GiB — refusing to start "
                f"(shard over more chips, lower expert_bits, or use "
                f"--offload experts)"
            )
    return _finish_report(rep, verbose)


def _finish_report(rep: Dict, verbose: bool) -> Dict:
    if verbose:
        import json

        print("[syscheck]", json.dumps(rep, indent=2))
    return rep


# ---------------------------------------------------------------------------
# RAM watchdog: a background thread that ends the process cleanly before the
# kernel's OOM killer does it; it guards the host-side weight loading and
# quantization, the only phase with large host allocations
# ---------------------------------------------------------------------------

def mem_available_gb() -> float:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) / (1 << 20)
    except OSError:
        pass
    return float("inf")


def start_ram_watchdog(min_free_gb: float = 2.0, interval_s: float = 5.0, on_low=None):
    """Background thread that fires `on_low(avail_gb)` (default: log +
    SIGTERM self) when host MemAvailable drops below `min_free_gb`.
    Returns a `stop()` callable."""
    import logging
    import signal
    import threading

    log = logging.getLogger("krasis_tpu_torch.watchdog")
    stop_evt = threading.Event()

    def _default_on_low(avail):
        log.critical(
            "host RAM critically low: %.2f GiB available < %.2f GiB floor "
            "— terminating before the kernel OOM-killer does", avail, min_free_gb,
        )
        os.kill(os.getpid(), signal.SIGTERM)

    handler = on_low or _default_on_low

    def _run():
        while not stop_evt.wait(interval_s):
            avail = mem_available_gb()
            if avail < min_free_gb:
                handler(avail)
                return

    t = threading.Thread(target=_run, name="ram-watchdog", daemon=True)
    t.start()

    def stop():
        stop_evt.set()

    return stop
