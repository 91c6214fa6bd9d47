"""syscheck (krasis_tpu_torch/syscheck.py) against the reference's
krasis_tpu/syscheck.py: the same refusals, word for word, for the same
budget, device memory and host RAM; the CPU's report names no card and
assumes no device memory; the RAM watchdog fires and stops
(tests/test_failure.py's case)."""

import threading
import time

import pytest

from krasis_tpu import syscheck as jsyscheck
from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.config import preset_config as jax_preset_config
from krasis_tpu_torch import budget, syscheck
from krasis_tpu_torch.config import QuantConfig, preset_config

GIB = 1 << 30
HOST_GB = 101.0      # the card machine's host RAM, GiB


def _reference(monkeypatch, hbm_gb):
    """The reference's report on one device of `hbm_gb` and HOST_GB of RAM."""
    monkeypatch.setattr(jsyscheck, "device_report", lambda: {
        "backend": "x", "n_devices": 1, "devices": [{"id": 0, "hbm_limit_gb": hbm_gb}]})
    monkeypatch.setattr(jsyscheck, "_host_mem_gb", lambda: HOST_GB)


def _both(monkeypatch, preset, hbm_gb, offload):
    """(the reference's outcome, the port's) for one model at Q4: the report's
    fit keys, or the refusal's text."""
    _reference(monkeypatch, hbm_gb)
    monkeypatch.setattr(syscheck, "_host_mem_gb", lambda: HOST_GB)
    monkeypatch.setattr(syscheck, "device_report", lambda: {"backend": "cuda", "n_devices": 1})
    monkeypatch.setattr(budget, "card_memory", lambda device=None: int(hbm_gb * GIB))
    out = []
    for run in (lambda: jsyscheck.run_startup_checks(
                    jax_preset_config(preset), JaxQuantConfig(expert_bits=4), verbose=False,
                    offload=offload),
                lambda: syscheck.run_startup_checks(
                    preset_config(preset), QuantConfig(expert_bits=4), verbose=False,
                    offload=offload)):
        try:
            rep = run()
            out.append({k: rep.get(k) for k in ("model_weight_gb", "per_chip_gb",
                                                "max_context", "host_expert_gb")})
        except RuntimeError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("preset,hbm_gb,offload,refused", [
    ("deepseek-v2-lite", 80.0, False, None),
    ("deepseek-v2-lite", 80.0, True, None),
    ("qwen3-235b", 80.0, False, "GiB/chip but HBM is 80.0 GiB"),
    ("qwen3-235b", 80.0, True, "RAM but host has 101.0 GiB"),
    ("qwen3-235b", 2.0, True, "offload mode still needs"),
    ("deepseek-v2-lite", 8.0, False, "GiB/chip but HBM is 8.0 GiB")])
def test_fit_check_matches_the_reference(monkeypatch, preset, hbm_gb, offload, refused):
    ref, port = _both(monkeypatch, preset, hbm_gb, offload)
    assert port == ref
    if refused is None:
        assert isinstance(port, dict) and port["per_chip_gb"] > 0
    else:
        assert isinstance(port, str) and refused in port and "refusing to start" in port


def test_the_cpu_reports_no_card_and_assumes_no_memory(monkeypatch, capsys):
    """Without a card the report names the CPU, holds no device memory, and
    the fit check is skipped rather than run against an assumed size."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rep = syscheck.device_report()
    assert rep["backend"] == "cpu" and rep["n_devices"] == 0
    assert rep["devices"] == [{"id": 0, "kind": "cpu", "platform": "cpu"}]
    rep = syscheck.run_startup_checks(preset_config("qwen3-235b"), QuantConfig(expert_bits=4))
    assert rep["fit_check"].startswith("skipped") and "per_chip_gb" not in rep
    assert rep["native_quantizer"] is False
    assert '"backend": "cpu"' in capsys.readouterr().out
    host = syscheck.host_report()
    assert host["cpus"] > 0 and host["ram_gb"] > 0


def test_ram_watchdog_fires_and_stops():
    fired = threading.Event()
    vals = []

    def on_low(avail):
        vals.append(avail)
        fired.set()

    # a floor above any machine's RAM fires on the first poll
    stop = syscheck.start_ram_watchdog(min_free_gb=1e9, interval_s=0.01, on_low=on_low)
    assert fired.wait(timeout=5.0)
    assert vals and vals[0] < 1e9
    stop()

    # a floor of 0 on a healthy machine does not fire
    fired2 = threading.Event()
    stop2 = syscheck.start_ram_watchdog(min_free_gb=0.0, interval_s=0.01,
                                        on_low=lambda a: fired2.set())
    time.sleep(0.1)
    stop2()
    assert not fired2.is_set()
    assert syscheck.mem_available_gb() > 0
