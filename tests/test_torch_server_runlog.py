"""The port's server.main with the reference's --config, --note and
--min-free-ram-gb (krasis_tpu/server.py main): the config file's values are
defaults the flags override, the run log opens in the working directory
with the note at its top and the previous run's log archived under logs/,
and the RAM watchdog starts at the given floor (0: not at all) and stops
when main returns. Serving is replaced by a stand-in."""

import logging

import pytest

from krasis_tpu_torch import server, syscheck

from torch_port_util import run_log_dir  # noqa: F401

pytestmark = pytest.mark.usefixtures("run_log_dir")


def _main(monkeypatch, argv):
    """server.main(argv) on the tiny synthetic model; returns (the engine it
    built, the watchdog floors started, the stops called)."""
    seen, floors, stops = {}, [], []

    def watchdog(min_free_gb=2.0, **kw):
        floors.append(min_free_gb)
        return lambda: stops.append(min_free_gb)
    monkeypatch.setattr(syscheck, "start_ram_watchdog", watchdog)
    monkeypatch.setattr(server, "run_server",
                        lambda engine, *a, **kw: seen.update(engine=engine))
    assert server.main(argv) == 0
    for h in logging.getLogger().handlers:
        h.flush()
    return seen["engine"], floors, stops


def test_config_note_and_watchdog(monkeypatch, run_log_dir):
    cfg = run_log_dir / "serve.cfg"
    cfg.write_text("synthetic=tiny\ndevice=cpu\nmax-len=256\nno-warmup=true\n")
    eng, floors, stops = _main(monkeypatch, ["--config", str(cfg), "--max-len", "512",
                                             "--note", "first run", "--min-free-ram-gb", "3"])
    assert eng.max_len == 512                  # the flag overrides the file's 256
    assert floors == [3.0] and stops == [3.0]
    log = run_log_dir / "krasis_tpu_torch.log"
    text = log.read_text()
    assert text.startswith("=== RUN NOTE: first run ===\n\n")
    assert "'max_len': 256" in text            # the file's values
    assert "'max_len': 512" in text and "'note': 'first run'" in text     # the arguments

    # a second start archives the first run's log and heads a new one
    eng, floors, stops = _main(monkeypatch, ["--config", str(cfg), "--note", "second run",
                                             "--min-free-ram-gb", "0"])
    assert eng.max_len == 256 and floors == [] and stops == []
    assert log.read_text().startswith("=== RUN NOTE: second run ===")
    archived = list((run_log_dir / "logs").iterdir())
    assert len(archived) == 1 and archived[0].name.startswith("krasis_tpu_torch_")
    assert archived[0].read_text().startswith("=== RUN NOTE: first run ===")


def test_unknown_config_key_is_refused(monkeypatch, run_log_dir, capsys):
    cfg = run_log_dir / "serve.cfg"
    cfg.write_text("synthetic=tiny\ndevice=cpu\nmax_lenn=256\n")
    with pytest.raises(SystemExit):
        server.main(["--config", str(cfg)])
    assert "unknown config keys" in capsys.readouterr().err
    assert not (run_log_dir / "krasis_tpu_torch.log").exists()
