"""cli (krasis_tpu_torch/cli.py) against the reference's krasis_tpu/cli.py:
the same commands, each dispatched to the port's entry point with the rest
of the command line; budget prints format_budget's text (the reference's
for the same model and memory) and off the card refuses to guess the
memory; check reports the CPU and no card; serve without a card and
without --device cpu raises."""

import pytest
import torch

from krasis_tpu import cli as jcli
from krasis_tpu_torch import benchmark, chat, cli, launcher, perplexity, server

from torch_port_util import run_log_dir  # noqa: F401


@pytest.fixture(autouse=True)
def _argv(monkeypatch):
    """cli.main rewrites sys.argv for the command it runs: put it back."""
    import sys

    monkeypatch.setattr(sys, "argv", list(sys.argv))


def test_commands_are_the_reference_s(capsys):
    assert list(cli.COMMANDS) == list(jcli.COMMANDS)
    assert cli.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert all(f"  {name:<10} " in out for name in cli.COMMANDS)
    assert cli.main(["nope"]) == 1
    assert "unknown command 'nope'" in capsys.readouterr().out


@pytest.mark.parametrize("cmd,module,rc", [
    ("serve", server, 0), ("benchmark", benchmark, 0), ("ppl", perplexity, 0),
    ("launch", launcher, 3)])
def test_commands_dispatch_with_their_arguments(monkeypatch, cmd, module, rc):
    seen = []
    monkeypatch.setattr(module, "main", lambda argv=None: seen.append(argv) or rc)
    assert cli.main([cmd, "--synthetic", "tiny", "--device", "cpu"]) == (rc if cmd in (
        "serve", "launch") else 0)
    assert seen == [["--synthetic", "tiny", "--device", "cpu"]]


def test_chat_dispatches(monkeypatch):
    import sys

    seen = []
    monkeypatch.setattr(chat, "main", lambda: seen.append(sys.argv[1:]) or 0)
    assert cli.main(["chat", "--url", "http://127.0.0.1:1"]) == 0
    assert seen == [["--url", "http://127.0.0.1:1"]]


@pytest.mark.parametrize("preset,bits", [("deepseek-v2-lite", 4), ("qwen3-235b", 8)])
def test_budget_prints_the_reference_text(capsys, preset, bits):
    argv = ["budget", preset, "--expert-bits", str(bits), "--chips", "2", "--hbm-gb", "80"]
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert cli.main(argv) == 0
    assert capsys.readouterr().out == want
    assert "max context @ 2 chips" in want


def test_budget_without_a_card_needs_the_memory(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        cli.main(["budget", "deepseek-v2-lite"])
    assert "pass --hbm-gb" in capsys.readouterr().err


def test_check_reports_no_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["check"]) == 0
    out = capsys.readouterr().out
    assert '"backend": "cpu"' in out and '"n_devices": 0' in out and "memory_gb" not in out


@pytest.mark.usefixtures("run_log_dir")
def test_serve_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["serve", "--synthetic", "tiny", "--no-warmup"])
