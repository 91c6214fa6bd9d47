"""The launcher (krasis_tpu_torch/launcher.py, launcher_tui.py) against the
reference's krasis_tpu/launcher.py and launcher_tui.py: the first two cases
of tests/test_launcher_tui.py (the settings' state and a budget panel that
never raises), scan_models' finds, the non-interactive command line (the
reference's, naming krasis_tpu_torch.server), a saved config of its own
(config_torch; the reference's config is never read), a budget over the
card's memory or the caller's and never an assumed size, and one
non-interactive launch on the CPU end to end: the server answers a chat
request and stops with the launcher on SIGTERM."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from krasis_tpu import launcher as jlauncher
from krasis_tpu import syscheck as jsyscheck
from krasis_tpu_torch import budget as krasis_budget
from krasis_tpu_torch import launcher, server
from krasis_tpu_torch.launcher_tui import CHOICES, SettingState, budget_lines, hardware_lines

from torch_port_util import run_log_dir  # noqa: F401

CONFIG = {"model_type": "qwen3_moe", "hidden_size": 64, "intermediate_size": 128,
          "moe_intermediate_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
          "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 256, "num_experts": 8,
          "num_experts_per_tok": 2, "max_position_embeddings": 4096}


def test_setting_state_cycle_and_edit():
    s = SettingState({"expert_bits": "8", "port": "9000"})
    assert s.values["expert_bits"] == "8" and s.values["port"] == "9000"
    assert s.cycle(0, 1) and s.values["expert_bits"] == "4"
    assert s.cycle(0, 1) and s.values["expert_bits"] == "8"
    idx_port = [i for i, (k, *_) in enumerate(launcher.SETTINGS) if k == "port"][0]
    assert not s.cycle(idx_port, 1)
    s.set(idx_port, "8401")
    assert s.values["port"] == "8401"
    assert set(CHOICES) <= {k for k, *_ in launcher.SETTINGS}
    # the reference's settings, and the device the port's server runs on
    assert [k for k, *_ in launcher.SETTINGS] == [k for k, *_ in jlauncher.SETTINGS] + ["device"]
    idx_dev = [i for i, (k, *_) in enumerate(launcher.SETTINGS) if k == "device"][0]
    assert s.values["device"] == "cuda" and s.cycle(idx_dev, 1) and s.values["device"] == "cpu"


def test_budget_lines_never_raise(tmp_path):
    lines = budget_lines(str(tmp_path / "nope"), {"expert_bits": "4"})
    assert lines and "unavailable" in lines[0]


def _model(tmp_path, name="tiny"):
    d = tmp_path / "models" / name
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps(CONFIG))
    (d / "model.safetensors").write_bytes(b"\x08\0\0\0\0\0\0\0{}")
    return d


def test_scan_models_finds_the_reference_s(tmp_path):
    _model(tmp_path, "a")
    nested = _model(tmp_path, "b")
    (nested / "inner").mkdir()
    (nested / "inner" / "config.json").write_text("{}")   # inside a checkpoint: not descended
    (tmp_path / "models" / "ggufs").mkdir()
    (tmp_path / "models" / "ggufs" / "m.gguf").write_bytes(b"GGUF")
    (tmp_path / "models" / "c").mkdir()
    (tmp_path / "models" / "c" / "config.json").write_text("{}")    # no weights
    roots = [str(tmp_path / "models"), str(tmp_path / "missing")]
    found = launcher.scan_models(roots)
    assert found == jlauncher.scan_models(roots) and len(found) == 3


def test_non_interactive_runs_the_reference_s_command(monkeypatch, tmp_path):
    model = str(_model(tmp_path))
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path))
    saved = {"model": model, "expert_bits": "8", "slots": "2", "port": "8411"}
    launcher.save_config(saved)
    assert launcher.config_path() == str(tmp_path / "config_torch")
    assert launcher.load_saved_config() == saved
    seen = []
    monkeypatch.setattr(launcher, "run_server", lambda cmd: seen.append(cmd) or 0)
    assert launcher.main(["--non-interactive"]) == 0

    ref_cfg = tmp_path / "config"
    ref_cfg.write_text("".join(f"{k}={v}\n" for k, v in saved.items()))
    monkeypatch.setattr(jlauncher, "CONFIG_PATH", str(ref_cfg))
    want = []
    monkeypatch.setattr(jlauncher.subprocess, "call", lambda cmd: want.append(cmd) or 0)
    monkeypatch.setattr(sys, "argv", ["launcher", "--non-interactive"])
    assert jlauncher.main() == 0
    cmd = seen[0]
    assert cmd[1:3] == ["-m", "krasis_tpu_torch.server"]
    assert cmd[:-2] == [a.replace("krasis_tpu.server", "krasis_tpu_torch.server")
                        for a in want[0]]
    assert cmd[-2:] == ["--device", "cuda"]

    seen.clear()
    assert launcher.main(["--non-interactive", "--port", "0"]) == 0
    assert cmd[cmd.index("--port") + 1] == "8411" and seen[0][seen[0].index("--port") + 1] == "0"


def test_the_reference_s_saved_config_is_never_read(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path))
    (tmp_path / "config").write_text(f"model={tmp_path}\n")
    assert launcher.load_saved_config() == {}
    assert launcher.main(["--non-interactive"]) == 1
    assert "no saved config" in capsys.readouterr().out


def test_budget_needs_the_card_or_the_caller_s_memory(monkeypatch, tmp_path, capsys):
    """No assumed memory: without a card, no budget; with a card of 80 GiB,
    the reference's text for one device of 80."""
    model = str(_model(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.show_budget(model, 4)
    assert "unavailable" in budget_lines(model, {"expert_bits": "4"})[0]
    monkeypatch.setattr(krasis_budget, "card_memory", lambda device=None: 80 << 30)
    launcher.show_budget(model, 4)
    got = capsys.readouterr().out
    monkeypatch.setattr(jsyscheck, "device_report", lambda: {
        "n_devices": 1, "devices": [{"id": 0, "hbm_limit_gb": 80.0}]})
    jlauncher.show_budget(model, 4)
    assert got == capsys.readouterr().out and "Budget" in got
    lines = hardware_lines()
    assert lines[0].startswith("accelerator: no CUDA device") and "host:" in lines[1]


@pytest.mark.usefixtures("run_log_dir")
def test_the_launched_server_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    """The launcher's default device is the card: without one, the server it
    starts raises (device.resolve_device) rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cmd = launcher.server_command(str(_model(tmp_path)), {})
    assert cmd[cmd.index("--device") + 1] == "cuda"
    with pytest.raises(RuntimeError, match="CUDA device and none is available"):
        server.main(cmd[3:] + ["--no-warmup"])


def test_run_server_returns_the_server_s_exit_code():
    assert launcher.run_server([sys.executable, "-c", "raise SystemExit(3)"]) == 3


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launch_serves_on_the_cpu_and_stops_on_sigterm(tmp_path):
    """cli launch --non-interactive with a saved config that asks for the
    CPU: the launcher starts the port's server on a tiny checkpoint, which
    answers a chat request; SIGTERM to the launcher stops both, exit 0."""
    from torch_ckpt_util import write_checkpoint

    from krasis_tpu_torch.runtime.bpe_train import save_tokenizer, train_bpe

    ckpt = write_checkpoint("qwen3_moe", tmp_path)
    vocab, merges = train_bpe(["hello launcher"], 256)
    save_tokenizer(ckpt, vocab, merges, (), chat_template=(
        "{% for m in messages %}{{ m['content'] }}{% endfor %}"))
    port = _free_port()
    (tmp_path / "config_torch").write_text(
        f"model={ckpt}\nport={port}\ndevice=cpu\nmax_len=512\nserver_backend=python\n")
    env = dict(os.environ, KRASIS_TPU_HOME=str(tmp_path),
               PYTHONPATH=os.pathsep.join(sys.path))
    proc = subprocess.Popen([sys.executable, "-m", "krasis_tpu_torch.cli", "launch",
                             "--non-interactive"], cwd=tmp_path, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        deadline = time.time() + 120
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"exit {proc.returncode}: {proc.stdout.read()}")
            assert time.time() < deadline, "no /health within 120 s"
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=2)
                break
            except OSError:
                time.sleep(0.3)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/chat/completions", headers={
                "Content-Type": "application/json"}, data=json.dumps({
                    "messages": [{"role": "user", "content": "hello"}], "max_tokens": 4,
                    "temperature": 0.0}).encode())
        body = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert 1 <= body["usage"]["completion_tokens"] <= 4
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        with pytest.raises(ProcessLookupError):
            os.killpg(proc.pid, 0)                        # the server stopped too
        out = proc.stdout.read()
        assert f"launching: {sys.executable} -m krasis_tpu_torch.server --model {ckpt} " in out
        assert (tmp_path / "krasis_tpu_torch.log").exists()      # its run log, in its cwd
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
