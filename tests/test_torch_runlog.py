"""runlog (krasis_tpu_torch/runlog.py) against the reference's
krasis_tpu/runlog.py: the config file's precedence gives the reference's
Namespace, unknown keys are refused in its words (``x_`` keys pass), the
previous log is archived with _1, _2 suffixes, and the note and the
exception hook reach the log file. The port's log has a name of its own."""

import logging
import os
import sys

import pytest

from krasis_tpu import runlog as jrunlog
from krasis_tpu_torch import runlog

from torch_port_util import run_log_dir  # noqa: F401

CONFIG = """# a comment, then a blank line

max-len = 2048
EXPERT_BITS=8
kv-dtype="fp8"
no-warmup=true
ratio = 0.5
model = ~/models/tiny
x_experiment = 3
"""


def _parser():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--model")
    ap.add_argument("--max-len", type=int, default=4096)
    ap.add_argument("--expert-bits", type=int, default=4)
    ap.add_argument("--kv-dtype", default="auto")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--ratio", type=float, default=1.0)
    ap.add_argument("--port", type=int, default=8399)
    return ap


@pytest.mark.parametrize("argv", [[], ["--max-len", "512"], ["--port", "0", "--expert-bits", "4"]])
def test_config_precedence_gives_the_reference_namespace(tmp_path, argv):
    path = tmp_path / "run.cfg"
    path.write_text(CONFIG)
    assert runlog.parse_config_file(str(path)) == jrunlog.parse_config_file(str(path))
    argv = ["--config", str(path), *argv]
    got = runlog.apply_config_precedence(_parser(), argv)
    want = jrunlog.apply_config_precedence(_parser(), argv)
    assert vars(got) == {**vars(want), "config_values": jrunlog.parse_config_file(str(path))}
    assert got.max_len == (512 if "512" in argv else 2048)      # the flag wins
    assert got.model == os.path.expanduser("~/models/tiny") and got.no_warmup is True


@pytest.mark.parametrize("text,word", [("bogus_key = 1\n", "unknown config keys"), (None, "not found")])
def test_bad_config_is_refused_in_the_reference_words(tmp_path, capsys, text, word):
    path = tmp_path / "run.cfg"
    if text is not None:
        path.write_text(text)
    errs = []
    for mod in (jrunlog, runlog):
        with pytest.raises(SystemExit):
            mod.apply_config_precedence(_parser(), ["--config", str(path)])
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0] == errs[1] and word in errs[1]


@pytest.mark.usefixtures("run_log_dir")
def test_archive_suffixes_match_the_reference(tmp_path):
    """Four starts over logs of one mtime second: <stamp>, <stamp>_1, _2,
    _3, under each package's own log name."""
    names = {}
    for mod, base in ((jrunlog, tmp_path / "ref"), (runlog, tmp_path / "port")):
        base.mkdir()
        log = base / mod.LOG_NAME
        for i in range(4):
            log.write_text(f"run {i}\n")
            os.utime(log, (1_700_000_000, 1_700_000_000))
            mod.setup_run_logging(log_dir=str(base))
        names[mod] = sorted(os.listdir(base / "logs"))
        assert (base / "logs" / names[mod][-1]).read_text().startswith("run 3")
    assert runlog.LOG_NAME == "krasis_tpu_torch.log" != jrunlog.LOG_NAME
    ref = [n.replace("krasis_tpu_", "") for n in names[jrunlog]]
    port = [n.replace("krasis_tpu_torch_", "") for n in names[runlog]]
    assert port == ref and len(port) == 4
    assert [n[-6:] for n in port[1:]] == ["_1.log", "_2.log", "_3.log"]


@pytest.mark.usefixtures("run_log_dir")
def test_note_and_exception_hook_reach_the_log(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(sys, "excepthook", lambda *exc: seen.append(exc[0]))
    path = runlog.setup_run_logging(note="the second run", log_dir=str(tmp_path))
    assert path == str(tmp_path / "krasis_tpu_torch.log")
    logging.getLogger("krasis_tpu_torch.server").info("an info line")
    try:
        raise KeyError("boom")
    except KeyError:
        sys.excepthook(*sys.exc_info())
    for h in logging.getLogger().handlers:
        h.flush()
    text = open(path).read()
    assert text.startswith("=== RUN NOTE: the second run ===\n\n")
    assert "an info line" in text and "uncaught exception" in text and "KeyError: 'boom'" in text
    assert seen == [KeyError]          # the previous hook still runs
