"""suite (krasis_tpu_torch/suite.py) against the reference's
krasis_tpu/suite.py: the TOML read the same way, each combo's benchmark
command line the reference's (module aside, and --device where a combo asks
for the CPU), the report parsed from the same output, and summarize's
table equal to the reference's on the same results. One tiny combo runs for
real with device = "cpu"; without it, on a host with no card, the combo's
benchmark raises as device.resolve_device does and the row records it."""

import json
import subprocess
import sys

import pytest

from krasis_tpu import suite as jsuite
from krasis_tpu_torch import benchmark, suite

TOML = """[suite]
decode_tokens = 64
prefill_lengths = [64, 128]

[[combo]]
name = "tiny-q4"
synthetic = "tiny"
expert_bits = 4
attention_quant = "int8"
decode_block = 16
max_len = 512
offload = "experts"

[[combo]]
name = "ckpt"
model = "/models/x"
expert_bits = 8
"""
REPORT = {"model": "synthetic/tiny", "results": {
    "best_prefill_tok_s": 1234.5, "decode": {"tok_s_mean": 98.7, "tok_s_median": 99.0}}}
OUT = "[engine] built\n{ not json\n" + json.dumps(REPORT, indent=2) + "\n"


class Done:
    def __init__(self, stdout, rc=0):
        self.stdout, self.returncode = stdout.encode(), rc


def _run_combo(mod, monkeypatch, tmp_path, combo, suite_cfg, out=OUT, rc=0):
    """mod.run_combo with the benchmark process replaced: (its command line,
    the result)."""
    seen = []
    monkeypatch.setattr(mod.subprocess, "run", lambda cmd, **kw: seen.append(cmd) or Done(out, rc))
    res = mod.run_combo(combo, suite_cfg, str(tmp_path))
    res.pop("elapsed_s")
    return seen[0], res


def _spec(tmp_path):
    import tomllib

    path = tmp_path / "suite.toml"
    path.write_text(TOML)
    with open(path, "rb") as f:
        return tomllib.load(f)


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_combo_command_and_report_are_the_reference_s(monkeypatch, tmp_path, which, device):
    spec = _spec(tmp_path)
    combo = dict(spec["combo"][which])
    want_cmd, want = _run_combo(jsuite, monkeypatch, tmp_path, combo, spec["suite"])
    if device:
        combo["device"] = device
    got_cmd, got = _run_combo(suite, monkeypatch, tmp_path, combo, spec["suite"])
    want_cmd = [a.replace("krasis_tpu.benchmark", "krasis_tpu_torch.benchmark")
                for a in want_cmd]
    assert got_cmd == want_cmd + (["--device", device] if device else [])
    assert got == want and got["report"] == REPORT
    assert (tmp_path / f"{combo['name']}.log").read_text().endswith("--- stdout ---\n" + OUT)


def test_every_flag_is_one_the_benchmark_takes(monkeypatch, tmp_path):
    spec = _spec(tmp_path)
    flags = {a for combo in spec["combo"] for a in suite.combo_command(
        dict(combo, device="cpu"), spec["suite"]) if a.startswith("--")}
    known = {s for a in benchmark.build_parser()._actions for s in a.option_strings}
    assert flags <= known and "--offload" in flags and "--device" in flags
    real = benchmark.build_parser

    def without_offload():
        ap = real()
        ap._actions = [a for a in ap._actions if "--offload" not in a.option_strings]
        return ap
    monkeypatch.setattr(benchmark, "build_parser", without_offload)
    with pytest.raises(ValueError, match="takes no --offload .*'tiny-q4'"):
        suite.main([str(tmp_path / "suite.toml"), "--out-dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()         # raised before any combo ran


def test_summarize_is_the_reference_s():
    results = [{"name": "a", "elapsed_s": 12.5, "rc": 0, "report": REPORT},
               {"name": "b", "elapsed_s": 3.0, "rc": 1},
               {"name": "c", "elapsed_s": 3600, "rc": -1, "report": {"results": {}}}]
    assert suite.summarize(results) == jsuite.summarize(results)
    assert "| a | 1234.5 | 98.7 | 12.5s | 0 |" in suite.summarize(results)


def test_unparsable_output_has_no_report(monkeypatch, tmp_path):
    spec = _spec(tmp_path)
    for out in ("no json here\n", ""):
        _, want = _run_combo(jsuite, monkeypatch, tmp_path, spec["combo"][0], {}, out, 3)
        _, got = _run_combo(suite, monkeypatch, tmp_path, spec["combo"][0], {}, out, 3)
        assert got == want == {"name": "tiny-q4", "rc": 3}


def test_a_tiny_combo_runs_on_the_cpu(tmp_path, capsys):
    """suite.main on one combo that asks for the CPU, the benchmark a process
    of its own; its row has rc 0 and numbers."""
    toml = tmp_path / "suite.toml"
    toml.write_text('[suite]\nprefill_lengths = [64]\n\n[[combo]]\nname = "tiny"\n'
                    'synthetic = "tiny"\nmax_len = 512\ndevice = "cpu"\n')
    results = suite.main([str(toml), "--out-dir", str(tmp_path / "out")])
    assert [r["rc"] for r in results] == [0]
    row = [line for line in capsys.readouterr().out.splitlines() if line.startswith("| tiny |")]
    cells = [c.strip() for c in row[0].strip("|").split("|")]
    assert float(cells[1]) > 0 and float(cells[2]) > 0 and cells[4] == "0"
    assert (tmp_path / "out" / "suite_logs" / "tiny.log").exists()
    assert len(list((tmp_path / "out").glob("suite_*.md"))) == 1


def test_a_combo_without_the_cpu_raises_without_a_card(tmp_path):
    """No card here: the benchmark of a combo that does not ask for the CPU
    raises (device.resolve_device), and the suite records its exit code."""
    res = suite.run_combo({"name": "card", "synthetic": "tiny"}, {}, str(tmp_path))
    assert res["rc"] != 0 and "report" not in res
    assert "CUDA device" in (tmp_path / "card.log").read_text()


def test_module_entry_point(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "krasis_tpu_torch.suite", "--help"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--out-dir" in proc.stdout
