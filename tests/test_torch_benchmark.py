"""The port's benchmark harness (krasis_tpu_torch/benchmark.py) against the
JAX package's: robust_stats equal on seeded series, run_engine_benchmark
making the same generate calls on a recording engine, and the network,
slots and archive paths run on tiny engines on the CPU."""

import json
import os
from pathlib import Path
from types import SimpleNamespace

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import krasis_tpu.benchmark as jb
import krasis_tpu.prompts as jp
import krasis_tpu_torch.benchmark as tb
import krasis_tpu_torch.prompts as tp
from krasis_tpu_torch.config import QuantConfig
from krasis_tpu_torch.models.synthetic import build_synthetic_engine, tiny_config

import torch_port_util  # noqa: F401  (one PyTorch thread a worker)

ROOT = Path(__file__).resolve().parent.parent
TARGET = 20_000


@settings(max_examples=60, deadline=None)
@given(st.lists(st.floats(min_value=0.0, max_value=1e5, allow_nan=False), min_size=1,
                max_size=12))
def test_robust_stats_matches_jax(xs):
    assert tb.robust_stats(xs) == jb.robust_stats(xs)


def test_robust_stats_flags_an_outlier():
    got = tb.robust_stats([10.0, 10.5, 9.5, 10.2, 40.0])
    assert got["flagged_runs"] == [4] and got["median"] == 10.2


class RecordingEngine:
    """What run_engine_benchmark reads of an engine: cfg.vocab_size,
    max_len and generate, which logs each call."""

    def __init__(self, max_len):
        self.cfg = SimpleNamespace(vocab_size=102400)
        self.max_len = max_len
        self.calls = []

    def generate(self, prompt, max_new_tokens, sampling=None, stop_ids=None):
        self.calls.append((list(prompt), max_new_tokens, sampling.temperature,
                           sorted(stop_ids)))
        n = len(self.calls)
        return SimpleNamespace(prefill_tok_s=1000.0 + n, prefill_s=len(prompt) / (1000.0 + n),
                               decode_tok_s=50.0 + n % 3)


@pytest.mark.parametrize("lengths,max_len", [((300, 500), 1200), ((400, 900, 3000), 1500)])
def test_engine_benchmark_makes_the_reference_calls(monkeypatch, tmp_path, lengths, max_len):
    jdir, home = str(tmp_path / "jax"), tmp_path / "home"
    jp.build_corpus(jdir, target_bytes=TARGET)
    load = jp.load_domain
    monkeypatch.setattr(jp, "load_domain", lambda d, out_dir=jdir: load(d, out_dir))
    monkeypatch.setenv("KRASIS_TPU_HOME", str(home))
    tp.build_corpus(target_bytes=TARGET)
    want_eng, got_eng = RecordingEngine(max_len), RecordingEngine(max_len)
    want = jb.run_engine_benchmark(want_eng, prefill_lengths=lengths, decode_runs=3,
                                   decode_tokens=8)
    got = tb.run_engine_benchmark(got_eng, prefill_lengths=lengths, decode_runs=3,
                                  decode_tokens=8)
    assert got_eng.calls == want_eng.calls
    assert got == want
    assert set(got) == set(want) and set(got["decode"]) == set(want["decode"])


@pytest.fixture(scope="module")
def tiny_engine():
    cfg = tiny_config("qwen3-moe")
    quant = QuantConfig(expert_bits=4, group_size=32, kv_cache_dtype="bf16")
    return build_synthetic_engine(cfg, quant, max_len=512, device="cpu")


def test_network_benchmark_through_the_port_server(tiny_engine):
    from krasis_tpu_torch.server import ServerState, prompt_ids, start_temp_server

    httpd = start_temp_server(tiny_engine, None, "synthetic/tiny", port=0, backend="python")
    try:
        net = tb.run_network_benchmark(httpd.port, n_prompt_tokens=64, decode_tokens=16)
    finally:
        httpd.shutdown()
    ids = prompt_ids(ServerState(tiny_engine, None, "t"),
                     [{"role": "user", "content": "benchmark " * 32}])
    assert net["streamed_chunks"] == len(tiny_engine.generate(ids, max_new_tokens=16).tokens)
    assert net["streamed_chunks"] >= 8
    assert net["ttfc_s"] is not None and net["ttfc_s"] > 0
    assert net["network_decode_tok_s"] and net["network_decode_tok_s"] > 0
    assert net["total_s"] > 0


def test_network_benchmark_on_both_transports(tiny_engine):
    out = tb.network_benchmark(tiny_engine, "synthetic/tiny", 0, eng_decode=100.0,
                               n_prompt_tokens=32, decode_tokens=8, runs=2)
    assert set(out) == {"native", "python"}
    for backend, net in out.items():
        assert "error" not in net, (backend, net)
        assert net["streamed_chunks"] > 0 and len(net["runs"]) == 2
        assert "overhead_pct" in net


def test_slots_benchmark_on_a_tiny_model(tiny_engine):
    res = tb.run_slots_benchmark(tiny_engine.cfg, tiny_engine.quant, tiny_engine.params,
                                 slots_list=(1, 2), max_len=128, prompt_len=32,
                                 decode_tokens=8, decode_block=4, device="cpu")
    assert set(res) == {"1", "2"}
    for slots, r in res.items():
        assert r["total_tok"] == 8 * int(slots)
        assert r["agg_tok_s"] > 0 and r["wall_s"] > 0


def _files(d: Path):
    return {p for p in d.rglob("*")}


def test_archive_report_never_writes_under_benchmarks(monkeypatch, tmp_path):
    before = _files(ROOT / "benchmarks")
    path = tb.archive_report({"model": "synthetic/tiny", "x": 1}, str(tmp_path / "given"))
    assert path.startswith(str(tmp_path / "given")) and path.endswith(".json")
    with open(path) as f:
        assert json.load(f)["x"] == 1
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path / "home"))
    path = tb.archive_report({"model": "a/b"})
    assert os.path.dirname(path) == str(tmp_path / "home" / "reports")
    assert os.path.basename(path).startswith("a_b_")
    assert _files(ROOT / "benchmarks") == before


def test_main_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path))
    tp.build_corpus(target_bytes=TARGET)
    report = tb.main(["--synthetic", "tiny", "--device", "cpu", "--prefill-lengths", "64",
                      "--max-len", "512", "--decode-block", "4", "--archive"])
    res = report["results"]
    assert set(res["prefill"]) == {"64"} and res["prefill"]["64"]["tok_s"] > 0
    assert len(res["decode"]["tok_s_runs"]) == tb.DECODE_RUNS
    assert report["system"]["device"] == "cpu" and "jax" not in json.dumps(report["system"])
    out = capsys.readouterr().out
    assert "archived:" in out and str(tmp_path / "reports") in out


def test_main_without_a_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.main(["--synthetic", "tiny"])
