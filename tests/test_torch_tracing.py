"""tracing (krasis_tpu_torch/tracing.py), the port of krasis_tpu/tracing.py:
capture_trace writes a Chrome trace that names the annotate() regions of
what it wraps (on the CPU here: the CPU activity of a tiny engine's
prefill and decode), and phase_timer prints as the reference's does."""

import json

from krasis_tpu import tracing as jtracing
from krasis_tpu_torch import tracing
from krasis_tpu_torch.config import QuantConfig
from krasis_tpu_torch.models.synthetic import build_synthetic_engine, tiny_config

import torch_port_util  # noqa: F401  (one PyTorch thread)


def test_trace_names_the_annotations(tmp_path):
    cfg = tiny_config("deepseek-v2-lite")
    eng = build_synthetic_engine(cfg, QuantConfig(expert_bits=4, group_size=32),
                                 max_len=128, device="cpu")
    with tracing.capture_trace(str(tmp_path)):
        with tracing.annotate("prefill"):
            eng.generate([5, 6, 7, 8], max_new_tokens=1, stop_ids={-1})
        with tracing.annotate("decode"):
            eng.generate([5, 6, 7, 8], max_new_tokens=4, stop_ids={-1})
    trace = json.loads((tmp_path / tracing.TRACE_NAME).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"prefill", "decode"} <= names
    assert any("matmul" in str(n) or "mm" in str(n) for n in names)


def test_phase_timer_prints_as_the_reference(capsys):
    for mod in (jtracing, tracing):
        with mod.phase_timer("load"):
            pass
        with mod.phase_timer("skipped", enabled=False):
            pass
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and all(line.startswith("[timing] load: ") and line.endswith(" ms")
                                 for line in out)
