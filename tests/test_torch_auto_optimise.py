"""auto_optimise (krasis_tpu_torch/auto_optimise.py) against the reference's
krasis_tpu/auto_optimise.py: the same generate calls (a warm run at each
block, then `runs` timed ones over 2 × block tokens, blocks that do not fit
max_len skipped) and the same result for the same measured rates; a tiny
engine tuned on the CPU stores under $KRASIS_TPU_HOME/auto_torch/, and
apply_tuning reads only that: a block the reference stored under auto/ is
never applied."""

import json
import types

import pytest

from krasis_tpu import auto_optimise as jauto
from krasis_tpu_torch import auto_optimise
from krasis_tpu_torch.config import QuantConfig
from krasis_tpu_torch.models.synthetic import build_synthetic_engine, tiny_config

import torch_port_util  # noqa: F401  (one PyTorch thread)


class Recorder:
    """An engine stand-in: records generate calls; the decode rate is a
    function of the block and the call's index."""

    def __init__(self, max_len=512):
        self.cfg = types.SimpleNamespace(model_type="qwen3_moe", num_hidden_layers=2,
                                         vocab_size=1024)
        self.max_len, self.decode_block, self.calls = max_len, 8, []

    def generate(self, prompt, max_new_tokens, sampling, stop_ids):
        self.calls.append((list(prompt), max_new_tokens, sampling.temperature,
                           sorted(stop_ids), self.decode_block))
        rate = 100.0 + self.decode_block + (len(self.calls) % 3)
        return types.SimpleNamespace(decode_tok_s=rate)


@pytest.mark.parametrize("runs,max_len", [(1, 512), (3, 512), (2, 200)])
def test_tuning_is_the_reference_s(monkeypatch, tmp_path, runs, max_len):
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path))
    got_eng, want_eng = Recorder(max_len), Recorder(max_len)
    got = auto_optimise.tune_engine(got_eng, blocks=(8, 16, 64), runs=runs, prompt_len=64)
    want = jauto.tune_engine(want_eng, blocks=(8, 16, 64), runs=runs, prompt_len=64)
    assert got_eng.calls == want_eng.calls
    got.pop("tuned_at"), want.pop("tuned_at")
    assert got == want and got_eng.decode_block == want_eng.decode_block
    assert (tmp_path / "auto_torch" / "qwen3_moe-2.json").exists()
    assert (tmp_path / "auto" / "qwen3_moe-2.json").exists()     # the reference's, apart


def test_a_tiny_engine_tunes_and_applies(monkeypatch, tmp_path):
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path))
    cfg = tiny_config("qwen3-moe")
    quant = QuantConfig(expert_bits=4, group_size=32)
    eng = build_synthetic_engine(cfg, quant, max_len=256, device="cpu")
    res = auto_optimise.tune_engine(eng, blocks=(2, 4), runs=1, prompt_len=32)
    assert set(res["decode_blocks"]) == {"2", "4"} and all(
        r > 0 for r in res["decode_blocks"].values())
    assert eng.decode_block == res["best_decode_block"]
    path = tmp_path / "auto_torch" / f"{cfg.model_type}-{cfg.num_hidden_layers}.json"
    assert json.loads(path.read_text())["best_decode_block"] == res["best_decode_block"]
    assert not (tmp_path / "auto").exists()

    fresh = build_synthetic_engine(cfg, quant, max_len=256, device="cpu")
    fresh.decode_block = 7
    assert auto_optimise.apply_tuning(fresh) and fresh.decode_block == res["best_decode_block"]


def test_the_reference_s_store_is_never_read(monkeypatch, tmp_path):
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path))
    eng = Recorder()
    (tmp_path / "auto").mkdir()
    (tmp_path / "auto" / "qwen3_moe-2.json").write_text(json.dumps({"best_decode_block": 128}))
    assert jauto.apply_tuning(eng) and eng.decode_block == 128       # the reference reads it
    eng.decode_block = 8
    assert not auto_optimise.apply_tuning(eng) and eng.decode_block == 8
    (tmp_path / "auto_torch" / "qwen3_moe-2.json").write_text("{not json")
    assert not auto_optimise.apply_tuning(eng) and eng.decode_block == 8
