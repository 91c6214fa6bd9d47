"""The port's perplexity entry points (krasis_tpu_torch/perplexity.py
load_dataset_text and main) against the JAX package's: the dataset cache
file read the same way, a missing one refused without a download, and
``main --text --device cpu`` on a tiny Qwen3-MoE checkpoint of
tests/torch_ckpt_util.py (with a 256-entry byte-level tokenizer, so that
every id fits its vocabulary) scoring the PPL the JAX main scores."""

import json
import sys

import pytest

import krasis_tpu.perplexity as jppl
import krasis_tpu_torch.perplexity as tppl
from krasis_tpu_torch import prompts
from krasis_tpu_torch.runtime.bpe_train import save_tokenizer, train_bpe

import torch_port_util  # noqa: F401  (one PyTorch thread a worker)
from torch_ckpt_util import write_checkpoint

PPL_RTOL = 1e-2


def test_load_dataset_text_reads_the_cache_file(monkeypatch, tmp_path):
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path))
    (tmp_path / "datasets").mkdir()
    (tmp_path / "datasets" / "wikitext-2.test.txt").write_text("one two\n\nthree")
    (tmp_path / "datasets" / "c4.validation.txt").write_text("c4 text")
    assert tppl.load_dataset_text("wikitext-2") == jppl.load_dataset_text("wikitext-2")
    assert tppl.load_dataset_text("c4", "validation") == jppl.load_dataset_text(
        "c4", "validation") == "c4 text"


def test_missing_dataset_file_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="datasets") as e:
        tppl.load_dataset_text("wikitext-2")
    assert str(tmp_path / "datasets" / "wikitext-2.test.txt") in str(e.value)


@pytest.fixture(scope="module")
def ckpt_and_text(tmp_path_factory):
    root = tmp_path_factory.mktemp("ppl_main")
    ck = write_checkpoint("qwen3_moe", root)
    text = prompts._build_docs(6000)
    vocab, merges = train_bpe([text], 256)              # the 256 byte characters
    save_tokenizer(ck, vocab, merges, ())
    path = root / "text.txt"
    path.write_text(text)
    return ck, str(path)


def test_main_matches_jax(monkeypatch, tmp_path, ckpt_and_text, capsys):
    ck, text = ckpt_and_text
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path))
    args = ["--model", ck, "--text", text, "--window", "128", "--stride", "64",
            "--max-tokens", "1200", "--expert-bits", "4"]
    monkeypatch.setattr(sys, "argv", ["perplexity", *args, "--out", str(tmp_path / "j.json")])
    jppl.main()
    with open(tmp_path / "j.json") as f:
        want = json.load(f)
    got = tppl.main(args + ["--device", "cpu", "--out", str(tmp_path / "p.json")])
    out = capsys.readouterr().out
    assert f'"ppl": {got["ppl"]}' in out
    with open(tmp_path / "p.json") as f:
        assert json.load(f)["ppl"] == got["ppl"]
    assert got["tokens_scored"] == want["tokens_scored"] and got["windows"] == want["windows"]
    assert abs(got["ppl"] - want["ppl"]) <= PPL_RTOL * want["ppl"]
    assert got["window"] == 128 and got["stride"] == 64 and got["model"] == ck
