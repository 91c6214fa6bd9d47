"""The port's quality matrix (krasis_tpu_torch/quality.py) against the JAX
package's: the bootstrap, the markdown and the per-mode quant configs
equal; a checkpoint trained by the port (runtime/bpe_train.py,
models/train_qwen3moe.py) read by HF transformers and tokenizers, which are
oracles here only; and both packages' run_matrix on one checkpoint built by
the JAX package. The corpora are built in temporary directories."""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import krasis_tpu.prompts as jp
import krasis_tpu.quality as jq
import krasis_tpu_torch.prompts as tp
import krasis_tpu_torch.quality as pq

import torch_port_util  # noqa: F401  (one PyTorch thread a worker)

TARGET = 60_000
SMALL = dict(steps=30, hidden=128, layers=2, experts=4, top_k=2, moe_intermediate=64,
             batch=4, seq=128, log_every=0)
MATRIX = dict(modes=("bf16", "q4"), shapes=((128, 64),), max_tokens=3000, group_size=32)
PPL_RTOL = 1e-2
DELTA_ATOL = 5e-3


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """$KRASIS_TPU_HOME in a temporary directory with both packages' corpora
    (the JAX one's load_domain pointed at its own temporary directory)."""
    root = tmp_path_factory.mktemp("quality_home")
    jdir = str(root / "jax_prompts")
    jp.build_corpus(jdir, target_bytes=TARGET)
    load = jp.load_domain
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KRASIS_TPU_HOME", str(root))
        mp.setattr(jp, "load_domain", lambda d, out_dir=jdir: load(d, out_dir))
        tp.build_corpus(target_bytes=TARGET)
        yield root


@pytest.fixture(scope="module")
def port_ckpt(home):
    return pq.build_quality_checkpoint(out_dir=str(home / "port_ckpt"), device="cpu", **SMALL)


@pytest.fixture(scope="module")
def jax_ckpt(home):
    return jq.build_quality_checkpoint(out_dir=str(home / "jax_ckpt"), **SMALL)


@pytest.fixture(scope="module")
def matrices(jax_ckpt):
    return (jq.run_matrix(jax_ckpt, **MATRIX),
            pq.run_matrix(jax_ckpt, device="cpu", **MATRIX))


def test_constants_match():
    assert (pq.VOCAB, pq.TRAIN_DOMAINS, pq.EVAL_DOMAINS, pq.TRAIN_FRACTION, pq.CHAT_TEMPLATE,
            pq.THRESHOLDS) == (jq.VOCAB, jq.TRAIN_DOMAINS, jq.EVAL_DOMAINS, jq.TRAIN_FRACTION,
                               jq.CHAT_TEMPLATE, jq.THRESHOLDS)


@pytest.mark.parametrize("mode", list(jq.THRESHOLDS))
def test_quant_for_matches_jax(mode):
    want = dataclasses.asdict(jq._quant_for(mode, 64))
    got = dataclasses.asdict(pq._quant_for(mode, 64))
    assert set(got) <= set(want)
    assert got == {k: want[k] for k in got}
    with pytest.raises(ValueError):
        pq._quant_for("q3", 64)


@pytest.mark.parametrize("n,seed", [(2, 0), (7, 1), (40, 2)])
def test_paired_bootstrap_matches_jax(n, seed):
    rng = np.random.default_rng(seed)
    cnt = rng.integers(60, 130, n).tolist()
    a = [(float(rng.uniform(300, 700)), c) for c in cnt]
    b = [(s + float(rng.normal(0, 2)), c) for s, c in a]
    assert pq.paired_bootstrap_delta(a, b) == jq.paired_bootstrap_delta(a, b)
    assert pq.paired_bootstrap_delta(a, b, n_boot=50, seed=3) == jq.paired_bootstrap_delta(
        a, b, n_boot=50, seed=3)


def test_port_checkpoint_is_read_by_hf(port_ckpt):
    from transformers import Qwen3MoeForCausalLM

    from krasis_tpu_torch.runtime.tokenizer import Tokenizer

    hf = Qwen3MoeForCausalLM.from_pretrained(port_ckpt, torch_dtype=torch.float32).eval()
    model, _ = pq._load_training_model(port_ckpt, torch.device("cpu"))
    text = tp.load_domain(pq.EVAL_DOMAINS[0])[:2000]
    ids = torch.tensor([Tokenizer(port_ckpt).encode(text)[:200]])
    with torch.no_grad():
        want = hf(input_ids=ids).logits.float()
        got = model(ids)
    assert float((got - want).abs().max()) <= 1e-4


def test_port_tokenizer_is_read_by_hf(port_ckpt):
    from tokenizers import Tokenizer as HFTokenizer
    from transformers import AutoTokenizer

    from krasis_tpu_torch.runtime.tokenizer import Tokenizer

    text = "\n\n".join(tp.load_domain(d)[:20_000] for d in pq.EVAL_DOMAINS + pq.TRAIN_DOMAINS)
    got = Tokenizer(port_ckpt).encode(text)
    assert got == HFTokenizer.from_file(os.path.join(port_ckpt, "tokenizer.json")).encode(text).ids
    auto = AutoTokenizer.from_pretrained(port_ckpt)
    assert auto(text)["input_ids"] == got
    assert auto.eos_token_id == 0 and auto.chat_template == pq.CHAT_TEMPLATE
    assert max(got) < pq.VOCAB - 4


def test_model_config_of_both_packages(port_ckpt):
    from krasis_tpu.config import ModelConfig as JaxModelConfig
    from krasis_tpu_torch.config import ModelConfig

    want, got = JaxModelConfig.from_model_path(port_ckpt), ModelConfig.from_model_path(port_ckpt)
    for f in ("model_type", "hidden_size", "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "head_dim", "n_routed_experts", "num_experts_per_tok",
              "moe_intermediate_size", "vocab_size", "norm_topk_prob", "rope_theta",
              "rms_norm_eps", "eos_token_id", "tie_word_embeddings"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.model_type == "qwen3_moe" and got.n_routed_experts == 4


def test_matrices_agree(matrices):
    want, got = matrices
    assert got["eval_tokens"] == want["eval_tokens"]
    for mode in MATRIX["modes"]:
        w, g = want["modes"][mode], got["modes"][mode]
        for col in ("128/64", "decode"):
            wc = w["shapes"][col] if col != "decode" else w["decode"]
            gc = g["shapes"][col] if col != "decode" else g["decode"]
            assert gc["tokens_scored"] == wc["tokens_scored"]
            assert abs(gc["ppl"] - wc["ppl"]) <= PPL_RTOL * wc["ppl"], (mode, col)
            key = "delta_vs_bf16"
            if key in wc:
                assert abs(gc[key] - wc[key]) <= DELTA_ATOL, (mode, col)
        assert g["verdict"] == w["verdict"]
    assert got["spec"]["ngram"]["exact"] is True and want["spec"]["ngram"]["exact"] is True
    assert got["modes"]["q4"]["launches"]["ragged_plain"] == 0


def test_write_markdown_matches_jax(matrices, tmp_path):
    want, got = matrices
    for results in ([want], [want, got]):
        jq.write_markdown(results, str(tmp_path / "jax.md"))
        pq.write_markdown(results, str(tmp_path / "port.md"))
        assert (tmp_path / "port.md").read_text() == (tmp_path / "jax.md").read_text()


def test_decode_path_scores_the_forced_segments(matrices):
    _, got = matrices
    dec = got["modes"]["bf16"]["decode"]
    assert dec["segment"] == 128 and dec["tokens_scored"] == 126 * len(dec["window_nlls"])
    nll = sum(w[0] for w in dec["window_nlls"])
    assert dec["ppl"] == pytest.approx(math.exp(nll / dec["tokens_scored"]), rel=1e-4)


def test_mtp_head_and_spec_exactness(port_ckpt):
    from krasis_tpu_torch.config import ModelConfig

    pq.train_mtp_head(port_ckpt, steps=4, batch=2, seq=64, log_every=0, device="cpu")
    cfg = ModelConfig.from_model_path(port_ckpt)
    assert cfg.num_nextn_predict_layers == 1
    spec = pq.run_spec_exactness(port_ckpt, group_size=32, n_tokens=16, device="cpu")
    assert spec["ngram"]["exact"] is True
    assert spec["mtp"]["exact"] is True and spec["mtp"]["checkpoint"] == "trained"
