"""The perplexity entry point of the port (sliding_windows,
evaluate_perplexity, Engine.forward_all_logits) against the reference's, on
token ids made from a seed: the window protocol exactly, the scoring on the
same logits, and both through the tiny int8-expert DeepSeek-V2-Lite whose
reference run takes the two-stage expert class."""

import numpy as np
import pytest
import torch

from krasis_tpu import perplexity as jppl
from krasis_tpu_torch import perplexity as ppl

from torch_port_util import q8_engines

LOGIT_TOL = 2e-2


@pytest.mark.parametrize("n,window,stride", [
    (4096, 2048, 1024), (200, 64, 32), (65, 64, 32), (64, 64, 32), (33, 64, 32),
    (2, 64, 32), (1, 64, 32), (0, 64, 32), (100, 50, 50), (97, 64, 16)])
def test_sliding_windows_equal_the_reference(n, window, stride):
    got = list(ppl.sliding_windows(n, window, stride))
    assert got == list(jppl.sliding_windows(n, window, stride))
    if n >= 2 and window == 2 * stride:
        # every shifted position is scored once
        scored = sum(max(0, (end - start - 1) - s0) for start, end, s0 in got)
        assert scored == n - 1


class _TableEngine:
    """forward_all_logits from a fixed table: logits depend on the token and
    its place in the window, so both packages score identical values."""

    def __init__(self, table, as_torch):
        self.table, self.as_torch = table, as_torch

    def forward_all_logits(self, ids):
        rows = self.table[np.asarray(ids)] + 0.01 * np.arange(len(ids))[:, None]
        rows = rows.astype(np.float32)
        return torch.from_numpy(rows) if self.as_torch else rows


@pytest.mark.parametrize("n,window,stride", [(200, 64, 32), (131, 64, 32), (90, 40, 10)])
def test_scoring_equals_the_reference_on_the_same_logits(n, window, stride):
    rng = np.random.default_rng(n)
    table = rng.standard_normal((50, 50)) * 2.0
    ids = rng.integers(0, 50, n).tolist()
    want = jppl.evaluate_perplexity(_TableEngine(table, False), ids, window, stride, log_every=0)
    got = ppl.evaluate_perplexity(_TableEngine(table, True), ids, window, stride, log_every=0)
    assert got["tokens_scored"] == want["tokens_scored"] and got["windows"] == want["windows"]
    assert got["ppl"] == pytest.approx(want["ppl"], rel=1e-5)
    assert got["bits_per_token"] == pytest.approx(want["bits_per_token"], rel=1e-5)
    for (gs, gn), (ws, wn) in zip(got["window_nlls"], want["window_nlls"]):
        assert gn == wn and gs == pytest.approx(ws, rel=1e-5, abs=1e-4)


def test_max_tokens_cuts_the_ids():
    table = np.random.default_rng(0).standard_normal((50, 50))
    ids = list(range(50)) * 4
    got = ppl.evaluate_perplexity(_TableEngine(table, True), ids, 64, 32, max_tokens=100,
                                  log_every=0)
    assert got["tokens_scored"] == 99


@pytest.mark.parametrize("activation", ["int8", "bf16"])
def test_perplexity_through_the_engines(monkeypatch, activation):
    """forward_all_logits within 2e-2 of the logits' scale and perplexity
    within 1% of the reference's, over 200 seeded ids, window 64, stride 32.
    Prefill runs bf16 activations under either setting."""
    jeng, eng, calls = q8_engines(monkeypatch, activation)
    ids = np.random.default_rng(11).integers(1, 512, size=200).tolist()

    want = np.asarray(jeng.forward_all_logits(ids[:64]), np.float32)
    assert calls["gmm"] > 0
    got = eng.forward_all_logits(ids[:64])
    assert got.shape == (64, 512) and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= LOGIT_TOL * max(1.0, float(np.abs(want).max()))

    # the last row is what a prefill of the same prompt returns
    eng.reset()
    with torch.inference_mode():
        last = eng._prefill_prompt(ids[:64])
    assert float((got[-1] - last[0]).abs().max()) <= LOGIT_TOL * float(last.square().mean().sqrt())

    w = jppl.evaluate_perplexity(jeng, ids, window=64, stride=32, log_every=0)
    g = ppl.evaluate_perplexity(eng, ids, window=64, stride=32, log_every=0)
    assert g["tokens_scored"] == w["tokens_scored"] == 199
    assert g["windows"] == w["windows"]
    assert np.isfinite(g["ppl"]) and g["ppl"] == pytest.approx(w["ppl"], rel=1e-2)


def test_forward_all_logits_refuses_a_window_past_max_len(monkeypatch):
    _, eng, _ = q8_engines(monkeypatch, "int8", max_len=256)
    with pytest.raises(ValueError, match="max_len"):
        eng.forward_all_logits(list(range(1, 300)))
    with pytest.raises(ValueError):
        eng.forward_all_logits([])
