"""The big-expert path as a whole on the CPU: a tiny DeepSeek-V2-Lite with
int8 experts whose reference run takes the two-stage class (decode through
moe_gathered_tiled, prefill through gmm twice), against the port's engine
on the same weights: greedy streams, logits, logprobs and top_logprobs.

The class limits of both packages are shrunk for the tiny experts
(``q8_engines``); the reference's kernels run in interpret mode."""

import numpy as np
import pytest
import torch

from krasis_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from krasis_tpu_torch.config import QuantConfig
from krasis_tpu_torch.models.params import init_synthetic_params
from krasis_tpu_torch.models.synthetic import tiny_config
from krasis_tpu_torch.ops import gmm_cuda, moe_cuda
from krasis_tpu_torch.ops.sampling import SamplingParams

from torch_port_util import Q8_OVERRIDES, q8_engines

NEW = 16
LOGIT_TOL = 2e-2
LP_TOL = 1e-2

# (expert activation, prompt length, prompt seed): seeds chosen so that no
# greedy step of the 16 lies within the logit tolerance of a tie
CASES = [("int8", 100, 7), ("bf16", 100, 7)]


@pytest.mark.parametrize("activation,n,seed", CASES)
def test_q8_generate_matches_jax_engine(monkeypatch, activation, n, seed):
    jeng, eng, calls = q8_engines(monkeypatch, activation)
    launched = {"tiled": 0, "two_stage": 0, "fused": 0}
    for mod, name, key in ((moe_cuda, "moe_gathered_tiled", "tiled"),
                           (gmm_cuda, "gmm_two_stage", "two_stage"),
                           (gmm_cuda, "gmm", "fused"), (moe_cuda, "moe_w4a8", "fused"),
                           (moe_cuda, "moe_bf16", "fused")):
        def counted(*a, _f=getattr(mod, name), _k=key, **kw):
            launched[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, counted)

    prompt = np.random.default_rng(seed).integers(1, 512, size=n).tolist()
    want = jeng.generate(prompt, max_new_tokens=NEW, stop_ids={-1}, top_logprobs=3,
                         sampling=JaxSamplingParams(temperature=0.0))
    assert calls["moe_gathered_tiled"] > 0 and calls["gmm"] > 0, calls
    streamed = []
    got = eng.generate(prompt, max_new_tokens=NEW, stop_ids={-1}, top_logprobs=3,
                       on_token_lp=lambda tok, lp: streamed.append((tok, lp)))
    assert launched["tiled"] > 0 and launched["two_stage"] > 0 and launched["fused"] == 0, launched
    assert got.finite
    assert got.tokens == want.tokens
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=LP_TOL)
    assert streamed == list(zip(got.tokens, got.logprobs))
    assert len(got.top_logprobs) == NEW
    for step, (g, w) in enumerate(zip(got.top_logprobs, want.top_logprobs)):
        # the values agree in order; the tokens too, except where two
        # candidates lie within the tolerance of each other and may swap
        np.testing.assert_allclose([lp for _, lp in g], [lp for _, lp in w], atol=LP_TOL)
        for tok, lp in g:
            if tok in dict(w):
                assert dict(w)[tok] == pytest.approx(lp, abs=LP_TOL), step
        assert g[0][0] == w[0][0] == got.tokens[step]
        assert g[0][1] == pytest.approx(got.logprobs[step])

    # last-position prefill logits, and the smallest top-2 gap of the stream
    jeng.reset(1024)
    eng.reset(1024)
    jl = np.asarray(jeng._prefill_prompt(prompt), np.float32)
    with torch.inference_mode():
        pl = eng._prefill_prompt(prompt)
        assert float(np.abs(pl.numpy() - jl).max()) <= LOGIT_TOL * max(1.0, float(np.abs(jl).max()))
        gaps = []
        for tok in want.tokens:
            top = torch.topk(pl[0], 2).values
            gaps.append(float(top[0] - top[1]))
            pl = eng._forward(torch.tensor([[tok]]), torch.ones(1, dtype=torch.int32),
                              prefill=False)
    assert min(gaps) > LOGIT_TOL, min(gaps)


def test_logprobs_are_zero_when_not_wanted(monkeypatch):
    _, eng, _ = q8_engines(monkeypatch, "int8")
    prompt = list(range(5, 45))
    res = eng.generate(prompt, max_new_tokens=10, stop_ids={-1}, want_logprobs=False)
    assert res.top_logprobs is None and len(res.logprobs) == 10
    assert res.logprobs[0] < 0.0 and res.logprobs[1:] == [0.0] * 9
    full = eng.generate(prompt, max_new_tokens=10, stop_ids={-1})
    assert full.tokens == res.tokens and all(lp < 0.0 for lp in full.logprobs)


def test_sampled_logprobs_are_of_the_raw_distribution(monkeypatch):
    """Under temperature the logprob is still log_softmax of the raw logits
    at the sampled token, and on_token may cancel the request."""
    _, eng, _ = q8_engines(monkeypatch, "int8")
    prompt = list(range(5, 45))

    def cancel_at_5(tok, seen=[]):
        seen.append(tok)
        if len(seen) == 5:
            raise StopIteration

    res = eng.generate(prompt, max_new_tokens=12, stop_ids={-1}, seed=3, top_logprobs=4,
                       sampling=SamplingParams(temperature=0.8, top_k=20, top_p=0.95),
                       on_token=cancel_at_5)
    assert len(res.tokens) == 5 and len(res.top_logprobs) == 5
    for tok, lp, top in zip(res.tokens, res.logprobs, res.top_logprobs):
        assert lp <= top[0][1] <= 0.0
        if tok in dict(top):
            assert dict(top)[tok] == pytest.approx(lp)


def test_synthetic_q8_tree_folds_int8_virtual_experts():
    """build_synthetic_engine's parameters at expert_bits=8: the two shared
    experts ride each expert stack as int8 virtual experts, bit-equal to
    slices of the dense shared leaves."""
    cfg = tiny_config("deepseek-v2-lite", **Q8_OVERRIDES)
    params = init_synthetic_params(cfg, QuantConfig(expert_bits=8, group_size=128), seed=0)
    lp = params["layers"][1]
    E, I = cfg.n_routed_experts, cfg.moe_intermediate_size
    assert lp["w13"].bits == lp["w2"].bits == 8
    assert lp["w13"].q.shape == (E + 2, cfg.hidden_size, 2 * I)
    assert lp["w2"].q.shape == (E + 2, I, cfg.hidden_size)
    assert lp["shared_w13"].bits == 8
    for j in range(2):
        assert torch.equal(lp["w13"].q[E + j, :, :I], lp["shared_w13"].q[:, j * I:(j + 1) * I])
        assert torch.equal(lp["w2"].q[E + j], lp["shared_w2"].q[j * I:(j + 1) * I])


def test_bridge_carries_the_q8_tree(monkeypatch):
    jeng, eng, _ = q8_engines(monkeypatch, "int8")
    jl, pl = jeng.params["pattern"][0], eng.params["layers"][1]
    assert pl["w13"].bits == 8 and pl["w13"].q.dtype == torch.int8
    assert pl["w13"].q.shape[0] == eng.cfg.n_routed_experts + 2
    assert np.array_equal(pl["w13"].q.numpy(), np.asarray(jl["w13"].q[0]))
    assert np.array_equal(pl["w2"].scales.view(torch.int16).numpy(),
                          np.asarray(jl["w2"].scales[0]).view(np.int16))
