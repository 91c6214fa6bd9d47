"""Prompt-lookup speculative decoding in the port (``models/spec_ngram.py``,
``ops/deltanet.delta_state_update``, ``models/model.la_spec_commit``)
against the JAX package on the CPU.

The drafting function, the DeltaNet replay and the commit of a verify step
are held to the JAX package's functions on the same inputs; the engine's
greedy streams under prompt lookup are held equal to the port's vanilla
greedy streams and to the JAX engine's spec streams, on the tiny hybrid
(DeltaNet + GQA) and a tiny qwen3-moe, on prompts free of near-ties
(``torch_spec_util``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.models.model import la_spec_commit as jax_la_spec_commit
from krasis_tpu.models.spec_ngram import ngram_draft as jax_ngram_draft
from krasis_tpu.ops.deltanet import delta_state_update as jax_delta_state_update
from krasis_tpu_torch.models.model import forward, la_spec_commit
from krasis_tpu_torch.models.spec_ngram import ngram_draft, put_history
from krasis_tpu_torch.ops.deltanet import delta_state_update, gated_delta_rule_recurrent
from krasis_tpu_torch.ops.sampling import SamplingParams

from torch_port_util import f32, t
from torch_spec_util import (NEW, NO_STOP, SEEDS, Models, greedy, min_top2_gap, prompt,
                             spec_env)


@pytest.fixture(scope="module")
def models():
    return Models()


# ---- delta_state_update and la_spec_commit --------------------------------


def _replay_inputs(seed, B=2, S=6, Hk=2, Hv=4, dk=8, dv=8):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(B, S, Hk, dk)).astype(np.float32)
    v = rng.normal(size=(B, S, Hv, dv)).astype(np.float32)
    g = -np.abs(rng.normal(size=(B, S, Hv))).astype(np.float32)
    beta = rng.uniform(0.1, 0.9, size=(B, S, Hv)).astype(np.float32)
    q = rng.normal(size=(B, S, Hk, dk)).astype(np.float32)
    s0 = rng.normal(size=(B, Hv, dk, dv)).astype(np.float32)
    return q, k, v, g, beta, s0


@pytest.mark.parametrize("n", [6, 4, 1, 0])
def test_delta_state_update_matches_jax(n):
    """A window with its tail past `n` masked (g = beta = 0): the port's
    replay equals the JAX package's within 1e-5, and equals the recurrence
    over the prefix alone bit for bit (the masked positions are no-ops)."""
    q, k, v, g, beta, s0 = _replay_inputs(n)
    mask = (np.arange(k.shape[1]) < n)[None, :, None]
    gm, bm = np.where(mask, g, 0.0), np.where(mask, beta, 0.0)
    got = delta_state_update(t(k), t(v), t(gm), t(bm), t(s0))
    want = jax_delta_state_update(*(jnp.asarray(a) for a in (k, v, gm, bm, s0)))
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    prefix = t(s0) if n == 0 else gated_delta_rule_recurrent(
        t(q[:, :n]), t(k[:, :n]), t(v[:, :n]), t(g[:, :n]), t(beta[:, :n]), t(s0))[1]
    assert torch.equal(got, prefix)


def _stash(seed, B=3, S=4, Hk=2, Hv=4, dk=8, dv=8, K=4):
    """One DeltaNet layer's cache after a verify step: the pre-window state
    and conv window and the replay stash, as numpy."""
    rng = np.random.default_rng(seed)
    C = 2 * Hk * dk + Hv * dv
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))          # noqa: E731
    return {"state": rng.normal(size=(B, Hv, dk, dv)).astype(np.float32),
            "conv": bf(rng.normal(size=(B, K - 1, C))),
            "p_k": bf(rng.normal(size=(B, S, Hk, dk))),
            "p_v": bf(rng.normal(size=(B, S, Hv, dv))),
            "p_g": -np.abs(rng.normal(size=(B, S, Hv))).astype(np.float32),
            "p_b": rng.uniform(0.1, 0.9, size=(B, S, Hv)).astype(np.float32),
            "p_x": bf(rng.normal(size=(B, S, C)))}


@pytest.mark.parametrize("ncommit", [(1, 3, 4), (4, 4, 4), (1, 1, 2)])
def test_la_spec_commit_matches_jax(ncommit):
    """Each row's committed prefix replayed onto its state and conv window:
    the state within 1e-5 of the JAX package's, the conv window equal, the
    stash dropped, and a layer without a stash (GQA) left as it was."""
    lc = _stash(sum(ncommit))
    gqa = {"k": np.zeros((3, 2, 8, 128), np.float32)}
    nc = np.asarray(ncommit, np.int32)
    want = jax_la_spec_commit({"prefix_layers": [{k: jnp.asarray(v) for k, v in lc.items()}],
                               "pattern": [], "length": jnp.zeros((3,), jnp.int32)},
                              jnp.asarray(nc))["prefix_layers"][0]
    cache = {"layers": [{k: t(v) for k, v in lc.items()}, {"k": t(gqa["k"])}],
             "length": torch.zeros(3, dtype=torch.int32)}
    la_spec_commit(cache, torch.tensor(nc))
    got = cache["layers"][0]
    assert set(got) == {"state", "conv"} and set(cache["layers"][1]) == {"k"}
    np.testing.assert_allclose(f32(got["state"]), np.asarray(want["state"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(f32(got["conv"]), np.asarray(want["conv"], np.float32))
    assert got["conv"].dtype == torch.bfloat16


# ---- ngram_draft -----------------------------------------------------------


@pytest.mark.parametrize("k,n_max", [(1, 3), (3, 3), (2, 2), (4, 1)])
def test_ngram_draft_matches_jax_on_random_histories(k, n_max):
    """200 random histories over 4 ids (matches of every length are common),
    each at a random committed length, stale ids past it."""
    rng = np.random.default_rng(k * 10 + n_max)
    hist = rng.integers(0, 4, size=(200, 40)).astype(np.int32)
    hlen = rng.integers(1, 41, size=(200,)).astype(np.int32)
    want = np.asarray(jax_ngram_draft(jnp.asarray(hist), jnp.asarray(hlen), k, n_max))
    got = ngram_draft(torch.tensor(hist, dtype=torch.int64), torch.tensor(hlen), k, n_max)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hist,hlen,k,n_max,want", [
    # the longest gram (1, 2, 3) matches at 0 and 4: the most recent wins
    ([1, 2, 3, 9, 1, 2, 3, 7, 5, 1, 2, 3] + [0] * 4, 12, 2, 3, [7, 5]),
    # (8, 4) at 2 beats the later 1-gram match of (4,)
    ([9, 9, 8, 4, 6, 4, 1, 8, 4] + [0] * 7, 9, 1, 2, [6]),
    # no match: the last id repeated
    ([1, 2, 3, 4, 5] + [0] * 11, 5, 3, 3, [5, 5, 5]),
    # stale ids past hlen make no match
    ([1, 2, 3, 4, 1, 2, 1, 2, 9] + [0] * 7, 6, 1, 3, [3]),
])
def test_ngram_draft_cases(hist, hlen, k, n_max, want):
    """The reference's four cases (tests/test_spec_ngram.py), in both packages."""
    got = ngram_draft(torch.tensor([hist]), torch.tensor([hlen]), k, n_max)[0].tolist()
    ref = np.asarray(jax_ngram_draft(jnp.asarray([hist], jnp.int32),
                                     jnp.asarray([hlen], jnp.int32), k, n_max))[0].tolist()
    assert got == ref == want


def test_put_history_drops_past_the_end():
    """Writes at or past the history's end are dropped, never raised on; a
    kept write on the last position wins over the dropped ones there."""
    hist = torch.arange(16, dtype=torch.int64).reshape(2, 8)
    put_history(hist, torch.tensor([[6, 7, 8, 9], [1, 2, 3, 4]]),
                torch.tensor([[60, 70, 80, 90], [10, 20, 30, 40]]))
    assert hist.tolist() == [[0, 1, 2, 3, 4, 5, 60, 70], [8, 10, 20, 30, 40, 13, 14, 15]]
    put_history(hist, torch.tensor([[8, 9, 10, 11], [7, 8, 9, 10]]),
                torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]]))
    assert hist.tolist() == [[0, 1, 2, 3, 4, 5, 60, 70], [8, 10, 20, 30, 40, 13, 14, 5]]


# ---- the engine -------------------------------------------------------------


def _jax_ngram(models, name, k=3):
    jeng = models.jax_engine(name)
    jeng.spec_mode, jeng.spec_k = "ngram", k
    return jeng


@pytest.mark.parametrize("name,seed", [("hybrid", SEEDS["hybrid"][0]),
                                       ("hybrid", SEEDS["hybrid"][1]),
                                       ("qwen3-moe", SEEDS["qwen3-moe"][0])])
def test_ngram_greedy_equals_vanilla_and_jax(models, name, seed):
    """The spec stream equals the port's vanilla stream and the JAX
    engine's spec stream, its logprobs within 2e-3 of the vanilla ones."""
    ids = prompt(seed)
    eng = models.engine(name, mode="ngram", k=3)
    assert eng.spec_mode == "ngram" and eng.spec_k == 3
    want = greedy(eng, ids, NEW, spec=False)
    assert eng.last_spec_stats is None
    got = greedy(eng, ids, NEW, spec=True)
    assert eng.last_spec_stats["emitted"] == NEW and eng.last_spec_stats["steps"] >= 1
    jgot = greedy(_jax_ngram(models, name), ids, NEW, spec=True)
    assert got.tokens == want.tokens == jgot.tokens
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=2e-3)
    assert min_top2_gap(eng, ids, want.tokens) > 0.02


def test_ngram_full_acceptance_state_equals_vanilla(models):
    """A model whose greedy token is always 0 (the head's scales zeroed):
    the lookup then drafts zeros and steps commit k + 1; every DeltaNet
    layer's state and conv window after a run equal the vanilla run's over
    the same number of tokens."""
    cfg, quant, params = models.port("hybrid")
    head = params["lm_head"]
    zeroed = {**params, "lm_head": type(head)(head.q, head.scales * 0, head.bits,
                                              head.group_size)}
    from krasis_tpu_torch.runtime.engine import Engine

    with spec_env("ngram", 2):
        eng = Engine(cfg, quant, zeroed, max_len=512, device="cpu")
    ids = [5, 6, 7, 8]
    got = greedy(eng, ids, 24, spec=True)
    stats = eng.last_spec_stats
    assert got.tokens == [0] * 24
    assert stats["accepted"] >= stats["emitted"] // 2, stats
    # the spec run's cache holds the prompt and every committed token but
    # the last: replay the same count through one-row decode steps
    fed = int(eng.cache["length"][0]) - len(ids)
    spec_layers = [dict(lc) for lc in eng.cache["layers"] if "state" in lc]
    eng.reset()
    with torch.inference_mode():
        eng._prefill_prompt(ids)
        for _ in range(fed):
            eng._forward(torch.zeros((1, 1), dtype=torch.int64),
                         torch.ones(1, dtype=torch.int32), prefill=False)
    for a, b in zip(spec_layers, [lc for lc in eng.cache["layers"] if "state" in lc]):
        torch.testing.assert_close(a["state"], b["state"], rtol=1e-5, atol=1e-5)
        assert torch.equal(a["conv"], b["conv"])


def test_verify_step_commits_prefix_state(models):
    """One verify step on the hybrid with its first two drafts right and the
    third wrong: it commits three tokens, which equal the vanilla greedy
    ones, and every DeltaNet layer's state and conv window equal the
    one-row decode of those three from the same state."""
    from krasis_tpu_torch.models.mtp import verify_and_sample

    eng = models.engine("hybrid", mode="ngram", k=3)
    ids = prompt(SEEDS["hybrid"][2])
    want = greedy(eng, ids, 5, spec=False).tokens
    one = torch.ones(1, dtype=torch.int32)
    with torch.inference_mode():
        eng.reset()
        eng._prefill_prompt(ids)
        vanilla = {"layers": [{k: v.clone() for k, v in lc.items()}
                              for lc in eng.cache["layers"]],
                   "length": eng.cache["length"].clone()}
        drafts = torch.tensor([[want[1], want[2], (want[3] + 1) % 256]])
        toks = torch.cat([torch.tensor([[want[0]]]), drafts], dim=1)
        logits = forward(eng.params, toks, torch.tensor([4], dtype=torch.int32), eng.cache,
                         eng.cfg, eng.quant, prefill=False, return_all_logits=True,
                         spec_la=True)
        assert any("p_k" in lc for lc in eng.cache["layers"])
        z = torch.zeros(1)
        ts, _, ncommit = verify_and_sample(logits, drafts, None,
                                           torch.zeros((1, 256), dtype=torch.bool), z,
                                           torch.ones(1), z, torch.zeros(1, dtype=torch.int32))
        la_spec_commit(eng.cache, ncommit)
        assert int(ncommit[0]) == 3 and ts[0, :3].tolist() == want[1:4]
        for tok in want[:3]:
            forward(eng.params, torch.tensor([[tok]]), one, vanilla, eng.cfg, eng.quant,
                    prefill=False)
    for a, b in zip(eng.cache["layers"], vanilla["layers"]):
        assert set(a) == set(b)
        if "state" in a:
            torch.testing.assert_close(a["state"], b["state"], rtol=1e-5, atol=1e-5)
            assert torch.equal(a["conv"], b["conv"])


def test_ngram_sampled_same_seed_same_stream(models):
    eng = models.engine("hybrid", mode="ngram", k=3)
    sp = SamplingParams(temperature=0.9, top_k=20, top_p=0.9)
    a = eng.generate([3, 1, 4, 1, 5, 3, 1, 4], max_new_tokens=16, sampling=sp,
                     stop_ids=NO_STOP, seed=7)
    b = eng.generate([3, 1, 4, 1, 5, 3, 1, 4], max_new_tokens=16, sampling=sp,
                     stop_ids=NO_STOP, seed=7)
    assert a.tokens == b.tokens and len(a.tokens) == 16 and eng.last_spec_stats is not None
