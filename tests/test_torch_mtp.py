"""The port's MTP speculative decoding (``models/mtp.py`` and the
``Engine``'s spec path) against the JAX package on the CPU.

``spec_config`` and ``mtp_forward`` are held to the JAX package's on the
same environment and weights; the verify step's accept and reject branches
and the sampled replay are pinned on the port alone; and the engine's greedy
streams through MTP drafts (MLA at k = 1, 2 and 3, GQA, chunked prefill,
the near-max_len fallback) are held equal to the port's vanilla streams
and to the JAX engine's spec streams, on prompts free of near-ties
(``torch_spec_util``).
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.models import mtp as jax_mtp
from krasis_tpu.runtime.kv_cache import init_mtp_cache as jax_init_mtp_cache
from krasis_tpu_torch.models import mtp
from krasis_tpu_torch.models.model import forward
from krasis_tpu_torch.ops.sampling import SamplingParams, sample_batched
from krasis_tpu_torch.runtime.engine import Engine
from krasis_tpu_torch.runtime.kv_cache import init_mtp_cache

from torch_port_util import f32, t
from torch_spec_util import (GREEDY, NEW, NO_STOP, SEEDS, Models, greedy, min_top2_gap,
                             prompt)

SPEC_ENV = ("KRASIS_TPU_SPEC_MODE", "KRASIS_TPU_NO_SPEC", "KRASIS_TPU_SPEC_K")
CHUNKED_SEED = 57      # a 200-id prompt whose 6 greedy steps keep a top-two gap of 0.18


@pytest.fixture(scope="module")
def models():
    return Models()


# ---- spec_config -----------------------------------------------------------


@pytest.mark.parametrize("mode,no_spec,k", list(itertools.product(
    (None, "auto", "mtp", "ngram", "off", "NGRAM"), (None, "1"), (None, "0", "2", "5"))))
def test_spec_config_equals_jax(models, monkeypatch, mode, no_spec, k):
    """Every combination of the three environment names, on a model with
    an MTP module, one whose parameters lack it, and a hybrid."""
    for name, value in zip(SPEC_ENV, (mode, no_spec, k)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    for name in ("v2-lite", "hybrid"):
        jcfg, _, jparams, cfg, _, params = models.get(name)
        for jp, p in ((jparams, params), ({}, {})):
            assert mtp.spec_config(cfg, p) == jax_mtp.spec_config(jcfg, jp)


def test_engine_reads_the_spec_environment(models, monkeypatch):
    """The engine's mode and depth are spec_config's, read from the
    environment when it is built: KRASIS_TPU_NO_SPEC turns an MTP model's
    auto mode off, KRASIS_TPU_SPEC_MODE / KRASIS_TPU_SPEC_K set them, and a
    hybrid never takes mtp."""
    monkeypatch.setenv("KRASIS_TPU_NO_SPEC", "1")
    cfg, quant, params = models.port("v2-lite")
    eng = Engine(cfg, quant, params, max_len=64, device="cpu")
    assert (eng.spec_mode, eng.spec_k, eng.spec_available) == (None, 1, False)
    assert eng.mtp_cache is None
    assert (models.engine("v2-lite", mode="mtp", k=3).spec_mode,
            models.engine("v2-lite", mode="mtp", k=3).spec_k) == ("mtp", 3)
    eng = models.engine("v2-lite", mode="ngram")
    assert (eng.spec_mode, eng.spec_k) == ("ngram", 3) and eng.mtp_cache is None
    assert models.engine("hybrid", mode="mtp").spec_available is False


# ---- mtp_forward -------------------------------------------------------------


@pytest.mark.parametrize("name", ["v2-lite", "qwen3-moe"])
def test_mtp_forward_matches_jax(models, name):
    """The module over a 16-row prefill chunk (15 valid rows, its own
    fresh rows), then a decode row at the cache's length: logits within
    2e-2 of the JAX package's, and the lengths advanced alike."""
    jcfg, jquant, jparams, cfg, quant, params = models.get(name)
    rng = np.random.default_rng(5)
    H, V = cfg.hidden_size, cfg.vocab_size
    toks = rng.integers(1, V, size=(1, 16)).astype(np.int32)
    hid = np.asarray(jnp.asarray(rng.normal(size=(1, 16, H)), jnp.bfloat16))
    tok1 = rng.integers(1, V, size=(1, 1)).astype(np.int32)
    hid1 = np.asarray(jnp.asarray(rng.normal(size=(1, 1, H)), jnp.bfloat16))
    jc = jax_init_mtp_cache(jcfg, jquant, 1, 64)
    c = init_mtp_cache(cfg, quant, 1, 64, "cpu")
    seq = np.asarray([15], np.int32)

    @functools.partial(jax.jit, static_argnums=(5,))
    def jax_fn(p, tk, sl, h, cache, prefill):
        return jax_mtp.mtp_forward(p, tk, sl, h, cache, jcfg, jquant, prefill=prefill,
                                   return_all_logits=not prefill)
    jl, jc = jax_fn(jparams, jnp.asarray(toks), jnp.asarray(seq), jnp.asarray(hid), jc, True)
    with torch.inference_mode():
        pl = mtp.mtp_forward(params, t(toks).long(), t(seq), t(hid), c, cfg, quant,
                             prefill=True)
        one = np.ones((1,), np.int32)
        jl1, jc = jax_fn(jparams, jnp.asarray(tok1), jnp.asarray(one), jnp.asarray(hid1), jc,
                         False)
        pl1, ph1 = mtp.mtp_forward(params, t(tok1).long(), t(one), t(hid1), c, cfg, quant,
                                   prefill=False, return_all_logits=True, return_hidden=True)
    for got, want in ((pl, jl), (pl1, jl1)):
        np.testing.assert_allclose(f32(got), np.asarray(want), atol=2e-2)
    assert int(c["length"][0]) == int(jc["length"][0]) == 16
    assert tuple(ph1.shape) == (1, 1, H)


# ---- the verify step ---------------------------------------------------------


def _greedy_args(B, V):
    z = torch.zeros(B)
    return (torch.zeros((B, V), dtype=torch.bool), z, torch.ones(B), z,
            torch.zeros(B, dtype=torch.int32))


def test_verify_and_sample_branches_on_fixed_logits():
    """Greedy rows on fixed logits: a row whose drafts all equal the argmax
    commits k + 1, one whose first draft is wrong 1, one wrong at the
    second draft 2; each committed token joins seen, the rest do not. The
    JAX package's verify gives the same tokens, counts and logprobs."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 3, 32)).astype(np.float32)
    top = logits.argmax(-1)
    drafts = np.stack([top[0, :2], [(top[1, 0] + 1) % 32, top[1, 1]],
                       [top[2, 0], (top[2, 1] + 1) % 32]]).astype(np.int32)
    seen, temp, top_p, pres, top_k = _greedy_args(3, 32)
    ts, lps, nc = mtp.verify_and_sample(t(logits), t(drafts).long(), None, seen, temp, top_p,
                                        pres, top_k)
    assert nc.tolist() == [3, 1, 2]
    assert ts.tolist() == top.tolist()
    assert [sorted(torch.nonzero(r)[:, 0].tolist()) for r in seen] == [
        sorted(set(top[0])), [top[1, 0]], sorted(set(top[2, :2]))]
    jts, jlps, jnc, _, _ = jax_mtp.verify_and_sample(
        jnp.asarray(logits), jnp.asarray(drafts), jax.random.PRNGKey(0),
        jnp.zeros((3, 32), jnp.bool_), jnp.zeros(3), jnp.ones(3), jnp.zeros(3),
        jnp.zeros(3, jnp.int32), max_top_k=32)
    assert np.asarray(jts).tolist() == ts.tolist() and np.asarray(jnc).tolist() == nc.tolist()
    np.testing.assert_allclose(f32(lps), np.asarray(jlps), rtol=1e-6, atol=1e-6)


def _prefilled(eng, ids, k):
    """The engine's caches after the MTP prefill of `ids` and the first
    draft chain; returns (t1, its drafts)."""
    eng.spec_k = k
    eng.reset(eng.max_len)
    logits, h_last = eng._prefill_prompt(ids, mtp=True)
    t1 = torch.argmax(logits, dim=-1)
    return t1, mtp.first_draft(eng.params, t1, h_last, eng.mtp_cache, eng.cfg, eng.quant, k)


def _step(eng, tok, drafts, V):
    return mtp.spec_decode_block(eng.params, tok, drafts, eng.cache, eng.mtp_cache, eng.cfg,
                                 eng.quant, 1, None, *_greedy_args(1, V))


@pytest.mark.parametrize("k,right", [(1, 1), (1, 0), (2, 2), (2, 1), (3, 3), (3, 0)])
def test_verify_step_commits_the_matching_prefix(models, k, right):
    """One verify step with its first `right` drafts equal to the vanilla
    greedy tokens and the next one wrong: it commits right + 1 tokens, the
    vanilla ones, and both caches end right + 1 past the prompt."""
    eng = models.engine("v2-lite", mode="mtp", k=k)
    ids = prompt(SEEDS["v2-lite"][0])
    want = greedy(eng, ids, k + 2, spec=False).tokens
    V = eng.cfg.vocab_size
    with torch.inference_mode():
        t1, _ = _prefilled(eng, ids, k)
        assert int(t1[0]) == want[0]
        d = want[1:1 + k]
        if right < k:
            d[right] = (d[right] + 1) % V
        ts, _, nc, finite, nxt, drafts = _step(eng, t1, torch.tensor([d]), V)
    n = right + 1
    assert int(nc[0, 0]) == n and bool(finite)
    assert ts[0, 0, :n].tolist() == want[1:1 + n] and int(nxt[0]) == want[n]
    assert int(eng.cache["length"][0]) == int(eng.mtp_cache["length"][0]) == len(ids) + n
    assert tuple(drafts.shape) == (1, k)


def test_rejected_rows_are_overwritten(models):
    """A rejected draft leaves a stale row; the next verify step, from the
    rolled-back length, overwrites it and stays on the vanilla stream."""
    eng = models.engine("v2-lite", mode="mtp", k=1)
    ids = prompt(SEEDS["v2-lite"][1])
    want = greedy(eng, ids, 4, spec=False).tokens
    V = eng.cfg.vocab_size
    with torch.inference_mode():
        t1, _ = _prefilled(eng, ids, 1)
        _, _, nc, _, nxt, _ = _step(eng, t1, torch.tensor([[(want[1] + 1) % V]]), V)
        assert int(nc[0, 0]) == 1 and int(nxt[0]) == want[1]
        ts, _, nc, _, _, _ = _step(eng, nxt, torch.tensor([[want[2]]]), V)
    assert int(nc[0, 0]) == 2 and ts[0, 0].tolist() == want[2:4]


def test_sampled_verify_replays_the_vanilla_draws(models):
    """Sampled verify steps draw from the generator as vanilla steps do:
    replaying the verify step's generator state through two one-row decode
    steps (presence penalty on, so `seen` threads through) gives the same
    tokens, on the accept and the reject branch."""
    eng = models.engine("v2-lite", mode="mtp", k=1)
    ids = prompt(SEEDS["v2-lite"][2])
    V = eng.cfg.vocab_size
    temp, top_p = torch.ones(1), torch.ones(1)
    pres, top_k = torch.full((1,), 0.3), torch.zeros(1, dtype=torch.int32)
    gen = torch.Generator().manual_seed(11)
    start = gen.get_state()
    one = torch.ones(1, dtype=torch.int32)
    with torch.inference_mode():
        t1, _ = _prefilled(eng, ids, 1)
        seen = torch.zeros((1, V), dtype=torch.bool)
        seen[0, t1] = True
        s1 = seen.clone()
        l1 = forward(eng.params, t1[:, None], one, eng.cache, eng.cfg, eng.quant, False)
        x1 = sample_batched(l1, temp, top_p, pres, s1, top_k, V, gen)
        s1[0, x1] = True
        l2 = forward(eng.params, x1[:, None], one, eng.cache, eng.cfg, eng.quant, False)
        x2 = sample_batched(l2, temp, top_p, pres, s1, top_k, V, gen)

        def spec_step(draft):
            _prefilled(eng, ids, 1)
            gen.set_state(start)
            return mtp.spec_decode_block(eng.params, t1, torch.tensor([[draft]]), eng.cache,
                                         eng.mtp_cache, eng.cfg, eng.quant, 1, gen,
                                         seen.clone(), temp, top_p, pres, top_k, V)
        ts, _, nc, _, nxt, _ = spec_step(int(x1[0]))
        assert int(nc[0, 0]) == 2 and ts[0, 0].tolist() == [int(x1[0]), int(x2[0])]
        ts, _, nc, _, nxt, _ = spec_step((int(x1[0]) + 1) % V)
        assert int(nc[0, 0]) == 1 and int(ts[0, 0, 0]) == int(nxt[0]) == int(x1[0])


# ---- the engine ----------------------------------------------------------------


def _jax_spec(models, name, k, max_len=512):
    jeng = models.jax_engine(name, max_len)
    assert jeng.spec_mode == "mtp"
    jeng.spec_k = k
    return jeng


@pytest.mark.parametrize("name,k,seed", [
    ("v2-lite", 1, SEEDS["v2-lite"][0]), ("v2-lite", 2, SEEDS["v2-lite"][2]),
    ("v2-lite", 3, SEEDS["v2-lite"][3]), ("qwen3-moe", 1, SEEDS["qwen3-moe"][0])])
def test_spec_greedy_equals_vanilla_and_jax(models, name, k, seed):
    """MLA and GQA: the spec stream equals the port's vanilla stream and the
    JAX engine's spec stream; its logprobs within 2e-3 of the vanilla ones;
    the stats count every token."""
    ids = prompt(seed)
    eng = models.engine(name, mode="mtp", k=k)
    want = greedy(eng, ids, NEW, spec=False)
    got = greedy(eng, ids, NEW, spec=True)
    stats = eng.last_spec_stats
    assert stats["emitted"] == NEW and stats["steps"] >= 1 and got.finite
    jgot = greedy(_jax_spec(models, name, k), ids, NEW, spec=True)
    assert got.tokens == want.tokens == jgot.tokens
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=2e-3)
    assert min_top2_gap(eng, ids, want.tokens) > 0.02


@pytest.mark.parametrize("k", [1, 3])
def test_spec_chunked_prefill(models, k):
    """A 200-id prompt in 128-id chunks: the MTP module's later chunk reads
    its cache, and the stream equals the vanilla and the JAX ones."""
    ids = prompt(CHUNKED_SEED, 200)
    eng = models.engine("v2-lite", mode="mtp", k=k)
    eng.chunk = 128
    want = greedy(eng, ids, 6, spec=False)
    got = greedy(eng, ids, 6, spec=True)
    jeng = _jax_spec(models, "v2-lite", k)
    jeng.chunk = 128
    try:
        jgot = greedy(jeng, ids, 6, spec=True)
    finally:
        jeng.chunk = 2048
    assert got.tokens == want.tokens == jgot.tokens and eng.last_spec_stats is not None
    assert min_top2_gap(eng, ids, want.tokens) > 0.02


def test_spec_near_max_len_falls_back_to_vanilla(models):
    """The spec block's larger overshoot never refuses a request or cuts it
    shorter than vanilla decode would: at 110 of 128 ids (vanilla room 9,
    spec room 1) the request runs the vanilla path, in both packages."""
    eng = models.engine("v2-lite", max_len=128, mode="mtp", k=1)
    ids = (list(range(1, 32)) * 4)[:110]
    res = eng.generate(ids, max_new_tokens=5, sampling=GREEDY, stop_ids=NO_STOP)
    assert len(res.tokens) == 5 and eng.last_spec_stats is None
    jeng = _jax_spec(models, "v2-lite", 1, max_len=128)
    from krasis_tpu.ops.sampling import SamplingParams as JaxSamplingParams

    jres = jeng.generate(ids, max_new_tokens=5, sampling=JaxSamplingParams(temperature=0.0),
                         stop_ids=NO_STOP)
    assert jeng.last_spec_stats is None and jres.tokens == res.tokens


def test_spec_stops_and_streams(models):
    """A stop id ends the stream on it, mid-step, and on_token / on_token_lp
    see exactly the tokens returned."""
    eng = models.engine("v2-lite", mode="mtp", k=3)
    ids = prompt(SEEDS["v2-lite"][3])
    want = greedy(eng, ids, NEW, spec=False).tokens
    stop = want[5]
    seen, lps = [], []
    res = eng.generate(ids, max_new_tokens=NEW, sampling=GREEDY, stop_ids={stop},
                       on_token=seen.append, on_token_lp=lambda tok, lp: lps.append(lp))
    assert res.tokens == want[:want.index(stop) + 1] == seen
    assert lps == res.logprobs and eng.last_spec_stats["emitted"] == len(seen)


def test_spec_sampled_runs_the_spec_path(models):
    eng = models.engine("v2-lite", mode="mtp", k=2)
    res = eng.generate([1, 2, 3], max_new_tokens=8, sampling=SamplingParams(temperature=0.8),
                       stop_ids=NO_STOP, seed=3)
    assert eng.last_spec_stats["emitted"] == len(res.tokens) == 8
    again = eng.generate([1, 2, 3], max_new_tokens=8,
                         sampling=SamplingParams(temperature=0.8), stop_ids=NO_STOP, seed=3)
    assert again.tokens == res.tokens
    # top_logprobs asks for the vanilla path
    eng.generate([1, 2, 3], max_new_tokens=4, stop_ids=NO_STOP, top_logprobs=2)
    assert eng.last_spec_stats is None


def test_spec_prefill_oom_halves_chunk(models, monkeypatch):
    """A spec prefill chunk that runs the card out of memory halves the
    chunk (down to 128) and prefills the prompt again on fresh caches, the
    MTP module's included; the stream stays the vanilla one."""
    from krasis_tpu_torch.runtime import engine as engine_mod

    eng = models.engine("v2-lite", mode="mtp", k=1)
    ids = prompt(SEEDS["v2-lite"][0])
    want = greedy(eng, ids, NEW, spec=False).tokens
    real, raised = engine_mod.spec_prefill, []

    def failing(*a, **kw):
        if len(raised) < 2:
            raised.append(1)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (raised by the test)")
        return real(*a, **kw)
    monkeypatch.setattr(engine_mod, "spec_prefill", failing)
    eng.chunk = 512
    assert greedy(eng, ids, NEW, spec=True).tokens == want
    assert len(raised) == 2 and eng.chunk == 128 and eng.last_spec_stats is not None
