"""The port's ``BatchScheduler`` with speculative decoding (MTP drafts and
prompt lookup) against the JAX package's on the CPU.

Greedy streams through 2-slot spec schedulers must equal the port's
vanilla ``Engine.generate`` of the same ids and the JAX spec scheduler's
(or, for a prefix-reuse turn, the JAX spec engine's), on the tiny
configurations and tie-free prompts of ``torch_spec_util``. A slot near
the cache's end writes a verify step's rows past it, which are dropped
without a host sync (``kv_cache.store_rows``, ``spec_ngram.put_history``).

Every queue read has a timeout, so a hang fails instead of eating the clock.
"""

import numpy as np
import pytest
import torch

from krasis_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from krasis_tpu.runtime.scheduler import BatchScheduler as JaxBatchScheduler
from krasis_tpu_torch.ops.sampling import SamplingParams
from krasis_tpu_torch.runtime.kv_cache import cache_rows, store_rows
from krasis_tpu_torch.runtime.scheduler import BatchScheduler

from torch_spec_util import (GREEDY, NEW, NO_STOP, SEEDS, Models, greedy, min_top2_gap, prompt,
                             spec_env)

MAX_LEN = 256
TIMEOUT = 120
# a stream's logprobs against the vanilla batch-1 engine's: the two packages
# and the two batch widths round bf16 products in other orders
LP_TOL = 5e-3


class Schedulers(Models):
    """``Models`` plus the JAX spec schedulers, one per (configuration,
    mode, depth), built under that environment."""

    def __init__(self):
        super().__init__()
        self._sched = {}

    def jax_scheduler(self, name, mode, k):
        if (name, mode, k) not in self._sched:
            jcfg, jquant, jparams = self.get(name)[:3]
            with spec_env(mode, k):
                s = JaxBatchScheduler(jcfg, jquant, jparams, max_len=MAX_LEN, num_slots=2)
            assert s.spec_mode == mode and s.spec_k == k
            self._sched[(name, mode, k)] = s
        return self._sched[(name, mode, k)]

    def jax_streams(self, name, mode, k, prompts, new=NEW):
        sch = self.jax_scheduler(name, mode, k)
        reqs = [sch.submit(ids, max_new_tokens=new,
                           sampling=JaxSamplingParams(temperature=0.0), stop_ids=NO_STOP)
                for ids in prompts]
        return [drain(r) for r in reqs]

    def close(self):
        for s in self._sched.values():
            s.shutdown()


@pytest.fixture(scope="module")
def models():
    m = Schedulers()
    yield m
    m.close()


def drain(req, timeout=TIMEOUT):
    toks = []
    while True:
        t = req.out_queue.get(timeout=timeout)
        if t is None:
            assert getattr(req, "error", None) is None, req.error
            return toks
        toks.append(t)


def scheduler(models, name, mode, k, max_len=MAX_LEN, **kw):
    cfg, quant, params = models.port(name)
    with spec_env(mode, k):
        return BatchScheduler(cfg, quant, params, max_len=max_len, num_slots=2,
                              device="cpu", **kw)


def streams(sch, prompts, new=NEW, sampling=GREEDY):
    reqs = [sch.submit(ids, max_new_tokens=new, sampling=sampling, stop_ids=NO_STOP,
                       want_logprobs=True) for ids in prompts]
    return [drain(r) for r in reqs], reqs


@pytest.mark.parametrize("name,mode,k", [("v2-lite", "mtp", 1), ("v2-lite", "mtp", 2),
                                         ("qwen3-moe", "mtp", 1), ("hybrid", "ngram", 3)])
def test_spec_streams_equal_engine_and_jax(models, name, mode, k):
    """Three requests on two slots (queueing, slot reuse, a fresh MTP cache
    a slot): each greedy stream equals the vanilla engine's and the JAX spec
    scheduler's, with logprobs within LP_TOL of the engine's; every step
    counted commits at least one token."""
    prompts = [prompt(s) for s in SEEDS[name][:3]]
    eng = models.engine(name, mode="off")
    want = [greedy(eng, ids, NEW, spec=False) for ids in prompts]
    sch = scheduler(models, name, mode, k)
    assert sch.spec_mode == mode and sch.spec_k == k
    try:
        got, reqs = streams(sch, prompts)
        stats = dict(sch.stats_spec)
    finally:
        sch.shutdown()
    assert got == [w.tokens for w in want] == models.jax_streams(name, mode, k, prompts)
    for r, w in zip(reqs, want):
        np.testing.assert_allclose(r.logprobs[:NEW], w.logprobs, atol=LP_TOL)
    assert 0 < stats["steps"] and stats["accepted"] >= 0


def test_mixed_sampling_and_prefix_reuse(models):
    """A sampled and a greedy slot share the verify steps: the greedy stream
    stays the vanilla one. Then a turn that extends the greedy request
    resumes after its cached prefix, the MTP cache clamped to it, and
    equals the vanilla engine's and the JAX spec engine's stream."""
    ids = prompt(SEEDS["v2-lite"][0])
    eng = models.engine("v2-lite", mode="off")
    ref = greedy(eng, ids, 8, spec=False).tokens
    sch = scheduler(models, "v2-lite", "mtp", 1)
    try:
        rs = sch.submit(prompt(SEEDS["v2-lite"][1]), max_new_tokens=8,
                        sampling=SamplingParams(temperature=0.9), stop_ids=NO_STOP)
        rg = sch.submit(ids, max_new_tokens=8, sampling=GREEDY, stop_ids=NO_STOP)
        s_toks, g_toks = drain(rs), drain(rg)
        assert g_toks == ref and len(s_toks) == 8
        turn2 = ids + ref[:3] + [5]
        reused = sch.stats["prefix_reused_tokens"]
        got = drain(sch.submit(turn2, max_new_tokens=6, sampling=GREEDY, stop_ids=NO_STOP))
        reused = sch.stats["prefix_reused_tokens"] - reused
    finally:
        sch.shutdown()
    want = greedy(eng, turn2, 6, spec=False).tokens
    jeng = models.jax_engine("v2-lite")
    jeng.spec_k = 1
    assert reused > 0
    assert got == want == greedy(jeng, turn2, 6, spec=True).tokens
    assert min_top2_gap(eng, turn2, want) > 0.02


@pytest.mark.parametrize("name,mode,k", [("v2-lite", "mtp", 3), ("qwen3-moe", "ngram", 3),
                                         ("hybrid", "ngram", 2)])
def test_slot_at_the_cache_end(models, name, mode, k):
    """max_len = prompt + NEW + 1: the request's NEW tokens fit, and the
    verify steps of its last block write up to (k + 1)·decode_block rows
    past the cache's end (the main and MTP caches and the token history),
    which are dropped. The stream equals the vanilla engine's on a long
    cache, and the scheduler answers the next request."""
    prompts = [prompt(s) for s in SEEDS[name][:2]]
    eng = models.engine(name, mode="off")
    want = [greedy(eng, ids, NEW, spec=False).tokens for ids in prompts]
    sch = scheduler(models, name, mode, k, max_len=len(prompts[0]) + NEW + 1)
    try:
        got = [drain(sch.submit(ids, max_new_tokens=4 * NEW, sampling=GREEDY,
                                stop_ids=NO_STOP)) for ids in prompts]
    finally:
        sch.shutdown()
    assert got == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
def test_decode_rows_past_the_end_are_dropped(dtype):
    """A verify step's rows [B, n] in decode form (no host sync): rows at or
    past the end are dropped, the kept ones land as the prefill form lands
    them, and a kept row on the last position wins over dropped ones
    clamped onto it."""
    S, D = 6, 16
    buf = torch.randn((2, 1, S, D)).to(dtype)
    ref = buf.clone()
    rows = torch.randn((2, 4, D))
    pos = torch.tensor([[3, 4, 5, 6], [5, 6, 7, 8]])
    at = cache_rows(pos, S, decode=True)
    assert at.take is None and at.keep.tolist() == [[True, True, True, False],
                                                    [True, False, False, False]]
    store_rows(buf, at, rows, head=0)
    store_rows(ref, cache_rows(pos, S, decode=False), rows, head=0)
    assert torch.equal(buf.view(torch.uint8), ref.view(torch.uint8))


def test_spec_admission_oom_retry_halves_chunk(models, monkeypatch):
    """A spec admission chunk that runs the card out of memory restarts the
    admission on fresh caches, the MTP module's included, with half the
    chunk; the stream stays the vanilla one."""
    from krasis_tpu_torch.runtime import engine as engine_mod

    real, raised = engine_mod.spec_prefill, []

    def failing(*a, **kw):
        if not raised:
            raised.append(1)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (raised by the test)")
        return real(*a, **kw)
    monkeypatch.setattr(engine_mod, "spec_prefill", failing)
    ids = prompt(SEEDS["v2-lite"][1])
    want = greedy(models.engine("v2-lite", mode="off"), ids, NEW, spec=False).tokens
    sch = scheduler(models, "v2-lite", "mtp", 1)
    try:
        sch.chunk = 256
        got = drain(sch.submit(ids, max_new_tokens=NEW, sampling=GREEDY, stop_ids=NO_STOP))
    finally:
        sch.shutdown()
    assert raised and sch.chunk == 128 and got == want
