"""The port's continuous batching (``runtime/scheduler.py``) against the JAX
package's ``BatchScheduler`` on the CPU.

Three tiny configurations, the JAX package's weights bridged into the port:
the reference scheduler tests' qwen3-moe (GQA) and hybrid (DeltaNet + GQA),
and a DeepSeek-V2-Lite (MLA); int4 experts at gs 32, a bf16 cache. Greedy
streams must be equal: to the port's ``Engine.generate`` of the same ids, and
to the JAX scheduler's (one per configuration, shared by the module). Tiny
random models have nearly flat logits, so each prompt here is checked free
of top-2 ties over its compared steps (``test_prompts_are_tie_free``).

Every queue read has a timeout, so a hang fails instead of eating the clock.
"""

import queue
import re
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.config import preset_config as jax_preset_config
from krasis_tpu.models.params import init_synthetic_params as jax_init
from krasis_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from krasis_tpu.runtime.scheduler import BatchScheduler as JaxBatchScheduler
from krasis_tpu_torch.config import QuantConfig, preset_config
from krasis_tpu_torch.ops.sampling import SamplingParams
from krasis_tpu_torch.runtime import engine as engine_mod
from krasis_tpu_torch.runtime import scheduler as sched_mod
from krasis_tpu_torch.runtime.engine import Engine
from krasis_tpu_torch.runtime.scheduler import BatchScheduler

from torch_port_util import calm_experts, port_params

CONFIGS = {
    # tests/test_scheduler.py's setup
    "qwen3-moe": ("qwen3-moe", dict(
        hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        vocab_size=256, head_dim=16, n_routed_experts=8, num_experts_per_tok=2)),
    # tests/test_scheduler.py's test_prefix_reuse_hybrid_deltanet
    "hybrid": ("qwen3-coder-next", dict(
        hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        vocab_size=256, head_dim=16,
        layer_types=["linear_attention", "linear_attention", "linear_attention",
                     "full_attention"],
        linear_num_key_heads=2, linear_num_value_heads=4,
        linear_key_head_dim=16, linear_value_head_dim=16,
        n_routed_experts=8, num_experts_per_tok=2, shared_expert_intermediate_size=32)),
    "v2-lite": ("deepseek-v2-lite", dict(
        hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
        num_hidden_layers=2, num_attention_heads=4, kv_lora_rank=32, vocab_size=256,
        n_routed_experts=8, num_experts_per_tok=2)),
}
QUANT = dict(expert_bits=4, group_size=32, kv_cache_dtype="bf16")
MAX_LEN = 256
NEW = 7
GREEDY = SamplingParams(temperature=0.0)
JAX_GREEDY = JaxSamplingParams(temperature=0.0)
NO_STOP = {-1}
TIMEOUT = 120
# the port's logits sit within 0.0074 of the JAX package's on these models
# (0.0049 hybrid, 0.0032 V2-Lite) over these prompts' steps
GAP = 0.02
# four prompts of 8 ids a configuration, seeds chosen so that no step of
# their NEW greedy tokens sits within GAP of a tie
PROMPT_SEEDS = {"qwen3-moe": (29, 39, 44, 48), "hybrid": (7, 16, 21, 28),
                "v2-lite": (3, 7, 18, 19)}
REUSE_SEEDS = {"qwen3-moe": 7, "hybrid": 36}     # 64 ids, tie-free likewise
# Logprobs: the two packages round bf16 products in different orders, which
# moves these models' logits by up to 0.0074 and the chosen tokens' logprobs
# by up to 0.0012; within the port, a row's logprob moves by up to 0.0004
# with the batch it decodes in (CPU matrix products take another order)
LP_TOL = 2e-3


def calm(jparams):
    """``calm_experts`` on every layer: the hybrid's four layers are all
    prefix layers. It scales the expert stacks by 1/8 on both sides, off the
    router near-ties that rounding breaks differently in the two packages."""
    calmed = calm_experts({**jparams, "pattern": jparams["prefix_layers"]})
    return calm_experts({**jparams, "prefix_layers": calmed["pattern"]})


def prompt(seed, n=8):
    return np.random.default_rng(seed).integers(1, 250, size=n).tolist()


class Models:
    """Per configuration: the port's config, quant and params, and the JAX
    BatchScheduler over the same weights, made when first asked for."""

    def __init__(self):
        self._built = {}
        self._jax = {}

    def get(self, name):
        if name not in self._built:
            preset, over = CONFIGS[name]
            jcfg, jquant = jax_preset_config(preset, **over), JaxQuantConfig(**QUANT)
            jparams = calm(jax_init(jcfg, jquant, jax.random.PRNGKey(0)))
            self._built[name] = (jcfg, jquant, jparams, preset_config(preset, **over),
                                 QuantConfig(**QUANT), port_params(jparams))
        return self._built[name]

    def port(self, name):
        return self.get(name)[3:]

    def jax_scheduler(self, name):
        if name not in self._jax:
            jcfg, jquant, jparams = self.get(name)[:3]
            self._jax[name] = JaxBatchScheduler(jcfg, jquant, jparams, max_len=MAX_LEN,
                                                num_slots=2)
        return self._jax[name]

    def jax_stream(self, name, ids, new=NEW, want_logprobs=False):
        req = self.jax_scheduler(name).submit(ids, max_new_tokens=new, sampling=JAX_GREEDY,
                                              stop_ids=NO_STOP, want_logprobs=want_logprobs)
        return drain(req), req.logprobs

    def close(self):
        for s in self._jax.values():
            s.shutdown()


@pytest.fixture(scope="module")
def models():
    m = Models()
    yield m
    m.close()


def drain(req, timeout=TIMEOUT):
    toks = []
    while True:
        t = req.out_queue.get(timeout=timeout)
        if t is None:
            return toks
        toks.append(t)


def scheduler(models, name, **kw):
    cfg, quant, params = models.port(name)
    kw = {"max_len": MAX_LEN, "num_slots": 2, **kw}
    return BatchScheduler(cfg, quant, params, device="cpu", **kw)


def engine(models, name, **kw):
    cfg, quant, params = models.port(name)
    return Engine(cfg, quant, params, max_len=MAX_LEN, device="cpu", **kw)


def min_top2_gap(eng, ids, tokens):
    """Teacher-force `tokens` after `ids` through the port; the smallest gap
    between the two largest logits over the steps."""
    eng.reset()
    gaps = []
    with torch.inference_mode():
        logits = eng._prefill_prompt(ids)
        for tok in tokens:
            top = torch.topk(logits[0], 2).values
            gaps.append(float(top[0] - top[1]))
            logits = eng._forward(torch.tensor([[tok]]), torch.ones(1, dtype=torch.int32),
                                  prefill=False)
    return min(gaps)


@pytest.mark.parametrize("name", CONFIGS)
def test_prompts_are_tie_free(models, name):
    eng = engine(models, name)
    for seed in PROMPT_SEEDS[name]:
        ids = prompt(seed)
        toks = eng.generate(ids, max_new_tokens=NEW, stop_ids=NO_STOP).tokens
        assert min_top2_gap(eng, ids, toks) > GAP, seed


@pytest.mark.parametrize("name", CONFIGS)
def test_one_request_equals_engine(models, name):
    ids = prompt(PROMPT_SEEDS[name][0])
    want = engine(models, name).generate(ids, max_new_tokens=NEW, stop_ids=NO_STOP).tokens
    sch = scheduler(models, name)
    try:
        got = drain(sch.submit(ids, max_new_tokens=NEW, sampling=GREEDY, stop_ids=NO_STOP))
    finally:
        sch.shutdown()
    assert got == want == models.jax_stream(name, ids)[0]


@pytest.mark.parametrize("name", CONFIGS)
def test_four_requests_on_two_slots(models, name):
    """More requests than slots: queueing, slot reuse, and each stream equal
    to its solo run and to the JAX scheduler's."""
    prompts = [prompt(s) for s in PROMPT_SEEDS[name]]
    sch = scheduler(models, name)
    try:
        reqs = [sch.submit(ids, max_new_tokens=NEW, sampling=GREEDY, stop_ids=NO_STOP)
                for ids in prompts]
        outs = [drain(r) for r in reqs]
    finally:
        sch.shutdown()
    eng = engine(models, name)
    for ids, out in zip(prompts, outs):
        assert len(out) == NEW
        assert out == eng.generate(ids, max_new_tokens=NEW, stop_ids=NO_STOP).tokens
        assert out == models.jax_stream(name, ids)[0]
    assert sch.stats["prefill_chunks"] == 4 and sch.stats["decode_blocks"] >= 2


def test_decode_interleaves_with_chunked_admission(models):
    """Active slots keep emitting between the prefill chunks of a long
    admission."""
    sch = scheduler(models, "qwen3-moe")
    try:
        sch.chunk = 8              # a 64-token prompt is 8 chunks
        a = sch.submit(list(range(1, 5)), max_new_tokens=200, sampling=GREEDY)
        assert a.out_queue.get(timeout=TIMEOUT) is not None
        b = sch.submit(list(range(1, 65)), max_new_tokens=4, sampling=GREEDY)
        assert b.out_queue.get(timeout=TIMEOUT) is not None
        during = 0
        try:
            while a.out_queue.get_nowait() is not None:
                during += 1
        except queue.Empty:
            pass
        assert during >= 1, "decode stalled during the chunked admission"
        a.cancelled.set()
        drain(a)
        drain(b)
    finally:
        sch.shutdown()


def test_cancel_mid_prefill_frees_slot(models):
    sch = scheduler(models, "qwen3-moe", num_slots=1)
    try:
        sch.chunk = 8
        c = sch.submit(list(range(1, 129)), max_new_tokens=4)
        deadline = time.time() + TIMEOUT
        while sch.stats["prefill_chunks"] < 2 and time.time() < deadline:
            time.sleep(0.001)
        c.cancelled.set()
        drain(c)
        assert sch.stats["prefill_chunks"] < 16      # it stopped at a chunk boundary
        ids = prompt(PROMPT_SEEDS["qwen3-moe"][0])
        got = drain(sch.submit(ids, max_new_tokens=NEW, sampling=GREEDY, stop_ids=NO_STOP))
    finally:
        sch.shutdown()
    assert got == models.jax_stream("qwen3-moe", ids)[0]


@pytest.mark.parametrize("name", ["qwen3-moe", "hybrid"])
def test_prefix_reuse_multiturn(models, name):
    """Turn 2 re-sends turn 1's prompt and more: prefill resumes after the
    shared prefix (the hybrid's DeltaNet state and conv window included) and
    the stream equals a fresh one's and the JAX scheduler's."""
    turn2 = prompt(REUSE_SEEDS[name], 64)
    turn1 = turn2[:40]
    sch = scheduler(models, name, num_slots=1)
    try:
        sch.chunk = 16
        drain(sch.submit(turn1, max_new_tokens=3, sampling=GREEDY, stop_ids=NO_STOP))
        assert sch.stats["prefix_reused_tokens"] == 0
        got = drain(sch.submit(turn2, max_new_tokens=NEW, sampling=GREEDY, stop_ids=NO_STOP))
        assert sch.stats["prefix_reused_tokens"] == len(turn1)
    finally:
        sch.shutdown()
    eng = engine(models, name)
    want = eng.generate(turn2, max_new_tokens=NEW, stop_ids=NO_STOP).tokens
    assert got == want == models.jax_stream(name, turn2)[0]
    assert min_top2_gap(eng, turn2, want) > GAP


def test_prefix_reuse_not_applied_on_mismatch(models):
    a, b = prompt(PROMPT_SEEDS["qwen3-moe"][1]), prompt(PROMPT_SEEDS["qwen3-moe"][2])
    sch = scheduler(models, "qwen3-moe", num_slots=1)
    try:
        drain(sch.submit(a, max_new_tokens=3, sampling=GREEDY, stop_ids=NO_STOP))
        got = drain(sch.submit(a[:2] + b, max_new_tokens=NEW, sampling=GREEDY,
                               stop_ids=NO_STOP))
        got_short = drain(sch.submit(b[:3], max_new_tokens=NEW, sampling=GREEDY,
                                     stop_ids=NO_STOP))
        assert sch.stats["prefix_reused_tokens"] == 0
    finally:
        sch.shutdown()
    eng = engine(models, "qwen3-moe")
    assert got == eng.generate(a[:2] + b, max_new_tokens=NEW, stop_ids=NO_STOP).tokens
    assert got_short == eng.generate(b[:3], max_new_tokens=NEW, stop_ids=NO_STOP).tokens


def test_admission_oom_retry_halves_chunk(models, monkeypatch):
    """A prefill chunk that runs the card out of memory restarts the
    admission on a fresh cache with half the chunk."""
    real, state = engine_mod.forward, {"raised": 0}

    def failing(*a, **kw):
        if kw.get("prefill") and not state["raised"]:
            state["raised"] = 1
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (raised by the test)")
        return real(*a, **kw)
    monkeypatch.setattr(engine_mod, "forward", failing)
    ids = prompt(PROMPT_SEEDS["qwen3-moe"][3])
    sch = scheduler(models, "qwen3-moe", num_slots=1)
    try:
        sch.chunk = 256
        got = drain(sch.submit(ids, max_new_tokens=NEW, sampling=GREEDY, stop_ids=NO_STOP))
    finally:
        sch.shutdown()
    assert state["raised"] and sch.chunk == 128
    assert got == models.jax_stream("qwen3-moe", ids)[0]


def test_engine_prefill_oom_halves_chunk(models, monkeypatch):
    eng = engine(models, "qwen3-moe")
    ids = prompt(PROMPT_SEEDS["qwen3-moe"][3])
    want = eng.generate(ids, max_new_tokens=NEW, stop_ids=NO_STOP).tokens
    real, raised = engine_mod.forward, []

    def failing(*a, **kw):
        if kw.get("prefill") and len(raised) < 2:
            raised.append(1)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (raised by the test)")
        return real(*a, **kw)
    monkeypatch.setattr(engine_mod, "forward", failing)
    eng.chunk = 512
    assert eng.generate(ids, max_new_tokens=NEW, stop_ids=NO_STOP).tokens == want
    assert eng.chunk == 128
    # at the floor, or on any other error, it re-raises
    raised.clear()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        eng.generate(ids, max_new_tokens=NEW, stop_ids=NO_STOP)


@pytest.mark.parametrize("name", CONFIGS)
def test_logprobs_opt_in(models, name):
    """Logprobs are opt-in: the block without them emits the same greedy
    tokens with zeros; asked for, they are the JAX scheduler's within LP_TOL."""
    ids = prompt(PROMPT_SEEDS[name][1])
    sch = scheduler(models, name)
    try:
        r0 = sch.submit(ids, max_new_tokens=NEW, sampling=GREEDY, stop_ids=NO_STOP)
        t0 = drain(r0)
        r1 = sch.submit(ids, max_new_tokens=NEW, sampling=GREEDY, stop_ids=NO_STOP,
                        want_logprobs=True)
        t1 = drain(r1)
    finally:
        sch.shutdown()
    want, want_lps = models.jax_stream(name, ids, want_logprobs=True)
    assert t0 == t1 == want
    assert all(lp == 0.0 for lp in r0.logprobs[1:])
    np.testing.assert_allclose(r1.logprobs, want_lps, atol=LP_TOL, rtol=0)
    assert all(lp < 0.0 for lp in r1.logprobs)


@pytest.mark.parametrize("name", ["v2-lite", "qwen3-moe"])
def test_request_runs_to_max_len(models, name):
    """ROADMAP C-7: max_new_tokens is clamped to the cache's room, and the
    last block runs two positions past the cache end, whose rows are
    dropped."""
    ids = prompt(PROMPT_SEEDS[name][2])
    sch = scheduler(models, name, max_len=16, decode_block=5)
    try:
        r = sch.submit(ids, max_new_tokens=100, sampling=GREEDY, stop_ids=NO_STOP)
        got = drain(r)
        assert int(sch.decode_cache["length"][r.slot]) == 16 + 2
    finally:
        sch.shutdown()
    assert r.max_new_tokens == 16 - 8 - 1 == len(got)
    assert got == models.jax_stream(name, ids, new=len(got))[0]


def test_idle_slot_outlives_the_cache(models):
    """ROADMAP C-7: requests pass one at a time through a 2-slot scheduler
    (max_len 16, blocks of 2) for more than max_len / decode_block blocks,
    so one slot idles throughout, decoding discarded tokens from position
    0; every stream is right."""
    max_len, block = 16, 2
    name = "v2-lite"
    sch = scheduler(models, name, max_len=max_len, decode_block=block)
    try:
        outs = []
        for seed in PROMPT_SEEDS[name]:
            r = sch.submit(prompt(seed), max_new_tokens=30, sampling=GREEDY, stop_ids=NO_STOP)
            outs.append(drain(r))
            if len(outs) == 1:      # and one request that ends at its first token
                assert len(drain(sch.submit(prompt(seed), max_new_tokens=1))) == 1
        assert sch.stats["decode_blocks"] > max_len // block
        assert int(sch.decode_cache["length"][1 - r.slot]) <= block
    finally:
        sch.shutdown()
    for seed, out in zip(PROMPT_SEEDS[name], outs):
        assert len(out) == max_len - 8 - 1
        assert out == models.jax_stream(name, prompt(seed), new=len(out))[0]


def test_loop_error_ends_every_waiting_request(models, monkeypatch):
    """A fault in the scheduler thread ends the active and queued requests
    with the error on them, and a later submit raises."""
    submitted = threading.Event()

    def broken(*a, **kw):
        submitted.wait(TIMEOUT)
        raise RuntimeError("decode fault raised by the test")
    monkeypatch.setattr(sched_mod, "decode_block_batched", broken)
    sch = scheduler(models, "qwen3-moe", num_slots=1)
    try:
        reqs = [sch.submit(prompt(s), max_new_tokens=NEW, sampling=GREEDY)
                for s in range(3)]
        submitted.set()
        outs = [drain(r) for r in reqs]
        assert len(outs[0]) == 1 and outs[1:] == [[], []]     # the first token, then the fault
        assert all("decode fault" in str(r.error) for r in reqs)
        with pytest.raises(RuntimeError, match="scheduler stopped"):
            sch.submit([1, 2, 3])
    finally:
        sch.shutdown()


def test_shutdown_ends_waiting_requests(models):
    sch = scheduler(models, "qwen3-moe", num_slots=1)
    a = sch.submit(prompt(1), max_new_tokens=200, sampling=GREEDY, stop_ids=NO_STOP)
    b = sch.submit(prompt(2), max_new_tokens=4, sampling=GREEDY)
    assert a.out_queue.get(timeout=TIMEOUT) is not None
    sch.shutdown()
    assert len(drain(a)) < 199 and drain(b) == []
    assert "shut down" in str(a.error) and "shut down" in str(b.error)
    with pytest.raises(RuntimeError, match="shut down"):
        sch.submit([1, 2, 3])


def _switch_fast():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    return old


def test_concurrent_submits_are_all_answered(models):
    """More submitting threads than cores, the interpreter switching threads
    as often as it can: every request gets all its tokens and its end."""
    sch = scheduler(models, "qwen3-moe", decode_block=2)
    old = _switch_fast()
    try:
        outs, lock = [], threading.Lock()

        def client(i):
            for j in range(2):
                toks = drain(sch.submit(prompt(i * 2 + j, n=4), max_new_tokens=3,
                                        sampling=GREEDY, stop_ids=NO_STOP))
                with lock:
                    outs.append(toks)
        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        sch.shutdown()
    assert len(outs) == 32 and all(len(o) == 3 for o in outs)


def test_fault_during_concurrent_submits_ends_every_request(models, monkeypatch):
    """The loop fails while threads submit: each submit either raises or
    returns a request that ends with the error; none waits forever."""
    def broken(*a, **kw):
        raise RuntimeError("decode fault raised by the test")
    monkeypatch.setattr(sched_mod, "decode_block_batched", broken)
    sch = scheduler(models, "qwen3-moe")
    old = _switch_fast()
    try:
        ended, refused, lock = [], [], threading.Lock()

        def client(i):
            for j in range(4):
                try:
                    r = sch.submit(prompt(i * 4 + j, n=4), max_new_tokens=3, sampling=GREEDY)
                except RuntimeError:
                    with lock:
                        refused.append(1)
                    continue
                drain(r)
                with lock:
                    ended.append(r.error is not None)
        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        sch.shutdown()
    assert len(ended) + len(refused) == 64 and all(ended) and refused


@pytest.mark.parametrize("kw,item", [({"offload": object(), "mesh": 2}, "A-10"),
                                     ({"offload": object()}, "A-9"),
                                     ({"mesh": 2}, "A-10")])
def test_branches_not_ported_raise(models, kw, item):
    """The offload branch (A-9) takes the store, folds nothing and turns spec
    decoding off (tests/test_torch_offload_engine.py drives it). A mesh
    (A-10, a 1 x 2 mesh on the CPU here) shards the parameters, splits the
    experts over ep and keeps the shared experts unfolded
    (tests/test_torch_scheduler_mesh.py drives it); with offload it stays
    refused in the reference server's words."""
    from krasis_tpu_torch.parallel.mesh import OFFLOAD_MESH_ERROR, make_mesh

    if "mesh" in kw:
        kw = {**kw, "mesh": make_mesh(kw["mesh"], devices=["cpu"] * kw["mesh"])}
    if item == "A-10" and "offload" in kw:
        with pytest.raises(ValueError, match=re.escape(OFFLOAD_MESH_ERROR)):
            scheduler(models, "qwen3-moe", **kw)
        return
    sch = scheduler(models, "qwen3-moe", **kw)
    try:
        if item == "A-9":
            assert sch.offload is kw["offload"] and sch.spec_mode is None
        else:
            assert sch.mesh is kw["mesh"] and sch.params["mesh"] is kw["mesh"]
            assert all(len(lp["_ep"]) == 2 for lp in sch.params["layers"])
            assert sch.device == torch.device("cpu")
    finally:
        sch.shutdown()
