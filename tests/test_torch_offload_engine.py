"""The port's offload tier end to end: Engine(offload=store), OffloadEngine
(streamed prefill, the hot-expert cache), BatchScheduler(offload=store),
load_params_offload, budget.py and the server's --offload / --hot-experts.

The cases of tests/test_offload.py that drive engines (offloaded against
resident on the same weights, the hybrid's host-call wiring, chunked and
streamed prefill at 2500 ids, the hot cache, the scheduler) on the port,
then the port against the JAX package: greedy streams equal to the JAX
OffloadEngine's on prompts held free of near-ties and ``forward_all_logits``
within 2e-2 of its own, the loader's store and device leaves bit-equal, and
the budget equal on every preset. The weights are the JAX package's,
bridged; the expert stacks are scaled by 1/8 on both sides (``calm``) so
the tiny routers sit off near-ties. The host engine runs one thread.
"""

import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from krasis_tpu.budget import compute_budget as jax_compute_budget
from krasis_tpu.budget import format_budget as jax_format_budget
from krasis_tpu.config import ModelConfig as JaxModelConfig
from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.config import preset_config as jax_preset_config
from krasis_tpu.models.loader import load_params_offload as jax_load_params_offload
from krasis_tpu.models.params import init_synthetic_params as jax_init
from krasis_tpu.models.synthetic import tiny_config as jax_tiny_config
from krasis_tpu.offload import store_from_params as jax_store_from_params
from krasis_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from krasis_tpu.runtime.offload_engine import OffloadEngine as JaxOffloadEngine
from krasis_tpu_torch import budget, server
from krasis_tpu_torch.config import _PRESETS, ModelConfig, QuantConfig, preset_config
from krasis_tpu_torch.models.loader import load_params_offload
from krasis_tpu_torch.models.synthetic import tiny_config
from krasis_tpu_torch.offload import hot_expert_ids, store_from_params
from krasis_tpu_torch.ops.sampling import SamplingParams
from krasis_tpu_torch.runtime.engine import Engine
from krasis_tpu_torch.runtime.offload_engine import OffloadEngine
from krasis_tpu_torch.runtime.scheduler import BatchScheduler

from torch_ckpt_util import assert_same_leaves, write_checkpoint
from torch_port_util import GPTOSS_TINY, hybrid_cfgs, port_params, run_log_dir  # noqa: F401
from torch_spec_util import calm

MLA_KW = dict(kv_lora_rank=64, q_lora_rank=None, qk_nope_head_dim=32,
              qk_rope_head_dim=16, v_head_dim=32)
PRESET_KW = {
    "qwen3-moe": ("qwen3-moe", {}),
    "v2-lite": ("deepseek-v2-lite", dict(MLA_KW, num_hidden_layers=5)),   # dense prefix + 4 reps
    # the tiny GPT-OSS of the port's other GPT-OSS tests (window 4, heads of 16)
    "gpt-oss": ("gpt-oss-20b", GPTOSS_TINY),
}
GREEDY = SamplingParams(temperature=0.0)
NO_STOP = {-1}
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
GAP = 0.02         # a compared greedy step's top-two logits stay further apart


class Models:
    """Per configuration: both packages' configs and quants, the JAX params
    (calmed), the port's bridged params, and both packages' stripped trees
    and stores, made once a module."""

    def __init__(self):
        self._got = {}

    def get(self, name):
        if name not in self._got:
            if name == "hybrid":
                jcfg, cfg = hybrid_cfgs()
            else:
                preset, kw = PRESET_KW[name]
                jcfg, cfg = jax_tiny_config(preset, **kw), tiny_config(preset, **kw)
            jquant, quant = JaxQuantConfig(), QuantConfig()
            jparams = calm(jax_init(jcfg, jquant, jax.random.PRNGKey(3)))
            params = port_params(jparams)
            jsp, jstore = jax_store_from_params(jcfg, jquant, jparams)
            sp, store = store_from_params(cfg, quant, params, threads=1)
            self._got[name] = dict(jcfg=jcfg, jquant=jquant, jparams=jparams, jsp=jsp,
                                   jstore=jstore, cfg=cfg, quant=quant, params=params, sp=sp,
                                   store=store)
        return self._got[name]

    def resident(self, name, max_len=256):
        m = self.get(name)
        return Engine(m["cfg"], m["quant"], m["params"], max_len=max_len, device="cpu")

    def offloaded(self, name, max_len=256, **kw):
        """OffloadEngine over the module's store (kw: streaming, hot_experts)."""
        m = self.get(name)
        return OffloadEngine(m["cfg"], m["quant"], m["sp"], m["store"], max_len=max_len,
                             device="cpu", **kw)


@pytest.fixture(scope="module")
def models():
    return Models()


def greedy(eng, ids, new):
    return eng.generate(list(ids), max_new_tokens=new, sampling=GREEDY, stop_ids=NO_STOP)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _spy(store):
    """Record (layer, rows, live picks) of every host call; returns the list
    and the original forward."""
    calls = []
    orig = store.forward

    def spy(layer, x, idx, w, **kw):
        calls.append((int(layer), x.shape[0], int((np.asarray(idx) >= 0).sum())))
        return orig(layer, x, idx, w, **kw)
    store.forward = spy
    return calls, orig


# ---------------------------------------------------------------------------
# Offloaded against resident, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen3-moe", "v2-lite", "gpt-oss"])
def test_offload_engine_parity(models, name):
    m = models.get(name)
    res = models.resident(name)
    off = Engine(m["cfg"], m["quant"], m["sp"], max_len=256, device="cpu", offload=m["store"])
    assert off.offload is m["store"] and m["store"].layers
    assert all("w13" not in lp and "w2" not in lp for lp in off.params["layers"])
    assert off.spec_mode is None
    l1, l2 = res.forward_all_logits(PROMPT), off.forward_all_logits(PROMPT)
    assert _rel(l2, l1) < 3e-2     # host f32 against device bf16 expert products
    r1, r2 = greedy(res, PROMPT, 12), greedy(off, PROMPT, 12)
    assert len(r1.tokens) == len(r2.tokens) == 12
    assert r1.tokens[:2] == r2.tokens[:2]


def test_build_synthetic_engine_offload():
    """build_synthetic_engine(offload=True) serves the resident engine's
    weights with the routed stacks in the store (the folded shared rows cut
    off); offload_engine=True builds an OffloadEngine over a store bit-equal
    to build_synthetic_store's for the seed."""
    from krasis_tpu_torch.models.synthetic import build_synthetic_engine
    from krasis_tpu_torch.offload import build_synthetic_store

    cfg, quant = tiny_config("deepseek-v2-lite", **MLA_KW), QuantConfig()
    res = build_synthetic_engine(cfg, quant, max_len=256, seed=2, device="cpu")
    off = build_synthetic_engine(cfg, quant, max_len=256, seed=2, device="cpu", offload=True)
    for layer in off.offload.layers:
        w13 = res.params["layers"][layer]["w13"]
        assert torch.equal(off.offload._layers[layer][0], w13.q[:cfg.n_routed_experts])
        assert "w13" not in off.params["layers"][layer]
    assert _rel(off.forward_all_logits(PROMPT), res.forward_all_logits(PROMPT)) < 3e-2
    eng = build_synthetic_engine(cfg, quant, max_len=256, seed=2, device="cpu",
                                 offload_engine=True, hot_experts=2)
    want = build_synthetic_store(cfg, quant, seed=2)
    assert isinstance(eng, OffloadEngine) and eng.hot_experts == 2
    for layer in want.layers:
        assert all(torch.equal(a, b) for a, b in zip(eng.offload._layers[layer][:4],
                                                     want._layers[layer][:4]))
    assert len(greedy(eng, PROMPT, 4).tokens) == 4


def test_offload_hybrid_wiring(models):
    """The hybrid's host calls: every MoE layer once a forward, in order,
    with the prefill's padded rows, then one row a decode step."""
    m = models.get("hybrid")
    off = Engine(m["cfg"], m["quant"], m["sp"], max_len=256, device="cpu", offload=m["store"])
    store = m["store"]
    L = m["cfg"].num_hidden_layers
    assert store.layers == list(range(L))
    calls, orig = _spy(store)
    try:
        r = greedy(off, PROMPT, 9)
    finally:
        store.forward = orig
    assert len(r.tokens) == 9
    assert [c[0] for c in calls[:L]] == list(range(L))
    assert all(c[1] == 128 for c in calls[:L])            # MIN_PREFILL_ROWS
    decode = calls[L:]
    assert [c[0] for c in decode[:L]] == list(range(L))
    assert all(c[1] == 1 for c in decode)
    assert len(decode) % L == 0 and len(decode) // L >= 8


def test_offload_chunked_prefill(models):
    """A prompt beyond one chunk prefills through the host in two chunks."""
    m = models.get("qwen3-moe")
    res = models.resident("qwen3-moe", max_len=4096)
    off = Engine(m["cfg"], m["quant"], m["sp"], max_len=4096, device="cpu", offload=m["store"])
    prompt = np.random.default_rng(7).integers(1, m["cfg"].vocab_size, 2500).tolist()
    calls, orig = _spy(m["store"])
    try:
        r2 = greedy(off, prompt, 4)
    finally:
        m["store"].forward = orig
    r1 = greedy(res, prompt, 4)
    assert len(r1.tokens) == len(r2.tokens) == 4
    assert [c[1] for c in calls[:2 * len(m["store"].layers)]] == [2048] * 2 + [452] * 2


@pytest.mark.parametrize("name", ["qwen3-moe", "v2-lite"])
def test_streaming_prefill_parity(models, name):
    """OffloadEngine's streamed prefill == its host prefill == the resident
    engine, through two chunks (2048 + 452); the streamed prefill's logits
    equal the resident prefill's bit for bit (the same rows, the same
    products); all-position logits through the streamed prefill."""
    m = models.get(name)
    res = models.resident(name, max_len=4096)
    cb = models.offloaded(name, max_len=4096, streaming=False)
    st = models.offloaded(name, max_len=4096)
    prompt = np.random.default_rng(1).integers(1, m["cfg"].vocab_size, 2500).tolist()
    calls, orig = _spy(m["store"])
    try:
        with torch.inference_mode():
            st.reset()
            l_st = st._prefill_prompt(prompt)
    finally:
        m["store"].forward = orig
    assert calls == []                       # streamed: no expert ran on the host
    stats = st.last_stream_stats
    assert stats["groups"] == st.streamer.info.reps and not stats["staged"]
    assert stats["streamed_bytes"] == m["store"].nbytes()
    with torch.inference_mode():
        res.reset()
        l_res = res._prefill_prompt(prompt)
    assert torch.equal(l_st, l_res)
    r0, r1, r2 = greedy(res, prompt, 6), greedy(cb, prompt, 6), greedy(st, prompt, 6)
    assert r1.tokens == r2.tokens
    assert len(r0.tokens) == len(r2.tokens) and r0.tokens[0] == r2.tokens[0]
    short = prompt[:64]
    l_res = res.forward_all_logits(short)
    l_st = st.forward_all_logits(short)
    assert l_st.shape == l_res.shape
    assert torch.equal(l_st, l_res)


def test_streaming_prefill_single_chunk_short(models):
    cb = models.offloaded("qwen3-moe", streaming=False)
    st = models.offloaded("qwen3-moe")
    assert greedy(cb, [3, 1, 4, 1, 5, 9], 8).tokens == greedy(st, [3, 1, 4, 1, 5, 9], 8).tokens


def test_streaming_prefill_stages_pageable_on_the_card_only(models):
    """On the CPU the slots are filled from the store directly (no staging,
    whatever the pages); the slots are made once and reused."""
    st = models.offloaded("v2-lite")
    greedy(st, PROMPT, 2)
    slots = [id(a) for s in st.streamer.slots for ts in s if ts for a in ts if a is not None]
    greedy(st, PROMPT, 2)
    assert slots == [id(a) for s in st.streamer.slots for ts in s if ts for a in ts
                     if a is not None]
    assert st.streamer.stage is None and not st.last_stream_stats["staged"]


# ---------------------------------------------------------------------------
# The hot-expert cache
# ---------------------------------------------------------------------------

def test_hot_cache_all_hot_no_host_traffic(models):
    """n_hot = E: every pick is served on the card; the host engine is never
    called, and the tokens equal the cacheless engine's."""
    m = models.get("qwen3-moe")
    r0 = greedy(models.offloaded("qwen3-moe"), PROMPT, 10)
    hot = models.offloaded("qwen3-moe", hot_experts=m["cfg"].n_routed_experts)
    calls, orig = _spy(m["store"])
    try:
        r1 = greedy(hot, PROMPT, 10)
    finally:
        m["store"].forward = orig
    assert calls == []
    assert r1.tokens == r0.tokens


def test_hot_cache_partial_split(models):
    """A partial cache: cold traffic shrinks but stays nonzero; the heatmap
    is collected; the first tokens equal the cacheless engine's."""
    m = models.get("qwen3-moe")
    base, part = models.offloaded("qwen3-moe"), models.offloaded("qwen3-moe", hot_experts=4)
    calls, orig = _spy(m["store"])
    try:
        r0 = greedy(base, PROMPT, 10)
        n0 = sum(c[2] for c in calls)
        calls.clear()
        r1 = greedy(part, PROMPT, 10)
    finally:
        m["store"].forward = orig
    assert 0 < sum(c[2] for c in calls) < n0
    assert r0.tokens[:2] == r1.tokens[:2]
    assert m["store"].heatmap and all(hm.sum() > 0 for hm in m["store"].heatmap.values())


def test_hot_cache_heatmap_selection_and_update(models):
    """update_hot_cache copies the heatmap's new hot set into the same
    device buffers: shapes and tensors unchanged, contents the new set."""
    m = models.get("qwen3-moe")
    eng = models.offloaded("qwen3-moe", hot_experts=4)
    store = m["store"]

    def leaves():
        return [(n, lp[n].q.data_ptr() if n != "hot_remap" else lp[n].data_ptr(),
                 tuple((lp[n].q if n != "hot_remap" else lp[n]).shape))
                for lp in eng.params["layers"] for n in ("hot_w13", "hot_w2", "hot_remap")]
    before = leaves()
    greedy(eng, [3, 1, 4], 4)                   # gathers the heatmap
    for layer in store.layers:
        store.heatmap[layer] = np.array([0, 9, 1, 8, 0, 7, 0, 2], np.int64)
    eng.update_hot_cache()
    assert leaves() == before
    for layer in store.layers:
        ids = hot_expert_ids(store, layer, 4)
        assert ids.tolist() == [1, 3, 5, 7]
        assert torch.equal(eng.params["layers"][layer]["hot_remap"][torch.from_numpy(
            ids.astype(np.int64))], torch.arange(4, dtype=torch.int32))
    assert len(greedy(eng, [3, 1, 4], 4).tokens) == 4


def test_hot_cache_gpt_oss_biases(models):
    """GPT-OSS's per-expert biases ride the hot substack."""
    eng = models.offloaded("gpt-oss", hot_experts=4)
    lp = next(lp for lp in eng.params["layers"] if "hot_w13" in lp)
    assert "hot_w13_bias" in lp and "hot_w2_bias" in lp
    r0 = greedy(models.offloaded("gpt-oss"), [3, 1, 4, 1, 5], 8)
    assert len(greedy(eng, [3, 1, 4, 1, 5], 8).tokens) == len(r0.tokens) == 8


@pytest.mark.parametrize("hot", [0, 4], ids=["streamed", "hot"])
def test_scheduler_offload_parity(models, hot):
    """Continuous batching over host experts: the offloaded scheduler's
    greedy stream equals the offloaded engine's (admission streamed through
    the card, `hot` experts of each layer on the card), and it serves
    concurrent requests (T = 2 slot rows a host call)."""
    m = models.get("qwen3-moe")
    eng = models.offloaded("qwen3-moe", hot_experts=hot)
    off = BatchScheduler(m["cfg"], m["quant"], eng.params, max_len=256, num_slots=2,
                         decode_block=4, device="cpu", offload=m["store"])
    assert off.spec_mode is None and off.streamer is not None

    def drain(req):
        out = []
        while (t := req.out_queue.get(timeout=120)) is not None:
            out.append(t)
        assert req.error is None
        return out

    try:
        want = greedy(eng, [3, 1, 4, 1, 5], 8)
        calls, orig = _spy(m["store"])
        try:
            got = drain(off.submit([3, 1, 4, 1, 5], max_new_tokens=8, sampling=GREEDY,
                                   stop_ids=NO_STOP))
        finally:
            m["store"].forward = orig
        assert got == want.tokens
        # the admission prefill streamed the weights: no host call at 128 rows
        assert not any(c[1] == 128 for c in calls)
        if hot:            # the host ran the cold picks only
            k = m["cfg"].num_experts_per_tok
            assert 0 < sum(c[2] for c in calls) < k * sum(c[1] for c in calls)
        calls, orig = _spy(m["store"])
        try:
            r1 = off.submit([2, 7, 1], max_new_tokens=6, sampling=GREEDY, stop_ids=NO_STOP)
            r2 = off.submit([9, 9, 8, 2], max_new_tokens=6, sampling=GREEDY, stop_ids=NO_STOP)
            assert len(drain(r1)) == 6 and len(drain(r2)) == 6
        finally:
            m["store"].forward = orig
        assert any(c[1] == 2 for c in calls)
    finally:
        off.shutdown()


# ---------------------------------------------------------------------------
# The port against the JAX package
# ---------------------------------------------------------------------------

def _jax_offload_engine(m, max_len=256, **kw):
    return JaxOffloadEngine(m["jcfg"], m["jquant"], m["jsp"], m["jstore"], max_len=max_len,
                            **kw)


def _min_gap(eng, ids, tokens):
    """The smallest top-two logit gap over the greedy steps, teacher-forced
    through the port's engine."""
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


# (prompt seed, new tokens) whose greedy steps keep a top-two gap over GAP
JAX_STREAMS = {("qwen3-moe", 0): (10, 6), ("qwen3-moe", 4): (10, 6), ("v2-lite", 0): (18, 10),
               ("v2-lite", 4): (18, 10), ("gpt-oss", 0): (11, 10)}


@pytest.mark.parametrize("name,hot", sorted(JAX_STREAMS))
def test_offload_engine_matches_jax(models, name, hot):
    """The port's OffloadEngine (streamed prefill, host decode, `hot` experts
    on the card) against the JAX package's on the same weights: greedy
    streams equal on a prompt held free of near-ties, all-position logits
    within 2e-2 of the larger of 1 and the largest logit."""
    m = models.get(name)
    seed, new = JAX_STREAMS[(name, hot)]
    prompt = np.random.default_rng(seed).integers(1, m["cfg"].vocab_size - 1, 8).tolist()
    jeng = _jax_offload_engine(m, hot_experts=hot)
    eng = models.offloaded(name, hot_experts=hot)
    want = jeng.generate(prompt, max_new_tokens=new,
                         sampling=JaxSamplingParams(temperature=0.0), stop_ids=NO_STOP)
    got = greedy(eng, prompt, new)
    assert _min_gap(eng, prompt, got.tokens) > GAP
    assert got.tokens == list(want.tokens)
    lj = np.asarray(jeng.forward_all_logits(prompt), np.float32)
    lp = eng.forward_all_logits(prompt).numpy()
    assert lp.shape == lj.shape
    assert float(np.abs(lp - lj).max()) <= 2e-2 * max(1.0, float(np.abs(lj).max()))


LOAD_FAMILIES = ("qwen3_moe", "deepseek_v2", "gpt_oss", "mtp")


@pytest.mark.parametrize("use_cache", [False, True], ids=["direct", "cache"])
@pytest.mark.parametrize("family", LOAD_FAMILIES)
def test_load_params_offload_matches_jax(tmp_path_factory, tmp_path, monkeypatch, family,
                                         use_cache):
    """load_params_offload: the store's bytes and the device leaves equal
    the JAX loader's, an MTP module's experts at index num_hidden_layers;
    through the cache the store points into the cache's mmap'd pages."""
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path / "home"))
    path = write_checkpoint(family, tmp_path_factory.getbasetemp() / "offload_ckpts")
    jdev, jstore = jax_load_params_offload(JaxModelConfig.from_model_path(path),
                                           JaxQuantConfig(), use_cache=use_cache)
    cfg = ModelConfig.from_model_path(path)
    dev, store = load_params_offload(cfg, QuantConfig(), use_cache=use_cache, device="cpu",
                                     threads=1)
    assert_same_leaves(port_params(jdev), dev)
    assert store.layers == jstore.layers
    if family == "mtp":
        assert cfg.num_hidden_layers in store.layers
    for layer in store.layers:
        for a, b in zip(store._layers[layer], jstore._layers[layer]):
            assert (a is None) == (b is None)
            if a is not None:
                bits = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
                assert np.array_equal(bits.numpy().view(np.asarray(b).dtype), np.asarray(b))
    assert not any(a.is_pinned() for e in store._layers.values() for a in e if a is not None)
    x = np.random.default_rng(0).standard_normal((2, store.H)).astype(np.float32) * 0.1
    idx = np.array([[0, 1], [2, -1]], np.int32)
    w = np.array([[0.5, 0.25], [1.0, 0.0]], np.float32)
    layer = store.layers[0]
    assert _rel(store.forward(layer, x, idx, w), jstore.forward(layer, x, idx, w)) < 2e-6


@pytest.mark.parametrize("preset", sorted(_PRESETS))
def test_budget_matches_jax(preset):
    """compute_budget, per_chip, offload_split, max_context_tokens and
    format_budget equal the reference's on every preset."""
    cfg, jcfg = preset_config(preset), jax_preset_config(preset)
    for kw in ({}, dict(expert_bits=8, kv_cache_dtype="fp8", attention="int8")):
        rep, jrep = budget.compute_budget(cfg, QuantConfig(**kw)), \
            jax_compute_budget(jcfg, JaxQuantConfig(**kw))
        assert rep.components == jrep.components
        assert (rep.expert_bytes_per_layer, rep.kv_bytes_per_token, rep.total_weight_bytes) == \
            (jrep.expert_bytes_per_layer, jrep.kv_bytes_per_token, jrep.total_weight_bytes)
        for n in (1, 2, 4, 8):
            for ep in (True, False):
                for tp in (True, False):
                    assert rep.per_chip(n, ep, tp) == jrep.per_chip(n, ep, tp)
            assert rep.max_context_tokens(n, 80 << 30) == jrep.max_context_tokens(n, 80 << 30)
        for g in (1, 4):
            assert rep.offload_split(g) == jrep.offload_split(g)
        for n, hbm in ((1, 80 << 30), (4, 16 << 30)):
            assert budget.format_budget(cfg, QuantConfig(**kw), n, hbm) == \
                jax_format_budget(jcfg, JaxQuantConfig(**kw), n, hbm)


def test_budget_reads_the_card_only_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        budget.format_budget(preset_config("qwen3-235b"), QuantConfig())


def _serve(monkeypatch, flags, during=None):
    """server.main with `flags` on the tiny synthetic model, its run_server
    replaced by `during(engine, scheduler)` (the scheduler is shut down
    when main returns); returns what main built."""
    seen = {}

    def serve(engine, tok, name, host, port, backend="auto", scheduler=None):
        seen.update(engine=engine, scheduler=scheduler)
        if during is not None:
            during(engine, scheduler)
    monkeypatch.setattr(server, "run_server", serve)
    assert server.main(["--synthetic", "tiny", "--device", "cpu", "--no-warmup", *flags]) == 0
    return seen["engine"], seen["scheduler"]


def _chat(eng, sch):
    httpd = server.start_temp_server(eng, None, "tiny", port=0, backend="python", scheduler=sch)
    try:
        body = json.dumps({"messages": [{"role": "user", "content": "hello there"}],
                           "max_tokens": 5, "temperature": 0.0}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.port}/v1/chat/completions",
                                     data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())
    finally:
        threading.Thread(target=httpd.shutdown, daemon=True).start()


@pytest.mark.parametrize("slots", [0, 2])
@pytest.mark.usefixtures("run_log_dir")
def test_server_offload_answers_a_chat(monkeypatch, slots):
    """--offload experts --hot-experts 2 builds an OffloadEngine (and an
    offloaded scheduler with --slots) that answers a chat request."""
    answers = []
    eng, sch = _serve(monkeypatch, ["--offload", "experts", "--hot-experts", "2",
                                    "--slots", str(slots)],
                      lambda e, s: answers.append(_chat(e, s)))
    assert isinstance(eng, OffloadEngine) and eng.hot_experts == 2
    assert all("w13" not in lp for lp in eng.params["layers"])
    assert (sch is None) if slots == 0 else (sch.offload is eng.offload)
    assert answers[0]["usage"]["completion_tokens"] == 5
    assert eng.offload.host_calls > 0


@pytest.mark.usefixtures("run_log_dir")
def test_server_offload_auto_is_resident_on_the_cpu(monkeypatch):
    eng, _ = _serve(monkeypatch, ["--offload", "auto"])
    assert eng.offload is None and not isinstance(eng, OffloadEngine)


@pytest.mark.parametrize("preset,want", [("deepseek-v2-lite", False), ("qwen3-235b", True)])
def test_offload_auto_decides_by_the_budget(monkeypatch, preset, want):
    """--offload auto on the card: resident while compute_budget's bytes
    stay within 0.92 of the card's memory (80 GiB here), else experts;
    experts and none decide alone."""
    import argparse

    monkeypatch.setattr(budget, "card_memory", lambda device=None: 80 << 30)
    cuda = torch.device("cuda")
    cfg, quant = preset_config(preset), QuantConfig()
    assert server.choose_offload(argparse.Namespace(offload="auto"), cfg, quant, cuda) == want
    assert server.choose_offload(argparse.Namespace(offload="experts"), cfg, quant, cuda)
    assert not server.choose_offload(argparse.Namespace(offload="none"), cfg, quant, cuda)


def test_offload_entry_points_run_on_the_card_unless_asked(models, monkeypatch, tmp_path,
                                                           tmp_path_factory):
    """Without a card and without device="cpu", every offload entry point
    raises: there is no silent CPU path."""
    from krasis_tpu_torch.models.synthetic import build_synthetic_engine

    m = models.get("qwen3-moe")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path / "home"))
    path = write_checkpoint("qwen3_moe", tmp_path_factory.getbasetemp() / "offload_ckpts")
    for make in (lambda: OffloadEngine(m["cfg"], m["quant"], m["sp"], m["store"]),
                 lambda: Engine(m["cfg"], m["quant"], m["sp"], offload=m["store"]),
                 lambda: BatchScheduler(m["cfg"], m["quant"], m["sp"], offload=m["store"]),
                 lambda: build_synthetic_engine(m["cfg"], m["quant"], offload_engine=True),
                 lambda: load_params_offload(ModelConfig.from_model_path(path), QuantConfig())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
