"""The port's parallelism (``krasis_tpu_torch/parallel/``) against its own
unsharded forward and the JAX package's sharded one, on the CPU; mirrors
``tests/test_parallel.py``.

A mesh of the port is a grid of torch devices in one process; here every
shard is the CPU (``devices=["cpu"] * 8``, the counterpart of the
reference's 8 virtual CPU devices, which ``tests/conftest.py`` provides
for the JAX side). Sharded and unsharded run the same plain versions of
the kernels on each shard's slice, so they differ by rounding and by the
regimes a shard's local expert count picks (the reference's do too): held
to the reference's 3e-2 with equal greedy argmax. The tiny models' expert
stacks are scaled by 1/8 on both sides (``calm``), off router near-ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.config import preset_config as jax_preset_config
from krasis_tpu.models.model import make_forward_fns
from krasis_tpu.models.params import init_synthetic_params as jax_init
from krasis_tpu.parallel.ep import moe_forward_ep as jax_moe_forward_ep
from krasis_tpu.parallel.mesh import cache_shardings as jax_cache_shardings
from krasis_tpu.parallel.mesh import make_mesh as jax_make_mesh
from krasis_tpu.parallel.mesh import shard_params as jax_shard_params
from krasis_tpu.quant import QTensor as JaxQTensor
from krasis_tpu.quant import quantize_host
from krasis_tpu.runtime.kv_cache import init_cache as jax_init_cache
from krasis_tpu_torch.config import QuantConfig, preset_config
from krasis_tpu_torch.models.model import forward, forced_decode
from krasis_tpu_torch.ops.moe import moe_forward
from krasis_tpu_torch.parallel.ep import ep_supported, local_picks, moe_forward_ep
from krasis_tpu_torch.budget import compute_budget
from krasis_tpu_torch.parallel.mesh import (cache_shardings, init_distributed, make_mesh,
                                            make_multihost_mesh, position_bytes, shard_bytes,
                                            shard_params)
from krasis_tpu_torch.parallel.pp import (make_pp_forward_fns, make_pp_mesh, pp_shard_cache,
                                          pp_shard_params, pp_supported)
from krasis_tpu_torch.parallel.sp import make_sp_mesh, make_sp_prefill_fns
from krasis_tpu_torch.quant import QTensor
from krasis_tpu_torch.runtime.engine import Engine
from krasis_tpu_torch.runtime.kv_cache import init_cache

import torch_spec_util as su
from torch_port_util import port_params, t, tq

CPUS = ["cpu"] * 8
QUANT = dict(expert_bits=4, group_size=32, kv_cache_dtype="bf16")
TOL = 3e-2
# tests/test_parallel.py's _gqa_cfg, _mla_cfg, _hybrid_cfg, and the PP ones
CONFIGS = {
    "gqa": ("qwen3-moe", dict(
        hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
        vocab_size=256, head_dim=16, n_routed_experts=8, num_experts_per_tok=2)),
    "mla": ("deepseek-v2-lite", dict(
        hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
        num_hidden_layers=3, num_attention_heads=4, vocab_size=256, kv_lora_rank=32,
        qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, q_lora_rank=None,
        n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
        first_k_dense_replace=1)),
    "hybrid": ("qwen3-coder-next", dict(
        hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        vocab_size=256, head_dim=16,
        layer_types=["linear_attention", "linear_attention", "linear_attention",
                     "full_attention"],
        linear_num_key_heads=2, linear_num_value_heads=4,
        linear_key_head_dim=16, linear_value_head_dim=16,
        n_routed_experts=8, num_experts_per_tok=2, shared_expert_intermediate_size=32)),
    "mla-pp": ("deepseek-v2-lite", dict(
        hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
        num_hidden_layers=5, num_attention_heads=4, vocab_size=256, kv_lora_rank=32,
        qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, q_lora_rank=None,
        n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
        first_k_dense_replace=1)),
    "hybrid-pp": ("qwen3-coder-next", dict(
        hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
        num_hidden_layers=8, num_attention_heads=4, num_key_value_heads=2,
        vocab_size=256, head_dim=16,
        layer_types=["linear_attention", "linear_attention", "linear_attention",
                     "full_attention"] * 2,
        linear_num_key_heads=2, linear_num_value_heads=4,
        linear_key_head_dim=16, linear_value_head_dim=16,
        n_routed_experts=8, num_experts_per_tok=2, shared_expert_intermediate_size=32)),
}
B, S, MAX_LEN = 2, 8, 32

_built, _runs = {}, {}


def models(name):
    """(JAX cfg, quant, params, port cfg, quant, params) over one set of
    calmed weights, made once a module."""
    if name not in _built:
        preset, over = CONFIGS[name]
        jcfg, jquant = jax_preset_config(preset, **over), JaxQuantConfig(**QUANT)
        jparams = su.calm(jax_init(jcfg, jquant, jax.random.PRNGKey(0)))
        _built[name] = (jcfg, jquant, jparams, preset_config(preset, **over),
                        QuantConfig(**QUANT), port_params(jparams))
    return _built[name]


def tokens_for(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int64))


def f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


def assert_close(got, want, tol=TOL):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)


def port_pair(name, dp):
    """The port's (unsharded prefill logits, sharded, unsharded decode
    logits, sharded, the decode tokens) on a dp × (8 / dp) CPU mesh; the
    decode step feeds the unsharded prefill's argmax to both."""
    if (name, dp) not in _runs:
        _, _, _, cfg, quant, params = models(name)
        tok = tokens_for(cfg)
        sl = torch.full((B,), S, dtype=torch.int32)
        one = torch.ones((B,), dtype=torch.int32)
        cache = init_cache(cfg, quant, B, MAX_LEN, "cpu")
        ref = forward(params, tok, sl, cache, cfg, quant, prefill=True)
        nxt = ref.argmax(-1)[:, None]
        ref_dec = forward(params, nxt, one, cache, cfg, quant, prefill=False)
        mesh = make_mesh(8, dp=dp, devices=CPUS)
        sp = shard_params(params, cfg, mesh)
        sc = cache_shardings(init_cache(cfg, quant, B, MAX_LEN, "cpu"), sp)
        logits = forward(sp, tok, sl, sc, cfg, quant, prefill=True, mesh=mesh)
        dec = forward(sp, nxt, one, sc, cfg, quant, prefill=False, mesh=mesh)
        _runs[(name, dp)] = (ref, logits, ref_dec, dec, nxt, sp, sc)
    return _runs[(name, dp)]


@pytest.mark.parametrize("name", ["gqa", "mla", "hybrid"])
@pytest.mark.parametrize("dp", [1, 2])
def test_sharded_forward_matches_unsharded(name, dp):
    ref, logits, ref_dec, dec, *_ = port_pair(name, dp)
    assert_close(logits, ref)
    assert_close(dec, ref_dec)
    assert torch.equal(logits.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("name,dp", [("gqa", 2), ("mla", 1), ("mla", 2), ("hybrid", 2)])
def test_sharded_forward_matches_jax_sharded(name, dp):
    """The port's sharded forward against the JAX package's sharded forward
    (``make_forward_fns(mesh=)`` on the 8 virtual devices) on the same
    weights: prefill and one decode step."""
    jcfg, jquant, jparams, *_ = models(name)
    _, logits, _, dec, nxt, *_ = port_pair(name, dp)
    tok = jnp.asarray(tokens_for(jcfg).numpy().astype(np.int32))
    sl = jnp.full((B,), S, jnp.int32)
    mesh = jax_make_mesh(8, dp=dp)
    with mesh:
        sparams = jax_shard_params(jparams, jcfg, mesh)
        scache = jax_cache_shardings(jax_init_cache(jcfg, jquant, B, MAX_LEN), mesh)
        prefill_fn, decode_fn, _ = make_forward_fns(jcfg, jquant, mesh=mesh)
        jlogits, jcache = jax.jit(prefill_fn)(sparams, tok, sl, scache)
        jdec, _ = jax.jit(decode_fn)(sparams, jnp.asarray(nxt.numpy().astype(np.int32)), jcache)
    assert_close(logits, jlogits)
    assert_close(dec, jdec)
    assert np.array_equal(logits.argmax(-1).numpy(), np.asarray(jlogits).argmax(-1))


def test_layout_on_one_device_copies_nothing():
    """Shards that share a device hold views of the unsharded stacks and
    the replicated leaves themselves; the dp × ep layout of the GQA model:
    experts over ep, attention by head (4 heads, ep 4), the slots split over
    dp, each head shard its own kv heads' cache."""
    _, _, _, cfg, _, params = models("gqa")
    *_, sp, sc = port_pair("gqa", 2)
    lp, slp = params["layers"][0], sp["layers"][0]
    assert slp["input_norm"] is lp["input_norm"] and sp["embed"] is params["embed"]
    assert sp["dp"][1]["layers"][0]["gate_w"] is lp["gate_w"]
    assert len(slp["_ep"]) == 4 and "w13" not in slp
    E = cfg.n_routed_experts // 4
    for e, sh in enumerate(slp["_ep"]):
        assert sh["w13"].q.data_ptr() == lp["w13"].q[e * E].data_ptr()
    assert [sh["q_proj"].shape[1] for sh in slp["_heads"]] == [16] * 4
    assert "dp" in sc and len(sc["dp"]) == 2 and sc["length"].tolist() == [S + 1] * B
    shards = sc["dp"][1]["layers"][0]["shards"]
    assert [tuple(s["k"].shape) for s in shards] == [(1, 1, MAX_LEN, 128)] * 4
    assert set(shard_bytes(sp)) == {"cpu"}


@pytest.mark.parametrize("name", ["gqa", "mla"])
def test_budget_per_card_brackets_a_shard(name):
    """budget.py's per-card total against what one shard of a 1 x 2 mesh
    holds, on weights quantized as the budget counts them (the shared
    experts at their own bits: no fold): the expert bytes exactly half, the
    whole between the figure with head-sharded attention (all of it
    divided) and without (all of it replicated); the MLA latent projection
    and the norms stay replicated."""
    from krasis_tpu_torch.models.params import init_synthetic_params

    _, _, _, cfg, _, _ = models(name)
    quant = QuantConfig(**QUANT, fold_shared_decode=False)
    params = init_synthetic_params(cfg, quant, device="cpu")
    sp = shard_params(params, cfg, make_mesh(2, devices=["cpu"] * 2))
    report = compute_budget(cfg, quant)
    experts = sum(w.q.numel() + w.scales.numel() * 2 for lp in sp["layers"] if "_ep" in lp
                  for w in (lp["_ep"][0]["w13"], lp["_ep"][0]["w2"]))
    assert experts == report.components["experts"] // 2
    held = position_bytes(sp)
    assert report.per_chip(2, tp_shard_attention=True) <= held <= report.per_chip(2)


@pytest.mark.parametrize("dp", [1, 2])
def test_mla_latent_cache_is_shared_by_head_shards_on_a_device(dp):
    *_, sp, sc = port_pair("mla", dp)
    lc = (sc["dp"][0] if "dp" in sc else sc)["layers"][1]
    if dp == 1:              # 4 heads over ep 8 do not split
        assert "shards" not in lc and "_heads" not in sp["layers"][1]
        return
    kv = [s["kv"] for s in lc["shards"]]
    assert len(kv) == 4 and all(k is kv[0] for k in kv)


# ---------------------------------------------------------------------------
# Op-level EP: moe_forward_ep == moe_forward, skewed and degenerate routing
# ---------------------------------------------------------------------------

def expert_stacks(seed, E=8, H=128, I=64):
    """JAX QTensors (the reference test's ``_make_expert_stack``) and the
    port's bit-equal copies."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jw = []
    for key, (K, N) in ((k1, (H, 2 * I)), (k2, (I, H))):
        w = jax.random.normal(key, (E, K, N), jnp.float32) * 0.05
        qt = quantize_host(np.asarray(w), bits=4, group_size=32)
        jw.append(JaxQTensor(jnp.asarray(np.asarray(qt.q)),
                             jnp.asarray(np.asarray(qt.scales).astype(jnp.bfloat16)),
                             qt.bits, qt.group_size))
    return jw, [tq(w) for w in jw]


def routing(kind, T=16, E=8, k=2):
    rng = np.random.default_rng(7)
    if kind == "uniform":
        idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    elif kind == "skewed":                 # every pick on shard 0's experts
        idx = rng.integers(0, 2, size=(T, k)).astype(np.int32)
        idx[:, 1] = (idx[:, 0] + 1) % 2
    elif kind == "one_expert":
        idx = np.full((T, k), 3, np.int32)
        idx[0, 0] = 6
    else:                                  # descending ids inside one shard
        idx = np.tile(np.array([[1, 0]], np.int32), (T, 1))
        idx[1] = [7, 6]
        idx[2] = [3, 2]
    wts = rng.random((T, k)).astype(np.float32)
    return idx, wts / wts.sum(-1, keepdims=True)


def activations(T, H=128, seed=3):
    x = jax.random.normal(jax.random.PRNGKey(seed), (T, H), jnp.float32) * 0.1
    return x.astype(jnp.bfloat16)


@pytest.mark.parametrize("kind", ["uniform", "skewed", "one_expert", "descending"])
@pytest.mark.parametrize("dp", [1, 2])
def test_moe_ep_matches_dense(kind, dp):
    _, (w13, w2) = expert_stacks(1)
    idx, wts = routing(kind)
    x = t(activations(16))
    mesh = make_mesh(8, dp=dp, devices=CPUS)
    assert ep_supported(mesh, w13, w2)
    want = moe_forward(x, w13, w2, torch.from_numpy(idx), torch.from_numpy(wts))
    got = moe_forward_ep(x, w13, w2, torch.from_numpy(idx), torch.from_numpy(wts), mesh=mesh)
    assert_close(got, want, 2e-2)


def test_local_picks_convention():
    """Valid picks first in their order, a remote pick the row's last valid
    local id at weight 0, a row without a local pick id 0."""
    idx = torch.tensor([[5, 2, 4], [0, 1, 7], [7, 4, 5]])
    wts = torch.tensor([[0.5, 0.3, 0.2], [0.6, 0.3, 0.1], [0.2, 0.3, 0.5]])
    ids, w, valid = local_picks(idx, wts, rank=1, E_local=4)
    assert ids.tolist() == [[1, 0, 0], [3, 3, 3], [3, 0, 1]]
    assert valid.tolist() == [[True, True, False], [True, False, False], [True, True, True]]
    assert torch.equal(w, torch.tensor([[0.5, 0.2, 0.0], [0.1, 0.0, 0.0], [0.2, 0.3, 0.5]]))
    ids, w, valid = local_picks(idx[1:2], wts[1:2], rank=0, E_local=2)
    assert ids.tolist() == [[0, 1, 1]] and w[0, 2] == 0


def test_moe_ep_prefill_scale():
    """T large enough that each shard takes the grouped regime."""
    _, (w13, w2) = expert_stacks(5)
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, 8, size=(128, 2)).astype(np.int32))
    wts = rng.random((128, 2)).astype(np.float32)
    wts = torch.from_numpy(wts / wts.sum(-1, keepdims=True))
    x = t(activations(128))
    want = moe_forward(x, w13, w2, idx, wts)
    got = moe_forward_ep(x, w13, w2, idx, wts, mesh=make_mesh(8, dp=2, devices=CPUS))
    assert_close(got, want, 2e-2)


@pytest.mark.parametrize("interpret,kind,dp", [
    (False, "skewed", 1), (False, "descending", 2), (True, "skewed", 2),
    (True, "uniform", 1)])
def test_moe_ep_matches_reference(interpret, kind, dp, monkeypatch):
    """The port's moe_forward_ep against the reference's on its 8-device
    virtual mesh, the same weights; with the Pallas MoE kernels in
    interpret mode inside the reference's shard_map where asked."""
    if interpret:
        monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    (jw13, jw2), (w13, w2) = expert_stacks(1)
    idx, wts = routing(kind)
    jx = activations(16)
    mesh = jax_make_mesh(8, dp=dp)
    with mesh:
        want = jax.jit(lambda x, i, w: jax_moe_forward_ep(x, jw13, jw2, i, w, mesh=mesh))(
            jx, jnp.asarray(idx), jnp.asarray(wts))
    got = moe_forward_ep(t(jx), w13, w2, torch.from_numpy(idx), torch.from_numpy(wts),
                         mesh=make_mesh(8, dp=dp, devices=CPUS))
    assert_close(got, want, 2e-2)


# ---------------------------------------------------------------------------
# Pipeline and sequence parallelism
# ---------------------------------------------------------------------------

def unsharded(cfg, quant, params, tok, history_chunks=()):
    """Prefill logits, the cache, and the argmax decode step's logits."""
    cache = init_cache(cfg, quant, tok.shape[0], 64, "cpu")
    sl = torch.full((tok.shape[0],), tok.shape[1], dtype=torch.int32)
    ref = forward(params, tok, sl, cache, cfg, quant, prefill=True)
    nxt = ref.argmax(-1)[:, None]
    dec = forward(params, nxt, torch.ones_like(sl), cache, cfg, quant, prefill=False)
    return ref, nxt, dec


@pytest.mark.parametrize("name,pp", [("mla-pp", 2), ("mla-pp", 4), ("hybrid-pp", 2)])
def test_pp_forward_matches_unsharded(name, pp):
    _, _, _, cfg, quant, params = models(name)
    tok = tokens_for(cfg)
    ref, nxt, ref_dec = unsharded(cfg, quant, params, tok)
    mesh = make_pp_mesh(pp, devices=CPUS)
    assert pp_supported(cfg, mesh)
    prefill_fn, decode_fn, _ = make_pp_forward_fns(cfg, quant, mesh)
    pparams = pp_shard_params(params, cfg, mesh)
    cache = pp_shard_cache(init_cache(cfg, quant, B, 64, "cpu"), cfg, mesh)
    logits = prefill_fn(pparams, tok, torch.full((B,), S, dtype=torch.int32), cache)
    dec = decode_fn(pparams, nxt, cache)
    assert_close(logits, ref)
    assert_close(dec, ref_dec)
    assert torch.equal(logits.argmax(-1), ref.argmax(-1))


def test_pp_cuts_the_projection_stacks_by_stage():
    """The hybrid with int8 projections: each stage holds its repetitions
    of a pattern position's projection stack, indexed from its first."""
    jcfg, _, jparams, cfg, _, _ = models("hybrid-pp")
    quant = QuantConfig(**QUANT, attention="int8")
    jq = JaxQuantConfig(**QUANT, attention="int8")
    params = port_params(su.calm(jax_init(jcfg, jq, jax.random.PRNGKey(0))))
    mesh = make_pp_mesh(2, devices=CPUS)
    pparams = pp_shard_params(params, cfg, mesh)
    assert isinstance(params["layers"][0]["qkvz_proj"], QTensor)
    assert [lp["_layer_idx"] for lp in pparams["layers"]] == [0] * 4 + [0] * 4
    assert pparams["layers"][4]["qkvz_proj"].q.shape[0] == 1
    tok = tokens_for(cfg)
    ref, nxt, ref_dec = unsharded(cfg, quant, params, tok)
    prefill_fn, decode_fn, _ = make_pp_forward_fns(cfg, quant, mesh)
    cache = pp_shard_cache(init_cache(cfg, quant, B, 64, "cpu"), cfg, mesh)
    assert_close(prefill_fn(pparams, tok, torch.full((B,), S, dtype=torch.int32), cache), ref)
    assert_close(decode_fn(pparams, nxt, cache), ref_dec)


@pytest.mark.parametrize("name", ["gqa", "mla", "hybrid"])
def test_sp_prefill_matches_unsharded(name):
    """MLP rows split over sp, attention and the cache replicated: the
    logits, and the ordinary decode step on the cache SP left behind."""
    _, _, _, cfg, quant, params = models(name)
    tok = tokens_for(cfg, seed=3, b=1, s=16)
    ref, nxt, ref_dec = unsharded(cfg, quant, params, tok)
    prefill_fn, _ = make_sp_prefill_fns(cfg, quant, make_sp_mesh(8, devices=CPUS))
    cache = init_cache(cfg, quant, 1, 64, "cpu")
    sl = torch.full((1,), 16, dtype=torch.int32)
    logits = prefill_fn(params, tok, sl, cache)
    dec = forward(params, nxt, torch.ones_like(sl), cache, cfg, quant, prefill=False)
    assert_close(logits, ref)
    assert torch.equal(logits.argmax(-1), ref.argmax(-1))
    assert_close(dec, ref_dec)


@pytest.mark.parametrize("name", ["gqa", "mla"])
def test_sp_ep_composed_prefill_matches_unsharded(name):
    """sp 4 × ep 2: each token shard's experts split over its row."""
    _, _, _, cfg, quant, params = models(name)
    tok = tokens_for(cfg, seed=5, b=1, s=16)
    ref, nxt, ref_dec = unsharded(cfg, quant, params, tok)
    mesh = make_sp_mesh(8, ep=2, devices=CPUS)
    assert mesh.shape == {"sp": 4, "ep": 2}
    prefill_fn, _ = make_sp_prefill_fns(cfg, quant, mesh)
    cache = init_cache(cfg, quant, 1, 64, "cpu")
    sl = torch.full((1,), 16, dtype=torch.int32)
    assert_close(prefill_fn(params, tok, sl, cache), ref)
    assert_close(forward(params, nxt, torch.ones_like(sl), cache, cfg, quant, prefill=False),
                 ref_dec)


def test_sp_chunked_prefill_matches_unsharded():
    _, _, _, cfg, quant, params = models("gqa")
    t1, t2 = tokens_for(cfg, seed=4, b=1, s=16), tokens_for(cfg, seed=6, b=1, s=16)
    sl = torch.full((1,), 16, dtype=torch.int32)
    cache = init_cache(cfg, quant, 1, 64, "cpu")
    forward(params, t1, sl, cache, cfg, quant, prefill=True)
    ref = forward(params, t2, sl, cache, cfg, quant, prefill=True, history=16)
    prefill_fn, chunk_fn = make_sp_prefill_fns(cfg, quant, make_sp_mesh(8, devices=CPUS))
    cache2 = init_cache(cfg, quant, 1, 64, "cpu")
    prefill_fn(params, t1, sl, cache2)
    assert_close(chunk_fn(16)(params, t2, sl, cache2), ref)


# ---------------------------------------------------------------------------
# Meshes, engines
# ---------------------------------------------------------------------------

def test_multihost_mesh_degenerates_single_host():
    init_distributed()                 # no-op in a single process
    mesh = make_multihost_mesh(dp=2, ep_per_host=4, devices=CPUS)
    assert mesh.axis_names == ("dp", "ep") and mesh.shape == {"dp": 2, "ep": 4}
    mesh1 = make_multihost_mesh(devices=CPUS)
    assert mesh1.shape == {"dp": 1, "ep": 8}


def test_mesh_needs_a_device_a_shard(monkeypatch):
    """More shards than cards raise, as the reference's make_mesh does,
    unless the caller passes the devices."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(2)
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        make_mesh(4, devices=["cpu"] * 2)
    assert make_mesh(2, devices=["cpu"] * 2).shape == {"dp": 1, "ep": 2}


@pytest.mark.parametrize("mode,name,k", [("ngram", "v2-lite", 3), ("mtp", "v2-lite", 1)])
def test_spec_on_mesh_matches_vanilla_on_mesh(mode, name, k):
    """Engine.generate with speculative decoding on a dp 1 × ep 2 mesh (the
    tiny V2-Lite's 4 heads, 2 a shard; its MTP layer sharded as a layer)
    gives the vanilla greedy stream of that mesh."""
    cfg, quant, params = su.Models().port(name)
    mesh = make_mesh(2, devices=["cpu"] * 2)
    with su.spec_env(mode, k):
        eng = Engine(cfg, quant, params, max_len=256, mesh=mesh)
    assert eng.spec_mode == mode and "_heads" in eng.params["layers"][0]
    assert "_heads" in eng.params["mtp"]["layer"]
    for seed in su.SEEDS[name][:2]:
        ids = su.prompt(seed)
        vanilla = su.greedy(eng, ids, su.NEW, spec=False).tokens
        spec = su.greedy(eng, ids, su.NEW, spec=True)
        assert spec.tokens == vanilla
        assert eng.last_spec_stats["emitted"] == su.NEW


def test_forced_decode_on_mesh_matches_unsharded():
    """The quality matrix's decode path reads the engine's params and cache:
    on a mesh engine it is the mesh's forward."""
    cfg, quant, params = su.Models().port("v2-lite")
    with su.spec_env("off"):
        plain = Engine(cfg, quant, params, max_len=64, device="cpu")
        meshed = Engine(cfg, quant, params, max_len=64, mesh=make_mesh(2, devices=["cpu"] * 2))
    toks = torch.tensor([su.prompt(75, n=12)])
    got = forced_decode(meshed.params, meshed.cache, toks, cfg, quant)
    want = forced_decode(plain.params, plain.cache, toks, cfg, quant)
    assert_close(got, want)
