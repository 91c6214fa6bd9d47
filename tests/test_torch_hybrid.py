"""The hybrid slice as a whole: a tiny Qwen3-Coder-Next (two repetitions of
[DeltaNet, DeltaNet, DeltaNet, GQA], every layer MoE with a gated shared
expert) against the JAX package with its Pallas kernels in interpret mode:
the bridged parameter tree, the shared-expert gate, and prefill / chunk /
decode logits for attention bf16, int8 and int4 and for bf16 expert
activations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.config import preset_config as jax_preset_config
from krasis_tpu.models import model as jax_model
from krasis_tpu.models.model import make_chunk_prefill_fn, make_forward_fns
from krasis_tpu.models.params import fold_shared_experts as jax_fold
from krasis_tpu.models.params import init_synthetic_params as jax_init
from krasis_tpu.models.params import layer_specs as jax_layer_specs
from krasis_tpu.models.params import pattern_info as jax_pattern_info
from krasis_tpu.quant import QTensor as JaxQTensor
from krasis_tpu.runtime.kv_cache import init_cache as jax_init_cache
from krasis_tpu_torch.config import preset_config
from krasis_tpu_torch.models import model as port_model
from krasis_tpu_torch.models.model import forward
from krasis_tpu_torch.models.params import (STACKED_PROJECTIONS, init_synthetic_params,
                                            layer_specs, pattern_info, pattern_layer_index)
from krasis_tpu_torch.runtime.kv_cache import init_cache, kv_bytes_per_token

from torch_port_util import (calm_experts, f32, hybrid_cfgs, hybrid_quants, port_params, t,
                             to_numpy_tree)

MAX_LEN = 512


@pytest.mark.parametrize("name", ["qwen3-coder-next", "qcn-1chip", "qwen3-moe",
                                  "deepseek-v2-lite"])
def test_presets_match_jax(name):
    want, got = jax_preset_config(name), preset_config(name)
    for field in vars(got):
        assert getattr(got, field) == getattr(want, field), field
    assert got.is_hybrid == want.is_hybrid and got.qk_head_dim == want.qk_head_dim
    assert tuple(pattern_info(got)) == tuple(jax_pattern_info(want))
    assert [tuple(s) for s in layer_specs(got)] == [tuple(s) for s in jax_layer_specs(want)]


def test_tiny_hybrid_has_the_published_pattern():
    jcfg, cfg = hybrid_cfgs()
    info = pattern_info(cfg)
    assert tuple(info) == tuple(jax_pattern_info(jcfg)) == (0, 4, 2)
    assert [s.attn_kind for s in layer_specs(cfg)] == (["linear_attention"] * 3 + ["gqa"]) * 2
    assert kv_bytes_per_token(cfg) == 2 * 2 * 2 * 128 * 2     # 2 GQA layers, K and V, 2 heads


@pytest.mark.parametrize("attention", ["bf16", "int8", "int4"])
def test_bridge_carries_the_hybrid_tree(attention):
    """Layers arrive in the order of `pattern_layer_index`; quantized
    projection stacks stay whole, shared by the layers of a pattern position
    with their `_layer_idx`; everything else is a per-layer view, bit for bit;
    and the port's own synthetic init builds the same structure."""
    jcfg, cfg = hybrid_cfgs()
    jquant, quant = hybrid_quants(attention)
    tree = to_numpy_tree(jax_fold(jax_init(jcfg, jquant, jax.random.PRNGKey(0)), jcfg, jquant))
    params = port_params(tree)
    own = init_synthetic_params(cfg, quant, seed=0, device="cpu")
    info = pattern_info(cfg)
    assert len(params["layers"]) == len(own["layers"]) == 8
    for t_ in range(info.period):
        for r in range(info.reps):
            i = pattern_layer_index(info, t_, r)
            lp, want = params["layers"][i], tree["pattern"][t_]
            assert set(lp) - {"_layer_idx"} == set(want), i
            assert set(own["layers"][i]) == set(lp), i
            for k, v in want.items():
                got = lp[k]
                if isinstance(v, dict) and k in STACKED_PROJECTIONS:
                    assert lp["_layer_idx"] == own["layers"][i]["_layer_idx"] == r
                    assert got is params["layers"][pattern_layer_index(info, t_, 0)][k]
                    assert got.q.shape == v["q"].shape == own["layers"][i][k].q.shape
                    assert got.bits == v["bits"] == own["layers"][i][k].bits
                    np.testing.assert_array_equal(got.q.numpy(), v["q"])
                elif isinstance(v, dict):
                    assert got.q.shape == v["q"].shape[1:] == own["layers"][i][k].q.shape
                    np.testing.assert_array_equal(got.q.numpy(), v["q"][r])
                else:
                    assert tuple(got.shape) == v.shape[1:] == tuple(own["layers"][i][k].shape), k
                    np.testing.assert_array_equal(f32(got), np.asarray(v[r], np.float32))
    if attention == "bf16":
        assert all("_layer_idx" not in lp for lp in params["layers"])
    else:
        la, gqa = params["layers"][0], params["layers"][3]
        floor = 8                                   # DeltaNet projections: int8 floor
        assert (la["qkvz_proj"].bits, la["ba_proj"].bits, la["la_out_proj"].bits) == (floor,) * 3
        assert gqa["q_proj"].bits == (8 if attention == "int8" else 4)
        assert gqa["q_proj"].q.dim() == 3 and gqa["q_proj"].n_dim == 2 * 4 * 32   # gated q


@pytest.mark.parametrize("prefill", [False, True])
def test_shared_expert_gate_matches_jax_mlp(monkeypatch, prefill):
    """A layer with `shared_gate_w`: the folded decode form weighs the virtual
    shared expert by sigmoid(x @ shared_gate_w), and the dense prefill form
    scales the shared product the same way, as the JAX `_mlp` does. Without
    the gate (weight 1) the result is far outside the tolerance."""
    monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    jcfg, cfg = hybrid_cfgs(num_hidden_layers=4, layer_types=["linear_attention"] * 3
                      + ["full_attention"])
    jquant, _ = hybrid_quants()
    jparams = jax_fold(jax_init(jcfg, jquant, jax.random.PRNGKey(2)), jcfg, jquant)
    jlp = jparams["prefix_layers"][0]
    rng = np.random.default_rng(3)
    # a gate well away from 1: sigmoid of about -1.5 .. 1.5
    jlp = {**jlp, "shared_gate_w": jnp.asarray(rng.standard_normal((128, 1)) * 0.1,
                                               jnp.float32).astype(jnp.bfloat16)}
    # the synthetic shared expert is small beside the routed ones: scale it
    # by 8 per product (a power of two, so the dense leaves and the virtual
    # expert sliced from them stay bit-identical) so that its weight matters
    E = jcfg.n_routed_experts
    for name in ("w13", "w2"):
        qt, sh = jlp[name], jlp["shared_" + name]
        jlp[name] = JaxQTensor(qt.q, qt.scales.at[E].multiply(8), qt.bits, qt.group_size)
        jlp["shared_" + name] = JaxQTensor(sh.q, sh.scales * 8, sh.bits, sh.group_size)
    lp = port_params({**jparams, "prefix_layers": [jlp]})["layers"][0]
    assert lp["w13"].q.shape[0] == cfg.n_routed_experts + 1
    T = 128 if prefill else 1
    x = jnp.asarray(rng.standard_normal((T, 128)), jnp.float32).astype(jnp.bfloat16)
    act = "bf16" if prefill else "int8"
    want = jax_model._mlp(jlp, x, jcfg, jax_layer_specs(jcfg)[0], activation=act,
                          prefill=prefill)
    got = port_model._mlp(lp, t(x), cfg, prefill, act)
    scale = float(np.abs(f32(want)).max())
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=2e-2 * scale)
    ungated = port_model._mlp({k: v for k, v in lp.items() if k != "shared_gate_w"},
                              t(x), cfg, prefill, act)
    assert float(np.abs(f32(ungated) - f32(want)).max()) > 0.2 * scale


# (attention, expert activation, prompt seed)
CASES = [("bf16", "int8", 1), ("int8", "int8", 7), ("int4", "int8", 7), ("int8", "bf16", 7)]
# Logits are ~0.8 large. Over the 8 layers the two frameworks' different
# summation orders and bf16 rounding flips compound to 0.01 - 0.03 (measured
# over several prompts and all four cases, with no outlier), so the limit is
# 5e-2 of max(1, largest logit); a dropped layer, a wrong pattern order or a
# missing gate moves the logits by 0.2 or more. The layer-level tests
# (test_torch_deltanet, test_torch_gqa, the shared-gate case above) hold each
# layer to 1e-2 of its scale or tighter.
PREFILL_TOL = DECODE_TOL = 5e-2


def _close(got, want, tol, what):
    got, want = f32(got), f32(want)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), f"{what}: max|Δ| {err}"


@pytest.mark.parametrize("attention,activation,seed", CASES)
def test_hybrid_forward_matches_jax(monkeypatch, attention, activation, seed):
    monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    _forward_case(attention, activation, seed)


def _forward_case(attention, activation, seed):
    jcfg, cfg = hybrid_cfgs()
    jquant, quant = hybrid_quants(attention, activation)
    jparams = calm_experts(jax_fold(jax_init(jcfg, jquant, jax.random.PRNGKey(0)), jcfg, jquant))
    prefill_fn, decode_fn, _ = make_forward_fns(jcfg, jquant)
    chunk_fn = jax.jit(make_chunk_prefill_fn(jcfg, jquant, history=128))
    prefill_fn, decode_fn = jax.jit(prefill_fn), jax.jit(decode_fn)
    params = port_params(jparams)
    cache = init_cache(cfg, quant, 1, MAX_LEN, "cpu")
    jcache = jax_init_cache(jcfg, jquant, 1, MAX_LEN)

    rng = np.random.default_rng(seed)
    n1, n2 = 40, 30
    prompt = rng.integers(1, cfg.vocab_size, size=n1 + n2)
    # both chunks padded to 128 rows on both sides: the second starts from the
    # first's DeltaNet state and conv window, which the padding must not touch
    for n, chunk in ((n1, prompt[:n1]), (n2, prompt[n1:])):
        tok = np.zeros((1, 128), np.int32)
        tok[0, :n] = chunk
        fn = prefill_fn if n == n1 else chunk_fn
        jl, jcache = fn(jparams, jnp.asarray(tok), jnp.asarray([n], jnp.int32), jcache)
        pl_ = forward(params, torch.from_numpy(tok).long(),
                      torch.tensor([n], dtype=torch.int32), cache, cfg, quant, prefill=True,
                      history=0 if n == n1 else 128)
        _close(pl_, jl, PREFILL_TOL, f"prefill logits after {int(cache['length'][0])} tokens")
    assert int(cache["length"][0]) == int(jcache["length"][0]) == n1 + n2
    # layer 0 (DeltaNet) sees only the embeddings, so its state is tight
    jst = np.asarray(jcache["pattern"][0]["state"])
    np.testing.assert_allclose(f32(cache["layers"][0]["state"]), jst[0], rtol=1e-3, atol=1e-5)
    np.testing.assert_array_equal(f32(cache["layers"][0]["conv"]),
                                  np.asarray(jcache["pattern"][0]["conv"][0], np.float32))

    nxt = int(np.argmax(f32(jl)[0]))
    for step in range(3):
        jl, jcache = decode_fn(jparams, jnp.asarray([[nxt]], jnp.int32), jcache)
        pl_ = forward(params, torch.tensor([[nxt]]), torch.ones(1, dtype=torch.int32),
                      cache, cfg, quant, prefill=False)
        assert torch.isfinite(pl_).all()
        _close(pl_, jl, DECODE_TOL, f"decode step {step} logits")
        nxt = int(np.argmax(f32(jl)[0]))
