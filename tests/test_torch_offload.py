"""The port's host-RAM expert store (krasis_tpu_torch/offload.py and
native/hostmoe.cpp) against its plain version and the JAX package's store.

The cases of tests/test_offload.py that hold the store itself: the C++
engine against its plain version (relative error < 2e-6 at int4 and int8,
both of the engine's regimes), every SIMD tier through KRASISH_FORCE_TIER,
negative ids skipped, the GPT-OSS activation and biases, ``nbytes`` and
``layers``; then the port against the reference: ``build_synthetic_store``
bit-equal for a seed, ``forward`` against the JAX store's on the same bytes,
``store_from_params`` and ``build_hot_params`` leaf for leaf, and the
host-link pair ``dispatch`` / ``collect``. The engine runs one OpenMP thread
here (``threads=1``): the tier-1 run has six workers on the machine's cores.
"""

import jax
import numpy as np
import pytest
import torch

from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.models.params import init_synthetic_params as jax_init
from krasis_tpu.models.synthetic import tiny_config as jax_tiny_config
from krasis_tpu.offload import build_hot_params as jax_build_hot_params
from krasis_tpu.offload import build_synthetic_store as jax_build_store
from krasis_tpu.offload import hot_expert_ids as jax_hot_expert_ids
from krasis_tpu.offload import store_from_params as jax_store_from_params
from krasis_tpu_torch import native
from krasis_tpu_torch.config import QuantConfig
from krasis_tpu_torch.models.synthetic import tiny_config
from krasis_tpu_torch.offload import (HostExpertStore, build_hot_params, build_synthetic_store,
                                      hot_expert_ids, store_from_params)
from krasis_tpu_torch.ops.moe import moe_forward_gathered
from krasis_tpu_torch.quant import QTensor

from torch_port_util import port_params

MLA_KW = dict(kv_lora_rank=64, q_lora_rank=None, qk_nope_head_dim=32,
              qk_rope_head_dim=16, v_head_dim=32)
TIERS = ("avx512", "avx2", "scalar")


def _rand_inputs(rng, T, k, H, E):
    x = rng.standard_normal((T, H)).astype(np.float32) * 0.1
    idx = rng.integers(0, E, (T, k)).astype(np.int32)
    w = rng.random((T, k)).astype(np.float32)
    return x, idx, w


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _store(preset, bits=4, seed=1, **kw):
    return build_synthetic_store(tiny_config(preset, **kw), QuantConfig(expert_bits=bits),
                                 seed=seed, threads=1)


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as numpy (bf16 as uint16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _same_entry(port_entry, jax_entry):
    for a, b in zip(port_entry, jax_entry):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(_np(a), np.asarray(b)), (a.shape, b.shape)


# ---------------------------------------------------------------------------
# The C++ engine against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("I", [192, 128])  # 192: I/2 not a multiple of gs
def test_native_vs_plain(bits, I):
    store = _store("deepseek-v2-lite", bits, moe_intermediate_size=I, hidden_size=256, **MLA_KW)
    rng = np.random.default_rng(0)
    layer = store.layers[0]
    for T in (1, 7):  # the column-parallel and the pick-parallel regimes
        x, idx, w = _rand_inputs(rng, T, 3, store.H, store.E)
        native_out = store.forward(layer, x, idx, w)
        plain = store.forward(layer, x, idx, w, plain=True)
        assert _rel(native_out, plain) < 2e-6, (bits, I, T)


@pytest.mark.parametrize("tier", TIERS)
def test_simd_tiers_bit_agree(tier, monkeypatch):
    """Every SIMD tier (KRASISH_FORCE_TIER pins one at create time) agrees
    with the plain version within 2e-6, at both bits and with a
    non-gs-aligned I (the hi-nibble group offset), and gives the same bits on
    a second engine. Tiers are not bit-equal to each other: AVX-512, AVX2
    and scalar FMA in different orders."""
    monkeypatch.setenv("KRASISH_FORCE_TIER", tier)
    for bits, I in ((4, 192), (4, 128), (8, 192)):
        runs = []
        for _ in range(2):
            store = _store("deepseek-v2-lite", bits, moe_intermediate_size=I, hidden_size=256,
                           **MLA_KW)
            if store.native_tier() != tier:
                pytest.skip(f"this CPU lacks {tier}")
            rng = np.random.default_rng(0)
            layer = store.layers[0]
            runs.append([])
            for T in (1, 7):
                x, idx, w = _rand_inputs(rng, T, 3, store.H, store.E)
                got = store.forward(layer, x, idx, w)
                assert _rel(got, store.forward(layer, x, idx, w, plain=True)) < 2e-6
                runs[-1].append(got)
        for a, b in zip(*runs):
            assert np.array_equal(a, b), (tier, bits, I)


def test_negative_id_skips():
    """id < 0 contributes nothing, as a zero weight does."""
    store = _store("qwen3-moe", seed=3)
    rng = np.random.default_rng(2)
    layer = store.layers[0]
    x, idx, w = _rand_inputs(rng, 4, 2, store.H, store.E)
    idx2 = idx.copy()
    idx2[1, 0] = -1
    w2 = w.copy()
    w2[1, 0] = 0.0
    for plain in (False, True):
        np.testing.assert_allclose(store.forward(layer, x, idx2, w, plain=plain),
                                   store.forward(layer, x, idx, w2, plain=plain),
                                   rtol=1e-6, atol=1e-7)


def test_gpt_oss_activation_and_bias():
    """GPT-OSS's clamped activation and per-expert biases, C++ against plain."""
    cfg = tiny_config("gpt-oss-20b", num_hidden_layers=4, head_dim=32)
    store = build_synthetic_store(cfg, QuantConfig(), seed=4, threads=1)
    layer = store.layers[0]
    e = list(store._layers[layer])
    g = torch.Generator().manual_seed(3)
    e[4] = torch.randn(e[4].shape, generator=g) * 0.05
    e[5] = torch.randn(e[5].shape, generator=g) * 0.05
    store.add_layer(layer, *e)
    x, idx, w = _rand_inputs(np.random.default_rng(3), 3, 2, store.H, store.E)
    assert _rel(store.forward(layer, x, idx, w), store.forward(layer, x, idx, w, plain=True)) \
        < 2e-6
    assert store.gpt_oss and store.swiglu_limit == 7.0


def test_store_nbytes_and_layers():
    cfg = tiny_config("deepseek-v2-lite", **MLA_KW)
    store = build_synthetic_store(cfg, QuantConfig(), seed=0)
    jstore = jax_build_store(jax_tiny_config("deepseek-v2-lite", **MLA_KW), JaxQuantConfig(),
                             seed=0)
    # layer 0 is dense (first_k_dense_replace = 1): not in the store
    assert 0 not in store.layers and store.layers == jstore.layers
    assert store.nbytes() == jstore.nbytes() > 0
    assert store.layer_nbytes() * len(store.layers) == store.nbytes()


def test_threads_and_failed_build(monkeypatch, tmp_path):
    """The thread count reaches the engine; a source that does not compile
    raises (there is no fallback to the plain version)."""
    store = _store("qwen3-moe")
    store.threads = 2
    assert store.native_threads() == 2
    bad = tmp_path / "hostmoe.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_hostmoe", None)
    monkeypatch.setattr(native, "HOSTMOE_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="did not build"):
        _store("qwen3-moe").forward(1, *_rand_inputs(np.random.default_rng(0), 1, 2, 128, 8))


# ---------------------------------------------------------------------------
# The port's store against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset,kw,bits", [
    ("qwen3-moe", {}, 4), ("deepseek-v2-lite", MLA_KW, 8),
    ("gpt-oss-20b", dict(num_hidden_layers=4, head_dim=32), 4)])
def test_synthetic_store_bit_equal_to_jax(preset, kw, bits):
    store = build_synthetic_store(tiny_config(preset, **kw), QuantConfig(expert_bits=bits),
                                  seed=7)
    jstore = jax_build_store(jax_tiny_config(preset, **kw), JaxQuantConfig(expert_bits=bits),
                             seed=7)
    assert store.layers == jstore.layers
    for layer in store.layers:
        _same_entry(store._layers[layer], jstore._layers[layer])


@pytest.mark.parametrize("bits", [4, 8])
def test_forward_matches_jax_store(bits):
    """The same bytes, the same picks: the port's engine against the JAX
    store's forward (its own C++ engine, or its numpy version where that
    one did not build), 2e-6 relative."""
    kw = dict(moe_intermediate_size=192, hidden_size=256, **MLA_KW)
    store = build_synthetic_store(tiny_config("deepseek-v2-lite", **kw),
                                  QuantConfig(expert_bits=bits), seed=2, threads=1)
    jstore = jax_build_store(jax_tiny_config("deepseek-v2-lite", **kw),
                             JaxQuantConfig(expert_bits=bits), seed=2)
    rng = np.random.default_rng(5)
    for layer in store.layers[:2]:
        for T in (1, 5):
            x, idx, w = _rand_inputs(rng, T, 3, store.H, store.E)
            idx[0, 1] = -1
            want = jstore.forward(layer, x, idx, w)
            assert _rel(store.forward(layer, x, idx, w), want) < 2e-6
            assert _rel(store.forward(layer, x, idx, w, plain=True), want) < 2e-6


def test_store_vs_device_oracle():
    """The store's numerics against the gathered MoE's plain version on the
    same quantized bytes (bf16 activations: 2e-3, the reference's limit)."""
    cfg = tiny_config("deepseek-v2-lite", hidden_size=256, moe_intermediate_size=192, **MLA_KW)
    store = build_synthetic_store(cfg, QuantConfig(), seed=2, threads=1)
    layer = store.layers[0]
    e = store._layers[layer]
    x, idx, w = _rand_inputs(np.random.default_rng(1), 5, 3, store.H, store.E)
    w13 = QTensor(e[0], e[1], store.bits, store.gs13)
    w2 = QTensor(e[2], e[3], store.bits, store.gs2)
    dev = moe_forward_gathered(torch.from_numpy(x), w13, w2, torch.from_numpy(idx),
                               torch.from_numpy(w)).numpy()
    assert _rel(store.forward(layer, x, idx, w), dev) < 2e-3


@pytest.mark.parametrize("preset,kw", [
    ("qwen3-moe", {}), ("deepseek-v2-lite", dict(MLA_KW, num_hidden_layers=5)),
    ("gpt-oss-20b", dict(num_hidden_layers=4, head_dim=32))])
def test_store_from_params_matches_jax(preset, kw):
    """From the same (bridged) weights: the same store bytes as the
    reference's store_from_params, folded virtual rows cut off, and a device
    tree without routed stacks that leaves the input tree as it was."""
    jcfg, jquant = jax_tiny_config(preset, **kw), JaxQuantConfig()
    jparams = jax_init(jcfg, jquant, jax.random.PRNGKey(3))
    _, jstore = jax_store_from_params(jcfg, jquant, jparams)
    cfg = tiny_config(preset, **kw)
    params = port_params(jparams)
    dev, store = store_from_params(cfg, QuantConfig(), params)
    assert store.layers == jstore.layers
    for layer in store.layers:
        _same_entry(store._layers[layer], jstore._layers[layer])
        assert "w13" not in dev["layers"][layer] and "w13" in params["layers"][layer]
        assert store._layers[layer][0].shape[0] == cfg.n_routed_experts


def test_hot_expert_ids():
    """Top counts, sorted; the first n while a layer has no counts."""
    store = _store("qwen3-moe")
    jstore = jax_build_store(jax_tiny_config("qwen3-moe"), JaxQuantConfig(), seed=1)
    layer = store.layers[0]
    for s in (store, jstore):
        s.heatmap[layer] = np.array([0, 9, 1, 8, 0, 7, 0, 2], np.int64)
    assert hot_expert_ids(store, layer, 3).tolist() == [1, 3, 5] \
        == jax_hot_expert_ids(jstore, layer, 3).tolist()
    store.heatmap.pop(layer)
    assert hot_expert_ids(store, layer, 3).tolist() == [0, 1, 2]


@pytest.mark.parametrize("preset,kw", [
    ("qwen3-moe", {}), ("gpt-oss-20b", dict(num_hidden_layers=4, head_dim=32))])
def test_build_hot_params_matches_jax(preset, kw):
    """The hot substacks, remap and (GPT-OSS) biases equal the reference's
    for the same heatmap, and a second build writes into the same buffers."""
    jcfg, jquant = jax_tiny_config(preset, **kw), JaxQuantConfig()
    jparams = jax_init(jcfg, jquant, jax.random.PRNGKey(3))
    jdev, jstore = jax_store_from_params(jcfg, jquant, jparams)
    cfg = tiny_config(preset, **kw)
    dev, store = store_from_params(cfg, QuantConfig(), port_params(jparams))
    rng = np.random.default_rng(4)
    heat = {layer: rng.integers(0, 20, cfg.n_routed_experts) for layer in store.layers}
    jhot = port_params(jax_build_hot_params(jcfg, jquant, jdev, jstore, 3, heatmap=heat))
    hot = build_hot_params(cfg, QuantConfig(), dev, store, 3, heatmap=heat)
    names = ("hot_w13", "hot_w2", "hot_remap", "hot_w13_bias", "hot_w2_bias")
    for layer in store.layers:
        got, want = hot["layers"][layer], jhot["layers"][layer]
        assert {n for n in names if n in got} == {n for n in names if n in want}
        for n in names:
            if n in got:
                g, w = got[n], want[n]
                pairs = [(g.q, w.q), (g.scales, w.scales)] if isinstance(g, QTensor) \
                    else [(g, w)]
                for a, b in pairs:
                    assert torch.equal(a, b), (layer, n)
    ptrs = [hot["layers"][layer]["hot_w13"].q.data_ptr() for layer in store.layers]
    heat2 = {layer: rng.integers(0, 20, cfg.n_routed_experts) for layer in store.layers}
    again = build_hot_params(cfg, QuantConfig(), hot, store, 3, heatmap=heat2)
    assert [again["layers"][layer]["hot_w13"].q.data_ptr() for layer in store.layers] == ptrs
    for layer in store.layers:
        ids = torch.from_numpy(hot_expert_ids(store, layer, 3, heat2).astype(np.int64))
        assert torch.equal(again["layers"][layer]["hot_w13"].q, store._layers[layer][0][ids])


def test_dispatch_collect():
    """The host-link pair on CPU tensors equals one forward call, and the
    counters count the call and its live picks."""
    store = _store("qwen3-moe")
    layer = store.layers[-1]
    x, idx, w = _rand_inputs(np.random.default_rng(6), 3, 2, store.H, store.E)
    idx[2, 1] = -1
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = store.forward(layer, xb.to(torch.float32).numpy(), idx, w)
    calls, picks = store.host_calls, store.host_picks
    got = store.collect(layer, store.dispatch(xb, torch.from_numpy(idx), torch.from_numpy(w)),
                        torch.device("cpu"))
    assert np.array_equal(got.numpy(), want)
    assert (store.host_calls - calls, store.host_picks - picks) == (1, 5)
    assert store.heatmap[layer].sum() > 0


def test_plain_store_runs_plain(monkeypatch):
    """plain=True on the store reaches _forward_plain and never builds the
    C++ engine."""
    cfg = tiny_config("qwen3-moe")
    store = HostExpertStore(cfg, QuantConfig(), plain=True)
    src = _store("qwen3-moe")
    for layer in src.layers:
        store.add_layer(layer, *src._layers[layer])
    x, idx, w = _rand_inputs(np.random.default_rng(7), 2, 2, store.H, store.E)
    want = src.forward(src.layers[0], x, idx, w)
    monkeypatch.setattr(native, "load_hostmoe", None)   # a call would raise TypeError
    assert _rel(store.forward(store.layers[0], x, idx, w), want) < 2e-6
    assert store._handle is None
