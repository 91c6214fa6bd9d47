"""Helpers for the tests that compare the PyTorch port with the JAX package:
moving JAX arrays, QTensors and parameter trees into the port via numpy."""

import logging
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.config import preset_config as jax_preset_config
from krasis_tpu.models.synthetic import build_synthetic_engine as jax_build_engine
from krasis_tpu.models.synthetic import tiny_config as jax_tiny_config
from krasis_tpu.ops import gmm_pallas, moe_pallas
from krasis_tpu.quant import QTensor as JaxQTensor
from krasis_tpu_torch.config import QuantConfig, preset_config
from krasis_tpu_torch.models.bridge import params_from_numpy, to_torch
from krasis_tpu_torch.models.synthetic import tiny_config
from krasis_tpu_torch.ops import expert_class
from krasis_tpu_torch.quant import QTensor

# One PyTorch thread per test process. Tier-1 runs six xdist workers on the
# machine's cores, and each worker's OpenMP pool (a thread per core) spins at
# the barrier of every parallel region; at these tiny shapes that made six
# concurrent runs of tests/test_torch_q8_engine.py take 412 s each, against
# 31 s with one thread (8 cores). Every worker imports every collected test
# module, this one included, so the whole run takes the setting.
torch.set_num_threads(1)


@pytest.fixture
def run_log_dir(monkeypatch, tmp_path):
    """For a test that calls the port's ``server.main``: main opens its run
    log (``runlog.setup_run_logging``) in the working directory and hooks
    sys.excepthook and the root logger. Run it in a temporary directory and
    put the hook, the handlers and the package logger's level back after."""
    monkeypatch.chdir(tmp_path)
    root, pkg = logging.getLogger(), logging.getLogger("krasis_tpu_torch")
    handlers, level, hook = list(root.handlers), pkg.level, sys.excepthook
    yield tmp_path
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    pkg.setLevel(level)
    sys.excepthook = hook


def to_numpy_tree(tree):
    """JAX parameter tree → numpy leaves, QTensors as {q, scales, bits, group_size}."""
    if isinstance(tree, JaxQTensor):
        return {"q": np.asarray(tree.q), "scales": np.asarray(tree.scales),
                "bits": tree.bits, "group_size": tree.group_size}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def port_params(jax_params):
    return params_from_numpy(to_numpy_tree(jax_params), device="cpu")


def t(a) -> torch.Tensor:
    """A JAX or numpy array as a CPU torch tensor, bit-exact."""
    return to_torch(np.asarray(a), "cpu")


def tq(qt: JaxQTensor) -> QTensor:
    return QTensor(t(qt.q), t(qt.scales), qt.bits, qt.group_size)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def hybrid_cfgs(**kw):
    """(JAX config, port config) of the tiny Qwen3-Coder-Next hybrid: two
    repetitions of [DeltaNet, DeltaNet, DeltaNet, GQA] unless overridden."""
    cfg = tiny_config("qwen3-coder-next", **kw)
    over = {k: getattr(cfg, k) for k in (
        "hidden_size", "intermediate_size", "moe_intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "vocab_size", "head_dim", "layer_types",
        "linear_num_key_heads", "linear_num_value_heads", "linear_key_head_dim",
        "linear_value_head_dim", "n_routed_experts", "num_experts_per_tok",
        "shared_expert_intermediate_size")}
    return jax_preset_config("qwen3-coder-next", **over), cfg


def hybrid_quants(attention="int8", activation="int8"):
    kw = dict(expert_bits=4, group_size=128, kv_cache_dtype="bf16", attention=attention,
              expert_activation=activation)
    return JaxQuantConfig(**kw), QuantConfig(**kw)


def calm_experts(jparams, factor=0.125):
    """Synthetic expert stacks put out values ~60x those of the attention
    and DeltaNet layers, so the MoE drowns every other layer, and its random
    router sits on near-ties that rounding noise breaks differently on the
    two sides (a different expert then moves the logits by 0.3 and more).
    Scale the experts' group scales by a power of two: exact in bf16, and
    the same on both sides, since the port is bridged from this tree."""
    def scale(qt):
        return JaxQTensor(qt.q, qt.scales * factor, qt.bits, qt.group_size)
    pattern = [{k: (scale(v) if k in ("w13", "w2", "shared_w13", "shared_w2") else v)
                for k, v in lp.items()} for lp in jparams["pattern"]]
    return {**jparams, "pattern": pattern}


Q8_OVERRIDES = dict(moe_intermediate_size=128, num_hidden_layers=3)


def q8_engines(monkeypatch, activation, max_len=1024):
    """(JAX engine, port engine, calls) of a tiny DeepSeek-V2-Lite with int8
    experts on the same weights, both built with the fused-class limits of
    both packages shrunk so that the tiny experts are in the two-stage
    class, as the full-size model's int8 experts are. `calls` counts the
    reference's traces through moe_gathered_tiled and gmm."""
    from krasis_tpu_torch.runtime.engine import Engine

    monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(moe_pallas, "_MAX_W_BYTES", 1024)
    monkeypatch.setattr(gmm_pallas, "_MAX_FUSED_BLOCK", 1024)
    monkeypatch.setattr(expert_class, "MAX_FUSED_PICK_BYTES", 1024)
    monkeypatch.setattr(expert_class, "MAX_FUSED_BLOCK_BYTES", 1024)
    calls = {"moe_gathered_tiled": 0, "gmm": 0}
    for mod, name in ((moe_pallas, "moe_gathered_tiled"), (gmm_pallas, "gmm")):
        def counted(*a, _f=getattr(mod, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    kw = dict(expert_bits=8, group_size=128, kv_cache_dtype="bf16",
              expert_activation=activation)
    jeng = jax_build_engine(jax_tiny_config("deepseek-v2-lite", **Q8_OVERRIDES),
                            JaxQuantConfig(**kw), max_len=max_len, seed=0)
    # int8 experts made of random bytes put out 16x the values of int4 ones
    jeng.params = calm_experts(jeng.params, 1 / 16)
    eng = Engine(tiny_config("deepseek-v2-lite", **Q8_OVERRIDES), QuantConfig(**kw),
                 port_params(jeng.params), max_len=max_len, device="cpu")
    return jeng, eng, calls


GPTOSS_TINY = dict(hidden_size=64, intermediate_size=32, moe_intermediate_size=32,
            num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
            vocab_size=256, head_dim=16, sliding_window=4,
            layer_types=["sliding_attention", "full_attention"] * 2,
            n_routed_experts=8, num_experts_per_tok=2)
GPTOSS_LEAVES = {  # scale of each random leaf
                 "sinks": 1.0, "gate_logit_bias": 0.5, "q_bias": 0.05, "k_bias": 0.05,
                 "v_bias": 0.05, "o_bias": 0.05, "w13_bias": 0.05, "w2_bias": 0.05}


def gptoss_cfgs():
    """(JAX config, port config) of the tiny GPT-OSS of tests/test_model.py:
    sliding (window 4) and full layers, 8 experts top-2, heads of 16."""
    return (jax_preset_config("gpt-oss-20b", **GPTOSS_TINY),
            preset_config("gpt-oss-20b", **GPTOSS_TINY))


def gptoss_quants(kv, **kw):
    q = dict(expert_bits=4, group_size=32, kv_cache_dtype=kv, **kw)
    return JaxQuantConfig(**q), QuantConfig(**q)


def randomize_gptoss(jparams, seed=0):
    """Random nonzero sinks, projection and expert biases and router logit
    biases (the synthetic init leaves them at zero), in their own dtypes."""
    rng = np.random.default_rng(seed)

    def layer(lp):
        return {k: (jnp.asarray(rng.standard_normal(v.shape) * GPTOSS_LEAVES[k], v.dtype)
                    if k in GPTOSS_LEAVES else v) for k, v in lp.items()}
    return {**jparams, "prefix_layers": [layer(lp) for lp in jparams["prefix_layers"]],
            "pattern": [layer(lp) for lp in jparams["pattern"]]}
