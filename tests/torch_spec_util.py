"""Shared set-up of the speculative-decoding tests (``test_torch_mtp.py``,
``test_torch_spec_ngram.py``, ``test_torch_spec_scheduler.py``): tiny
configurations with an MTP module, the JAX package's weights bridged into
the port, and the prompts held free of greedy near-ties.

Tiny random models have nearly flat logits, and a verify step's forward
over k + 1 rows takes other numerics than a one-row decode step (at T > 1
the tiny MoE takes the grouped regime with bf16 rows; at T = 1 the
gathered one with int8 rows). So the expert stacks are scaled down on both
sides (``calm``) and every prompt here is checked free of top-2 ties over
its greedy steps (``min_top2_gap``), with more room than the two paths
move apart.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.config import preset_config as jax_preset_config
from krasis_tpu.models.params import init_synthetic_params as jax_init
from krasis_tpu.quant import QTensor as JaxQTensor
from krasis_tpu.runtime.engine import Engine as JaxEngine
from krasis_tpu_torch.config import QuantConfig, preset_config
from krasis_tpu_torch.ops.sampling import SamplingParams
from krasis_tpu_torch.runtime.engine import Engine

from torch_port_util import port_params

CONFIGS = {
    "v2-lite": ("deepseek-v2-lite", dict(
        hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
        num_hidden_layers=2, num_attention_heads=4, kv_lora_rank=32, vocab_size=256,
        n_routed_experts=8, num_experts_per_tok=2, num_nextn_predict_layers=1)),
    "qwen3-moe": ("qwen3-moe", dict(
        hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        vocab_size=256, head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
        num_nextn_predict_layers=1)),
    "hybrid": ("qwen3-coder-next", dict(
        hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        vocab_size=256, head_dim=16,
        layer_types=["linear_attention", "linear_attention", "linear_attention",
                     "full_attention"],
        linear_num_key_heads=2, linear_num_value_heads=4,
        linear_key_head_dim=16, linear_value_head_dim=16,
        n_routed_experts=8, num_experts_per_tok=2, shared_expert_intermediate_size=32)),
}
QUANT = dict(expert_bits=4, group_size=32, kv_cache_dtype="bf16")
GREEDY = SamplingParams(temperature=0.0)
NO_STOP = {-1}
# the port's logits sit within 0.0074 of the JAX package's on these models
# (tests/test_torch_scheduler.py), and a verify step's within 0.001 of the
# one-row decode step's; a prompt's greedy steps keep their top two logits
# further apart than this
GAP = 0.02
NEW = 12
# 8-id prompts (``prompt``) whose NEW greedy steps keep a top-two gap over GAP
SEEDS = {"v2-lite": (75, 92, 108, 157), "qwen3-moe": (57, 132, 137, 165),
         "hybrid": (140, 183, 191, 205)}


def _calm_layer(lp, factor=0.125):
    """Scale a layer's expert stacks by a power of two (exact in bf16, and
    the same on both sides): off the router near-ties and the MoE noise
    that dominates these tiny models' logits."""
    return {k: (JaxQTensor(v.q, v.scales * factor, v.bits, v.group_size)
                if k in ("w13", "w2", "shared_w13", "shared_w2") else v)
            for k, v in lp.items()}


def calm(jparams):
    """``_calm_layer`` on every layer, the MTP module's included."""
    out = {**jparams, "prefix_layers": [_calm_layer(lp) for lp in jparams["prefix_layers"]],
           "pattern": [_calm_layer(lp) for lp in jparams["pattern"]]}
    if "mtp" in jparams:
        out["mtp"] = {**jparams["mtp"], "layer": _calm_layer(jparams["mtp"]["layer"])}
    return out


@contextlib.contextmanager
def spec_env(mode=None, k=None):
    """The reference's environment names set for `mode` / `k` (None leaves
    a name unset) and KRASIS_TPU_NO_SPEC unset, while an engine or a
    scheduler is built: ``spec_config`` reads them there."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (("KRASIS_TPU_SPEC_MODE", mode), ("KRASIS_TPU_SPEC_K", k),
                            ("KRASIS_TPU_NO_SPEC", None)):
            if value is None:
                mp.delenv(name, raising=False)
            else:
                mp.setenv(name, str(value))
        yield


def prompt(seed, n=8, vocab=250):
    return np.random.default_rng(seed).integers(1, vocab, size=n).tolist()


class Models:
    """Per configuration: both packages' configs, quants and params over the
    same weights, and JAX engines made when first asked for."""

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

    def engine(self, name, max_len=512, mode=None, k=None):
        """The port's engine on the CPU, its spec mode and depth set through
        the environment (``spec_env``)."""
        cfg, quant, params = self.port(name)
        with spec_env(mode, k):
            return Engine(cfg, quant, params, max_len=max_len, device="cpu")

    def jax_engine(self, name, max_len=512):
        """One JAX engine a configuration and length (its spec mode from
        the environment when first built)."""
        if (name, max_len) not in self._jax:
            jcfg, jquant, jparams = self.get(name)[:3]
            self._jax[(name, max_len)] = JaxEngine(jcfg, jquant, jparams, max_len=max_len)
        return self._jax[(name, max_len)]


def greedy(eng, ids, new, spec, **kw):
    """The engine's greedy stream with speculative decoding on or off (the
    reference's tests toggle ``spec_available`` the same way)."""
    from krasis_tpu.ops.sampling import SamplingParams as JaxSamplingParams

    saved = eng.spec_available
    eng.spec_available = spec
    try:
        sp = GREEDY if isinstance(eng, Engine) else JaxSamplingParams(temperature=0.0)
        return eng.generate(list(ids), max_new_tokens=new, sampling=sp, stop_ids=NO_STOP, **kw)
    finally:
        eng.spec_available = saved


def min_top2_gap(eng, ids, tokens):
    """Teacher-force `tokens` after `ids` through the port's one-row decode;
    the smallest gap between the two largest logits over the steps."""
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
