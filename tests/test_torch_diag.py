"""KRASIS_TPU_DIAG (krasis_tpu_torch/timing.py TIMING, printed by the layer
step of models/model.py) against the reference's jax.debug.print in
krasis_tpu/models/model.py make_layer_step: one prefill of a tiny
DeepSeek-V2-Lite and of a tiny Qwen3-Coder-Next hybrid prints one
``[diag] {kind} in_rms=...`` line a layer, of the same count and kinds in
the same order, each in_rms within 1e-2 relative of the reference's (the
JAX Pallas kernels in interpret mode); the flag off prints nothing."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu import timing as jtiming
from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.models.model import make_forward_fns
from krasis_tpu.models.params import fold_shared_experts as jax_fold
from krasis_tpu.models.params import init_synthetic_params as jax_init
from krasis_tpu.models.synthetic import tiny_config as jax_tiny_config
from krasis_tpu.runtime.kv_cache import init_cache as jax_init_cache
from krasis_tpu_torch import timing
from krasis_tpu_torch.config import QuantConfig
from krasis_tpu_torch.models.model import forward
from krasis_tpu_torch.models.synthetic import tiny_config
from krasis_tpu_torch.runtime.kv_cache import init_cache

from torch_port_util import hybrid_cfgs, port_params

LINE = re.compile(r"^\[diag\] (\S+) in_rms=([0-9.]+)$")
RTOL = 1e-2
QUANT = dict(expert_bits=4, group_size=128, kv_cache_dtype="bf16")


def _cfgs(kind):
    if kind == "v2-lite":
        over = dict(moe_intermediate_size=128, num_hidden_layers=4)
        return jax_tiny_config("deepseek-v2-lite", **over), tiny_config("deepseek-v2-lite", **over)
    return hybrid_cfgs()


def _diag(text):
    return [(m.group(1), float(m.group(2))) for m in map(LINE.match, text.splitlines()) if m]


@pytest.mark.parametrize("kind", ["v2-lite", "hybrid"])
def test_diag_lines_match_the_reference(monkeypatch, capfd, kind):
    monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    jcfg, cfg = _cfgs(kind)
    jquant, quant = JaxQuantConfig(**QUANT), QuantConfig(**QUANT)
    jparams = jax_fold(jax_init(jcfg, jquant, jax.random.PRNGKey(0)), jcfg, jquant)
    params = port_params(jparams)
    n = 8
    tok = np.zeros((1, 128), np.int32)
    tok[0, :n] = np.random.default_rng(3).integers(1, cfg.vocab_size, n)

    monkeypatch.setattr(jtiming.TIMING, "diag", True)
    prefill_fn, _, _ = make_forward_fns(jcfg, jquant)     # traced with the flag on
    jl, _ = jax.jit(prefill_fn)(jparams, jnp.asarray(tok), jnp.asarray([n], jnp.int32),
                                jax_init_cache(jcfg, jquant, 1, 256))
    jl.block_until_ready()
    jax.effects_barrier()
    want = _diag(capfd.readouterr().out)

    monkeypatch.setattr(timing.TIMING, "diag", True)
    forward(params, torch.from_numpy(tok).long(), torch.tensor([n], dtype=torch.int32),
            init_cache(cfg, quant, 1, 256, "cpu"), cfg, quant, prefill=True)
    got = _diag(capfd.readouterr().out)

    assert len(got) == len(want) == cfg.num_hidden_layers
    assert [k for k, _ in got] == [k for k, _ in want]
    assert len({k for k, _ in got}) == (2 if kind == "hybrid" else 1)
    for (_, g), (_, w) in zip(got, want):
        assert abs(g - w) <= RTOL * abs(w) + 1e-4, (got, want)

    monkeypatch.setattr(timing.TIMING, "diag", False)
    forward(params, torch.from_numpy(tok).long(), torch.tensor([n], dtype=torch.int32),
            init_cache(cfg, quant, 1, 256, "cpu"), cfg, quant, prefill=True)
    assert _diag(capfd.readouterr().out) == []


def test_flags_read_the_reference_environment(monkeypatch):
    for value, want_diag in (("1", True), ("0", False)):
        monkeypatch.setenv("KRASIS_TPU_DIAG", value)
        assert timing._Timing().diag == jtiming._Timing().diag == want_diag
    monkeypatch.delenv("KRASIS_TPU_DIAG")
    assert timing._Timing().diag is jtiming._Timing().diag is False
