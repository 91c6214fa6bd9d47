"""The teacher-forced decode step (krasis_tpu_torch/models/model.py
forced_decode) against the JAX make_forced_decode_fn on the same tiny
Qwen3-MoE weights (through the bridge), and against the port's own prefill
all-logits path at the bounds of tests/test_quality_matrix.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.models.model import make_forced_decode_fn
from krasis_tpu.models.synthetic import build_synthetic_engine as jax_build
from krasis_tpu.models.synthetic import tiny_config as jax_tiny_config
from krasis_tpu.runtime.engine import pick_bucket
from krasis_tpu_torch.config import QuantConfig
from krasis_tpu_torch.models.model import forced_decode
from krasis_tpu_torch.models.synthetic import tiny_config
from krasis_tpu_torch.runtime.engine import Engine

from torch_port_util import calm_experts, port_params

QUANT = dict(expert_bits=4, group_size=32, kv_cache_dtype="bf16")
N = 192
# the two packages' decode log-probabilities: the same function, rounded
# at the same points; what remains is bf16 rounding order
JAX_ATOL = 2e-2
PREFILL_ATOL, PREFILL_MEAN = 0.15, 0.01


@pytest.fixture(scope="module")
def engines():
    jeng = jax_build(jax_tiny_config("qwen3-moe"), JaxQuantConfig(**QUANT), max_len=256)
    # the expert stacks scaled by 1/8 on both sides, so that no token's
    # routing sits on a near-tie that the two packages' rounding breaks
    # differently (tests/torch_port_util.py calm_experts)
    calmed = calm_experts({**jeng.params, "pattern": jeng.params["prefix_layers"]})
    jeng.params = calm_experts({**jeng.params, "prefix_layers": calmed["pattern"]})
    eng = Engine(tiny_config("qwen3-moe"), QuantConfig(**QUANT), port_params(jeng.params),
                 max_len=256, device="cpu")
    ids = np.random.default_rng(0).integers(5, eng.cfg.vocab_size - 5, size=N).tolist()
    return jeng, eng, ids


def _port_forced(eng, ids):
    eng.reset(256)
    with torch.inference_mode():
        eng._prefill_prompt(ids[:1])
        return forced_decode(eng.params, eng.cache, torch.tensor([ids[1:]]), eng.cfg,
                             eng.quant)[0].numpy()


def test_forced_decode_matches_jax(engines):
    jeng, eng, ids = engines
    steps = len(ids) - 2
    fn = jax.jit(make_forced_decode_fn(jeng.cfg, jeng.quant, steps))
    jeng.reset(256)
    tokens = np.zeros((1, pick_bucket(1)), np.int32)
    tokens[0, 0] = ids[0]
    _, jeng.cache = jeng._prefill(jeng.params, jnp.asarray(tokens),
                                  jnp.asarray([1], np.int32), jeng.cache)
    toks = np.zeros((1, steps + 1), np.int32)
    toks[0] = ids[1:]
    want = np.asarray(fn(jeng.params, jnp.asarray(toks), jeng.cache)[0][0], np.float32)
    got = _port_forced(eng, ids)
    assert got.shape == (steps,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=JAX_ATOL)
    assert np.abs(got - want).mean() < 2e-3


def test_forced_decode_matches_own_prefill(engines):
    _, eng, ids = engines
    with torch.inference_mode():
        lsm = torch.log_softmax(eng.forward_all_logits(ids).to(torch.float32), dim=-1)
    lp_pre = lsm[:-1].gather(1, torch.tensor(ids[1:])[:, None])[:, 0].numpy()
    lp_dec = _port_forced(eng, ids)
    np.testing.assert_allclose(lp_dec, lp_pre[1:], atol=PREFILL_ATOL)
    assert np.abs(lp_dec - lp_pre[1:]).mean() < PREFILL_MEAN


def test_forced_decode_advances_the_cache(engines):
    _, eng, ids = engines
    _port_forced(eng, ids[:40])
    assert int(eng.cache["length"][0]) == 39
