"""The port's forward against the JAX package's `forward` on a tiny
DeepSeek-V2-Lite (1 dense prefix layer + a stack of 3 MoE layers, I=128 so
the JAX side takes its fused grouped kernels), with the JAX Pallas kernels
in interpret mode: prefill logits, a second chunk over history, the MLA
cache rows, and two decode steps."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.models.model import make_chunk_prefill_fn, make_forward_fns
from krasis_tpu.models.params import fold_shared_experts as jax_fold
from krasis_tpu.models.params import init_synthetic_params as jax_init
from krasis_tpu.models.synthetic import tiny_config as jax_tiny_config
from krasis_tpu.runtime.kv_cache import init_cache as jax_init_cache
from krasis_tpu_torch.config import QuantConfig
from krasis_tpu_torch.models.model import forward
from krasis_tpu_torch.models.synthetic import tiny_config
from krasis_tpu_torch.runtime.kv_cache import init_cache

from torch_port_util import f32, port_params

OVERRIDES = dict(moe_intermediate_size=128, num_hidden_layers=4)
QUANT = dict(expert_bits=4, group_size=128, kv_cache_dtype="bf16")
MAX_LEN = 512
TOL = 2e-2


def _close(got, want, what):
    got, want = f32(got), f32(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(scale, 1.0), f"{what}: max|Δ| {err} vs scale {scale}"


def _jax_layer_caches(cache):
    rows = [lc["kv"] for lc in cache["prefix_layers"]]
    stack = cache["pattern"][0]["kv"]
    rows += [stack[r] for r in range(stack.shape[0])]
    return rows


def test_forward_matches_jax(monkeypatch):
    monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    jcfg = jax_tiny_config("deepseek-v2-lite", **OVERRIDES)
    jquant = JaxQuantConfig(**QUANT)
    jparams = jax_fold(jax_init(jcfg, jquant, jax.random.PRNGKey(0)), jcfg, jquant)
    prefill_fn, decode_fn, _ = make_forward_fns(jcfg, jquant)
    chunk_fn = jax.jit(make_chunk_prefill_fn(jcfg, jquant, history=128))
    prefill_fn, decode_fn = jax.jit(prefill_fn), jax.jit(decode_fn)

    cfg, quant = tiny_config("deepseek-v2-lite", **OVERRIDES), QuantConfig(**QUANT)
    params = port_params(jparams)
    cache = init_cache(cfg, quant, 1, MAX_LEN, "cpu")
    jcache = jax_init_cache(jcfg, jquant, 1, MAX_LEN)

    # Random tiny routers have near-uniform scores: at some tokens the k-th
    # and (k+1)-th router logits lie ~1e-5 apart, and one bf16 rounding
    # difference upstream then picks another expert. This prompt (seed 7)
    # keeps every compared router gap >= 1.1e-3, ten times the noise.
    rng = np.random.default_rng(7)
    n1, n2 = 40, 30
    prompt = rng.integers(1, cfg.vocab_size, size=n1 + n2)
    # both chunks are padded to the reference's 128-row bucket, on both sides
    for n, chunk in ((n1, prompt[:n1]), (n2, prompt[n1:])):
        tok = np.zeros((1, 128), np.int32)
        tok[0, :n] = chunk
        fn = prefill_fn if n == n1 else chunk_fn
        jl, jcache = fn(jparams, jnp.asarray(tok), jnp.asarray([n], jnp.int32), jcache)
        pl_ = forward(params, torch.from_numpy(tok).long(),
                      torch.tensor([n], dtype=torch.int32), cache, cfg, quant, prefill=True,
                      history=0 if n == n1 else 128)
        _close(pl_, jl, f"prefill logits after {int(cache['length'][0])} tokens")
    total = n1 + n2
    assert int(cache["length"][0]) == int(jcache["length"][0]) == total
    for i, (lc, jkv) in enumerate(zip(cache["layers"], _jax_layer_caches(jcache))):
        _close(lc["kv"][:, :, :total], np.asarray(jkv)[:, :, :total], f"layer {i} cache")

    # two greedy decode steps fed the same token on both sides
    nxt = int(np.argmax(f32(jl)[0]))
    for step in range(2):
        jl, jcache = decode_fn(jparams, jnp.asarray([[nxt]], jnp.int32), jcache)
        pl_ = forward(params, torch.tensor([[nxt]]), torch.ones(1, dtype=torch.int32),
                      cache, cfg, quant, prefill=False)
        _close(pl_, jl, f"decode step {step} logits")
        nxt = int(np.argmax(f32(jl)[0]))
