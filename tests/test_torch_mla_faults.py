"""Two MLA faults the port had against the reference, held repaired.

C-6: a synthetic q-LoRA MLA model (DeepSeek-V3's attention: q_a_proj,
q_a_norm, q_b_proj) could not be built. The port's synthetic tree must
have the JAX package's leaves, shapes and dtypes, and an engine over the
JAX package's weights its greedy stream.

C-7: the MLA decode write had no bound check. A batch row whose position
runs past the cache end must be dropped, as the reference's scatter drops
it: nothing raises, and the other rows' logits equal the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.config import preset_config as jax_preset_config
from krasis_tpu.models.model import make_forward_fns
from krasis_tpu.models.params import fold_shared_experts as jax_fold
from krasis_tpu.models.params import init_synthetic_params as jax_init
from krasis_tpu.models.synthetic import build_synthetic_engine as jax_build
from krasis_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from krasis_tpu.runtime.kv_cache import init_cache as jax_init_cache
from krasis_tpu_torch.config import QuantConfig, preset_config
from krasis_tpu_torch.models.model import forward
from krasis_tpu_torch.models.params import init_synthetic_params
from krasis_tpu_torch.quant import QTensor
from krasis_tpu_torch.runtime.engine import Engine
from krasis_tpu_torch.runtime.kv_cache import init_cache

from torch_port_util import f32, port_params

QLORA = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, kv_lora_rank=32,
             q_lora_rank=48, intermediate_size=128, moe_intermediate_size=64,
             vocab_size=512, n_routed_experts=8, num_experts_per_tok=2)
MLA = {**QLORA, "q_lora_rank": None}
QUANT = dict(expert_bits=4, group_size=32, kv_cache_dtype="bf16")
TOL = 2e-2
NEW = 8
# the least top-2 logit gap over the compared greedy steps: the port's logits
# sit within 0.007 of the JAX package's here, so a gap three times that is no
# rounding coin-flip (prompt seed 12 keeps 0.0295)
GAP = 0.02


def _leaves(tree, prefix=""):
    """{path: (dtype, shape)} with QTensors as their parts and bits."""
    if isinstance(tree, QTensor):
        return {prefix + ".q": (tree.q.dtype, tuple(tree.q.shape)),
                prefix + ".scales": (tree.scales.dtype, tuple(tree.scales.shape)),
                prefix + ".bits": (tree.bits, tree.group_size)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}.{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}[{i}]"))
        return out
    return {prefix: (tree.dtype, tuple(tree.shape))}


@pytest.mark.parametrize("attention", ["bf16", "int8"])
def test_qlora_synthetic_tree_has_the_reference_leaves(attention):
    quant = dict(QUANT, attention=attention)
    jcfg = jax_preset_config("deepseek-v2-lite", **QLORA)
    want = port_params(jax_init(jcfg, JaxQuantConfig(**quant), jax.random.PRNGKey(0)))
    got = init_synthetic_params(preset_config("deepseek-v2-lite", **QLORA),
                                QuantConfig(**quant), seed=0)
    for lp in got["layers"]:
        assert {"q_a_proj", "q_a_norm", "q_b_proj"} <= lp.keys() and "q_proj" not in lp
    assert _leaves(got) == _leaves(want)


def _min_top2_gap(eng, prompt, tokens):
    eng.reset(256)
    gaps = []
    with torch.inference_mode():
        logits = eng._prefill_prompt(prompt)
        for tok in tokens:
            top = torch.topk(logits[0], 2).values
            gaps.append(float(top[0] - top[1]))
            logits = eng._forward(torch.tensor([[tok]]), torch.ones(1, dtype=torch.int32),
                                  prefill=False)
    return min(gaps)


def test_qlora_engine_matches_jax_engine():
    jeng = jax_build(jax_preset_config("deepseek-v2-lite", **QLORA), JaxQuantConfig(**QUANT),
                     max_len=256, seed=0)
    eng = Engine(preset_config("deepseek-v2-lite", **QLORA), QuantConfig(**QUANT),
                 port_params(jeng.params), max_len=256, device="cpu")
    prompt = np.random.default_rng(12).integers(1, 512, size=40).tolist()
    want = jeng.generate(prompt, max_new_tokens=NEW, stop_ids={-1},
                         sampling=JaxSamplingParams(temperature=0.0)).tokens
    got = eng.generate(prompt, max_new_tokens=NEW, stop_ids={-1})
    assert got.finite and got.tokens == want
    assert _min_top2_gap(eng, prompt, want) > GAP


@pytest.mark.parametrize("preset_kw", [MLA, QLORA], ids=["mla", "qlora"])
def test_decode_past_the_cache_end_is_dropped(preset_kw):
    """max_len 16, a batch of 2 prefilled to 15 and 5 tokens, then 4 decode
    steps: row 0 writes positions 15-18, three past the end."""
    max_len, lens = 16, (15, 5)
    jcfg = jax_preset_config("deepseek-v2-lite", **preset_kw)
    jquant = JaxQuantConfig(**QUANT)
    jparams = jax_fold(jax_init(jcfg, jquant, jax.random.PRNGKey(0)), jcfg, jquant)
    prefill_fn, decode_fn, _ = (jax.jit(f) for f in make_forward_fns(jcfg, jquant))
    cfg, quant = preset_config("deepseek-v2-lite", **preset_kw), QuantConfig(**QUANT)
    params = port_params(jparams)
    jcache = jax_init_cache(jcfg, jquant, 2, max_len)
    cache = init_cache(cfg, quant, 2, max_len, "cpu")

    tok = np.random.default_rng(5).integers(1, cfg.vocab_size, size=(2, max_len)).astype(np.int32)
    seq = np.asarray(lens, np.int32)
    jl, jcache = prefill_fn(jparams, jnp.asarray(tok), jnp.asarray(seq), jcache)
    with torch.inference_mode():
        pl = forward(params, torch.from_numpy(tok).long(), torch.from_numpy(seq), cache,
                     cfg, quant, prefill=True)
        assert np.abs(f32(pl) - f32(jl)).max() <= TOL * max(1.0, np.abs(f32(jl)).max())
        for step in range(4):
            nxt = np.asarray([[7 + step], [11 + step]], np.int32)
            jl, jcache = decode_fn(jparams, jnp.asarray(nxt), jcache)
            pl = forward(params, torch.from_numpy(nxt).long(), torch.ones(2, dtype=torch.int32),
                         cache, cfg, quant, prefill=False)
            want, got = f32(jl)[1], f32(pl)[1]
            assert np.isfinite(f32(pl)).all()
            assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max()), step
    assert cache["length"].tolist() == [lens[0] + 4, lens[1] + 4]
    # row 0's last cached row is its position-15 token's, not a later one's
    jkv = np.asarray(jcache["prefix_layers"][0]["kv"])
    np.testing.assert_allclose(f32(cache["layers"][0]["kv"][0, 0, 15]), f32(jkv[0, 0, 15]),
                               atol=TOL)
