"""The port's checkpoint configuration and A-3 against the JAX package:
``ModelConfig.from_dict`` on the HF config dicts of every family (built
offline with transformers' config classes, also nested under
``text_config`` / ``language_config``), ``from_model_path`` on checkpoint
directories (the lm_head in the index, a VL wrapper's layers prefix, and a
config without the layer count and MLA dims that the weight shapes give
back), field by field; ``add_rms_norm`` against the JAX function; and the
three presets A-3 adds."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.config import ModelConfig as JaxModelConfig
from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.config import preset_config as jax_preset_config
from krasis_tpu.models.loader import load_params as jax_load_params
from krasis_tpu.ops.norm import add_rms_norm as jadd_rms_norm
from krasis_tpu_torch.config import ModelConfig, QuantConfig, preset_config
from krasis_tpu_torch.models.loader import load_params
from krasis_tpu_torch.ops.norm import add_rms_norm
from krasis_tpu_torch.utils.safetensors_io import ShardedSafetensors, write_safetensors

from torch_ckpt_util import HF_MODELS, assert_same_leaves, hf_config, write_checkpoint
from torch_port_util import f32, port_params, t

pytest.importorskip("transformers")


def _same(cfg, jcfg):
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("ckpts")


@pytest.mark.parametrize("nest", ["top", "text_config", "language_config"])
@pytest.mark.parametrize("family", sorted(HF_MODELS))
def test_from_dict_equals_reference(family, nest):
    raw = hf_config(family).to_dict()
    if nest != "top":
        raw = {nest: raw, "eos_token_id": [7, 9, 11], "bos_token_id": 3}
    _same(ModelConfig.from_dict(raw), JaxModelConfig.from_dict(raw))


@pytest.mark.parametrize("family", sorted(HF_MODELS) + ["gpt_oss_mxfp4", "fp8", "ct_int4"])
def test_from_model_path_equals_reference(root, family):
    path = write_checkpoint(family, root)
    cfg = ModelConfig.from_model_path(path)
    _same(cfg, JaxModelConfig.from_model_path(path))
    assert cfg.model_path == path and not cfg.tie_word_embeddings


def test_shapes_give_back_layers_and_mla_dims(tmp_path):
    """A DeepSeek-VL2-style language_config without num_hidden_layers and
    the MLA dims, under a `language.model` prefix: both packages infer them
    from the safetensors headers alone."""
    H, hq, dn, dr, dv, Lr = 64, 2, 32, 16, 64, 32
    P = "language.model.layers"
    z = lambda *s: torch.zeros(s, dtype=torch.bfloat16)     # noqa: E731
    tensors = {f"{P}.0.self_attn.kv_a_layernorm.weight": z(Lr),
               f"{P}.0.self_attn.kv_a_proj_with_mqa.weight": z(Lr + dr, H),
               f"{P}.0.self_attn.kv_b_proj.weight": z(hq * (dn + dv), Lr),
               f"{P}.0.self_attn.o_proj.weight": z(H, hq * dv),
               f"{P}.0.self_attn.q_proj.weight": z(hq * (dn + dr), H),
               f"{P}.2.input_layernorm.weight": z(H), "lm_head.weight": z(8, H)}
    write_safetensors(str(tmp_path / "model.safetensors"), tensors)
    raw = {"language_config": {"model_type": "deepseek_v2", "hidden_size": H,
                               "vocab_size": 8, "intermediate_size": 128}}
    with open(tmp_path / "config.json", "w") as f:
        json.dump(raw, f)
    cfg = ModelConfig.from_model_path(str(tmp_path))
    _same(cfg, JaxModelConfig.from_model_path(str(tmp_path)))
    assert (cfg.num_hidden_layers, cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim, cfg.num_attention_heads) == (3, Lr, dn, dr, dv, hq)
    assert cfg.layers_prefix == "language.model" and not cfg.tie_word_embeddings


def test_wrapped_prefix_loads_equal_reference(root, tmp_path, monkeypatch):
    """A VL wrapper's checkpoint (every model.* name under `language.`)
    loads through the detected prefix to the reference's leaves."""
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path / "home"))
    src = write_checkpoint("deepseek_v2", root)
    st = ShardedSafetensors(src)
    write_safetensors(str(tmp_path / "model.safetensors"),
                      {("language." + k if k.startswith("model.") else k): st.tensor(k)
                       for k in st.keys()})
    with open(os.path.join(src, "config.json")) as f:
        raw = json.load(f)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(raw, f)
    cfg = ModelConfig.from_model_path(str(tmp_path))
    assert cfg.layers_prefix == "language.model"
    jcfg = JaxModelConfig.from_model_path(str(tmp_path))
    want = port_params(jax_load_params(jcfg, JaxQuantConfig(), use_cache=False))
    assert_same_leaves(want, load_params(cfg, QuantConfig(), use_cache=False, device="cpu"))


@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_add_rms_norm_matches(residual, plus_one):
    rng = np.random.default_rng(int(residual) * 2 + int(plus_one))
    x = jnp.asarray(rng.standard_normal((3, 5, 256)) * 3, jnp.float32).astype(jnp.bfloat16)
    r = jnp.asarray(rng.standard_normal((3, 5, 256)), jnp.float32).astype(jnp.bfloat16)
    w = jnp.asarray(rng.uniform(0.5, 1.5, 256), jnp.float32).astype(jnp.bfloat16)
    jn, jres = jadd_rms_norm(x, r if residual else None, w, 1e-6, plus_one)
    n, res = add_rms_norm(t(x), t(r) if residual else None, t(w), 1e-6, plus_one)
    assert res.dtype == torch.bfloat16 and torch.equal(res, t(jres))   # the add is exact
    if not residual:
        assert torch.equal(res, t(x))
    np.testing.assert_allclose(f32(n), f32(jn), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("name", ["qwen3-235b", "qwen3.5-35b", "qwen35-1chip"])
def test_new_presets_equal_reference(name):
    _same(preset_config(name), jax_preset_config(name))
