"""The port's checkpoint loader against the reference's, bit for bit.

Tiny checkpoints of every family the loader's name schema covers (Qwen3-MoE,
DeepSeek-V2, Qwen3-Next, GPT-OSS in fused bf16 and in MXFP4 blocks,
DeepSeek-V3, GLM-4 MoE) and the prequantized inputs (fp8 blocks,
compressed-tensors int4) load through both packages, directly and through
their weight caches, at the default QuantConfig and with int8 experts:
every leaf of the port's load_params(device="cpu") equals the reference's
load_params passed through bridge.params_from_numpy."""

import pytest
import torch

from krasis_tpu.config import ModelConfig as JaxModelConfig
from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.models.loader import load_params as jax_load_params
from krasis_tpu_torch.config import ModelConfig, QuantConfig
from krasis_tpu_torch.models.loader import load_params, load_params_offload
from krasis_tpu_torch.quant import dequant_mxfp4, quantize
from krasis_tpu_torch.utils.safetensors_io import ShardedSafetensors

from torch_ckpt_util import FAMILIES, assert_same_leaves, write_checkpoint
from torch_port_util import port_params

QUANTS = {"default": {}, "int8_experts": dict(expert_bits=8)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("ckpts")


@pytest.mark.parametrize("use_cache", [False, True], ids=["direct", "cache"])
@pytest.mark.parametrize("quant", sorted(QUANTS))
@pytest.mark.parametrize("family", FAMILIES)
def test_leaves_equal_reference(root, tmp_path, monkeypatch, family, quant, use_cache):
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path / "home"))
    path = write_checkpoint(family, root)
    want = port_params(jax_load_params(JaxModelConfig.from_model_path(path),
                                       JaxQuantConfig(**QUANTS[quant]), use_cache=use_cache))
    got = load_params(ModelConfig.from_model_path(path), QuantConfig(**QUANTS[quant]),
                      use_cache=use_cache, device="cpu")
    assert_same_leaves(want, got)
    if family in ("deepseek_v2", "qwen3_next"):
        # shared experts folded at load: virtual experts after the routed ones
        cfg = ModelConfig.from_model_path(path)
        lp = got["layers"][-1]
        assert lp["w13"].q.shape[0] > cfg.n_routed_experts


@pytest.mark.parametrize("use_cache", [False, True], ids=["direct", "cache"])
def test_mtp_leaves_equal_reference(root, tmp_path, monkeypatch, use_cache):
    """A DeepSeek-V3-style MTP module (enorm, hnorm, eh_proj, the shared
    head and its own MoE layer, shared expert folded) loads to the
    reference's leaves under params["mtp"]."""
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path / "home"))
    path = write_checkpoint("mtp", root)
    want = port_params(jax_load_params(JaxModelConfig.from_model_path(path), JaxQuantConfig(),
                                       use_cache=use_cache))
    got = load_params(ModelConfig.from_model_path(path), QuantConfig(), use_cache=use_cache,
                      device="cpu")
    assert {"enorm", "hnorm", "eh_proj", "final_norm", "head", "layer"} <= set(got["mtp"])
    assert got["mtp"]["layer"]["w13"].q.shape[0] == 8 + 1      # the folded shared expert
    assert_same_leaves(want, got)


def test_gpt_oss_mxfp4_gate_up_deinterleaved(root):
    """The MXFP4 experts' gate / up columns arrive interleaved (even gate,
    odd up); the loaded bias and stacks hold them gate first, then up."""
    path = write_checkpoint("gpt_oss_mxfp4", root)
    params = load_params(ModelConfig.from_model_path(path), QuantConfig(expert_bits=8),
                         use_cache=False, device="cpu")
    st = ShardedSafetensors(path)
    M = "model.layers.0.mlp.experts"
    gu = dequant_mxfp4(st.tensor(f"{M}.gate_up_proj_blocks")[1],
                       st.tensor(f"{M}.gate_up_proj_scales")[1]).T      # [H, 2I]
    bias = st.tensor(f"{M}.gate_up_proj_bias").float()
    lp = params["layers"][0]
    I = gu.shape[1] // 2
    assert torch.equal(lp["w13_bias"][:, :I], bias[:, ::2])
    assert torch.equal(lp["w13_bias"][:, I:], bias[:, 1::2])
    want = quantize(torch.cat([gu[:, ::2], gu[:, 1::2]], dim=-1), 8, 128)
    assert torch.equal(lp["w13"].q[1], want.q)


def test_mesh_and_offload_name_their_roadmap_items(root, tmp_path, monkeypatch):
    """A mesh load (A-10) places each leaf on its shard, through the cache
    and directly: each ep shard's experts are its slice of the unsharded
    load's stacks, nothing is folded, and the replicated leaves are the
    same; the offload load (A-9) gives a device tree without routed stacks
    and a store holding them (tests/test_torch_offload_engine.py holds both
    against the reference)."""
    from krasis_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path / "home"))
    path = write_checkpoint("qwen3_moe", root)
    cfg = ModelConfig.from_model_path(path)
    mesh = make_mesh(2, devices=["cpu"] * 2)
    whole = load_params(cfg, QuantConfig(), device="cpu")
    for use_cache in (True, False):
        sharded = load_params(cfg, QuantConfig(), mesh=mesh, use_cache=use_cache)
        assert sharded["mesh"] is mesh
        for lp, slp in zip(whole["layers"], sharded["layers"]):
            assert "w13" not in slp and len(slp["_ep"]) == 2
            E = cfg.n_routed_experts // 2
            for e, sh in enumerate(slp["_ep"]):
                for k in ("w13", "w2"):
                    assert torch.equal(sh[k].q, lp[k].q[e * E:(e + 1) * E])
                    assert torch.equal(sh[k].scales, lp[k].scales[e * E:(e + 1) * E])
            assert torch.equal(slp["gate_w"], lp["gate_w"])
    params, store = load_params_offload(cfg, QuantConfig(), device="cpu")
    assert store.layers == [i for i in range(cfg.num_hidden_layers) if cfg.layer_is_moe(i)]
    assert all("w13" not in lp for lp in params["layers"])


def test_load_without_card_raises(root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = write_checkpoint("qwen3_moe", root)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_params(ModelConfig.from_model_path(path), QuantConfig(), use_cache=False)
