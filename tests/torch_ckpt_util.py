"""Tiny checkpoints on disk for the loader tests of the PyTorch port.

Each family is a tiny random HF model written with save_pretrained, at the
widths of tests/test_hf_parity.py; ``gpt_oss_mxfp4`` rewrites GPT-OSS's
experts in the published MXFP4 layout, and ``fp8`` / ``ct_int4`` rewrite a
Qwen3-MoE checkpoint in the prequantized formats of
tests/test_prequant_input.py. ``flat`` and ``assert_same_leaves`` compare
two parameter trees of the port leaf by leaf, bit for bit."""

import json
import os
import shutil

import numpy as np
import torch

from krasis_tpu_torch.quant import QTensor
from krasis_tpu_torch.utils.safetensors_io import ShardedSafetensors, write_safetensors


def _qwen3_moe():
    from transformers import Qwen3MoeConfig, Qwen3MoeForCausalLM
    return Qwen3MoeForCausalLM, Qwen3MoeConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=32, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        num_experts=8, num_experts_per_tok=2, decoder_sparse_step=1,
        norm_topk_prob=True, mlp_only_layers=[], tie_word_embeddings=False,
        rope_theta=10000.0, max_position_embeddings=512)


def _deepseek_v2():
    from transformers import DeepseekV2Config, DeepseekV2ForCausalLM
    return DeepseekV2ForCausalLM, DeepseekV2Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=32, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=4,
        kv_lora_rank=32, q_lora_rank=None, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16,
        n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
        first_k_dense_replace=1, moe_layer_freq=1,
        topk_method="greedy", scoring_func="softmax",
        routed_scaling_factor=1.0, norm_topk_prob=False,
        aux_loss_alpha=0.0, seq_aux=False,
        tie_word_embeddings=False, rope_theta=10000.0,
        max_position_embeddings=512, attention_bias=False)


def _qwen3_next():
    from transformers import Qwen3NextConfig
    from transformers.models.qwen3_next.modeling_qwen3_next import Qwen3NextForCausalLM
    return Qwen3NextForCausalLM, Qwen3NextConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=32, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        num_experts=8, num_experts_per_tok=2, decoder_sparse_step=1,
        shared_expert_intermediate_size=32, norm_topk_prob=True,
        mlp_only_layers=[], tie_word_embeddings=False,
        linear_conv_kernel_dim=4, linear_key_head_dim=16,
        linear_num_key_heads=2, linear_value_head_dim=16,
        linear_num_value_heads=4, full_attention_interval=4,
        rope_theta=10000.0, max_position_embeddings=512,
        partial_rotary_factor=0.25)


def _gpt_oss():
    from transformers import GptOssConfig
    from transformers.models.gpt_oss.modeling_gpt_oss import GptOssForCausalLM
    return GptOssForCausalLM, GptOssConfig(
        vocab_size=256, hidden_size=64, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, num_local_experts=4, num_experts_per_tok=2,
        sliding_window=8, swiglu_limit=7.0, attention_bias=True,
        layer_types=["sliding_attention", "full_attention"],
        tie_word_embeddings=False, rope_theta=10000.0,
        max_position_embeddings=512, rope_scaling=None)


def _deepseek_v3():
    from transformers import DeepseekV3Config
    from transformers.models.deepseek_v3.modeling_deepseek_v3 import DeepseekV3ForCausalLM
    return DeepseekV3ForCausalLM, DeepseekV3Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=32, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=4,
        kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16,
        n_routed_experts=16, num_experts_per_tok=4, n_shared_experts=1,
        first_k_dense_replace=1, n_group=4, topk_group=2,
        topk_method="noaux_tc", scoring_func="sigmoid",
        routed_scaling_factor=2.0, norm_topk_prob=True,
        tie_word_embeddings=False, rope_theta=10000.0,
        max_position_embeddings=512, attention_bias=False, rope_scaling=None)


def _glm4_moe():
    from transformers import Glm4MoeConfig
    from transformers.models.glm4_moe.modeling_glm4_moe import Glm4MoeForCausalLM
    return Glm4MoeForCausalLM, Glm4MoeConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=32, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        n_routed_experts=16, num_experts_per_tok=4, n_shared_experts=1,
        first_k_dense_replace=1, n_group=4, topk_group=2,
        norm_topk_prob=True, routed_scaling_factor=1.0,
        use_qk_norm=True, partial_rotary_factor=0.5,
        attention_bias=False, tie_word_embeddings=False,
        rope_theta=10000.0, max_position_embeddings=512)


HF_MODELS = {"qwen3_moe": _qwen3_moe, "deepseek_v2": _deepseek_v2,
             "qwen3_next": _qwen3_next, "gpt_oss": _gpt_oss,
             "deepseek_v3": _deepseek_v3, "glm4_moe": _glm4_moe}
FAMILIES = tuple(HF_MODELS) + ("gpt_oss_mxfp4", "fp8", "ct_int4")


def hf_config(family: str):
    return HF_MODELS[family]()[1]


def hf_model(family: str, seed: int = 0):
    model_cls, config = HF_MODELS[family]()
    torch.manual_seed(seed)
    return model_cls(config).eval()


def _copy_configs(src: str, dst: str, extra_cfg=None):
    os.makedirs(dst, exist_ok=True)
    for f in os.listdir(src):
        if not f.endswith(".safetensors") and not f.endswith(".index.json"):
            shutil.copy(os.path.join(src, f), os.path.join(dst, f))
    if extra_cfg:
        with open(os.path.join(dst, "config.json")) as f:
            c = json.load(f)
        c.update(extra_cfg)
        with open(os.path.join(dst, "config.json"), "w") as f:
            json.dump(c, f)


def _to_mxfp4(src: str, dst: str, seed: int = 0):
    """GPT-OSS's fused bf16 experts → the published MXFP4 layout: random
    e2m1 bytes (every byte is two valid codes) and e8m0 scales in 118-127;
    the biases, router and attention stay as they are."""
    rng = np.random.default_rng(seed)
    st = ShardedSafetensors(src)
    out = {}
    for name in st.keys():
        t = st.tensor(name)
        if name.endswith("experts.gate_up_proj") or name.endswith("experts.down_proj"):
            E, K, N = t.shape                                      # [E, in, out]
            g = K // 32
            out[name + "_blocks"] = torch.from_numpy(
                rng.integers(0, 256, (E, N, g, 16), dtype=np.uint8))
            out[name + "_scales"] = torch.from_numpy(
                rng.integers(118, 128, (E, N, g), dtype=np.uint8))
        else:
            out[name] = t.clone()
    _copy_configs(src, dst, {"quantization_config": {"quant_method": "mxfp4"}})
    write_safetensors(os.path.join(dst, "model.safetensors"), out)


def _prequant(src: str, dst: str, kind: str):
    """A Qwen3-MoE checkpoint with its expert, q_proj and dense matrices in
    fp8 blocks or compressed-tensors int4 (tests/test_prequant_input.py)."""
    from test_prequant_input import _convertible, _ct_int4_encode, _fp8_encode

    st = ShardedSafetensors(src)
    out = {}
    for name in st.keys():
        t = st.tensor(name)
        if not (_convertible(name) and t.dim() == 2):
            out[name] = t.clone()
        elif kind == "fp8":
            w8, sinv = _fp8_encode(t.float().numpy())
            out[name] = torch.from_numpy(w8.view(np.uint8)).view(torch.float8_e4m3fn)
            out[f"{name}_scale_inv"] = torch.from_numpy(sinv)
        else:
            packed, scale = _ct_int4_encode(t.float().numpy(), gs=32)
            base = name[:-len(".weight")]
            out[f"{base}.weight_packed"] = torch.from_numpy(packed)
            out[f"{base}.weight_scale"] = torch.from_numpy(scale)
    extra = None
    if kind == "ct_int4":
        extra = {"quantization_config": {
            "format": "pack-quantized",
            "config_groups": {"group_0": {"weights": {
                "num_bits": 4, "group_size": 32, "symmetric": True}}}}}
    _copy_configs(src, dst, extra)
    write_safetensors(os.path.join(dst, "model.safetensors"), out)


def _write_mtp(dst: str):
    """A tiny DeepSeek-V3-style checkpoint with its MTP module at index
    num_hidden_layers (tests/test_mtp_loader.py's layout): a dense MLA
    layer, a MoE one with a shared expert, then enorm / hnorm / eh_proj,
    the shared head and one more MoE layer."""
    H, V, hq, dn, dr, L, dv, E, Im, Id = 64, 256, 4, 16, 8, 32, 16, 8, 32, 128
    g = np.random.default_rng(21)
    tensors = {}

    def t(name, *shape):
        tensors[name] = torch.from_numpy(g.normal(size=shape, scale=0.05).astype(np.float32))

    def layer(P, moe):
        tensors[f"{P}.input_layernorm.weight"] = torch.ones(H)
        tensors[f"{P}.post_attention_layernorm.weight"] = torch.ones(H)
        t(f"{P}.self_attn.q_proj.weight", hq * (dn + dr), H)
        t(f"{P}.self_attn.kv_a_proj_with_mqa.weight", L + dr, H)
        tensors[f"{P}.self_attn.kv_a_layernorm.weight"] = torch.ones(L)
        t(f"{P}.self_attn.kv_b_proj.weight", hq * (dn + dv), L)
        t(f"{P}.self_attn.o_proj.weight", H, hq * dv)
        if not moe:
            for n, shape in (("gate_proj", (Id, H)), ("up_proj", (Id, H)),
                             ("down_proj", (H, Id))):
                t(f"{P}.mlp.{n}.weight", *shape)
            return
        t(f"{P}.mlp.gate.weight", E, H)
        for sub in [f"experts.{e}" for e in range(E)] + ["shared_experts"]:
            for n, shape in (("gate_proj", (Im, H)), ("up_proj", (Im, H)),
                             ("down_proj", (H, Im))):
                t(f"{P}.mlp.{sub}.{n}.weight", *shape)

    t("model.embed_tokens.weight", V, H)
    tensors["model.norm.weight"] = torch.ones(H)
    t("lm_head.weight", V, H)
    layer("model.layers.0", moe=False)
    layer("model.layers.1", moe=True)
    M = "model.layers.2"
    t(f"{M}.embed_tokens.weight", V, H)
    tensors[f"{M}.enorm.weight"] = torch.ones(H)
    tensors[f"{M}.hnorm.weight"] = torch.ones(H)
    t(f"{M}.eh_proj.weight", H, 2 * H)
    tensors[f"{M}.shared_head.norm.weight"] = torch.ones(H)
    t(f"{M}.shared_head.head.weight", V, H)
    layer(M, moe=True)
    os.makedirs(dst, exist_ok=True)
    write_safetensors(os.path.join(dst, "model.safetensors"), tensors)
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(dict(model_type="deepseek_v2", hidden_size=H, intermediate_size=Id,
                       moe_intermediate_size=Im, num_hidden_layers=2, num_attention_heads=hq,
                       num_key_value_heads=hq, vocab_size=V, kv_lora_rank=L,
                       qk_nope_head_dim=dn, qk_rope_head_dim=dr, v_head_dim=dv,
                       n_routed_experts=E, num_experts_per_tok=2, n_shared_experts=1,
                       first_k_dense_replace=1, num_nextn_predict_layers=1,
                       scoring_func="softmax", rms_norm_eps=1e-6, rope_theta=10000.0,
                       tie_word_embeddings=False, eos_token_id=0), f)


def write_checkpoint(family: str, root) -> str:
    """The family's tiny checkpoint under `root` (FAMILIES, or "mtp");
    returns its directory."""
    root = str(root)
    if family == "mtp":
        dst = os.path.join(root, "mtp")
        if not os.path.exists(os.path.join(dst, "config.json")):
            _write_mtp(dst)
        return dst
    base = {"gpt_oss_mxfp4": "gpt_oss", "fp8": "qwen3_moe", "ct_int4": "qwen3_moe"}.get(
        family, family)
    src = os.path.join(root, base)
    if not os.path.exists(os.path.join(src, "config.json")):
        hf_model(base).save_pretrained(src, safe_serialization=True)
    if family == base:
        return src
    dst = os.path.join(root, family)
    if not os.path.exists(os.path.join(dst, "config.json")):
        if family == "gpt_oss_mxfp4":
            _to_mxfp4(src, dst)
        else:
            _prequant(src, dst, family)
    return dst


def flat(tree, prefix=""):
    """(path, leaf) pairs; a QTensor gives .q, .scales, .bits, .group_size."""
    if isinstance(tree, QTensor):
        for part in ("q", "scales", "bits", "group_size"):
            yield f"{prefix}.{part}", getattr(tree, part)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def assert_same_leaves(want, got):
    """Same paths; every tensor of the same dtype, shape and bits."""
    fw, fg = dict(flat(want)), dict(flat(got))
    assert fw.keys() == fg.keys(), sorted(fw.keys() ^ fg.keys())
    for k, a in fw.items():
        b = fg[k]
        if not isinstance(a, torch.Tensor):
            assert a == b, (k, a, b)
            continue
        assert (a.dtype, tuple(a.shape)) == (b.dtype, tuple(b.shape)), (k, a.dtype, b.dtype)
        a, b = a.cpu().reshape(-1), b.cpu().reshape(-1)
        if a.dtype.is_floating_point:       # bits: NaN == NaN, -0.0 != 0.0
            a, b = a.view(torch.uint8), b.view(torch.uint8)
        assert torch.equal(a, b), k
