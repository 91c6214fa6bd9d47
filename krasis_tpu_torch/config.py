"""Model / quantization configuration for the PyTorch port.

A copy of ``krasis_tpu.config``: ``QuantConfig``, the ``ModelConfig``
fields and derived properties, the parsing of a checkpoint's
``config.json`` (``ModelConfig.from_model_path`` / ``from_dict``, with the
nested ``text_config`` / ``language_config`` of wrapped models, the layers
prefix of VL wrappers, and the layer count and MLA dims inferred from the
weight shapes where the config lacks them; a GGUF file's metadata where
there is no ``config.json``), and the presets (MLA × MoE:
``deepseek-v2-lite``; GQA × MoE: ``qwen3-moe`` and ``qwen3-235b``; hybrid
Gated DeltaNet + GQA: ``qwen3-coder-next``, ``qwen3.5-35b`` and their
64-expert cuts ``qcn-1chip`` and ``qwen35-1chip``; GQA with sliding
windows, sinks and biases: ``gpt-oss-120b`` and ``gpt-oss-20b``). Field
names, defaults and parsing rules are identical, so one checkpoint gives
both packages the same configuration.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class QuantConfig:
    """Per-component quantization policy (see ``krasis_tpu.config``)."""

    expert_bits: int = 4            # 4 or 8 — routed expert weights
    # "int8" = W4A8 decode MoE (per-row, per-K-group int8 activations);
    # the grouped prefill path always runs bf16 activations.
    expert_activation: str = "int8"  # "bf16" | "int8"
    lm_head: str = "int8"           # "bf16" | "int8"
    attention: str = "bf16"         # "bf16" | "int8" | "int4" (projections)
    shared_expert: str = "int8"     # "bf16" | "int8"
    dense_mlp: str = "int8"         # "bf16" | "int8"
    group_size: int = 128           # quantization group size along K
    # Shared experts ride the decode MoE stack as always-picked virtual
    # experts (models/params.fold_shared_experts).
    fold_shared_decode: bool = True
    kv_cache_dtype: str = "auto"    # "auto" | "fp8" (e4m3) | "bf16"


@dataclass
class ModelConfig:
    """Parsed model architecture description."""

    model_path: str
    model_type: str
    hidden_size: int
    intermediate_size: int
    moe_intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    vocab_size: int

    # MLA
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_nope_head_dim: Optional[int] = None
    qk_rope_head_dim: Optional[int] = None
    v_head_dim: Optional[int] = None

    # GQA
    head_dim: Optional[int] = None
    qk_norm: bool = False
    attention_bias: bool = False
    sliding_window: int = 0

    # hybrid linear attention
    full_attention_interval: int = 0
    layer_types: Optional[List[str]] = None
    linear_conv_kernel_dim: int = 4
    linear_key_head_dim: int = 128
    linear_num_key_heads: int = 16
    linear_value_head_dim: int = 128
    linear_num_value_heads: int = 32

    # MoE
    n_routed_experts: int = 0
    num_experts_per_tok: int = 0
    n_shared_experts: int = 0
    shared_expert_intermediate_size: int = 0
    first_k_dense_replace: int = 0
    routed_scaling_factor: float = 1.0
    scoring_func: str = "softmax"
    topk_method: str = "greedy"
    n_group: int = 0
    topk_group: int = 0
    norm_topk_prob: bool = False
    has_router_bias: bool = False
    moe_router_softmax_after_topk: bool = False

    # norm / activation
    rms_norm_eps: float = 1e-6
    hidden_act: str = "silu"
    norm_plus_one: bool = False
    swiglu_limit: float = 0.0
    expert_quant_method: str = ""

    # RoPE
    rope_theta: float = 10000.0
    rope_scaling: Dict[str, Any] = field(default_factory=dict)
    max_position_embeddings: int = 131072
    partial_rotary_factor: float = 1.0

    num_nextn_predict_layers: int = 0

    tie_word_embeddings: bool = False
    bos_token_id: int = 0
    eos_token_id: int = 0
    extra_stop_token_ids: Tuple[int, ...] = ()
    layers_prefix: str = "model"

    @property
    def attention_type(self) -> str:
        return "mla" if self.kv_lora_rank is not None else "gqa"

    @property
    def is_hybrid(self) -> bool:
        return any(t == "linear_attention" for t in self.layer_types or [])

    @property
    def is_moe(self) -> bool:
        return self.n_routed_experts > 0

    @property
    def qk_head_dim(self) -> int:
        if self.attention_type == "mla":
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        return self.head_dim or (self.hidden_size // self.num_attention_heads)

    def layer_type(self, layer_idx: int) -> str:
        if self.layer_types is not None:
            return self.layer_types[layer_idx]
        return "full_attention"

    def layer_is_moe(self, layer_idx: int) -> bool:
        return self.is_moe and layer_idx >= self.first_k_dense_replace

    @property
    def num_moe_layers(self) -> int:
        return sum(self.layer_is_moe(i) for i in range(self.num_hidden_layers))

    @classmethod
    def from_model_path(cls, model_path: str) -> "ModelConfig":
        """A checkpoint directory's ``config.json``; a ``.gguf`` file, or a
        directory without ``config.json``, through its GGUF metadata."""
        cfg_file = os.path.join(model_path, "config.json")
        if model_path.endswith(".gguf") or not os.path.exists(cfg_file):
            from .utils.gguf_source import GgufCheckpoint

            ck = GgufCheckpoint(model_path)
            try:
                raw = ck.to_config_dict()
            finally:
                ck.close()
            cfg = cls.from_dict(raw, model_path="")
            cfg.model_path = model_path
            return cfg
        with open(cfg_file) as f:
            raw = json.load(f)
        return cls.from_dict(raw, model_path=model_path)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any], model_path: str = "") -> "ModelConfig":
        """An HF config dict, by the reference's rules for every family."""
        cfg = raw.get("text_config", raw.get("language_config", raw))
        if model_path:
            cfg = _infer_missing_from_weights(model_path, cfg)
        arch = cfg.get("model_type", "")
        is_mla = "kv_lora_rank" in cfg

        # first_k_dense_replace (DeepSeek) or decoder_sparse_step (Qwen3-MoE)
        if "first_k_dense_replace" in cfg:
            first_k_dense = cfg["first_k_dense_replace"]
        elif "decoder_sparse_step" in cfg:
            step = cfg["decoder_sparse_step"]
            first_k_dense = 0 if step <= 1 else step
        else:
            first_k_dense = 0

        num_layers = cfg["num_hidden_layers"]
        # explicit layer types (GPT-OSS), or every Nth layer full attention
        full_interval = cfg.get("full_attention_interval", 0)
        layer_types = cfg.get("layer_types")
        if layer_types is None and full_interval > 0:
            layer_types = ["full_attention" if (i + 1) % full_interval == 0
                           else "linear_attention" for i in range(num_layers)]

        n_experts = cfg.get("n_routed_experts",
                            cfg.get("num_experts", cfg.get("num_local_experts", 0)))
        experts_per_tok = cfg.get("num_experts_per_tok", cfg.get("experts_per_token", 0))
        moe_inter = cfg.get("moe_intermediate_size", cfg.get("intermediate_size", 0))
        n_shared = cfg.get("n_shared_experts", 0)
        shared_inter = cfg.get("shared_expert_intermediate_size", 0)
        if n_shared == 0 and shared_inter > 0:
            n_shared = 1

        rope_params = cfg.get("rope_parameters") or {}
        rope_theta = cfg.get("rope_theta", rope_params.get("rope_theta", 10000.0))
        partial_rotary = cfg.get("partial_rotary_factor",
                                 rope_params.get("partial_rotary_factor", 1.0))

        # untied when no config says and the index holds an lm_head weight
        tie_default = True
        if ("tie_word_embeddings" not in cfg and "tie_word_embeddings" not in raw
                and model_path):
            index = _read_index(model_path)
            if index and any("lm_head.weight" in k for k in index):
                tie_default = False
        tie = cfg.get("tie_word_embeddings", raw.get("tie_word_embeddings", tie_default))

        quant_method = (cfg.get("quantization_config") or {}).get("quant_method", "")
        eos_raw = raw.get("eos_token_id", cfg.get("eos_token_id", 0))
        if isinstance(eos_raw, list):
            eos, extra_stops = (eos_raw[0] if eos_raw else 0), tuple(eos_raw[1:])
        else:
            eos, extra_stops = eos_raw, ()

        return cls(
            model_path=model_path,
            model_type=arch,
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg.get("intermediate_size", moe_inter),
            moe_intermediate_size=moe_inter,
            num_hidden_layers=num_layers,
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            vocab_size=cfg["vocab_size"],
            q_lora_rank=cfg.get("q_lora_rank") if is_mla else None,
            kv_lora_rank=cfg.get("kv_lora_rank") if is_mla else None,
            qk_nope_head_dim=cfg.get("qk_nope_head_dim") if is_mla else None,
            qk_rope_head_dim=cfg.get("qk_rope_head_dim") if is_mla else None,
            v_head_dim=cfg.get("v_head_dim") if is_mla else None,
            head_dim=cfg.get("head_dim") if not is_mla else None,
            qk_norm=cfg.get("use_qk_norm",
                            arch.startswith("qwen3") or arch in ("qwen3_5_moe_text",)),
            attention_bias=cfg.get("attention_bias", False),
            sliding_window=cfg.get("sliding_window", 0) or 0,
            full_attention_interval=full_interval,
            layer_types=layer_types,
            linear_conv_kernel_dim=cfg.get("linear_conv_kernel_dim", 4),
            linear_key_head_dim=cfg.get("linear_key_head_dim", 128),
            linear_num_key_heads=cfg.get("linear_num_key_heads", 16),
            linear_value_head_dim=cfg.get("linear_value_head_dim", 128),
            linear_num_value_heads=cfg.get("linear_num_value_heads", 32),
            n_routed_experts=n_experts,
            num_experts_per_tok=experts_per_tok,
            n_shared_experts=n_shared,
            shared_expert_intermediate_size=shared_inter,
            first_k_dense_replace=first_k_dense,
            routed_scaling_factor=cfg.get("routed_scaling_factor", 1.0),
            scoring_func=cfg.get("scoring_func", "softmax"),
            topk_method=cfg.get("topk_method", "greedy"),
            n_group=cfg.get("n_group", 0) or 0,
            topk_group=cfg.get("topk_group", 0) or 0,
            # Qwen3.5 renormalises its top-k weights without saying so
            norm_topk_prob=cfg.get("norm_topk_prob", arch == "qwen3_5_moe_text"),
            moe_router_softmax_after_topk=arch == "gpt_oss",
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
            hidden_act=cfg.get("hidden_act", "silu"),
            norm_plus_one=arch in ("qwen3_next", "qwen3_5_moe_text"),
            swiglu_limit=cfg.get("swiglu_limit", 0.0) or 0.0,
            expert_quant_method=quant_method,
            rope_theta=rope_theta,
            rope_scaling=cfg.get("rope_scaling") or {},
            max_position_embeddings=cfg.get("max_position_embeddings", 131072),
            partial_rotary_factor=partial_rotary,
            num_nextn_predict_layers=cfg.get("num_nextn_predict_layers", 0),
            tie_word_embeddings=tie,
            bos_token_id=raw.get("bos_token_id", cfg.get("bos_token_id", 0)) or 0,
            eos_token_id=eos,
            extra_stop_token_ids=extra_stops,
            layers_prefix=_detect_layers_prefix(model_path) if model_path else "model",
        )


def _read_index(model_path: str) -> Dict[str, str]:
    """Tensor name → shard file, from model.safetensors.index.json or the
    header of a single model.safetensors."""
    path = os.path.join(model_path, "model.safetensors.index.json")
    if not os.path.exists(path):
        single = os.path.join(model_path, "model.safetensors")
        if os.path.exists(single):
            names = _read_safetensors_header(single).keys()
            return {n: "model.safetensors" for n in names if n != "__metadata__"}
        return {}
    with open(path) as f:
        return json.load(f).get("weight_map", {})


def _read_safetensors_header(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(hlen))


def _detect_layers_prefix(model_path: str) -> str:
    """The tensor-name prefix before '.layers.' (VL wrappers nest it)."""
    for key in _read_index(model_path):
        pos = key.find(".layers.")
        if pos > 0 and ("self_attn" in key or "linear_attn" in key):
            return key[:pos]
    return "model"


def _infer_missing_from_weights(model_path: str, cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The layer count and MLA dims from the weight shapes, for configs
    that lack them (DeepSeek-VL2's language_config)."""
    if "num_hidden_layers" in cfg and "num_attention_heads" in cfg and "kv_lora_rank" in cfg:
        return cfg
    index = _read_index(model_path)
    if not index:
        return cfg
    prefix = _detect_layers_prefix(model_path)
    cfg = dict(cfg)

    if "num_hidden_layers" not in cfg:
        marker = f"{prefix}.layers."
        layer_ids = set()
        for k in index:
            if k.startswith(marker):
                try:
                    layer_ids.add(int(k[len(marker):].split(".")[0]))
                except ValueError:
                    pass
        if layer_ids:
            cfg["num_hidden_layers"] = max(layer_ids) + 1

    kv_a_key = f"{prefix}.layers.0.self_attn.kv_a_proj_with_mqa.weight"
    if kv_a_key in index and "kv_lora_rank" not in cfg:
        headers: Dict[str, Dict[str, Any]] = {}

        def shape_of(name: str) -> Optional[List[int]]:
            shard = index.get(name)
            if not shard:
                return None
            if shard not in headers:
                headers[shard] = _read_safetensors_header(os.path.join(model_path, shard))
            info = headers[shard].get(name)
            return info["shape"] if info else None

        A = f"{prefix}.layers.0.self_attn"
        ln, kv_a = shape_of(f"{A}.kv_a_layernorm.weight"), shape_of(kv_a_key)
        kv_b, o, q = (shape_of(f"{A}.{n}.weight") for n in ("kv_b_proj", "o_proj", "q_proj"))
        if ln and kv_a and kv_b and o and q:
            kv_lora_rank = ln[0]
            rope_dim = kv_a[0] - kv_lora_rank
            total_v, total_kv_b, total_q = o[1], kv_b[0], q[0]
            for v_head in (128, 64, 96, 256):
                if total_v % v_head:
                    continue
                n_heads = total_v // v_head
                if total_kv_b % n_heads:
                    continue
                nope = total_kv_b // n_heads - v_head
                if nope > 0 and total_q == n_heads * (nope + rope_dim):
                    for key, val in (("kv_lora_rank", kv_lora_rank),
                                     ("qk_nope_head_dim", nope), ("qk_rope_head_dim", rope_dim),
                                     ("v_head_dim", v_head), ("num_attention_heads", n_heads),
                                     ("num_key_value_heads", n_heads)):
                        cfg.setdefault(key, val)
                    break
    return cfg


_PRESETS: Dict[str, Dict[str, Any]] = {
    # DeepSeek V2-Lite: 16B total / 2.4B active, MLA, 64+2 experts top-6.
    "deepseek-v2-lite": dict(
        model_type="deepseek_v2",
        hidden_size=2048, intermediate_size=10944, moe_intermediate_size=1408,
        num_hidden_layers=27, num_attention_heads=16, num_key_value_heads=16,
        vocab_size=102400,
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, q_lora_rank=None,
        n_routed_experts=64, num_experts_per_tok=6, n_shared_experts=2,
        first_k_dense_replace=1, routed_scaling_factor=1.0,
        scoring_func="softmax", norm_topk_prob=False,
        rms_norm_eps=1e-6, rope_theta=10000.0,
        rope_scaling=dict(
            type="yarn", factor=40.0, original_max_position_embeddings=4096,
            beta_fast=32, beta_slow=1, mscale=0.707, mscale_all_dim=0.707,
        ),
        max_position_embeddings=163840,
    ),
    # Qwen3-30B-A3B-style GQA MoE.
    "qwen3-moe": dict(
        model_type="qwen3_moe",
        hidden_size=2048, intermediate_size=6144, moe_intermediate_size=768,
        num_hidden_layers=48, num_attention_heads=32, num_key_value_heads=4,
        vocab_size=151936, head_dim=128, qk_norm=True,
        n_routed_experts=128, num_experts_per_tok=8,
        norm_topk_prob=True, rms_norm_eps=1e-6, rope_theta=1000000.0,
    ),
    # Qwen3-235B-A22B: GQA, 128 experts top-8.
    "qwen3-235b": dict(
        model_type="qwen3_moe",
        hidden_size=4096, intermediate_size=12288, moe_intermediate_size=1536,
        num_hidden_layers=94, num_attention_heads=64, num_key_value_heads=4,
        vocab_size=151936, head_dim=128, qk_norm=True,
        n_routed_experts=128, num_experts_per_tok=8,
        norm_topk_prob=True, rms_norm_eps=1e-6, rope_theta=1000000.0,
    ),
    # Qwen3-Coder-Next-80B: hybrid 36 DeltaNet + 12 GQA, 512 experts top-10.
    "qwen3-coder-next": dict(
        model_type="qwen3_next",
        hidden_size=2048, intermediate_size=5120, moe_intermediate_size=512,
        num_hidden_layers=48, num_attention_heads=16, num_key_value_heads=2,
        vocab_size=151936, head_dim=256, qk_norm=True, norm_plus_one=True,
        full_attention_interval=4,
        layer_types=[
            "full_attention" if (i + 1) % 4 == 0 else "linear_attention"
            for i in range(48)
        ],
        linear_conv_kernel_dim=4, linear_key_head_dim=128,
        linear_num_key_heads=16, linear_value_head_dim=128,
        linear_num_value_heads=32,
        n_routed_experts=512, num_experts_per_tok=10, n_shared_experts=1,
        shared_expert_intermediate_size=512,
        norm_topk_prob=True, rms_norm_eps=1e-6, rope_theta=10000000.0,
        partial_rotary_factor=0.25,
    ),
    # Qwen3.5-35B-A3B: hybrid 30 DeltaNet + 10 GQA, 256 experts top-8. The
    # layer count, expert count, top-k and 3:1 ratio are the model's; the
    # widths are the Qwen3-Coder-Next preset's, as in the reference, until
    # a published config.json can confirm them.
    "qwen3.5-35b": dict(
        model_type="qwen3_5_moe_text",
        hidden_size=2048, intermediate_size=5120, moe_intermediate_size=512,
        num_hidden_layers=40, num_attention_heads=16, num_key_value_heads=2,
        vocab_size=151936, head_dim=256, qk_norm=True, norm_plus_one=True,
        full_attention_interval=4,
        layer_types=[
            "full_attention" if (i + 1) % 4 == 0 else "linear_attention"
            for i in range(40)
        ],
        linear_conv_kernel_dim=4, linear_key_head_dim=128,
        linear_num_key_heads=16, linear_value_head_dim=128,
        linear_num_value_heads=32,
        n_routed_experts=256, num_experts_per_tok=8, n_shared_experts=1,
        shared_expert_intermediate_size=512,
        norm_topk_prob=True, rms_norm_eps=1e-6, rope_theta=10000000.0,
        partial_rotary_factor=0.25,
    ),
    # GPT-OSS-120B: 128 experts top-4, alternating sliding (window 128) and
    # full GQA layers with learned attention sinks, biased projections and
    # experts, the clamped gpt-oss activation, and a router that selects on
    # raw logits and takes the softmax over the top-k only.
    "gpt-oss-120b": dict(
        model_type="gpt_oss",
        hidden_size=2880, intermediate_size=2880, moe_intermediate_size=2880,
        num_hidden_layers=36, num_attention_heads=64, num_key_value_heads=8,
        vocab_size=201088, head_dim=64, qk_norm=False,
        attention_bias=True, sliding_window=128,
        layer_types=[
            "sliding_attention" if i % 2 == 0 else "full_attention"
            for i in range(36)
        ],
        n_routed_experts=128, num_experts_per_tok=4,
        moe_router_softmax_after_topk=True,
        swiglu_limit=7.0, rms_norm_eps=1e-5, rope_theta=150000.0,
        rope_scaling=dict(
            rope_type="yarn", factor=32.0,
            original_max_position_embeddings=4096,
            beta_fast=32.0, beta_slow=1.0,
        ),
        max_position_embeddings=131072,
    ),
}
# Qwen3.5 with 64 of its 256 experts: the full model's per-layer shapes.
_PRESETS["qwen35-1chip"] = dict(_PRESETS["qwen3.5-35b"],
                                n_routed_experts=64, num_experts_per_tok=8)
# GPT-OSS-20B: the same family at 24 layers and 32 experts.
_PRESETS["gpt-oss-20b"] = dict(
    _PRESETS["gpt-oss-120b"],
    num_hidden_layers=24, n_routed_experts=32,
    layer_types=["sliding_attention" if i % 2 == 0 else "full_attention"
                 for i in range(24)],
)
# The same architecture with 64 of the 512 experts: per-layer shapes are
# those of the full model, the expert stacks are an eighth of its size.
_PRESETS["qcn-1chip"] = dict(_PRESETS["qwen3-coder-next"],
                             n_routed_experts=64, num_experts_per_tok=10)


def preset_config(name: str, **overrides: Any) -> ModelConfig:
    """Built-in architecture description (public config.json values)."""
    if name not in _PRESETS:
        raise KeyError(f"unknown preset '{name}'; have {sorted(_PRESETS)}")
    kw = dict(_PRESETS[name])
    kw.update(overrides)
    kw.setdefault("model_path", f"synthetic://{name}")
    return ModelConfig(**kw)
