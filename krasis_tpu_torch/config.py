"""Model / quantization configuration for the PyTorch port.

A copy of the parts of ``krasis_tpu.config`` that the DeepSeek-V2-Lite
main path reads: ``QuantConfig``, the ``ModelConfig`` fields and derived
properties, and the ``deepseek-v2-lite`` preset. Field names and defaults
are identical, so one configuration describes both packages. Parsing of
checkpoint ``config.json`` files arrives with the loader in a later slice.
"""

from __future__ import annotations

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
}


def preset_config(name: str, **overrides: Any) -> ModelConfig:
    """Built-in architecture description (public config.json values)."""
    if name not in _PRESETS:
        raise KeyError(f"unknown preset '{name}'; have {sorted(_PRESETS)}")
    kw = dict(_PRESETS[name])
    kw.update(overrides)
    kw.setdefault("model_path", f"synthetic://{name}")
    return ModelConfig(**kw)
