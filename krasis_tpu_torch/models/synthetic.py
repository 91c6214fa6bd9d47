"""Synthetic models: config → random-weight engine, no checkpoint."""

from __future__ import annotations

from typing import Optional

from ..config import ModelConfig, QuantConfig, preset_config
from ..device import resolve_device
from ..runtime.engine import Engine
from .params import init_synthetic_params

TINY_OVERRIDES = dict(
    hidden_size=128, intermediate_size=256, moe_intermediate_size=64,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    vocab_size=512,
    n_routed_experts=8, num_experts_per_tok=2,
)


def tiny_config(preset: str = "deepseek-v2-lite", **overrides) -> ModelConfig:
    kw = dict(TINY_OVERRIDES)
    kw.update(overrides)
    return preset_config(preset, **kw)


def build_synthetic_engine(cfg: ModelConfig, quant: Optional[QuantConfig] = None,
                           max_len: int = 4096, seed: int = 0,
                           device=None) -> Engine:
    """Random weights made on the card (or on `device`) from `seed`."""
    quant = quant or QuantConfig()
    dev = resolve_device(device)
    params = init_synthetic_params(cfg, quant, seed=seed, device=dev)
    return Engine(cfg, quant, params, max_len=max_len, device=dev)
