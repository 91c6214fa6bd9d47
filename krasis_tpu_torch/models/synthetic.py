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


# A hybrid needs its layer pattern and DeltaNet widths cut as well: two
# repetitions of [DeltaNet, DeltaNet, DeltaNet, GQA], widths that the
# grouped and gathered MoE kernels accept (H, I multiples of 128).
TINY_HYBRID_OVERRIDES = dict(
    moe_intermediate_size=128, shared_expert_intermediate_size=128,
    num_hidden_layers=8, head_dim=32,
    layer_types=(["linear_attention"] * 3 + ["full_attention"]) * 2,
    linear_num_key_heads=2, linear_num_value_heads=4,
    linear_key_head_dim=32, linear_value_head_dim=32,
)


def tiny_config(preset: str = "deepseek-v2-lite", **overrides) -> ModelConfig:
    kw = dict(TINY_OVERRIDES)
    if preset_config(preset).is_hybrid:
        kw.update(TINY_HYBRID_OVERRIDES)
    kw.update(overrides)
    return preset_config(preset, **kw)


def build_synthetic_engine(cfg: ModelConfig, quant: Optional[QuantConfig] = None,
                           max_len: int = 4096, seed: int = 0, device=None,
                           offload: bool = False, offload_engine: bool = False,
                           hot_experts: int = 0, mesh=None) -> Engine:
    """Random weights made on the card (or on `device`) from `seed`.

    `offload`: the same weights, the routed experts copied into a host store
    (``offload.store_from_params``) and left out of the device tree, served
    by ``Engine(offload=store)``: offloaded equals resident, bit for bit in
    the weights. `offload_engine`: the serving ``OffloadEngine`` (streamed
    prefill, `hot_experts` on the card) over a store filled on the host
    (``offload.build_synthetic_store``, the reference's bytes for `seed`), so
    the expert weights never touch the card at build time; its experts
    differ from the `offload` path's. `mesh`: the weights made on the mesh's
    first device and sharded over it (``Engine(mesh=)``)."""
    quant = quant or QuantConfig()
    dev = mesh.home(0) if mesh is not None else resolve_device(device)
    pin = dev.type == "cuda"
    if offload_engine:
        from ..offload import build_synthetic_store
        from ..runtime.offload_engine import OffloadEngine

        store = build_synthetic_store(cfg, quant, seed=seed, pin=pin)
        params = init_synthetic_params(cfg, quant, seed=seed, device=dev, skip_experts=True)
        return OffloadEngine(cfg, quant, params, store, hot_experts=hot_experts,
                             max_len=max_len, device=dev)
    params = init_synthetic_params(cfg, quant, seed=seed, device=dev)
    store = None
    if offload:
        from ..offload import store_from_params

        params, store = store_from_params(cfg, quant, params, pin=pin)
    return Engine(cfg, quant, params, max_len=max_len, device=dev, offload=store, mesh=mesh)
