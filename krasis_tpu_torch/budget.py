"""Analytic device-memory budget, the port of ``krasis_tpu/budget.py``.

Per-component byte model from config.json alone, no weights needed:
attention (MLA / GQA / linear attention), dense MLP, router gate, shared
expert, norms, embedding, lm_head, per-token KV bytes, and per-expert bytes
at a given bit width. Gives per-card totals over a mesh, the split of
device and host bytes under ``--offload experts``, and a max-context
estimate. The card's memory is ``torch.cuda.get_device_properties``'s
``total_memory`` (``card_memory``); the server's ``--offload auto`` reads
both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from .config import ModelConfig, QuantConfig


def _linear_bytes(k: int, n: int, mode: str, gs: int) -> int:
    if mode == "bf16":
        return k * n * 2
    bits = {"int8": 8, "int4": 4}[mode]
    return k * n * bits // 8 + (k // gs) * n * 2  # packed + bf16 scales


@dataclass
class BudgetReport:
    components: Dict[str, int]
    expert_bytes_per_layer: int
    kv_bytes_per_token: int
    total_weight_bytes: int

    def per_chip(self, n_chips: int, ep_shard_experts: bool = True,
                 tp_shard_attention: bool = False) -> int:
        """Weight bytes per card: experts sharded over EP, rest replicated.

        `tp_shard_attention` models head-sharded attention projections over
        the same mesh axis. Approximation: the whole attention component
        divides by n_chips (KV projections replicate when head counts do not
        divide, but they are a small share of attention bytes)."""
        expert_total = self.components["experts"]
        rest = self.total_weight_bytes - expert_total
        if not ep_shard_experts:
            # everything (incl. attention) divides evenly — the TP flag
            # is already subsumed and must not double-count
            return self.total_weight_bytes // n_chips
        if tp_shard_attention:
            att = self.components.get("attention", 0)
            rest = rest - att + att // n_chips
        return rest + expert_total // n_chips

    def offload_split(self, group_layers: int = 1):
        """(device_bytes, host_bytes) under host-RAM expert offload
        (``offload.py``): the card holds everything but the routed experts
        plus the two streamed layer-group slots of the prefill
        (``runtime/offload_engine.py``); host RAM (or the weight cache's
        page cache) holds the experts."""
        experts = self.components["experts"]
        rest = self.total_weight_bytes - experts
        stream = 2 * group_layers * self.expert_bytes_per_layer
        return rest + stream, experts

    def max_context_tokens(self, n_chips: int, hbm_per_chip: int,
                           reserve_frac: float = 0.15) -> int:
        usable = int(hbm_per_chip * (1 - reserve_frac)) * n_chips
        free = usable - self.per_chip(n_chips) * n_chips
        if self.kv_bytes_per_token <= 0:
            return 1 << 30
        return max(0, free // self.kv_bytes_per_token)


def compute_budget(cfg: ModelConfig, quant: QuantConfig) -> BudgetReport:
    H = cfg.hidden_size
    gs = quant.group_size
    comp: Dict[str, int] = {}

    comp["embedding"] = cfg.vocab_size * H * 2
    comp["lm_head"] = (
        0 if cfg.tie_word_embeddings
        else _linear_bytes(H, cfg.vocab_size, quant.lm_head, gs)
    )
    comp["norms"] = (2 * cfg.num_hidden_layers + 1) * H * 2

    att = quant.attention
    attn_total = 0
    la_total = 0
    for i in range(cfg.num_hidden_layers):
        lt = cfg.layer_type(i)
        if lt == "linear_attention":
            hk, hv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
            dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
            kd, vd = hk * dk, hv * dv
            conv_dim = 2 * kd + vd
            la_total += (
                _linear_bytes(H, 2 * kd + 2 * vd, att, gs)
                + _linear_bytes(H, 2 * hv, att, gs)
                + conv_dim * cfg.linear_conv_kernel_dim * 2
                + _linear_bytes(vd, H, att, gs)
                + hv * 8 + dv * 2
            )
        elif cfg.attention_type == "mla":
            hq = cfg.num_attention_heads
            dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
            L = cfg.kv_lora_rank
            q_bytes = (
                _linear_bytes(H, cfg.q_lora_rank, att, gs)
                + _linear_bytes(cfg.q_lora_rank, hq * (dn + dr), att, gs)
                if cfg.q_lora_rank
                else _linear_bytes(H, hq * (dn + dr), att, gs)
            )
            attn_total += (
                q_bytes
                + _linear_bytes(H, L + dr, att, gs)
                + hq * (dn + dv) * L * 2          # w_kc + w_vc (bf16)
                + _linear_bytes(hq * dv, H, att, gs)
            )
        else:
            d = cfg.qk_head_dim
            hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
            gated = cfg.model_type in ("qwen3_next", "qwen3_5_moe_text")
            attn_total += (
                _linear_bytes(H, hq * d * (2 if gated else 1), att, gs)
                + 2 * _linear_bytes(H, hkv * d, att, gs)
                + _linear_bytes(hq * d, H, att, gs)
            )
    comp["attention"] = attn_total
    comp["linear_attention"] = la_total

    # MoE / dense
    expert_per_layer = 0
    moe_total = 0
    dense_total = 0
    shared_total = 0
    gate_total = 0
    ebits = quant.expert_bits
    for i in range(cfg.num_hidden_layers):
        if cfg.layer_is_moe(i):
            E, I = cfg.n_routed_experts, cfg.moe_intermediate_size
            per_e = (H * 2 * I + I * H) * ebits // 8 + (
                (H // gs) * 2 * I + (I // gs) * H
            ) * 2
            expert_per_layer = E * per_e
            moe_total += expert_per_layer
            gate_total += H * E * 4
            if cfg.n_shared_experts:
                Is = cfg.shared_expert_intermediate_size or (
                    I * cfg.n_shared_experts
                )
                shared_total += _linear_bytes(H, 2 * Is, quant.shared_expert, gs)
                shared_total += _linear_bytes(Is, H, quant.shared_expert, gs)
        else:
            I = cfg.intermediate_size
            dense_total += _linear_bytes(H, 2 * I, quant.dense_mlp, gs)
            dense_total += _linear_bytes(I, H, quant.dense_mlp, gs)
    comp["experts"] = moe_total
    comp["gates"] = gate_total
    comp["shared_experts"] = shared_total
    comp["dense_mlp"] = dense_total

    # KV bytes per token across layers
    kv_elem = 1 if quant.kv_cache_dtype == "fp8" else 2
    kv_per_token = 0
    for i in range(cfg.num_hidden_layers):
        lt = cfg.layer_type(i)
        if lt == "linear_attention":
            continue  # O(1) state, no per-token cost
        if cfg.attention_type == "mla":
            kv_per_token += (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * kv_elem
        else:
            kv_per_token += 2 * cfg.num_key_value_heads * cfg.qk_head_dim * kv_elem

    total = sum(comp.values())
    return BudgetReport(
        components=comp,
        expert_bytes_per_layer=expert_per_layer,
        kv_bytes_per_token=kv_per_token,
        total_weight_bytes=total,
    )


def card_memory(device=None) -> int:
    """Bytes of device memory on the card (`device`, default the current
    one). Raises without a card."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass the device memory explicitly")
    return int(torch.cuda.get_device_properties(device or 0).total_memory)


def format_budget(cfg: ModelConfig, quant: QuantConfig,
                  n_chips: int = 1, hbm_per_chip: Optional[int] = None) -> str:
    """The budget as text; `hbm_per_chip` defaults to the card's memory."""
    if hbm_per_chip is None:
        hbm_per_chip = card_memory()
    rep = compute_budget(cfg, quant)
    gb = 1 << 30
    lines = [f"Budget for {cfg.model_type} ({cfg.num_hidden_layers} layers):"]
    for name, b in sorted(rep.components.items(), key=lambda kv: -kv[1]):
        if b:
            lines.append(f"  {name:<18} {b / gb:8.2f} GiB")
    lines.append(f"  {'TOTAL':<18} {rep.total_weight_bytes / gb:8.2f} GiB")
    lines.append(f"  per-chip (EP x{n_chips}): "
                 f"{rep.per_chip(n_chips) / gb:.2f} GiB")
    lines.append(f"  KV bytes/token: {rep.kv_bytes_per_token}")
    lines.append(f"  max context @ {n_chips} chips: "
                 f"{rep.max_context_tokens(n_chips, hbm_per_chip):,} tokens")
    if rep.components.get("experts"):
        from .models.params import pattern_info

        dev, host = rep.offload_split(max(pattern_info(cfg).period, 1))
        lines.append(
            f"  --offload experts: {dev / gb:.2f} GiB HBM + "
            f"{host / gb:.2f} GiB host RAM"
        )
    return "\n".join(lines)
