"""Parameter schema and synthetic initialization (PyTorch).

Parameters are a dict: ``embed``, ``final_norm``, ``lm_head`` and
``layers``, a list with one dict per layer. The reference keeps repeated
layers stacked along a leading ``reps`` axis so XLA can scan over them;
here ``stack[l]`` is a free view, so each layer simply holds its own
tensors. Key names inside a layer are the reference's.

``init_synthetic_params`` builds a random-weight model directly in
quantized form on the target device from an explicit ``torch.Generator``,
with the shared experts folded into the expert stacks at creation.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch

from ..config import ModelConfig, QuantConfig
from ..quant import (QTensor, cat_leading, dequantize, quantize, random_qtensor,
                     slice_k, slice_n, stack_leading)


class LayerSpec(NamedTuple):
    attn_kind: str      # "mla" | "gqa" | "linear_attention"
    sliding: bool
    mlp_kind: str       # "moe" | "dense"


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    specs = []
    for i in range(cfg.num_hidden_layers):
        lt = cfg.layer_type(i)
        if lt == "linear_attention":
            attn, sliding = "linear_attention", False
        else:
            attn, sliding = cfg.attention_type, lt == "sliding_attention"
        specs.append(LayerSpec(attn, sliding, "moe" if cfg.layer_is_moe(i) else "dense"))
    return specs


class PatternInfo(NamedTuple):
    prefix_n: int
    period: int
    reps: int


def pattern_info(cfg: ModelConfig) -> PatternInfo:
    """Smallest (prefix, period) with specs = prefix ++ pattern × reps: the
    reference's stacking, which the weight bridge unstacks."""
    specs = layer_specs(cfg)
    L = len(specs)
    best = PatternInfo(L, 0, 0)
    for prefix_n in range(0, min(L, 4) + 1):
        rest = L - prefix_n
        for period in range(1, rest + 1):
            if rest % period:
                continue
            reps = rest // period
            if reps < 2:
                continue
            pat = specs[prefix_n:prefix_n + period]
            if all(specs[prefix_n + r * period + t] == pat[t]
                   for r in range(reps) for t in range(period)):
                cand = PatternInfo(prefix_n, period, reps)
                if (cand.period, cand.prefix_n) < (
                        best.period if best.reps else L + 1, best.prefix_n):
                    best = cand
                break
    return best if best.reps else PatternInfo(L, 0, 0)


def _maybe_quant(w: torch.Tensor, mode: str, group_size: int):
    if mode == "bf16":
        return w.to(torch.bfloat16)
    return quantize(w, {"int8": 8, "int4": 4}[mode], group_size)


def virtual_expert_slices(sh13: QTensor, sh2: QTensor, I: int):
    """Shared-expert weights → n_virt virtual experts [n_virt, ...] as
    bit-exact slices, so the folded decode path and the dense prefill path
    compute from identical values."""
    Is = sh2.scales.shape[-2] * sh2.group_size
    v13, v2 = [], []
    for j in range(Is // I):
        g = slice_n(sh13, j * I, I)
        u = slice_n(sh13, Is + j * I, I)
        v13.append(cat_leading([g, u], dim=-1))
        v2.append(slice_k(sh2, j * I, I))
    return stack_leading(v13, 0), stack_leading(v2, 0)


def _n_virtual(cfg: ModelConfig, quant: QuantConfig, Is: int) -> int:
    I = cfg.moe_intermediate_size
    if (Is and quant.fold_shared_decode and quant.expert_bits in (4, 8)
            and Is % I == 0 and not (quant.expert_bits == 4 and I % 2)):
        return Is // I
    return 0


def _init_layer(cfg: ModelConfig, quant: QuantConfig, spec: LayerSpec,
                g: torch.Generator, device: torch.device) -> Dict[str, Any]:
    if spec.attn_kind != "mla":
        raise NotImplementedError(f"{spec.attn_kind} attention is not ported yet")
    H, gs = cfg.hidden_size, quant.group_size

    def rnd(shape, dtype=torch.bfloat16, scale=0.02):
        return (torch.randn(shape, generator=g, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=device)

    hq = cfg.num_attention_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    L, dv = cfg.kv_lora_rank, cfg.v_head_dim
    if cfg.q_lora_rank:
        raise NotImplementedError("q-LoRA MLA is not ported yet")
    lp: Dict[str, Any] = {"input_norm": ones(H), "post_norm": ones(H)}
    lp["q_proj"] = _maybe_quant(rnd((H, hq * (dn + dr)), torch.float32), quant.attention, gs)
    lp["kv_a_proj"] = _maybe_quant(
        rnd((H, L + dr), torch.float32),
        "int8" if quant.attention == "int4" else quant.attention, gs)
    lp["kv_a_norm"] = ones(L)
    lp["w_kc"] = rnd((hq, dn, L))
    lp["w_vc"] = rnd((hq, L, dv))
    lp["o_proj"] = _maybe_quant(rnd((hq * dv, H), torch.float32), quant.attention, gs)

    if spec.mlp_kind == "dense":
        I = cfg.intermediate_size
        lp["mlp_w13"] = _maybe_quant(rnd((H, 2 * I), torch.float32), quant.dense_mlp, gs)
        lp["mlp_w2"] = _maybe_quant(rnd((I, H), torch.float32), quant.dense_mlp, gs)
        return lp

    E, I = cfg.n_routed_experts, cfg.moe_intermediate_size
    lp["gate_w"] = rnd((H, E), torch.float32)
    Is = 0
    if cfg.n_shared_experts > 0:
        Is = cfg.shared_expert_intermediate_size or I * cfg.n_shared_experts
        src13, src2 = rnd((H, 2 * Is), torch.float32), rnd((Is, H), torch.float32)
        lp["shared_w13"] = _maybe_quant(src13, quant.shared_expert, gs)
        lp["shared_w2"] = _maybe_quant(src2, quant.shared_expert, gs)
    n_virt = _n_virtual(cfg, quant, Is)
    bits = quant.expert_bits
    lp["w13"] = random_qtensor((E + n_virt, H, 2 * I), bits, gs, g, device)
    lp["w2"] = random_qtensor((E + n_virt, I, H), bits, gs, g, device)
    if n_virt and I % lp["w2"].group_size == 0:
        # ONE quantization of the shared source at expert bits: the dense
        # prefill leaves and the virtual experts hold the same values
        sh13 = quantize(src13, bits, gs)
        sh2 = quantize(src2, bits, lp["w2"].group_size)
        lp["shared_w13"], lp["shared_w2"] = sh13, sh2
        v13, v2 = virtual_expert_slices(sh13, sh2, I)
        for name, v in (("w13", v13), ("w2", v2)):
            lp[name].q[E:] = v.q
            lp[name].scales[E:] = v.scales
    elif n_virt:
        lp["w13"], lp["w2"] = lp["w13"][:E], lp["w2"][:E]
    return lp


def init_synthetic_params(cfg: ModelConfig, quant: QuantConfig, seed: int = 0,
                          device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Random parameters made on `device` from a generator seeded `seed`."""
    device = torch.device(device or "cpu")
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    H = cfg.hidden_size
    embed = (torch.randn((cfg.vocab_size, H), generator=g, device=device,
                         dtype=torch.float32) * 0.02).to(torch.bfloat16)
    lm = torch.randn((H, cfg.vocab_size), generator=g, device=device,
                     dtype=torch.float32) * 0.02
    params: Dict[str, Any] = {
        "embed": embed,
        "final_norm": torch.ones(H, dtype=torch.bfloat16, device=device),
        "lm_head": _maybe_quant(lm, quant.lm_head, quant.group_size),
    }
    del lm
    params["layers"] = [_init_layer(cfg, quant, spec, g, device)
                        for spec in layer_specs(cfg)]
    return params


def fold_shared_experts(params: Dict[str, Any], cfg: ModelConfig,
                        quant: QuantConfig) -> Dict[str, Any]:
    """Append each layer's shared experts to its expert stacks as
    always-picked virtual experts (the decode path), requantizing the dense
    shared leaves to expert bits so both paths hold the same values.
    Idempotent: a stack already longer than n_routed_experts is kept."""
    if cfg.n_shared_experts <= 0:
        return params
    I = cfg.moe_intermediate_size

    def fold_layer(lp):
        w13, w2 = lp.get("w13"), lp.get("w2")
        if (not isinstance(w13, QTensor) or "shared_w13" not in lp
                or w13.bits not in (4, 8) or w13.q.shape[0] != cfg.n_routed_experts):
            return lp
        sw13 = lp["shared_w13"]
        Is = sw13.n_dim // 2 if isinstance(sw13, QTensor) else sw13.shape[-1] // 2
        if Is % I or Is == 0 or (I % 2 and w13.bits == 4) or I % w2.group_size:
            return lp

        def requant(w, gs):
            if isinstance(w, QTensor) and w.bits == w13.bits and w.group_size == gs:
                return w
            wf = dequantize(w, torch.float32) if isinstance(w, QTensor) else w.float()
            return quantize(wf, w13.bits, gs)

        sh13 = requant(sw13, w13.group_size)
        sh2 = requant(lp["shared_w2"], w2.group_size)
        v13, v2 = virtual_expert_slices(sh13, sh2, I)
        out = dict(lp)
        out["shared_w13"], out["shared_w2"] = sh13, sh2
        out["w13"] = cat_leading([w13, v13], 0)
        out["w2"] = cat_leading([w2, v2], 0)
        return out

    return {**params, "layers": [fold_layer(lp) for lp in params["layers"]]}
