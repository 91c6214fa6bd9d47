"""Parameter schema and synthetic initialization (PyTorch).

Parameters are a dict: ``embed``, ``final_norm``, ``lm_head`` and
``layers``, a list with one dict per layer. The reference keeps repeated
layers stacked along a leading ``reps`` axis so XLA can scan over them;
here ``stack[l]`` is a free view, so each layer simply holds its own
tensors. Key names inside a layer are the reference's. The one exception
are the quantized attention / DeltaNet projections of the repeated layer
pattern (``STACKED_PROJECTIONS``): each stays one ``[reps, K(/2), N]``
QTensor per pattern position, shared by the layers of that position, and
each such layer carries its ``_layer_idx`` into the stack, which the
stacked qmm kernel reads in place.

``init_synthetic_params`` builds a random-weight model directly in
quantized form on the target device from an explicit ``torch.Generator``,
with the shared experts folded into the expert stacks at creation. GPT-OSS
layers also hold ``sinks`` [Hq], ``gate_logit_bias`` [E], ``w13_bias``
[E, 2I] and ``w2_bias`` [E, H] (f32, zero, as the reference makes them).

``params_from_stacked`` turns the reference's stacked tree (what the
weight cache stores) into this layout with views, and
``fold_shared_experts`` folds the shared experts of loaded checkpoints,
into stacks reserved for them (``fold_width``) or by concatenation.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch

from ..config import ModelConfig, QuantConfig
from ..quant import (QTensor, cat_leading, dequantize, quantize, random_qtensor,
                     slice_k, slice_n, stack_leading)


# Qwen3-Next family: gated attention output and a gated shared expert.
GATED_ATTENTION_TYPES = ("qwen3_next", "qwen3_5_moe_text")


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


def pattern_layer_index(info: PatternInfo, t: int, r: int) -> int:
    """Global layer index of pattern position t at repetition r."""
    return info.prefix_n + r * info.period + t


def mtp_layer_spec(cfg: ModelConfig) -> LayerSpec:
    """The MTP module's layer (DeepSeek V3 / Kimi K2: one more MLA layer at
    index num_hidden_layers, wrapped by enorm / hnorm / eh_proj)."""
    return LayerSpec(cfg.attention_type, False,
                     "moe" if cfg.layer_is_moe(cfg.num_hidden_layers) else "dense")


# Quantized projections that stay whole as [reps, K(/2), N] stacks.
STACKED_PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "kv_a_proj",
                       "qkvz_proj", "ba_proj", "la_out_proj")


def stack_pattern_projections(layers: List[Dict[str, Any]],
                              cfg: ModelConfig) -> List[Dict[str, Any]]:
    """Join the per-layer quantized projections of each pattern position
    into one stack; every layer of the position then holds the stack and
    its own ``_layer_idx``."""
    info = pattern_info(cfg)
    for t in range(info.period):
        group = [layers[pattern_layer_index(info, t, r)] for r in range(info.reps)]
        names = [n for n in STACKED_PROJECTIONS if isinstance(group[0].get(n), QTensor)]
        for name in names:
            stack = stack_leading([lp.pop(name) for lp in group], 0)
            for lp in group:
                lp[name] = stack
        if names:
            for r, lp in enumerate(group):
                lp["_layer_idx"] = r
    return layers


def params_from_stacked(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's tree (``prefix_layers``, ``pattern`` entries whose
    leaves carry a leading reps dim, ``embed``, ``final_norm``, ``lm_head``
    and, when present, ``mtp``) of torch leaves → this layout. Pattern
    leaves become per-layer views; a quantized projection stack
    (``STACKED_PROJECTIONS``) stays whole, and each layer of its position
    holds it and its ``_layer_idx``."""
    layers = [dict(lp) for lp in tree["prefix_layers"]]
    pattern = tree["pattern"]
    if pattern:
        reps = pattern[0]["input_norm"].shape[0]
        for r in range(reps):
            for lp in pattern:
                whole = {k for k, v in lp.items()
                         if k in STACKED_PROJECTIONS and isinstance(v, QTensor)}
                layer = {k: (v if k in whole else v[r]) for k, v in lp.items()}
                if whole:
                    layer["_layer_idx"] = r
                layers.append(layer)
    out = {k: tree[k] for k in ("embed", "final_norm", "lm_head")}
    out["layers"] = layers
    if "mtp" in tree:
        out["mtp"] = {k: (dict(v) if k == "layer" else v) for k, v in tree["mtp"].items()}
    return out


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
                g: torch.Generator, device: torch.device,
                skip_experts: bool = False) -> Dict[str, Any]:
    H, gs = cfg.hidden_size, quant.group_size
    gpt_oss = cfg.model_type == "gpt_oss"

    def rnd(shape, dtype=torch.bfloat16, scale=0.02):
        return (torch.randn(shape, generator=g, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    def plain_ones(n, dtype=torch.bfloat16):
        return torch.ones(n, dtype=dtype, device=device)

    def ones(n):
        # (1 + w)·x norms store their weights near zero
        if cfg.norm_plus_one:
            return torch.zeros(n, dtype=torch.bfloat16, device=device)
        return plain_ones(n)

    def attn_w(shape, mode=quant.attention):
        return _maybe_quant(rnd(shape, torch.float32), mode, gs)

    # the latent and recurrent paths compound weight noise: int8 floor
    floor8 = "int8" if quant.attention == "int4" else quant.attention
    hq = cfg.num_attention_heads
    lp: Dict[str, Any] = {"input_norm": ones(H), "post_norm": ones(H)}
    if spec.attn_kind == "gqa":
        d, hkv = cfg.qk_head_dim, cfg.num_key_value_heads
        gated = cfg.model_type in GATED_ATTENTION_TYPES
        qn = hq * d * (2 if gated else 1)
        lp["q_proj"] = attn_w((H, qn))
        lp["k_proj"] = attn_w((H, hkv * d))
        lp["v_proj"] = attn_w((H, hkv * d))
        lp["o_proj"] = attn_w((hq * d, H))
        if cfg.attention_bias:
            for name, n in (("q_bias", qn), ("k_bias", hkv * d), ("v_bias", hkv * d),
                            ("o_bias", H)):
                lp[name] = torch.zeros(n, dtype=torch.bfloat16, device=device)
        if cfg.qk_norm:
            lp["q_norm"], lp["k_norm"] = ones(d), ones(d)
        if gpt_oss:
            lp["sinks"] = torch.zeros(hq, dtype=torch.float32, device=device)
    elif spec.attn_kind == "mla":
        dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        L, dv = cfg.kv_lora_rank, cfg.v_head_dim
        if cfg.q_lora_rank:                                  # q-LoRA (DeepSeek V3)
            lp["q_a_proj"] = attn_w((H, cfg.q_lora_rank))
            lp["q_a_norm"] = plain_ones(cfg.q_lora_rank)
            lp["q_b_proj"] = attn_w((cfg.q_lora_rank, hq * (dn + dr)))
        else:
            lp["q_proj"] = attn_w((H, hq * (dn + dr)))
        lp["kv_a_proj"] = attn_w((H, L + dr), floor8)
        lp["kv_a_norm"] = plain_ones(L)
        lp["w_kc"] = rnd((hq, dn, L))
        lp["w_vc"] = rnd((hq, L, dv))
        lp["o_proj"] = attn_w((hq * dv, H))
    else:                                                    # linear_attention
        hk, hv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
        dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
        key_dim, value_dim = hk * dk, hv * dv
        lp["qkvz_proj"] = attn_w((H, 2 * key_dim + 2 * value_dim), floor8)
        lp["ba_proj"] = attn_w((H, 2 * hv), floor8)
        lp["conv_w"] = rnd((2 * key_dim + value_dim, cfg.linear_conv_kernel_dim), scale=0.2)
        lp["dt_bias"] = plain_ones(hv, torch.float32)
        lp["a_log"] = torch.zeros(hv, dtype=torch.float32, device=device)
        lp["la_norm"] = plain_ones(dv)                       # gated norm: plain weight
        lp["la_out_proj"] = attn_w((value_dim, H), floor8)

    if spec.mlp_kind == "dense":
        I = cfg.intermediate_size
        lp["mlp_w13"] = _maybe_quant(rnd((H, 2 * I), torch.float32), quant.dense_mlp, gs)
        lp["mlp_w2"] = _maybe_quant(rnd((I, H), torch.float32), quant.dense_mlp, gs)
        return lp

    E, I = cfg.n_routed_experts, cfg.moe_intermediate_size
    lp["gate_w"] = rnd((H, E), torch.float32)
    if cfg.has_router_bias:
        lp["gate_bias"] = torch.zeros(E, dtype=torch.float32, device=device)
    if gpt_oss:
        lp["gate_logit_bias"] = torch.zeros(E, dtype=torch.float32, device=device)
    Is = 0
    if cfg.n_shared_experts > 0:
        Is = cfg.shared_expert_intermediate_size or I * cfg.n_shared_experts
        src13, src2 = rnd((H, 2 * Is), torch.float32), rnd((Is, H), torch.float32)
        lp["shared_w13"] = _maybe_quant(src13, quant.shared_expert, gs)
        lp["shared_w2"] = _maybe_quant(src2, quant.shared_expert, gs)
        if cfg.model_type in GATED_ATTENTION_TYPES:
            lp["shared_gate_w"] = rnd((H, 1))
    if skip_experts:
        return lp
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
    if gpt_oss:
        lp["w13_bias"] = torch.zeros((E, 2 * I), dtype=torch.float32, device=device)
        lp["w2_bias"] = torch.zeros((E, H), dtype=torch.float32, device=device)
    return lp


def init_synthetic_params(cfg: ModelConfig, quant: QuantConfig, seed: int = 0,
                          device: Optional[torch.device] = None,
                          skip_experts: bool = False) -> Dict[str, Any]:
    """Random parameters made on `device` from a generator seeded `seed`.
    `skip_experts` leaves out the routed expert stacks (and GPT-OSS's expert
    biases): the offload tier's device tree, whose experts a host store
    holds (``offload.build_synthetic_store``)."""
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
        "final_norm": (torch.zeros if cfg.norm_plus_one else torch.ones)(
            H, dtype=torch.bfloat16, device=device),
        "lm_head": _maybe_quant(lm, quant.lm_head, quant.group_size),
    }
    del lm
    params["layers"] = stack_pattern_projections(
        [_init_layer(cfg, quant, spec, g, device, skip_experts) for spec in layer_specs(cfg)],
        cfg)
    if cfg.num_nextn_predict_layers > 0:
        params["mtp"] = init_mtp_params(cfg, quant, g, device)
    return params


def init_mtp_params(cfg: ModelConfig, quant: QuantConfig, g: torch.Generator,
                    device: Optional[torch.device] = None) -> Dict[str, Any]:
    """A random MTP module (depth 1; the reference's leaves): enorm, hnorm
    and final_norm, eh_proj [2H, H] quantized as the attention projections,
    and one layer of ``mtp_layer_spec(cfg)``. It shares the model's
    embedding and head."""
    device = torch.device(device or "cpu")
    H = cfg.hidden_size
    one = (torch.zeros if cfg.norm_plus_one else torch.ones)(H, dtype=torch.bfloat16,
                                                             device=device)
    eh = torch.randn((2 * H, H), generator=g, device=device, dtype=torch.float32) * 0.02
    return {"enorm": one, "hnorm": one.clone(), "final_norm": one.clone(),
            "eh_proj": _maybe_quant(eh, quant.attention, quant.group_size),
            "layer": _init_layer(cfg, quant, mtp_layer_spec(cfg), g, device)}


def fold_width(cfg: ModelConfig, bits: int, w2_group_size: int, Is: int,
               biased: bool = False) -> int:
    """The number of virtual experts that a layer's Is-wide shared experts
    fold into (the reference's conditions), 0 where the fold does not
    apply: biased experts, 16-bit stacks, Is not a multiple of I, odd I
    under int4, or I not a whole number of w2 groups."""
    I = cfg.moe_intermediate_size
    if (biased or bits not in (4, 8) or Is == 0 or Is % I or (I % 2 and bits == 4)
            or I % w2_group_size):
        return 0
    return Is // I


def _shared_width(sw13) -> int:
    return (sw13.n_dim if isinstance(sw13, QTensor) else sw13.shape[-1]) // 2


def layer_fold_width(lp: Dict[str, Any], cfg: ModelConfig) -> int:
    """fold_width of a layer's leaves: 0 without quantized expert stacks or
    shared experts, or with expert biases."""
    w13, sw13 = lp.get("w13"), lp.get("shared_w13")
    if not isinstance(w13, QTensor) or sw13 is None or "w13_bias" in lp:
        return 0
    return fold_width(cfg, w13.bits, lp["w2"].group_size, _shared_width(sw13))


def fold_layer(lp: Dict[str, Any], cfg: ModelConfig, reserved: bool = False
               ) -> Dict[str, Any]:
    """One layer's shared experts as always-picked virtual experts at the
    end of its expert stacks, the dense shared leaves requantized to the
    stacks' bits and groups so that both paths hold the same values. A
    stack of n_routed_experts rows is concatenated with them. With
    `reserved`, a stack of n_routed_experts + fold_width rows has room
    for them, and they are written into its tail in place (no second copy
    of a stack); without it such a stack is already folded and kept."""
    if "w13" not in lp or "shared_w13" not in lp or "w13_bias" in lp:
        return lp
    E, I = cfg.n_routed_experts, cfg.moe_intermediate_size
    w13, w2 = lp["w13"], lp["w2"]
    sw13, sw2 = lp["shared_w13"], lp["shared_w2"]
    Is = _shared_width(sw13)
    if not isinstance(w13, QTensor):
        # 16-bit stacks: the slices are exact by nature; quantized shared
        # leaves are dequantized to the stack's dtype first
        if w13.shape[0] != E or Is == 0 or Is % I:
            return lp
        s13 = dequantize(sw13, w13.dtype) if isinstance(sw13, QTensor) else sw13.to(w13.dtype)
        s2 = dequantize(sw2, w13.dtype) if isinstance(sw2, QTensor) else sw2.to(w13.dtype)
        n_virt, H = Is // I, s13.shape[0]
        gate = s13[:, :Is].reshape(H, n_virt, I)
        up = s13[:, Is:].reshape(H, n_virt, I)
        v13 = torch.cat([gate, up], dim=-1).transpose(0, 1)
        return {**lp, "w13": torch.cat([w13, v13], dim=0),
                "w2": torch.cat([w2, s2.reshape(n_virt, I, s2.shape[-1])], dim=0)}
    n_virt = layer_fold_width(lp, cfg)
    rows = w13.q.shape[0]
    in_place = reserved and rows == E + n_virt
    if n_virt == 0 or not (rows == E or in_place):
        return lp

    def requant(w, gs):
        if isinstance(w, QTensor) and w.bits == w13.bits and w.group_size == gs:
            return w
        wf = dequantize(w, torch.float32) if isinstance(w, QTensor) else w.to(torch.float32)
        return quantize(wf, w13.bits, gs)

    sh13, sh2 = requant(sw13, w13.group_size), requant(sw2, w2.group_size)
    v13, v2 = virtual_expert_slices(sh13, sh2, I)
    out = dict(lp)
    out["shared_w13"], out["shared_w2"] = sh13, sh2
    if in_place:
        for stack, v in ((w13, v13), (w2, v2)):
            stack.q[E:] = v.q
            stack.scales[E:] = v.scales
    else:
        out["w13"] = cat_leading([w13, v13], 0)
        out["w2"] = cat_leading([w2, v2], 0)
    return out


def fold_shared_experts(params: Dict[str, Any], cfg: ModelConfig,
                        quant: QuantConfig) -> Dict[str, Any]:
    """Append each layer's shared experts to its expert stacks as
    always-picked virtual experts (the decode path), requantizing the dense
    shared leaves to expert bits so both paths hold the same values.
    Idempotent: a stack already longer than n_routed_experts is kept."""
    if cfg.n_shared_experts <= 0:
        return params
    out = {**params, "layers": [fold_layer(lp, cfg) for lp in params["layers"]]}
    if "mtp" in params:
        out["mtp"] = {**params["mtp"], "layer": fold_layer(params["mtp"]["layer"], cfg)}
    return out
