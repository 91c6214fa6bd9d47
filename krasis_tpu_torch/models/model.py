"""Full-model forward for MLA × (dense | MoE) models: prefill and decode.

Layer graph (the reference's ``krasis_tpu/models/model.py``):
    h += attn(rms_norm(h));  h += mlp(rms_norm(h))
with MLA attention in absorbed form and a dense or routed-MoE MLP. The
reference's prefix layers and scanned pattern stack are one Python loop
over ``params["layers"]`` here. ``forward`` updates the cache in place
and returns the logits.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..config import ModelConfig, QuantConfig
from ..ops.flash_attention import flash_attention
from ..ops.moe import mlp_forward, moe_forward
from ..ops.norm import rms_norm
from ..ops.qmm import linear
from ..ops.rope import apply_rope, rope_cos_sin, yarn_softmax_scale
from ..ops.routing import compute_routing


def _mla_attention(lp: Dict[str, Any], lc: Dict[str, Any], x: torch.Tensor,
                   positions: torch.Tensor, kv_len: torch.Tensor,
                   cfg: ModelConfig, prefill: bool) -> torch.Tensor:
    B, S, _ = x.shape
    hq = cfg.num_attention_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    L = cfg.kv_lora_rank

    q = linear(x, lp["q_proj"]).reshape(B, S, hq, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    kv_a = linear(x, lp["kv_a_proj"])                        # [B, S, L + dr]
    ckv = rms_norm(kv_a[..., :L], lp["kv_a_norm"], cfg.rms_norm_eps)
    kpe = kv_a[..., L:]

    cos, sin = rope_cos_sin(positions, dr, cfg.rope_theta, cfg.rope_scaling)
    # DeepSeek checkpoints store rope dims pair-interleaved
    q_pe = apply_rope(q_pe, cos, sin, interleaved=True)
    kpe = apply_rope(kpe[:, :, None, :], cos, sin, interleaved=True)[:, :, 0, :]

    cache = lc["kv"]                                         # [B, 1, Smax, Dp]
    Dp = cache.shape[-1]
    row = F.pad(torch.cat([ckv, kpe], dim=-1), (0, Dp - (L + dr))).to(cache.dtype)
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, S)
    if prefill:
        # padding rows past the cache end are dropped, as XLA drops them
        keep = positions < cache.shape[2]
        cache[bidx[keep], 0, positions[keep]] = row[keep]
    else:
        cache[bidx, 0, positions] = row

    scale = yarn_softmax_scale((dn + dr) ** -0.5, cfg.rope_scaling)
    # absorbed MQA form: q_nope @ w_kc joins q_pe against the single-head
    # [ckv ; kpe] key; the absorb products run in true f32
    q_eff = torch.einsum("bshd,hdl->bshl", q_nope.to(torch.float32),
                         lp["w_kc"].to(torch.float32)).to(x.dtype)
    q_cat = F.pad(torch.cat([q_eff, q_pe.to(x.dtype)], dim=-1), (0, Dp - (L + dr)))
    ctx = flash_attention(q_cat, cache, positions[:, 0], kv_len, scale, v_dim=L)
    out = torch.einsum("bshl,hlv->bshv", ctx.to(torch.float32),
                       lp["w_vc"].to(torch.float32)).to(x.dtype)
    return linear(out.reshape(B, S, -1), lp["o_proj"])


def _mlp(lp: Dict[str, Any], x2d: torch.Tensor, cfg: ModelConfig,
         prefill: bool, activation: str) -> torch.Tensor:
    if "mlp_w13" in lp:
        return mlp_forward(x2d, lp["mlp_w13"], lp["mlp_w2"])
    routing = compute_routing(x2d, lp["gate_w"], cfg)
    E_stack = lp["w13"].q.shape[0]
    n_virt = E_stack - cfg.n_routed_experts
    if n_virt > 0 and not prefill:
        # decode: the folded shared experts are always-picked virtual
        # experts with weight 1, computed in the same kernel as the routed
        T = x2d.shape[0]
        sh_idx = torch.arange(cfg.n_routed_experts, E_stack, dtype=torch.int32,
                              device=x2d.device).expand(T, n_virt)
        sh_w = torch.ones((T, n_virt), dtype=torch.float32, device=x2d.device)
        return moe_forward(x2d, lp["w13"], lp["w2"],
                           torch.cat([routing.topk_idx, sh_idx], dim=1),
                           torch.cat([routing.topk_weights, sh_w], dim=1),
                           activation=activation)
    out = moe_forward(x2d, lp["w13"], lp["w2"], routing.topk_idx,
                      routing.topk_weights, activation=activation)
    if "shared_w13" in lp:
        # prefill: shared experts as one dense product, from the same
        # values the virtual experts were sliced from
        out = out + mlp_forward(x2d, lp["shared_w13"], lp["shared_w2"])
    return out


def forward(params: Dict[str, Any], tokens: torch.Tensor, seq_lens: torch.Tensor,
            cache: Dict[str, Any], cfg: ModelConfig, quant: QuantConfig,
            prefill: bool) -> torch.Tensor:
    """One pass over tokens [B, S] with seq_lens [B] valid tokens per row,
    after cache["length"] cached ones. Writes the new cache rows, advances
    cache["length"], and returns f32 logits [B, V] at each row's last valid
    token."""
    B, S = tokens.shape
    length = cache["length"]
    positions = length.to(torch.int64)[:, None] + torch.arange(S, device=tokens.device)
    kv_len = length + seq_lens.to(length.dtype)
    # prefill MoE stays bf16: the int8-activation numerics belong to decode
    activation = "bf16" if prefill else quant.expert_activation

    x = params["embed"][tokens]
    for lp, lc in zip(params["layers"], cache["layers"]):
        normed = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps, cfg.norm_plus_one)
        x = x + _mla_attention(lp, lc, normed, positions, kv_len, cfg, prefill)
        normed = rms_norm(x, lp["post_norm"], cfg.rms_norm_eps, cfg.norm_plus_one)
        x = x + _mlp(lp, normed.reshape(B * S, -1), cfg, prefill,
                     activation).reshape(B, S, -1)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps, cfg.norm_plus_one)
    last = torch.clamp(seq_lens.to(torch.int64) - 1, min=0)
    x = x[torch.arange(B, device=x.device), last]
    cache["length"] = kv_len
    return linear(x, params["lm_head"], out_dtype=torch.float32)
