"""Full-model forward: prefill and decode.

Layer graph (the reference's ``krasis_tpu/models/model.py``):
    h += attn(rms_norm(h));  h += mlp(rms_norm(h))
with attn ∈ {MLA in absorbed form, GQA (qk-norm, gated output, partial
rotary, sliding windows, sinks, biases), Gated DeltaNet} and mlp ∈ {routed
MoE + shared expert, dense MLP}. The reference's prefix layers and scanned
pattern stack are one Python loop over ``params["layers"]`` here, each
layer's kind read from ``layer_specs``. ``forward`` updates the cache in
place and returns the logits.

As in the reference, the first prefill chunk (``history == 0``) attends to
its freshly projected bf16 keys and values, never to the rows it has just
written to the cache; later chunks and decode read the cache, bf16 or fp8.

With ``offload`` (``offload.HostExpertStore``: the routed experts live in
host memory and the layers hold no ``w13`` / ``w2``), a MoE layer routes on
the card and its routed picks run on the host engine between launches (the
reference's segmented decode; PyTorch needs no ``pure_callback``, so the
port has this one form for every backend and no ``segmented`` switch). The
layer overlaps the two sides (``_offload_mlp``): its activations, ids and
weights go down in one pinned copy, the card runs the hot-expert cache's
picks (``hot_w13`` / ``hot_w2`` / ``hot_remap``) and the shared expert
meanwhile, then the host computes the cold picks and its result comes up and
is added.

Over a device mesh (``parallel/``) a layer's leaves carry its shards, each
on its device: ``_ep`` (expert slices: ``_mlp``'s EP branch, the f32
partials summed on the rows' device), ``_heads`` (head groups:
``_sharded_attention``), ``_sp`` (a prefill's MLP rows split over sp). A
cache whose slots split over dp runs each group's rows on its own devices
(``forward`` through ``parallel/mesh.dp_groups``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..config import ModelConfig, QuantConfig
from ..ops.deltanet import (DeltaNetDims, causal_conv, delta_state_update,
                            fix_qkvz_ordering, gated_delta_rule_chunked,
                            gated_delta_rule_recurrent)
from ..ops.flash_attention import flash_attention
from ..ops.moe import mlp_forward, moe_forward
from ..ops.norm import gated_rms_norm, rms_norm
from ..ops.qmm import linear
from ..ops.rope import apply_rope, rope_cos_sin, yarn_softmax_scale
from ..ops.routing import compute_routing
from ..ops.sampling import sample_batched
from ..parallel.ep import ep_combine
from ..parallel.mesh import dp_groups, shard_cfg
from ..quant import QTensor
from ..runtime.kv_cache import CacheRows, cache_rows, store_rows
from ..timing import TIMING
from .params import GATED_ATTENTION_TYPES, layer_specs


def _gqa_attention(lp: Dict[str, Any], lc: Dict[str, Any], x: torch.Tensor,
                   positions: torch.Tensor, kv_len: torch.Tensor,
                   cfg: ModelConfig, sliding: bool = False,
                   fresh: bool = False, at: Optional[CacheRows] = None,
                   project: bool = True) -> torch.Tensor:
    """`sliding`: the layer sees the last cfg.sliding_window keys only.
    `fresh`: the first prefill chunk, which attends to its own k / v. `at`:
    where the new rows go in the cache (from `positions` when not given).
    Without `project`, returns the heads' output before ``o_proj`` (a head
    shard's, whose product with its rows of ``o_proj`` is a partial sum)."""
    B, S, _ = x.shape
    d = cfg.qk_head_dim
    hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    li = lp.get("_layer_idx")

    q = linear(x, lp["q_proj"], layer_idx=li)
    if "q_bias" in lp:
        q = q + lp["q_bias"].to(q.dtype)
    gate = None
    if cfg.model_type in GATED_ATTENTION_TYPES:
        q = q.reshape(B, S, hq, 2 * d)
        q, gate = q[..., :d], q[..., d:].reshape(B, S, hq * d)
    else:
        q = q.reshape(B, S, hq, d)
    k = linear(x, lp["k_proj"], layer_idx=li)
    v = linear(x, lp["v_proj"], layer_idx=li)
    if "k_bias" in lp:
        k = k + lp["k_bias"].to(k.dtype)
        v = v + lp["v_bias"].to(v.dtype)
    k = k.reshape(B, S, hkv, d)
    v = v.reshape(B, S, hkv, d)

    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps, cfg.norm_plus_one)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps, cfg.norm_plus_one)
    rot = int(d * cfg.partial_rotary_factor)
    cos, sin = rope_cos_sin(positions, rot, cfg.rope_theta, cfg.rope_scaling)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    # caches are [B, Hkv, Smax, Dp] with the feature dim lane-padded
    Dp = lc["k"].shape[-1]
    if at is None:
        at = cache_rows(positions, lc["k"].shape[2])
    for name, new in (("k", k), ("v", v)):
        store_rows(lc[name], at, F.pad(new, (0, Dp - d)))

    if fresh:   # the chunk's own bf16 rows, padded as the cache's are
        kk, vv = (F.pad(t, (0, Dp - d)).transpose(1, 2) for t in (k, v))
    else:
        kk, vv = lc["k"], lc["v"]
    out = flash_attention(F.pad(q, (0, Dp - d)), kk, positions[:, 0], kv_len, d ** -0.5,
                          v_dim=d, v=vv, qk_dim=d,
                          window=cfg.sliding_window if sliding else 0, sinks=lp.get("sinks"))
    out = out.reshape(B, S, hq * d)
    if gate is not None:
        out = out * torch.sigmoid(gate.to(torch.float32)).to(out.dtype)
    if not project:
        return out
    o = linear(out, lp["o_proj"], layer_idx=li)
    if "o_bias" in lp:
        o = o + lp["o_bias"].to(o.dtype)
    return o


def _la_attention(lp: Dict[str, Any], lc: Dict[str, Any], x: torch.Tensor,
                  valid: torch.Tensor, cfg: ModelConfig, prefill: bool,
                  spec: bool = False) -> torch.Tensor:
    """Gated DeltaNet layer; `valid` [B, S] masks padded query positions,
    which must neither enter the conv window nor advance the recurrence.

    `spec` (a speculative verify step, in decode): the outputs are computed as usual,
    but `state` and `conv` stay as they were; the layer's cache holds the
    replay inputs instead (post-conv k and v, decay, beta and the conv
    inputs as ``p_k``, ``p_v``, ``p_g``, ``p_b``, ``p_x``) until
    ``la_spec_commit`` advances them by each row's committed prefix."""
    B, S, _ = x.shape
    dims = DeltaNetDims(cfg.linear_num_key_heads, cfg.linear_num_value_heads,
                        cfg.linear_key_head_dim, cfg.linear_value_head_dim,
                        cfg.linear_conv_kernel_dim)
    li = lp.get("_layer_idx")
    qkvz = linear(x, lp["qkvz_proj"], layer_idx=li)
    ba = linear(x, lp["ba_proj"], layer_idx=li)
    q, k, v, z, b, a = fix_qkvz_ordering(qkvz, ba, dims)

    mixed = torch.cat([q.reshape(B, S, -1), k.reshape(B, S, -1), v.reshape(B, S, -1)],
                      dim=-1)
    mixed = torch.where(valid[..., None], mixed, torch.zeros((), dtype=mixed.dtype,
                                                             device=mixed.device))
    conv_out, _ = causal_conv(mixed, lp["conv_w"], lc["conv"])
    spec = spec and not prefill
    if not spec:
        # new conv window = the last K-1 *valid* inputs of each row
        lc["conv"] = _conv_window(lc["conv"], mixed, valid.sum(dim=-1))

    kd = dims.key_dim
    qc = conv_out[..., :kd].reshape(B, S, dims.num_k_heads, dims.head_k_dim)
    kc = conv_out[..., kd:2 * kd].reshape(B, S, dims.num_k_heads, dims.head_k_dim)
    vc = conv_out[..., 2 * kd:].reshape(B, S, dims.num_v_heads, dims.head_v_dim)

    beta = torch.sigmoid(b.to(torch.float32))
    g = -torch.exp(lp["a_log"]) * F.softplus(a.to(torch.float32) + lp["dt_bias"])
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    beta = torch.where(valid[..., None], beta, zero)         # no write
    g = torch.where(valid[..., None], g, zero)               # no decay

    if prefill:
        # fast=True: the numerics the reference runs on its accelerator
        core, lc["state"] = gated_delta_rule_chunked(qc, kc, vc, g, beta, lc["state"],
                                                     fast=True)
    elif spec:
        core, _ = gated_delta_rule_recurrent(qc, kc, vc, g, beta, lc["state"])
        lc.update(p_k=kc, p_v=vc, p_g=g, p_b=beta, p_x=mixed)
    else:
        core, lc["state"] = gated_delta_rule_recurrent(qc, kc, vc, g, beta, lc["state"])
    core = gated_rms_norm(core.to(x.dtype), z, lp["la_norm"], cfg.rms_norm_eps,
                          plus_one=False)
    return linear(core.reshape(B, S, -1), lp["la_out_proj"], layer_idx=li)


def _conv_window(conv: torch.Tensor, mixed: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The conv window after each row's first n [B] inputs of mixed [B, S,
    C]: the last K-1 of concat(conv, mixed[:, :n]), in conv's dtype."""
    B, K1 = conv.shape[0], conv.shape[1]
    hist = torch.cat([conv.to(mixed.dtype), mixed], dim=1)
    take = n.to(torch.int64)[:, None] + torch.arange(K1, device=mixed.device)
    return hist[torch.arange(B, device=mixed.device)[:, None], take].to(conv.dtype)


def la_spec_commit(cache: Dict[str, Any], ncommit: torch.Tensor) -> None:
    """After a speculative verify step (``forward(spec_la=True)``), advance
    every DeltaNet layer's state and conv window by each row's committed
    token count ncommit [B] (1 to S), in place, and drop the replay stash.
    The rejected tail is masked (g = beta = 0, exact no-ops), so the state
    is the one the committed tokens decoded one at a time give. A no-op for
    caches without DeltaNet layers."""
    if "dp" in cache:                    # slots split over a mesh's dp groups
        b = ncommit.shape[0] // len(cache["dp"])
        for d, group in enumerate(cache["dp"]):
            la_spec_commit(group, ncommit[d * b:(d + 1) * b])
        return
    for lc in cache["layers"]:
        if "p_k" not in lc:
            continue
        p_k, p_v, p_g, p_b, p_x = (lc.pop(n) for n in ("p_k", "p_v", "p_g", "p_b", "p_x"))
        ncommit = ncommit.to(p_x.device)
        S = p_x.shape[1]
        mask = (torch.arange(S, device=p_x.device)[None, :] < ncommit[:, None])[..., None]
        zero = torch.zeros((), dtype=torch.float32, device=p_x.device)
        lc["state"] = delta_state_update(p_k, p_v, torch.where(mask, p_g, zero),
                                         torch.where(mask, p_b, zero), lc["state"])
        lc["conv"] = _conv_window(lc["conv"], p_x, ncommit)


def _mla_latent(lp: Dict[str, Any], lc: Dict[str, Any], x: torch.Tensor,
                positions: torch.Tensor, cfg: ModelConfig,
                at: Optional[CacheRows] = None, rope=None) -> torch.Tensor:
    """MLA's latent row [B, S, Dp] ``[ckv ; kpe ; 0]`` of each position,
    written into the layer's cache, which every head reads. `rope`: the
    positions' (cos, sin), when the caller has them."""
    L, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    kv_a = linear(x, lp["kv_a_proj"], layer_idx=lp.get("_layer_idx"))   # [B, S, L + dr]
    ckv = rms_norm(kv_a[..., :L], lp["kv_a_norm"], cfg.rms_norm_eps)
    cos, sin = rope or rope_cos_sin(positions, dr, cfg.rope_theta, cfg.rope_scaling)
    # DeepSeek checkpoints store rope dims pair-interleaved
    kpe = apply_rope(kv_a[..., L:][:, :, None, :], cos, sin, interleaved=True)[:, :, 0, :]
    cache = lc["kv"]                                         # [B, 1, Smax, Dp]
    row = F.pad(torch.cat([ckv, kpe], dim=-1), (0, cache.shape[-1] - (L + dr)))
    store_rows(cache, at if at is not None else cache_rows(positions, cache.shape[2]), row,
               head=0)
    return row


def _mla_attention(lp: Dict[str, Any], lc: Dict[str, Any], x: torch.Tensor,
                   positions: torch.Tensor, kv_len: torch.Tensor,
                   cfg: ModelConfig, fresh: bool = False,
                   at: Optional[CacheRows] = None, row: Optional[torch.Tensor] = None,
                   project: bool = True) -> torch.Tensor:
    """`row`: the latent rows ``_mla_latent`` already wrote (a head shard
    sharing its device's cache with another); without `project`, the heads'
    output before ``o_proj``."""
    B, S, _ = x.shape
    hq = cfg.num_attention_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    L = cfg.kv_lora_rank

    li = lp.get("_layer_idx")
    if "q_a_proj" in lp:                                     # q-LoRA (DeepSeek V3)
        qa = rms_norm(linear(x, lp["q_a_proj"], layer_idx=li), lp["q_a_norm"], cfg.rms_norm_eps)
        q = linear(qa, lp["q_b_proj"], layer_idx=li)
    else:
        q = linear(x, lp["q_proj"], layer_idx=li)
    q = q.reshape(B, S, hq, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    cos, sin = rope_cos_sin(positions, dr, cfg.rope_theta, cfg.rope_scaling)
    if row is None:
        row = _mla_latent(lp, lc, x, positions, cfg, at, (cos, sin))
    cache = lc["kv"]
    Dp = cache.shape[-1]
    q_pe = apply_rope(q_pe, cos, sin, interleaved=True)

    scale = yarn_softmax_scale((dn + dr) ** -0.5, cfg.rope_scaling)
    # absorbed MQA form: q_nope @ w_kc joins q_pe against the single-head
    # [ckv ; kpe] key; the absorb products run in true f32
    q_eff = torch.einsum("bshd,hdl->bshl", q_nope.to(torch.float32),
                         lp["w_kc"].to(torch.float32)).to(x.dtype)
    q_cat = F.pad(torch.cat([q_eff, q_pe.to(x.dtype)], dim=-1), (0, Dp - (L + dr)))
    # the first chunk attends to its own bf16 rows, not the cache's
    ctx = flash_attention(q_cat, row[:, None] if fresh else cache, positions[:, 0], kv_len,
                          scale, v_dim=L, qk_dim=L + dr)
    out = torch.einsum("bshl,hlv->bshv", ctx.to(torch.float32),
                       lp["w_vc"].to(torch.float32)).to(x.dtype).reshape(B, S, -1)
    return linear(out, lp["o_proj"], layer_idx=li) if project else out


def _sharded_attention(lp: Dict[str, Any], lc: Dict[str, Any], x: torch.Tensor, spec,
                       cfg: ModelConfig, cfg_s: ModelConfig, on, fresh: bool) -> torch.Tensor:
    """Attention split by head over the layer's shards (``lp["_heads"]``, the
    cache's ``lc["shards"]``): each shard runs its heads on its device with a
    configuration of its head counts, its output times its rows of
    ``o_proj`` in f32; the partials are summed on x's device, rounded once
    to x's dtype, and ``o_bias`` added. MLA's latent row is computed and
    written once a device. `cfg_s` is a shard's configuration
    (``parallel/mesh.shard_cfg``); `on(dev)` gives (positions, kv_len,
    where the rows go) on a device."""
    shards = lp["_heads"]
    rows: Dict[torch.device, torch.Tensor] = {}
    total = None
    for sh, slc in zip(shards, lc["shards"]):
        dev = sh["_device"]
        xe = x.to(dev)
        positions, kv_len, at = on(dev)
        if spec.attn_kind == "mla":
            if dev not in rows:
                rows[dev] = _mla_latent(sh, slc, xe, positions, cfg, at)
            ctx = _mla_attention(sh, slc, xe, positions, kv_len, cfg_s, fresh, at,
                                 row=rows[dev], project=False)
        else:
            ctx = _gqa_attention(sh, slc, xe, positions, kv_len, cfg_s, spec.sliding, fresh,
                                 at, project=False)
        part = linear(ctx, sh["o_proj"], out_dtype=torch.float32).to(x.device)
        total = part if total is None else total + part
    o = total.to(x.dtype)
    if "o_bias" in lp:
        o = o + lp["o_bias"].to(o.dtype)
    return o


def _shared_gate(lp: Dict[str, Any], x2d: torch.Tensor) -> torch.Tensor:
    """sigmoid(x @ shared_gate_w) [T, 1] f32: the per-token weight of the
    shared expert in the Qwen3-Next family."""
    return torch.sigmoid(linear(x2d, lp["shared_gate_w"]).to(torch.float32))


def _shared_expert(lp: Dict[str, Any], x2d: torch.Tensor) -> Optional[torch.Tensor]:
    """The layer's shared experts as one dense product (gated in the
    Qwen3-Next family), None without them."""
    if "shared_w13" not in lp:
        return None
    shared = mlp_forward(x2d, lp["shared_w13"], lp["shared_w2"])
    if "shared_gate_w" in lp:
        shared = shared * _shared_gate(lp, x2d).to(shared.dtype)
    return shared


def _offload_mlp(lp: Dict[str, Any], x2d: torch.Tensor, cfg: ModelConfig, routing,
                 offload, layer: int) -> torch.Tensor:
    """A MoE layer whose routed experts are in host memory: hot picks on the
    card (bf16 rows, as the reference's hot call passes no activation), cold
    picks (id -1, weight 0 for the card's side) on the host, overlapped.
    The sum is the reference's: (hot + host) + shared, in x's dtype. A layer
    whose hot set holds every expert has no cold pick and skips the host
    (the reference calls it with none live; adding its zeros changes
    nothing)."""
    gpt_oss = cfg.model_type == "gpt_oss"
    idx, wts = routing.topk_idx, routing.topk_weights
    hot = "hot_w13" in lp
    handle = None
    if hot:
        local = lp["hot_remap"][idx.to(torch.int64)]
        valid = local >= 0
        if lp["hot_w13"].q.shape[0] < cfg.n_routed_experts:
            handle = offload.dispatch(x2d, torch.where(valid, torch.full_like(idx, -1), idx),
                                      torch.where(valid, torch.zeros_like(wts), wts))
        out = moe_forward(x2d, lp["hot_w13"], lp["hot_w2"],
                          torch.where(valid, local, torch.zeros_like(local)),
                          torch.where(valid, wts, torch.zeros_like(wts)),
                          swiglu_limit=cfg.swiglu_limit, gpt_oss=gpt_oss,
                          w13_bias=lp.get("hot_w13_bias"), w2_bias=lp.get("hot_w2_bias"),
                          pick_valid=valid)
    else:
        handle = offload.dispatch(x2d, idx, wts)     # one copy down, then an event
        out = None
    shared = _shared_expert(lp, x2d)                 # the card works while the host does
    if handle is not None:
        cold = offload.collect(layer, handle, x2d.device).to(x2d.dtype)
        out = cold if out is None else out + cold
    return out if shared is None else out + shared


def _mlp(lp: Dict[str, Any], x2d: torch.Tensor, cfg: ModelConfig,
         prefill: bool, activation: str, offload=None, layer: int = -1) -> torch.Tensor:
    gpt_oss = cfg.model_type == "gpt_oss"
    act = dict(swiglu_limit=cfg.swiglu_limit, gpt_oss=gpt_oss)
    sp = lp.get("_sp")
    if sp is not None and len(sp) > 1 and x2d.shape[0] % len(sp) == 0:
        # sequence parallel (parallel/sp.py): each shard its slice of the
        # rows, on its device; rows that do not split run whole below
        n = x2d.shape[0] // len(sp)
        return torch.cat([_mlp(sh, x2d[i * n:(i + 1) * n].to(sh["_device"]), cfg, prefill,
                               activation).to(x2d.device) for i, sh in enumerate(sp)])
    if "mlp_w13" in lp:
        return mlp_forward(x2d, lp["mlp_w13"], lp["mlp_w2"], **act)
    routing = compute_routing(x2d, lp["gate_w"], cfg, lp.get("gate_bias"),
                              logit_bias=lp.get("gate_logit_bias"))
    if "_ep" in lp:
        # expert parallel (parallel/ep.py): every shard its slice of the
        # experts on its device, the partials summed here in f32; the shared
        # experts are a dense product, as under the reference's mesh
        out = ep_combine(x2d, lp["_ep"], routing.topk_idx, routing.topk_weights,
                         activation=activation, **act)
        shared = _shared_expert(lp, x2d)
        return out if shared is None else out + shared
    if "w13" not in lp:
        return _offload_mlp(lp, x2d, cfg, routing, offload, layer)
    w13 = lp["w13"]
    E_stack = (w13.q if isinstance(w13, QTensor) else w13).shape[0]
    n_virt = E_stack - cfg.n_routed_experts
    if n_virt > 0 and not prefill and not gpt_oss:
        # decode: the folded shared experts are always-picked virtual
        # experts, computed in the same kernel as the routed, with weight 1
        # or the layer's per-token shared gate
        T = x2d.shape[0]
        sh_idx = torch.arange(cfg.n_routed_experts, E_stack, dtype=torch.int32,
                              device=x2d.device).expand(T, n_virt)
        if "shared_gate_w" in lp:
            sh_w = _shared_gate(lp, x2d).expand(T, n_virt)
        else:
            sh_w = torch.ones((T, n_virt), dtype=torch.float32, device=x2d.device)
        return moe_forward(x2d, lp["w13"], lp["w2"],
                           torch.cat([routing.topk_idx, sh_idx], dim=1),
                           torch.cat([routing.topk_weights, sh_w], dim=1),
                           activation=activation, **act)
    out = moe_forward(x2d, lp["w13"], lp["w2"], routing.topk_idx,
                      routing.topk_weights, w13_bias=lp.get("w13_bias"),
                      w2_bias=lp.get("w2_bias"), activation=activation, **act)
    # prefill: shared experts as one dense product, from the same values the
    # virtual experts were sliced from
    shared = _shared_expert(lp, x2d)
    return out if shared is None else out + shared


def make_layer_step(cfg: ModelConfig, *, prefill: bool, positions: torch.Tensor,
                    valid: torch.Tensor, kv_len: torch.Tensor, activation: str,
                    fresh: bool, at: Optional[CacheRows], spec_la: bool = False,
                    offload=None):
    """One layer as a function, ``step(x, lp, lc, spec, layer) → x`` (norm →
    attention → norm → MLP, the cache updated in place): the body of
    ``forward``'s layer loop, which the MTP module (``models/mtp.py``) and
    the pipeline stages (``parallel/pp.py``) run too. The reference's
    ``make_layer_step``. `layer`, the absolute index, names the host store's
    entry of an offloaded MoE layer. A layer sharded over a mesh
    (``parallel/mesh.py``) carries its shards in its leaves (``_heads``,
    ``_ep``, ``_sp``), each with its device: the reference's `mesh`,
    `sp_axis` and `ep_axis` arguments are read from there."""
    moved = {positions.device: (positions, kv_len, at)}
    shard_cfgs: Dict[int, ModelConfig] = {}

    def on(dev: torch.device):
        """(positions, kv_len, where the rows go) on a head shard's device."""
        if dev not in moved:
            moved[dev] = (positions.to(dev), kv_len.to(dev),
                          None if at is None else CacheRows(*(
                              None if t is None else t.to(dev) for t in at)))
        return moved[dev]

    def step(x: torch.Tensor, lp: Dict[str, Any], lc: Dict[str, Any], spec,
             layer: int = -1) -> torch.Tensor:
        B, S = x.shape[:2]
        if TIMING.diag:
            # the reference's KRASIS_TPU_DIAG: each layer's input RMS
            r = float(torch.sqrt(torch.mean(torch.square(x.to(torch.float32)))))
            print(f"[diag] {spec.attn_kind} in_rms={r:.4f}", flush=True)
        normed = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps, cfg.norm_plus_one)
        if "_heads" in lp:
            n = len(lp["_heads"])
            if n not in shard_cfgs:
                shard_cfgs[n] = shard_cfg(cfg, n)
            attn = _sharded_attention(lp, lc, normed, spec, cfg, shard_cfgs[n], on, fresh)
        elif spec.attn_kind == "gqa":
            attn = _gqa_attention(lp, lc, normed, positions, kv_len, cfg, spec.sliding, fresh, at)
        elif spec.attn_kind == "mla":
            attn = _mla_attention(lp, lc, normed, positions, kv_len, cfg, fresh, at)
        else:
            attn = _la_attention(lp, lc, normed, valid, cfg, prefill, spec=spec_la)
        x = x + attn
        normed = rms_norm(x, lp["post_norm"], cfg.rms_norm_eps, cfg.norm_plus_one)
        return x + _mlp(lp, normed.reshape(B * S, -1), cfg, prefill,
                        activation, offload, layer).reshape(B, S, -1)

    return step


def _cache_rows_of(lc: Dict[str, Any]) -> Optional[int]:
    """The rows S of a layer's attention buffers (of its first head shard's
    when the layer is head-sharded), None without them."""
    lc = lc["shards"][0] if "shards" in lc else lc
    return next((lc[k].shape[2] for k in ("kv", "k") if k in lc), None)


def step_inputs(length: torch.Tensor, seq_lens: torch.Tensor, S: int, buffers, prefill: bool):
    """(positions [B, S], valid [B, S], kv_len [B], where the rows go) of a
    pass over S tokens after `length` cached ones, `seq_lens` of them valid,
    into the layer caches `buffers` (each layer's attention writes its rows
    at the same places; None without attention buffers)."""
    steps = torch.arange(S, device=length.device)
    positions = length.to(torch.int64)[:, None] + steps
    valid = steps[None, :] < seq_lens[:, None]
    kv_len = length + seq_lens.to(length.dtype)
    S_cache = next((n for n in map(_cache_rows_of, buffers) if n is not None), None)
    at = None if S_cache is None else cache_rows(positions, S_cache, decode=not prefill)
    return positions, valid, kv_len, at


def forward(params: Dict[str, Any], tokens: torch.Tensor, seq_lens: torch.Tensor,
            cache: Dict[str, Any], cfg: ModelConfig, quant: QuantConfig,
            prefill: bool, return_all_logits: bool = False,
            history: int = 0, return_hidden: bool = False, spec_la: bool = False,
            offload=None, mesh=None):
    """One pass over tokens [B, S] with seq_lens [B] valid tokens per row,
    after cache["length"] cached ones. Writes the new cache rows, advances
    cache["length"], and returns f32 logits [B, V] at each row's last valid
    token, or [B, S, V] at every position with return_all_logits (the
    perplexity path and the verify step). `history` is the host's count of
    tokens cached before a prefill chunk: 0 marks the first chunk (read on
    the host, so the cache's device-side length is never synchronised).
    With `return_hidden`, returns (logits, the final-norm hidden [B, S, H]
    at every position: the MTP module's input). `spec_la` (a verify step)
    leaves the DeltaNet layers' state for ``la_spec_commit``. `offload`: the
    host store of a model whose routed experts are offloaded. `mesh`: the
    mesh the parameters are sharded over (``parallel/mesh.shard_params``;
    read from them when not given), the cache laid out by
    ``cache_shardings``: a cache whose slots split over dp runs each group's
    rows on its devices, and the logits come back to group 0's home."""
    if mesh is not None and params.get("mesh") is not mesh:
        raise ValueError("forward(mesh=): shard the parameters over that mesh first "
                         "(parallel.mesh.shard_params)")
    if "dp" in cache:
        return dp_groups(params, cache, lambda gp, gc, tok, sl: forward(
            gp, tok, sl, gc, cfg, quant, prefill, return_all_logits, history, return_hidden,
            spec_la, offload), (tokens, seq_lens))
    B, S = tokens.shape
    positions, valid, kv_len, at = step_inputs(cache["length"], seq_lens, S, cache["layers"],
                                               prefill)
    # prefill MoE stays bf16: the int8-activation numerics belong to decode
    step = make_layer_step(cfg, prefill=prefill, positions=positions, valid=valid,
                           kv_len=kv_len,
                           activation="bf16" if prefill else quant.expert_activation,
                           fresh=prefill and history == 0, at=at, spec_la=spec_la,
                           offload=offload)
    x = params["embed"][tokens]
    for i, (lp, lc, spec) in enumerate(zip(params["layers"], cache["layers"], layer_specs(cfg))):
        x = step(x, lp, lc, spec, i)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps, cfg.norm_plus_one)
    hidden = x
    if not return_all_logits:
        last = torch.clamp(seq_lens.to(torch.int64) - 1, min=0)
        x = x[torch.arange(B, device=x.device), last]
    cache["length"] = kv_len
    logits = linear(x, params["lm_head"], out_dtype=torch.float32)
    return (logits, hidden) if return_hidden else logits


def chosen_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """log P(tok) under log_softmax(logits): [B, V], [B] → [B] f32."""
    lsm = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(lsm, -1, tok[:, None].to(torch.int64))[:, 0]


@torch.inference_mode()
def forced_decode(params: Dict[str, Any], cache: Dict[str, Any], toks: torch.Tensor,
                  cfg: ModelConfig, quant: QuantConfig, offload=None) -> torch.Tensor:
    """Teacher-forced decode (the reference's ``make_forced_decode_fn``):
    toks [B, steps + 1] on the cache's device; step t feeds toks[:, t] through
    the serving decode forward (T = 1: int8 expert activations where the
    quant asks, the cache in its own dtype) and scores toks[:, t + 1]. The
    cache advances in place. Returns log P [B, steps] f32 on the host: the
    steps queue without a host sync, and the result is read back once."""
    B, n = toks.shape
    seq1 = torch.ones((B,), dtype=torch.int32, device=toks.device)
    lps = []
    for t in range(n - 1):
        logits = forward(params, toks[:, t:t + 1], seq1, cache, cfg, quant, prefill=False,
                         offload=offload)
        lps.append(chosen_logprob(logits, toks[:, t + 1]))
    return torch.stack(lps, dim=1).cpu()


def decode_block_batched(params: Dict[str, Any], tok: torch.Tensor, cache: Dict[str, Any],
                         cfg: ModelConfig, quant: QuantConfig, steps: int,
                         generator: torch.Generator, seen: torch.Tensor,
                         temperature: torch.Tensor, top_p: torch.Tensor,
                         presence_penalty: torch.Tensor, top_k: torch.Tensor,
                         need_logprobs: bool = True, max_top_k: int = 64, offload=None):
    """`steps` decode forwards over every row of the cache (the
    continuous-batching block; the reference's
    ``make_multi_decode_batched_fn``): each step feeds tok [B], samples the
    next token of every row with its own temperature, top_p,
    presence_penalty and top_k [B] (``sample_batched``, draws from
    `generator`), marks it in seen [B, V] (in place) and, with
    `need_logprobs`, takes its logprob under the raw model distribution
    (zeros otherwise). Returns tokens [steps, B] int64 and logprobs
    [steps, B] f32, left on the device: the block never waits for it (an
    offloaded model's MoE layers wait on their own copies down)."""
    B = tok.shape[0]
    rows = torch.arange(B, device=tok.device)
    seq1 = torch.ones((B,), dtype=torch.int32, device=tok.device)
    toks, lps = [], []
    for _ in range(steps):
        logits = forward(params, tok[:, None], seq1, cache, cfg, quant, prefill=False,
                         offload=offload)
        tok = sample_batched(logits, temperature, top_p, presence_penalty, seen, top_k,
                             max_top_k, generator)
        lps.append(chosen_logprob(logits, tok) if need_logprobs
                   else torch.zeros((B,), dtype=torch.float32, device=tok.device))
        seen[rows, tok] = True
        toks.append(tok)
    return torch.stack(toks), torch.stack(lps)
