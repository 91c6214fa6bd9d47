"""Checkpoint loading: safetensors / GGUF → the port's parameters (PyTorch).

The port of ``krasis_tpu/models/loader.py``. A checkpoint directory
(``config.json`` and safetensors shards) or a GGUF file is read tensor by
tensor from mmap views, each tensor goes to the loader's device (the card
unless the caller asks for the CPU), and there it is dequantized where it
arrives prequantized, transposed to math orientation [in, out], and
quantized by the ``QuantConfig`` policy with ``quant.quantize``, which
gives ``quantize_np``'s bits on either device. Routed experts stream one
at a time into stacks reserved for the whole layer.

The name schema is the reference's: DeepSeek V2 / V3 (MLA with the latent
projection at an int8 floor under int4 attention, q-LoRA, ``kv_b_proj``
split into ``w_kc`` / ``w_vc``, shared experts, ``e_score_correction_bias``),
Qwen3 (qk-norm), Qwen3-Next / Qwen3.5 (Gated DeltaNet with its int8 floor,
``conv1d`` [C, 1, K] → [C, K], gated attention and shared expert), GPT-OSS
(``router``, fused experts with gate / up interleaved in bf16 or MXFP4
blocks, biases, ``sinks``), VL wrappers (the layers prefix), tied
embeddings, MTP modules, and the prequantized inputs: fp8 block
(``weight_scale_inv``), compressed-tensors int4 (``weight_packed``) and
GGUF (``utils/gguf_source.py``).

``load_params`` goes through the weight cache (``models/weight_cache.py``,
the reference's format, in ``$KRASIS_TPU_HOME/cache_torch/``, a directory
of the port's own), built under a lock on the first load. The shared
experts are folded into stacks reserved for them as the leaves are placed,
never as a second copy of a stack on the device.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional, Sequence

import torch

from ..config import ModelConfig, QuantConfig
from ..device import resolve_device
from ..parallel.mesh import shard_params
from ..quant import (QTensor, dequant_compressed_int4, dequant_fp8_block, dequant_mxfp4,
                     pick_group_size, quantize)
from ..utils.safetensors_io import ShardedSafetensors
from .params import (fold_layer, fold_width, layer_fold_width, layer_specs, mtp_layer_spec,
                     params_from_stacked, pattern_info, pattern_layer_index,
                     stack_pattern_projections)

CACHE_VERSION = 2


def _checkpoint_fingerprint(model_path: str) -> str:
    """(name, size, mtime) of every weight, index and config file, so a
    checkpoint rewritten in place misses the cache."""
    entries = []
    if os.path.isdir(model_path):
        for f in sorted(os.listdir(model_path)):
            if f.endswith((".safetensors", ".gguf", ".json")):
                st = os.stat(os.path.join(model_path, f))
                entries.append((f, st.st_size, int(st.st_mtime)))
    elif os.path.exists(model_path):
        st = os.stat(model_path)
        entries.append((os.path.basename(model_path), st.st_size, int(st.st_mtime)))
    return json.dumps(entries)


def _cache_dir(cfg: ModelConfig, quant: QuantConfig) -> str:
    """The reference's key (every QuantConfig field, the path, the depth and
    the fingerprint) under ``cache_torch/``: the two packages never share a
    cache directory."""
    base = os.environ.get("KRASIS_TPU_HOME", os.path.expanduser("~/.krasis_tpu"))
    tag = json.dumps([CACHE_VERSION, sorted(vars(quant).items(), key=str)],
                     sort_keys=True, default=str)
    h = hashlib.sha256((tag + cfg.model_path + str(cfg.num_hidden_layers)
                        + _checkpoint_fingerprint(cfg.model_path)).encode()).hexdigest()[:16]
    name = os.path.basename(os.path.normpath(cfg.model_path)) or "model"
    return os.path.join(base, "cache_torch", f"{name}-{h}")


def _is_gguf(model_path: str) -> bool:
    return model_path.endswith(".gguf") or (
        os.path.isdir(model_path)
        and not os.path.exists(os.path.join(model_path, "config.json"))
        and any(f.endswith(".gguf") for f in os.listdir(model_path)))


class WeightLoader:
    """Streams a checkpoint into parameters on `device`, one tensor (and
    one expert) at a time. `dtype` stores the unquantized weights (bf16, or
    f32 for the parity tests). `experts`, when set, are the only routed
    experts read (a check of a few experts against another device's
    load); None reads them all."""

    experts: Optional[Sequence[int]] = None

    def __init__(self, cfg: ModelConfig, quant: QuantConfig, dtype=torch.bfloat16,
                 device=None):
        self.cfg = cfg
        self.quant = quant
        self.dtype = torch.float32 if dtype == torch.float32 else torch.bfloat16
        self.device = resolve_device(device)
        if _is_gguf(cfg.model_path):
            from ..utils.gguf_source import GgufCheckpoint

            self.st = GgufCheckpoint(cfg.model_path, device=self.device)
            self.prefix = "model"
        else:
            self.st = ShardedSafetensors(cfg.model_path)
            self.prefix = cfg.layers_prefix

    # -- helpers ------------------------------------------------------------

    def _has(self, name: str) -> bool:
        """Present, raw or as a compressed-tensors int4 variant."""
        if name in self.st:
            return True
        return name.endswith(".weight") and name[:-len(".weight")] + ".weight_packed" in self.st

    @property
    def _ct_group_size(self) -> int:
        """compressed-tensors group size from config.json (default 128)."""
        if not hasattr(self, "_ct_gs"):
            gs = 128
            try:
                with open(os.path.join(self.cfg.model_path, "config.json")) as f:
                    qc = json.load(f).get("quantization_config", {})
                for grp in qc.get("config_groups", {}).values():
                    gs = int(grp.get("weights", {}).get("group_size", gs))
                    break
            except (OSError, ValueError):
                pass
            self._ct_gs = gs
        return self._ct_gs

    def _rows(self, name: str) -> int:
        """The out dim of a [out, in] weight, read from the header."""
        packed = name[:-len(".weight")] + ".weight_packed"
        return self.st.shape(name if name in self.st else packed)[0]

    def _dev(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device)

    def _get(self, name: str, required: bool = True) -> Optional[torch.Tensor]:
        """A tensor on the loader's device; fp8 block and compressed int4
        inputs arrive dequantized to f32."""
        if name in self.st:
            t = self.st.tensor(name)
            if t.dtype == torch.float8_e4m3fn and f"{name}_scale_inv" in self.st:
                return dequant_fp8_block(self._dev(t),
                                         self._dev(self.st.tensor(f"{name}_scale_inv")))
            return self._dev(t)
        if name.endswith(".weight"):
            base = name[:-len(".weight")]
            if f"{base}.weight_packed" in self.st:
                return dequant_compressed_int4(self._dev(self.st.tensor(f"{base}.weight_packed")),
                                               self._dev(self.st.tensor(f"{base}.weight_scale")),
                                               self._ct_group_size)
        if required:
            raise KeyError(f"missing tensor {name}")
        return None

    def _store(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dtype).contiguous()

    def _quant(self, w: torch.Tensor, mode: str):
        """A [K, N] f32 weight by `mode` ('bf16' | 'int8' | 'int4')."""
        if mode == "bf16":
            return self._store(w)
        qt = quantize(w, {"int8": 8, "int4": 4}[mode], self.quant.group_size)
        return QTensor(qt.q.contiguous(), qt.scales.contiguous(), qt.bits, qt.group_size)

    def _linear(self, name: str, mode: str):
        """A [out, in] checkpoint matrix as [in, out], by `mode`."""
        return self._quant(self._get(name).to(torch.float32).T, mode)

    def _norm(self, name: str) -> torch.Tensor:
        return self._store(self._get(name))

    # -- main ---------------------------------------------------------------

    def load(self, fold: bool = False, expert_sink=None) -> Dict[str, Any]:
        """The port's parameters on the device; with `fold`, each layer's
        shared experts are folded into its reserved stack tail. With
        `expert_sink(i)`, layer i's routed experts go to the sink it returns
        (``_load_moe``) and not into a stack on the device."""
        cfg = self.cfg
        params: Dict[str, Any] = self.load_head()
        layers = []
        for i, spec in enumerate(layer_specs(cfg)):
            lp = self._load_layer(i, spec, fold=fold, expert_sink=expert_sink and expert_sink(i))
            layers.append(fold_layer(lp, cfg, reserved=True) if fold else lp)
        params["layers"] = stack_pattern_projections(layers, cfg)
        if self.has_mtp():
            params["mtp"] = self._load_mtp(
                fold=fold, expert_sink=expert_sink and expert_sink(cfg.num_hidden_layers))
            if fold:
                params["mtp"]["layer"] = fold_layer(params["mtp"]["layer"], cfg, reserved=True)
        return params

    def has_mtp(self) -> bool:
        """The checkpoint ships an MTP module (a layer at index
        num_hidden_layers with enorm / hnorm / eh_proj and a shared head)."""
        cfg = self.cfg
        return cfg.num_nextn_predict_layers > 0 and self._has(
            f"{self.prefix}.layers.{cfg.num_hidden_layers}.eh_proj.weight")

    def _load_mtp(self, expert_sink=None, fold: bool = False) -> Dict[str, Any]:
        """MTP module leaves; the module's own embed_tokens (tied to the main
        one) is skipped. The forward does not read them yet."""
        cfg, q = self.cfg, self.quant
        L = f"{self.prefix}.layers.{cfg.num_hidden_layers}"
        mtp: Dict[str, Any] = {
            "enorm": self._norm(f"{L}.enorm.weight"),
            "hnorm": self._norm(f"{L}.hnorm.weight"),
            "eh_proj": self._linear(f"{L}.eh_proj.weight", q.attention),
            "final_norm": self._norm(f"{L}.shared_head.norm.weight"),
            "layer": self._load_layer(cfg.num_hidden_layers, mtp_layer_spec(cfg),
                                      expert_sink=expert_sink, fold=fold),
        }
        head = f"{L}.shared_head.head.weight"
        if self._has(head):
            mtp["head"] = self._linear(head, q.lm_head)
        return mtp

    def load_head(self) -> Dict[str, Any]:
        """embed, final_norm and lm_head."""
        cfg, P = self.cfg, self.prefix
        params: Dict[str, Any] = {
            "embed": self._store(self._get(f"{P}.embed_tokens.weight")),
            "final_norm": self._norm(f"{P}.norm.weight"),
        }
        if cfg.tie_word_embeddings:
            params["lm_head"] = self._get(f"{P}.embed_tokens.weight").to(self.dtype).T.contiguous()
        else:
            lm_name = "lm_head.weight"
            if not self._has(lm_name):
                lm_name = f"{P}.lm_head.weight"
            params["lm_head"] = self._linear(lm_name, self.quant.lm_head)
        return params

    def _load_layer(self, i: int, spec, expert_sink=None, fold: bool = False) -> Dict[str, Any]:
        cfg, q = self.cfg, self.quant
        L = f"{self.prefix}.layers.{i}"
        lp: Dict[str, Any] = {
            "input_norm": self._norm(f"{L}.input_layernorm.weight"),
            "post_norm": self._norm(f"{L}.post_attention_layernorm.weight"),
        }
        att = q.attention
        # the latent and recurrent paths compound weight noise: int8 floor
        floor8 = "int8" if att == "int4" else att
        if spec.attn_kind == "gqa":
            A = f"{L}.self_attn"
            for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
                lp[name] = self._linear(f"{A}.{name}.weight", att)
            for pn, key in (("q_bias", "q_proj.bias"), ("k_bias", "k_proj.bias"),
                            ("v_bias", "v_proj.bias"), ("o_bias", "o_proj.bias")):
                t = self._get(f"{A}.{key}", required=False)
                if t is not None:
                    lp[pn] = t.to(torch.bfloat16).contiguous()
            if cfg.qk_norm:
                lp["q_norm"] = self._norm(f"{A}.q_norm.weight")
                lp["k_norm"] = self._norm(f"{A}.k_norm.weight")
            sinks = self._get(f"{A}.sinks", required=False)
            if sinks is not None:
                lp["sinks"] = sinks.to(torch.float32).contiguous()
        elif spec.attn_kind == "mla":
            A = f"{L}.self_attn"
            if cfg.q_lora_rank:
                lp["q_a_proj"] = self._linear(f"{A}.q_a_proj.weight", att)
                lp["q_a_norm"] = self._norm(f"{A}.q_a_layernorm.weight")
                lp["q_b_proj"] = self._linear(f"{A}.q_b_proj.weight", att)
            else:
                lp["q_proj"] = self._linear(f"{A}.q_proj.weight", att)
            lp["kv_a_proj"] = self._linear(f"{A}.kv_a_proj_with_mqa.weight", floor8)
            lp["kv_a_norm"] = self._norm(f"{A}.kv_a_layernorm.weight")
            # kv_b_proj [hq·(dn + dv), L] → the absorbed split, unquantized
            hq, dn, dv = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
            kv_b = self._get(f"{A}.kv_b_proj.weight").to(torch.float32)
            kv_b = kv_b.reshape(hq, dn + dv, cfg.kv_lora_rank)
            lp["w_kc"] = self._store(kv_b[:, :dn, :])                     # [hq, dn, L]
            lp["w_vc"] = self._store(kv_b[:, dn:, :].transpose(1, 2))     # [hq, L, dv]
            lp["o_proj"] = self._linear(f"{A}.o_proj.weight", att)
        else:                                                # Gated DeltaNet
            A = f"{L}.linear_attn"
            lp["qkvz_proj"] = self._linear(f"{A}.in_proj_qkvz.weight", floor8)
            lp["ba_proj"] = self._linear(f"{A}.in_proj_ba.weight", floor8)
            conv = self._get(f"{A}.conv1d.weight").to(torch.float32)      # [C, 1, K]
            lp["conv_w"] = self._store(conv[:, 0, :])
            lp["dt_bias"] = self._get(f"{A}.dt_bias").to(torch.float32).contiguous()
            lp["a_log"] = self._get(f"{A}.A_log").to(torch.float32).contiguous()
            lp["la_norm"] = self._norm(f"{A}.norm.weight")
            lp["la_out_proj"] = self._linear(f"{A}.out_proj.weight", floor8)

        if spec.mlp_kind == "moe":
            lp.update(self._load_moe(i, expert_sink=expert_sink, fold=fold))
        else:
            M = f"{L}.mlp"
            lp["mlp_w13"] = self._fused_w13(f"{M}.gate_proj.weight", f"{M}.up_proj.weight",
                                            q.dense_mlp)
            lp["mlp_w2"] = self._linear(f"{M}.down_proj.weight", q.dense_mlp)
        return lp

    def _fused_w13(self, gate_name: str, up_name: str, mode: str):
        gate = self._get(gate_name).to(torch.float32).T                   # [H, I]
        up = self._get(up_name).to(torch.float32).T
        return self._quant(torch.cat([gate, up], dim=-1), mode)          # [H, 2I]

    def _iter_experts(self, i: int):
        """(e, w13_e [H, 2I] f32, w2_e [I, H] f32) on the device, one expert
        at a time: per-expert tensors, GPT-OSS's fused bf16 tensors, or its
        MXFP4 blocks (gate / up interleaved in both fused forms)."""
        M = f"{self.prefix}.layers.{i}.mlp"
        ids = range(self.cfg.n_routed_experts) if self.experts is None else self.experts

        def split(gu):                                   # [H, 2I] interleaved
            return torch.cat([gu[:, ::2], gu[:, 1::2]], dim=-1)

        if f"{M}.experts.gate_up_proj_blocks" in self.st:
            gu_b, gu_s, dn_b, dn_s = (self.st.tensor(f"{M}.experts.{n}") for n in (
                "gate_up_proj_blocks", "gate_up_proj_scales", "down_proj_blocks",
                "down_proj_scales"))
            for e in ids:
                gu = dequant_mxfp4(self._dev(gu_b[e]), self._dev(gu_s[e])).T    # [H, 2I]
                w2_e = dequant_mxfp4(self._dev(dn_b[e]), self._dev(dn_s[e])).T  # [I, H]
                yield e, split(gu), w2_e
            return
        if f"{M}.experts.gate_up_proj" in self.st:      # GPT-OSS fused bf16
            gu = self.st.tensor(f"{M}.experts.gate_up_proj")                  # [E, H, 2I]
            dn = self.st.tensor(f"{M}.experts.down_proj")                     # [E, I, H]
            for e in ids:
                yield (e, split(self._dev(gu[e]).to(torch.float32)),
                       self._dev(dn[e]).to(torch.float32))
            return
        for e in ids:
            Ex = f"{M}.experts.{e}"
            gate = self._get(f"{Ex}.gate_proj.weight").to(torch.float32).T
            up = self._get(f"{Ex}.up_proj.weight").to(torch.float32).T
            w2_e = self._get(f"{Ex}.down_proj.weight").to(torch.float32).T
            yield e, torch.cat([gate, up], dim=-1), w2_e

    def _shared_prefix(self, M: str) -> Optional[str]:
        """Qwen3-Next's `shared_expert` or DeepSeek's `shared_experts`."""
        for sh in (f"{M}.shared_expert", f"{M}.shared_experts"):
            if self._has(f"{sh}.gate_proj.weight"):
                return sh
        return None

    def _load_moe(self, i: int, expert_sink=None, fold: bool = False) -> Dict[str, Any]:
        """A MoE layer's leaves. With `expert_sink(e, w13_e, w2_e)` the
        routed experts stream to the sink (the cache build); otherwise they
        are quantized into stacks on the device, with room at the end for
        the virtual experts when `fold` applies to this layer."""
        cfg, q = self.cfg, self.quant
        M = f"{self.prefix}.layers.{i}.mlp"
        lp: Dict[str, Any] = {}
        gate_name = f"{M}.gate.weight"
        if not self._has(gate_name):
            gate_name = f"{M}.router.weight"             # GPT-OSS
        lp["gate_w"] = self._get(gate_name).to(torch.float32).T.contiguous()
        bias = self._get(f"{M}.gate.e_score_correction_bias", required=False)
        if bias is not None:
            lp["gate_bias"] = bias.to(torch.float32).contiguous()
        rbias = self._get(f"{M}.router.bias", required=False)
        if rbias is not None:                            # GPT-OSS: inside the logits
            lp["gate_logit_bias"] = rbias.to(torch.float32).contiguous()
        gub = self._get(f"{M}.experts.gate_up_proj_bias", required=False)
        dnb = self._get(f"{M}.experts.down_proj_bias", required=False)
        if gub is not None:                              # interleaved gate / up
            gub = gub.to(torch.float32)
            lp["w13_bias"] = torch.cat([gub[..., ::2], gub[..., 1::2]], dim=-1)
        if dnb is not None:
            lp["w2_bias"] = dnb.to(torch.float32).contiguous()

        E, H, I = cfg.n_routed_experts, cfg.hidden_size, cfg.moe_intermediate_size
        gs, bits = q.group_size, q.expert_bits
        sh = self._shared_prefix(M)
        if expert_sink is not None and bits in (4, 8):
            for e, w13_e, w2_e in self._iter_experts(i):
                expert_sink(e, w13_e, w2_e)
        elif bits == 16:                                 # unquantized experts (parity tests)
            w13 = torch.empty((E, H, 2 * I), dtype=self.dtype, device=self.device)
            w2 = torch.empty((E, I, H), dtype=self.dtype, device=self.device)
            for e, w13_e, w2_e in self._iter_experts(i):
                w13[e], w2[e] = w13_e, w2_e
            lp["w13"], lp["w2"] = w13, w2
        else:
            gs13, gs2 = pick_group_size(H, gs), pick_group_size(I, gs)
            n_virt = 0
            if fold and sh is not None:
                n_virt = fold_width(cfg, bits, gs2, self._rows(f"{sh}.gate_proj.weight"),
                                    biased="w13_bias" in lp)
            lp["w13"] = _empty_qtensor((E + n_virt, H, 2 * I), bits, gs13, self.device)
            lp["w2"] = _empty_qtensor((E + n_virt, I, H), bits, gs2, self.device)
            for e, w13_e, w2_e in self._iter_experts(i):
                for name, w in (("w13", w13_e), ("w2", w2_e)):
                    qt = quantize(w, bits, gs)
                    lp[name].q[e], lp[name].scales[e] = qt.q, qt.scales

        if sh is not None:
            lp["shared_w13"] = self._fused_w13(f"{sh}.gate_proj.weight",
                                               f"{sh}.up_proj.weight", q.shared_expert)
            lp["shared_w2"] = self._linear(f"{sh}.down_proj.weight", q.shared_expert)
        sg = self._get(f"{M}.shared_expert_gate.weight", required=False)
        if sg is not None:
            lp["shared_gate_w"] = self._store(sg.to(torch.float32).T)
        return lp


def _empty_qtensor(shape, bits: int, group_size: int, device) -> QTensor:
    """Room for a stack [*lead, K, N] quantized at `bits` in groups of
    `group_size` rows."""
    *lead, K, N = shape
    rows = K // 2 if bits == 4 else K
    return QTensor(torch.empty((*lead, rows, N), dtype=torch.int8, device=device),
                   torch.empty((*lead, K // group_size, N), dtype=torch.bfloat16, device=device),
                   bits, group_size)


def _dest(info, i: int):
    """(kind, group index, repetition) of global layer i in the stacked layout."""
    if i < info.prefix_n:
        return "prefix", i, None
    t = (i - info.prefix_n) % info.period
    r = (i - info.prefix_n) // info.period
    return "pattern", t, r


def build_cache(cfg: ModelConfig, quant: QuantConfig, cache_path: str,
                dtype=torch.bfloat16, device=None):
    """Stream a checkpoint into the cache, quantizing on `device`. Stacked
    expert regions are reserved once and written expert by expert, so the
    host holds about two expert tensors at a time."""
    from .weight_cache import CacheWriter

    wl = WeightLoader(cfg, quant, dtype=dtype, device=device)
    cw = CacheWriter(cache_path)
    try:
        info = pattern_info(cfg)
        for k, v in wl.load_head().items():
            cw.add_leaf(f"head/{k}", "head", v)
        H, I, E = cfg.hidden_size, cfg.moe_intermediate_size, cfg.n_routed_experts
        bits, gs = quant.expert_bits, quant.group_size
        gs13, gs2 = pick_group_size(H, gs), pick_group_size(I, gs)
        r13 = H // 2 if bits == 4 else H
        r2 = I // 2 if bits == 4 else I

        def put_stacked(key, group, r, reps, leaf):
            """A per-layer leaf into its [reps, ...] region."""
            if isinstance(leaf, QTensor):
                if f"{key}.q" not in cw.index:
                    for part in ("q", "scales"):
                        t = getattr(leaf, part)
                        cw.alloc(f"{key}.{part}", group, (reps,) + tuple(t.shape), t.dtype,
                                 bits=leaf.bits, group_size=leaf.group_size)
                cw.write_at(f"{key}.q", (r,), leaf.q)
                cw.write_at(f"{key}.scales", (r,), leaf.scales)
            else:
                if key not in cw.index:
                    cw.alloc(key, group, (reps,) + tuple(leaf.shape), leaf.dtype)
                cw.write_at(key, (r,), leaf)

        def sink_for(base, r):
            def sink(e, w13_e, w2_e):
                idx = (e,) if r is None else (r, e)
                for name, w in (("w13", w13_e), ("w2", w2_e)):
                    qt = quantize(w, bits, gs)
                    cw.write_at(f"{base}/{name}.q", idx, qt.q)
                    cw.write_at(f"{base}/{name}.scales", idx, qt.scales)
            return sink

        def alloc_experts(base, group, lead):
            for key, qshape, sshape, g in (
                    (f"{base}/w13", (E, r13, 2 * I), (E, H // gs13, 2 * I), gs13),
                    (f"{base}/w2", (E, r2, H), (E, I // gs2, H), gs2)):
                if f"{key}.q" not in cw.index:
                    cw.alloc_qtensor(key, group, lead + qshape, lead + sshape, bits, g)

        for i, spec in enumerate(layer_specs(cfg)):
            kind, t, r = _dest(info, i)
            group, base = f"{kind}_{t:02d}", f"{kind}/{t}"
            sink = None
            if spec.mlp_kind == "moe" and bits in (4, 8):
                alloc_experts(base, group, () if r is None else (info.reps,))
                sink = sink_for(base, r)
            lp = wl._load_layer(i, spec, expert_sink=sink)
            for name, leaf in lp.items():
                key = f"{base}/{name}"
                if r is None:
                    if f"{key}.q" not in cw.index and key not in cw.index:
                        cw.add_leaf(key, group, leaf)
                else:
                    put_stacked(key, group, r, info.reps, leaf)

        if wl.has_mtp():
            sink = None
            if mtp_layer_spec(cfg).mlp_kind == "moe" and bits in (4, 8):
                alloc_experts("mtp/layer", "mtp", ())
                sink = sink_for("mtp/layer", None)
            mtp = wl._load_mtp(expert_sink=sink)
            layer = mtp.pop("layer")
            for name, leaf in mtp.items():
                cw.add_leaf(f"mtp/{name}", "mtp", leaf)
            for name, leaf in layer.items():
                key = f"mtp/layer/{name}"
                if f"{key}.q" not in cw.index and key not in cw.index:
                    cw.add_leaf(key, "mtp", leaf)
        cw.finalize(n_prefix=info.prefix_n, n_pattern=max(info.period, 0))
    except BaseException:
        cw.abort()
        raise


def place_params(tree: Dict[str, Any], cfg: ModelConfig, device,
                 fold: bool = False, mesh=None) -> Dict[str, Any]:
    """The reference's stacked tree on the host (mmap-backed from the
    cache) → the port's parameters on `device`. With `fold`, a layer's
    expert stacks are placed into stacks with room for its virtual experts
    (one expert-dim block of the host stack at a time) and the shared
    experts are folded into that room. With a `mesh`, every leaf goes from
    the host straight to its shard (``parallel/mesh.shard_params``): no
    whole replica lands on one card, and nothing is folded."""
    if mesh is not None:
        return shard_params(params_from_stacked(tree), cfg, mesh)
    def put(leaf):
        if isinstance(leaf, QTensor):
            return QTensor(leaf.q.to(device), leaf.scales.to(device), leaf.bits, leaf.group_size)
        return leaf.to(device)

    def put_stack(t, extra):
        """[(reps,) E, R, N] → [(reps,) E + extra, R, N], a rep at a time."""
        E = t.shape[-3]
        out = torch.empty((*t.shape[:-3], E + extra, *t.shape[-2:]), dtype=t.dtype,
                          device=device)
        for r in range(t.shape[0]) if t.dim() == 4 else (None,):
            dst, src = (out, t) if r is None else (out[r], t[r])
            dst[:E].copy_(src)
        return out

    def put_layer(lp):
        extra = layer_fold_width(lp, cfg) if fold else 0
        out = {}
        for k, v in lp.items():
            if extra and k in ("w13", "w2"):
                out[k] = QTensor(put_stack(v.q, extra), put_stack(v.scales, extra),
                                 v.bits, v.group_size)
            else:
                out[k] = put(v)
        return out

    placed = {k: put(tree[k]) for k in ("embed", "final_norm", "lm_head")}
    placed["prefix_layers"] = [put_layer(lp) for lp in tree["prefix_layers"]]
    placed["pattern"] = [put_layer(lp) for lp in tree["pattern"]]
    if "mtp" in tree:
        placed["mtp"] = {k: (put_layer(v) if k == "layer" else put(v))
                         for k, v in tree["mtp"].items()}
    params = params_from_stacked(placed)
    if fold:
        params["layers"] = [fold_layer(lp, cfg, reserved=True) for lp in params["layers"]]
        if "mtp" in params:
            params["mtp"]["layer"] = fold_layer(params["mtp"]["layer"], cfg, reserved=True)
    return params


def cached_tree(cfg: ModelConfig, quant: QuantConfig, device=None) -> Dict[str, Any]:
    """The cache's stacked tree of mmap-backed CPU leaves, building the
    cache (quantizing on `device`) under the build lock on a miss."""
    from .weight_cache import BuildLock, CacheReader

    d = _cache_dir(cfg, quant)
    if not os.path.exists(os.path.join(d, "meta.json")):
        os.makedirs(os.path.dirname(d), exist_ok=True)
        lock = BuildLock(d)
        if lock.acquire() == "acquired":
            try:
                if not os.path.exists(os.path.join(d, "meta.json")):
                    build_cache(cfg, quant, d, device=device)
            finally:
                lock.release()
    return CacheReader(d).as_pytree()


def load_params(cfg: ModelConfig, quant: QuantConfig, dtype=torch.bfloat16,
                use_cache: bool = True, mesh=None, device=None) -> Dict[str, Any]:
    """Load and quantize a checkpoint onto `device` (the card unless the
    caller asks for the CPU), through the weight cache when `dtype` is bf16
    and `use_cache` holds. The shared experts are folded here, as the
    reference's load_params folds them before placement; Engine's own fold
    then finds the stacks folded and keeps them. With a `mesh`
    (``parallel/mesh.py``) the leaves are placed onto their shards, and
    nothing is folded (the mesh computes the shared experts densely); a
    checkpoint that does not go through the cache is loaded onto the mesh's
    first device and sharded from there."""
    dev = mesh.home(0) if mesh is not None else resolve_device(device)
    fold = quant.fold_shared_decode and cfg.n_shared_experts > 0 and mesh is None
    if use_cache and dtype == torch.bfloat16:
        return place_params(cached_tree(cfg, quant, dev), cfg, dev, fold=fold, mesh=mesh)
    params = WeightLoader(cfg, quant, dtype=dtype, device=dev).load(fold=fold)
    return params if mesh is None else shard_params(params, cfg, mesh)


def load_params_offload(cfg: ModelConfig, quant: QuantConfig, dtype=torch.bfloat16,
                        use_cache: bool = True, device=None, threads: int = 0):
    """Load for the host-RAM expert offload tier: (device params without the
    routed experts, ``offload.HostExpertStore`` holding them). Through the
    weight cache (bf16 and `use_cache`), the store points into the cache's
    mmap'd stacks in place: the page cache is the store, no second copy in
    RAM, and the streamed prefill stages those pageable pages through
    pinned buffers; the rest of the cache's tree is placed as
    ``load_params`` places it. Otherwise the checkpoint is loaded onto
    `device` with each routed expert quantized there and copied into host
    stacks (pinned when `device` is the card). An MTP module's experts go
    into the store at index num_hidden_layers. The shared experts are not
    folded. `threads` is the host engine's thread count (0: every core)."""
    from ..offload import EXPERT_LEAVES, HostExpertStore, expert_leaves, without_experts

    dev = resolve_device(device)
    E = cfg.n_routed_experts
    if not (use_cache and dtype == torch.bfloat16):
        pin = dev.type == "cuda"
        store = HostExpertStore(cfg, quant, pin=pin, threads=threads)
        stacks: Dict[Any, QTensor] = {}

        def sink_for(i):
            def sink(e, w13_e, w2_e):
                for name, w in (("w13", w13_e), ("w2", w2_e)):
                    qt = quantize(w, quant.expert_bits, quant.group_size)
                    if (i, name) not in stacks:
                        stacks[i, name] = QTensor(*(
                            torch.empty((E, *a.shape), dtype=a.dtype, pin_memory=pin)
                            for a in (qt.q, qt.scales)), qt.bits, qt.group_size)
                    stacks[i, name].q[e].copy_(qt.q)
                    stacks[i, name].scales[e].copy_(qt.scales)
            return sink

        params = WeightLoader(cfg, quant, dtype=dtype, device=dev).load(expert_sink=sink_for)
        layers = params["layers"] + ([params["mtp"]["layer"]] if "mtp" in params else [])
        for i, lp in enumerate(layers):
            if (i, "w13") in stacks:
                store.add_layer(i, *expert_leaves({**lp, "w13": stacks[i, "w13"],
                                                   "w2": stacks[i, "w2"]}, E))
        params["layers"] = [without_experts(lp) for lp in params["layers"]]
        if "mtp" in params:
            params["mtp"]["layer"] = without_experts(params["mtp"]["layer"])
        return params, store

    tree = cached_tree(cfg, quant, dev)
    store = HostExpertStore(cfg, quant, threads=threads)
    info = pattern_info(cfg)
    for i, lp in enumerate(tree["prefix_layers"]):
        if "w13" in lp:
            store.add_layer(i, *expert_leaves(lp, E))
    for t, lp in enumerate(tree["pattern"]):
        if "w13" in lp:
            for r in range(info.reps):
                rep = {k: v[r] for k, v in lp.items() if k in EXPERT_LEAVES}
                store.add_layer(pattern_layer_index(info, t, r), *expert_leaves(rep, E))
    tree = {**tree, "prefix_layers": [without_experts(lp) for lp in tree["prefix_layers"]],
            "pattern": [without_experts(lp) for lp in tree["pattern"]]}
    mtp = tree.get("mtp", {}).get("layer", {})
    if "w13" in mtp:
        store.add_layer(cfg.num_hidden_layers, *expert_leaves(mtp, E))
        tree["mtp"] = {**tree["mtp"], "layer": without_experts(mtp)}
    return place_params(tree, cfg, dev), store
