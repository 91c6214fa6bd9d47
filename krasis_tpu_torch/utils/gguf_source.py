"""A GGUF checkpoint under HF tensor names (PyTorch).

The port of ``krasis_tpu/utils/gguf_source.py``: ``GgufCheckpoint`` serves
a GGUF file through the ``ShardedSafetensors`` interface the loader reads
(llama.cpp names mapped to the HF schema, fused [E, N, K] expert tensors
served per expert), each tensor dequantized to f32 on the loader's device;
the loader then quantizes it as any other checkpoint tensor.
``to_config_dict`` rebuilds an HF config dict from the metadata
(``<arch>.block_count`` and the like) for files without ``config.json``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import torch

from .gguf import GgufFile

# llama.cpp → HF names, layer-scoped
_LAYER_MAP = {
    "attn_norm.weight": "input_layernorm.weight",
    "ffn_norm.weight": "post_attention_layernorm.weight",
    "attn_q.weight": "self_attn.q_proj.weight",
    "attn_k.weight": "self_attn.k_proj.weight",
    "attn_v.weight": "self_attn.v_proj.weight",
    "attn_output.weight": "self_attn.o_proj.weight",
    "attn_q.bias": "self_attn.q_proj.bias",
    "attn_k.bias": "self_attn.k_proj.bias",
    "attn_v.bias": "self_attn.v_proj.bias",
    "attn_q_norm.weight": "self_attn.q_norm.weight",
    "attn_k_norm.weight": "self_attn.k_norm.weight",
    # MLA (deepseek2)
    "attn_q_a.weight": "self_attn.q_a_proj.weight",
    "attn_q_a_norm.weight": "self_attn.q_a_layernorm.weight",
    "attn_q_b.weight": "self_attn.q_b_proj.weight",
    "attn_kv_a_mqa.weight": "self_attn.kv_a_proj_with_mqa.weight",
    "attn_kv_a_norm.weight": "self_attn.kv_a_layernorm.weight",
    "attn_kv_b.weight": "self_attn.kv_b_proj.weight",
    # dense MLP
    "ffn_gate.weight": "mlp.gate_proj.weight",
    "ffn_up.weight": "mlp.up_proj.weight",
    "ffn_down.weight": "mlp.down_proj.weight",
    # router and shared expert
    "ffn_gate_inp.weight": "mlp.gate.weight",
    "exp_probs_b.bias": "mlp.gate.e_score_correction_bias",
    "ffn_gate_shexp.weight": "mlp.shared_experts.gate_proj.weight",
    "ffn_up_shexp.weight": "mlp.shared_experts.up_proj.weight",
    "ffn_down_shexp.weight": "mlp.shared_experts.down_proj.weight",
}

_TOP_MAP = {
    "token_embd.weight": "model.embed_tokens.weight",
    "output_norm.weight": "model.norm.weight",
    "output.weight": "lm_head.weight",
}

_EXPERT_FUSED = {
    "ffn_gate_exps.weight": "gate_proj",
    "ffn_up_exps.weight": "up_proj",
    "ffn_down_exps.weight": "down_proj",
}


class GgufCheckpoint:
    """A GGUF file (or the first .gguf of a directory) with HF tensor
    names, decoded on `device`."""

    def __init__(self, path: str, device="cpu"):
        if os.path.isdir(path):
            ggufs = sorted(f for f in os.listdir(path) if f.endswith(".gguf"))
            if not ggufs:
                raise FileNotFoundError(f"no .gguf in {path}")
            path = os.path.join(path, ggufs[0])
        self.gguf = GgufFile(path)
        self.device = torch.device(device)
        self._names: Dict[str, Tuple[str, Optional[int]]] = {}
        self._cache_name: Optional[str] = None
        self._cache_val: Optional[torch.Tensor] = None
        for gname in self.gguf.tensors:
            if gname in _TOP_MAP:
                self._names[_TOP_MAP[gname]] = (gname, None)
                continue
            m = re.match(r"blk\.(\d+)\.(.+)$", gname)
            if not m:
                continue
            i, rest = int(m.group(1)), m.group(2)
            if rest in _LAYER_MAP:
                self._names[f"model.layers.{i}.{_LAYER_MAP[rest]}"] = (gname, None)
            elif rest in _EXPERT_FUSED:
                proj = _EXPERT_FUSED[rest]
                for e in range(self.gguf.shape(gname)[0]):   # fused [E, N, K]
                    self._names[f"model.layers.{i}.mlp.experts.{e}.{proj}.weight"] = (gname, e)

    def keys(self) -> List[str]:
        return list(self._names)

    def __contains__(self, name: str) -> bool:
        return name in self._names

    def shape(self, name: str) -> Tuple[int, ...]:
        gname, expert = self._names[name]
        s = self.gguf.shape(gname)
        return tuple(s[1:]) if expert is not None else tuple(s)

    def tensor(self, name: str) -> torch.Tensor:
        """f32 on the device; the last fused expert tensor decoded is kept,
        since the loader reads its experts in a row."""
        gname, expert = self._names[name]
        if self._cache_name != gname:
            self._cache_name = gname
            self._cache_val = self.gguf.dequantize(gname, self.device)
        return self._cache_val[expert] if expert is not None else self._cache_val

    def close(self):
        self._cache_val = None
        self.gguf.close()

    def to_config_dict(self) -> Dict:
        """An HF-style config dict from the GGUF metadata."""
        md = self.gguf.metadata
        arch = md.get("general.architecture", "llama")

        def g(key, default=None):
            return md.get(f"{arch}.{key}", default)

        cfg: Dict = {
            "model_type": {"qwen3moe": "qwen3_moe", "deepseek2": "deepseek_v2"}.get(arch, arch),
            "hidden_size": g("embedding_length"),
            "num_hidden_layers": g("block_count"),
            "num_attention_heads": g("attention.head_count"),
            "num_key_value_heads": g("attention.head_count_kv", g("attention.head_count")),
            "intermediate_size": g("feed_forward_length"),
            "rms_norm_eps": g("attention.layer_norm_rms_epsilon", 1e-6),
            "rope_theta": g("rope.freq_base", 10000.0),
            "vocab_size": g("vocab_size") or len(md.get("tokenizer.ggml.tokens", []) or []),
            "max_position_embeddings": g("context_length", 131072),
        }
        if g("expert_count"):
            cfg["n_routed_experts"] = g("expert_count")
            cfg["num_experts_per_tok"] = g("expert_used_count")
            cfg["moe_intermediate_size"] = g("expert_feed_forward_length")
            if g("expert_shared_count"):
                cfg["n_shared_experts"] = g("expert_shared_count")
            if g("expert_shared_feed_forward_length"):
                cfg["shared_expert_intermediate_size"] = g("expert_shared_feed_forward_length")
        for gk, ck in (("attention.key_length", "head_dim"),
                       ("attention.q_lora_rank", "q_lora_rank"),
                       ("attention.kv_lora_rank", "kv_lora_rank"),
                       ("leading_dense_block_count", "first_k_dense_replace"),
                       ("expert_weights_scale", "routed_scaling_factor")):
            if g(gk) is not None:
                cfg[ck] = g(gk)
        if g("attention.kv_lora_rank"):
            # MLA: key_length is the whole qk head (nope + rope), and
            # rope.dimension_count its rope slice (llama.cpp's deepseek2)
            rope_dim, key_len = g("rope.dimension_count"), g("attention.key_length")
            if rope_dim is not None:
                cfg["qk_rope_head_dim"] = rope_dim
                if key_len is not None:
                    cfg["qk_nope_head_dim"] = key_len - rope_dim
            if g("attention.value_length") is not None:
                cfg["v_head_dim"] = g("attention.value_length")
            cfg.pop("head_dim", None)
        # expert_gating_func 2 is sigmoid; 1 or absent, softmax
        if g("expert_gating_func") is not None:
            cfg["scoring_func"] = "sigmoid" if int(g("expert_gating_func")) == 2 else "softmax"
        if g("expert_weights_norm") is not None:
            cfg["norm_topk_prob"] = bool(g("expert_weights_norm"))
        # llama.cpp leaves a tied lm_head out of the file
        cfg["tie_word_embeddings"] = "output.weight" not in self.gguf.tensors
        return {k: v for k, v in cfg.items() if v is not None}
