"""A trainable Qwen3-MoE in plain PyTorch, for the quality checkpoint.

It stands in for ``transformers``' ``Qwen3MoeForCausalLM`` in training only
(the card's machine has no ``transformers``): ``nn.Module``s under HF's
parameter names, so ``state_dict()`` is a checkpoint in HF's layout
(``model.layers.{i}.self_attn.{q,k,v,o}_proj``, ``q_norm`` / ``k_norm``,
``mlp.gate``, ``mlp.experts.{e}.{gate,up,down}_proj``), HF's RMSNorm, rotary
embedding and initialisation (normal at ``initializer_range``, norms at 1),
a softmax top-k router with HF's ``norm_topk_prob``, and the causal-LM loss
plus HF's load-balancing loss at ``router_aux_loss_coef``. ``MTPHead`` is
the DeepSeek-V3 next-next-token module over one more such decoder layer.
Serving never runs this module: checkpoints go through ``models/loader.py``.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass
class Qwen3MoeTrainConfig:
    """The fields of HF's ``Qwen3MoeConfig`` that this model reads, with its
    defaults; ``config_json`` writes them as ``save_pretrained`` does."""
    vocab_size: int = 2048
    hidden_size: int = 256
    intermediate_size: int = 512
    moe_intermediate_size: int = 128
    num_hidden_layers: int = 4
    num_attention_heads: int = 4
    num_key_value_heads: int = 2
    head_dim: int = 64
    num_experts: int = 8
    num_experts_per_tok: int = 2
    decoder_sparse_step: int = 1
    max_position_embeddings: int = 4096
    eos_token_id: int = 0
    norm_topk_prob: bool = False
    router_aux_loss_coef: float = 0.01
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    mlp_only_layers: List[int] = field(default_factory=list)

    def config_json(self, **extra) -> Dict:
        out = {"architectures": ["Qwen3MoeForCausalLM"], "attention_bias": False,
               "attention_dropout": 0.0, "dtype": "float32", "hidden_act": "silu",
               "model_type": "qwen3_moe", "output_router_logits": False,
               "rope_scaling": None, "sliding_window": None, "tie_word_embeddings": False,
               "use_cache": True, "use_sliding_window": False}
        out.update(asdict(self))
        out.update(extra)
        return dict(sorted(out.items()))


class RMSNorm(nn.Module):
    def __init__(self, n: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = x.to(torch.float32)
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * x.to(dt)


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float, dtype: torch.dtype):
    """HF's default rotary embedding: cos, sin [..., S, dim]."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.int64, device=positions.device)
                          .to(torch.float32) / dim))
    freqs = positions.to(torch.float32)[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


class Attention(nn.Module):
    def __init__(self, c: Qwen3MoeTrainConfig):
        super().__init__()
        self.c = c
        hd = c.head_dim
        self.q_proj = nn.Linear(c.hidden_size, c.num_attention_heads * hd, bias=False)
        self.k_proj = nn.Linear(c.hidden_size, c.num_key_value_heads * hd, bias=False)
        self.v_proj = nn.Linear(c.hidden_size, c.num_key_value_heads * hd, bias=False)
        self.o_proj = nn.Linear(c.num_attention_heads * hd, c.hidden_size, bias=False)
        self.q_norm = RMSNorm(hd, c.rms_norm_eps)
        self.k_norm = RMSNorm(hd, c.rms_norm_eps)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        c, hd = self.c, self.c.head_dim
        q = self.q_norm(self.q_proj(x).view(B, S, -1, hd)).transpose(1, 2)
        k = self.k_norm(self.k_proj(x).view(B, S, -1, hd)).transpose(1, 2)
        v = self.v_proj(x).view(B, S, -1, hd).transpose(1, 2)
        cos, sin = cos[:, None], sin[:, None]
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin
        rep = c.num_attention_heads // c.num_key_value_heads
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=hd ** -0.5)
        return self.o_proj(out.transpose(1, 2).reshape(B, S, -1))


class MLP(nn.Module):
    def __init__(self, hidden: int, inter: int):
        super().__init__()
        self.gate_proj = nn.Linear(hidden, inter, bias=False)
        self.up_proj = nn.Linear(hidden, inter, bias=False)
        self.down_proj = nn.Linear(inter, hidden, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class SparseMoe(nn.Module):
    """HF's ``Qwen3MoeSparseMoeBlock``: returns (out, router logits)."""

    def __init__(self, c: Qwen3MoeTrainConfig):
        super().__init__()
        self.c = c
        self.gate = nn.Linear(c.hidden_size, c.num_experts, bias=False)
        self.experts = nn.ModuleList(MLP(c.hidden_size, c.moe_intermediate_size)
                                     for _ in range(c.num_experts))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, S, H = x.shape
        x = x.reshape(-1, H)
        logits = self.gate(x)
        w = F.softmax(logits, dim=1, dtype=torch.float32)
        w, idx = torch.topk(w, self.c.num_experts_per_tok, dim=-1)
        if self.c.norm_topk_prob:
            w = w / w.sum(dim=-1, keepdim=True)
        w = w.to(x.dtype)
        out = torch.zeros_like(x)
        for e, expert in enumerate(self.experts):
            tok, pick = torch.where(idx == e)
            if tok.numel():
                out = out.index_add(0, tok, expert(x[tok]) * w[tok, pick, None])
        return out.reshape(B, S, H), logits


class DecoderLayer(nn.Module):
    def __init__(self, c: Qwen3MoeTrainConfig, layer_idx: int):
        super().__init__()
        self.self_attn = Attention(c)
        sparse = (layer_idx not in c.mlp_only_layers and c.num_experts > 0
                  and (layer_idx + 1) % c.decoder_sparse_step == 0)
        self.mlp = SparseMoe(c) if sparse else MLP(c.hidden_size, c.intermediate_size)
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        out = self.mlp(self.post_attention_layernorm(x))
        out, logits = out if isinstance(out, tuple) else (out, None)
        return x + out, logits


class Body(nn.Module):
    def __init__(self, c: Qwen3MoeTrainConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(c, i) for i in range(c.num_hidden_layers))
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps)


def init_weights(module: nn.Module, std: float, generator: torch.Generator) -> None:
    """HF's initialisation from `generator`: every Linear and Embedding
    weight normal(0, std) in module order, norms at 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                w.normal_(0.0, std, generator=generator)
                m.weight.copy_(w)
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)


class Qwen3MoeForTraining(nn.Module):
    def __init__(self, c: Qwen3MoeTrainConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = c
        self.model = Body(c)
        self.lm_head = nn.Linear(c.hidden_size, c.vocab_size, bias=False)
        if generator is not None:
            init_weights(self, c.initializer_range, generator)

    def hidden(self, ids: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(final-norm hidden [B, S, H], each MoE layer's router logits)."""
        c = self.config
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        x = self.model.embed_tokens(ids)
        cos, sin = rope_cos_sin(pos, c.head_dim, c.rope_theta, x.dtype)
        router = []
        for layer in self.model.layers:
            x, logits = layer(x, cos, sin)
            if logits is not None:
                router.append(logits)
        return self.model.norm(x), router

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """f32 logits [B, S, V]."""
        return self.lm_head(self.hidden(ids)[0]).float()

    def loss(self, ids: torch.Tensor) -> torch.Tensor:
        """HF's causal-LM loss with ``output_router_logits``: next-token
        cross entropy plus router_aux_loss_coef x the load-balancing loss."""
        h, router = self.hidden(ids)
        logits = self.lm_head(h).float()
        c = self.config
        ce = F.cross_entropy(logits[:, :-1].reshape(-1, c.vocab_size), ids[:, 1:].reshape(-1))
        if not router:
            return ce
        return ce + c.router_aux_loss_coef * load_balancing_loss(
            torch.cat(router), c.num_experts, c.num_experts_per_tok)


def load_balancing_loss(logits: torch.Tensor, num_experts: int, top_k: int) -> torch.Tensor:
    """HF's ``load_balancing_loss_func`` without an attention mask, over the
    router logits of every MoE layer concatenated [L·T, E]."""
    w = F.softmax(logits, dim=-1)
    _, sel = torch.topk(w, top_k, dim=-1)
    mask = F.one_hot(sel, num_experts)
    tokens_per_expert = mask.float().mean(dim=0)
    prob_per_expert = w.mean(dim=0)
    return (tokens_per_expert * prob_per_expert[None]).sum() * num_experts


class MTPHead(nn.Module):
    """The DeepSeek-V3 MTP module over a frozen base: position i's input is
    ``eh_proj([enorm(emb(t_{i+1})) ; hnorm(h_i)])``, one decoder layer (index
    num_hidden_layers), ``shared_head.norm`` and the base's lm_head."""

    def __init__(self, c: Qwen3MoeTrainConfig, generator: torch.Generator):
        super().__init__()
        H = c.hidden_size
        self.layer = DecoderLayer(c, c.num_hidden_layers)
        self.enorm = RMSNorm(H, c.rms_norm_eps)
        self.hnorm = RMSNorm(H, c.rms_norm_eps)
        self.head_norm = RMSNorm(H, c.rms_norm_eps)
        self.eh_proj = nn.Linear(2 * H, H, bias=False)
        init_weights(self, c.initializer_range, generator)

    def tensors(self, layer_idx: int) -> Dict[str, torch.Tensor]:
        """The module's tensors under the V3 names the loader reads."""
        P = f"model.layers.{layer_idx}"
        out = {f"{P}.enorm.weight": self.enorm.weight, f"{P}.hnorm.weight": self.hnorm.weight,
               f"{P}.eh_proj.weight": self.eh_proj.weight,
               f"{P}.shared_head.norm.weight": self.head_norm.weight}
        out.update({f"{P}.{k}": v for k, v in self.layer.state_dict().items()})
        return {k: v.detach().float().cpu().contiguous() for k, v in out.items()}


def mtp_loss(base: Qwen3MoeForTraining, head: MTPHead, x: torch.Tensor) -> torch.Tensor:
    """The t + 2 objective: position j (0 .. S - 2) fuses emb(t_{j+1}) with
    the base's h_j and predicts t_{j+2}; the last position has no target."""
    c = base.config
    with torch.no_grad():
        h, _ = base.hidden(x)
        emb = base.model.embed_tokens(x)
    inp = head.eh_proj(torch.cat([head.enorm(emb[:, 1:]), head.hnorm(h[:, :-1])], dim=-1))
    pos = torch.arange(inp.shape[1], device=x.device)[None]
    cos, sin = rope_cos_sin(pos, c.head_dim, c.rope_theta, inp.dtype)
    out, _ = head.layer(inp, cos, sin)
    logits = base.lm_head(head.head_norm(out))[:, :-1]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(), x[:, 2:].reshape(-1))


def cosine_warmup(steps: int):
    """The learning-rate factor at step s: linear warm-up over steps / 20,
    then a cosine to 0 at `steps` (the reference's LambdaLR)."""
    warmup = max(1, steps // 20)
    return lambda s: (min(1.0, (s + 1) / warmup)
                      * 0.5 * (1 + math.cos(math.pi * min(1.0, s / max(1, steps)))))


def sample_batch(ids: torch.Tensor, batch: int, seq: int,
                 generator: torch.Generator) -> torch.Tensor:
    """`batch` windows of `seq` ids at random starts drawn from `generator`."""
    starts = torch.randint(0, len(ids) - seq - 1, (batch,), generator=generator)
    return torch.stack([ids[s:s + seq] for s in starts.tolist()])


def state_dict_f32(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float().cpu().contiguous() for k, v in model.state_dict().items()}


def write_config(out_dir: str, c: Qwen3MoeTrainConfig, **extra) -> None:
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(c.config_json(**extra), f, indent=2)
