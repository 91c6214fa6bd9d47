"""Token sampling: greedy, or temperature / top-k / top-p / presence
penalty with an explicit ``torch.Generator``.

Greedy is exact (first maximum, as ``jnp.argmax``). Sampled tokens come
from PyTorch's generator, not JAX's, so only their distribution matches
the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SamplingParams(NamedTuple):
    temperature: float = 0.6
    top_k: int = 20
    top_p: float = 0.95
    presence_penalty: float = 0.0


def sample(logits: torch.Tensor, params: SamplingParams,
           generator: Optional[torch.Generator] = None,
           seen_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [B, V] → token ids [B] int64."""
    logits = logits.to(torch.float32)
    if params.presence_penalty != 0.0 and seen_mask is not None:
        logits = logits - params.presence_penalty * seen_mask.to(torch.float32)
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / params.temperature
    V = logits.shape[-1]
    k = min(params.top_k, V) if params.top_k > 0 else V
    vals, idx = torch.topk(logits, k, dim=-1)
    probs = torch.softmax(vals, dim=-1)
    if params.top_p < 1.0:
        keep = (torch.cumsum(probs, dim=-1) - probs) < params.top_p
        probs = torch.where(keep, probs, torch.zeros_like(probs))
    choice = torch.multinomial(probs, 1, generator=generator)
    return torch.gather(idx, -1, choice)[:, 0]


def sample_batched(logits: torch.Tensor, temperature: torch.Tensor, top_p: torch.Tensor,
                   presence_penalty: torch.Tensor, seen_mask: torch.Tensor,
                   top_k: Optional[torch.Tensor] = None, max_top_k: int = 64,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-row sampling parameters in one pass over the batch, with no host
    sync: logits [B, V]; temperature, top_p, presence_penalty [B]; seen_mask
    [B, V] bool; top_k [B] (<= 0: off) → token ids [B] int64. Per row: the
    presence penalty on seen tokens, greedy on the penalised logits, then
    the logits over max(t, 1e-6), truncation to the top min(max_top_k, V),
    the row's top_k as a rank mask, softmax, the nucleus (exclusive
    cumulative probability < top_p), and a draw from what is kept. Rows
    with temperature <= 0 are greedy."""
    logits = logits.to(torch.float32)
    logits = logits - presence_penalty[:, None].to(torch.float32) * seen_mask.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1)
    kk = min(max_top_k, logits.shape[-1])
    t = torch.clamp(temperature.to(torch.float32), min=1e-6)[:, None]
    vals, idx = torch.topk(logits / t, kk, dim=-1)
    if top_k is not None:
        ranks = torch.arange(kk, device=logits.device)[None, :]
        per_row = torch.where(top_k <= 0, kk, torch.clamp(top_k, max=kk))[:, None]
        vals = torch.where(ranks < per_row, vals, torch.full_like(vals, float("-inf")))
    probs = torch.softmax(vals, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p[:, None].to(torch.float32)
    probs = torch.where(keep, probs, torch.zeros_like(probs))
    choice = torch.multinomial(probs, 1, generator=generator)
    sampled = torch.gather(idx, -1, choice)[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled)
