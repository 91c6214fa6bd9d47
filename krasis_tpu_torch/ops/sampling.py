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


def sample_batched(logits: torch.Tensor, temperature: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-row temperature; rows with temperature 0 are greedy."""
    greedy = torch.argmax(logits, dim=-1)
    t = torch.clamp(temperature, min=1e-6)[:, None]
    probs = torch.softmax(logits.to(torch.float32) / t, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled)
