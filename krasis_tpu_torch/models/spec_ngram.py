"""Prompt-lookup (n-gram) speculative decoding: drafts from the request's
own history, no extra weights, so it serves every family, the DeltaNet
hybrids included (their state is advanced by the committed prefix alone,
``model.la_spec_commit``). The port of ``krasis_tpu/models/spec_ngram.py``.

The verify step is MTP's (``models/mtp.py`` ``verify_and_sample``): greedy
output is the vanilla greedy output, sampled output follows the vanilla
distribution, and the drafts only set the acceptance. The history lives on
the device, [B, cache_len] int64, written by the verify block itself, so a
draft never costs a host round trip.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..config import ModelConfig, QuantConfig
from ..runtime.kv_cache import settle_dropped
from .mtp import verify_step


def ngram_draft(hist: torch.Tensor, hlen: torch.Tensor, k: int, n_max: int = 3) -> torch.Tensor:
    """k drafts [B, k] by prompt lookup. hist [B, L] token history, hlen [B]
    committed tokens (the last at hist[hlen - 1]). For n = n_max..1 the
    trailing n-gram is matched against every window wholly inside the
    committed history before it; the most recent match of the longest n
    wins and the k tokens after it are the draft. A row with no match
    drafts its last token k times."""
    B, L = hist.shape
    hlen = hlen.to(torch.int64)
    start = torch.full((B,), -1, dtype=torch.int64, device=hist.device)
    for n in range(n_max, 0, -1):
        if n > L:
            continue
        win = hist.unfold(1, n, 1)                                   # [B, L - n + 1, n]
        pos = torch.arange(win.shape[1], device=hist.device)
        # clamped into the history: a row past the end (its overshoot is
        # dropped) drafts from its last ids rather than fault
        gram_idx = torch.clamp(hlen[:, None] - n + torch.arange(n, device=hist.device),
                               0, L - 1)
        gram = torch.gather(hist, 1, gram_idx)                        # [B, n]
        m = (win == gram[:, None, :]).all(dim=-1)
        # a window strictly before the trailing gram, the gram wholly there
        m &= (pos[None] <= hlen[:, None] - n - 1) & (hlen[:, None] > n)
        p = torch.where(m, pos[None], torch.full_like(m, -1, dtype=torch.int64)).amax(dim=1)
        start = torch.where(start >= 0, start, torch.where(p >= 0, p + n, -1))
    last = torch.gather(hist, 1, torch.clamp(hlen - 1, 0, L - 1)[:, None])[:, 0]
    idx = torch.clamp(start[:, None] + torch.arange(k, device=hist.device), 0, L - 1)
    cont = torch.gather(hist, 1, idx)
    return torch.where((start >= 0)[:, None], cont, last[:, None])


def put_history(hist: torch.Tensor, pos: torch.Tensor, toks: torch.Tensor) -> None:
    """hist[b, pos[b, i]] = toks[b, i] in place, with the reference's drop
    semantics: positions at or past the history's end are dropped."""
    L = hist.shape[1]
    keep = pos < L
    at = pos.clamp(max=L - 1)
    rows = torch.arange(hist.shape[0], device=hist.device)[:, None].expand_as(at)
    new = torch.where(keep, toks.to(hist.dtype), hist[rows, at])
    hist[rows, at] = settle_dropped(new, at, keep, L - 1)


def ngram_decode_block(params: Dict[str, Any], tok: torch.Tensor, cache: Dict[str, Any],
                       hist: torch.Tensor, cfg: ModelConfig, quant: QuantConfig, steps: int,
                       k: int, generator: Optional[torch.Generator], seen: torch.Tensor,
                       temperature: torch.Tensor, top_p: torch.Tensor,
                       presence_penalty: torch.Tensor, top_k: torch.Tensor,
                       max_top_k: int = 64, n_max: int = 3):
    """`steps` prompt-lookup verify steps over every row of the cache (the
    reference's ``make_ngram_decode_fn``), each committing 1 to k + 1 tokens
    a row. tok [B] is each row's last committed token, at hist[length]; the
    drafts come from `hist` at the top of each step and the step's samples
    are written back after the committed length (stale ones past it are
    masked from matching and overwritten later). The cache and `hist` are
    updated in place. Returns (tokens [steps, B, k + 1], logprobs alike,
    committed [steps, B], whether every logit was finite, the next tok),
    left on the device."""
    B = tok.shape[0]
    offs = torch.arange(k + 1, device=tok.device)
    rows = torch.arange(B, device=tok.device)
    finite = torch.ones((), dtype=torch.bool, device=tok.device)
    out_t, out_lp, out_n = [], [], []
    for _ in range(steps):
        hlen = cache["length"].to(torch.int64) + 1          # committed, `tok` included
        drafts = ngram_draft(hist, hlen, k, n_max)
        ts, lps, ncommit, ok = verify_step(params, tok, drafts, cache, cfg, quant, generator,
                                           seen, temperature, top_p, presence_penalty, top_k,
                                           max_top_k)
        finite &= ok
        put_history(hist, hlen[:, None] + offs, ts)
        tok = ts[rows, (ncommit - 1).to(torch.int64)]
        out_t.append(ts)
        out_lp.append(lps)
        out_n.append(ncommit)
    return torch.stack(out_t), torch.stack(out_lp), torch.stack(out_n), finite, tok
