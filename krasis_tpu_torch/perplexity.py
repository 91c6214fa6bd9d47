"""Perplexity through the serving forward path, on token ids.

The protocol of ``krasis_tpu/perplexity.py``: sliding window 2048, stride
1024, NLL of the last ``stride`` tokens of each window, every window run
through ``Engine.forward_all_logits``, the same forward that serves
requests, so quantization, cache handling and kernels are all in the
measurement. The reference's ``load_dataset_text`` and ``main`` (dataset
files, tokenizer, checkpoint) wait for the loader and the tokenizer to be
ported; callers pass token ids.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

import torch


def sliding_windows(n_tokens: int, window: int, stride: int):
    """Yield (start, end, shifted score_start) per window: starts every
    `stride` tokens up to n_tokens - 1; the first window scores every
    shifted position, later windows the shifted positions >= stride - 1
    (original positions >= start + stride). A window shorter than 2 tokens
    ends the walk; a trailing window that is all overlap scores nothing."""
    for pos in range(0, max(n_tokens - 1, 1), stride):
        end = min(pos + window, n_tokens)
        if end - pos < 2:
            break
        yield pos, end, (0 if pos == 0 else stride - 1)


def evaluate_perplexity(engine, token_ids: List[int], window: int = 2048,
                        stride: int = 1024, max_tokens: Optional[int] = None,
                        log_every: int = 10) -> dict:
    if max_tokens:
        token_ids = token_ids[:max_tokens]
    n = len(token_ids)
    total_nll = 0.0
    total_scored = 0
    t0 = time.time()
    window_nlls = []          # per window (nll sum, tokens scored)

    for start, end, score_start in sliding_windows(n, window, stride):
        ids = token_ids[start:end]
        logits = engine.forward_all_logits(ids)               # [S, V] f32
        # NLL of token t+1 given the logits at t, scored from score_start
        tgt = torch.tensor(ids[1:], dtype=torch.int64, device=logits.device)
        lg = logits[:-1].to(torch.float32)
        nll = torch.logsumexp(lg, dim=-1) - lg.gather(1, tgt[:, None])[:, 0]
        scored = nll[score_start:]
        nll_sum = float(scored.to(torch.float64).sum())       # the window's one readback
        total_nll += nll_sum
        total_scored += scored.shape[0]
        window_nlls.append((nll_sum, int(scored.shape[0])))
        if log_every and len(window_nlls) % log_every == 0:
            ppl = math.exp(total_nll / total_scored)
            print(f"[ppl] window {len(window_nlls)}: tokens={total_scored} ppl={ppl:.4f}")

    return {
        "ppl": math.exp(total_nll / total_scored),
        "bits_per_token": total_nll / total_scored / math.log(2),
        "tokens_scored": total_scored,
        "windows": len(window_nlls),
        "window_nlls": window_nlls,
        "elapsed_s": time.time() - t0,
    }
