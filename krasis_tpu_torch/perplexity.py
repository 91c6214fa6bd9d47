"""Perplexity through the serving forward path, on token ids.

The protocol of ``krasis_tpu/perplexity.py``: sliding window 2048, stride
1024, NLL of the last ``stride`` tokens of each window, every window run
through ``Engine.forward_all_logits``, the same forward that serves
requests, so quantization, cache handling and kernels are all in the
measurement. ``main`` scores a checkpoint (``load_params`` → ``Engine`` →
the port's ``Tokenizer``) on a local text file or on a dataset's cached text
(``load_dataset_text``, which reads the file the reference caches and, with
no network, never downloads).

    python -m krasis_tpu_torch.perplexity --model DIR --text FILE [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
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


def load_dataset_text(name: str, split: str = "test") -> str:
    """A dataset's text (WikiText-2 / -103, C4) from its cache file,
    ``$KRASIS_TPU_HOME/datasets/<name>.<split>.txt``, the file the reference
    reads first. The reference downloads a missing one through ``datasets``;
    the port raises instead."""
    home = os.environ.get("KRASIS_TPU_HOME", os.path.expanduser("~/.krasis_tpu"))
    cache = os.path.join(home, "datasets", f"{name}.{split}.txt")
    if not os.path.exists(cache):
        raise RuntimeError(
            f"no cached text for dataset {name!r} split {split!r} at {cache}: the "
            "`datasets` download is not available here; write the text there or pass --text")
    with open(cache) as f:
        return f.read()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m krasis_tpu_torch.perplexity")
    ap.add_argument("--model", required=True)
    ap.add_argument("--dataset", default="wikitext-2")
    ap.add_argument("--text", help="score a local text file instead")
    ap.add_argument("--window", type=int, default=2048)
    ap.add_argument("--stride", type=int, default=1024)
    ap.add_argument("--max-tokens", type=int, default=300_000)
    ap.add_argument("--expert-bits", type=int, default=4)
    ap.add_argument("--out", help="results JSON path")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="the card (default) or, when asked, the CPU")
    args = ap.parse_args(argv)

    from .config import ModelConfig, QuantConfig
    from .models.loader import load_params
    from .runtime.engine import Engine
    from .runtime.tokenizer import Tokenizer

    cfg = ModelConfig.from_model_path(args.model)
    quant = QuantConfig(expert_bits=args.expert_bits)
    params = load_params(cfg, quant, device=args.device)
    engine = Engine(cfg, quant, params, max_len=args.window, device=args.device)
    tok = Tokenizer(args.model)

    if args.text:
        with open(args.text) as f:
            text = f.read()
    else:
        text = load_dataset_text(args.dataset)
    res = evaluate_perplexity(engine, tok.encode(text), window=args.window,
                              stride=args.stride, max_tokens=args.max_tokens)
    res.update({"model": args.model, "dataset": args.dataset,
                "expert_bits": args.expert_bits,
                "window": args.window, "stride": args.stride})
    print(json.dumps(res, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
