"""Auto-tuner for runtime strategy knobs, the port of ``krasis_tpu/auto_optimise.py``.

It tunes ``decode_block``, the tokens a decode loop runs between host
synchronisations (latency amortization against streaming granularity):
each block is measured over 2 × block tokens, after a warm run at that
block, and the median of `runs` is kept.

Results persist to ``$KRASIS_TPU_HOME/auto_torch/<tag>.json`` and are
picked up by ``apply_tuning(engine)``. The reference's results live in
``auto/`` beside it and are never read here: a block tuned on another
device does not carry over.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

STORE_DIR = "auto_torch"


def _store_path(tag: str) -> str:
    d = os.path.join(
        os.environ.get("KRASIS_TPU_HOME", os.path.expanduser("~/.krasis_tpu")), STORE_DIR)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{tag}.json")


def _tag(engine) -> str:
    return f"{engine.cfg.model_type}-{engine.cfg.num_hidden_layers}"


def tune_engine(engine, tag: Optional[str] = None, blocks=(8, 16, 32, 64, 128),
                runs: int = 3, prompt_len: int = 1024) -> Dict:
    """Measure decode tok/s for each block size; persist and apply the
    winner. A partial final block pays a whole block's time for fewer
    emitted tokens and understates the rate, so each block runs 2 × block
    tokens; a warm run at the exact configuration comes first, and the
    median of `runs` repeats is recorded."""
    from .ops.sampling import SamplingParams

    tag = tag or _tag(engine)
    greedy = SamplingParams(temperature=0.0)
    rng = np.random.default_rng(0)
    prompt = rng.integers(100, engine.cfg.vocab_size - 100, size=prompt_len).tolist()

    results: Dict[str, Dict] = {"decode_blocks": {}}
    best_block, best_rate = engine.decode_block, 0.0
    for block in blocks:
        n_tok = 2 * block
        if prompt_len + n_tok + block + 8 > engine.max_len:
            continue
        engine.decode_block = block
        engine.generate(prompt, max_new_tokens=n_tok, sampling=greedy, stop_ids={-1})
        rates = []
        for _ in range(max(1, runs)):
            r = engine.generate(prompt, max_new_tokens=n_tok, sampling=greedy, stop_ids={-1})
            rates.append(r.decode_tok_s)
        rate = float(np.median(rates))
        results["decode_blocks"][str(block)] = round(rate, 2)
        if rate > best_rate:
            best_rate, best_block = rate, block

    engine.decode_block = best_block
    results["best_decode_block"] = best_block
    results["best_decode_tok_s"] = round(best_rate, 2)
    results["tuned_at"] = time.strftime("%Y-%m-%d %H:%M:%S")
    with open(_store_path(tag), "w") as f:
        json.dump(results, f, indent=2)
    return results


def apply_tuning(engine, tag: Optional[str] = None) -> bool:
    """Load a previous tuning result onto an engine (True if found)."""
    path = _store_path(tag or _tag(engine))
    if not os.path.exists(path):
        return False
    try:
        with open(path) as f:
            res = json.load(f)
        engine.decode_block = int(res.get("best_decode_block", engine.decode_block))
        return True
    except (OSError, ValueError):
        return False
