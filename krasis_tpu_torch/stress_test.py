"""Generation stress battery, the port of ``krasis_tpu/stress_test.py``:
diverse prompts + sampling modes + edge cases, each validated for
degenerate or contract-violating output.

It covers (a) structurally diverse prompts (short/long/code/repetition
bait/multilingual/unicode/control-chars/deep nesting), (b) a sampling-mode
sweep incl. greedy determinism (two greedy runs must be identical) and
presence penalty, (c) contract edges: stop-token truncation, near-max_len
prompts, long generations, finite non-positive logprobs, (d) optionally
continuous-batching churn (mixed sampling across slots + a mid-stream
cancel). It runs against an Engine directly (synthetic or a checkpoint).

One departure: each prompt's sampling seed is ``zlib.crc32`` of its name,
where the reference takes Python's ``hash``, which changes from process to
process, so that a battery's sampled prompts repeat from run to run.

    python -m krasis_tpu_torch.stress_test --synthetic tiny --device cpu --slots 4
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import zlib
from typing import Dict, List

PROMPT_KINDS = {
    "short": "Hi",
    "question": "What are the three primary colors? Answer briefly.",
    "code": "Write a Python function that reverses a string.",
    "long_context": "The quick brown fox jumps over the lazy dog. " * 200
    + "\nSummarize the above text in one sentence.",
    "repetition_bait": "Repeat the word 'test' exactly three times.",
    "multilingual": "Translate 'good morning' into French, German and Japanese.",
    "numeric": "Count from 1 to 10, separated by commas.",
    "unicode": "Explain this: éèê 中文 \U0001f600 "
               "مرحبا ßøå",
    "control_chars": "Echo safely: a\tb\r\nc\x0bd  e",
    "deep_nesting": "Evaluate: " + "(" * 40 + "1+1" + ")" * 40,
    "json_shape": 'Return JSON: {"name": "x", "tags": ["a", "b"], '
                  '"nested": {"k": [1, 2, {"deep": true}]}}',
    "one_giant_word": "Define " + "antidisestablishmentarian" * 30,
    "whitespace_bait": "   \n\n  \t  What comes after Tuesday?",
}


def prompt_seed(name: str) -> int:
    """A prompt's sampling seed: stable across processes."""
    return zlib.crc32(name.encode()) % (2**31)


def validate_tokens(tokens: List[int], max_run: int = 12) -> Dict:
    """Degenerate-output checks: long single-token runs, tiny vocab usage."""
    issues = []
    if not tokens:
        issues.append("empty")
    run, best = 1, 1
    for a, b in zip(tokens, tokens[1:]):
        run = run + 1 if a == b else 1
        best = max(best, run)
    if best >= max_run:
        issues.append(f"token_run_{best}")
    if len(tokens) >= 32 and len(set(tokens)) <= max(2, len(tokens) // 16):
        issues.append("low_diversity")
    return {"ok": not issues, "issues": issues, "n": len(tokens)}


def _encode(engine, tokenizer, prompt: str, reserve: int = 72) -> List[int]:
    """Tokenize, capped so `reserve` generation room always remains within
    the engine's max_len (the battery must stress content, not trip the
    prompt-too-long guard)."""
    cap = max(8, engine.max_len - engine.decode_block - reserve)
    if tokenizer is not None:
        ids = tokenizer.apply_chat_template([{"role": "user", "content": prompt}])
        return ids[:cap]
    vocab = engine.cfg.vocab_size
    return [(7 + 31 * ord(c)) % (vocab - 2) + 1 for c in prompt[:min(1024, cap)]]


def run_stress(engine, tokenizer=None, max_new_tokens: int = 64) -> Dict:
    """Prompt battery (sampled decoding) — the core battery."""
    from .ops.sampling import SamplingParams

    results = {}
    for name, prompt in PROMPT_KINDS.items():
        ids = _encode(engine, tokenizer, prompt)
        res = engine.generate(
            ids, max_new_tokens=max_new_tokens,
            sampling=SamplingParams(temperature=0.6, top_k=20, top_p=0.95),
            seed=prompt_seed(name),
        )
        v = validate_tokens(res.tokens)
        v["decode_tok_s"] = round(res.decode_tok_s, 2)
        results[name] = v
    results["_summary"] = {
        "passed": sum(1 for k, v in results.items() if not k.startswith("_") and v["ok"]),
        "total": len(PROMPT_KINDS),
    }
    return results


SWEEP_MODES = {
    "greedy": dict(temperature=0.0),
    "top_k_1": dict(temperature=1.0, top_k=1),
    "high_temp": dict(temperature=1.4, top_k=50, top_p=0.99),
    "nucleus": dict(temperature=0.8, top_p=0.9),
    "presence": dict(temperature=0.7, top_k=40, presence_penalty=1.2),
}


def run_sampling_sweep(engine, tokenizer=None, n_tokens: int = 48) -> Dict:
    """Every sampling mode produces valid output; greedy is bit-
    deterministic across runs; presence penalty suppresses repeats."""
    from .ops.sampling import SamplingParams

    ids = _encode(engine, tokenizer, PROMPT_KINDS["question"])
    modes = {name: SamplingParams(**kw) for name, kw in SWEEP_MODES.items()}
    out: Dict = {}
    for name, sp in modes.items():
        res = engine.generate(ids, max_new_tokens=n_tokens, sampling=sp, seed=11,
                              stop_ids={-1})
        v = validate_tokens(res.tokens, max_run=20)
        lps = res.logprobs or []
        if any(not math.isfinite(lp) or lp > 1e-6 for lp in lps):
            v["ok"] = False
            v["issues"].append("bad_logprob")
        out[name] = v
    # greedy determinism (two fresh runs)
    a = engine.generate(ids, max_new_tokens=n_tokens, sampling=modes["greedy"],
                        stop_ids={-1}).tokens
    b = engine.generate(ids, max_new_tokens=n_tokens, sampling=modes["greedy"],
                        stop_ids={-1}).tokens
    out["greedy_deterministic"] = {"ok": a == b,
                                   "issues": [] if a == b else ["nondeterministic"]}
    # greedy == top_k=1 at temperature > 0 is not required (ties may resolve
    # differently); determinism of each mode with a fixed seed is
    c = engine.generate(ids, max_new_tokens=n_tokens, sampling=modes["high_temp"], seed=5,
                        stop_ids={-1}).tokens
    d = engine.generate(ids, max_new_tokens=n_tokens, sampling=modes["high_temp"], seed=5,
                        stop_ids={-1}).tokens
    out["seeded_sampling_deterministic"] = {
        "ok": c == d, "issues": [] if c == d else ["seed_nondeterministic"]}
    return out


def run_contract_edges(engine, tokenizer=None) -> Dict:
    """Stop-token truncation, near-max_len prompts, long generation."""
    from .ops.sampling import SamplingParams

    greedy = SamplingParams(temperature=0.0)
    ids = _encode(engine, tokenizer, PROMPT_KINDS["code"])
    out: Dict = {}

    # stop token: rerun greedy with the 6th emitted token as a stop id — the
    # stream must end at that token's first occurrence, and include it
    base = engine.generate(ids, max_new_tokens=24, sampling=greedy, stop_ids={-1}).tokens
    if len(base) >= 8:
        stop_tok = base[5]
        res = engine.generate(ids, max_new_tokens=24, sampling=greedy,
                              stop_ids={stop_tok}).tokens
        first = base.index(stop_tok)
        ok = res == base[: first + 1]
        out["stop_token"] = {"ok": ok, "issues": [] if ok else ["stop_ignored"]}

    # near-max_len prompt: must emit ≥ 1 token and never exceed the room
    n_room = max(8, engine.max_len - engine.decode_block - 4)
    room_prompt = [1 + (i % (engine.cfg.vocab_size - 2)) for i in range(n_room)]
    res = engine.generate(room_prompt, max_new_tokens=64, sampling=greedy,
                          stop_ids={-1}).tokens
    ok = 1 <= len(res) <= 64
    out["near_max_len"] = {"ok": ok, "n": len(res),
                           "issues": [] if ok else ["room_violation"]}

    # long generation stays non-degenerate
    res = engine.generate(ids, max_new_tokens=min(256, engine.max_len // 2),
                          sampling=SamplingParams(temperature=0.7, top_k=40),
                          seed=3, stop_ids={-1}).tokens
    out["long_generation"] = validate_tokens(res, max_run=24)
    return out


def run_scheduler_churn(cfg, quant, params, num_slots: int = 4,
                        n_requests: int = 8) -> Dict:
    """Continuous-batching churn: mixed sampling across slots, one
    mid-stream cancel, all streams must terminate and validate. The
    scheduler runs on the device the parameters live on."""
    from .ops.sampling import SamplingParams
    from .runtime.scheduler import BatchScheduler

    sched = BatchScheduler(cfg, quant, params, max_len=512, num_slots=num_slots,
                           decode_block=4, device=params["embed"].device)
    out: Dict = {}
    try:
        reqs = []
        for i in range(n_requests):
            sp = (SamplingParams(temperature=0.0) if i % 2 == 0
                  else SamplingParams(temperature=0.9, top_k=30, top_p=0.95))
            reqs.append(sched.submit([5 + i, 9 + i, 13 + i, 2 + i], max_new_tokens=32,
                                     sampling=sp, stop_ids={-1}))
        reqs[1].cancelled.set()
        for i, r in enumerate(reqs):
            toks = []
            while True:
                t = r.out_queue.get(timeout=900)
                if t is None:
                    break
                toks.append(t)
            v = validate_tokens(toks, max_run=20) if i != 1 else {
                "ok": len(toks) < 32, "issues": [], "n": len(toks)}
            if r.error is not None:
                v["ok"] = False
                v["issues"].append(f"error: {r.error!r}")
            out[f"req{i}" + ("_cancelled" if i == 1 else "")] = v
    finally:
        sched.shutdown()
    return out


def run_all(engine, tokenizer=None, max_new_tokens: int = 64, scheduler_cfg=None) -> Dict:
    report = {
        "prompts": run_stress(engine, tokenizer, max_new_tokens),
        "sampling": run_sampling_sweep(engine, tokenizer),
        "contracts": run_contract_edges(engine, tokenizer),
    }
    if scheduler_cfg is not None:
        cfg, quant, params = scheduler_cfg
        report["scheduler"] = run_scheduler_churn(cfg, quant, params)
    flat = []
    for section, cases in report.items():
        for name, v in cases.items():
            if isinstance(v, dict) and "ok" in v:
                flat.append((f"{section}.{name}", v["ok"]))
    report["_summary"] = {
        "passed": sum(ok for _, ok in flat),
        "total": len(flat),
        "failed": [n for n, ok in flat if not ok],
    }
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m krasis_tpu_torch.stress_test")
    ap.add_argument("--model")
    ap.add_argument("--synthetic", default="tiny")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="the card (default) or, when asked, the CPU")
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--slots", type=int, default=0,
                    help="also churn the batching scheduler at N slots")
    args = ap.parse_args(argv)

    from .config import ModelConfig, QuantConfig
    from .device import resolve_device

    dev = resolve_device(args.device)
    if args.model:
        from .models.loader import load_params
        from .runtime.engine import Engine
        from .runtime.tokenizer import Tokenizer

        cfg = ModelConfig.from_model_path(args.model)
        quant = QuantConfig()
        engine = Engine(cfg, quant, load_params(cfg, quant, device=dev), device=dev)
        tok = Tokenizer(args.model)
    else:
        from .config import preset_config
        from .models.synthetic import build_synthetic_engine, tiny_config

        if args.synthetic == "tiny":
            cfg = tiny_config("qwen3-moe")
            quant = QuantConfig(expert_bits=4, group_size=32)
        else:
            cfg, quant = preset_config(args.synthetic), QuantConfig()
        engine = build_synthetic_engine(cfg, quant, device=dev)
        tok = None

    sched_cfg = (cfg, quant, engine.params) if args.slots > 0 else None
    report = run_all(engine, tok, args.max_new_tokens, scheduler_cfg=sched_cfg)
    print(json.dumps(report, indent=2))
    return 1 if report["_summary"]["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
