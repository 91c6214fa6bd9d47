"""The benchmark harness: the reference's measurement protocol on the port.

The port of ``krasis_tpu/benchmark.py``: a warm-up generate on a domain kept
apart, timed prefill at 20K / 35K / 50K ids, decode as 5 runs x 64 tokens
with median, IQR and flagged runs (``robust_stats``), optionally the same
through a temporary HTTP server on both transports (the engine-to-network
overhead) or continuous-batching throughput by slot count. Reports are JSON;
``--archive`` writes them under ``$KRASIS_TPU_HOME/reports``.

    python -m krasis_tpu_torch.benchmark --synthetic deepseek-v2-lite [--network]
    python -m krasis_tpu_torch.benchmark --synthetic deepseek-v2-lite --slots-bench 1 4 8 16
    python -m krasis_tpu_torch.benchmark --synthetic tiny --device cpu --prefill-lengths 256
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import threading
import time
from typing import Dict, List, Optional

import numpy as np

PREFILL_LENGTHS = (20_000, 35_000, 50_000)
DECODE_RUNS = 5
DECODE_TOKENS = 64


def robust_stats(xs: List[float]) -> Dict:
    """Median and IQR of a run series; runs outside median ± 1.5 IQR are
    listed in `flagged_runs` rather than averaged in."""
    a = np.asarray(xs, np.float64)
    med = float(np.median(a))
    q1, q3 = float(np.percentile(a, 25)), float(np.percentile(a, 75))
    iqr = q3 - q1
    lo, hi = med - 1.5 * iqr, med + 1.5 * iqr
    flagged = [i for i, v in enumerate(a) if not (lo <= v <= hi)]
    return {
        "median": round(med, 2),
        "iqr": round(iqr, 2),
        "runs": [round(float(v), 2) for v in a],
        "flagged_runs": flagged,
    }


def card_line() -> Optional[str]:
    """The card's name and power limit as nvidia-smi prints them, or None
    where nvidia-smi is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return (out.stdout.strip() or None) if out.returncode == 0 else None


def _system_info() -> Dict:
    import torch

    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "card": card_line() if cuda else None,
    }


def run_engine_benchmark(engine, prompt_ids: Optional[List[int]] = None,
                         prefill_lengths=PREFILL_LENGTHS, decode_runs: int = DECODE_RUNS,
                         decode_tokens: int = DECODE_TOKENS) -> Dict:
    """Engine-direct measurement (no network). The warm-up prompt comes from
    the ``warmup`` domain and each timed run from another real domain of the
    corpus (``prompts.py``)."""
    from . import prompts as corpus
    from .ops.sampling import SamplingParams

    greedy = SamplingParams(temperature=0.0)
    vocab = engine.cfg.vocab_size
    tokenizer = getattr(engine, "tokenizer", None)
    domains = list(corpus.DOMAINS)

    def make_prompt(n, domain):
        if prompt_ids and len(prompt_ids) >= n:
            return prompt_ids[:n]
        return corpus.prompt_ids(domain, n, vocab, tokenizer=tokenizer)

    # warm-up at the largest timed length, then every other timed length:
    # the first call at a shape builds the kernels' plans and grows the
    # allocator, which must not land inside a timed run
    warm_n = min(max([*prefill_lengths, 2048], default=2048),
                 engine.max_len - decode_tokens - 8)
    engine.generate(make_prompt(warm_n, corpus.WARMUP_DOMAIN),
                    max_new_tokens=decode_tokens, sampling=greedy, stop_ids={-1})
    for n in prefill_lengths:
        if n != warm_n and n + decode_tokens + 8 <= engine.max_len:
            engine.generate(make_prompt(n, corpus.WARMUP_DOMAIN), max_new_tokens=2,
                            sampling=greedy, stop_ids={-1})

    results: Dict = {"prefill": {}, "decode": {}}
    for i, n in enumerate(prefill_lengths):
        if n + decode_tokens + 8 > engine.max_len:
            continue
        dom = domains[i % len(domains)]
        res = engine.generate(make_prompt(n, dom), max_new_tokens=2, sampling=greedy,
                              stop_ids={-1})
        results["prefill"][str(n)] = {
            "tok_s": round(res.prefill_tok_s, 1),
            "ttft_s": round(res.prefill_s, 3),
            "domain": dom,
        }

    # a warm run at the timed decode context first
    n_ctx = min(2048, engine.max_len // 2)
    engine.generate(make_prompt(n_ctx, corpus.WARMUP_DOMAIN), max_new_tokens=decode_tokens,
                    sampling=greedy, stop_ids={-1})
    decode_rates = []
    for r in range(decode_runs):
        dom = domains[(r + len(prefill_lengths)) % len(domains)]
        res = engine.generate(make_prompt(n_ctx, dom), max_new_tokens=decode_tokens,
                              sampling=greedy, stop_ids={-1})
        decode_rates.append(res.decode_tok_s)
    stats = robust_stats(decode_rates)
    results["decode"] = {
        "tok_s_median": stats["median"],
        "tok_s_iqr": stats["iqr"],
        "tok_s_runs": stats["runs"],
        "flagged_runs": stats["flagged_runs"],
        "tok_s_mean": round(float(np.mean(decode_rates)), 2),
        "context": n_ctx,
        "tokens_per_run": decode_tokens,
    }
    results["best_prefill_tok_s"] = max(
        (v["tok_s"] for v in results["prefill"].values()), default=0.0)
    # the offload tier's host-to-card stream rate: one untimed prefill with
    # the streamer timing its first group's copy alone (that serialises it
    # against the pipeline, so the timed rows above run without it)
    streamer = getattr(engine, "streamer", None)
    if hasattr(engine, "last_stream_stats") and streamer is not None:
        streamer.measure_h2d = True
        try:
            engine.generate(make_prompt(min(512, n_ctx), corpus.WARMUP_DOMAIN),
                            max_new_tokens=2, sampling=greedy, stop_ids={-1})
        finally:
            streamer.measure_h2d = False
    stream = getattr(engine, "last_stream_stats", None)
    if stream:
        results["offload_stream"] = stream
    return results


def run_slots_benchmark(cfg, quant, params, slots_list=(1, 4, 8, 16), max_len: int = 2048,
                        prompt_len: int = 512, decode_tokens: int = 128,
                        decode_block: int = 32, device=None, offload=None) -> Dict:
    """Continuous-batching aggregate decode throughput by slot count: every
    slot decodes at once from a `prompt_len`-id prompt; the steady rate
    counts the tokens after the last stream's first token. `params` may be
    an Engine's: the scheduler's shared-expert fold keeps folded stacks."""
    from .ops.sampling import SamplingParams
    from .runtime.scheduler import BatchScheduler

    greedy = SamplingParams(temperature=0.0)
    rng = np.random.default_rng(0)
    results: Dict = {}
    for slots in slots_list:
        sched = BatchScheduler(cfg, quant, params, max_len=max_len, num_slots=slots,
                               decode_block=decode_block, device=device, offload=offload)
        prompts = [rng.integers(100, cfg.vocab_size - 100, size=prompt_len).tolist()
                   for _ in range(slots)]

        def run_one(out, idx):
            req = sched.submit(prompts[idx], max_new_tokens=decode_tokens, sampling=greedy,
                               stop_ids={-1})
            n, first = 0, None
            while True:
                t = req.out_queue.get(timeout=1800)
                if t is None:
                    break
                if first is None:
                    first = time.time()
                n += 1
            if req.error is not None:
                raise RuntimeError("the scheduler failed") from req.error
            out[idx] = (n, first)

        try:
            run_one([None], 0)          # warm-up: prefill, insert, block decode
            out = [None] * slots
            threads = [threading.Thread(target=run_one, args=(out, i)) for i in range(slots)]
            t0 = time.time()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            end = time.time()
        finally:
            sched.shutdown()
        if any(o is None for o in out):
            raise RuntimeError(f"a stream of the {slots}-slot run did not finish")
        total = sum(o[0] for o in out)
        last_first = max(o[1] for o in out)
        steady = (total - slots) / (end - last_first) if end > last_first else 0.0
        results[str(slots)] = {
            "total_tok": total,
            "wall_s": round(end - t0, 2),
            "agg_tok_s": round(total / (end - t0), 1),
            "steady_decode_tok_s": round(steady, 1),
        }
    return results


def run_network_benchmark(port: int, n_prompt_tokens: int = 2048,
                          decode_tokens: int = DECODE_TOKENS) -> Dict:
    """The same decode through a running HTTP server over SSE: the
    network-side rate is the streamed chunks over their wall-clock span,
    to compare with the engine's own."""
    import urllib.request

    prompt = "benchmark " * (n_prompt_tokens // 2)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps({
            "messages": [{"role": "user", "content": prompt}],
            "max_tokens": decode_tokens, "temperature": 0.0,
            "stream": True,
        }).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.time()
    t_first = None
    n_chunks = 0
    t_last = t0
    with urllib.request.urlopen(req, timeout=2400) as resp:
        for raw in resp:
            line = raw.decode("utf-8", "replace").strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            obj = json.loads(line[6:])
            delta = obj["choices"][0].get("delta", {})
            if "content" in delta:
                now = time.time()
                if t_first is None:
                    t_first = now
                n_chunks += 1
                t_last = now
    net_decode = ((n_chunks - 1) / (t_last - t_first)
                  if n_chunks > 1 and t_last > t_first else None)
    return {
        "total_s": round(time.time() - t0, 2),
        "ttfc_s": round(t_first - t0, 3) if t_first else None,
        "network_decode_tok_s": round(net_decode, 2) if net_decode else None,
        "streamed_chunks": n_chunks,
    }


def reports_dir() -> str:
    home = os.environ.get("KRASIS_TPU_HOME", os.path.expanduser("~/.krasis_tpu"))
    return os.path.join(home, "reports")


def archive_report(report: Dict, out_dir: Optional[str] = None) -> str:
    """Write `report` as JSON into `out_dir` (default ``reports_dir()``)."""
    out_dir = out_dir or reports_dir()
    os.makedirs(out_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    name = report.get("model", "model").replace("/", "_")
    path = os.path.join(out_dir, f"{name}_{stamp}.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    return path


def network_benchmark(engine, model_name: str, port: int, eng_decode: Optional[float],
                      n_prompt_tokens: int = 2048, decode_tokens: int = DECODE_TOKENS,
                      runs: int = 3, tokenizer=None) -> Dict:
    """``run_network_benchmark`` through ``start_temp_server`` on the native
    and the stdlib transports, `runs` requests each; the median network
    rate against `eng_decode` gives the overhead."""
    from .server import start_temp_server

    out: Dict = {}
    for backend in ("native", "python"):
        try:
            httpd = start_temp_server(engine, tokenizer, model_name, port=port, backend=backend)
        except RuntimeError as e:
            out[backend] = {"error": str(e)}
            continue
        try:
            res = [run_network_benchmark(httpd.port, n_prompt_tokens, decode_tokens)
                   for _ in range(runs)]
        finally:
            httpd.shutdown()
        rates = [r["network_decode_tok_s"] for r in res if r.get("network_decode_tok_s")]
        net = res[-1]
        if rates and eng_decode:
            med = sorted(rates)[len(rates) // 2]
            net["network_decode_tok_s"] = med
            net["runs"] = rates
            net["overhead_pct"] = round(100.0 * (1 - med / eng_decode), 1)
        out[backend] = net
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m krasis_tpu_torch.benchmark")
    ap.add_argument("--model", help="checkpoint path")
    ap.add_argument("--synthetic", help="synthetic preset name (tiny: a tiny Qwen3-MoE)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="the card (default) or, when asked, the CPU")
    ap.add_argument("--expert-bits", type=int, default=4)
    ap.add_argument("--attention-quant", default="bf16", choices=("bf16", "int8", "int4"))
    ap.add_argument("--expert-activation", default="bf16", choices=("bf16", "int8"))
    ap.add_argument("--decode-block", type=int, default=32,
                    help="tokens per host synchronisation of the decode loop")
    ap.add_argument("--max-len", type=int, default=65536)
    ap.add_argument("--prefill-lengths", type=int, nargs="*", default=list(PREFILL_LENGTHS))
    ap.add_argument("--archive", action="store_true",
                    help="also write the report under $KRASIS_TPU_HOME/reports")
    ap.add_argument("--network", action="store_true",
                    help="also measure through a temporary HTTP server on both transports")
    ap.add_argument("--offload", default="none", choices=("none", "experts"),
                    help="routed experts in host RAM (OffloadEngine)")
    ap.add_argument("--slots-bench", type=int, nargs="*", default=None,
                    help="continuous-batching aggregate decode throughput at these slot "
                         "counts (skips the single-request protocol)")
    ap.add_argument("--port", type=int, default=8398, help="0 takes a free port")
    return ap


def main(argv=None) -> Dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if bool(args.model) == bool(args.synthetic):
        ap.error("give one of --model and --synthetic")

    from .config import ModelConfig, QuantConfig, preset_config
    from .device import resolve_device

    dev = resolve_device(args.device)
    quant = QuantConfig(expert_bits=args.expert_bits, attention=args.attention_quant,
                        expert_activation=args.expert_activation)
    tokenizer = None
    if args.synthetic:
        from .models.synthetic import build_synthetic_engine, tiny_config

        if args.synthetic == "tiny":
            # hash_tokenize draws ids from [1000, vocab - 100)
            cfg = tiny_config("qwen3-moe", vocab_size=2048)
            quant = QuantConfig(expert_bits=args.expert_bits, group_size=32,
                                attention=args.attention_quant,
                                expert_activation=args.expert_activation)
        else:
            cfg = preset_config(args.synthetic)
        engine = build_synthetic_engine(cfg, quant, max_len=args.max_len, device=dev,
                                        offload_engine=args.offload == "experts")
        model_name = f"synthetic/{args.synthetic}"
    else:
        from .runtime.engine import Engine
        from .runtime.tokenizer import Tokenizer

        cfg = ModelConfig.from_model_path(args.model)
        if args.offload == "experts":
            from .models.loader import load_params_offload
            from .runtime.offload_engine import OffloadEngine

            params, store = load_params_offload(cfg, quant, device=dev)
            engine = OffloadEngine(cfg, quant, params, store, max_len=args.max_len, device=dev)
        else:
            from .models.loader import load_params

            engine = Engine(cfg, quant, load_params(cfg, quant, device=dev),
                            max_len=args.max_len, device=dev)
        if os.path.exists(os.path.join(args.model, "tokenizer.json")):
            tokenizer = engine.tokenizer = Tokenizer(args.model)
        model_name = args.model
    engine.decode_block = args.decode_block

    report = {
        "model": model_name,
        "quant": {"expert_bits": args.expert_bits, "attention": args.attention_quant,
                  "expert_activation": args.expert_activation},
        "system": _system_info(),
    }
    if args.slots_bench is not None:
        slots = tuple(args.slots_bench) or (1, 4, 8, 16)
        report["results"] = {"slots_throughput": run_slots_benchmark(
            cfg, quant, engine.params, slots_list=slots,
            max_len=min(args.max_len, 2048), decode_block=args.decode_block, device=dev,
            offload=engine.offload)}
    else:
        report["results"] = run_engine_benchmark(
            engine, prefill_lengths=tuple(args.prefill_lengths))
    if args.network:
        eng_decode = report["results"].get("decode", {}).get("tok_s_median")
        report["results"]["network"] = network_benchmark(
            engine, model_name, args.port, eng_decode, tokenizer=tokenizer)

    print(json.dumps(report, indent=2))
    if args.archive:
        print("archived:", archive_report(report))
    return report


if __name__ == "__main__":
    main()
