"""Benchmark suite runner: model × config matrix from a TOML file.

The port of ``krasis_tpu/suite.py``: each combo runs as a process of its
own (``python -m krasis_tpu_torch.benchmark``, fresh device state), the
last JSON object of its standard output is its report, and a markdown
summary and each combo's log land under ``--out-dir``.

TOML schema:
    [suite]
    decode_tokens = 64
    prefill_lengths = [2048]

    [[combo]]
    name = "v2lite-q4"
    synthetic = "deepseek-v2-lite"    # or: model = "/path/to/ckpt"
    expert_bits = 4
    device = "cpu"                    # optional: the CPU instead of the card

    python -m krasis_tpu_torch.suite suite.toml --out-dir build/suite
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import tomllib
from typing import Dict, List


def combo_command(combo: Dict, suite_cfg: Dict) -> List[str]:
    """The benchmark's command line for one combo. Each flag must be one
    that ``benchmark.main`` accepts; a flag it does not take raises here,
    naming it, before anything runs."""
    cmd = [sys.executable, "-m", "krasis_tpu_torch.benchmark"]
    if combo.get("synthetic"):
        cmd += ["--synthetic", combo["synthetic"]]
    else:
        cmd += ["--model", combo["model"]]
    cmd += ["--expert-bits", str(combo.get("expert_bits", 4))]
    if combo.get("attention_quant"):
        cmd += ["--attention-quant", combo["attention_quant"]]
    if combo.get("decode_block"):
        cmd += ["--decode-block", str(combo["decode_block"])]
    pl = suite_cfg.get("prefill_lengths")
    if pl:
        cmd += ["--prefill-lengths"] + [str(x) for x in pl]
    if combo.get("max_len"):
        cmd += ["--max-len", str(combo["max_len"])]
    if combo.get("offload"):
        cmd += ["--offload", combo["offload"]]
    if combo.get("device"):
        cmd += ["--device", combo["device"]]
    from .benchmark import build_parser

    known = {s for a in build_parser()._actions for s in a.option_strings}
    for flag in (a for a in cmd[3:] if a.startswith("--")):
        if flag not in known:
            raise ValueError(f"krasis_tpu_torch.benchmark takes no {flag} "
                             f"(combo {combo.get('name', 'combo')!r})")
    return cmd


def last_json(out: str):
    """The last JSON object of a process's output (the report is printed
    indented over many lines), or None."""
    start = out.rfind("\n{")
    while start >= 0:
        try:
            return json.loads(out[start + 1:])
        except json.JSONDecodeError:
            start = out.rfind("\n{", 0, start)
    try:
        return json.loads(out)
    except json.JSONDecodeError:
        return None


def run_combo(combo: Dict, suite_cfg: Dict, log_dir: str) -> Dict:
    name = combo.get("name", "combo")
    cmd = combo_command(combo, suite_cfg)
    log_path = os.path.join(log_dir, f"{name}.log")
    t0 = time.time()
    with open(log_path, "w") as logf:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=logf,
                              timeout=combo.get("timeout_s", 3600))
    out = proc.stdout.decode()
    result: Dict = {"name": name, "elapsed_s": round(time.time() - t0, 1),
                    "rc": proc.returncode}
    report = last_json(out)
    if report is not None:
        result["report"] = report
    with open(log_path, "a") as logf:
        logf.write("\n--- stdout ---\n" + out)
    return result


def summarize(results: List[Dict]) -> str:
    lines = [
        "| combo | prefill tok/s | decode tok/s | elapsed | rc |",
        "|---|---|---|---|---|",
    ]
    for r in results:
        rep = (r.get("report") or {}).get("results", {})
        pre = rep.get("best_prefill_tok_s", "-")
        dec = rep.get("decode", {}).get("tok_s_mean", "-")
        lines.append(f"| {r['name']} | {pre} | {dec} | {r['elapsed_s']}s | {r['rc']} |")
    return "\n".join(lines)


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(prog="python -m krasis_tpu_torch.suite")
    ap.add_argument("toml", help="suite definition")
    ap.add_argument("--out-dir", default=os.path.join("build", "suite"))
    args = ap.parse_args(argv)

    with open(args.toml, "rb") as f:
        spec = tomllib.load(f)
    suite_cfg = spec.get("suite", {})
    combos = spec.get("combo", [])
    for combo in combos:            # a flag the benchmark lacks raises before any run
        combo_command(combo, suite_cfg)
    log_dir = os.path.join(args.out_dir, "suite_logs")
    os.makedirs(log_dir, exist_ok=True)

    results = []
    for combo in combos:
        print(f"[suite] running {combo.get('name')} ...", flush=True)
        try:
            results.append(run_combo(combo, suite_cfg, log_dir))
        except subprocess.TimeoutExpired:
            results.append({"name": combo.get("name"), "rc": -1,
                            "elapsed_s": combo.get("timeout_s", 3600)})
    md = summarize(results)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    out = os.path.join(args.out_dir, f"suite_{stamp}.md")
    with open(out, "w") as f:
        f.write(md + "\n")
    print(md)
    print("written:", out)
    return results


if __name__ == "__main__":
    main()
