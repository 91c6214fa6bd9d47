"""Unified CLI: ``krasis-tpu-torch <command>``, the port of ``krasis_tpu/cli.py``.

Commands: serve, chat, benchmark, ppl, budget, check, launch, each over the
port's entry point. The entry points run on the card unless asked for the
CPU (``--device cpu``); ``budget`` reads the card's memory, and off the card
needs ``--hbm-gb``.

    python -m krasis_tpu_torch.cli check
    python -m krasis_tpu_torch.cli budget deepseek-v2-lite
    python -m krasis_tpu_torch.cli serve --synthetic tiny --device cpu
"""

from __future__ import annotations

import sys

PROG = "krasis-tpu-torch"

COMMANDS = {
    "serve": "OpenAI-compatible HTTP server (krasis_tpu_torch.server)",
    "chat": "terminal streaming chat client (krasis_tpu_torch.chat)",
    "benchmark": "standardized benchmark protocol (krasis_tpu_torch.benchmark)",
    "ppl": "perplexity through the production path (krasis_tpu_torch.perplexity)",
    "budget": "device-memory budget calculator from config.json or a preset",
    "check": "environment / device report",
    "launch": "interactive launcher",
}


def budget_main(argv) -> int:
    import argparse

    import torch

    from .budget import card_memory, format_budget
    from .config import ModelConfig, QuantConfig, preset_config

    ap = argparse.ArgumentParser(prog=f"{PROG} budget")
    ap.add_argument("model", help="checkpoint path or preset name")
    ap.add_argument("--expert-bits", type=int, default=4)
    ap.add_argument("--chips", type=int, default=1)
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="device memory a card, GiB (default: the card's own; required "
                         "without a card)")
    a = ap.parse_args(argv)
    if a.hbm_gb is None and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --hbm-gb")
    try:
        cfg = preset_config(a.model)
    except KeyError:
        cfg = ModelConfig.from_model_path(a.model)
    hbm = card_memory() if a.hbm_gb is None else int(a.hbm_gb * (1 << 30))
    print(format_budget(cfg, QuantConfig(expert_bits=a.expert_bits), a.chips, hbm))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: {PROG} <command> [args]\n\ncommands:")
        for name, desc in COMMANDS.items():
            print(f"  {name:<10} {desc}")
        return 0
    cmd, rest = argv[0], argv[1:]
    sys.argv = [f"{PROG} {cmd}"] + rest

    if cmd == "serve":
        from . import server

        return server.main(rest) or 0
    if cmd == "chat":
        from . import chat

        return chat.main() or 0
    if cmd == "benchmark":
        from . import benchmark

        benchmark.main(rest)
    elif cmd == "ppl":
        from . import perplexity

        perplexity.main(rest)
    elif cmd == "budget":
        return budget_main(rest)
    elif cmd == "check":
        from .syscheck import run_startup_checks

        run_startup_checks()
    elif cmd == "launch":
        from .launcher import main as launch_main

        return launch_main(rest) or 0
    else:
        print(f"unknown command '{cmd}' — run `{PROG} --help`")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
