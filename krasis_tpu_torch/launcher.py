"""Interactive launcher: model scan → config → budget preview → serve.

The port of ``krasis_tpu/launcher.py``: scan_models over a models
directory, hardware detection (``syscheck``), a config editor with a live
budget preview, a saved config at ``$KRASIS_TPU_HOME/config_torch`` (the
reference's ``config`` beside it is never read), a non-interactive mode,
and the server (``python -m krasis_tpu_torch.server``) spawned at the end.
Plain stdin prompts with ``--plain`` or without a terminal, the curses
screens of ``launcher_tui.py`` otherwise. The budget's device memory is the
card's (``budget.card_memory``); without a card there is no preview.

    python -m krasis_tpu_torch.launcher --models-dir ~/models
    python -m krasis_tpu_torch.cli launch --non-interactive
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
from typing import Dict, List

CONFIG_NAME = "config_torch"


def config_path() -> str:
    return os.path.join(
        os.environ.get("KRASIS_TPU_HOME", os.path.expanduser("~/.krasis_tpu")), CONFIG_NAME)


def scan_models(roots: List[str]) -> List[str]:
    """Find checkpoint directories (config.json + safetensors) and
    standalone .gguf files under roots: both source formats are launchable
    (``--model x.gguf`` goes through ``utils/gguf_source``)."""
    found = []
    for root in roots:
        if not os.path.isdir(root):
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            if "config.json" in filenames and any(
                f.endswith(".safetensors") for f in filenames
            ):
                found.append(dirpath)
                dirnames.clear()  # don't descend into checkpoints
                continue
            for f in filenames:
                if f.endswith(".gguf"):
                    found.append(os.path.join(dirpath, f))
    return sorted(found)


def detect_hardware() -> Dict:
    """The hardware screen: the cards and their memory (syscheck), host RAM,
    cores and free disk."""
    import shutil

    from .syscheck import device_report, host_report

    rep = {"accelerator": None, "host": None}
    try:
        rep["accelerator"] = device_report()
    except Exception as e:
        rep["accelerator"] = {"error": str(e)}
    try:
        rep["host"] = host_report()
    except Exception:
        rep["host"] = {}
    try:
        du = shutil.disk_usage(os.path.expanduser("~"))
        rep["disk_free_gb"] = round(du.free / (1 << 30), 1)
    except OSError:
        pass
    return rep


def hardware_text(rep: Dict) -> List[str]:
    """The hardware report as lines (the plain flow prints them, the curses
    screen shows them)."""
    lines = []
    acc = rep.get("accelerator") or {}
    if "error" in acc:
        lines.append(f"accelerator: unavailable ({acc['error']})")
    elif not acc.get("n_devices"):
        lines.append("accelerator: no CUDA device (the CPU runs only with --device cpu)")
    else:
        lines.append(f"accelerator: {acc.get('backend')} x{acc.get('n_devices')}")
        for d in acc.get("devices", []):
            mem = d.get("memory_gb")
            lines.append(f"  [{d['id']}] {d.get('kind')}" + (f", {mem} GiB" if mem else ""))
    host = rep.get("host") or {}
    if host:
        lines.append(f"host: {host.get('cpus', '?')} cpus, {host.get('ram_gb', '?')} GB RAM"
                     + (f", {rep['disk_free_gb']} GB disk free"
                        if "disk_free_gb" in rep else ""))
    return lines


def print_hardware(rep: Dict):
    for line in hardware_text(rep):
        print(line)


def load_saved_config() -> Dict[str, str]:
    cfg: Dict[str, str] = {}
    path = config_path()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#") and "=" in line:
                    k, v = line.split("=", 1)
                    cfg[k.strip()] = v.strip()
    return cfg


def save_config(cfg: Dict[str, str]):
    path = config_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k}={v}\n")


def _ask(prompt: str, default: str) -> str:
    resp = input(f"{prompt} [{default}]: ").strip()
    return resp or default


def show_budget(model_path: str, expert_bits: int, kv_dtype: str = "auto"):
    """format_budget of the checkpoint over the cards, at the card's memory;
    it raises without a card."""
    import torch

    from .budget import card_memory, format_budget
    from .config import ModelConfig, QuantConfig

    n = max(torch.cuda.device_count(), 1) if torch.cuda.is_available() else 1
    hbm = card_memory()
    cfg = ModelConfig.from_model_path(model_path)
    print(format_budget(
        cfg, QuantConfig(expert_bits=expert_bits, kv_cache_dtype=kv_dtype), n, hbm))


# Editable settings: (key, prompt, default, server flag)
SETTINGS = [
    ("expert_bits", "expert bits (4/8)", "4", "--expert-bits"),
    ("kv_dtype", "kv cache dtype (auto/fp8/bf16)", "auto", "--kv-dtype"),
    ("attention_quant", "attention quant (bf16/int8/int4)", "bf16",
     "--attention-quant"),
    ("expert_activation", "expert activations (bf16/int8=W4A8)", "bf16",
     "--expert-activation"),
    ("offload", "expert offload (none/experts=host RAM)", "none",
     "--offload"),
    ("hot_experts", "offload: hot experts on the card", "0",
     "--hot-experts"),
    ("max_len", "max context length", "4096", "--max-len"),
    ("slots", "batching slots (0 = single)", "0", "--slots"),
    ("decode_block", "decode block (tokens/host sync)", "8",
     "--decode-block"),
    ("server_backend", "server transport (auto/native/python)", "auto",
     "--server-backend"),
    ("port", "port", "8399", "--port"),
    ("device", "device (cuda = the card / cpu)", "cuda", "--device"),
]


def server_command(model: str, values: Dict[str, str]) -> List[str]:
    """The server's command line for a model and the settings' values."""
    cmd = [sys.executable, "-m", "krasis_tpu_torch.server", "--model", model]
    for key, _, default, flag in SETTINGS:
        cmd += [flag, values.get(key, default)]
    return cmd


def run_server(cmd: List[str]) -> int:
    """Start the server and wait for it; SIGINT and SIGTERM are passed on to
    it, so that stopping the launcher stops the server. Returns its exit
    code."""
    print("launching:", " ".join(cmd), flush=True)
    proc = subprocess.Popen(cmd)

    def forward(signum, frame):
        if proc.poll() is None:
            proc.send_signal(signum)

    old = {sig: signal.signal(sig, forward) for sig in (signal.SIGINT, signal.SIGTERM)}
    try:
        return proc.wait()
    finally:
        for sig, handler in old.items():
            signal.signal(sig, handler)
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def edit_loop(model: str, cfg: Dict[str, str]):
    """Live config editor: show all settings and the budget preview,
    re-render after every edit, until the user launches (l), saves and quits
    (q), or aborts (a)."""
    while True:
        print(f"\nmodel: {model}")
        for i, (key, prompt, default, _) in enumerate(SETTINGS):
            print(f"  [{i}] {prompt:<32} = {cfg.get(key, default)}")
        try:
            show_budget(model, int(cfg.get("expert_bits", "4")), cfg.get("kv_dtype", "auto"))
        except Exception as e:
            print(f"(budget preview unavailable: {e})")
        sel = input("edit # / (l)aunch / (q)uit-save / (a)bort: ").strip()
        if sel == "l":
            return cfg, True
        if sel == "q":
            return cfg, False
        if sel == "a":
            raise KeyboardInterrupt
        if sel.isdigit() and int(sel) < len(SETTINGS):
            key, prompt, default, _ = SETTINGS[int(sel)]
            cfg[key] = _ask(prompt, cfg.get(key, default))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m krasis_tpu_torch.launcher")
    ap.add_argument("--models-dir", action="append", default=[])
    ap.add_argument("--non-interactive", action="store_true",
                    help="launch the saved config without asking")
    ap.add_argument("--plain", action="store_true",
                    help="stdin prompts instead of the curses TUI")
    ap.add_argument("--port", type=int, default=None,
                    help="serve on this port (default: the saved setting)")
    args = ap.parse_args(argv)

    saved = load_saved_config()
    if args.port is not None:
        saved["port"] = str(args.port)
    roots = args.models_dir or [
        saved.get("models_dir", os.path.expanduser("~/models")),
        "/models", "/data/models",
    ]

    if args.non_interactive:
        model = saved.get("model")
        if not model:
            print("no saved config; run interactively first")
            return 1
        return run_server(server_command(model, saved))
    if args.plain or not (sys.stdin.isatty() and sys.stdout.isatty()):
        return main_plain(roots, saved)
    # the 4-screen curses TUI (launcher_tui.py); the plain prompts on any
    # terminal trouble
    try:
        from .launcher_tui import run_tui

        model, values, action = run_tui(scan_models(roots), saved)
    except Exception as e:  # noqa: BLE001 — degraded terminal
        print(f"(curses TUI unavailable: {e}; using plain prompts)")
        return main_plain(roots, saved)
    if action is None:
        print("aborted")
        return 1
    cfg = dict(saved)
    cfg.update(values)
    cfg["model"] = model
    save_config(cfg)
    if action != "launch":
        print(f"saved config to {config_path()}")
        return 0
    return run_server(server_command(model, cfg))


def main_plain(roots: List[str], saved: Dict[str, str]) -> int:
    """The stdin-prompt flow (no curses needed)."""
    print_hardware(detect_hardware())
    models = scan_models(roots)
    if models:
        print("found models:")
        for i, m in enumerate(models):
            kind = "gguf" if m.endswith(".gguf") else "safetensors"
            print(f"  [{i}] ({kind}) {m}")
        sel = _ask("select model #", saved.get("model_idx", "0"))
        model = models[int(sel)]
    else:
        model = _ask("model path", saved.get("model", ""))
        if not model:
            print("no model found — pass --models-dir or a path")
            return 1
    try:
        cfg, launch = edit_loop(model, dict(saved))
    except KeyboardInterrupt:
        print("\naborted")
        return 1
    cfg["model"] = model
    save_config(cfg)
    if not launch:
        print(f"saved config to {config_path()}")
        return 0
    return run_server(server_command(model, cfg))


if __name__ == "__main__":
    sys.exit(main())
