"""Run logging, log archiving, config-file precedence, exception hook.

The port of ``krasis_tpu/runlog.py``: a KEY=VALUE config file whose values
become argparse defaults (command-line flags win), the previous run's log
archived under ``logs/`` stamped with its mtime before a new one starts,
an optional ``--note`` written at the top of the fresh log, and an
excepthook that records uncaught exceptions in the log file. The log is
``krasis_tpu_torch.log`` (archived as ``logs/krasis_tpu_torch_<mtime>.log``),
a name of its own beside the reference's ``krasis_tpu.log``.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys
from datetime import datetime
from typing import Dict, Optional

LOG_NAME = "krasis_tpu_torch.log"
ARCHIVE_PREFIX = "krasis_tpu_torch_"

logger = logging.getLogger("krasis_tpu_torch")


def parse_config_file(path: str) -> Dict[str, object]:
    """KEY=VALUE / key-name=value lines → {argparse dest: typed value}.

    Booleans accept true/false; numbers coerce to int then float; ``~``
    expands in values that start with it. Lines starting with ``#`` and
    blank lines are ignored.
    """
    out: Dict[str, object] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, val = line.partition("=")
            dest = key.strip().replace("-", "_").lower()
            val = val.strip().strip('"').strip("'")
            low = val.lower()
            if low in ("true", "false"):
                out[dest] = low == "true"
                continue
            try:
                out[dest] = int(val)
            except ValueError:
                try:
                    out[dest] = float(val)
                except ValueError:
                    out[dest] = os.path.expanduser(val) if val.startswith("~") else val
    return out


def apply_config_precedence(parser: argparse.ArgumentParser,
                            argv=None) -> argparse.Namespace:
    """--config file values become defaults; explicit flags override them.

    Unknown keys in the file are rejected (typo protection) unless they
    start with ``x_`` (reserved for experiments). The file's values stay on
    the Namespace as ``config_values`` ({} without a file), for the caller
    to log once its run log is open.
    """
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default=None,
                     help="KEY=VALUE config file; CLI flags override it")
    pre_args, remaining = pre.parse_known_args(argv)
    parser.add_argument("--config", default=None, help=argparse.SUPPRESS)
    defaults: Dict[str, object] = {}
    if pre_args.config:
        if not os.path.isfile(pre_args.config):
            parser.error(f"config file not found: {pre_args.config}")
        defaults = parse_config_file(pre_args.config)
        known = {a.dest for a in parser._actions}
        bad = [k for k in defaults if k not in known and not k.startswith("x_")]
        if bad:
            parser.error(f"unknown config keys in {pre_args.config}: {bad}")
        parser.set_defaults(**{k: v for k, v in defaults.items() if k in known})
    args = parser.parse_args(remaining)
    args.config = pre_args.config
    args.config_values = defaults
    return args


def setup_run_logging(note: Optional[str] = None,
                      log_dir: Optional[str] = None) -> str:
    """Archive the previous log, open a fresh one, hook uncaught exceptions.

    Returns the live log file's path. The previous ``krasis_tpu_torch.log``
    in `log_dir` (default: the working directory) is moved to
    ``logs/krasis_tpu_torch_<mtime>.log`` (suffixed _1, _2, ... on rapid
    restarts), so no run's log is lost.
    """
    base = log_dir or os.getcwd()
    log_file = os.path.join(base, LOG_NAME)
    logs_dir = os.path.join(base, "logs")
    os.makedirs(logs_dir, exist_ok=True)

    if os.path.isfile(log_file) and os.path.getsize(log_file) > 0:
        ts = datetime.fromtimestamp(
            os.path.getmtime(log_file)).strftime("%Y%m%d_%H%M%S")
        dst = os.path.join(logs_dir, f"{ARCHIVE_PREFIX}{ts}.log")
        n = 1
        while os.path.exists(dst):
            dst = os.path.join(logs_dir, f"{ARCHIVE_PREFIX}{ts}_{n}.log")
            n += 1
        shutil.move(log_file, dst)
        print(f"archived previous log -> {os.path.relpath(dst, base)}")

    fmt = "%(asctime)s %(name)s %(levelname)s %(message)s"
    logging.basicConfig(level=logging.INFO, format=fmt)
    if note:
        with open(log_file, "w") as f:
            f.write(f"=== RUN NOTE: {note} ===\n\n")
    handler = logging.FileHandler(log_file, mode="a")
    handler.setLevel(logging.DEBUG)
    handler.setFormatter(logging.Formatter(fmt))
    logging.getLogger().addHandler(handler)
    if logger.level == logging.NOTSET:
        # the package's info lines reach the file whatever the root's level
        logger.setLevel(logging.INFO)

    prev_hook = sys.excepthook

    def _hook(exc_type, exc_value, exc_tb):
        logger.critical("uncaught exception",
                        exc_info=(exc_type, exc_value, exc_tb))
        prev_hook(exc_type, exc_value, exc_tb)

    sys.excepthook = _hook
    logger.info("logging to %s", log_file)
    return log_file
