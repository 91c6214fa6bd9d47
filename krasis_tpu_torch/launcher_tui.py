"""Curses launcher TUI: model select → hardware → config editor with a
live budget panel → confirm & launch.

The port of ``krasis_tpu/launcher_tui.py``: four screens (model scan,
hardware, the config editor with the budget over the card's memory, launch
confirm) that end in the port's server (``launcher.server_command``). A
pure view: state and actions live in small testable helpers
(``SettingState``, ``budget_lines``, ``hardware_lines``), and the stdin flow
of launcher.py stays available (``--plain`` or no terminal).
"""

from __future__ import annotations

import curses
import os
from typing import Dict, List, Optional, Tuple

from .launcher import SETTINGS, detect_hardware, hardware_text, server_command, show_budget

# enumerated settings cycle with ←/→ instead of free text
CHOICES = {
    "expert_bits": ["4", "8"],
    "kv_dtype": ["auto", "fp8", "bf16"],
    "attention_quant": ["bf16", "int8", "int4"],
    "expert_activation": ["bf16", "int8"],
    "offload": ["none", "experts", "auto"],
    "server_backend": ["auto", "native", "python"],
    "device": ["cuda", "cpu"],
}


class SettingState:
    """Editor state: ordered settings with defaults, cycling, editing."""

    def __init__(self, saved: Dict[str, str]):
        self.values = {k: saved.get(k, d) for k, _, d, _ in SETTINGS}
        self.cursor = 0

    def rows(self) -> List[Tuple[str, str]]:
        return [(p, self.values[k]) for k, p, _, _ in SETTINGS]

    def key_at(self, i: int) -> str:
        return SETTINGS[i][0]

    def cycle(self, i: int, step: int) -> bool:
        """←/→ on an enumerated setting; False when free-text."""
        key = self.key_at(i)
        opts = CHOICES.get(key)
        if not opts:
            return False
        cur = self.values[key]
        j = (opts.index(cur) + step) % len(opts) if cur in opts else 0
        self.values[key] = opts[j]
        return True

    def set(self, i: int, value: str):
        if value:
            self.values[self.key_at(i)] = value


def budget_lines(model: str, values: Dict[str, str]) -> List[str]:
    """Live budget panel content (re-rendered per edit)."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            show_budget(model, int(values.get("expert_bits", "4")),
                        values.get("kv_dtype", "auto"))
    except Exception as e:  # noqa: BLE001 — panel must never crash the UI
        return [f"(budget preview unavailable: {e})"]
    return buf.getvalue().splitlines()


def hardware_lines() -> List[str]:
    return hardware_text(detect_hardware())


# --------------------------------------------------------------------------
# curses screens
# --------------------------------------------------------------------------

def _header(scr, title: str):
    h, w = scr.getmaxyx()
    scr.addnstr(0, 0, f" krasis-tpu-torch launcher — {title} ".ljust(w - 1),
                w - 1, curses.A_REVERSE)


def _footer(scr, text: str):
    h, w = scr.getmaxyx()
    scr.addnstr(h - 1, 0, text[: w - 1], w - 1, curses.A_DIM)


def _pick_model(scr, models: List[str], saved_idx: int) -> Optional[str]:
    cur = min(saved_idx, max(len(models) - 1, 0))
    while True:
        scr.erase()
        _header(scr, "select model (screen 1/4)")
        h, w = scr.getmaxyx()
        if not models:
            scr.addnstr(2, 2, "no models found — press e to enter a path",
                        w - 3)
        top = max(0, cur - (h - 6))
        for i, m in enumerate(models[top: top + h - 5]):
            kind = "gguf" if m.endswith(".gguf") else "st  "
            attr = curses.A_REVERSE if top + i == cur else 0
            scr.addnstr(2 + i, 2, f"{kind} {m}", w - 4, attr)
        _footer(scr, "↑/↓ (j/k) move · enter select · e path · q quit")
        c = scr.getch()
        if c == ord("q"):
            return None
        if c in (curses.KEY_UP, ord("k")) and cur > 0:
            cur -= 1
        elif c in (curses.KEY_DOWN, ord("j")) and cur < len(models) - 1:
            cur += 1
        elif c == ord("e"):
            path = _prompt(scr, "model path: ")
            if path and os.path.exists(path):
                return path
        elif c in (curses.KEY_ENTER, 10, 13) and models:
            return models[cur]


def _show_hardware(scr) -> bool:
    scr.erase()
    _header(scr, "hardware (screen 2/4)")
    h, w = scr.getmaxyx()
    scr.addnstr(2, 2, "detecting…", w - 3)
    scr.refresh()
    lines = hardware_lines()
    scr.erase()
    _header(scr, "hardware (screen 2/4)")
    for i, ln in enumerate(lines[: h - 4]):
        scr.addnstr(2 + i, 2, ln, w - 3)
    _footer(scr, "enter continue · q quit")
    while True:
        c = scr.getch()
        if c in (curses.KEY_ENTER, 10, 13):
            return True
        if c == ord("q"):
            return False


def _prompt(scr, label: str) -> str:
    h, w = scr.getmaxyx()
    curses.echo()
    scr.addnstr(h - 2, 2, label.ljust(w - 3), w - 3)
    scr.refresh()
    try:
        s = scr.getstr(h - 2, 2 + len(label), w - 4 - len(label))
        return s.decode("utf-8", "replace").strip()
    finally:
        curses.noecho()


def _edit(scr, model: str, state: SettingState) -> Optional[str]:
    """Returns 'launch' | 'save' | None (abort)."""
    budget_cache = budget_lines(model, state.values)
    while True:
        scr.erase()
        _header(scr, "configure (screen 3/4)")
        h, w = scr.getmaxyx()
        scr.addnstr(2, 2, f"model: {model}", w - 3, curses.A_BOLD)
        rows = state.rows()
        for i, (label, val) in enumerate(rows):
            attr = curses.A_REVERSE if i == state.cursor else 0
            mark = "↔" if state.key_at(i) in CHOICES else " "
            scr.addnstr(4 + i, 2, f"{mark} {label:<36} {val}", w - 4, attr)
        y0 = 5 + len(rows)
        scr.addnstr(y0, 2, "— budget —", w - 3, curses.A_DIM)
        for i, ln in enumerate(budget_cache[: h - y0 - 3]):
            scr.addnstr(y0 + 1 + i, 2, ln, w - 3)
        _footer(scr, "↑/↓ (j/k) move · ←/→ ([/]) cycle · enter edit · "
                     "l launch · s save+quit · q abort")
        c = scr.getch()
        if c == ord("q"):
            return None
        if c == ord("l"):
            return "launch"
        if c == ord("s"):
            return "save"
        if c in (curses.KEY_UP, ord("k")) and state.cursor > 0:
            state.cursor -= 1
        elif c in (curses.KEY_DOWN, ord("j")) and state.cursor < len(rows) - 1:
            state.cursor += 1
        elif c in (curses.KEY_LEFT, curses.KEY_RIGHT, ord("["), ord("]")):
            step = 1 if c in (curses.KEY_RIGHT, ord("]")) else -1
            if state.cycle(state.cursor, step):
                budget_cache = budget_lines(model, state.values)
        elif c in (curses.KEY_ENTER, 10, 13):
            val = _prompt(scr, f"{state.key_at(state.cursor)} = ")
            state.set(state.cursor, val)
            budget_cache = budget_lines(model, state.values)


def _confirm(scr, cmd: List[str]) -> bool:
    scr.erase()
    _header(scr, "launch (screen 4/4)")
    h, w = scr.getmaxyx()
    scr.addnstr(2, 2, "command:", w - 3, curses.A_BOLD)
    line, y = "", 3
    for part in cmd:
        if len(line) + len(part) + 1 > w - 6:
            scr.addnstr(y, 4, line, w - 5)
            y, line = y + 1, ""
        line += part + " "
    scr.addnstr(y, 4, line, w - 5)
    _footer(scr, "enter launch · q back out")
    while True:
        c = scr.getch()
        if c in (curses.KEY_ENTER, 10, 13):
            return True
        if c == ord("q"):
            return False


def run_tui(models: List[str], saved: Dict[str, str]):
    """Returns (model, values, action) — action ∈ 'launch' | 'save' |
    None (aborted)."""

    def inner(scr):
        curses.curs_set(0)
        scr.keypad(True)
        model = _pick_model(scr, models,
                            int(saved.get("model_idx", "0") or 0))
        if model is None:
            return None, None, None
        if not _show_hardware(scr):
            return None, None, None
        state = SettingState(saved)
        action = _edit(scr, model, state)
        if action is None:
            return None, None, None
        if action == "launch":
            if not _confirm(scr, server_command(model, state.values)):
                action = "save"
        return model, state.values, action

    return curses.wrapper(inner)
