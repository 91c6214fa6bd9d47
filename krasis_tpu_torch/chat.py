"""Terminal streaming chat client (urllib only, no dependencies).

The port of ``krasis_tpu/chat.py``: server discovery through the registry
directory (``$KRASIS_TPU_HOME/servers``, read at call time), SSE parsing,
``<think>``-block filtering, GPT-OSS channel filtering and the --sanity
battery.

    python -m krasis_tpu_torch.chat [--url http://127.0.0.1:8399]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.request


class ChannelFilter:
    """Incremental filter for GPT-OSS channel markup.

    GPT-OSS emits structured turns like
    ``<|channel|>analysis<|message|>…<|end|><|start|>assistant
    <|channel|>final<|message|>…`` — only the ``final`` channel is user
    content. This is a small
    streaming state machine: markers may arrive split across SSE chunks,
    so any suffix that could be the start of a marker is held back until
    it resolves. Text with no channel markup passes through untouched.
    """

    MARKERS = ("<|channel|>", "<|message|>", "<|end|>", "<|start|>",
               "<|endofprompt|>", "<|return|>")
    _MAXLEN = max(len(m) for m in MARKERS)

    def __init__(self):
        self._pending = ""
        self._mode = "text"      # "text" | "channel" | "role"
        self._channel = "final"  # pre-markup text displays
        self._seen_markup = False

    def _emit(self, text: str) -> str:
        if self._mode == "channel":
            self._channel += text
            return ""
        if self._mode == "role":
            return ""
        if self._seen_markup and self._channel != "final":
            return ""
        return text

    def _on_marker(self, m: str):
        self._seen_markup = True
        if m == "<|channel|>":
            self._mode, self._channel = "channel", ""
        elif m == "<|message|>":
            self._mode = "text"
        elif m == "<|start|>":
            self._mode = "role"
        else:  # <|end|> / <|endofprompt|> / <|return|>
            self._mode = "role"  # nothing displays until the next message

    def feed(self, chunk: str) -> str:
        self._pending += chunk
        out = []
        while self._pending:
            hit = min(
                ((i, m) for m in self.MARKERS
                 if (i := self._pending.find(m)) != -1),
                default=None,
            )
            if hit is not None:
                i, m = hit
                out.append(self._emit(self._pending[:i]))
                self._on_marker(m)
                self._pending = self._pending[i + len(m):]
                continue
            # no full marker: emit all but a tail that could become one
            keep = 0
            for j in range(1, min(self._MAXLEN, len(self._pending)) + 1):
                tail = self._pending[-j:]
                if any(m.startswith(tail) for m in self.MARKERS):
                    keep = j
            cut = len(self._pending) - keep
            out.append(self._emit(self._pending[:cut]))
            self._pending = self._pending[cut:]
            break
        return "".join(out)

    def flush(self) -> str:
        out = self._emit(self._pending)
        self._pending = ""
        return out

def registry_dir() -> str:
    """Where running servers register (server.register_server writes it)."""
    home = os.environ.get("KRASIS_TPU_HOME", os.path.expanduser("~/.krasis_tpu"))
    return os.path.join(home, "servers")


def discover_server() -> str | None:
    """The first registered server that answers /health."""
    d = registry_dir()
    try:
        entries = sorted(os.listdir(d))
    except FileNotFoundError:
        return None
    for name in entries:
        try:
            with open(os.path.join(d, name)) as f:
                info = json.load(f)
            url = f"http://127.0.0.1:{info['port']}"
            urllib.request.urlopen(url + "/health", timeout=2)
            return url
        except Exception:
            continue
    return None


def stream_chat(url: str, messages, max_tokens=512, temperature=0.6,
                hide_thinking=True, out=sys.stdout) -> str:
    req = urllib.request.Request(
        url + "/v1/chat/completions",
        data=json.dumps({
            "messages": messages, "stream": True,
            "max_tokens": max_tokens, "temperature": temperature,
        }).encode(),
        headers={"Content-Type": "application/json"},
    )
    full = []
    in_think = False
    channels = ChannelFilter()
    with urllib.request.urlopen(req) as resp:
        for raw in resp:
            line = raw.decode("utf-8", errors="replace").strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                break
            delta = json.loads(payload)["choices"][0]["delta"]
            text = delta.get("content", "")
            if not text:
                continue
            full.append(text)
            # GPT-OSS channel markup: show only the final channel
            text = channels.feed(text)
            if not text:
                continue
            if hide_thinking:
                # crude <think>…</think> stream filter
                if "<think>" in text:
                    in_think = True
                    text = text.split("<think>")[0]
                if "</think>" in text:
                    in_think = False
                    text = text.split("</think>")[-1]
                elif in_think:
                    continue
            out.write(text)
            out.flush()
        tail = channels.flush()
        if tail and not in_think:
            out.write(tail)
    out.write("\n")
    return "".join(full)


SANITY_PROMPTS = [
    "What is 2+2? Answer with just the number.",
    "Name the capital of France in one word.",
    "Complete: The quick brown fox jumps over the lazy",
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", help="server url (default: auto-discover)")
    ap.add_argument("--max-tokens", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=0.6)
    ap.add_argument("--show-thinking", action="store_true")
    ap.add_argument("--sanity", action="store_true",
                    help="run the sanity prompt battery and exit")
    args = ap.parse_args()

    url = args.url or discover_server()
    if not url:
        print("no running server found (start: python -m krasis_tpu_torch.server)")
        return 1

    if args.sanity:
        for p in SANITY_PROMPTS:
            print(f"\n>>> {p}")
            stream_chat(url, [{"role": "user", "content": p}],
                        max_tokens=64, temperature=0.0)
        return 0

    history = []
    print(f"connected to {url} — /quit to exit")
    while True:
        try:
            user = input("\nyou> ")
        except (EOFError, KeyboardInterrupt):
            break
        if user.strip() in ("/quit", "/exit"):
            break
        history.append({"role": "user", "content": user})
        print("model> ", end="")
        reply = stream_chat(
            url, history, max_tokens=args.max_tokens,
            temperature=args.temperature,
            hide_thinking=not args.show_thinking,
        )
        history.append({"role": "assistant", "content": reply})
    return 0


if __name__ == "__main__":
    sys.exit(main())
