"""OpenAI-compatible HTTP server with SSE streaming (PyTorch port).

The port of ``krasis_tpu/server.py``: ``/health``, ``/v1/models`` and
``/v1/chat/completions`` (JSON and SSE, an immediate role chunk,
``stop`` strings, ``logprobs`` / ``top_logprobs``,
``stream_options.include_usage``, client-disconnect cancellation) and a
registry of running servers under ``$KRASIS_TPU_HOME/servers``, over the
port's ``Engine.generate``.

    python -m krasis_tpu_torch.server --synthetic deepseek-v2-lite
    python -m krasis_tpu_torch.server --model /path/to/checkpoint

Two transports share the route handler (``handle_request``):

* **native** (``--server-backend auto`` picks it when it builds): the C++
  epoll server of ``native/serve.cpp``, built with g++ at first use;
* **python**: the stdlib ``ThreadingHTTPServer``. ``auto`` falls back to it,
  with one logged warning naming the failure, when the native library does
  not build; ``native`` raises instead.

Generation is serialized through an engine lock, one request at a time
(``--slots 0``, the reference's default), unless a continuous-batching
``BatchScheduler`` is attached (``--slots N``): then requests take no lock
and share its N decode slots. Synthetic models (``--synthetic``) have no
tokenizer: message text is hashed into token ids and tokens come back as
``<id>`` (stream) or space-separated ids.

``--offload experts`` keeps the routed experts in host RAM
(``runtime/offload_engine.py`` ``OffloadEngine``: streamed-weight prefill,
the host engine for decode, ``--hot-experts N`` of each MoE layer on the
card); ``--offload auto`` (the default) takes it only when the model's
resident bytes (``budget.compute_budget``) pass 0.92 of the card's memory.

``main`` takes ``--config FILE`` (KEY=VALUE lines whose values are defaults
that the flags override), opens the run log ``krasis_tpu_torch.log`` in the
working directory (the previous one archived under ``logs/``; ``--note``
heads the new one) and starts the host RAM watchdog (``--min-free-ram-gb``,
0 turns it off): ``runlog.py``, ``syscheck.py``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict

from .chat import registry_dir
from .ops.sampling import SamplingParams

log = logging.getLogger("krasis_tpu_torch.server")


class ServerState:
    def __init__(self, engine, tokenizer, model_name: str, scheduler=None):
        self.engine = engine
        self.tokenizer = tokenizer  # None for synthetic models
        self.model_name = model_name
        self.scheduler = scheduler  # continuous batching; None: one request at a time
        self.lock = threading.Lock()


# ---- transport-independent route handlers ---------------------------------
# Both transports provide a writer with:
#   send_json(code, body_bytes) / sse_start() / sse_send(bytes) -> bool
#   sse_end() / cancelled() -> bool


def _json_bytes(obj: Dict[str, Any]) -> bytes:
    return json.dumps(obj).encode()


def _chunk(state: ServerState, rid, created, delta: Dict[str, Any],
           finish=None, logprobs=None) -> bytes:
    choice: Dict[str, Any] = {"index": 0, "delta": delta, "finish_reason": finish}
    if logprobs is not None:
        choice["logprobs"] = {"content": logprobs}
    obj = {"id": rid, "object": "chat.completion.chunk", "created": created,
           "model": state.model_name, "choices": [choice]}
    return f"data: {json.dumps(obj)}\n\n".encode()


def prompt_ids(state: ServerState, messages) -> list:
    """The request's prompt: the chat template's ids, or for a synthetic
    model its message text hashed into ids (at most 512)."""
    if state.tokenizer is not None:
        return state.tokenizer.apply_chat_template(messages)
    text = " ".join(m.get("content", "") for m in messages)
    vocab = state.engine.cfg.vocab_size
    return [(7 + 31 * ord(c)) % (vocab - 2) + 1 for c in text[:512]] or [1]


def handle_request(state: ServerState, method: str, path: str, body: bytes, w) -> None:
    if method == "GET" and path == "/health":
        w.send_json(200, _json_bytes({"status": "ok", "model": state.model_name}))
        return
    if method == "GET" and path == "/v1/models":
        w.send_json(200, _json_bytes({
            "object": "list",
            "data": [{"id": state.model_name, "object": "model", "owned_by": "krasis-tpu"}],
        }))
        return
    if method != "POST" or path != "/v1/chat/completions":
        w.send_json(404, _json_bytes({"error": "not found"}))
        return

    try:
        req = json.loads(body)
        if not isinstance(req, dict):
            raise ValueError("request body must be a JSON object")
        # field validation inside the 400 envelope: a null max_tokens or a
        # non-list stop is a client error, not a 500 or a dropped socket
        stream = bool(req.get("stream", False))
        max_tokens = int(req.get("max_tokens", req.get("max_completion_tokens", 512)))
        sampling = SamplingParams(
            temperature=float(req.get("temperature", 0.6)),
            top_k=int(req.get("top_k", 20)),
            top_p=float(req.get("top_p", 0.95)),
            presence_penalty=float(req.get("presence_penalty", 0.0)),
        )
        stops = _parse_stops(req)
        want_logprobs = bool(req.get("logprobs", False))
        top_logprobs = int(req.get("top_logprobs", 0) or 0)
        if not 0 <= top_logprobs <= 8:
            raise ValueError("top_logprobs must be in [0, 8]")
        seed = int(req.get("seed", 0) or 0)
        include_usage = bool((req.get("stream_options") or {}).get("include_usage", False))
        messages = req.get("messages", [])
        if not isinstance(messages, list):
            raise ValueError("messages must be a list")
    except Exception as e:  # a malformed request
        w.send_json(400, _json_bytes({"error": str(e)}))
        return
    ids = prompt_ids(state, messages)

    rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
    created = int(time.time())
    if state.scheduler is not None:
        # continuous batching: no lock, the scheduler shares its slots
        try:
            req = state.scheduler.submit(ids, max_new_tokens=max_tokens, sampling=sampling,
                                         want_logprobs=want_logprobs)
        except RuntimeError as e:                      # the scheduler has stopped
            w.send_json(500, _json_bytes({"error": str(e)}))
            return
        if stream:
            _stream_batched(state, w, rid, created, ids, req, stops, include_usage,
                            want_logprobs)
        else:
            _full_batched(state, w, rid, created, ids, req, stops, want_logprobs)
        return
    with state.lock:
        if stream:
            _stream_single(state, w, rid, created, ids, max_tokens, sampling, stops, seed,
                           include_usage, want_logprobs)
        else:
            _full_single(state, w, rid, created, ids, max_tokens, sampling, stops,
                         want_logprobs, top_logprobs, seed)


def _make_decoder(state: ServerState):
    if state.tokenizer is None:
        return None
    from .runtime.tokenizer import IncrementalDecoder

    return IncrementalDecoder(state.tokenizer)


class StopMatcher:
    """Streaming `stop`-string matcher: emits text only once it can no
    longer be the prefix of a stop string, so a stop sequence straddling
    chunk boundaries is still caught and never leaks to the client."""

    def __init__(self, stops):
        self.stops = [s for s in (stops or []) if s]
        self.hold = max((len(s) for s in self.stops), default=0)
        self.buf = ""
        self.stopped = False

    def push(self, text: str) -> str:
        """Feed decoded text; returns the text safe to emit now."""
        if self.stopped:
            return ""
        if not self.stops:
            return text
        self.buf += text
        hits = [i for i in (self.buf.find(s) for s in self.stops) if i >= 0]
        if hits:
            self.stopped = True
            out, self.buf = self.buf[:min(hits)], ""
            return out
        # emit everything except a tail that could still start a stop
        keep = 0
        for j in range(min(self.hold - 1, len(self.buf)), 0, -1):
            tail = self.buf[-j:]
            if any(s.startswith(tail) for s in self.stops):
                keep = j
                break
        if keep:
            out, self.buf = self.buf[:-keep], self.buf[-keep:]
        else:
            out, self.buf = self.buf, ""
        return out

    def flush(self) -> str:
        """End of generation: release any held-back tail."""
        out, self.buf = ("" if self.stopped else self.buf), ""
        return out


def _parse_stops(req) -> list:
    stop = req.get("stop")
    if stop is None:
        return []
    if isinstance(stop, str):
        stop = [stop]
    return [s for s in stop[:8] if isinstance(s, str) and s]


def _usage_chunk(state, rid, created, prompt_tokens, completion) -> bytes:
    obj = {"id": rid, "object": "chat.completion.chunk", "created": created,
           "model": state.model_name, "choices": [],
           "usage": {"prompt_tokens": prompt_tokens, "completion_tokens": completion,
                     "total_tokens": prompt_tokens + completion}}
    return f"data: {json.dumps(obj)}\n\n".encode()


class _Stream:
    """One streamed answer, token by token: the role chunk at once, each
    token's text once it can no longer start a stop string, and its logprob
    in the chunk that carries its text."""

    def __init__(self, state, w, rid, created, stops, want_logprobs):
        self.state, self.w, self.rid, self.created = state, w, rid, created
        self.want_logprobs = want_logprobs
        self.dec = _make_decoder(state)
        self.sm = StopMatcher(stops)
        self.n_tok = 0
        self.pending_lp: list = []  # (tok, lp) since the last chunk sent
        w.sse_start()
        # the role chunk at once: the client sees the stream open before prefill
        w.sse_send(self._chunk({"role": "assistant"}))

    def _chunk(self, delta, finish=None, logprobs=None) -> bytes:
        return _chunk(self.state, self.rid, self.created, delta, finish, logprobs)

    def push(self, tok: int, lp: float) -> bool:
        """Send what `tok` makes safe to send; False once the answer ends (a
        stop string, or a send the client is gone for)."""
        self.n_tok += 1
        if self.want_logprobs:
            self.pending_lp.append((tok, lp))
        text = self.sm.push(self.dec.push(tok) if self.dec is not None else f"<{tok}>")
        if text:
            lps = None
            if self.want_logprobs:
                lps = _logprobs_content(self.state, [t for t, _ in self.pending_lp],
                                        [p for _, p in self.pending_lp])
                self.pending_lp.clear()
            if not self.w.sse_send(self._chunk({"content": text}, logprobs=lps)):
                return False
        return not self.sm.stopped

    def finish(self, prompt_len: int, include_usage: bool) -> None:
        tail = self.sm.flush()
        if tail:
            self.w.sse_send(self._chunk({"content": tail}))
        self.w.sse_send(self._chunk({}, finish="stop"))
        if include_usage:
            self.w.sse_send(_usage_chunk(self.state, self.rid, self.created, prompt_len,
                                         self.n_tok))
        self.w.sse_send(b"data: [DONE]\n\n")
        self.w.sse_end()


class _Text:
    """An unstreamed answer's text, token by token: a stop string ends it
    where the string first occurs, and is left out. The text is built as
    the tokens come only when there are stops to watch for."""

    def __init__(self, state, stops):
        self.state, self.stops = state, stops
        self.sm = StopMatcher(stops)
        self.dec = _make_decoder(state) if stops else None
        self.pieces: list = []

    def push(self, tok: int) -> bool:
        """True once a stop string has completed."""
        if not self.stops:
            return False
        piece = self.dec.push(tok) if self.dec is not None else (
            ("" if not self.pieces else " ") + str(tok))
        self.pieces.append(self.sm.push(piece))
        return self.sm.stopped

    def text(self, tokens) -> str:
        if self.stops:
            return "".join(self.pieces) + self.sm.flush()
        if self.state.tokenizer is not None:
            return self.state.tokenizer.decode(tokens)
        return " ".join(str(t) for t in tokens)


def _completion(state, rid, created, text, tokens, logprobs, prompt_len, top=None, **extra):
    """The chat.completion body of an unstreamed answer."""
    choice = {"index": 0, "message": {"role": "assistant", "content": text},
              "finish_reason": "stop"}
    if logprobs is not None:
        choice["logprobs"] = {"content": _logprobs_content(state, tokens, logprobs, top)}
    n = len(tokens)
    return _json_bytes({
        "id": rid, "object": "chat.completion", "created": created,
        "model": state.model_name, "choices": [choice],
        "usage": {"prompt_tokens": prompt_len, "completion_tokens": n,
                  "total_tokens": prompt_len + n},
        **extra})


def _stream_single(state, w, rid, created, prompt_ids, max_tokens, sampling, stops=(),
                   seed=0, include_usage=False, want_logprobs=False):
    out = _Stream(state, w, rid, created, stops, want_logprobs)

    def on_token_lp(tok: int, lp: float):
        # the client went away, or a stop string: cancel decode
        if w.cancelled() or not out.push(tok, lp):
            raise StopIteration

    # the logprob values are unused unless the request asked for them, so
    # the engine skips their math then
    state.engine.generate(prompt_ids, max_new_tokens=max_tokens, sampling=sampling,
                          on_token_lp=on_token_lp, seed=seed, want_logprobs=want_logprobs)
    out.finish(len(prompt_ids), include_usage)


def _logprobs_content(state, tokens, lps, top=None):
    """OpenAI ``logprobs.content`` entries: each token's text and its raw
    model logprob (and the top-N alternatives when computed)."""
    def tok_str(t):
        return state.tokenizer.decode([t]) if state.tokenizer is not None else str(t)

    out = []
    for i, (t, lp) in enumerate(zip(tokens, lps or [])):
        alts = []
        if top is not None and i < len(top):
            alts = [{"token": tok_str(tid), "logprob": round(tlp, 6)} for tid, tlp in top[i]]
        out.append({"token": tok_str(t), "logprob": round(lp, 6), "top_logprobs": alts})
    return out


def _full_single(state, w, rid, created, prompt_ids, max_tokens, sampling, stops=(),
                 want_logprobs=False, top_logprobs=0, seed=0):
    # a stop string cancels generation rather than truncating afterwards: a
    # stop on token 3 of a 512-token request does not pay for 512 tokens
    text = _Text(state, stops)

    def on_token(tok: int):
        if text.push(tok):
            raise StopIteration

    res = state.engine.generate(prompt_ids, max_new_tokens=max_tokens, sampling=sampling,
                                on_token=on_token, seed=seed,
                                top_logprobs=(top_logprobs if want_logprobs else 0),
                                want_logprobs=want_logprobs)
    w.send_json(200, _completion(
        state, rid, created, text.text(res.tokens), res.tokens,
        res.logprobs if want_logprobs else None, res.prompt_len, res.top_logprobs,
        timing={"prefill_tok_s": round(res.prefill_tok_s, 2),
                "decode_tok_s": round(res.decode_tok_s, 2),
                # the verify steps' counts when the request ran a spec path
                **({"spec": state.engine.last_spec_stats}
                   if getattr(state.engine, "last_spec_stats", None) else {})}))


def _stream_batched(state, w, rid, created, prompt_ids, req, stops=(), include_usage=False,
                    want_logprobs=False):
    """Stream a request submitted to the scheduler: its tokens arrive on its
    queue; a stop string or a dropped client cancels it, and its queue is
    drained to the end sentinel either way."""
    out = _Stream(state, w, rid, created, stops, want_logprobs)
    ended = False
    while (tok := req.out_queue.get()) is not None:
        if ended:
            continue                 # drain to the scheduler's end sentinel
        # logprobs[i] is appended before token i reaches the queue
        if w.cancelled() or not out.push(tok, req.logprobs[out.n_tok]):
            req.cancelled.set()      # frees the slot at its next token
            ended = True
    if req.error is not None:
        # the status line has gone: the stream ends on an error event
        w.sse_send(f"data: {json.dumps({'error': str(req.error)})}\n\n".encode())
        w.sse_end()
    elif ended and not out.sm.stopped:
        # the client left: sse_end all the same, which releases the request
        # on the native transport
        w.sse_end()
    else:
        out.finish(len(prompt_ids), include_usage)


def _full_batched(state, w, rid, created, prompt_ids, req, stops=(), want_logprobs=False):
    """Answer a request submitted to the scheduler in one JSON body; a stop
    string cancels the rest of it."""
    text = _Text(state, stops)
    toks = []
    while (tok := req.out_queue.get()) is not None:
        if text.sm.stopped:
            continue                 # draining after a stop (the slot is cancelled)
        toks.append(tok)
        if text.push(tok):
            req.cancelled.set()
    if req.error is not None:
        w.send_json(500, _json_bytes({"error": str(req.error)}))
        return
    w.send_json(200, _completion(state, rid, created, text.text(toks), toks,
                                 req.logprobs[:len(toks)] if want_logprobs else None,
                                 len(prompt_ids)))


# ---- stdlib transport ------------------------------------------------------


class _StdlibWriter:
    """The writer protocol over a BaseHTTPRequestHandler (chunked SSE)."""

    def __init__(self, h: BaseHTTPRequestHandler):
        self._h = h
        self._dead = False

    def send_json(self, code: int, body: bytes) -> None:
        h = self._h
        try:
            h.send_response(code)
            h.send_header("Content-Type", "application/json")
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            # the client left before or while the response was written:
            # routine teardown, not an error
            self._dead = True

    def sse_start(self) -> None:
        h = self._h
        try:
            h.send_response(200)
            h.send_header("Content-Type", "text/event-stream")
            h.send_header("Cache-Control", "no-cache")
            h.send_header("Transfer-Encoding", "chunked")
            h.end_headers()
        except (BrokenPipeError, ConnectionResetError):
            self._dead = True

    def sse_send(self, data: bytes) -> bool:
        if self._dead:
            return False
        try:
            self._h.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self._h.wfile.flush()
            return True
        except (BrokenPipeError, ConnectionResetError):
            self._dead = True
            return False

    def sse_end(self) -> None:
        if self._dead:
            return
        try:
            self._h.wfile.write(b"0\r\n\r\n")
            self._h.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            self._dead = True

    def cancelled(self) -> bool:
        # a stdlib socket sees a disconnect only when a write fails (the
        # native transport sees EPOLLRDHUP)
        return self._dead


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet default logging
        pass

    def _dispatch(self):
        try:
            n = int(self.headers.get("Content-Length", 0))
        except ValueError:
            n = 0
        try:
            body = self.rfile.read(n) if n else b""
            handle_request(self.server.state, self.command, self.path, body,
                           _StdlibWriter(self))
        except (BrokenPipeError, ConnectionResetError):
            # a mid-request disconnect: close quietly
            self.close_connection = True

    def do_GET(self):
        self._dispatch()

    def do_POST(self):
        self._dispatch()


class _QuietThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that treats client-gone errors as routine (the
    default handle_error prints a traceback for a client that merely
    disconnected mid-stream); real errors still get the default report."""

    daemon_threads = True

    def __init__(self, state: ServerState, address):
        self.state = state
        super().__init__(address, Handler)

    @property
    def port(self) -> int:
        return self.server_address[1]

    def handle_error(self, request, client_address):
        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError, ConnectionAbortedError,
                            TimeoutError)):
            return
        super().handle_error(request, client_address)


# ---- lifecycle -------------------------------------------------------------


def register_server(port: int, model_name: str) -> str:
    """Server discovery registry: ``<registry_dir>/<port>.json``."""
    d = registry_dir()
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{port}.json")
    with open(path, "w") as f:
        json.dump({"port": port, "model": model_name, "pid": os.getpid(),
                   "started": time.time()}, f)
    return path


def _make_httpd(state: ServerState, host: str, port: int, backend: str = "auto"):
    """Build the requested transport. Returns (httpd, backend used)."""
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown server backend {backend!r}")
    if backend in ("auto", "native"):
        from .native import build_error
        from .native import serve as native_serve

        try:
            native_serve.load()
        except (OSError, subprocess.SubprocessError) as exc:
            if backend == "native":
                raise RuntimeError("the native server was asked for but its C++ library "
                                   f"did not build: {build_error(exc)}") from exc
            log.warning("native HTTP transport (native/serve.cpp) did not build, serving "
                        "on the stdlib transport: %s", build_error(exc))
        else:
            # every slot's request holds a worker while it runs; the headroom
            # keeps /health and queued requests answerable
            slots = state.scheduler.num_slots if state.scheduler is not None else 0
            httpd = native_serve.NativeHTTPServer(
                host, port, lambda m, p, b, w: handle_request(state, m, p, b, w),
                workers=max(32, 2 * slots + 8))
            return httpd, "native"
    return _QuietThreadingHTTPServer(state, (host, port)), "python"


def start_temp_server(engine, tokenizer, model_name: str, host="127.0.0.1", port=8398,
                      backend: str = "auto", scheduler=None):
    """A server that runs in the background of this process (port 0 picks a
    free one; the httpd's ``port`` says which), through `scheduler` when one
    is given. Returns the httpd; call ``.shutdown()`` when done."""
    state = ServerState(engine, tokenizer, model_name, scheduler)
    httpd, used = _make_httpd(state, host, port, backend)
    httpd.backend = used
    if used == "python":
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def run_server(engine, tokenizer, model_name: str, host="127.0.0.1", port=8399,
               backend: str = "auto", scheduler=None):
    """Serve until SIGINT or SIGTERM, registered while it runs."""
    state = ServerState(engine, tokenizer, model_name, scheduler)
    httpd, used = _make_httpd(state, host, port, backend)
    reg = register_server(httpd.port, model_name)
    if threading.current_thread() is threading.main_thread():
        def stop(signum, frame):
            # shutdown() waits for serve_forever, which runs on this thread
            threading.Thread(target=httpd.shutdown, daemon=True).start()
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, stop)
    print(f"krasis-tpu (torch) serving {model_name} on http://{host}:{httpd.port} "
          f"[{used} transport]", flush=True)
    try:
        httpd.serve_forever()
    finally:
        if used == "python":
            httpd.server_close()
        try:
            os.unlink(reg)
        except OSError:
            pass


def warmup(engine, scheduler=None):
    """Run a prefill and a few decode steps before accepting traffic, so the
    first request does not pay for the kernels' build and the allocator;
    through the scheduler too when one is attached."""
    t0 = time.time()
    n = min(256, engine.max_len // 4)
    greedy = SamplingParams(temperature=0.0)
    engine.generate(list(range(1, n + 1)), max_new_tokens=4, sampling=greedy, stop_ids={-1})
    if scheduler is not None:
        r = scheduler.submit(list(range(1, n + 1)), max_new_tokens=4, sampling=greedy)
        while r.out_queue.get(timeout=600) is not None:
            pass
        if r.error is not None:
            raise RuntimeError("the scheduler's warmup failed") from r.error
    print(f"warmup done in {time.time() - t0:.1f}s", flush=True)


AUTO_OFFLOAD_FRACTION = 0.92     # of the card's memory, for the resident weights


def choose_offload(args, cfg, quant, device, mesh=None) -> bool:
    """--offload: experts → True, none → False; auto → True when the
    model's resident weight bytes pass AUTO_OFFLOAD_FRACTION of the card's
    memory (the CPU is never short of it, and a mesh keeps the model
    resident, as the reference's auto does: resident)."""
    if args.offload != "auto":
        return args.offload == "experts"
    if device.type != "cuda" or mesh is not None:
        return False
    from .budget import card_memory, compute_budget

    need, have = compute_budget(cfg, quant).per_chip(1), card_memory(device)
    fits = need <= AUTO_OFFLOAD_FRACTION * have
    print(f"--offload auto: resident weights {need / 2**30:.2f} GiB, card "
          f"{have / 2**30:.2f} GiB: {'resident' if fits else 'experts in host RAM'}",
          flush=True)
    return not fits


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m krasis_tpu_torch.server",
        description="OpenAI-compatible server over krasis_tpu_torch's Engine on one CUDA "
                    "device (or the CPU with --device cpu).")
    ap.add_argument("--model", help="model checkpoint path")
    ap.add_argument("--synthetic", help="synthetic preset (tiny | deepseek-v2-lite | ...)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8399)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the engine runs: the card (default) or, when asked, the CPU "
                         "through the kernels' plain versions")
    ap.add_argument("--max-len", type=int, default=4096)
    ap.add_argument("--expert-bits", type=int, default=4, choices=(4, 8))
    ap.add_argument("--kv-dtype", default="auto", choices=("auto", "fp8", "bf16"))
    ap.add_argument("--attention-quant", default="bf16", choices=("bf16", "int8", "int4"))
    ap.add_argument("--expert-activation", default="bf16", choices=("bf16", "int8"),
                    help="int8 = W4A8 decode MoE (int8 tensor-core dots; adds bounded "
                         "activation rounding)")
    ap.add_argument("--shared-expert-quant", default="int8", choices=("bf16", "int8"))
    ap.add_argument("--dense-mlp-quant", default="int8", choices=("bf16", "int8"))
    ap.add_argument("--lm-head-quant", default="int8", choices=("bf16", "int8"))
    ap.add_argument("--mesh", default=None, metavar="DP,EP",
                    help="shard over a dp x ep device mesh (parallel/mesh.py): experts and "
                         "attention heads over ep, batch slots over dp; needs dp * ep cards, "
                         "or runs every shard on the CPU with --device cpu")
    ap.add_argument("--slots", type=int, default=0,
                    help="continuous-batching slots (BatchScheduler); 0 = one request at a "
                         "time through Engine.generate")
    ap.add_argument("--decode-block", type=int, default=8,
                    help="tokens per fused decode call of the batch scheduler (which needs "
                         "--slots > 0)")
    ap.add_argument("--spec-k", type=int, default=None, metavar="K",
                    help="speculative draft depth: each verify step commits 1 to K + 1 "
                         "tokens (0 turns speculative decoding off)")
    ap.add_argument("--spec-mode", default=None, choices=("auto", "mtp", "ngram", "off"),
                    help="speculative draft source: mtp = the checkpoint's MTP module, "
                         "ngram = prompt lookup (any model, the DeltaNet hybrids too), "
                         "auto = mtp where the module is, else off (models/mtp.py "
                         "spec_config)")
    ap.add_argument("--server-backend", default="auto", choices=("auto", "native", "python"),
                    help="HTTP transport: the C++ epoll server or the stdlib one; auto takes "
                         "native when it builds")
    ap.add_argument("--hot-experts", type=int, default=0, metavar="N",
                    help="offload mode: the N most picked experts of each MoE layer on the "
                         "card (the host serves only the cold picks)")
    ap.add_argument("--offload", default="auto", choices=("auto", "none", "experts"),
                    help="experts: routed expert weights in host RAM (prefill streams them "
                         "a layer group at a time, decode computes them on the host). auto "
                         "(default): resident when the model fits the card, else experts")
    ap.add_argument("--no-warmup", action="store_true", help="skip the pre-serve warmup")
    ap.add_argument("--note", default=None,
                    help="run note written at the top of the log file (runlog.py)")
    ap.add_argument("--min-free-ram-gb", type=float, default=2.0,
                    help="host RAM watchdog floor, GiB; 0 turns it off (syscheck.py)")
    return ap


def main(argv=None) -> int:
    from .runlog import apply_config_precedence, setup_run_logging

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    ap = build_parser()
    # --config FILE: its values are defaults that the flags override
    args = apply_config_precedence(ap, argv)
    if bool(args.model) == bool(args.synthetic):
        ap.error("give one of --model and --synthetic")
    # the engine and the scheduler read these when they are built
    if args.spec_k is not None:
        if args.spec_k <= 0:
            os.environ["KRASIS_TPU_NO_SPEC"] = "1"
        else:
            os.environ["KRASIS_TPU_SPEC_K"] = str(args.spec_k)
    if args.spec_mode is not None:
        os.environ["KRASIS_TPU_SPEC_MODE"] = args.spec_mode

    setup_run_logging(note=args.note)
    if args.config:
        log.info("config file %s: %s", args.config, args.config_values)
    log.info("arguments: %s", vars(args))
    stop_watchdog = None
    if args.min_free_ram_gb > 0:
        from .syscheck import start_ram_watchdog

        stop_watchdog = start_ram_watchdog(min_free_gb=args.min_free_ram_gb)
    try:
        return _serve(args, ap)
    finally:
        if stop_watchdog is not None:
            stop_watchdog()


def _serve(args, ap) -> int:
    """main's body after the flags, the log and the watchdog: build the
    engine (and the scheduler), warm up, serve."""
    from .config import ModelConfig, QuantConfig, preset_config

    def make_quant(group_size=128):
        return QuantConfig(expert_bits=args.expert_bits, group_size=group_size,
                           kv_cache_dtype=args.kv_dtype, attention=args.attention_quant,
                           expert_activation=args.expert_activation,
                           shared_expert=args.shared_expert_quant,
                           dense_mlp=args.dense_mlp_quant, lm_head=args.lm_head_quant)

    from .device import resolve_device

    dev = resolve_device(args.device)
    mesh = None
    if args.mesh:
        from .parallel.mesh import OFFLOAD_MESH_ERROR, make_mesh

        dp, ep = (int(x) for x in args.mesh.split(","))
        # the CPU has one device: every shard goes there; on the card each
        # shard needs a card of its own, as the reference's mesh does
        mesh = make_mesh(dp * ep, dp=dp, devices=[dev] * (dp * ep) if dev.type == "cpu" else None)
        if args.offload == "experts":
            ap.error(OFFLOAD_MESH_ERROR)
        print(f"--mesh {args.mesh}: {mesh}", flush=True)
    if args.synthetic:
        from .models.synthetic import build_synthetic_engine, tiny_config

        if args.synthetic == "tiny":
            cfg, quant = tiny_config("qwen3-moe"), make_quant(group_size=32)
        else:
            cfg, quant = preset_config(args.synthetic), make_quant()
        offload = choose_offload(args, cfg, quant, dev, mesh)
        engine = build_synthetic_engine(cfg, quant, max_len=args.max_len, device=dev,
                                        offload_engine=offload, hot_experts=args.hot_experts,
                                        mesh=mesh)
        tok = None
        name = f"synthetic/{args.synthetic}"
    else:
        from .models.loader import load_params, load_params_offload
        from .runtime.engine import Engine
        from .runtime.tokenizer import Tokenizer

        cfg = ModelConfig.from_model_path(args.model)
        quant = make_quant()
        if choose_offload(args, cfg, quant, dev, mesh):
            from .runtime.offload_engine import OffloadEngine

            params, store = load_params_offload(cfg, quant, device=dev)
            engine = OffloadEngine(cfg, quant, params, store, hot_experts=args.hot_experts,
                                   max_len=args.max_len, device=dev)
        else:
            params = load_params(cfg, quant, device=dev, mesh=mesh)
            engine = Engine(cfg, quant, params, max_len=args.max_len, device=dev, mesh=mesh)
        tok_files = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model")
        if os.path.isdir(args.model) and not any(
                os.path.exists(os.path.join(args.model, f)) for f in tok_files):
            # a checkpoint that ships no tokenizer files at all serves token
            # ids as the synthetic path does; one whose files fail to load
            # fails here
            log.warning("no tokenizer files in %s; serving raw token ids", args.model)
            tok = None
        else:
            tok = Tokenizer(args.model)
        name = os.path.basename(os.path.normpath(args.model))

    if engine.offload is not None:
        print(f"--offload experts: {engine.offload.nbytes() / 1e9:.2f} GB of routed experts in "
              f"host RAM ({engine.offload.native_tier()}, {engine.offload.native_threads()} "
              f"threads), {args.hot_experts} hot a layer on the card", flush=True)
    sched = None
    if args.slots > 0:
        from .runtime.scheduler import BatchScheduler

        sched = BatchScheduler(cfg, quant, engine.params, max_len=args.max_len,
                               num_slots=args.slots, decode_block=args.decode_block,
                               device=engine.device, offload=engine.offload, mesh=mesh)
    try:
        if not args.no_warmup:
            warmup(engine, sched)
        run_server(engine, tok, name, args.host, args.port, backend=args.server_backend,
                   scheduler=sched)
    finally:
        if sched is not None:
            sched.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
