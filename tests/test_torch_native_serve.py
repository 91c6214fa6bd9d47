"""The port's server transports: the single-request cases of
tests/test_native_server.py on the port's native (native/serve.cpp) and
stdlib transports, over a tiny synthetic Qwen3-MoE engine on the CPU, and
the native library's build under concurrency: several processes building
into one empty directory must all load it."""

import http.client
import json
import os
import random
import socket
import subprocess
import sys
import threading
import time

import pytest

from krasis_tpu_torch.config import QuantConfig
from krasis_tpu_torch.models.synthetic import build_synthetic_engine, tiny_config
from krasis_tpu_torch.server import start_temp_server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class SpyEngine:
    """Delegates to a real engine, counting emitted tokens."""

    def __init__(self, eng):
        self._eng = eng
        self.cfg = eng.cfg
        self.max_len = eng.max_len
        self.tokens_emitted = 0

    def generate(self, prompt_ids, max_new_tokens, sampling, on_token=None, on_token_lp=None,
                 **kw):
        def counting(tok):
            self.tokens_emitted += 1
            if on_token is not None:
                on_token(tok)
        return self._eng.generate(prompt_ids, max_new_tokens=max_new_tokens, sampling=sampling,
                                  on_token=counting, on_token_lp=on_token_lp, **kw)


@pytest.fixture(scope="module")
def engine():
    return build_synthetic_engine(
        tiny_config("qwen3-moe"), QuantConfig(expert_bits=4, group_size=32, kv_cache_dtype="bf16"),
        max_len=1024, device="cpu")


@pytest.fixture(scope="module", params=["native", "python"])
def served(request, engine):
    spy = SpyEngine(engine)
    httpd = start_temp_server(spy, None, "synthetic/tiny", port=0, backend=request.param)
    assert httpd.backend == request.param
    yield httpd.port, spy, request.param
    httpd.shutdown()


def _post(port, obj, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/chat/completions", json.dumps(obj),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    body = r.read()
    conn.close()
    return r.status, body


def _health(port, timeout=10):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("GET", "/health")
    status = conn.getresponse().status
    conn.close()
    return status


def _raw_request(obj) -> bytes:
    body = json.dumps(obj).encode()
    return (b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\nContent-Type: application/json"
            b"\r\nContent-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)


def test_sse_stream(served):
    port, _, _ = served
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/chat/completions", json.dumps({
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
        "temperature": 0.0, "stream": True}), {"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.status == 200 and r.getheader("Content-Type") == "text/event-stream"
    lines = [raw.decode().strip() for raw in r]
    conn.close()
    data = [ln[6:] for ln in lines if ln.startswith("data: ")]
    assert data[-1] == "[DONE]"
    chunks = [json.loads(d) for d in data[:-1]]
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert "".join(c["choices"][0]["delta"].get("content", "") for c in chunks).count("<") == 4
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"


def test_concurrent_requests(served):
    """Four requests at once are all answered (one at a time behind the
    engine lock), each with its own greedy tokens."""
    port, _, _ = served
    results = []

    def worker():
        status, body = _post(port, {"messages": [{"role": "user", "content": "go"}],
                                    "max_tokens": 2, "temperature": 0.0})
        results.append((status, json.loads(body)["choices"][0]["message"]["content"]))

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert len(results) == 4 and len(set(results)) == 1 and results[0][0] == 200


def test_greedy_determinism(served):
    port, _, _ = served
    outs = [json.loads(_post(port, {"messages": [{"role": "user", "content": "determinism"}],
                                    "max_tokens": 6, "temperature": 0.0})[1])
            for _ in range(2)]
    assert outs[0]["choices"] == outs[1]["choices"]


def test_half_close_client_still_served(served):
    """A client that writes a whole request and then shuts its write side
    still gets its response (EPOLLIN and EPOLLRDHUP arrive together)."""
    port, _, _ = served
    s = socket.create_connection(("127.0.0.1", port), timeout=120)
    s.sendall(_raw_request({"messages": [{"role": "user", "content": "half close"}],
                            "max_tokens": 2, "temperature": 0.0}))
    s.shutdown(socket.SHUT_WR)
    data = b""
    while True:
        try:
            chunk = s.recv(65536)
        except socket.timeout:
            break
        if not chunk:
            break
        data += chunk
        if b"chat.completion" in data and data.rstrip().endswith(b"}"):
            break
    s.close()
    assert b"200 OK" in data and b"chat.completion" in data


def test_oversized_path_request(served):
    """A request line the parser must reject: no crash, still serving."""
    port, _, _ = served
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.sendall(b"GET /" + b"x" * (80 * 1024) + b" HTTP/1.1\r\n")
    time.sleep(0.2)
    s.close()
    assert _health(port) == 200


def test_disconnect_cancels_and_next_request_is_prompt(engine):
    """A client that drops a stream mid-way cancels its generation (the
    native transport sees EPOLLRDHUP), so the next request is answered
    without waiting for the dropped one's 400 tokens."""
    spy = SpyEngine(engine)
    httpd = start_temp_server(spy, None, "synthetic/tiny", port=0, backend="native")
    try:
        s = socket.create_connection(("127.0.0.1", httpd.port), timeout=60)
        s.sendall(_raw_request({"messages": [{"role": "user", "content": "long"}],
                                "max_tokens": 400, "temperature": 0.0, "stream": True}))
        s.recv(1024)      # the headers and the role chunk
        s.close()
        deadline = time.time() + 60
        while time.time() < deadline:
            done = spy.tokens_emitted
            time.sleep(0.5)
            if spy.tokens_emitted == done and done > 0:
                break
        assert 0 < spy.tokens_emitted < 400
        t0 = time.perf_counter()
        status, _ = _post(httpd.port, {"messages": [{"role": "user", "content": "next"}],
                                       "max_tokens": 2, "temperature": 0.0})
        assert status == 200 and time.perf_counter() - t0 < 30
    finally:
        httpd.shutdown()


def test_native_parser_fuzz(engine):
    """Malformed, truncated and random bytes at the hand-written parser
    must never take the server down or wedge a worker."""
    httpd = start_temp_server(engine, None, "synthetic/tiny", port=0, backend="native")
    rnd = random.Random(0)
    payloads = [
        b"", b"\r\n\r\n", b"GET\r\n\r\n",
        b"GET / HTTP/1.1\r\nContent-Length: -5\r\n\r\n",
        b"POST /v1/chat/completions HTTP/1.1\r\nContent-Length: 10\r\n\r\nabc",
        b"GET /health HTTP/1.1\r\nHost: x\r\n\r\nGET /health HTTP/1.1\r\n\r\n",
        b"POST / HTTP/1.1\r\nContent-Length: 99999999999999999999\r\n\r\n",
        bytes(rnd.randrange(256) for _ in range(512)),
        b"GET " + b"A" * 2000 + b" HTTP/1.1\r\n\r\n",
        b"POST /v1/chat/completions HTTP/1.1\r\ncontent-length: 2\r\n\r\n{}",
    ]
    try:
        for pl in payloads:
            try:
                s = socket.create_connection(("127.0.0.1", httpd.port), timeout=10)
                if pl:
                    s.sendall(pl)
                time.sleep(0.05)
                s.close()
            except OSError:
                pass  # the server may reset the connection; it must not die
        assert _health(httpd.port, timeout=30) == 200
    finally:
        httpd.shutdown()


def test_native_concurrency_soak(engine):
    """Health checks stay answerable while streams are in flight; no
    request is lost over many keep-alive cycles."""
    httpd = start_temp_server(engine, None, "synthetic/tiny", port=0, backend="native")
    errors = []

    def stream_worker():
        try:
            conn = http.client.HTTPConnection("127.0.0.1", httpd.port, timeout=120)
            conn.request("POST", "/v1/chat/completions", json.dumps({
                "messages": [{"role": "user", "content": "soak"}], "max_tokens": 16,
                "temperature": 0.0, "stream": True}), {"Content-Type": "application/json"})
            for _ in conn.getresponse():
                pass
            conn.close()
        except Exception as e:  # noqa: BLE001 (collected and asserted below)
            errors.append(e)

    def health_worker():
        try:
            conn = http.client.HTTPConnection("127.0.0.1", httpd.port, timeout=60)
            for _ in range(25):
                conn.request("GET", "/health")
                r = conn.getresponse()
                assert r.status == 200
                r.read()
            conn.close()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    ts = ([threading.Thread(target=stream_worker) for _ in range(2)]
          + [threading.Thread(target=health_worker) for _ in range(6)])
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        assert not errors, errors
    finally:
        httpd.shutdown()


BUILD = """
import sys
from krasis_tpu_torch.native import serve
lib = serve.load(sys.argv[1])
h = lib.ks_start(b"127.0.0.1", 0)
assert h > 0 and lib.ks_port(h) > 0
lib.ks_stop(h)
print("ok")
"""


def test_concurrent_builds_all_load(tmp_path):
    """Six processes build serve.cpp into one empty directory at once: each
    builds under the directory's lock to a name of its own, so every one
    loads a whole library (the JAX package's native build shares one
    temporary path and loses about half of such a race)."""
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, outs
    assert all(o.strip().endswith("ok") for o in outs), outs
    assert sorted(os.listdir(tmp_path)) == ["libkrasis_serve.so"]
