"""Serving soak on the port (krasis_tpu_torch/server.py), the counterpart
of tests/test_serving_soak.py: twelve concurrent SSE streams over the
continuous-batching scheduler on each transport (the stdlib one and the
native epoll one), every third client dropping its connection mid-stream.
Every stream that was not dropped runs to its end, the server keeps serving
after the churn, and nothing reaches stderr: no traceback, no socketserver
"Exception occurred during processing of request"."""

import json
import socket
import threading
import time
import urllib.request

import pytest

from krasis_tpu_torch import server
from krasis_tpu_torch.config import QuantConfig
from krasis_tpu_torch.models.synthetic import build_synthetic_engine, tiny_config
from krasis_tpu_torch.runtime.scheduler import BatchScheduler

import torch_port_util  # noqa: F401  (one PyTorch thread)

NEW = 24


@pytest.fixture(scope="module")
def served():
    cfg = tiny_config("qwen3-moe")
    quant = QuantConfig(expert_bits=4, group_size=32, kv_cache_dtype="bf16")
    engine = build_synthetic_engine(cfg, quant, max_len=512, device="cpu")
    sched = BatchScheduler(cfg, quant, engine.params, max_len=512, num_slots=4,
                           decode_block=4, device="cpu")
    yield engine, sched
    sched.shutdown()


def _sse_request(port, content, max_tokens, disconnect_after=0):
    """Open an SSE stream; with `disconnect_after`, close the socket after
    that many data chunks (no clean HTTP teardown). Returns (chunks seen,
    whether [DONE] came)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps({"messages": [{"role": "user", "content": content}],
                         "max_tokens": max_tokens, "temperature": 0.0,
                         "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    chunks, done = 0, False
    resp = urllib.request.urlopen(req, timeout=600)
    try:
        for raw in resp:
            line = raw.decode("utf-8", "replace").strip()
            if line == "data: [DONE]":
                done = True
                continue
            if not line.startswith("data: "):
                continue
            chunks += 1
            if disconnect_after and chunks >= disconnect_after:
                try:
                    resp.fp.raw._sock.shutdown(socket.SHUT_RDWR)   # noqa: SLF001
                except Exception:
                    pass
                resp.close()
                return chunks, done
    finally:
        try:
            resp.close()
        except Exception:
            pass
    return chunks, done


@pytest.mark.parametrize("backend", ["python", "native"])
def test_soak_disconnects_stderr_clean(served, backend, capfd):
    engine, sched = served
    httpd = server.start_temp_server(engine, None, "synthetic/tiny", port=0, scheduler=sched,
                                     backend=backend)
    assert httpd.backend == backend
    port = httpd.port
    try:
        assert _sse_request(port, "warm", 4)[0] >= 1
        results = [None] * 12

        def worker(i):
            results[i] = _sse_request(port, f"client {i}", NEW,
                                      disconnect_after=2 if i % 3 == 0 else 0)
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert all(r is not None for r in results)
        for i, (n, done) in enumerate(results):
            if i % 3 == 0:
                assert n >= 2 and not done, (i, n, done)
            else:
                assert n >= 2 and done, (i, n, done)
        time.sleep(1.0)
        assert _sse_request(port, "after the storm", 4)[1]
    finally:
        httpd.shutdown()
        time.sleep(0.5)
    err = capfd.readouterr().err
    assert "Exception occurred during processing of request" not in err, err
    assert "Traceback" not in err, err
