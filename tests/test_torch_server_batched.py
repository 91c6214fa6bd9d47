"""The port's server with a continuous-batching scheduler attached
(``--slots``), on the CPU.

A tiny DeepSeek-V2-Lite (MLA, 2 layers) is served through a 2-slot
``BatchScheduler`` on the stdlib transport (and the native one for the
concurrency case): four requests at once, streamed and not, each answered
with the ids ``Engine.generate`` gives for the same prompt; stop strings; a
client that drops its stream; a fault in the scheduler's loop answered with
500; and ``python -m krasis_tpu_torch.server --slots 2`` run as a user runs
it. Synthetic models hash message text into ids; TEXTS are checked free of
top-2 ties over their greedy steps (the scheduler decodes two rows at a
time, which moves a row's logits by rounding). Every HTTP read and queue
read has a timeout."""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

from krasis_tpu_torch import server
from krasis_tpu_torch.config import QuantConfig, preset_config
from krasis_tpu_torch.models.params import init_synthetic_params
from krasis_tpu_torch.ops.sampling import SamplingParams
from krasis_tpu_torch.runtime import scheduler as sched_mod
from krasis_tpu_torch.runtime.engine import Engine
from krasis_tpu_torch.runtime.scheduler import BatchScheduler

from torch_port_util import run_log_dir  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = preset_config("deepseek-v2-lite", hidden_size=64, intermediate_size=128,
                    moe_intermediate_size=32, num_hidden_layers=2, num_attention_heads=4,
                    kv_lora_rank=32, vocab_size=256, n_routed_experts=8,
                    num_experts_per_tok=2)
QUANT = QuantConfig(expert_bits=4, group_size=32, kv_cache_dtype="bf16")
MAX_LEN = 256
NEW = 6
GAP = 0.02
TIMEOUT = 120
# four texts whose greedy steps keep a top-2 logit gap above GAP
TEXTS = ["incremental prefix reuse across", "(triangular solves) + recurrent",
         "(decode; scalar-prefetch double-buffers each", "GPT-OSS, Kimi, VL) quant.py"]


@pytest.fixture(scope="module")
def model():
    params = init_synthetic_params(CFG, QUANT, seed=0)
    return Engine(CFG, QUANT, params, max_len=MAX_LEN, device="cpu")


@pytest.fixture(scope="module")
def served(model):
    """{backend: port} of servers over one 2-slot scheduler."""
    sched = BatchScheduler(CFG, QUANT, model.params, max_len=MAX_LEN, num_slots=2,
                           decode_block=4, device="cpu")
    httpds = {b: server.start_temp_server(model, None, "tiny", port=0, backend=b,
                                          scheduler=sched) for b in ("python", "native")}
    yield {b: h.port for b, h in httpds.items()}, sched
    for h in httpds.values():
        h.shutdown()
    sched.shutdown()


def ids_of(model, text):
    return server.prompt_ids(server.ServerState(model, None, ""), [{"content": text}])


def request(text, **kw):
    return {"messages": [{"role": "user", "content": text}], "max_tokens": NEW,
            "temperature": 0.0, **kw}


def post(port, obj, timeout=TIMEOUT):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/chat/completions", json.dumps(obj),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    out = r.status, r.read()
    conn.close()
    return out


def sse(body: bytes):
    out = []
    for line in body.decode().split("\n"):
        if line.startswith("data: "):
            data = line[len("data: "):]
            out.append(data if data == "[DONE]" else json.loads(data))
    return out


def streamed_ids(events):
    text = "".join(e["choices"][0]["delta"].get("content", "") for e in events
                   if isinstance(e, dict) and e.get("choices"))
    return [int(t) for t in text.replace("<", " ").replace(">", " ").split()]


def test_texts_are_tie_free(model):
    for text in TEXTS:
        ids = ids_of(model, text)
        toks = model.generate(ids, max_new_tokens=NEW, stop_ids={-1}).tokens
        model.reset()
        gaps = []
        with torch.inference_mode():
            logits = model._prefill_prompt(ids)
            for tok in toks:
                top = torch.topk(logits[0], 2).values
                gaps.append(float(top[0] - top[1]))
                logits = model._forward(torch.tensor([[tok]]), torch.ones(1, dtype=torch.int32),
                                        prefill=False)
        assert min(gaps) > GAP, (text, min(gaps))


@pytest.mark.parametrize("backend", ["python", "native"])
def test_four_concurrent_requests(model, served, backend):
    """Two streamed and two unstreamed requests at once on two slots: each
    answered with its solo Engine.generate ids, usage right."""
    ports, _ = served
    want = [model.generate(ids_of(model, t), max_new_tokens=NEW, stop_ids={-1}).tokens
            for t in TEXTS]
    results = [None] * 4

    def worker(i):
        results[i] = post(ports[backend], request(TEXTS[i], stream=i % 2 == 1,
                                                   stream_options={"include_usage": True}))
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    for i, (status, body) in enumerate(results):
        assert status == 200
        n = len(ids_of(model, TEXTS[i]))
        if i % 2:
            events = sse(body)
            assert events[0]["choices"][0]["delta"] == {"role": "assistant"}
            assert events[-1] == "[DONE]"
            assert streamed_ids(events) == want[i]
            assert events[-2]["usage"] == {"prompt_tokens": n, "completion_tokens": NEW,
                                           "total_tokens": n + NEW}
        else:
            out = json.loads(body)
            assert [int(t) for t in out["choices"][0]["message"]["content"].split()] == want[i]
            assert out["usage"]["completion_tokens"] == NEW


@pytest.mark.parametrize("stream", [False, True])
def test_stop_string_cancels(model, served, stream):
    """A stop across two tokens ends the answer where it first completes."""
    ports, _ = served
    toks = model.generate(ids_of(model, TEXTS[2]), max_new_tokens=NEW, stop_ids={-1}).tokens
    if stream:
        pieces = [f"<{t}>" for t in toks]
    else:
        pieces = [("" if i == 0 else " ") + str(t) for i, t in enumerate(toks)]
    whole = "".join(pieces)
    cut = len("".join(pieces[:3]))
    stop = whole[cut - 2:cut + 2]
    at = whole.find(stop)
    k = next(j for j in range(1, NEW + 1) if len("".join(pieces[:j])) >= at + len(stop))
    status, body = post(ports["python"], request(TEXTS[2], stream=stream, stop=[stop],
                                                 stream_options={"include_usage": True}))
    assert status == 200
    if stream:
        events = sse(body)
        text = "".join(e["choices"][0]["delta"].get("content", "") for e in events
                       if isinstance(e, dict) and e.get("choices"))
        assert text == whole[:at]
        assert events[-2]["usage"]["completion_tokens"] == k
    else:
        out = json.loads(body)
        assert out["choices"][0]["message"]["content"] == whole[:at]
        assert out["usage"]["completion_tokens"] == k


def test_dropped_client_frees_its_slot(model, served):
    """A client that leaves a long stream cancels it: its slot is freed, and
    requests after it are answered."""
    ports, sched = served
    s = socket.create_connection(("127.0.0.1", ports["python"]), timeout=TIMEOUT)
    raw = json.dumps(request(TEXTS[0], stream=True, max_tokens=200)).encode()
    s.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\nContent-Type: "
              b"application/json\r\nContent-Length: " + str(len(raw)).encode()
              + b"\r\n\r\n" + raw)
    s.recv(256)
    s.close()
    deadline = time.time() + TIMEOUT
    while any(sched._active) and time.time() < deadline:
        time.sleep(0.01)
    assert not any(sched._active), "the dropped stream still holds its slot"
    want = model.generate(ids_of(model, TEXTS[1]), max_new_tokens=NEW, stop_ids={-1}).tokens
    status, body = post(ports["python"], request(TEXTS[1]))
    assert status == 200
    assert [int(t) for t in json.loads(body)["choices"][0]["message"]["content"].split()] \
        == want


def test_loop_error_answers_500(model, monkeypatch):
    """A fault in the scheduler's loop: the waiting requests are answered
    500 (a stream that had begun ends on an error event), and so is every
    request after it."""
    gate = threading.Event()

    def broken(*a, **kw):
        gate.wait(TIMEOUT)
        raise RuntimeError("decode fault raised by the test")
    monkeypatch.setattr(sched_mod, "decode_block_batched", broken)
    sched = BatchScheduler(CFG, QUANT, model.params, max_len=MAX_LEN, num_slots=2,
                           device="cpu")
    httpd = server.start_temp_server(model, None, "tiny", port=0, backend="python",
                                     scheduler=sched)
    try:
        results = {}

        def worker(name, body):
            results[name] = post(httpd.port, body)
        threads = [threading.Thread(target=worker, args=("full", request(TEXTS[0]))),
                   threading.Thread(target=worker, args=("stream",
                                                         request(TEXTS[1], stream=True)))]
        for t in threads:
            t.start()
        # both submitted: one admitted (its first token out, its decode held
        # at the gate), the other queued
        deadline = time.time() + TIMEOUT
        while (sum(r is not None for r in sched._active) + sched._in_queue.qsize() < 2
               and time.time() < deadline):
            time.sleep(0.01)
        gate.set()
        for t in threads:
            t.join(TIMEOUT)
        assert results["full"][0] == 500
        assert "decode fault" in json.loads(results["full"][1])["error"]
        events = sse(results["stream"][1])
        assert "decode fault" in events[-1]["error"] and "[DONE]" not in events
        status, body = post(httpd.port, request(TEXTS[2]))
        assert status == 500 and "scheduler stopped" in json.loads(body)["error"]
    finally:
        httpd.shutdown()
        sched.shutdown()


def test_module_entry_point_with_slots(tmp_path):
    """python -m krasis_tpu_torch.server --slots 2 (on the CPU here): warms up
    through the scheduler, answers two requests at once, exits 0 on SIGTERM."""
    env = {**os.environ, "KRASIS_TPU_HOME": str(tmp_path), "PYTHONPATH": ROOT}
    proc = subprocess.Popen(
        [sys.executable, "-m", "krasis_tpu_torch.server", "--synthetic", "tiny", "--device",
         "cpu", "--port", "0", "--server-backend", "python", "--max-len", "512",
         "--slots", "2", "--decode-block", "4"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)     # the run log goes into the working directory
    try:
        reg = tmp_path / "servers"
        deadline = time.time() + TIMEOUT
        while not (reg.exists() and list(reg.iterdir())) and time.time() < deadline:
            assert proc.poll() is None, proc.stdout.read()
            time.sleep(0.2)
        port = json.loads(next(reg.iterdir()).read_text())["port"]
        results = []
        threads = [threading.Thread(target=lambda: results.append(post(port, {
            "messages": [{"role": "user", "content": "hi"}], "max_tokens": 3,
            "temperature": 0.0}))) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert [r[0] for r in results] == [200, 200]
        assert all(json.loads(r[1])["usage"]["completion_tokens"] == 3 for r in results)
        assert results[0][1] != b"" and json.loads(results[0][1])["choices"] \
            == json.loads(results[1][1])["choices"]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "warmup done" in out


@pytest.mark.parametrize("flags,item", [
    (["--spec-k", "2", "--offload", "experts"], "A-9"), (["--offload", "experts"], "A-9"),
    (["--mesh", "1,8"], "A-10")])
@pytest.mark.usefixtures("run_log_dir")
def test_slots_with_flags_not_ported_raise(flags, item, monkeypatch):
    """--offload experts (A-9): the scheduler shares the OffloadEngine's
    store, spec off. --mesh (A-10, a 1 x 8 CPU mesh here): the scheduler
    runs over the engine's mesh and answers a request as the mesh engine
    does."""
    for name in ("KRASIS_TPU_SPEC_MODE", "KRASIS_TPU_SPEC_K", "KRASIS_TPU_NO_SPEC"):
        monkeypatch.setenv(name, "")        # main sets them: restored afterwards
        monkeypatch.delenv(name)
    seen = {}

    def serve(engine, tok, name, host, port, backend="auto", scheduler=None):
        seen.update(engine=engine, scheduler=scheduler)
        if item == "A-10":               # main shuts the scheduler down after this
            greedy = SamplingParams(temperature=0.0)
            want = engine.generate([3, 4, 5], max_new_tokens=4, sampling=greedy,
                                   stop_ids={-1})
            req = scheduler.submit([3, 4, 5], max_new_tokens=4, sampling=greedy,
                                   stop_ids={-1})
            got = []
            while (t := req.out_queue.get(timeout=120)) is not None:
                got.append(t)
            seen.update(want=want.tokens, got=got, error=req.error)
    monkeypatch.setattr(server, "run_server", serve)
    assert server.main(["--synthetic", "tiny", "--device", "cpu", "--no-warmup",
                        "--slots", "2", *flags]) == 0
    eng, sch = seen["engine"], seen["scheduler"]
    if item == "A-9":
        assert eng.offload is not None and sch.offload is eng.offload
        assert eng.spec_mode is None and sch.spec_mode is None
        return
    assert sch.mesh is eng.mesh and eng.mesh.shape == {"dp": 1, "ep": 8}
    assert sch.params is eng.params
    assert seen["error"] is None and seen["got"] == seen["want"] and len(seen["got"]) == 4
