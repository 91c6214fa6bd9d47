"""The port's OpenAI-compatible server against the JAX package's.

A tiny DeepSeek-V2-Lite (2 layers, vocabulary 4096) is built by the JAX
package (Pallas kernels in interpret mode) and bridged into the port's
Engine on the CPU; both are served with the committed test tokenizer
(tests/data/torch_tokenizer), the JAX one by ``krasis_tpu.server`` on its
stdlib transport, the port's on both of its transports. The same requests
go to each: content, usage and the SSE chunk sequence must be identical
(``id``, ``created`` and ``timing`` left out), logprobs within 2e-2, the
tolerance of tests/test_torch_engine.py. Tiny random models have nearly
flat logits, so PROMPTS holds message texts whose greedy steps are at least
GAP apart (a guard test checks it), away from rounding coin-flips.

Also: the synthetic (no tokenizer) path through ``handle_request`` on both
sides, served tokens against ``Engine.generate``, the chat client, the
registry, ``main``'s flags, and ``python -m krasis_tpu_torch.server`` run as
a user runs it."""

import http.client
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from krasis_tpu import chat as jchat
from krasis_tpu import server as jserver
from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.models.synthetic import build_synthetic_engine as jax_build
from krasis_tpu.models.synthetic import tiny_config as jax_tiny_config
from krasis_tpu.runtime.tokenizer import Tokenizer as JaxTokenizer
from krasis_tpu_torch import chat, server
from krasis_tpu_torch.config import QuantConfig
from krasis_tpu_torch.models.synthetic import tiny_config
from krasis_tpu_torch.runtime.engine import Engine
from krasis_tpu_torch.runtime.tokenizer import Tokenizer

from torch_port_util import port_params, run_log_dir  # noqa: F401
from torch_tokenizer_util import COMMITTED

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = dict(moe_intermediate_size=128, num_hidden_layers=2, vocab_size=4096)
QUANT = dict(expert_bits=4, group_size=128, kv_cache_dtype="bf16")
LP_TOL = 2e-2
GAP = 0.05           # the least top-2 logit gap over a prompt's greedy steps
NEW = 8
PROMPTS = ["diagnostic information.", "Customize Python build configuration variables.",
           "But if you define a hashable set type, its __hash__ should",
           "For round-half-up and round-half-even (and for round-half-down and"]
STOPS = ["ed trap", "ers mem", "d call"]      # a stop inside each prompt's greedy text
TOP_PROMPT, TOP_NEW = 3, 4   # asked for top_logprobs=2 over 4 tokens
SYNTHETIC = ["To override the comparisons (presumably for speed, as the",
             "issubclass() function, but the registering ABC won't show up in"]


@pytest.fixture(scope="module")
def engines():
    mp = pytest.MonkeyPatch()
    mp.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    jeng = jax_build(jax_tiny_config("deepseek-v2-lite", **OVERRIDES), JaxQuantConfig(**QUANT),
                     max_len=1024, seed=0)
    eng = Engine(tiny_config("deepseek-v2-lite", **OVERRIDES), QuantConfig(**QUANT),
                 port_params(jeng.params), max_len=1024, device="cpu")
    yield jeng, eng
    mp.undo()


@pytest.fixture(scope="module")
def servers(engines):
    """{"jax": port, "native": port, "python": port} over the same weights."""
    jeng, eng = engines
    jhttpd = jserver.start_temp_server(jeng, JaxTokenizer(COMMITTED), "tiny", port=0,
                                       backend="python")
    tok = Tokenizer(COMMITTED)
    httpds = {b: server.start_temp_server(eng, tok, "tiny", port=0, backend=b)
              for b in ("native", "python")}
    assert {b: h.backend for b, h in httpds.items()} == {"native": "native", "python": "python"}
    yield {"jax": jhttpd.server_address[1], **{b: h.port for b, h in httpds.items()}}
    jhttpd.shutdown()
    for h in httpds.values():
        h.shutdown()


def _post(port, obj, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/chat/completions",
                 obj if isinstance(obj, bytes) else json.dumps(obj),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    status, ctype, body = r.status, r.getheader("Content-Type"), r.read()
    conn.close()
    return status, ctype, body


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    r = conn.getresponse()
    out = r.status, json.loads(r.read())
    conn.close()
    return out


def _sse(body: bytes):
    """The data lines of an SSE body: JSON objects, and "[DONE]"."""
    out = []
    for line in body.decode().split("\n"):
        if line.startswith("data: "):
            data = line[len("data: "):]
            out.append(data if data == "[DONE]" else json.loads(data))
    return out


def _same(got, want, path="$"):
    """Equal, except numbers under a "logprob" key, which may differ by
    LP_TOL; "id", "created" and "timing" are left out."""
    if isinstance(want, dict):
        keys = set(want) - {"id", "created", "timing"}
        assert set(got) - {"id", "created", "timing"} == keys, path
        for k in keys:
            if k == "logprob":
                assert abs(got[k] - want[k]) <= LP_TOL, (path, got[k], want[k])
            else:
                _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def _request(i, **kw):
    return {"messages": [{"role": "user", "content": PROMPTS[i]}], "max_tokens": NEW,
            "temperature": 0.0, **kw}


def _min_gaps(eng, ids, tokens):
    """(smallest top-1/top-2, smallest top-2/top-3 logit gap) over the
    teacher-forced greedy steps of `tokens` through the port."""
    eng.reset(1024)
    g12, g23 = [], []
    with torch.inference_mode():
        logits = eng._prefill_prompt(ids)
        for tok in tokens:
            top = torch.topk(logits[0].float(), 3).values
            g12.append(float(top[0] - top[1]))
            g23.append(float(top[1] - top[2]))
            logits = eng._forward(torch.tensor([[tok]]), torch.ones(1, dtype=torch.int32),
                                  prefill=False)
    return min(g12), min(g23)


@pytest.mark.parametrize("kind,i", [("chat", i) for i in range(len(PROMPTS))]
                         + [("synthetic", i) for i in range(len(SYNTHETIC))])
def test_prompts_are_away_from_ties(engines, kind, i):
    _, eng = engines
    if kind == "chat":
        ids = Tokenizer(COMMITTED).apply_chat_template([{"role": "user", "content": PROMPTS[i]}])
    else:
        ids = server.prompt_ids(server.ServerState(eng, None, ""), [{"content": SYNTHETIC[i]}])
    top = kind == "chat" and i == TOP_PROMPT
    res = eng.generate(ids, max_new_tokens=TOP_NEW if top else NEW, stop_ids={-1})
    g12, g23 = _min_gaps(eng, ids, res.tokens)
    assert g12 > GAP, g12
    if top:                         # its second alternative is served too
        assert g23 > LP_TOL, g23


REQUESTS = {
    "greedy": lambda: _request(0),
    "logprobs": lambda: _request(TOP_PROMPT, logprobs=True, top_logprobs=2, max_tokens=TOP_NEW),
    "stop": lambda: _request(2, stop=STOPS[2]),
    "stop-unmatched": lambda: _request(0, stop=["zzz", "qq"]),
}


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("name", ["greedy", "logprobs", "stop", "stop-unmatched"])
def test_json_response_matches_jax(servers, backend, name):
    req = REQUESTS[name]()
    want = _post(servers["jax"], req)
    got = _post(servers[backend], req)
    assert got[:2] == want[:2] == (200, "application/json")
    w, g = json.loads(want[2]), json.loads(got[2])
    _same(g, w)
    assert set(g["timing"]) == {"prefill_tok_s", "decode_tok_s"}
    if name == "stop":
        assert g["usage"]["completion_tokens"] < NEW   # the stop cancelled decode


STREAMS = {
    "plain": lambda: _request(0, stream=True),
    "usage-logprobs": lambda: _request(1, stream=True, logprobs=True,
                                       stream_options={"include_usage": True}),
    "stop": lambda: _request(1, stream=True, stop=[STOPS[1]],
                             stream_options={"include_usage": True}),
}


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_sse_sequence_matches_jax(servers, backend, name):
    req = STREAMS[name]()
    want = _post(servers["jax"], req)
    got = _post(servers[backend], req)
    assert got[:2] == want[:2] == (200, "text/event-stream")
    w, g = _sse(want[2]), _sse(got[2])
    _same(g, w)
    assert g[0]["choices"][0]["delta"] == {"role": "assistant"} and g[-1] == "[DONE]"


BAD = [b"null", b"{not json", b'{"messages": "hi"}', b'{"max_tokens": null}',
       b'{"top_logprobs": 50, "logprobs": true}']


@pytest.mark.parametrize("backend", ["native", "python"])
def test_errors_match_jax(servers, backend):
    for raw in BAD:
        want, got = _post(servers["jax"], raw), _post(servers[backend], raw)
        assert got == want and got[0] == 400, raw
    for path in ("/nope", "/v1/chat/completions"):
        assert _get(servers[backend], path) == _get(servers["jax"], path) == (
            404, {"error": "not found"})


@pytest.mark.parametrize("backend", ["native", "python"])
def test_health_and_models_keep_alive(servers, backend):
    conn = http.client.HTTPConnection("127.0.0.1", servers[backend], timeout=10)
    for path, want in (("/health", {"status": "ok", "model": "tiny"}),
                       ("/v1/models", {"object": "list", "data": [
                           {"id": "tiny", "object": "model", "owned_by": "krasis-tpu"}]})):
        conn.request("GET", path)         # the same connection twice
        r = conn.getresponse()
        assert (r.status, json.loads(r.read())) == (200, want)
    conn.close()


@pytest.mark.parametrize("backend", ["native", "python"])
def test_served_text_is_the_engine_s(engines, servers, backend):
    """The served greedy text is the tokenizer's decode of Engine.generate
    on the chat template's ids, and usage counts those ids."""
    _, eng = engines
    tok = Tokenizer(COMMITTED)
    for i in range(len(PROMPTS)):
        ids = tok.apply_chat_template([{"role": "user", "content": PROMPTS[i]}])
        want = tok.decode(eng.generate(ids, max_new_tokens=NEW, stop_ids={-1}).tokens)
        obj = json.loads(_post(servers[backend], _request(i))[2])
        assert obj["choices"][0]["message"]["content"] == want
        assert obj["usage"]["prompt_tokens"] == len(ids)


class Recorder:
    """A writer that keeps what a transport would send."""

    def __init__(self):
        self.out = []

    def send_json(self, code, body):
        self.out.append((code, json.loads(body)))

    def sse_start(self):
        self.out.append("start")

    def sse_send(self, data):
        self.out.extend(_sse(data))
        return True

    def sse_end(self):
        self.out.append("end")

    def cancelled(self):
        return False


@pytest.mark.parametrize("stream", [False, True])
def test_synthetic_path_matches_jax(engines, stream):
    """No tokenizer: message text hashed into ids (at most 512), tokens back
    as ids, the same through both packages' handle_request."""
    jeng, eng = engines
    js, ps = jserver.ServerState(jeng, None, "synthetic/tiny"), server.ServerState(
        eng, None, "synthetic/tiny")
    for text in SYNTHETIC:
        body = json.dumps({"messages": [{"role": "user", "content": text}],
                           "max_tokens": NEW, "temperature": 0.0, "stream": stream,
                           "logprobs": True}).encode()
        jw, pw = Recorder(), Recorder()
        jserver.handle_request(js, "POST", "/v1/chat/completions", body, jw)
        server.handle_request(ps, "POST", "/v1/chat/completions", body, pw)
        _same(pw.out, jw.out)
    long_text = "x" * 600
    assert server.prompt_ids(ps, [{"content": long_text}]) == [
        (7 + 31 * ord("x")) % (4096 - 2) + 1] * 512


def test_stop_matcher_unit():
    sm = server.StopMatcher(["END"])
    assert sm.push("hello E") == "hello "          # "E" held back (could start "END")
    assert sm.push("ND world") == "" and sm.stopped
    assert sm.flush() == ""
    sm2 = server.StopMatcher(["ZZZ"])
    assert sm2.push("abcZ") == "abc" and sm2.flush() == "Z"
    sm3 = server.StopMatcher(["xy", "bc"])
    assert sm3.push("abcxy") == "a" and sm3.stopped
    assert server.StopMatcher([]).push("anything") == "anything"
    assert server._parse_stops({"stop": "a"}) == ["a"]
    assert server._parse_stops({"stop": ["", 3, "b"] + ["c"] * 9}) == ["b"] + ["c"] * 5


def test_chat_client_streams_and_discovers(servers, monkeypatch, tmp_path):
    """stream_chat prints the served text; discover_server finds a server
    through the registry read at call time, and skips dead entries."""
    import io

    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path))
    assert chat.discover_server() is None
    (tmp_path / "servers").mkdir()
    (tmp_path / "servers" / "1.json").write_text(json.dumps({"port": 1}))
    path = server.register_server(servers["native"], "tiny")
    assert os.path.dirname(path) == str(tmp_path / "servers")
    url = chat.discover_server()
    assert url == f"http://127.0.0.1:{servers['native']}"
    out = io.StringIO()
    msgs = [{"role": "user", "content": PROMPTS[0]}]
    full = chat.stream_chat(url, msgs, max_tokens=NEW, temperature=0.0, out=out)
    jout = io.StringIO()
    jfull = jchat.stream_chat(f"http://127.0.0.1:{servers['jax']}", msgs, max_tokens=NEW,
                              temperature=0.0, out=jout)
    assert full == jfull and out.getvalue() == jout.getvalue() and full


@pytest.mark.parametrize("stream", [
    "<|channel|>analysis<|message|>let me think...<|end|><|start|>assistant"
    "<|channel|>final<|message|>Paris.",
    "plain text, no markup <|chan", "<think>hidden</think>shown <|return|> tail"])
def test_channel_filter_matches_reference(stream):
    for size in (1, 3, 7, len(stream)):
        f, jf = chat.ChannelFilter(), jchat.ChannelFilter()
        got = "".join(f.feed(stream[i:i + size]) for i in range(0, len(stream), size))
        want = "".join(jf.feed(stream[i:i + size]) for i in range(0, len(stream), size))
        assert got + f.flush() == want + jf.flush()


@pytest.mark.parametrize("flags,item", [
    (["--mesh", "1,8"], "A-10"),
    (["--offload", "experts"], "A-9"), (["--hot-experts", "4"], "A-9"),
    (["--spec-k", "2", "--mesh", "1,8"], "A-10"),
    (["--spec-mode", "mtp", "--offload", "experts"], "A-9")])
@pytest.mark.usefixtures("run_log_dir")
def test_main_raises_for_flags_not_ported(flags, item, monkeypatch, capsys):
    """The offload flags (A-9): main builds an OffloadEngine, with spec
    decoding off. --mesh (A-10): with --device cpu, main builds the engine
    over a 1 x 8 CPU mesh (the tiny model's 8 experts one a shard), which
    answers a request through the server's handler; --offload experts beside
    --mesh stays refused in the reference's words."""
    for name in ("KRASIS_TPU_SPEC_MODE", "KRASIS_TPU_SPEC_K", "KRASIS_TPU_NO_SPEC"):
        monkeypatch.setenv(name, "")        # main sets them: restored afterwards
        monkeypatch.delenv(name)
    if item == "A-10":
        from krasis_tpu_torch.parallel.mesh import OFFLOAD_MESH_ERROR

        seen = {}
        monkeypatch.setattr(server, "run_server",
                            lambda engine, *a, **kw: seen.update(engine=engine))
        assert server.main(["--synthetic", "tiny", "--device", "cpu", "--no-warmup",
                            *flags]) == 0
        eng = seen["engine"]
        assert eng.mesh.shape == {"dp": 1, "ep": 8} and eng.params["mesh"] is eng.mesh
        assert all(len(lp["_ep"]) == 8 for lp in eng.params["layers"])
        want = eng.generate([5, 6, 7], max_new_tokens=3, stop_ids={-1}).tokens
        httpd = server.start_temp_server(eng, None, "tiny", port=0, backend="python")
        try:
            status, _, body = _post(httpd.port, {"messages": [{"role": "user", "content": "hi"}],
                                                 "max_tokens": 3, "temperature": 0.0})
        finally:
            httpd.shutdown()
        assert status == 200 and json.loads(body)["usage"]["completion_tokens"] == 3
        assert len(want) == 3
        capsys.readouterr()
        with pytest.raises(SystemExit):
            server.main(["--synthetic", "tiny", "--device", "cpu", "--no-warmup", *flags,
                         "--offload", "experts"])
        assert OFFLOAD_MESH_ERROR in capsys.readouterr().err
        return
    if item == "A-9":
        from krasis_tpu_torch.runtime.offload_engine import OffloadEngine

        seen = {}
        monkeypatch.setattr(server, "run_server",
                            lambda engine, *a, **kw: seen.update(engine=engine))
        assert server.main(["--synthetic", "tiny", "--device", "cpu", "--no-warmup",
                            *flags]) == 0
        eng = seen["engine"]
        assert eng.spec_mode is None
        # --hot-experts alone keeps the model resident (--offload auto, on the CPU)
        assert isinstance(eng, OffloadEngine) == ("--offload" in flags)


@pytest.mark.usefixtures("run_log_dir")
def test_main_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        server.main(["--synthetic", "tiny", "--no-warmup"])


def test_native_backend_raises_and_auto_falls_back(engines, monkeypatch, caplog):
    from krasis_tpu_torch.native import serve as native_serve

    def broken():
        raise subprocess.CalledProcessError(1, ["g++"], stderr=b"serve.cpp: error: nope")
    monkeypatch.setattr(native_serve, "load", broken)
    _, eng = engines
    with pytest.raises(RuntimeError, match="did not build.*nope"):
        server.start_temp_server(eng, None, "tiny", port=0, backend="native")
    with caplog.at_level("WARNING", logger="krasis_tpu_torch.server"):
        httpd = server.start_temp_server(eng, None, "tiny", port=0, backend="auto")
    try:
        assert httpd.backend == "python"
        assert [r.message for r in caplog.records if "did not build" in r.message]
        assert _get(httpd.port, "/health")[0] == 200
    finally:
        httpd.shutdown()


def test_module_entry_point_serves_and_exits_cleanly(tmp_path):
    """python -m krasis_tpu_torch.server as a user runs it (on the CPU here):
    it registers, answers, and exits 0 on SIGTERM, removing its entry."""
    env = {**os.environ, "KRASIS_TPU_HOME": str(tmp_path), "PYTHONPATH": ROOT}
    proc = subprocess.Popen(
        [sys.executable, "-m", "krasis_tpu_torch.server", "--synthetic", "tiny", "--device",
         "cpu", "--port", "0", "--server-backend", "native", "--max-len", "512"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)     # the run log goes into the working directory
    try:
        reg = tmp_path / "servers"
        deadline = time.time() + 120
        while not (reg.exists() and list(reg.iterdir())) and time.time() < deadline:
            assert proc.poll() is None, proc.stdout.read()
            time.sleep(0.2)
        port = json.loads(next(reg.iterdir()).read_text())["port"]
        assert _get(port, "/health") == (200, {"status": "ok", "model": "synthetic/tiny"})
        status, _, body = _post(port, {"messages": [{"role": "user", "content": "hi"}],
                                       "max_tokens": 3, "temperature": 0.0})
        assert status == 200 and json.loads(body)["usage"]["completion_tokens"] == 3
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "[native transport]" in out and "warmup done" in out
    assert not list(reg.iterdir())
