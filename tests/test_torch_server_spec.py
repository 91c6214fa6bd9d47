"""The port's server with speculative decoding on the CPU: ``--spec-mode`` /
``--spec-k`` set the engine's and the scheduler's spec mode and depth (the
reference's environment names), flags still not ported are still refused
beside them, and a served greedy request through a spec engine answers the
vanilla text with the verify steps' counts under ``timing.spec``.

The engines are the tiny configurations of ``torch_spec_util`` (synthetic:
no tokenizer, the message text hashed into ids, the answer the token ids)."""

import http.client
import json

import pytest

from krasis_tpu_torch import server

from torch_port_util import run_log_dir  # noqa: F401
from torch_spec_util import Models, min_top2_gap

# synthetic messages whose greedy steps keep a top-two gap over 0.02
MESSAGES = {"v2-lite": "multi token prediction", "hybrid": "token history"}
NEW = 10


@pytest.fixture(scope="module")
def models():
    return Models()


def _post(port, obj, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/chat/completions", json.dumps(obj),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    out = r.status, json.loads(r.read())
    conn.close()
    return out


@pytest.mark.parametrize("flags,mode,k", [
    (["--spec-mode", "ngram", "--spec-k", "3"], "ngram", 3),
    (["--spec-mode", "ngram"], "ngram", 3),
    (["--spec-mode", "ngram", "--spec-k", "0"], None, 1),
    (["--spec-mode", "mtp"], None, 1),          # the tiny preset has no MTP module
    (["--spec-k", "2"], None, 2)])
@pytest.mark.parametrize("slots", [0, 2])
@pytest.mark.usefixtures("run_log_dir")
def test_main_accepts_spec_flags(monkeypatch, flags, mode, k, slots):
    """The flags reach the engine and the scheduler through the reference's
    environment names; serving itself is replaced by a stand-in."""
    for name in ("KRASIS_TPU_SPEC_MODE", "KRASIS_TPU_SPEC_K", "KRASIS_TPU_NO_SPEC"):
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)
    seen = {}

    def serve(engine, tok, name, host, port, backend="auto", scheduler=None):
        seen.update(engine=engine, scheduler=scheduler)
    monkeypatch.setattr(server, "run_server", serve)
    assert server.main(["--synthetic", "tiny", "--device", "cpu", "--no-warmup",
                        "--slots", str(slots), *flags]) == 0
    eng, sch = seen["engine"], seen["scheduler"]
    assert (eng.spec_mode, eng.spec_k) == (mode, k)
    if slots:
        assert (sch.spec_mode, sch.spec_k) == (mode, k)
        sch.shutdown()
    else:
        assert sch is None


@pytest.mark.parametrize("flags,item", [
    (["--spec-mode", "ngram", "--spec-k", "3", "--mesh", "1,8"], "A-10"),
    (["--spec-mode", "ngram", "--offload", "experts"], "A-9")])
@pytest.mark.usefixtures("run_log_dir")
def test_spec_flags_with_flags_not_ported_raise(flags, item, monkeypatch):
    """Under --offload experts (A-9) spec decoding is off, as in the
    reference. Under --mesh (A-10, a 1 x 8 CPU mesh here) it stays on: the
    engine's prompt-lookup stream equals its vanilla one."""
    for name in ("KRASIS_TPU_SPEC_MODE", "KRASIS_TPU_SPEC_K", "KRASIS_TPU_NO_SPEC"):
        monkeypatch.setenv(name, "")        # main sets them: restored afterwards
        monkeypatch.delenv(name)
    seen = {}
    monkeypatch.setattr(server, "run_server",
                        lambda engine, *a, **kw: seen.update(engine=engine))
    assert server.main(["--synthetic", "tiny", "--device", "cpu", "--no-warmup",
                        *flags]) == 0
    eng = seen["engine"]
    if item == "A-9":
        assert eng.offload is not None
        assert (eng.spec_mode, eng.spec_available) == (None, False)
        return
    assert eng.mesh.shape == {"dp": 1, "ep": 8} and (eng.spec_mode, eng.spec_k) == ("ngram", 3)
    ids = [9, 10, 11, 9, 10, 11, 9, 10]
    spec = eng.generate(ids, max_new_tokens=8, stop_ids={-1}).tokens
    eng.spec_available = False
    assert spec == eng.generate(ids, max_new_tokens=8, stop_ids={-1}).tokens


@pytest.mark.parametrize("name,mode", [("v2-lite", "mtp"), ("hybrid", "ngram")])
def test_spec_request_answers_the_vanilla_text(models, name, mode):
    """The same greedy request with spec decoding on and off: the same text
    and tokens, `timing.spec` counting every token on the spec request and
    absent from the vanilla one."""
    eng = models.engine(name, mode=mode, k=3)
    httpd = server.start_temp_server(eng, None, f"tiny/{name}", port=0, backend="python")
    body = {"messages": [{"role": "user", "content": MESSAGES[name]}], "max_tokens": NEW,
            "temperature": 0.0}
    try:
        status, spec = _post(httpd.port, body)
        eng.spec_available = False
        status2, vanilla = _post(httpd.port, body)
    finally:
        eng.spec_available = True
        httpd.shutdown()
    assert status == status2 == 200
    text = spec["choices"][0]["message"]["content"]
    assert text == vanilla["choices"][0]["message"]["content"]
    assert spec["usage"]["completion_tokens"] == NEW
    assert spec["timing"]["spec"]["emitted"] == NEW and spec["timing"]["spec"]["steps"] >= 1
    assert "spec" not in vanilla["timing"]
    ids = server.prompt_ids(server.ServerState(eng, None, "x", None), body["messages"])
    assert min_top2_gap(eng, ids, [int(x) for x in text.split()]) > 0.02
