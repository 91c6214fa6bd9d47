"""quality.main --spec-only (krasis_tpu_torch/quality.py) against the
reference's (krasis_tpu/quality.py main): the spec-exactness rows of the
first seed's checkpoint (built if absent, the MTP head trained if absent)
spliced into that seed's newest saved matrix, the other matrices left as
they are, and QUALITY.md rewritten from each seed's newest matrix, the same
files as the reference's for the same saved matrices and the same spec
rows. The checkpoint, the MTP training and the spec run are stand-ins here
(tests/test_torch_quality.py runs them)."""

import json
import sys

import pytest

from krasis_tpu import quality as jquality
from krasis_tpu_torch import quality

SPEC = {"ngram": {"exact": True, "tokens": 144, "verdict": "accept"},
        "mtp": {"exact": True, "tokens": 144, "checkpoint": "trained", "verdict": "accept"}}


def _matrix(seed, delta, spec=None):
    res = {"checkpoint_meta": {"key": "qw3moe-tiny", "seed": seed, "steps": 30,
                               "tail_ppl_torch": 11.5, "holdout_ppl_torch": 14.25},
           "eval_tokens": 3000, "group_size": 32, "unpaired_noise_floor": 0.0125,
           "modes": {"bf16": {"shapes": {"prefill": {"ppl": 11.5}}, "verdict": "baseline"},
                     "q4": {"shapes": {"prefill": {"ppl": 11.5 * (1 + delta)}}, "base": "bf16",
                            "worst_delta": delta, "worst_ci95": [delta / 2, delta * 2],
                            "tolerance": 0.05, "verdict": "accept"}}}
    if spec is not None:
        res["spec"] = spec
    return res


SAVED = {"matrix_s0_20260101_000000.json": _matrix(0, 0.01),
         "matrix_s0_20260102_000000.json": _matrix(0, 0.02, {"ngram": {
             "exact": False, "tokens": 9, "verdict": "REJECT"}}),
         "matrix_s1_20260101_000000.json": _matrix(1, 0.03)}


def _run(mod, monkeypatch, out, main):
    for name, text in SAVED.items():
        (out / name).write_text(json.dumps(text, indent=2))
    calls = []
    monkeypatch.setattr(mod, "build_quality_checkpoint",
                        lambda **kw: calls.append(("build", kw)) or str(out / "ckpt"))
    monkeypatch.setattr(mod, "train_mtp_head", lambda ckpt, **kw: calls.append(("mtp", ckpt)))
    monkeypatch.setattr(mod, "run_spec_exactness",
                        lambda ckpt, **kw: calls.append(("spec", ckpt, kw)) or dict(SPEC))
    main()
    files = {p.name: p.read_text() for p in sorted(out.iterdir())}
    return calls, files


@pytest.mark.parametrize("seeds", [["0", "1"], ["1"]])
def test_spec_only_splices_as_the_reference_does(monkeypatch, tmp_path, capsys, seeds):
    argv = ["--spec-only", "--steps", "30", "--group-size", "32", "--seeds", *seeds]
    ref, port = tmp_path / "ref", tmp_path / "port"
    ref.mkdir(), port.mkdir()
    monkeypatch.setattr(sys, "argv", ["quality", *argv, "--out", str(ref)])
    want_calls, want = _run(jquality, monkeypatch, ref, jquality.main)
    got_calls, got = _run(quality, monkeypatch, port,
                          lambda: quality.main([*argv, "--out", str(port), "--device", "cpu"]))
    assert got == want
    first = f"matrix_s{seeds[0]}_" + ("20260102_000000.json" if seeds[0] == "0"
                                      else "20260101_000000.json")
    assert json.loads(got[first])["spec"] == SPEC
    for name in SAVED:
        if name != first:
            assert json.loads(got[name]) == SAVED[name]          # untouched
    assert "## Speculative decoding exactness" in got["QUALITY.md"]
    assert [c[0] for c in got_calls] == [c[0] for c in want_calls] == ["build", "mtp", "spec"]
    assert got_calls[0][1]["steps"] == 30 and got_calls[0][1]["seed"] == int(seeds[0])
    assert got_calls[0][1]["device"] == "cpu" and got_calls[2][2]["group_size"] == 32
    assert "wrote" in capsys.readouterr().out


def test_spec_only_without_a_saved_matrix_writes_no_table(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(quality, "build_quality_checkpoint", lambda **kw: "ckpt")
    monkeypatch.setattr(quality, "train_mtp_head", lambda ckpt, **kw: calls.append(ckpt))
    monkeypatch.setattr(quality, "run_spec_exactness", lambda ckpt, **kw: dict(SPEC))
    quality.main(["--spec-only", "--seeds", "0", "--out", str(tmp_path), "--device", "cpu"])
    assert calls == ["ckpt"] and list(tmp_path.iterdir()) == []
