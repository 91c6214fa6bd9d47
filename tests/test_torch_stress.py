"""The stress battery (krasis_tpu_torch/stress_test.py) against the
reference's krasis_tpu/stress_test.py.

The whole battery passes end to end on the tiny Qwen3-MoE, as
tests/test_stress.py runs the reference's: prompts, the sampling sweep
(greedy and seeded determinism), the contract edges (stop token,
near-max_len, long generation) and the scheduler's churn with a mid-stream
cancel, its scheduler on the parameters' device (the CPU here). The greedy
streams that the sweep and the contract edges ask for equal the JAX
engine's on the same weights (bridged, the expert stacks calmed by 1/8 on
both sides), token for token. These tiny models' logits are flat (the
smallest top-2 gap over the battery's greedy steps is 1e-5 to 5e-3 for most
weight seeds), so the weights' seed is one whose every greedy step keeps a
gap over 0.01, which a guard test holds."""

import json
import subprocess
import sys

import jax
import pytest
import torch

from krasis_tpu import stress_test as jstress
from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.config import preset_config as jax_preset_config
from krasis_tpu.models.params import init_synthetic_params as jax_init
from krasis_tpu.runtime.engine import Engine as JaxEngine
from krasis_tpu_torch import stress_test
from krasis_tpu_torch.config import QuantConfig, preset_config
from krasis_tpu_torch.models.synthetic import build_synthetic_engine, tiny_config
from krasis_tpu_torch.runtime.engine import Engine

from torch_port_util import port_params
from torch_spec_util import calm

QUANT = dict(expert_bits=4, group_size=32, kv_cache_dtype="bf16")
OVER = dict(hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            vocab_size=256, head_dim=16, n_routed_experts=8, num_experts_per_tok=2)
MAX_LEN = 192
SWEEP_NEW = 12
SEED = 28            # weights whose greedy steps keep a top-2 gap over MIN_GAP (seeds 0-29 scanned)
MIN_GAP = 0.01


def test_stress_battery_passes():
    cfg = tiny_config("qwen3-moe")
    quant = QuantConfig(**QUANT)
    engine = build_synthetic_engine(cfg, quant, max_len=1024, device="cpu")
    report = stress_test.run_all(engine, None, max_new_tokens=48,
                                 scheduler_cfg=(cfg, quant, engine.params))
    assert report["_summary"]["failed"] == [], report["_summary"]
    assert set(report) >= {"prompts", "sampling", "contracts", "scheduler", "_summary"}
    assert report["_summary"]["total"] >= 25
    assert report["scheduler"]["req1_cancelled"]["n"] < 32


def test_prompts_and_validation_are_the_reference_s():
    assert stress_test.PROMPT_KINDS == jstress.PROMPT_KINDS
    for toks in ([], [3] * 12, [3] * 11 + [4], list(range(40)), [1, 2] * 20):
        for run in (12, 20):
            assert stress_test.validate_tokens(toks, run) == jstress.validate_tokens(toks, run)


def test_prompt_seeds_do_not_change_between_processes():
    """The reference seeds a prompt with hash(name), which Python salts per
    process; the port's seed is the same in every process."""
    code = ("from krasis_tpu_torch.stress_test import PROMPT_KINDS, prompt_seed; "
            "print([prompt_seed(n) for n in PROMPT_KINDS])")
    outs = {subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           env={"PYTHONHASHSEED": str(s), "PATH": "/usr/bin:/bin",
                                "PYTHONPATH": ":".join(sys.path)}, check=True).stdout
            for s in (1, 2)}
    assert len(outs) == 1
    assert eval(outs.pop()) == [stress_test.prompt_seed(n) for n in stress_test.PROMPT_KINDS]


class Recorder:
    """An engine whose greedy generate calls are recorded: (prompt, new
    tokens, stop ids) → tokens."""

    def __init__(self, engine):
        self.engine, self.calls = engine, []

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def generate(self, ids, max_new_tokens=64, sampling=None, stop_ids=None, seed=0, **kw):
        res = self.engine.generate(ids, max_new_tokens=max_new_tokens, sampling=sampling,
                                   stop_ids=stop_ids, seed=seed, **kw)
        if sampling is not None and sampling.temperature == 0.0:
            self.calls.append((list(ids), max_new_tokens, sorted(stop_ids or ()),
                               list(res.tokens)))
        return res


@pytest.fixture(scope="module")
def engines():
    jcfg, jquant = jax_preset_config("qwen3-moe", **OVER), JaxQuantConfig(**QUANT)
    jparams = calm(jax_init(jcfg, jquant, jax.random.PRNGKey(SEED)))
    cfg, quant = preset_config("qwen3-moe", **OVER), QuantConfig(**QUANT)
    port = Engine(cfg, quant, port_params(jparams), max_len=MAX_LEN, device="cpu")
    return port, JaxEngine(jcfg, jquant, jparams, max_len=MAX_LEN)


def _battery(mod, engine):
    rec = Recorder(engine)
    sweep = mod.run_sampling_sweep(rec, None, n_tokens=SWEEP_NEW)
    edges = mod.run_contract_edges(rec, None)
    return rec.calls, sweep, edges


def test_greedy_streams_equal_the_jax_engine_s(engines):
    port, jeng = engines
    got, sweep, edges = _battery(stress_test, port)
    want, jsweep, jedges = _battery(jstress, jeng)
    assert [c[:3] for c in got] == [c[:3] for c in want]     # the same prompts asked
    assert len(got) == 6         # sweep: greedy x 3; edges: base, stop, near-max_len
    for (ids, _, _, toks), (_, _, _, jtoks) in zip(got, want):
        assert toks == jtoks, (len(ids), toks, jtoks)
    assert {k: v["ok"] for k, v in sweep.items()} == {k: v["ok"] for k, v in jsweep.items()}
    assert edges["stop_token"] == jedges["stop_token"] == {"ok": True, "issues": []}
    assert edges["near_max_len"] == jedges["near_max_len"]


def test_greedy_steps_are_free_of_near_ties(engines):
    """The guard: every greedy step of the compared streams keeps a top-2
    logit gap over MIN_GAP on the port, so bf16 rounding between the two
    packages cannot flip a token."""
    port, _ = engines
    calls, _, _ = _battery(stress_test, port)
    gap = float("inf")
    for ids, _, _, toks in calls:
        port.reset()
        with torch.inference_mode():
            logits = port._prefill_prompt(ids)
            for tok in toks:
                top = torch.topk(logits[0].float(), 2).values
                gap = min(gap, float(top[0] - top[1]))
                logits = port._forward(torch.tensor([[tok]]), torch.ones(1, dtype=torch.int32),
                                       prefill=False)
    assert gap > MIN_GAP, gap


def test_main_runs_the_battery_on_the_cpu_when_asked(capsys):
    assert stress_test.main(["--synthetic", "tiny", "--device", "cpu", "--max-new-tokens", "8",
                             "--slots", "4"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["_summary"]["failed"] == [] and "scheduler" in report


def test_main_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        stress_test.main(["--synthetic", "tiny"])
