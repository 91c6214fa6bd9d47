"""The port's continuous-batching scheduler on a dp × ep mesh, on the CPU;
mirrors ``tests/test_scheduler_mesh.py``.

Admission, slot insert, the batched decode block with the slots split over
dp (each group's rows on its own devices) and mid-stream cancellation,
held exactly against the single-sequence Engine on the same mesh (its one
slot runs on dp group 0 at the shapes each scheduler group runs: one row).
The mesh's devices are all the CPU (``devices=["cpu"] * 8``).
"""

import time

import jax
import pytest

from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.config import preset_config as jax_preset_config
from krasis_tpu.models.params import init_synthetic_params as jax_init
from krasis_tpu_torch.config import QuantConfig, preset_config
from krasis_tpu_torch.ops.sampling import SamplingParams
from krasis_tpu_torch.parallel.mesh import make_mesh, shard_params
from krasis_tpu_torch.runtime.engine import Engine
from krasis_tpu_torch.runtime.scheduler import BatchScheduler

from torch_port_util import port_params
from torch_spec_util import calm, spec_env

GREEDY = SamplingParams(temperature=0.0)
TIMEOUT = 120
# tests/test_scheduler_mesh.py's setup
OVER = dict(hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
            num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
            vocab_size=256, head_dim=16, n_routed_experts=8, num_experts_per_tok=2)
QUANT = dict(expert_bits=4, group_size=32, kv_cache_dtype="bf16")


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_preset_config("qwen3-moe", **OVER)
    jparams = calm(jax_init(jcfg, JaxQuantConfig(**QUANT), jax.random.PRNGKey(0)))
    cfg, quant = preset_config("qwen3-moe", **OVER), QuantConfig(**QUANT)
    mesh = make_mesh(8, dp=2, devices=["cpu"] * 8)
    return cfg, quant, shard_params(port_params(jparams), cfg, mesh), mesh


def _drain(req):
    toks = []
    while True:
        tok = req.out_queue.get(timeout=TIMEOUT)
        if tok is None:
            assert req.error is None, req.error
            return toks
        toks.append(tok)


def test_scheduler_on_dp_ep_mesh_matches_mesh_engine(setup):
    """2 slots (one a dp group), 3 queued requests (slot churn), dp 2 × ep 4:
    every stream equals its solo greedy run through the Engine on the same
    mesh."""
    cfg, quant, params, mesh = setup
    assert mesh.shape == {"dp": 2, "ep": 4}
    prompts = [[10 + i, 20 + i, 30 + i, 40 + i] for i in range(3)]
    with spec_env("off"):
        meng = Engine(cfg, quant, params, max_len=256, mesh=mesh)
        want = [meng.generate(p, max_new_tokens=6, sampling=GREEDY, stop_ids={-1}).tokens
                for p in prompts]
        sched = BatchScheduler(cfg, quant, params, max_len=256, num_slots=2, mesh=mesh,
                               decode_block=4)
    try:
        assert "dp" in sched.decode_cache and "dp" not in sched.prefill_cache
        reqs = [sched.submit(p, max_new_tokens=6, sampling=GREEDY, stop_ids={-1})
                for p in prompts]
        outs = [_drain(r) for r in reqs]
    finally:
        sched.shutdown()
    assert outs == want


def test_mid_stream_cancel_on_mesh_frees_slot(setup):
    """Cancel a stream mid-decode on the mesh: it ends well short of its
    length, and a later request in the freed slot is still exact."""
    cfg, quant, params, mesh = setup
    with spec_env("off"):
        meng = Engine(cfg, quant, params, max_len=256, mesh=mesh)
        want = meng.generate([7, 8, 9], max_new_tokens=5, sampling=GREEDY,
                             stop_ids={-1}).tokens
        sched = BatchScheduler(cfg, quant, params, max_len=256, num_slots=2, mesh=mesh,
                               decode_block=2)
    try:
        victim = sched.submit([1, 2, 3], max_new_tokens=200, sampling=GREEDY, stop_ids={-1})
        got = [victim.out_queue.get(timeout=TIMEOUT) for _ in range(2)]
        assert all(tok is not None for tok in got)
        victim.cancelled.set()
        deadline, tail = time.time() + TIMEOUT, []
        while time.time() < deadline:
            tok = victim.out_queue.get(timeout=TIMEOUT)
            if tok is None:
                break
            tail.append(tok)
        assert len(tail) < 150, "cancellation ignored"
        follow = sched.submit([7, 8, 9], max_new_tokens=5, sampling=GREEDY, stop_ids={-1})
        assert _drain(follow) == want
    finally:
        sched.shutdown()


@pytest.mark.parametrize("mode,name", [("ngram", "qwen3-moe"), ("ngram", "hybrid"),
                                       ("mtp", "v2-lite")])
def test_spec_scheduler_on_dp_ep_mesh_matches_mesh_engine(mode, name):
    """Speculative decoding through the scheduler with the slots split over
    dp 2 × ep 2: prompt lookup on the GQA model and the hybrid (its DeltaNet
    state committed group by group, its GQA attention by head) and the
    V2-Lite's MTP drafts (the MTP module's cache split over dp as well) give
    the mesh Engine's vanilla greedy streams."""
    import torch_spec_util as su

    cfg, quant, params = su.Models().port(name)
    mesh = make_mesh(4, dp=2, devices=["cpu"] * 4)
    prompts = [su.prompt(seed) for seed in su.SEEDS[name][:2]]
    with spec_env("off"):
        meng = Engine(cfg, quant, params, max_len=256, mesh=mesh)
        want = [meng.generate(p, max_new_tokens=6, sampling=GREEDY, stop_ids={-1}).tokens
                for p in prompts]
    with spec_env(mode, 2):
        sched = BatchScheduler(cfg, quant, meng.params, max_len=256, num_slots=2, mesh=mesh,
                               decode_block=2)
    try:
        assert sched.spec_mode == mode and "dp" in sched.decode_cache
        if mode == "mtp":
            assert "dp" in sched.mtp_decode_cache
        outs = [_drain(sched.submit(p, max_new_tokens=6, sampling=GREEDY, stop_ids={-1}))
                for p in prompts]
        assert sched.stats_spec["steps"] > 0
    finally:
        sched.shutdown()
    assert outs == want
