"""K7 with a partial last column CTA and the biased grouped form, on the CPU
against the JAX package:

* ``gmm_plain`` (K7's plain version) at widths with a 64-column tail
  (N % 128 == 64), int4 and int8, groups of 32 and 16, on 64- and 128-row
  plans, against JAX ``quant.dequantize`` and an f32 product (2e-2, the
  reference's qmm tolerance);
* ``moe_forward`` on biased stacks in the grouped regime (GPT-OSS's prefill
  experts: form "ragged", ``gmm_cuda.moe_prefill`` with the biases, here on
  K7's plain version) against JAX ``moe_forward`` (its plain
  ``moe_forward_ragged``) with the same seeded nonzero biases (3e-2, the
  reference's MoE tolerance), with and without ``pick_valid``, with a
  control (the port's plain ``moe_forward_ragged`` without the w13 bias)
  that must fail that limit;
* the dispatch: a biased grouped call makes exactly two K7 calls and no
  plain route, as does an unbiased stack that the reference's grouped
  kernels decline; unquantized stacks keep the plain form;
* a tiny GPT-OSS whose experts K7 takes (I = 64; w2 is one 64-column CTA)
  through ``Engine.generate`` against the JAX engine: identical greedy
  streams, its prefill on the new form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.config import preset_config as jax_preset_config
from krasis_tpu.models.synthetic import build_synthetic_engine as jax_build
from krasis_tpu.ops import moe as jmoe
from krasis_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from krasis_tpu.quant import dequantize as jdequantize
from krasis_tpu.quant import random_qtensor as jrandom_qtensor
from krasis_tpu_torch.config import preset_config
from krasis_tpu_torch.ops import gmm_cuda, moe
from krasis_tpu_torch.runtime.engine import Engine

from torch_port_util import GPTOSS_TINY, f32, gptoss_quants, port_params, randomize_gptoss, t, tq

TOL_QMM = 2e-2
TOL_MOE = 3e-2


def _bf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def _stack(seed, e, k, n, bits, gs):
    return jrandom_qtensor(jax.random.PRNGKey(seed), (e, k, n), bits, group_size=gs,
                           scale_mag=0.03 if bits == 4 else 0.002)


def _picks(rng, T, E, k):
    return np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)


# T of each plan height at E = 4, k = 2: choose_tm gives 128 rows once
# T·k ≥ 128·E
ROWS = {64: 40, 128: 256}


@pytest.mark.parametrize("tm", [64, 128])
@pytest.mark.parametrize("gs", [32, 16])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("N", [320, 192])
def test_gmm_plain_at_column_tails(N, bits, gs, tm):
    E, K, k, T = 4, 256, 2, ROWS[tm]
    rng = np.random.default_rng(N + bits + gs + tm)
    w = _stack(N + gs, E, K, N, bits, gs)
    x = _bf16(rng.standard_normal((T, K)) * 0.5)
    idx = _picks(rng, T, E, k)
    plan = gmm_cuda.plan_tiles(t(idx), E, gmm_cuda.choose_tm(T * k, E))
    assert plan.tm == tm and N % gmm_cuda.cta_cols(tm) == 64
    assert gmm_cuda.gmm_supported(tq(w))
    got = gmm_cuda.gmm_plain(t(x), plan.row_src, tq(w), plan, False)
    assert got.dtype == torch.float32 and tuple(got.shape) == (plan.n_tiles * tm, N)
    wd = np.asarray(jdequantize(w, jnp.bfloat16), np.float32)            # [E, K, N]
    xs = np.asarray(x, np.float32)
    dest = plan.dest.numpy()
    want = np.einsum("mk,mkn->mn", xs[np.repeat(np.arange(T), k)], wd[idx.reshape(-1)])
    np.testing.assert_allclose(f32(got)[dest], want, rtol=TOL_QMM, atol=TOL_QMM)


# (bits, gs, H, I): H = 320 gives w2 a 64-column tail; int8 at I = 96 gives
# w13 (2I = 192 columns) one too, int4 at I = 192 takes whole w13 CTAs (a
# K7 step is 32 packed rows, so int4 needs I % 64 == 0)
STACKS = {"int4_gs32": (4, 32, 320, 192), "int4_gs16": (4, 16, 320, 192),
          "int8_gs32": (8, 32, 320, 96), "int8_gs16": (8, 16, 320, 96)}


def _biased_case(name, tm, seed, masked=False, E=4, k=2):
    """Biased stacks with seeded nonzero biases about the size of h and of a
    pick's output; gate and up values past GPT-OSS's clamp."""
    bits, gs, H, I = STACKS[name]
    T = ROWS[tm]
    rng = np.random.default_rng(seed)
    w13 = _stack(seed, E, H, 2 * I, bits, gs)
    w2 = _stack(seed + 1, E, I, H, bits, gs)
    x = _bf16(rng.standard_normal((T, H)) * 2.0)
    idx = _picks(rng, T, E, k)
    wts = rng.dirichlet(np.ones(k), T).astype(np.float32)
    valid = None
    if masked:
        valid = rng.random((T, k)) > 0.25
        wts = wts * valid
    b13 = _bf16(rng.standard_normal((E, 2 * I)) * 0.5)
    b2 = _bf16(rng.standard_normal((E, H)) * 0.5)
    return w13, w2, x, idx, wts, valid, b13, b2


# every stack at both plan heights, each height with and without pick_valid
# for int4 and for int8
CASES = [("int4_gs32", 64, False), ("int4_gs32", 128, True), ("int4_gs16", 64, True),
         ("int4_gs16", 128, False), ("int8_gs32", 64, False), ("int8_gs32", 128, True),
         ("int8_gs16", 64, True), ("int8_gs16", 128, False)]


@pytest.mark.parametrize("stacks,tm,masked", CASES,
                         ids=[f"{s}-{tm}-{'pick_valid' if m else 'all'}" for s, tm, m in CASES])
def test_biased_grouped_form_matches_the_reference(stacks, tm, masked):
    """moe_forward on biased stacks in the grouped regime takes the "ragged"
    form (K7's two calls, the biases between, on its plain version here)
    and no plain route; it is within 3e-2 of the reference's moe_forward,
    which sends biased experts to its plain moe_forward_ragged. The plain
    ragged form without the w13 bias is not."""
    w13, w2, x, idx, wts, valid, b13, b2 = _biased_case(stacks, tm, 70 + tm + masked)
    pw13, pw2 = tq(w13), tq(w2)
    assert moe.route(t(x), pw13, pw2, t(idx), True) == "ragged"
    assert gmm_cuda.choose_tm(idx.size, 4) == tm
    moe.plain_routes.update(ragged_plain=0, gathered_plain=0)
    args = (t(x), pw13, pw2, t(idx), t(wts), 7.0, True)
    got = f32(moe.moe_forward(*args, w13_bias=t(b13), w2_bias=t(b2),
                              pick_valid=None if valid is None else t(valid)))
    assert moe.plain_routes == {"ragged_plain": 0, "gathered_plain": 0}
    want = f32(jmoe.moe_forward(x, w13, w2, jnp.asarray(idx), jnp.asarray(wts), swiglu_limit=7.0,
                                gpt_oss=True, w13_bias=b13, w2_bias=b2,
                                pick_valid=None if valid is None else jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, rtol=TOL_MOE, atol=TOL_MOE)
    dropped = f32(moe.moe_forward_ragged(*args, w2_bias=t(b2)))
    assert not np.allclose(dropped, want, rtol=TOL_MOE, atol=TOL_MOE)


def _count_two_stage(monkeypatch):
    calls = []
    real = gmm_cuda.gmm_two_stage

    def counted(*a, **kw):
        calls.append(a[2].n_dim)
        return real(*a, **kw)

    monkeypatch.setattr(gmm_cuda, "gmm_two_stage", counted)
    return calls


@pytest.mark.parametrize("case", ["biased", "unbiased_tail", "unquantized"])
def test_grouped_dispatch(monkeypatch, case):
    """A biased grouped call, and an unbiased one on stacks whose 320
    columns the reference's grouped kernels decline (not whole 128-lane
    tiles), make exactly two K7 calls and no plain route; stacks that are
    not quantized keep the plain moe_forward_ragged ("ragged_plain")."""
    calls = _count_two_stage(monkeypatch)
    ragged = []
    real = moe.moe_forward_ragged
    monkeypatch.setattr(moe, "moe_forward_ragged",
                        lambda *a, **kw: ragged.append(1) or real(*a, **kw))
    w13, w2, x, idx, wts, _, b13, b2 = _biased_case("int4_gs32", 64, 90)
    pw13, pw2 = tq(w13), tq(w2)
    bias = dict(w13_bias=t(b13), w2_bias=t(b2))
    if case == "unbiased_tail":
        bias = {}
    elif case == "unquantized":
        pw13 = t(jdequantize(w13, jnp.bfloat16))
        pw2 = t(jdequantize(w2, jnp.bfloat16))
    moe.plain_routes.update(ragged_plain=0, gathered_plain=0)
    form = moe.route(t(x), pw13, pw2, t(idx), bool(bias))
    got = moe.moe_forward(t(x), pw13, pw2, t(idx), t(wts), 7.0, True, **bias)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    if case == "unquantized":
        assert form == "ragged_plain" and not calls and ragged == [1]
        assert moe.plain_routes == {"ragged_plain": 1, "gathered_plain": 0}
    else:
        assert form == "ragged" and calls == [pw13.n_dim, pw2.n_dim] and not ragged
        assert moe.plain_routes == {"ragged_plain": 0, "gathered_plain": 0}


# the tiny GPT-OSS of tests/test_model.py with I = 64: w13 [8, 64, 128] and
# w2 [8, 64, 64] (one 64-column CTA), which K7 takes; at I = 32 w2 has 16
# packed int4 rows, under a K7 step, and prefill keeps the plain form
TINY_K7 = dict(GPTOSS_TINY, intermediate_size=64, moe_intermediate_size=64)


def test_tiny_gptoss_prefill_on_k7_matches_jax_engine(monkeypatch):
    """A 200-token prompt in chunks of 128, then 8 greedy tokens: each
    prefill chunk's MoE takes the "ragged" form (two K7 calls a layer, no
    plain route), decode the gathered one; the stream equals the JAX
    engine's (its Pallas kernels in interpret mode)."""
    monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")
    jquant, quant = gptoss_quants("bf16")
    jeng = jax_build(jax_preset_config("gpt-oss-20b", **TINY_K7), jquant, max_len=512, seed=0)
    jeng.params = randomize_gptoss(jeng.params, seed=2)
    jeng.chunk = 128
    eng = Engine(preset_config("gpt-oss-20b", **TINY_K7), quant, port_params(jeng.params),
                 max_len=512, device="cpu")
    eng.chunk = 128
    prompt = np.random.default_rng(26).integers(1, 256, size=200).tolist()
    want = jeng.generate(prompt, max_new_tokens=8, stop_ids={-1},
                         sampling=JaxSamplingParams(temperature=0.0))
    calls = _count_two_stage(monkeypatch)
    moe.plain_routes.update(ragged_plain=0, gathered_plain=0)
    got = eng.generate(prompt, max_new_tokens=8, stop_ids={-1})
    assert moe.plain_routes == {"ragged_plain": 0, "gathered_plain": 0}
    assert len(calls) == 2 * 2 * eng.cfg.num_hidden_layers       # two chunks
    assert got.finite and got.tokens == want.tokens
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=5e-2)
    # no greedy step sits within the logit tolerance of a tie
    eng.reset(512)
    gaps = []
    with torch.inference_mode():
        logits = eng._prefill_prompt(prompt)
        for tok in want.tokens:
            top = torch.topk(logits[0], 2).values
            gaps.append(float(top[0] - top[1]))
            logits = eng._forward(torch.tensor([[tok]]), torch.ones(1, dtype=torch.int32),
                                  prefill=False)
    assert min(gaps) > TOL_QMM
