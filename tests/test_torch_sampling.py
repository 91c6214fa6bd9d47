"""`sample_batched` against the JAX package's on the same numpy inputs:
greedy rows equal, and each sampled row draws from the same support — the
tokens that the reference's definition keeps (presence penalty,
temperature, top min(max_top_k, V), the row's top_k, the nucleus under
top_p), recomputed here in numpy. The two packages draw with different
generators, so draws are compared with the support, not with each other."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from krasis_tpu.ops.sampling import sample_batched as jsample_batched
from krasis_tpu_torch.ops.sampling import sample_batched

B, V, MAX_TOP_K = 4, 1000, 64
TEMP = np.array([0.0, 0.7, 1.3, 0.7], np.float32)
TOP_P = np.full(B, 0.9, np.float32)
TOP_K = np.array([0, 0, 20, 20], np.int32)
PENALTY = np.full(B, 4.0, np.float32)


def _inputs():
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal((B, V)) * 2.5).astype(np.float32)
    seen = rng.random((B, V)) < 0.05
    seen[np.arange(B), logits.argmax(-1)] = True        # the penalty moves each row's top
    return logits, seen


def _support(logits, seen, row, top_k=TOP_K):
    """The reference's kept tokens of one row, and the smallest kept
    probability and the nucleus's margin (how far the kept cumulative
    sums sit from top_p)."""
    z = logits[row].astype(np.float64) - PENALTY[row] * seen[row]
    z = z / max(float(TEMP[row]), 1e-6)
    kk = min(MAX_TOP_K, V)
    order = np.argsort(-z, kind="stable")[:kk]
    vals = z[order]
    per_row = kk if top_k[row] <= 0 else min(int(top_k[row]), kk)
    vals = np.where(np.arange(kk) < per_row, vals, -np.inf)
    p = np.exp(vals - vals.max())
    p /= p.sum()
    excl = np.cumsum(p) - p
    keep = excl < TOP_P[row]
    margin = float(np.abs(excl[:per_row] - TOP_P[row]).min())
    return set(order[keep].tolist()), float(p[keep].min() / p[keep].sum()), margin


def _jax_args(logits, seen):
    return (jnp.asarray(logits), jnp.asarray(TEMP), jnp.asarray(TOP_P), jnp.asarray(PENALTY),
            jnp.asarray(seen), jnp.asarray(TOP_K))


def _torch_args(logits, seen):
    return (torch.from_numpy(logits), torch.from_numpy(TEMP), torch.from_numpy(TOP_P),
            torch.from_numpy(PENALTY), torch.from_numpy(seen), torch.from_numpy(TOP_K))


def test_greedy_rows_match_jax():
    logits, seen = _inputs()
    want = np.asarray(jsample_batched(jax.random.PRNGKey(0), *_jax_args(logits, seen),
                                      max_top_k=MAX_TOP_K))
    gen = torch.Generator().manual_seed(0)
    got = sample_batched(*_torch_args(logits, seen), max_top_k=MAX_TOP_K, generator=gen).numpy()
    assert got[0] == want[0]
    # the penalty moved the greedy token off the raw maximum
    assert got[0] != logits[0].argmax()
    # with every temperature at 0, every row is the penalised argmax
    zero = torch.zeros(B)
    args = list(_torch_args(logits, seen))
    args[1] = zero
    greedy = sample_batched(*args, max_top_k=MAX_TOP_K, generator=gen).numpy()
    jargs = list(_jax_args(logits, seen))
    jargs[1] = jnp.zeros(B)
    np.testing.assert_array_equal(
        greedy, np.asarray(jsample_batched(jax.random.PRNGKey(1), *jargs, max_top_k=MAX_TOP_K)))


def test_sampled_rows_draw_from_the_reference_support():
    logits, seen = _inputs()
    n = 4000
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    jargs = _jax_args(logits, seen)
    jdraws = np.asarray(jax.vmap(
        lambda k: jsample_batched(k, *jargs, max_top_k=MAX_TOP_K))(keys))      # [n, B]
    targs = _torch_args(logits, seen)
    reps = 20
    tiled = [a.repeat(reps, *([1] * (a.dim() - 1))) for a in targs]
    tdraws = np.concatenate([
        sample_batched(*tiled, max_top_k=MAX_TOP_K,
                       generator=torch.Generator().manual_seed(seed)).numpy().reshape(reps, B)
        for seed in range(n // reps)])                                          # [n, B]
    for row in range(1, B):
        support, p_min, margin = _support(logits, seen, row)
        # the seeded data keeps the check meaningful: several kept tokens,
        # each likely enough to appear in n draws, and no cumulative sum
        # within f32 rounding of top_p
        assert len(support) >= 3 and p_min * n > 20 and margin > 1e-4, (row, p_min, margin)
        assert set(jdraws[:, row].tolist()) == support, row
        assert set(tdraws[:, row].tolist()) == support, row
    # the rank mask matters: rows 2 and 3 would keep more tokens without it
    for row in (2, 3):
        assert len(_support(logits, seen, row, np.zeros(B, np.int32))[0]) > 20
