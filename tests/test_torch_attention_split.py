"""The port's split-KV decode attention, its tile plans at both tile
heights, and the GPT-OSS activation of its fused expert kernels, each in
its plain PyTorch version against the JAX package on the same numpy inputs
(Pallas kernels in interpret mode, and the XLA attention path).

Tolerances: 2e-2 for attention, 3e-2 for the MoE kernels, as the
reference's own kernel tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.ops import flash_attention as jfa
from krasis_tpu.ops import gmm_pallas as jgp
from krasis_tpu.ops import moe_pallas as jmp
from krasis_tpu.ops.attention import attend, build_mask
from krasis_tpu.quant import random_qtensor as jrandom_qtensor
from krasis_tpu_torch.ops import flash_attention as tfa
from krasis_tpu_torch.ops import gmm_cuda, moe, moe_cuda

from torch_port_util import f32, t, tq

L, DR, DP = 512, 64, 640        # MLA: scores over L + DR lanes of DP, V = first L
SCALE = (128 + DR) ** -0.5


def _bf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


@pytest.mark.parametrize("S", [4096, 256, 64])
@pytest.mark.parametrize("Hkv,B", [(1, 1), (2, 1), (1, 2), (8, 4)])
def test_split_plan_covers_the_cache(S, Hkv, B):
    chunk, n = tfa.split_plan(S, Hkv, B)
    assert chunk % 64 == 0 and chunk >= 64
    spans = [(i * chunk, min((i + 1) * chunk, S)) for i in range(n)]
    assert spans[0][0] == 0 and spans[-1][1] == S
    assert all(a < b for a, b in spans)
    assert all(spans[i][1] == spans[i + 1][0] for i in range(n - 1))
    if S // 64 >= 2 * tfa.SMS // (Hkv * B):
        # long caches give about two CTAs per SM
        assert tfa.SMS <= n * Hkv * B <= 3 * tfa.SMS


def _mla_case(rng, B, S, q_std=1.0):
    q = np.zeros((B, 1, 16, DP), np.float32)
    q[..., :L + DR] = q_std * rng.standard_normal((B, 1, 16, L + DR))
    cache = np.zeros((B, 1, S, DP), np.float32)
    cache[..., :L + DR] = rng.standard_normal((B, 1, S, L + DR))
    return _bf16(q), _bf16(cache)


def _gqa_case(rng, B, S, d=128, q_std=1.0):
    q = _bf16(q_std * rng.standard_normal((B, 1, 16, d)))
    k = _bf16(rng.standard_normal((B, 2, S, d)))
    v = _bf16(rng.standard_normal((B, 2, S, d)))
    return q, k, v


def _xla_attention(q, k, v, kl, scale):
    """The reference's XLA path: attend over [B, S, Hkv, D] with the
    causal and kv_len mask of a decode step."""
    S = k.shape[2]
    mask = build_mask(kl[:, None] - 1, jnp.arange(S), kl)
    return attend(q, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3), mask, scale)


KV_LENS = {"ragged_300": [300], "below_one_chunk": [17], "two_rows": [300, 17]}


@pytest.mark.parametrize("lens", list(KV_LENS), ids=list(KV_LENS))
def test_split_decode_matches_jax_mla(lens):
    """MLA, V inside K: 16 heads on one [ckv; kpe] row, 576 real lanes of
    640; split + combine against decode_attention (interpret) and attend."""
    rng = np.random.default_rng(len(lens) * 7 + KV_LENS[lens][0])
    kl = jnp.asarray(KV_LENS[lens], jnp.int32)
    q, cache = _mla_case(rng, kl.shape[0], 512)
    chunk, n = tfa.split_plan(512, 1, kl.shape[0])
    assert n > 1 and max(KV_LENS[lens]) % chunk
    parts = tfa.decode_split_plain(t(q), t(cache), t(kl) - 1, t(kl), SCALE, L, chunk,
                                   qk_dim=L + DR)
    got = tfa._unstack(tfa.decode_combine_plain(*parts), 1)
    want = jfa.decode_attention(q, cache, None, kl, SCALE, v_from_k=True, v_dim=L,
                                interpret=True)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)
    xla = _xla_attention(q, cache, cache[..., :L], kl, SCALE)
    np.testing.assert_allclose(f32(got), f32(xla), rtol=2e-2, atol=2e-2)
    one = tfa.decode_attention(t(q), t(cache), t(kl), SCALE, L, qk_dim=L + DR)
    np.testing.assert_allclose(f32(one), f32(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("lens", list(KV_LENS), ids=list(KV_LENS))
def test_split_decode_matches_jax_gqa(lens):
    """GQA with a separate V buffer: 16 query heads on 2 kv heads (G = 8)."""
    rng = np.random.default_rng(len(lens) * 11 + KV_LENS[lens][0])
    kl = jnp.asarray(KV_LENS[lens], jnp.int32)
    q, k, v = _gqa_case(rng, kl.shape[0], 512)
    scale = 128 ** -0.5
    chunk, n = tfa.split_plan(512, 2, kl.shape[0])
    assert n > 1
    parts = tfa.decode_split_plain(t(q), t(k), t(kl) - 1, t(kl), scale, 128, chunk, t(v))
    got = tfa._unstack(tfa.decode_combine_plain(*parts), 1)
    want = jfa.decode_attention(q, k, v, kl, scale, interpret=True)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)
    xla = _xla_attention(q, k, v, kl, scale)
    np.testing.assert_allclose(f32(got), f32(xla), rtol=2e-2, atol=2e-2)


def _over_limit(got, want, tol):
    """Worst |got - want| / (tol * (|want| + rms(want))): ≤ 1 passes."""
    got, want = got.float(), want.float()
    rms = want.square().mean().sqrt()
    return float(((got - want).abs() / (tol * (want.abs() + rms))).max())


@pytest.mark.parametrize("family", ["mla", "gqa"])
def test_dropping_a_split_fails_the_check(family):
    """The element-wise check that holds the split form on the card must
    see a combine that lost one split: here the split holding each row's
    largest score, with peaked scores (std about 3) as on the card."""
    rng = np.random.default_rng(5)
    kl = torch.tensor([300])
    if family == "mla":
        q, cache = _mla_case(rng, 1, 512, q_std=3.0 / (SCALE * (L + DR) ** 0.5))
        args, scale, v, qk = (t(q), t(cache)), SCALE, None, L + DR
        dv = L
    else:
        q, k, vv = _gqa_case(rng, 1, 512, q_std=3.0)
        args, scale, v, qk, dv = (t(q), t(k)), 128 ** -0.5, t(vv), 128, 128
    chunk, _ = tfa.split_plan(512, args[1].shape[1], 1)
    o, m, l = tfa.decode_split_plain(*args, kl - 1, kl, scale, dv, chunk, v, qk)
    full = tfa.decode_combine_plain(o, m, l)
    want = tfa.flash_attention_plain(*args, kl - 1, kl, scale, dv, v, qk)
    assert _over_limit(tfa._unstack(full, 1), want, 2e-2) <= 1.0
    dropped = m.clone()
    top = m.argmax(dim=2, keepdim=True)
    dropped.scatter_(2, top, tfa.NEG_INF)
    assert _over_limit(tfa.decode_combine_plain(o, dropped, l), full, 2e-2) > 1.0


def test_empty_splits_weigh_nothing():
    """Splits past kv_len hold m = NEG_INF and l = 0: their O, whatever it
    holds, must not reach the result; a row that sees no key gives 0."""
    rng = np.random.default_rng(6)
    q, cache = _mla_case(rng, 1, 512)
    kl = torch.tensor([70])
    o, m, l = tfa.decode_split_plain(t(q), t(cache), kl - 1, kl, SCALE, L, 64,
                                     qk_dim=L + DR)
    assert bool((m[:, :, 2:] == tfa.NEG_INF).all()) and bool((l[:, :, 2:] == 0).all())
    noisy = o.clone()
    noisy[:, :, 2:] = float("nan")
    assert torch.equal(tfa.decode_combine_plain(noisy, m, l), tfa.decode_combine_plain(o, m, l))
    none = tfa.decode_combine_plain(o, torch.full_like(m, tfa.NEG_INF), torch.zeros_like(l))
    assert not none.float().any()


E, HD, I = 8, 256, 128


def _experts(seed, bits, e=E):
    k13, k2 = jax.random.split(jax.random.PRNGKey(seed))
    mag = 0.03 if bits == 4 else 0.002
    return (jrandom_qtensor(k13, (e, HD, 2 * I), bits, group_size=128, scale_mag=mag),
            jrandom_qtensor(k2, (e, I, HD), bits, group_size=128, scale_mag=mag))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("tm", [128, 64])
def test_plan_tiles_at_both_heights_match_jax_gmm(tm, bits):
    """A tm-row plan through gmm_plain against gmm13_fused, gmm2_fused and
    gmm (interpret) on the same tile rows."""
    rng = np.random.default_rng(tm + bits)
    w13, w2 = _experts(tm + bits, bits)
    T, k = 96, 2
    x = _bf16(rng.standard_normal((T, HD)) * 0.5)
    idx = torch.from_numpy(np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32))
    plan = gmm_cuda.plan_tiles(idx, E, tm)
    assert plan.tm == tm and plan.n_tiles == T * k // tm + E + 1
    Mp = plan.n_tiles * tm
    live = plan.tile_valid.bool().repeat_interleave(tm).numpy()
    x_tiles = gmm_cuda._tile_rows(t(x), plan.row_src)
    j_args = (jnp.asarray(plan.tile_e.numpy()), jnp.asarray(plan.tile_valid.numpy()))
    jx = jnp.asarray(f32(x_tiles), jnp.float32).astype(jnp.bfloat16)

    a = gmm_cuda.gmm_plain(t(x), plan.row_src, tq(w13), plan, True)
    want = jgp.gmm13_fused(jx, w13, *j_args, interpret=True, tm=tm)[:Mp]
    np.testing.assert_allclose(f32(a)[live], f32(want)[live], rtol=3e-2, atol=3e-2)
    o = gmm_cuda.gmm_plain(a, None, tq(w2), plan, False)
    want = jgp.gmm2_fused(_bf16(f32(a)), w2, *j_args, interpret=True, tm=tm)[:Mp]
    np.testing.assert_allclose(f32(o)[live], f32(want)[live], rtol=3e-2, atol=3e-2)
    h = gmm_cuda.gmm_plain(t(x), plan.row_src, tq(w13), plan, False)
    want = jgp.gmm(jx, w13, *j_args, interpret=True, tm=tm)[:Mp]
    np.testing.assert_allclose(f32(h)[live], f32(want)[live], rtol=3e-2, atol=3e-2)


def test_choose_tm_follows_rows_per_expert():
    """V2-Lite at 2048 tokens (6 picks of 66) gets 128-row tiles; the
    hybrid (10 picks of 513) and short prompts keep 64."""
    assert gmm_cuda.choose_tm(2048 * 6, 66) == 128
    assert gmm_cuda.choose_tm(2048 * 10, 513) == 64
    assert gmm_cuda.choose_tm(128 * 6, 66) == 64


LIMIT = 7.0


def _gpt_oss_case(seed, bits, T):
    rng = np.random.default_rng(seed)
    w13, w2 = _experts(seed, bits, e=10)
    x = _bf16(rng.standard_normal((T, HD)) * 4.0)
    idx = np.stack([rng.permutation(10)[:4] for _ in range(T)]).astype(np.int32)
    wts = rng.uniform(0.1, 1.0, (T, 4)).astype(np.float32)
    return w13, w2, x, jnp.asarray(idx), jnp.asarray(wts)


def _clamps(x, w13):
    """Share of the gate and up values that the clamp at LIMIT moves."""
    h = moe_cuda.gathered_qmm_plain(t(x), tq(w13), torch.zeros(x.shape[0], dtype=torch.int32))
    return float((h.abs() > LIMIT).float().mean())


@pytest.mark.parametrize("bits", [4, 8])
def test_gpt_oss_fused_decode_int8_matches_pallas(bits):
    """K3's plain version with the GPT-OSS activation against
    moe_gathered_w4a8_pallas (interpret)."""
    w13, w2, x, idx, wts = _gpt_oss_case(50 + bits, bits, 2)
    assert _clamps(x, w13) > 0.05
    want = jmp.moe_gathered_w4a8_pallas(x, w13, w2, idx, wts, swiglu_limit=LIMIT,
                                        gpt_oss=True, interpret=True)
    got = moe_cuda.moe_w4a8(t(x), tq(w13), tq(w2), t(idx), t(wts), LIMIT, True)
    np.testing.assert_allclose(f32(got), f32(want), rtol=3e-2, atol=3e-2)
    plain = moe_cuda.moe_w4a8(t(x), tq(w13), tq(w2), t(idx), t(wts))
    assert not torch.equal(got, plain)


@pytest.mark.parametrize("bits", [4, 8])
def test_gpt_oss_fused_decode_bf16_matches_pallas(bits):
    """K5's plain version with the GPT-OSS activation against
    moe_gathered_pallas (interpret)."""
    w13, w2, x, idx, wts = _gpt_oss_case(60 + bits, bits, 2)
    want = jmp.moe_gathered_pallas(x, w13, w2, idx, wts, swiglu_limit=LIMIT, gpt_oss=True,
                                   interpret=True)
    got = moe_cuda.moe_bf16(t(x), tq(w13), tq(w2), t(idx), t(wts), LIMIT, True)
    np.testing.assert_allclose(f32(got), f32(want), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("bits", [4, 8])
def test_gpt_oss_fused_grouped_matches_pallas(bits):
    """K4's plain SwiGLU epilogue in the GPT-OSS form against gmm13_fused
    (interpret) on one plan, and the whole grouped MoE against
    moe_prefill_pallas."""
    w13, w2, x, idx, wts = _gpt_oss_case(70 + bits, bits, 64)
    plan = gmm_cuda.plan_tiles(t(idx), 10)
    live = plan.tile_valid.bool().repeat_interleave(plan.tm).numpy()
    x_tiles = gmm_cuda._tile_rows(t(x), plan.row_src)
    a = gmm_cuda.gmm_plain(t(x), plan.row_src, tq(w13), plan, True, LIMIT, True)
    want = jgp.gmm13_fused(jnp.asarray(f32(x_tiles)).astype(jnp.bfloat16), w13,
                           jnp.asarray(plan.tile_e.numpy()),
                           jnp.asarray(plan.tile_valid.numpy()), swiglu_limit=LIMIT,
                           gpt_oss=True, interpret=True, tm=plan.tm)[:plan.n_tiles * plan.tm]
    np.testing.assert_allclose(f32(a)[live], f32(want)[live], rtol=3e-2, atol=3e-2)
    got = moe.moe_forward(t(x), tq(w13), tq(w2), t(idx), t(wts), swiglu_limit=LIMIT,
                          gpt_oss=True)
    want = jgp.moe_prefill_pallas(x, w13, w2, idx, wts, swiglu_limit=LIMIT, gpt_oss=True,
                                  interpret=True)
    np.testing.assert_allclose(f32(got), f32(want), rtol=3e-2, atol=3e-2)
