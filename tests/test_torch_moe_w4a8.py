"""K3, the W4A8 decode MoE (``moe_cuda.moe_w4a8``), and K6a, which runs on
K3's core, on the CPU.

Its plain version against the Pallas kernel it replaces
(``moe_gathered_w4a8_pallas``, interpret mode) on the same numpy inputs,
by the reference's own measure for that kernel (tests/test_pallas.py
``test_moe_gathered_w4a8_matches_ref``: max |Δ| under 3e-2 of the output's
largest value; requantization rounds a few hidden values the other way
where the two frameworks' f32 arithmetic differs in the last bit); the
launch plan of the CUDA kernels (``plan_w4a8``) at V2-Lite's and the
hybrid's shapes; and a plain emulation of the kernels' reduction order —
each cluster rank's int32 dots over its units, summed over the ranks, then
the f32 sums in group and pick order — against the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.ops.moe_pallas import moe_gathered_w4a8_pallas
from krasis_tpu.quant import random_qtensor as jrandom_qtensor
from krasis_tpu_torch.ops import moe_cuda
from krasis_tpu_torch.ops.activations import swiglu
from krasis_tpu_torch.quant import QTensor, unpack

from torch_port_util import f32, t, tq

LIMIT = 7.0
V2LITE = dict(k=8, H=2048, I=1408)     # 6 routed + 2 folded shared experts
HYBRID = dict(k=11, H=2048, I=512)     # 10 routed + 1 folded shared expert


def _case(seed, bits, gs, T, I, H=256, E=10, routed=4, virtual=2, x_std=0.5):
    """Stacks of E experts (the last `virtual` are folded shared experts,
    picked by every token with weight 1); at T > 1 token 1 repeats token 0's
    first routed expert."""
    rng = np.random.default_rng(seed)
    k13, k2 = jax.random.split(jax.random.PRNGKey(seed))
    w13 = jrandom_qtensor(k13, (E, H, 2 * I), bits, group_size=gs, scale_mag=0.03)
    w2 = jrandom_qtensor(k2, (E, I, H), bits, group_size=gs, scale_mag=0.03)
    x = jnp.asarray(rng.standard_normal((T, H)) * x_std, jnp.float32).astype(jnp.bfloat16)
    n_r = E - virtual
    routed_idx = np.stack([rng.permutation(n_r)[:routed] for _ in range(T)])
    if T > 1:
        routed_idx[1, -1] = routed_idx[0, 0]
    idx = np.concatenate([routed_idx, np.tile(np.arange(n_r, E), (T, 1))], 1).astype(np.int32)
    wts = np.concatenate([rng.uniform(0.05, 0.4, (T, routed)), np.ones((T, virtual))], 1)
    return x, w13, w2, jnp.asarray(idx), jnp.asarray(wts, jnp.float32)


# (bits, gs, T, gpt_oss, I): I = 384 at gs 128 halves into 1.5 groups, as
# V2-Lite's w2 (K/2 = 704 = 5.5 groups)
CASES = [(4, 128, 1, False, 128), (8, 128, 1, False, 128), (4, 32, 5, False, 128),
         (8, 32, 5, True, 128), (4, 128, 5, True, 384), (8, 128, 5, False, 384),
         (4, 32, 1, True, 384), (4, 128, 1, False, 384)]


@pytest.mark.parametrize("bits,gs,T,gpt_oss,I", CASES)
def test_moe_w4a8_plain_matches_pallas(bits, gs, T, gpt_oss, I):
    """GPT-OSS's form at inputs that put part of h past the clamp, as
    tests/test_torch_attention_split.py's K3 case does."""
    x, w13, w2, idx, wts = _case(40 + bits + gs + T + I, bits, gs, T, I,
                                 x_std=4.0 if gpt_oss and bits == 4 else 0.5)
    limit = LIMIT if gpt_oss else 0.0
    if gpt_oss:
        h = moe_cuda.gathered_qmm_plain(t(x), tq(w13), torch.zeros(T, dtype=torch.int32))
        assert float((h.abs() > LIMIT).float().mean()) > 0.05
    want = moe_gathered_w4a8_pallas(x, w13, w2, idx, wts, swiglu_limit=limit, gpt_oss=gpt_oss,
                                     interpret=True)
    got = moe_cuda.moe_w4a8(t(x), tq(w13), tq(w2), t(idx), t(wts), limit, gpt_oss)
    assert got.dtype == torch.bfloat16 and got.shape == (T, w13.k_dim)
    got, want = f32(got), f32(want)
    assert np.abs(got - want).max() / (np.abs(want).max() + 1e-9) < 3e-2


def _rows(plan_stage, packed_rows, z):
    """(pick, packed row) of rank z's units."""
    u0, u1 = plan_stage.unit_range(z)
    nb = packed_rows // moe_cuda.UNIT
    return [(u // nb, (u % nb) * moe_cuda.UNIT + r) for u in range(u0, u1)
            for r in range(moe_cuda.UNIT)]


def _check_stage(st, picks, K, N, bits, gs, cols_of_tile, tiles):
    """Every (pick, column, element row) once; every unit in one group per
    nibble half; the pieces of each group (rank, half) tile its rows."""
    packed = K // 2 if bits == 4 else K
    half = K // 2 if bits == 4 else 0
    assert st.ks in (1, 2, 4, 8) and st.ks <= st.units == picks * packed // moe_cuda.UNIT
    cols = np.zeros(N, np.int64)
    for tile in range(tiles):
        cols[cols_of_tile(tile)] += 1
    assert (cols == 1).all()
    seen = np.zeros((picks, K), np.int64)
    pieces = {}
    for z in range(st.ks):
        rows = _rows(st, packed, z)
        for j, r in rows:
            for h in ((0, 1) if bits == 4 else (0,)):
                e = r + h * half
                seen[j, e] += 1
                pieces.setdefault((j, e // gs), set()).add((z, h))
        u0, u1 = st.unit_range(z)
        for u in range(u0, u1):
            r0 = (u % (packed // moe_cuda.UNIT)) * moe_cuda.UNIT
            for h in ((0, 1) if bits == 4 else (0,)):
                assert (r0 + h * half) // gs == (r0 + h * half + moe_cuda.UNIT - 1) // gs
    assert (seen == 1).all()
    return pieces


@pytest.mark.parametrize("shape", [V2LITE, HYBRID], ids=["v2lite", "hybrid"])
@pytest.mark.parametrize("T", [1, 5])
def test_plan_covers_each_pick_column_and_row_once(shape, T):
    k, H, I = shape["k"], shape["H"], shape["I"]
    plan = moe_cuda.plan_w4a8(T, k, H, I, 4, 128, 128)
    s1, s2 = plan.w13, plan.w2
    assert s1.grid[1] == T * k and s2.grid[1] == T
    na = s1.cols // 2
    _check_stage(s1, 1, H, 2 * I, 4, 128,
                 lambda tl: np.r_[tl * na:(tl + 1) * na, I + tl * na:I + (tl + 1) * na],
                 s1.grid[0])
    pieces = _check_stage(s2, k, I, H, 4, 128,
                          lambda tl: np.arange(tl * s2.cols, (tl + 1) * s2.cols), s2.grid[0])
    if I % 256:
        # V2-Lite's w2: group 5 of every pick lies in both nibble halves,
        # so its int32 dot is whole only once the halves are added
        straddle = I // 2 // 128
        assert all({h for _, h in pieces[(j, straddle)]} == {0, 1} for j in range(k))
    if T == 1:
        assert s1.ctas >= 264 and s2.ctas >= 264


@pytest.mark.parametrize("bits", [4, 8])
def test_plan_at_main_path_sizes(bits):
    """Every T the dispatch sends to the gathered path (V2-Lite up to 6-7
    tokens, the hybrid up to 34-38) gets a plan whose shared memory fits."""
    for shape, ts in ((V2LITE, range(1, 8)), (HYBRID, range(1, 39))):
        for k in (shape["k"], shape["k"] - 1 - (shape is V2LITE)):
            for T in ts:
                p = moe_cuda.plan_w4a8(T, k, shape["H"], shape["I"], bits, 128, 128)
                for stage, st in ((1, p.w13), (2, p.w2)):
                    assert moe_cuda.k3_smem(stage, st, k, shape["H"], shape["I"], bits,
                                            128) <= moe_cuda.MAX_SMEM
                    assert st.ks in (1, 2, 4, 8)


def _partials(xq, w_i8, st, packed, bits, gs, picks_of):
    """int32 dots [picks, G, N] of each rank's units, summed over the ranks
    in int32 (any order: integer sums are exact)."""
    K, N = w_i8.shape[1], w_i8.shape[2]
    half = K // 2 if bits == 4 else 0
    total = np.zeros((w_i8.shape[0], K // gs, N), np.int64)
    for z in range(st.ks):
        part = np.zeros_like(total)
        for j, r in _rows(st, packed, z):
            for h in ((0, 1) if bits == 4 else (0,)):
                e = r + h * half
                part[j, e // gs] += xq[picks_of(j), e].astype(np.int64) * w_i8[j, e]
        assert np.abs(part).max() < 2 ** 31
        total += part
    return total


def _ordered(d, s_act, s_w):
    """acc = acc + (d * sx) * sw over the groups in order, in f32."""
    acc = np.zeros(d.shape[::2], np.float32)
    for g in range(d.shape[1]):
        acc = acc + (d[:, g].astype(np.float32) * s_act[:, g:g + 1]) * s_w[:, g]
    return acc


@pytest.mark.parametrize("bits,gs,I,T", [(4, 128, 384, 1), (4, 128, 384, 3), (8, 32, 128, 2)])
def test_emulated_reduction_order_equals_plain(bits, gs, I, T):
    """The kernels' order, step by step on the plan: each rank's int32 group
    dots over its units (a group cut between ranks or nibble halves added in
    int32 first), the f32 sums in group order, SwiGLU on the f32 h, the
    hidden requantized, the picks summed in order; against moe_w4a8_plain."""
    x, w13, w2, idx, wts = _case(70 + bits + I + T, bits, gs, T, I)
    x, w13, w2, idx, wts = t(x), tq(w13), tq(w2), t(idx).long(), t(wts)
    Tn, H = x.shape
    k = idx.shape[1]
    plan = moe_cuda.plan_w4a8(Tn, k, H, I, bits, gs, gs)
    assert plan.w13.ks > 1 and plan.w2.ks > 1
    xq, sx = moe_cuda.quantize_activations(x, gs)
    e = idx.reshape(-1)
    w13_i8, w2_i8 = unpack(w13[e]).numpy(), unpack(w2[e]).numpy()
    P = Tn * k
    h = np.zeros((P, 2 * I), np.float32)
    for p in range(P):       # stage 1: a cluster per pick (and column tile)
        d = _partials(xq.numpy(), w13_i8[p:p + 1], plan.w13, w13.q.shape[-2], bits, gs,
                      lambda j: p // k)
        h[p] = _ordered(d, sx.numpy()[p // k:p // k + 1], w13.scales[e[p]].float().numpy()[None])
    a = swiglu(torch.from_numpy(h))
    aq, sa = moe_cuda.quantize_activations(a, gs)
    out = np.zeros((Tn, H), np.float32)
    for tok in range(Tn):    # stage 2: a cluster per token (and column tile)
        rows = slice(tok * k, (tok + 1) * k)
        d = _partials(aq.numpy(), w2_i8[rows], plan.w2, w2.q.shape[-2], bits, gs,
                      lambda j: tok * k + j)
        o = _ordered(d, sa.numpy()[rows], w2.scales[e[rows]].float().numpy())
        acc = np.zeros(H, np.float32)
        for j in range(k):
            acc = acc + o[j] * wts.numpy()[tok, j]
        out[tok] = acc
    want = moe_cuda.moe_w4a8_plain(x, w13, w2, idx.to(torch.int32), wts).float().numpy()
    got = torch.from_numpy(out).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_k3_declines_groups_that_cut_units():
    """K3 dots a 32-row unit whole, or as two 16-row halves for groups of a
    multiple of 16 that is not one of 32 (its G16 form). Groups that are
    not a multiple of 16 (here 8) would cut a half: the predicate and the
    plan refuse them, while K5, which reads a scale per row, takes them.
    Groups of 16 are taken and planned."""
    def stack(gs):
        return QTensor(torch.zeros((2, 128, 256), dtype=torch.int8),
                       torch.ones((2, 256 // gs, 256), dtype=torch.bfloat16), 4, gs)

    w2 = QTensor(torch.zeros((2, 64, 256), dtype=torch.int8),
                 torch.ones((2, 4, 256), dtype=torch.bfloat16), 4, 32)
    assert moe_cuda.supported(stack(8), w2) and not moe_cuda.w4a8_supported(stack(8), w2)
    with pytest.raises(ValueError):
        moe_cuda.plan_w4a8(1, 2, 256, 128, 4, 8, 32)
    assert moe_cuda.w4a8_supported(stack(16), w2)
    assert moe_cuda.plan_w4a8(1, 2, 256, 128, 4, 16, 32).w13.ks >= 1


@pytest.mark.parametrize("bits,gs,T,gpt_oss,I", [(8, 128, 3, False, 384), (4, 128, 2, True, 384),
                                                 (8, 32, 1, True, 128), (4, 32, 4, False, 128)])
def test_int8_chain_plain_equals_k3_plain(bits, gs, T, gpt_oss, I):
    """The two classes of int8 decode round at the same points (group dots
    in int32, f32 sums in group order, the activation on the f32 h, the
    hidden requantized, the picks weighted in f32 and added in order): the
    plain chain equals K3's plain version bit for bit, and under pick_valid
    equals it with the skipped picks' weights set to 0."""
    x, w13, w2, idx, wts = _case(90 + bits + gs + T, bits, gs, T, I,
                                 x_std=4.0 if gpt_oss else 0.5)
    x, w13, w2, idx, wts = t(x), tq(w13), tq(w2), t(idx), t(wts)
    limit = LIMIT if gpt_oss else 0.0
    k = idx.shape[1]
    pv = torch.ones((T, k), dtype=torch.bool)
    pv[0, 1] = pv[T - 1, k - 1] = False          # a routed pick and a folded shared expert
    for mask in (None, pv):
        got = moe_cuda.moe_gathered_tiled(x, w13, w2, idx, wts, limit, gpt_oss, mask, "int8")
        want = moe_cuda.moe_w4a8_plain(x, w13, w2, idx, wts if mask is None else wts * mask,
                                       limit, gpt_oss)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert not torch.equal(got, moe_cuda.moe_w4a8_plain(x, w13, w2, idx, wts, limit, gpt_oss))


Q8 = dict(k=8, H=2048, I=1408)     # V2-Lite's int8 experts: 6 routed + 2 folded shared


@pytest.mark.parametrize("T,ctas", [(1, (352, 512)), (2, (352, 512)), (6, (1056, 384))])
def test_k6a_plan_at_q8_shapes(T, ctas):
    """K6a's chain at V2-Lite Q8's shapes (int8, groups of 128) takes K3's
    plan: shared memory within 227 KB, every (pick, column, row) once, and
    at T = 1 stage 1 at 128 columns in clusters of 2 (22 x 8 x 2 CTAs),
    stage 2 at 32 columns in clusters of 8 (64 x 1 x 8); the product form's
    plans at the same widths fit too."""
    k, H, I = Q8["k"], Q8["H"], Q8["I"]
    plan = moe_cuda.plan_w4a8(T, k, H, I, 8, 128, 128)
    s1, s2 = plan.w13, plan.w2
    assert (s1.ctas, s2.ctas) == ctas
    if T == 1:
        assert s1.grid == (22, 8, 2) and s1.cols == 128 and s2.grid == (64, 1, 8) and s2.cols == 32
    for stage, st in ((1, s1), (2, s2)):
        assert moe_cuda.k3_smem(stage, st, k, H, I, 8, 128) <= moe_cuda.MAX_SMEM
    na = s1.cols // 2
    _check_stage(s1, 1, H, 2 * I, 8, 128,
                 lambda tl: np.r_[tl * na:(tl + 1) * na, I + tl * na:I + (tl + 1) * na],
                 s1.grid[0])
    _check_stage(s2, k, I, H, 8, 128,
                 lambda tl: np.arange(tl * s2.cols, (tl + 1) * s2.cols), s2.grid[0])
    for K, N in ((H, 2 * I), (I, H)):
        p = moe_cuda.plan_gq_a8(T * k, K, N, 8, 128)
        assert p.grid[1] == T * k and 2 * p.ctas >= 5 * moe_cuda.SMS
        assert moe_cuda.k3_smem(1, p, 1, K, 0, 8, 128) <= moe_cuda.MAX_SMEM
        _check_stage(p, 1, K, N, 8, 128, lambda tl: np.arange(tl * p.cols, (tl + 1) * p.cols),
                     p.grid[0])
