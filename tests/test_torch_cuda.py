"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes. Skipped where there is no CUDA device; on a machine with
one (which need not have jax):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from krasis_tpu_torch.config import QuantConfig
from krasis_tpu_torch.device import set_exact_matmul_flags
from krasis_tpu_torch.models.synthetic import build_synthetic_engine, tiny_config
from krasis_tpu_torch.ops import flash_attention as fa
from krasis_tpu_torch.ops import expert_class, gmm_cuda, moe_cuda, probes_cuda, qmm_cuda
from krasis_tpu_torch.quant import (QTensor, pack_int4, quantize, random_qtensor,
                                    stack_leading)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_exact_matmul_flags()
    return torch.device("cuda")


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _close(got, want, tol):
    """|got - want| <= tol * (|want| + rms(want)), element by element."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    diff = (got - want).abs()
    limit = tol * (want.abs() + want.square().mean().sqrt())
    assert bool((diff <= limit).all()), float((diff / limit).max())


def _one_launch_each(fn, counter):
    """Two calls: bit-equal results, one count each on the wrapper's
    counter `counter` (module, attribute)."""
    before = getattr(*counter)
    a = fn()
    b = fn()
    assert getattr(*counter) == before + 2
    assert torch.equal(a, b)
    return a


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("N", [64, 384, 388])
@pytest.mark.parametrize("T", [1, 4, 8, 13, 16])
def test_qmm_kernel(dev, bits, T, N):
    """N = 388 is the tail form (4-column copies: N % 16 != 0)."""
    g = _gen(dev, T + bits + N)
    qt = quantize(torch.randn((512, N), generator=g, device=dev) * 0.05, bits, 128)
    x = torch.randn((T, 512), generator=g, device=dev).to(torch.bfloat16)
    got = _one_launch_each(lambda: qmm_cuda.qmm(x, qt, torch.float32), (qmm_cuda, "launches"))
    _close(got, qmm_cuda.qmm_plain(x, qt, torch.float32), 2e-2)
    _close(qmm_cuda.qmm(x, qt), qmm_cuda.qmm_plain(x, qt), 2e-2)          # bf16 out


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("T,N", [(1, 384), (5, 384), (1, 64), (4, 64), (16, 64), (1, 388),
                                 (4, 388), (16, 388), (16, 384)])
def test_qmm_stacked_kernel(dev, bits, T, N):
    """Layers of a [12, K(/2), N] stack, read in place, layer 11 included;
    N = 64 is the narrow ba_proj case (half a block of columns), N = 388
    the tail form."""
    g = _gen(dev, 7 * T + bits + N)
    stack = stack_leading([quantize(torch.randn((512, N), generator=g, device=dev) * 0.05,
                                    bits, 128) for _ in range(12)], 0)
    x = torch.randn((T, 512), generator=g, device=dev).to(torch.bfloat16)
    for layer in (0, 5, 11):
        got = _one_launch_each(lambda: qmm_cuda.qmm_stacked(x, stack, layer, torch.float32),
                               (qmm_cuda, "launches_stacked"))
        _close(got, qmm_cuda.qmm_plain(x, stack[layer], torch.float32), 2e-2)


@pytest.mark.parametrize("K,N,bits,gs", [(1408, 256, 4, 128), (2064, 128, 4, 16),
                                         (10944, 128, 8, 64), (4096, 2048, 8, 128)])
@pytest.mark.parametrize("T", [1, 16])
def test_qmm_kernel_group_edges(dev, K, N, bits, gs, T):
    """Group boundaries inside a split or a 16-row step: int4's K/2 not a
    multiple of the group (1408), K/2 at half a 16-row step past a group
    boundary (2064, gs 16), gs 64 with 171 groups (V2-Lite's dense w2), and
    o_proj's shape with 8 splits."""
    g = _gen(dev, K + T)
    qt = quantize(torch.randn((K, N), generator=g, device=dev) * 0.05, bits, gs)
    assert qt.group_size == gs
    x = torch.randn((T, K), generator=g, device=dev).to(torch.bfloat16)
    got = _one_launch_each(lambda: qmm_cuda.qmm(x, qt, torch.float32), (qmm_cuda, "launches"))
    _close(got, qmm_cuda.qmm_plain(x, qt, torch.float32), 2e-2)


@pytest.mark.parametrize("bits", [4, 8])
def test_qmm_kernel_unaligned_x(dev, bits):
    """x starting 2 bytes past a 16-byte boundary takes the kernel's
    element-by-element x copy."""
    g = _gen(dev, 99 + bits)
    qt = quantize(torch.randn((1024, 384), generator=g, device=dev) * 0.05, bits, 128)
    buf = torch.randn((3 * 1024 + 1,), generator=g, device=dev).to(torch.bfloat16)
    x = buf[1:].view(3, 1024)
    assert x.data_ptr() % 16
    _close(qmm_cuda.qmm(x, qt, torch.float32), qmm_cuda.qmm_plain(x, qt, torch.float32), 2e-2)


def test_qmm_one_device_kernel_a_call(dev):
    """At a split shape (o_proj, 8 splits), a call is one device kernel: the
    split sums meet on the chip, and no sum or cast launch follows."""
    from torch.profiler import ProfilerActivity, profile, schedule

    g = _gen(dev, 5)
    qt = quantize(torch.randn((4096, 2048), generator=g, device=dev) * 0.05, 8, 128)
    x = torch.randn((1, 4096), generator=g, device=dev).to(torch.bfloat16)
    assert qmm_cuda.plan(1, 4096, 2048, 8, 128).ks > 1
    qmm_cuda.qmm(x, qt)
    torch.cuda.synchronize()
    for _ in range(3):              # the tracer at times records nothing: take it again
        # the second step is recorded; the first warms the tracer up
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for _ in range(2):
                for _ in range(5):
                    qmm_cuda.qmm(x, qt)
                torch.cuda.synchronize()
                prof.step()
        kernels = [(e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    assert len(kernels) == 1 and "qmm" in kernels[0][0] and kernels[0][1] == 5, kernels


@pytest.mark.parametrize("sq,q_off,kv_len", [(200, 0, 200), (100, 128, 228), (1, 300, 301),
                                             (40, 0, 17)])
@pytest.mark.parametrize("d,dp", [(256, 256), (32, 128)])
def test_attention_kernel_separate_v(dev, sq, q_off, kv_len, d, dp):
    """GQA: 8 query heads on 2 kv heads, K and V in two lane-padded buffers."""
    g = _gen(dev, sq + d)
    Hq, Hkv = 8, 2
    q = torch.zeros((1, sq, Hq, dp), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((1, Hkv, 512, dp), dtype=torch.bfloat16, device=dev)
    v = torch.zeros_like(k)
    q[..., :d] = torch.randn((1, sq, Hq, d), generator=g, device=dev).to(torch.bfloat16)
    k[..., :d] = torch.randn((1, Hkv, 512, d), generator=g, device=dev).to(torch.bfloat16)
    v[..., :d] = torch.randn((1, Hkv, 512, d), generator=g, device=dev).to(torch.bfloat16)
    qo = torch.tensor([q_off], device=dev)
    kl = torch.tensor([kv_len], device=dev)
    _close(fa.flash_attention(q, k, qo, kl, d ** -0.5, d, v=v),
           fa.flash_attention_plain(q, k, qo, kl, d ** -0.5, d, v=v), 2e-2)


@pytest.mark.parametrize("sq,q_off,kv_len", [(200, 0, 200), (100, 128, 228), (1, 300, 301),
                                             (40, 0, 17)])
def test_attention_kernel(dev, sq, q_off, kv_len):
    g = _gen(dev, sq)
    H, D, L = 4, 640, 512
    q = torch.randn((1, sq, H, D), generator=g, device=dev).to(torch.bfloat16)
    kv = torch.randn((1, 1, 512, D), generator=g, device=dev).to(torch.bfloat16)
    qo = torch.tensor([q_off], device=dev)
    kl = torch.tensor([kv_len], device=dev)
    _close(fa.flash_attention(q, kv, qo, kl, 0.07, L),
           fa.flash_attention_plain(q, kv, qo, kl, 0.07, L), 2e-2)


def _experts(dev, E, H, I, seed):
    g = _gen(dev, seed)
    return (random_qtensor((E, H, 2 * I), 4, 128, g, dev, scale_mag=0.03),
            random_qtensor((E, I, H), 4, 128, g, dev, scale_mag=0.03), g)


def test_moe_decode_kernel(dev):
    w13, w2, g = _experts(dev, 10, 256, 128, 1)
    x = torch.randn((2, 256), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.tensor([[0, 3, 5, 8, 9], [7, 1, 2, 8, 9]], dtype=torch.int32, device=dev)
    wts = torch.rand((2, 5), generator=g, device=dev)
    _close(moe_cuda.moe_w4a8(x, w13, w2, idx, wts),
           moe_cuda.moe_w4a8_plain(x, w13, w2, idx, wts), 3e-2)


def _k3_case(dev, seed, T, k, H, I, bits=4, gs=128, E=12, virtual=2):
    """K3's inputs at a model's widths: k picks a token, the last `virtual`
    of them folded shared experts with weight 1, and at T > 1 token 1
    repeating token 0's first expert."""
    g = _gen(dev, seed)
    w13 = random_qtensor((E, H, 2 * I), bits, gs, g, dev, scale_mag=0.03)
    w2 = random_qtensor((E, I, H), bits, gs, g, dev, scale_mag=0.03)
    x = torch.randn((T, H), generator=g, device=dev).to(torch.bfloat16)
    routed = torch.stack([torch.randperm(E - virtual, generator=g, device=dev)[:k - virtual]
                          for _ in range(T)])
    if T > 1:
        routed[1, -1] = routed[0, 0]
    virt = torch.arange(E - virtual, E, device=dev).expand(T, virtual)
    idx = torch.cat([routed, virt], dim=1).to(torch.int32)
    wts = torch.cat([torch.rand((T, k - virtual), generator=g, device=dev) * 0.3,
                     torch.ones((T, virtual), device=dev)], dim=1)
    return x, w13, w2, idx, wts


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("shape", [(8, 2048, 1408, 2), (11, 2048, 512, 1)],
                         ids=["v2lite", "hybrid"])
def test_moe_w4a8_kernel_at_main_path_shapes(dev, shape, T):
    """K3 at V2-Lite's (I = 1408: w2's groups cut by the nibble halves) and
    the hybrid's widths: within 3e-2 of its plain version, two calls equal
    bit for bit, two launches a call."""
    k, H, I, virtual = shape
    x, w13, w2, idx, wts = _k3_case(dev, 20 + T + k, T, k, H, I, virtual=virtual)
    before = moe_cuda.launches
    got = moe_cuda.moe_w4a8(x, w13, w2, idx, wts)
    assert torch.equal(got, moe_cuda.moe_w4a8(x, w13, w2, idx, wts))
    assert moe_cuda.launches == before + 4
    assert got.dtype == torch.bfloat16 and got.shape == (T, H)
    _close(got, moe_cuda.moe_w4a8_plain(x, w13, w2, idx, wts), 3e-2)


@pytest.mark.parametrize("bits,gs,gpt_oss", [(8, 128, False), (4, 32, True), (8, 32, True)])
def test_moe_w4a8_kernel_forms(dev, bits, gs, gpt_oss):
    """int8 weights, 32-row groups and GPT-OSS's clamped activation."""
    x, w13, w2, idx, wts = _k3_case(dev, 30 + bits + gs, 3, 4, 512, 384, bits, gs)
    x = (x.float() * (4.0 if gpt_oss else 1.0)).to(torch.bfloat16)
    lim = 7.0 if gpt_oss else 0.0
    _close(moe_cuda.moe_w4a8(x, w13, w2, idx, wts, lim, gpt_oss),
           moe_cuda.moe_w4a8_plain(x, w13, w2, idx, wts, lim, gpt_oss), 3e-2)


def test_k3_smem_formula_matches_kernel(dev):
    """The plans made off the card (``k3_smem``) and on it (the built
    kernel's ``moe_w4a8_smem``) see the same shared memory, for every
    column tile and cluster size at V2-Lite's, the hybrid's and a wide
    expert's widths, and at K6a's product form on V2-Lite Q8's w2 (stage
    1's layout at H = K = 1408)."""
    for k, H, I in ((8, 2048, 1408), (11, 2048, 512), (8, 4096, 1536), (4, 512, 384),
                    (1, 1408, 1024)):
        for bits in (4, 8):
            for gs in (32, 128):
                for stage in (1, 2):
                    units = (H // 2 if bits == 4 else H) // moe_cuda.UNIT if stage == 1 else (
                        k * (I // 2 if bits == 4 else I) // moe_cuda.UNIT)
                    for cols in moe_cuda.K3_COLS:
                        for ks in (1, 2, 4, 8):
                            p = moe_cuda.StagePlan(cols, ks, units, (1, 1, ks))
                            assert (moe_cuda.k3_smem(stage, p, k, H, I, bits, gs)
                                    == moe_cuda.k3_smem_card(stage, p, k, H, I, bits, gs))


def test_moe_w4a8_two_device_kernels_a_call(dev):
    """Routing's int32 indices and f32 weights go in as they are: a call is
    exactly K3's two device kernels."""
    from krasis_tpu_torch.timing import device_per_call

    x, w13, w2, idx, wts = _k3_case(dev, 40, 1, 8, 2048, 1408)
    us, per_call, _ = device_per_call(lambda: moe_cuda.moe_w4a8(x, w13, w2, idx, wts),
                                      moe_cuda.K3_KERNELS, calls=5)
    assert per_call == 2 and us > 0


@pytest.mark.parametrize("bits", [4, 8])
def test_moe_bf16_kernel(dev, bits):
    g = _gen(dev, 3 + bits)
    w13 = random_qtensor((10, 256, 256), bits, 128, g, dev, scale_mag=0.03)
    w2 = random_qtensor((10, 128, 256), bits, 128, g, dev, scale_mag=0.03)
    x = torch.randn((2, 256), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.tensor([[0, 3, 5, 8, 9], [7, 1, 2, 8, 9]], dtype=torch.int32, device=dev)
    wts = torch.rand((2, 5), generator=g, device=dev)
    before = moe_cuda.launches_bf16
    _close(moe_cuda.moe_bf16(x, w13, w2, idx, wts),
           moe_cuda.moe_bf16_plain(x, w13, w2, idx, wts), 3e-2)
    assert moe_cuda.launches_bf16 == before + 2


def test_grouped_moe_kernel(dev):
    w13, w2, g = _experts(dev, 8, 256, 128, 2)
    T, k = 100, 2
    x = torch.randn((T, 256), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.rand((T, 8), generator=g, device=dev).topk(k, dim=-1).indices.to(torch.int32)
    plan = gmm_cuda.plan_tiles(idx, 8)
    real = plan.row_src >= 0
    a = gmm_cuda.gmm_plain(x, plan.row_src, w13, plan, True)
    _close(gmm_cuda.gmm(x, plan.row_src, w13, plan, True)[real], a[real], 3e-2)
    _close(gmm_cuda.gmm(a, None, w2, plan, False)[real],
           gmm_cuda.gmm_plain(a, None, w2, plan, False)[real], 3e-2)


def _picks(dev, g, P, E, masked):
    eids = torch.randint(0, E, (P,), generator=g, device=dev).to(torch.int32)
    valid = None
    if masked:
        valid = torch.ones(P, dtype=torch.int32, device=dev)
        valid[[1, P - 1]] = 0
    return eids, valid


@pytest.mark.parametrize("masked", [False, True], ids=["all", "pick_valid"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K,N,gs", [(256, 384, 128), (384, 256, 128), (256, 320, 32),
                                    (256, 196, 16), (64, 64, 32)])
def test_gathered_qmm_kernel(dev, K, N, gs, bits, masked):
    """K6 on K1's core: rows against experts read in place, widths with a
    partial last column tile, groups of 16; skipped picks read back 0."""
    g = _gen(dev, K + N + bits)
    w = random_qtensor((10, K, N), bits, gs, g, dev, scale_mag=0.03)
    x = torch.randn((7, K), generator=g, device=dev).to(torch.bfloat16)
    eids, valid = _picks(dev, g, 7, 10, masked)
    assert moe_cuda.gathered_qmm_supported(w)
    got = _one_launch_each(lambda: moe_cuda.gathered_qmm(x, w, eids, valid),
                           (moe_cuda, "launches_gq"))
    _close(got, moe_cuda.gathered_qmm_plain(x, w, eids, valid), 2e-2)
    if masked:
        assert not got[[1, 6]].any() and got[0].any()


@pytest.mark.parametrize("masked", [False, True], ids=["all", "pick_valid"])
@pytest.mark.parametrize("name,K,N,bits,gs,P", [
    ("gptoss_w13", 2880, 5760, 4, 32, 4), ("gptoss_w2", 2880, 2880, 4, 32, 4),
    ("gptoss_w2_T2", 2880, 2880, 4, 32, 8), ("q8_w13", 2048, 2816, 8, 128, 8),
    ("q8_w2", 1408, 2048, 8, 128, 8)])
def test_gathered_qmm_at_full_shapes(dev, name, K, N, bits, gs, P, masked):
    """K6 at GPT-OSS-20B's (the 2880-wide w2 ends in a 64-column tile) and
    V2-Lite Q8's widths, 10 experts: one device kernel a call, equal bit for
    bit from call to call, within 2e-2 of its plain version."""
    from krasis_tpu_torch.timing import device_per_call

    g = _gen(dev, K + N + P)
    w = random_qtensor((10, K, N), bits, gs, g, dev, scale_mag=0.03 if bits == 4 else 0.002)
    x = torch.randn((P, K), generator=g, device=dev).to(torch.bfloat16)
    eids, valid = _picks(dev, g, P, 10, masked)
    got = _one_launch_each(lambda: moe_cuda.gathered_qmm(x, w, eids, valid),
                           (moe_cuda, "launches_gq"))
    _close(got, moe_cuda.gathered_qmm_plain(x, w, eids, valid), 2e-2)
    if masked:
        assert not got[[1, P - 1]].any() and got[0].any()
    _, per_call, _ = device_per_call(lambda: moe_cuda.gathered_qmm(x, w, eids, valid),
                                     "qmm_kernel", calls=5)
    assert per_call == 1


@pytest.mark.parametrize("masked", [False, True], ids=["all", "pick_valid"])
@pytest.mark.parametrize("T", [1, 2])
def test_biased_chain_at_gpt_oss_shapes(dev, T, masked):
    """GPT-OSS's biased experts through moe_forward (32 experts, H and I
    2880, int4 gs 32, top-4, nonzero biases): two K6 launches a call, no
    plain route, within 3e-2 of the plain moe_forward_gathered."""
    from krasis_tpu_torch.ops import moe

    g = _gen(dev, 90 + T)
    E, H, I, k = 32, 2880, 2880, 4
    w13 = random_qtensor((E, H, 2 * I), 4, 32, g, dev, scale_mag=0.03)
    w2 = random_qtensor((E, I, H), 4, 32, g, dev, scale_mag=0.03)
    x = torch.randn((T, H), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.stack([torch.randperm(E, generator=g, device=dev)[:k]
                       for _ in range(T)]).to(torch.int32)
    wts = torch.softmax(torch.randn((T, k), generator=g, device=dev), dim=-1)
    b13 = torch.randn((E, 2 * I), generator=g, device=dev).to(torch.bfloat16)
    b2 = torch.randn((E, H), generator=g, device=dev).to(torch.bfloat16)
    pv = None
    if masked:
        pv = torch.ones((T, k), dtype=torch.bool, device=dev)
        pv[0, 1] = False
        wts = wts * pv
    args = (x, w13, w2, idx, wts, 7.0, True)
    before = moe_cuda.launches_gq
    moe.plain_routes.update(ragged_plain=0, gathered_plain=0)
    got = moe.moe_forward(*args, w13_bias=b13, w2_bias=b2, pick_valid=pv, activation="int8")
    assert moe_cuda.launches_gq == before + 2
    assert moe.plain_routes == {"ragged_plain": 0, "gathered_plain": 0}
    want = moe.moe_forward_gathered(*args, w13_bias=b13, w2_bias=b2)
    _close(got, want, 3e-2)
    with pytest.raises(AssertionError):
        _close(got, moe.moe_forward_gathered(*args, w2_bias=b2), 3e-2)


@pytest.mark.parametrize("regime,T,activation,two_stage,counter", [
    ("fused_int8", 1, "int8", False, (moe_cuda, "launches")),
    ("tiled_int8", 1, "int8", True, (moe_cuda, "launches_gq_a8")),
    ("fused_bf16", 1, "bf16", False, (moe_cuda, "launches_bf16")),
    ("tiled_bf16", 1, "bf16", True, (moe_cuda, "launches_gq")),
    ("grouped", 64, "bf16", False, (gmm_cuda, "launches"))])
@pytest.mark.parametrize("bits", [4, 8])
def test_groups_of_16_in_each_regime(dev, monkeypatch, regime, T, activation, two_stage,
                                     counter, bits):
    """Stacks at gs 16 (4 experts, H 256, I 128, int4 and int8): moe_forward
    takes the reference's form on the card without raising and runs it on
    the form's kernel (two launches; no plain route), within 3e-2 of the
    form's plain version."""
    from krasis_tpu_torch.ops import moe

    if two_stage:
        monkeypatch.setattr(expert_class, "MAX_FUSED_PICK_BYTES", 1024)
    g = _gen(dev, 16 + T)
    E, H, I, k = 4, 256, 128, 2
    w13 = random_qtensor((E, H, 2 * I), bits, 16, g, dev, scale_mag=0.03)
    w2 = random_qtensor((E, I, H), bits, 16, g, dev, scale_mag=0.03)
    x = torch.randn((T, H), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.rand((T, E), generator=g, device=dev).topk(k, dim=-1).indices.to(torch.int32)
    wts = torch.rand((T, k), generator=g, device=dev)
    assert moe.route(x, w13, w2, idx, False, activation) == regime
    moe.plain_routes.update(ragged_plain=0, gathered_plain=0)
    mod, attr = counter
    before = getattr(mod, attr)
    got = moe.moe_forward(x, w13, w2, idx, wts, activation=activation)
    assert getattr(mod, attr) == before + 2
    assert moe.plain_routes == {"ragged_plain": 0, "gathered_plain": 0}
    plain = {"fused_int8": lambda: moe_cuda.moe_w4a8_plain(x, w13, w2, idx, wts),
             "tiled_int8": lambda: moe_cuda.moe_gathered_a8_plain(x, w13, w2, idx, wts),
             "fused_bf16": lambda: moe_cuda.moe_bf16_plain(x, w13, w2, idx, wts),
             "tiled_bf16": lambda: moe_cuda.moe_gathered_bf16_plain(x, w13, w2, idx, wts),
             "grouped": lambda: moe.moe_forward(x.cpu(), w13.to("cpu"), w2.to("cpu"), idx.cpu(),
                                                wts.cpu()).to(dev)}
    _close(got, plain[regime](), 3e-2)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("tm", [64, 128, 256, 512])
def test_gmm_kernel_groups_of_16(dev, tm, bits):
    """gmm_kernel's FULL16 form (groups of 16 rows) at every tile height,
    both epilogues, against gmm_plain on the real rows: the w13 call with
    gathered rows and the w2 call on tile-aligned rows; padding rows of
    computed tiles read back zero."""
    g = _gen(dev, tm + bits)
    E, H, I, T, k = 4, 512, 256, 96, 2
    w13 = random_qtensor((E, H, 2 * I), bits, 16, g, dev, scale_mag=0.03)
    w2 = random_qtensor((E, I, H), bits, 16, g, dev, scale_mag=0.03)
    x = torch.randn((T, H), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.rand((T, E), generator=g, device=dev).topk(k, dim=-1).indices.to(torch.int32)
    plan = gmm_cuda.plan_tiles(idx, E, tm)
    real = plan.row_src >= 0
    pad = (~real) & plan.tile_valid.bool().repeat_interleave(tm)
    a = gmm_cuda.gmm(x, plan.row_src, w13, plan, True)
    _close(a[real], gmm_cuda.gmm_plain(x, plan.row_src, w13, plan, True)[real], 3e-2)
    assert not a[pad].any()
    h = gmm_cuda.gmm_two_stage(x, plan.row_src, w13, plan)
    _close(h[real], gmm_cuda.gmm_plain(x, plan.row_src, w13, plan, False)[real], 2e-2)
    o = gmm_cuda.gmm(a, None, w2, plan, False)
    _close(o[real], gmm_cuda.gmm_plain(a, None, w2, plan, False)[real], 3e-2)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "pick_valid"])
@pytest.mark.parametrize("gs", [32, 16])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("tm", [64, 128, 256])
def test_k7_column_tail(dev, tm, bits, gs, masked):
    """K7 at widths that end in a 64-column CTA (N = 320 and 192), at the
    heights where a CTA is 128 columns, both call shapes (gathered rows,
    tile-aligned rows), against gmm_plain on the real rows within 2e-2;
    padding rows of computed tiles read back zero. K4's SwiGLU epilogue
    still refuses such a width."""
    g = _gen(dev, 300 + tm + bits + gs + masked)
    E, T, k = 4, 150, 2
    w13 = random_qtensor((E, 320, 192), bits, gs, g, dev, scale_mag=0.03)
    w2 = random_qtensor((E, 192, 320), bits, gs, g, dev, scale_mag=0.03)
    x = torch.randn((T, 320), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.rand((T, E), generator=g, device=dev).topk(k, dim=-1).indices.to(torch.int32)
    pv = torch.rand((T, k), generator=g, device=dev) > 0.2 if masked else None
    plan = gmm_cuda.plan_tiles(idx, E, tm, pick_valid=pv)
    real = plan.row_src >= 0
    pad = (~real) & plan.tile_valid.bool().repeat_interleave(tm)
    before = gmm_cuda.launches_two_stage
    h = gmm_cuda.gmm_two_stage(x, plan.row_src, w13, plan)
    _close(h[real], gmm_cuda.gmm_plain(x, plan.row_src, w13, plan, False)[real], 2e-2)
    assert not h[pad].any()
    a = torch.randn((plan.n_tiles * tm, w2.k_dim), generator=g, device=dev).to(torch.bfloat16)
    o = gmm_cuda.gmm_two_stage(a, None, w2, plan)
    live = plan.tile_valid.bool().repeat_interleave(tm)
    _close(o[live], gmm_cuda.gmm_plain(a, None, w2, plan, False)[live], 2e-2)
    assert gmm_cuda.launches_two_stage == before + 2
    with pytest.raises(ValueError):
        gmm_cuda.gmm(x, plan.row_src, w13, plan, True)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "pick_valid"])
@pytest.mark.parametrize("T", [40, 1024])
def test_biased_grouped_chain_at_gpt_oss_shapes(dev, T, masked):
    """GPT-OSS's biased experts in the grouped regime through moe_forward
    (32 experts, H and I 2880, int4 gs 32, top-4, nonzero biases; 64-row
    tiles at T = 40, 128-row at T = 1024): two K7 launches a call and no
    plain route, within 3e-2 of the plain moe_forward_ragged; without the
    w13 bias the plain form is not."""
    from krasis_tpu_torch.ops import moe

    g = _gen(dev, 120 + T)
    E, H, I, k = 32, 2880, 2880, 4
    w13 = random_qtensor((E, H, 2 * I), 4, 32, g, dev, scale_mag=0.03)
    w2 = random_qtensor((E, I, H), 4, 32, g, dev, scale_mag=0.03)
    x = torch.randn((T, H), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.stack([torch.randperm(E, generator=g, device=dev)[:k]
                       for _ in range(T)]).to(torch.int32)
    wts = torch.softmax(torch.randn((T, k), generator=g, device=dev), dim=-1)
    b13 = torch.randn((E, 2 * I), generator=g, device=dev).to(torch.bfloat16)
    b2 = torch.randn((E, H), generator=g, device=dev).to(torch.bfloat16)
    pv = None
    if masked:
        pv = torch.rand((T, k), generator=g, device=dev) > 0.2
        wts = wts * pv
    args = (x, w13, w2, idx, wts, 7.0, True)
    assert moe.route(x, w13, w2, idx, True) == "ragged"
    before = (gmm_cuda.launches_two_stage, gmm_cuda.launches, gmm_cuda.launches_a8)
    moe.plain_routes.update(ragged_plain=0, gathered_plain=0)
    got = moe.moe_forward(*args, w13_bias=b13, w2_bias=b2, pick_valid=pv, activation="int8")
    assert (gmm_cuda.launches_two_stage, gmm_cuda.launches, gmm_cuda.launches_a8) == (
        before[0] + 2, before[1], before[2])
    assert moe.plain_routes == {"ragged_plain": 0, "gathered_plain": 0}
    want = moe.moe_forward_ragged(*args, w13_bias=b13, w2_bias=b2)
    _close(got, want, 3e-2)
    with pytest.raises(AssertionError):
        _close(got, moe.moe_forward_ragged(*args, w2_bias=b2), 3e-2)


@pytest.mark.parametrize("activation", ["int8", "bf16"])
@pytest.mark.parametrize("bits", [4, 8])
def test_fused_decode_kernels_groups_of_16_at_v2_lite_widths(dev, bits, activation):
    """K3 (int8 rows) and K5 (bf16 rows) at V2-Lite's widths (H 2048, I
    1408: w2's int4 halves of 704 rows) with groups of 16, T = 2 of top-6,
    against their plain versions."""
    g = _gen(dev, 160 + bits)
    E, H, I, T, k = 16, 2048, 1408, 2, 6
    w13 = random_qtensor((E, H, 2 * I), bits, 16, g, dev, scale_mag=0.02)
    w2 = random_qtensor((E, I, H), bits, 16, g, dev, scale_mag=0.02)
    x = torch.randn((T, H), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.rand((T, E), generator=g, device=dev).topk(k, dim=-1).indices.to(torch.int32)
    wts = torch.softmax(torch.randn((T, k), generator=g, device=dev), dim=-1)
    if activation == "int8":
        got = moe_cuda.moe_w4a8(x, w13, w2, idx, wts)
        want = moe_cuda.moe_w4a8_plain(x, w13, w2, idx, wts)
    else:
        got = moe_cuda.moe_bf16(x, w13, w2, idx, wts)
        want = moe_cuda.moe_bf16_plain(x, w13, w2, idx, wts)
    _close(got, want, 3e-2)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "pick_valid"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K,N", [(256, 384), (384, 256)])
def test_gathered_qmm_a8_kernel(dev, K, N, bits, masked):
    """K6a: int8 rows with per-group scales; K = 384 is 3 groups, fewer
    than the kernel's 8 warps."""
    g = _gen(dev, K + bits + 1)
    w = random_qtensor((10, K, N), bits, 128, g, dev, scale_mag=0.03)
    x = torch.randn((7, K), generator=g, device=dev).to(torch.bfloat16)
    xq, sx = moe_cuda.quantize_activations(x, 128)
    eids, valid = _picks(dev, g, 7, 10, masked)
    before = moe_cuda.launches_gq_a8_product
    got = moe_cuda.gathered_qmm_a8(xq, sx, w, eids, valid)
    assert moe_cuda.launches_gq_a8_product == before + 1
    _close(got, moe_cuda.gathered_qmm_a8_plain(xq, sx, w, eids, valid), 3e-2)
    if masked:
        assert not got[[1, 6]].any() and got[0].any()


@pytest.mark.parametrize("masked", [False, True], ids=["all", "pick_valid"])
@pytest.mark.parametrize("name,K,N", [("w13", 2048, 2816), ("w2", 1408, 2048)])
def test_gathered_qmm_a8_product_at_q8_shapes(dev, name, K, N, masked):
    """K6a's product form at V2-Lite Q8's w13 and w2 (int8, 8 picks of 12
    experts): one device kernel a call under its own name, equal bit for bit
    from call to call, within 1e-2 of its plain version."""
    from krasis_tpu_torch.timing import device_per_call

    g = _gen(dev, K + masked)
    w = random_qtensor((12, K, N), 8, 128, g, dev, scale_mag=0.002)
    x = torch.randn((8, K), generator=g, device=dev).to(torch.bfloat16)
    xq, sx = moe_cuda.quantize_activations(x, 128)
    eids, valid = _picks(dev, g, 8, 12, masked)
    got = _one_launch_each(lambda: moe_cuda.gathered_qmm_a8(xq, sx, w, eids, valid),
                           (moe_cuda, "launches_gq_a8_product"))
    _close(got, moe_cuda.gathered_qmm_a8_plain(xq, sx, w, eids, valid), 1e-2)
    _, per_call, _ = device_per_call(lambda: moe_cuda.gathered_qmm_a8(xq, sx, w, eids, valid),
                                     moe_cuda.K6A_PRODUCT_KERNEL, calls=5)
    assert per_call == 1


def _k6a_case(dev, seed, T, k, H, I, bits, gs, masked, gpt_oss):
    x, w13, w2, idx, wts = _k3_case(dev, seed, T, k, H, I, bits, gs)
    if gpt_oss:
        x = (x.float() * 4.0).to(torch.bfloat16)
    pv = None
    if masked:
        pv = torch.ones((T, k), dtype=torch.bool, device=dev)
        pv[0, 1] = pv[T - 1, k - 1] = False
    return x, w13, w2, idx, wts, pv


@pytest.mark.parametrize("masked", [False, True], ids=["all", "pick_valid"])
@pytest.mark.parametrize("bits,gs,gpt_oss", [(8, 128, False), (4, 128, True), (8, 32, True),
                                             (4, 32, False)])
def test_moe_gathered_a8_chain_kernel(dev, bits, gs, gpt_oss, masked):
    """K6a's chain, moe_gathered_tiled(activation="int8"): two launches a
    call, equal bit for bit from call to call, within 1e-2 of its plain
    version; a skipped pick adds nothing (K3's function with its weight 0),
    and without a mask the chain is K3 bit for bit."""
    x, w13, w2, idx, wts, pv = _k6a_case(dev, 60 + bits + gs, 3, 5, 512, 384, bits, gs, masked,
                                         gpt_oss)
    lim = 7.0 if gpt_oss else 0.0

    def run():
        return moe_cuda.moe_gathered_tiled(x, w13, w2, idx, wts, lim, gpt_oss, pv, "int8")

    before = moe_cuda.launches_gq_a8
    got = run()
    assert torch.equal(got, run()) and moe_cuda.launches_gq_a8 == before + 4
    _close(got, moe_cuda.moe_gathered_a8_plain(x, w13, w2, idx, wts, lim, gpt_oss, pv), 1e-2)
    if masked:
        _close(got, moe_cuda.moe_w4a8_plain(x, w13, w2, idx, wts * pv, lim, gpt_oss), 1e-2)
    else:
        assert torch.equal(got, moe_cuda.moe_w4a8(x, w13, w2, idx, wts, lim, gpt_oss))


@pytest.mark.parametrize("T", [1, 2, 6])
def test_k6a_chain_at_q8_shapes(dev, T):
    """At V2-Lite Q8's widths (int8 experts, 6 routed + 2 shared picks of 12):
    exactly K6a's two device kernels a call, within 1e-2 of the plain chain."""
    from krasis_tpu_torch.timing import device_per_call

    x, w13, w2, idx, wts, _ = _k6a_case(dev, 70 + T, T, 8, 2048, 1408, 8, 128, False, False)

    def run():
        return moe_cuda.moe_gathered_tiled(x, w13, w2, idx, wts, activation="int8")

    _close(run(), moe_cuda.moe_gathered_a8_plain(x, w13, w2, idx, wts), 1e-2)
    us, per_call, _ = device_per_call(run, moe_cuda.K6A_KERNELS, calls=5)
    assert per_call == 2 and us > 0


@pytest.mark.parametrize("activation,tol", [("bf16", 2e-2), ("int8", 3e-2)])
@pytest.mark.parametrize("bits", [4, 8])
def test_moe_gathered_tiled_on_card(dev, bits, activation, tol):
    g = _gen(dev, 11 + bits)
    w13 = random_qtensor((10, 256, 256), bits, 128, g, dev, scale_mag=0.03)
    w2 = random_qtensor((10, 128, 256), bits, 128, g, dev, scale_mag=0.03)
    x = torch.randn((2, 256), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.tensor([[0, 3, 5, 8, 9], [7, 1, 2, 8, 9]], dtype=torch.int32, device=dev)
    wts = torch.rand((2, 5), generator=g, device=dev)
    pv = torch.ones((2, 5), dtype=torch.bool, device=dev)
    pv[1, 2] = False
    got = moe_cuda.moe_gathered_tiled(x, w13, w2, idx, wts, pick_valid=pv, activation=activation)
    want = moe_cuda.moe_gathered_tiled(x.cpu(), w13.to("cpu"), w2.to("cpu"), idx.cpu(),
                                       wts.cpu(), pick_valid=pv.cpu(), activation=activation)
    _close(got.cpu(), want, tol)


def _grouped_case(dev, bits, seed, masked):
    g = _gen(dev, seed)
    w13 = random_qtensor((8, 256, 256), bits, 128, g, dev, scale_mag=0.03)
    w2 = random_qtensor((8, 128, 256), bits, 128, g, dev, scale_mag=0.03)
    T, k = 100, 2
    x = torch.randn((T, 256), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.rand((T, 8), generator=g, device=dev).topk(k, dim=-1).indices.to(torch.int32)
    wts = torch.rand((T, k), generator=g, device=dev)
    pv = None
    if masked:
        pv = torch.rand((T, k), generator=g, device=dev) > 0.2
    return w13, w2, x, idx, wts, pv


@pytest.mark.parametrize("masked", [False, True], ids=["all", "pick_valid"])
@pytest.mark.parametrize("bits", [4, 8])
def test_two_stage_grouped_kernel(dev, monkeypatch, bits, masked):
    """K7 at both call shapes through moe_prefill, equal bit for bit to the
    fused form (K4) on the same plan, and within tolerance of the plain
    versions."""
    w13, w2, x, idx, wts, pv = _grouped_case(dev, bits, 20 + bits, masked)
    plan = gmm_cuda.plan_tiles(idx, 8, pick_valid=pv)
    real = plan.row_src >= 0
    _close(gmm_cuda.gmm_two_stage(x, plan.row_src, w13, plan)[real],
           gmm_cuda.gmm_plain(x, plan.row_src, w13, plan, False)[real], 2e-2)
    fused = gmm_cuda.moe_prefill(x, w13, w2, idx, wts, pick_valid=pv)
    before = gmm_cuda.launches_two_stage
    monkeypatch.setattr(expert_class, "MAX_FUSED_BLOCK_BYTES", 0)
    two_stage = gmm_cuda.moe_prefill(x, w13, w2, idx, wts, pick_valid=pv)
    assert gmm_cuda.launches_two_stage == before + 2
    assert torch.equal(two_stage, fused)
    want = gmm_cuda.moe_prefill(x.cpu(), w13.to("cpu"), w2.to("cpu"), idx.cpu(), wts.cpu(),
                                pick_valid=None if pv is None else pv.cpu())
    _close(two_stage.cpu(), want, 2e-2)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "pick_valid"])
@pytest.mark.parametrize("bits", [4, 8])
def test_grouped_a8_kernel(dev, bits, masked):
    """K7a: each stage against its plain version, and through
    moe_prefill(activation="int8")."""
    w13, w2, x, idx, wts, pv = _grouped_case(dev, bits, 30 + bits, masked)
    plan = gmm_cuda.plan_tiles(idx, 8, pick_valid=pv)
    real = plan.row_src >= 0
    xq, sx = moe_cuda.quantize_activations(x, 128)
    before = gmm_cuda.launches_a8
    h = gmm_cuda.gmm_a8(xq, sx, plan.row_src, w13, plan)
    assert gmm_cuda.launches_a8 == before + 1
    _close(h[real], gmm_cuda.gmm_a8_plain(xq, sx, plan.row_src, w13, plan)[real], 3e-2)
    assert not h[(~real) & plan.tile_valid.bool().repeat_interleave(gmm_cuda.TM)].any()
    got = gmm_cuda.moe_prefill(x, w13, w2, idx, wts, pick_valid=pv, activation="int8")
    want = gmm_cuda.moe_prefill(x.cpu(), w13.to("cpu"), w2.to("cpu"), idx.cpu(), wts.cpu(),
                                pick_valid=None if pv is None else pv.cpu(), activation="int8")
    _close(got.cpu(), want, 3e-2)


@pytest.mark.parametrize("activation", ["int8", "bf16"])
def test_tiny_q8_engine_takes_the_two_stage_kernels(dev, monkeypatch, activation):
    """With the class limits shrunk for its tiny experts, an int8-expert
    V2-Lite goes through K7 in prefill and K6a or K6 in decode, answers
    with logprobs, and gives a finite perplexity."""
    from krasis_tpu_torch.perplexity import evaluate_perplexity

    monkeypatch.setattr(expert_class, "MAX_FUSED_PICK_BYTES", 1024)
    monkeypatch.setattr(expert_class, "MAX_FUSED_BLOCK_BYTES", 1024)
    cfg = tiny_config("deepseek-v2-lite", moe_intermediate_size=128, num_hidden_layers=3)
    quant = QuantConfig(expert_bits=8, group_size=128, expert_activation=activation)
    eng = build_synthetic_engine(cfg, quant, seed=0, max_len=1024)
    decode = "launches_gq_a8" if activation == "int8" else "launches_gq"
    before = (gmm_cuda.launches_two_stage, getattr(moe_cuda, decode), gmm_cuda.launches,
              moe_cuda.launches, moe_cuda.launches_bf16)
    res = eng.generate(list(range(3, 203)), max_new_tokens=12, stop_ids={-1}, top_logprobs=3)
    assert res.finite and len(res.tokens) == 12
    assert all(lp <= 0.0 for lp in res.logprobs)
    assert [top[0][0] for top in res.top_logprobs] == res.tokens
    after = (gmm_cuda.launches_two_stage, getattr(moe_cuda, decode), gmm_cuda.launches,
             moe_cuda.launches, moe_cuda.launches_bf16)
    assert after[0] > before[0] and after[1] > before[1] and after[2:] == before[2:]
    ids = torch.randint(1, 512, (200,), generator=torch.Generator().manual_seed(0)).tolist()
    out = evaluate_perplexity(eng, ids, window=64, stride=32, log_every=0)
    assert out["tokens_scored"] == 199 and 1.0 < out["ppl"] < float("inf")


def test_tiny_engine_generates_on_card(dev):
    cfg = tiny_config("deepseek-v2-lite", moe_intermediate_size=128, num_hidden_layers=4)
    eng = build_synthetic_engine(cfg, QuantConfig(expert_bits=4, group_size=128), seed=0)
    res = eng.generate(list(range(3, 203)), max_new_tokens=12, stop_ids={-1})
    assert res.finite and len(res.tokens) == 12


@pytest.mark.parametrize("attention,activation", [("int8", "int8"), ("int8", "bf16"),
                                                  ("bf16", "int8"), ("int4", "int8")])
def test_tiny_hybrid_generates_on_card(dev, attention, activation):
    cfg = tiny_config("qwen3-coder-next")
    quant = QuantConfig(expert_bits=4, group_size=128, attention=attention,
                        expert_activation=activation)
    eng = build_synthetic_engine(cfg, quant, seed=0)
    eng.chunk = 128
    counters = [(qmm_cuda, "launches_stacked"), (fa, "launches"),
                (moe_cuda, "launches" if activation == "int8" else "launches_bf16")]
    before = [getattr(m, name) for m, name in counters]
    res = eng.generate(list(range(3, 203)), max_new_tokens=12, stop_ids={-1})
    assert res.finite and len(res.tokens) == 12
    for (m, name), b in zip(counters, before):
        if name == "launches_stacked" and attention == "bf16":
            continue
        assert getattr(m, name) > b, name


def _decode_case(dev, family, B, S, seed):
    g = _gen(dev, seed)
    if family == "mla":
        q = torch.zeros((B, 1, 16, 640), dtype=torch.bfloat16, device=dev)
        kv = torch.zeros((B, 1, S, 640), dtype=torch.bfloat16, device=dev)
        q[..., :576] = torch.randn((B, 1, 16, 576), generator=g, device=dev).to(torch.bfloat16)
        kv[..., :576] = torch.randn((B, 1, S, 576), generator=g, device=dev).to(torch.bfloat16)
        return q, kv, None, dict(scale=0.07, v_dim=512, qk_dim=576)
    q = torch.randn((B, 1, 16, 256), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, 2, S, 256), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, 2, S, 256), generator=g, device=dev).to(torch.bfloat16)
    return q, k, v, dict(scale=1 / 16, v_dim=256, qk_dim=256)


@pytest.mark.parametrize("kv_len", [[300], [17], [300, 17], [512], [2500]],
                         ids=["ragged", "below_chunk", "two_rows", "full", "long"])
@pytest.mark.parametrize("family", ["mla", "gqa"])
def test_split_decode_kernel(dev, family, kv_len):
    """K2's split-KV decode (two launches) against the one-launch plain
    version and against the split form's own plain version; splits past
    kv_len are empty."""
    S = 4096 if max(kv_len) > 512 else 512
    q, kv, v, kw = _decode_case(dev, family, len(kv_len), S, sum(kv_len))
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    before = fa.launches
    got = fa.decode_attention(q, kv, kl, kw["scale"], kw["v_dim"], v=v, qk_dim=kw["qk_dim"])
    assert fa.launches == before + 2
    _close(got, fa.flash_attention_plain(q, kv, kl - 1, kl, kw["scale"], kw["v_dim"], v,
                                         kw["qk_dim"]), 2e-2)
    want = fa.decode_attention(q.cpu(), kv.cpu(), kl.cpu(), kw["scale"], kw["v_dim"],
                               v=None if v is None else v.cpu(), qk_dim=kw["qk_dim"])
    _close(got.cpu(), want, 2e-2)


@pytest.mark.parametrize("sq,q_off,kv_len", [(2, 298, 300), (4, 60, 64)])
def test_split_decode_kernel_verify_rows(dev, sq, q_off, kv_len):
    """A few query tokens (Sq·G ≤ 64 stacked rows) take the split form with
    the causal mask inside a split."""
    q, kv, _, kw = _decode_case(dev, "mla", 1, 512, sq)
    q = q.expand(1, sq, 16, 640).contiguous()
    q[:, 1:] = torch.roll(q[:, 1:], 1, dims=-1)
    qo = torch.tensor([q_off], dtype=torch.int32, device=dev)
    kl = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    before = fa.launches
    got = fa.flash_attention(q, kv, qo, kl, kw["scale"], kw["v_dim"], qk_dim=kw["qk_dim"])
    assert fa.launches == before + 2
    _close(got, fa.flash_attention_plain(q, kv, qo, kl, kw["scale"], kw["v_dim"],
                                         qk_dim=kw["qk_dim"]), 2e-2)


@pytest.mark.parametrize("family", ["mla", "gqa"])
def test_prefill_kernel_real_lanes(dev, family):
    """The one-launch form with scores over the real lanes only, prefill and
    a chunk over history."""
    q1, kv, v, kw = _decode_case(dev, family, 1, 512, 3)
    g = _gen(dev, 4)
    for sq, q_off, kv_len in ((300, 0, 300), (97, 300, 397)):
        q = torch.zeros((1, sq) + tuple(q1.shape[2:]), dtype=torch.bfloat16, device=dev)
        q[..., :kw["qk_dim"]] = torch.randn(q[..., :kw["qk_dim"]].shape, generator=g,
                                            device=dev).to(torch.bfloat16)
        qo = torch.tensor([q_off], dtype=torch.int32, device=dev)
        kl = torch.tensor([kv_len], dtype=torch.int32, device=dev)
        before = fa.launches
        got = fa.flash_attention(q, kv, qo, kl, kw["scale"], kw["v_dim"], v, kw["qk_dim"])
        assert fa.launches == before + 1
        _close(got, fa.flash_attention_plain(q, kv, qo, kl, kw["scale"], kw["v_dim"], v,
                                             kw["qk_dim"]), 2e-2)


def _gmm_case(dev, bits, seed, T, k, E, H=256, I=128):
    g = _gen(dev, seed)
    w13 = random_qtensor((E, H, 2 * I), bits, 128, g, dev, scale_mag=0.03)
    w2 = random_qtensor((E, I, H), bits, 128, g, dev, scale_mag=0.03)
    x = torch.randn((T, H), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.rand((T, E), generator=g, device=dev).topk(k, dim=-1).indices.to(torch.int32)
    pv = torch.rand((T, k), generator=g, device=dev) > 0.2
    return w13, w2, x, idx, pv


@pytest.mark.parametrize("masked", [False, True], ids=["all", "pick_valid"])
@pytest.mark.parametrize("tm", [64, 128])
@pytest.mark.parametrize("bits", [4, 8])
def test_grouped_kernel_tile_heights(dev, bits, tm, masked):
    """gmm_kernel at both tile heights, int4 and int8, both epilogues,
    against gmm_plain on the same plan; padding rows of computed tiles
    read back zero."""
    w13, w2, x, idx, pv = _gmm_case(dev, bits, 40 + bits + tm, 300, 2, 8)
    plan = gmm_cuda.plan_tiles(idx, 8, tm, pick_valid=pv if masked else None)
    real = plan.row_src >= 0
    pad = (~real) & plan.tile_valid.bool().repeat_interleave(tm)
    before = gmm_cuda.launches
    a = gmm_cuda.gmm(x, plan.row_src, w13, plan, True)
    _close(a[real], gmm_cuda.gmm_plain(x, plan.row_src, w13, plan, True)[real], 3e-2)
    assert not a[pad].any()
    o = gmm_cuda.gmm(a, None, w2, plan, False)
    _close(o[real], gmm_cuda.gmm_plain(a, None, w2, plan, False)[real], 3e-2)
    assert gmm_cuda.launches == before + 2
    h = gmm_cuda.gmm_two_stage(x, plan.row_src, w13, plan)
    _close(h[real], gmm_cuda.gmm_plain(x, plan.row_src, w13, plan, False)[real], 2e-2)
    assert not h[pad].any()


@pytest.mark.parametrize("tm", [64, 128])
@pytest.mark.parametrize("bits", [4, 8])
def test_two_stage_equals_fused_at_both_heights(dev, bits, tm):
    """K7 + SwiGLU + K7 equals K4 bit for bit on one plan, at K = 2048 and
    an I whose K/2 is no multiple of the scale group (V2-Lite's w2)."""
    from krasis_tpu_torch.ops.activations import swiglu

    w13, w2, x, idx, _ = _gmm_case(dev, bits, 50 + bits + tm, 256, 4, 8, H=2048, I=1408)
    plan = gmm_cuda.plan_tiles(idx, 8, tm)
    live = plan.tile_valid.bool().repeat_interleave(tm)
    a4 = gmm_cuda.gmm(x, plan.row_src, w13, plan, True)
    a7 = swiglu(gmm_cuda.gmm_two_stage(x, plan.row_src, w13, plan).to(torch.bfloat16))
    assert torch.equal(a4[live], a7[live])
    assert torch.equal(gmm_cuda.gmm(a4, None, w2, plan, False)[live],
                       gmm_cuda.gmm_two_stage(a7, None, w2, plan)[live])


def test_gpt_oss_epilogues_on_card(dev):
    """K3, K5 and K4 with GPT-OSS's clamped activation against their plain
    versions, with gate and up values past the clamp."""
    w13, w2, _ = _experts(dev, 10, 256, 128, 5)
    g = _gen(dev, 6)
    x = (4 * torch.randn((2, 256), generator=g, device=dev)).to(torch.bfloat16)
    idx = torch.tensor([[0, 3, 5, 8, 9], [7, 1, 2, 8, 9]], dtype=torch.int32, device=dev)
    wts = torch.rand((2, 5), generator=g, device=dev)
    for run, plain in ((moe_cuda.moe_w4a8, moe_cuda.moe_w4a8_plain),
                       (moe_cuda.moe_bf16, moe_cuda.moe_bf16_plain)):
        got = run(x, w13, w2, idx, wts, 7.0, True)
        _close(got, plain(x, w13, w2, idx, wts, 7.0, True), 3e-2)
        assert not torch.equal(got, run(x, w13, w2, idx, wts))
    xs = (4 * torch.randn((200, 256), generator=g, device=dev)).to(torch.bfloat16)
    topk = torch.rand((200, 10), generator=g, device=dev).topk(3, dim=-1).indices.to(torch.int32)
    plan = gmm_cuda.plan_tiles(topk, 10)
    real = plan.row_src >= 0
    _close(gmm_cuda.gmm(xs, plan.row_src, w13, plan, True, 7.0, True)[real],
           gmm_cuda.gmm_plain(xs, plan.row_src, w13, plan, True, 7.0, True)[real], 3e-2)


def _gptoss_case(dev, seed, sq, S, Hq=16, Hkv=2):
    """GPT-OSS's attention rows: heads of 64 real lanes in 128-lane rows,
    K and V in two buffers, and sinks near the rows' largest scores."""
    g = _gen(dev, seed)

    def rows(shape):
        t = torch.zeros(shape[:-1] + (128,), dtype=torch.bfloat16, device=dev)
        t[..., :64] = torch.randn(shape[:-1] + (64,), generator=g, device=dev).to(torch.bfloat16)
        return t

    sinks = 2.0 + torch.randn((Hq,), generator=g, device=dev)
    return rows((1, sq, Hq, 64)), rows((1, Hkv, S, 64)), rows((1, Hkv, S, 64)), sinks


# (sq, q_off, kv_len, cache rows): prefill and a chunk (one launch), decode
# below and past the window (split), and 4 and 8 query rows (Sq·G = 32, 64:
# split, the causal mask inside a split)
WINDOW_CASES = [(300, 0, 300, 512), (97, 300, 397, 512), (1, 99, 100, 4096),
                (1, 2499, 2500, 4096), (4, 86, 90, 512), (8, 292, 300, 512)]


@pytest.mark.parametrize("with_sinks", [True, False], ids=["sinks", "no_sinks"])
@pytest.mark.parametrize("window", [128, 0])
@pytest.mark.parametrize("sq,q_off,kv_len,S", WINDOW_CASES)
def test_attention_window_sinks_kernel(dev, sq, q_off, kv_len, S, window, with_sinks):
    """K2 with a sliding window and sinks, both launch forms, against the
    one-launch plain version; the split form also against its own plain
    split + combine (the sink joins once, in the combine)."""
    q, k, v, sinks = _gptoss_case(dev, sq + kv_len + window, sq, S)
    sinks = sinks if with_sinks else None
    qo = torch.tensor([q_off], dtype=torch.int32, device=dev)
    kl = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    split = sq * 8 <= fa.MAX_SPLIT_ROWS
    before = fa.launches
    got = fa.flash_attention(q, k, qo, kl, 0.125, 64, v, 64, window=window, sinks=sinks)
    assert fa.launches == before + (2 if split else 1)
    _close(got, fa.flash_attention_plain(q, k, qo, kl, 0.125, 64, v, 64, window, sinks), 2e-2)
    if split:
        chunk, _ = fa.split_plan(S, 2, 1, torch.cuda.get_device_properties(dev)
                                 .multi_processor_count)
        o, m, l = fa.decode_split_plain(q, k, qo, kl, 0.125, 64, chunk, v, 64, window)
        _close(got, fa._unstack(fa.decode_combine_plain(o, m, l, sinks), sq), 2e-2)


def _fp8_case(dev, family, sq, S):
    if family == "gqa":
        q, k, v, sinks = _gptoss_case(dev, 5 + sq, sq, S)
        return q, k, v, sinks, dict(scale=0.125, v_dim=64, qk_dim=64, window=128)
    g = _gen(dev, 6 + sq)
    q = torch.zeros((1, sq, 16, 640), dtype=torch.bfloat16, device=dev)
    kv = torch.zeros((1, 1, S, 640), dtype=torch.bfloat16, device=dev)
    q[..., :576] = (0.3 * torch.randn((1, sq, 16, 576), generator=g, device=dev)).to(torch.bfloat16)
    kv[..., :576] = torch.randn((1, 1, S, 576), generator=g, device=dev).to(torch.bfloat16)
    return q, kv, None, None, dict(scale=0.072, v_dim=512, qk_dim=576, window=0)


@pytest.mark.parametrize("sq,q_off,kv_len", [(300, 0, 300), (97, 300, 397), (1, 2499, 2500),
                                             (1, 39, 40), (2, 298, 300)])
@pytest.mark.parametrize("family", ["gqa", "mla"])
def test_attention_fp8_cache_kernel(dev, family, sq, q_off, kv_len):
    """K2 over an e4m3 cache (GQA: 64 real lanes of 128, V in its own
    buffer, window and sinks; MLA: 576 of 640, V inside K) equals K2 over the
    same cache cast to bf16 bit for bit, and its plain version within 2e-2."""
    from krasis_tpu_torch.runtime.kv_cache import to_cache

    S = 4096 if kv_len > 512 else 512
    q, k, v, sinks, kw = _fp8_case(dev, family, sq, S)
    k8 = to_cache(k, torch.float8_e4m3fn)
    v8 = None if v is None else to_cache(v, torch.float8_e4m3fn)
    wide = (k8.to(torch.bfloat16), None if v8 is None else v8.to(torch.bfloat16))
    qo = torch.tensor([q_off], dtype=torch.int32, device=dev)
    kl = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    args = (qo, kl, kw["scale"], kw["v_dim"])
    opts = dict(qk_dim=kw["qk_dim"], window=kw["window"], sinks=sinks)
    got = _one_launch_each(lambda: fa.flash_attention(q, k8, *args, v=v8, **opts),
                           (fa, "launches")) if sq * (q.shape[2] // k.shape[1]) > 64 else \
        fa.flash_attention(q, k8, *args, v=v8, **opts)
    assert torch.equal(got, fa.flash_attention(q, wide[0], *args, v=wide[1], **opts))
    _close(got, fa.flash_attention_plain(q, k8, *args, v8, **opts), 2e-2)


def test_attention_fp8_rejects_misaligned_lanes(dev):
    q = torch.zeros((1, 1, 8, 72), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((1, 1, 64, 72), dtype=torch.float8_e4m3fn, device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, torch.tensor([0], device=dev), torch.tensor([1], device=dev),
                           0.1, 64, v=k, qk_dim=64)


# --- the probe kernels (csrc/probes.cu) and the probe forms of gmm_kernel


def _bytes(dev, g, shape):
    return torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int8)


@pytest.mark.parametrize("n13,n2,H", [(320, 256, 256), (2816, 2048, 2048)])
def test_probe_stream_kernel(dev, n13, n2, H):
    """P4 equals its plain version exactly, w13's columns past H included in
    the stream (320: a partial 512-column group)."""
    g = _gen(dev, n13)
    q13, q2 = _bytes(dev, g, (8, 136, n13)), _bytes(dev, g, (8, 72, n2))
    eids = torch.tensor([1, 4, 7, 4], dtype=torch.int32, device=dev)
    before = probes_cuda.launches_stream
    got = probes_cuda.stream(q13, q2, eids, H)
    assert probes_cuda.launches_stream == before + 1
    assert torch.equal(got, probes_cuda.stream_plain(q13, q2, eids, H))


@pytest.mark.parametrize("mode", ["maskxor", "shift"])
def test_probe_unpack_kernel(dev, mode):
    q = _bytes(dev, _gen(dev, 3), (200, 336))
    got = probes_cuda.unpack_colsum(q, mode)
    assert torch.equal(got, probes_cuda.unpack_colsum_plain(q, mode))
    assert torch.equal(got, probes_cuda.unpack_colsum_plain(q, "maskxor"))


@pytest.mark.parametrize("M,K,N", [(8, 128, 256), (16, 256, 64), (3, 64, 24)])
def test_probe_int4_dot_kernels(dev, M, K, N):
    """P6 on the full int8 range and P5 on x in [-8, 7], both exact; P5
    refuses x outside the s4 range."""
    g = _gen(dev, M + K + N)
    q = _bytes(dev, g, (K // 2, N))
    x8 = _bytes(dev, g, (M, K))
    x4 = torch.randint(-8, 8, (M, K), generator=g, device=dev, dtype=torch.int8)
    assert torch.equal(probes_cuda.int4_dot(x8, q), probes_cuda.int4_dot_plain(x8, q))
    assert torch.equal(probes_cuda.int4_dot_native(x4, q), probes_cuda.int4_dot_plain(x4, q))
    with pytest.raises(ValueError):
        probes_cuda.int4_dot_native(x8, q)


def test_probe_int4_dot_on_ones(dev):
    ones = torch.ones((8, 128), dtype=torch.int8, device=dev)
    q = pack_int4(torch.ones((128, 256), dtype=torch.int8, device=dev))
    assert int(probes_cuda.int4_dot_native(ones, q)[0, 0]) == 128
    assert int(probes_cuda.int4_dot(ones, q)[0, 0]) == 128


@pytest.mark.parametrize("R,N", [(128, 256), (7, 40)])
def test_probe_int4_view_kernel(dev, R, N):
    q = torch.randint(0, 256, (R, N), dtype=torch.uint8, device=dev)
    assert probes_cuda.int4_view_shape(q).tolist() == [[2 * R, N]]


@pytest.mark.parametrize("tm", [256, 512])
@pytest.mark.parametrize("bits", [4, 8])
def test_grouped_kernel_large_tiles_equal_128(dev, bits, tm):
    """K4 (both epilogues) and K7 at 256 and 512 rows give each pick's row
    bit for bit as at 128 rows, and hold to their plain versions."""
    w13, w2, x, idx, _ = _gmm_case(dev, bits, 60 + bits + tm, 600, 2, 4, I=256)
    p128, pbig = gmm_cuda.plan_tiles(idx, 4, 128), gmm_cuda.plan_tiles(idx, 4, tm)
    assert pbig.tm == tm
    real = pbig.row_src >= 0
    a = {p.tm: gmm_cuda.gmm(x, p.row_src, w13, p, True) for p in (p128, pbig)}
    assert torch.equal(a[128][p128.dest], a[tm][pbig.dest])
    _close(a[tm][real], gmm_cuda.gmm_plain(x, pbig.row_src, w13, pbig, True)[real], 3e-2)
    o = {p.tm: gmm_cuda.gmm(a[p.tm], None, w2, p, False) for p in (p128, pbig)}
    assert torch.equal(o[128][p128.dest], o[tm][pbig.dest])
    h = {p.tm: gmm_cuda.gmm_two_stage(x, p.row_src, w13, p) for p in (p128, pbig)}
    assert torch.equal(h[128][p128.dest], h[tm][pbig.dest])
    _close(h[tm][real], gmm_cuda.gmm_plain(x, pbig.row_src, w13, pbig, False)[real], 2e-2)


@pytest.mark.parametrize("gathered", [False, True], ids=["tile_rows", "row_src"])
@pytest.mark.parametrize("mode,tm", [("copy", 128), ("nounpack", 128), ("unpackonly", 128),
                                     ("full", 128), ("v2", 128), ("v2", 256), ("v2", 512)])
@pytest.mark.parametrize("bits", [4, 8])
def test_gmm_probe_forms(dev, bits, mode, tm, gathered):
    """The probe forms against their plain versions on the computed tiles,
    over tile-aligned rows and over rows gathered through row_src: copy and
    unpackonly exactly, the products within 2e-2; full is K7's own launch
    and equals it bit for bit."""
    w13, _, xs, idx, _ = _gmm_case(dev, bits, 70 + bits + tm, 600, 2, 4, I=128)
    plan = gmm_cuda.plan_tiles(idx, 4, tm)
    live = plan.tile_valid.bool().repeat_interleave(tm)
    x = xs if gathered else torch.randn((plan.n_tiles * tm, 256), generator=_gen(dev, 9),
                                        device=dev).to(torch.bfloat16)
    src = plan.row_src if gathered else None
    counter = "launches_two_stage" if mode == "full" else f"launches_{mode}"
    before = getattr(gmm_cuda, counter)
    got = gmm_cuda.gmm_probe(x, w13, plan, mode, row_src=src)[live]
    assert getattr(gmm_cuda, counter) == before + 1
    want = gmm_cuda.gmm_probe_plain(x, w13, plan, mode, row_src=src)[live]
    if mode in ("copy", "unpackonly"):
        assert torch.equal(got, want)
    else:
        _close(got, want, 2e-2)
    if mode == "full":
        assert torch.equal(got, gmm_cuda.gmm_two_stage(x, src, w13, plan)[live])


@pytest.mark.parametrize("tm", [128, 256, 512])
def test_moe_prefill_tile_rows_on_card(dev, tm):
    """K4 at each height equals the 128-row plan bit for bit; with int8 rows
    K7a takes 128 rows (two launches, equal to the 64-row plan bit for bit)
    and refuses 256 and 512."""
    w13, w2, x, idx, _ = _gmm_case(dev, 4, 80 + tm, 600, 2, 4, I=256)
    wts = torch.rand(idx.shape, generator=_gen(dev, 2), device=dev)
    before = gmm_cuda.launches
    got = gmm_cuda.moe_prefill(x, w13, w2, idx, wts, tile_rows=tm)
    assert gmm_cuda.launches == before + 2
    assert torch.equal(got, gmm_cuda.moe_prefill(x, w13, w2, idx, wts, tile_rows=128))
    if tm == 128:
        before = gmm_cuda.launches_a8
        got = gmm_cuda.moe_prefill(x, w13, w2, idx, wts, activation="int8", tile_rows=tm)
        assert gmm_cuda.launches_a8 == before + 2
        assert torch.equal(got, gmm_cuda.moe_prefill(x, w13, w2, idx, wts, activation="int8",
                                                     tile_rows=64))
    else:
        with pytest.raises(ValueError, match="S-4a"):
            gmm_cuda.moe_prefill(x, w13, w2, idx, wts, activation="int8", tile_rows=tm)


# K5 at a model's widths: (T, k, H, I, bits, gs), the last pick a folded
# shared expert of weight 1
K5_SHAPES = {"hybrid": (1, 11, 2048, 512, 4, 128), "v2lite": (1, 8, 2048, 1408, 4, 128),
             "v2lite_int8_gs32": (2, 8, 2048, 1408, 8, 32), "gs16_T4": (4, 6, 256, 128, 4, 16)}


@pytest.mark.parametrize("name", list(K5_SHAPES))
def test_k5_two_kernels_at_model_widths(dev, name):
    """K5 on K1's core: two device kernels a call (by the profiler), two
    counts, bit-equal repeats, within 3e-2 of moe_bf16_plain, no cast, and
    the check refuses the plain version without the shared pick."""
    from krasis_tpu_torch.timing import device_per_call

    T, k, H, I, bits, gs = K5_SHAPES[name]
    x, w13, w2, idx, wts = _k3_case(dev, 170 + len(name), T, k, H, I, bits, gs, E=16,
                                    virtual=1)
    casts, before = moe_cuda.k5_casts, moe_cuda.launches_bf16
    got = moe_cuda.moe_bf16(x, w13, w2, idx, wts)
    assert torch.equal(got, moe_cuda.moe_bf16(x, w13, w2, idx, wts))
    assert moe_cuda.launches_bf16 == before + 4 and moe_cuda.k5_casts == casts
    want = moe_cuda.moe_bf16_plain(x, w13, w2, idx, wts)
    _close(got, want, 3e-2)
    shared_only = wts.clone()
    shared_only[:, :-1] = 0
    with pytest.raises(AssertionError):
        _close(moe_cuda.moe_bf16(x, w13, w2, idx, shared_only), torch.zeros_like(want), 3e-2)
    us, per_call, _ = device_per_call(lambda: moe_cuda.moe_bf16(x, w13, w2, idx, wts),
                                      moe_cuda.K5_KERNELS, calls=5)
    assert per_call == 2 and us > 0


def test_k5_reads_the_router_dtypes(dev):
    """The router's int32 ids and f32 weights go to the kernels as they are;
    int64 ids or bf16 weights take one counted PyTorch cast and give the
    same result; GPT-OSS's clamped activation within 3e-2."""
    x, w13, w2, idx, wts = _k3_case(dev, 190, 2, 6, 256, 128, 4, 32, E=16, virtual=1)
    wb = wts.to(torch.bfloat16)
    casts = moe_cuda.k5_casts
    want = moe_cuda.moe_bf16(x, w13, w2, idx, wb.float())
    assert moe_cuda.k5_casts == casts
    assert torch.equal(moe_cuda.moe_bf16(x, w13, w2, idx.long(), wb), want)
    assert moe_cuda.k5_casts == casts + 1
    _close(moe_cuda.moe_bf16(4 * x, w13, w2, idx, wts, 7.0, True),
           moe_cuda.moe_bf16_plain(4 * x, w13, w2, idx, wts, 7.0, True), 3e-2)


# K7a: (K, N, gs): N = 192 and 320 have a 64-column tail at 64-row tiles;
# K = 384 at gs 128 cuts group 1 at K/2 = 192 for int4
A8_STACKS = {"gs32_tail": (256, 320, 32), "gs16_tail": (256, 192, 16), "gs128": (384, 256, 128)}


@pytest.mark.parametrize("stack", list(A8_STACKS))
@pytest.mark.parametrize("tm", [64, 128])
@pytest.mark.parametrize("bits", [4, 8])
def test_k7a_int8_tensor_cores(dev, bits, tm, stack):
    """K7a on the int8 mma: against gmm_a8_plain within 3e-2 on the real
    rows (int8 stacks bit for bit: the groups fold in the plain version's
    order), padding rows of computed tiles zero, one launch, and the same
    rows bit for bit at 64 and 128 rows."""
    K, N, gs = A8_STACKS[stack]
    g = _gen(dev, K + N + gs + bits + tm)
    E, T, k = 4, 200, 2
    w = random_qtensor((E, K, N), bits, gs, g, dev, scale_mag=0.03)
    x = torch.randn((T, K), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.rand((T, E), generator=g, device=dev).topk(k, dim=-1).indices.to(torch.int32)
    xq, sx = moe_cuda.quantize_activations(x, gs)
    plans = {h: gmm_cuda.plan_tiles(idx, E, h) for h in (64, 128)}
    plan = plans[tm]
    real = plan.row_src >= 0
    before = gmm_cuda.launches_a8
    got = gmm_cuda.gmm_a8(xq, sx, plan.row_src, w, plan)
    assert gmm_cuda.launches_a8 == before + 1
    want = gmm_cuda.gmm_a8_plain(xq, sx, plan.row_src, w, plan)
    _close(got[real], want[real], 3e-2)
    if bits == 8:
        assert torch.equal(got[real], want[real])
    assert not got[(~real) & plan.tile_valid.bool().repeat_interleave(tm)].any()
    other = plans[192 - tm]
    assert torch.equal(got[plan.dest], gmm_cuda.gmm_a8(xq, sx, other.row_src, w, other)[other.dest])


def test_k7a_takes_groups_of_16_in_moe_prefill(dev):
    """C-3 on the card: moe_prefill(activation="int8") on a gs-16 int4 stack
    launches K7a twice and no K4 / K7, within 3e-2 of the same call on the
    CPU; a stack K7a declines (groups of 8) raises."""
    g = _gen(dev, 316)
    w13 = random_qtensor((4, 256, 256), 4, 16, g, dev, scale_mag=0.03)
    w2 = random_qtensor((4, 128, 256), 4, 16, g, dev, scale_mag=0.03)
    x = torch.randn((64, 256), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.rand((64, 4), generator=g, device=dev).topk(2, dim=-1).indices.to(torch.int32)
    wts = torch.rand((64, 2), generator=g, device=dev)
    before = (gmm_cuda.launches_a8, gmm_cuda.launches, gmm_cuda.launches_two_stage)
    got = gmm_cuda.moe_prefill(x, w13, w2, idx, wts, activation="int8")
    assert (gmm_cuda.launches_a8, gmm_cuda.launches, gmm_cuda.launches_two_stage) == (
        before[0] + 2, before[1], before[2])
    want = gmm_cuda.moe_prefill(x.cpu(), w13.to("cpu"), w2.to("cpu"), idx.cpu(), wts.cpu(),
                                activation="int8")
    _close(got.cpu(), want, 3e-2)
    w8 = QTensor(w13.q, w13.scales.repeat_interleave(2, dim=1), 4, 8)
    assert expert_class.grouped_int8(w8) and not gmm_cuda.gmm_a8_supported(w8)
    with pytest.raises(ValueError, match="gmm_a8"):
        gmm_cuda.moe_prefill(x, w8, w2, idx, wts, activation="int8")


def _same_bits(got: torch.Tensor, want: torch.Tensor):
    """Bit for bit, except that a NaN may carry another payload."""
    got, want = got.cpu().reshape(-1), want.cpu().reshape(-1)
    assert got.dtype == want.dtype and got.shape == want.shape
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[got.element_size()]
    same = got.view(ints) == want.view(ints)
    if got.dtype.is_floating_point:
        same |= torch.isnan(got) & torch.isnan(want)
    assert bool(same.all()), int((~same).sum())


@pytest.mark.parametrize("K,N,bits,gs", [(2048, 2816, 4, 128), (1408, 2048, 4, 128),
                                         (2048, 102400, 8, 128), (2880, 5760, 4, 32),
                                         (2880, 2880, 8, 32)],
                         ids=["v2lite-w13", "v2lite-w2", "v2lite-lm_head", "gptoss-w13-gs32",
                              "gptoss-w2-int8-gs32"])
def test_quantize_on_card_equals_cpu(dev, K, N, bits, gs):
    """The loader's quantizer on the card gives the CPU's (quantize_np's)
    bits at full-width shapes: scales by IEEE division, not a reciprocal."""
    w = torch.randn((K, N), generator=_gen(dev, K + N), device=dev) * 0.02
    got = quantize(w, bits, gs)
    want = quantize(w.cpu(), bits, gs)
    assert torch.equal(got.q.cpu(), want.q)
    _same_bits(got.scales, want.scales)


def test_prequant_decoders_on_card_equal_cpu(dev):
    """MXFP4 on every (byte, scale) pair, fp8 blocks and compressed-tensors
    int4 decode on the card to the CPU's bits."""
    from krasis_tpu_torch.quant import dequant_compressed_int4, dequant_fp8_block, dequant_mxfp4

    b = torch.arange(256, dtype=torch.uint8).repeat_interleave(256).reshape(-1, 1, 1)
    s = torch.arange(256, dtype=torch.uint8).repeat(256).reshape(-1, 1)
    _same_bits(dequant_mxfp4(b.to(dev), s.to(dev)), dequant_mxfp4(b, s))
    g = _gen(dev, 7)
    blocks = torch.randint(0, 256, (32, 64, 90, 16), generator=g, device=dev, dtype=torch.uint8)
    scales = torch.randint(118, 128, (32, 64, 90), generator=g, device=dev, dtype=torch.uint8)
    _same_bits(dequant_mxfp4(blocks, scales), dequant_mxfp4(blocks.cpu(), scales.cpu()))

    w8 = (torch.randn((1000, 700), generator=g, device=dev) * 100).to(torch.float8_e4m3fn)
    sinv = torch.rand((8, 6), generator=g, device=dev) * 1e-2
    _same_bits(dequant_fp8_block(w8, sinv), dequant_fp8_block(w8.cpu(), sinv.cpu()))
    packed = torch.randint(-2**31, 2**31 - 1, (512, 64), generator=g, device=dev,
                           dtype=torch.int32)
    scale = (torch.rand((512, 16), generator=g, device=dev) * 0.01).to(torch.float16)
    _same_bits(dequant_compressed_int4(packed, scale, 32),
               dequant_compressed_int4(packed.cpu(), scale.cpu(), 32))


@pytest.mark.parametrize("ttype", [0, 1, 30, 8, 2, 6, 12, 13, 14],
                         ids=["F32", "F16", "BF16", "Q8_0", "Q4_0", "Q5_0", "Q4_K", "Q5_K",
                              "Q6_K"])
def test_gguf_codecs_on_card_equal_cpu(dev, ttype):
    from krasis_tpu_torch.utils import gguf

    be, bb = gguf.BLOCK_INFO[ttype]
    n_blocks = (1 << 20) // bb
    g = _gen(dev, ttype)
    raw = torch.randint(0, 256, (n_blocks, bb), generator=g, device=dev, dtype=torch.uint8)
    if be == 1:     # finite values of the type
        dt = {0: torch.float32, 1: torch.float16, 30: torch.bfloat16}[ttype]
        vals = torch.randn((n_blocks * bb // dt.itemsize,), generator=g, device=dev).to(dt)
        raw = vals.view(torch.uint8)
    else:           # finite f16 scales
        offs = {8: (0,), 2: (0,), 6: (0,), 12: (0, 2), 13: (0, 2), 14: (208,)}[ttype]
        for off in offs:
            d = (torch.randn((n_blocks,), generator=g, device=dev) * 0.05).to(torch.float16)
            raw[:, off:off + 2] = d.view(torch.uint8).reshape(n_blocks, 2)
    raw = raw.reshape(-1)
    n = raw.numel() // bb * be
    _same_bits(gguf.dequantize_raw(raw, ttype, n), gguf.dequantize_raw(raw.cpu(), ttype, n))
