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
from krasis_tpu_torch.ops import expert_class, gmm_cuda, moe_cuda, qmm_cuda
from krasis_tpu_torch.quant import quantize, random_qtensor, stack_leading

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
@pytest.mark.parametrize("K,N", [(256, 384), (384, 256)])
def test_gathered_qmm_kernel(dev, K, N, bits, masked):
    """K6: rows against experts read in place; skipped picks read back 0."""
    g = _gen(dev, K + bits)
    w = random_qtensor((10, K, N), bits, 128, g, dev, scale_mag=0.03)
    x = torch.randn((7, K), generator=g, device=dev).to(torch.bfloat16)
    eids, valid = _picks(dev, g, 7, 10, masked)
    before = moe_cuda.launches_gq
    got = moe_cuda.gathered_qmm(x, w, eids, valid)
    assert moe_cuda.launches_gq == before + 1
    _close(got, moe_cuda.gathered_qmm_plain(x, w, eids, valid), 2e-2)
    if masked:
        assert not got[[1, 6]].any() and got[0].any()


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
    before = moe_cuda.launches_gq_a8
    got = moe_cuda.gathered_qmm_a8(xq, sx, w, eids, valid)
    assert moe_cuda.launches_gq_a8 == before + 1
    _close(got, moe_cuda.gathered_qmm_a8_plain(xq, sx, w, eids, valid), 3e-2)
    if masked:
        assert not got[[1, 6]].any() and got[0].any()


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
