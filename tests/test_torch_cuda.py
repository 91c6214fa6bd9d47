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
from krasis_tpu_torch.ops import gmm_cuda, moe_cuda, qmm_cuda
from krasis_tpu_torch.quant import quantize, random_qtensor

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


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("T", [1, 8, 13])
def test_qmm_kernel(dev, bits, T):
    g = _gen(dev, T + bits)
    qt = quantize(torch.randn((512, 384), generator=g, device=dev) * 0.05, bits, 128)
    x = torch.randn((T, 512), generator=g, device=dev).to(torch.bfloat16)
    _close(qmm_cuda.qmm(x, qt, torch.float32), qmm_cuda.qmm_plain(x, qt, torch.float32), 2e-2)


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


def test_tiny_engine_generates_on_card(dev):
    cfg = tiny_config("deepseek-v2-lite", moe_intermediate_size=128, num_hidden_layers=4)
    eng = build_synthetic_engine(cfg, QuantConfig(expert_bits=4, group_size=128), seed=0)
    res = eng.generate(list(range(3, 203)), max_new_tokens=12, stop_ids={-1})
    assert res.finite and len(res.tokens) == 12
