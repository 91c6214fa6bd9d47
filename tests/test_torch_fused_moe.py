"""KrasisTpuMoE (krasis_tpu_torch/fused_moe.py), the port of
krasis_tpu/fused_moe.py, embedded in a host framework's layer.

The four cases of tests/test_fused_moe_embedding.py, with a PyTorch
``nn.Module`` host block that owns the norm and the router and hands the
routed experts to KrasisTpuMoE (weights owned outside the host framework):
drop-in output parity with a dense reference (float), int4 on ingest close
to it, split expert ownership by -1 masks, and routing off the host's gate
weights. Then the port against the JAX KrasisTpuMoE on the same weights and
inputs (Pallas in interpret mode): float and int4 on ingest, with a third
of the picks masked, at T = 1 (the gathered regime) and T = 16 (the grouped
one), and forward_routed, element by element within 3e-2 of the
reference's output (|Δ| ≤ 3e-2 · (|want| + rms(want)))."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from krasis_tpu.config import preset_config as jax_preset_config
from krasis_tpu.fused_moe import KrasisTpuMoE as JaxKrasisTpuMoE
from krasis_tpu_torch.config import preset_config
from krasis_tpu_torch.fused_moe import KrasisTpuMoE
from krasis_tpu_torch.ops.routing import compute_routing

import torch_port_util  # noqa: F401  (one PyTorch thread)

E, H, I, K = 8, 64, 32, 2
T = 16
TOL = 3e-2
CFG = dict(hidden_size=H, moe_intermediate_size=I, n_routed_experts=E, num_experts_per_tok=K,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
           vocab_size=256, intermediate_size=2 * H)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("KRASIS_TPU_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    w13 = (rng.standard_normal((E, H, 2 * I)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((E, I, H)) * 0.1).astype(np.float32)
    return w13, w2


def _ref_moe(x, w13, w2, idx, wts):
    """Dense einsum reference (f32)."""
    h = torch.einsum("th,tkhi->tki", x, w13[idx.long()])
    g, u = h[..., :I], h[..., I:]
    out = torch.einsum("tki,tkih->tkh", g * torch.sigmoid(g) * u, w2[idx.long()])
    return (out * wts[..., None]).sum(dim=1)


class HostBlock(nn.Module):
    """The host framework's layer: it owns the norm and the router; the
    expert computation is injected (``moe_fn``), as a bridge embeds it."""

    def __init__(self, moe_fn):
        super().__init__()
        self.norm = nn.LayerNorm(H)
        self.router = nn.Linear(H, E, bias=False)
        self.moe_fn = moe_fn

    def forward(self, x):
        h = self.norm(x)
        wts, idx = torch.topk(torch.softmax(self.router(h), -1), K)
        return x + self.moe_fn(h, idx.to(torch.int32), wts)


def _blocks(krasis, w13, w2):
    """(the block over KrasisTpuMoE, the block over the dense reference), one
    set of host parameters."""
    torch.manual_seed(2)
    ref = HostBlock(lambda h, i, w: _ref_moe(h, w13, w2, i, w))
    blk = HostBlock(krasis)
    blk.load_state_dict(ref.state_dict())
    return blk, ref


def _x(seed, rows=T, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((rows, H))
                            .astype(np.float32)).to(dtype)


def test_host_block_with_krasis_moe_matches_reference(weights):
    w13, w2 = map(torch.from_numpy, weights)
    blk, ref = _blocks(KrasisTpuMoE(w13, w2, K), w13, w2)
    x = _x(1)
    with torch.no_grad():
        torch.testing.assert_close(blk(x), ref(x), rtol=2e-4, atol=2e-4)


def test_host_block_quantized_close(weights):
    """The same embedding with int4-on-ingest weights: close, not exact."""
    w13, w2 = map(torch.from_numpy, weights)
    blk, ref = _blocks(KrasisTpuMoE(w13, w2, K, expert_bits=4, group_size=32), w13, w2)
    x = _x(1)
    with torch.no_grad():
        got, want = blk(x), ref(x)
    err = float((got - want).abs().max() / (want.abs().max() + 1e-9))
    assert err < 0.05, err


def test_split_ownership_masking(weights):
    """Two wrappers each own half the experts (global ids, -1 masks the
    other owner's picks); their outputs sum to the full wrapper's."""
    w13, w2 = map(torch.from_numpy, weights)
    x = _x(3)
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.choice(E, size=(T, K)).astype(np.int32))
    wts = torch.from_numpy(rng.random((T, K), np.float32))
    full = KrasisTpuMoE(w13, w2, K)(x, idx, wts)
    halves = []
    for lo, hi in ((0, E // 2), (E // 2, E)):
        local = (idx >= lo) & (idx < hi)
        halves.append(KrasisTpuMoE(w13[lo:hi], w2[lo:hi], K)(
            x, torch.where(local, idx - lo, -1), wts))
    torch.testing.assert_close(halves[0] + halves[1], full, rtol=2e-4, atol=2e-4)


def test_forward_routed_from_host_gate(weights):
    """forward_routed: the host hands raw gate weights; routing runs
    compute_routing as the model does."""
    w13, w2 = map(torch.from_numpy, weights)
    cfg = preset_config("qwen3-moe", **CFG)
    rng = np.random.default_rng(5)
    gate_w = torch.from_numpy((rng.standard_normal((H, E)) * 0.1).astype(np.float32))
    x = _x(6)
    moe = KrasisTpuMoE(w13, w2, K)
    r = compute_routing(x, gate_w, cfg)
    torch.testing.assert_close(moe.forward_routed(x, gate_w, cfg),
                               moe(x, r.topk_idx, r.topk_weights), rtol=1e-6, atol=1e-6)


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    rms = float(np.sqrt(np.mean(want ** 2)))
    assert np.all(np.isfinite(got))
    over = np.abs(got - want) / (TOL * (np.abs(want) + rms))
    assert over.max() <= 1.0, (float(over.max()), float(np.abs(got - want).max()))


def _pair(weights, bits):
    w13, w2 = weights
    kw = dict(expert_bits=bits, group_size=32) if bits else {}
    return (KrasisTpuMoE(torch.from_numpy(w13), torch.from_numpy(w2), K, **kw),
            JaxKrasisTpuMoE(jnp.asarray(w13), jnp.asarray(w2), K, **kw))


@pytest.mark.parametrize("rows", [1, T])
@pytest.mark.parametrize("bits", [0, 4])
def test_masked_picks_match_the_jax_module(weights, bits, rows):
    """A third of the picks masked with -1: the port (pick_valid, weight 0)
    against the reference's clamp-and-zero, bf16 rows as a model passes
    them."""
    port, ref = _pair(weights, bits)
    rng = np.random.default_rng(7 + rows)
    x = rng.standard_normal((rows, H)).astype(np.float32)
    idx = np.stack([rng.choice(E, K, replace=False) for _ in range(rows)]).astype(np.int32)
    idx[(np.arange(rows * K) % 3 == 0).reshape(rows, K)] = -1
    wts = rng.random((rows, K)).astype(np.float32)
    got = port(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(idx),
               torch.from_numpy(wts))
    want = ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(idx), jnp.asarray(wts))
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # a masked pick adds nothing: all picks masked give zeros on both sides
    none = np.full_like(idx, -1)
    assert not port(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(none),
                    torch.from_numpy(wts)).any()


@pytest.mark.parametrize("bits", [0, 4])
def test_forward_routed_matches_the_jax_module(weights, bits):
    port, ref = _pair(weights, bits)
    rng = np.random.default_rng(5)
    gate_w = (rng.standard_normal((H, E)) * 0.1).astype(np.float32)
    x = rng.standard_normal((T, H)).astype(np.float32)
    got = port.forward_routed(torch.from_numpy(x), torch.from_numpy(gate_w),
                              preset_config("qwen3-moe", **CFG))
    want = ref.forward_routed(jnp.asarray(x), jnp.asarray(gate_w),
                              jax_preset_config("qwen3-moe", **CFG))
    _close(got.numpy(), np.asarray(want))
