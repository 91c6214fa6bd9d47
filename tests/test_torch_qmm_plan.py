"""K1 / K1s on the CPU: the launch plan (`qmm_cuda.plan`) for every
quantized few-row product that the presets and `tiny_config` reach, the
split-K partition it gives the kernel, and the plain version against
`qmm_pallas` in interpret mode at T = 16. Tolerance 2e-2, the reference's
own for its qmm kernels (tests/test_pallas.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.ops.qmm_pallas import qmm_pallas
from krasis_tpu.quant import quantize as jquantize
from krasis_tpu_torch.config import QuantConfig, preset_config
from krasis_tpu_torch.models.params import init_synthetic_params, layer_specs
from krasis_tpu_torch.models.synthetic import tiny_config
from krasis_tpu_torch.ops import qmm_cuda
from krasis_tpu_torch.quant import QTensor, dequantize, pick_group_size, quantize

from torch_port_util import f32, t, tq

EXPERT_STACKS = {"w13", "w2"}       # the MoE kernels' weights, not K1's


def k1_shapes(cfg, quant):
    """(name, K, N, bits, gs) of every weight that `linear` may hand to
    K1 / K1s (T <= 16): the lm_head, the dense MLP, the shared experts'
    dense form and the attention projections, as `_init_layer` quantizes
    them."""
    H = cfg.hidden_size
    bits_of = {"int8": 8, "int4": 4}
    floor8 = "int8" if quant.attention == "int4" else quant.attention
    out = []

    def add(name, K, N, mode, group_size=quant.group_size):
        bits = quant.expert_bits if mode == "expert" else bits_of.get(mode)
        if bits:
            out.append((name, K, N, bits, pick_group_size(K, group_size)))

    add("lm_head", H, cfg.vocab_size, quant.lm_head)
    for spec in layer_specs(cfg):
        hq = cfg.num_attention_heads
        if spec.attn_kind == "gqa":
            d, hkv = cfg.qk_head_dim, cfg.num_key_value_heads
            gated = cfg.model_type in ("qwen3_next", "qwen3_5_moe_text")
            add("q_proj", H, hq * d * (2 if gated else 1), quant.attention)
            add("k_proj", H, hkv * d, quant.attention)
            add("v_proj", H, hkv * d, quant.attention)
            add("o_proj", hq * d, H, quant.attention)
        elif spec.attn_kind == "mla":
            dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
            add("q_proj", H, hq * (dn + dr), quant.attention)
            add("kv_a_proj", H, cfg.kv_lora_rank + dr, floor8)
            add("o_proj", hq * cfg.v_head_dim, H, quant.attention)
        else:
            kd = cfg.linear_num_key_heads * cfg.linear_key_head_dim
            vd = cfg.linear_num_value_heads * cfg.linear_value_head_dim
            add("qkvz_proj", H, 2 * kd + 2 * vd, floor8)
            add("ba_proj", H, 2 * cfg.linear_num_value_heads, floor8)
            add("la_out_proj", vd, H, floor8)
        if spec.mlp_kind == "dense":
            add("mlp_w13", H, 2 * cfg.intermediate_size, quant.dense_mlp)
            add("mlp_w2", cfg.intermediate_size, H, quant.dense_mlp)
        elif cfg.n_shared_experts > 0:
            I = cfg.moe_intermediate_size
            Is = cfg.shared_expert_intermediate_size or I * cfg.n_shared_experts
            gs2 = pick_group_size(I, quant.group_size)
            # folded into the decode stack, they are held at expert bits
            if (quant.fold_shared_decode and quant.expert_bits in (4, 8) and Is % I == 0
                    and not (quant.expert_bits == 4 and I % 2) and I % gs2 == 0):
                add("shared_w13", H, 2 * Is, "expert")
                add("shared_w2", Is, H, "expert", gs2)
            else:
                add("shared_w13", H, 2 * Is, quant.shared_expert)
                add("shared_w2", Is, H, quant.shared_expert)
    return sorted(set(out))


QUANTS = [QuantConfig(expert_bits=4, group_size=128),
          QuantConfig(expert_bits=4, group_size=128, attention="int8"),
          QuantConfig(expert_bits=8, group_size=128, attention="int4")]
PRESETS = ["deepseek-v2-lite", "qwen3-moe", "qwen3-coder-next", "qcn-1chip"]


def _all_shapes():
    cfgs = [preset_config(p) for p in PRESETS] + [tiny_config(p) for p in PRESETS]
    return sorted({s[1:] for c in cfgs for q in QUANTS for s in k1_shapes(c, q)})


def _qtensors(tree):
    if isinstance(tree, QTensor):
        yield tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            if k not in EXPERT_STACKS:
                yield from _qtensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _qtensors(v)


@pytest.mark.parametrize("preset", ["deepseek-v2-lite", "qwen3-coder-next"])
def test_shape_list_matches_the_tiny_models_weights(preset):
    """The shape list above is the set of quantized non-expert weights a
    tiny model really holds."""
    cfg, quant = tiny_config(preset), QUANTS[1]
    params = init_synthetic_params(cfg, quant, seed=0)
    held = {(w.k_dim, w.n_dim, w.bits, w.group_size) for w in _qtensors(params)}
    assert held == {s[1:] for s in k1_shapes(cfg, quant)}


def test_the_full_presets_reach_the_main_path_shapes():
    shapes = _all_shapes()
    for K, N, bits in ((2048, 102400, 8), (2048, 151936, 8), (2048, 12288, 8), (2048, 64, 8),
                       (4096, 2048, 8), (2048, 8192, 8), (2048, 512, 8), (10944, 2048, 8),
                       (2048, 21888, 8)):
        assert any(s[:3] == (K, N, bits) for s in shapes), (K, N, bits)


@pytest.mark.parametrize("T", [1, 16])
def test_plan_splits_and_grid(T):
    for K, N, bits, gs in _all_shapes() + [(512, 388, 8, 128), (512, 388, 4, 128),
                                             (1408, 2048, 4, 128), (2064, 100, 4, 16)]:
        p = qmm_cuda.plan(T, K, N, bits, gs)
        rows = K // 2 if bits == 4 else K
        assert p.tt == (1 if T == 1 else 16)
        assert p.ks in (1, 2, 4, 8) and p.pk in (64, 128)
        # the splits run over whole groups (half groups where int4's K/2 is
        # not a multiple of the group), in order, none empty
        assert p.unit in (gs, gs // 2) and rows % p.unit == 0
        ranges = p.split_rows(rows)
        assert ranges[0][0] == 0 and ranges[-1][1] == rows
        for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
            assert a1 == b0
        assert all(r0 % p.unit == 0 and r1 > r0 for r0, r1 in ranges)
        # the grid covers N in 128-column tiles, ks CTAs (a cluster) each
        tiles, one, ks = p.grid
        assert one == 1 and ks == p.ks and (tiles - 1) * qmm_cuda.COLS < N <= tiles * qmm_cuda.COLS
        # the fewest splits that give 2.5 CTAs an SM, unless splits run out
        target = 5 * qmm_cuda.SMS / 2
        assert tiles * ks >= target or ks == 8 or 2 * ks > rows // p.unit
        assert ks == 1 or tiles * ks / 2 < target


def test_plan_refuses_more_than_16_rows():
    with pytest.raises(ValueError):
        qmm_cuda.plan(17, 2048, 512, 8, 128)


def _split_sum(x, qt, p):
    """The kernel's arithmetic order over the plan's splits: each split's
    f32 partial (both nibble halves of its packed rows for int4), summed in
    rank order."""
    w = dequantize(qt, torch.bfloat16).to(torch.float32)
    xf = x.to(torch.float32)
    K = qt.k_dim
    rows = K // 2 if qt.bits == 4 else K
    total = torch.zeros((x.shape[0], qt.n_dim))
    for r0, r1 in p.split_rows(rows):
        ks = [slice(r0, r1)] + ([slice(K // 2 + r0, K // 2 + r1)] if qt.bits == 4 else [])
        total = total + sum(xf[:, k] @ w[k] for k in ks)
    return total


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K,N", [(1408, 388), (2048, 64)])
def test_split_partition_sums_to_the_product(bits, K, N):
    """Summing the splits' partials in rank order gives the product: the
    partition covers every row once, int4's high half included."""
    g = torch.Generator().manual_seed(K + N + bits)
    qt = quantize(torch.randn((K, N), generator=g) * 0.05, bits, 128)
    x = torch.randn((3, K), generator=g).to(torch.bfloat16)
    p = qmm_cuda.plan(3, K, N, bits, qt.group_size)
    assert p.ks > 1
    want = qmm_cuda.qmm_plain(x, qt, torch.float32)
    np.testing.assert_allclose(_split_sum(x, qt, p).numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bits", [4, 8])
def test_qmm_plain_matches_pallas_at_16_rows(bits):
    rng = np.random.default_rng(20 + bits)
    w = jquantize(jnp.asarray(rng.standard_normal((512, 256)) * 0.05, jnp.float32),
                  bits=bits, group_size=128)
    x = jnp.asarray(rng.standard_normal((16, 512)) * 0.5, jnp.float32).astype(jnp.bfloat16)
    want = qmm_pallas(x, w, out_dtype=jnp.float32, interpret=True)
    got = qmm_cuda.qmm(t(x), tq(w), torch.float32)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)
