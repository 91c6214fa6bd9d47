"""The port's quantized storage and weight bridge are bit-exact with the
JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.config import preset_config as jax_preset_config
from krasis_tpu.models.params import fold_shared_experts as jax_fold
from krasis_tpu.models.params import init_synthetic_params as jax_init
from krasis_tpu.models.params import pattern_info as jax_pattern_info
from krasis_tpu.models.synthetic import tiny_config as jax_tiny_config
from krasis_tpu.quant import dequantize_np
from krasis_tpu.quant import quantize as jquantize
from krasis_tpu.quant import slice_k as jslice_k
from krasis_tpu_torch.config import QuantConfig, preset_config
from krasis_tpu_torch.models.params import fold_shared_experts, pattern_info
from krasis_tpu_torch.models.synthetic import tiny_config
from krasis_tpu_torch.quant import QTensor, dequantize, quantize, slice_k

from torch_port_util import port_params, to_numpy_tree, tq

OVERRIDES = dict(moe_intermediate_size=128, num_hidden_layers=4)


def _bits(x) -> np.ndarray:
    """Raw bytes of a torch or numpy array, for bit-exact comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.contiguous().numpy().view(np.uint8)
    return np.ascontiguousarray(x).view(np.uint8)


@pytest.mark.parametrize("bits", [4, 8])
def test_dequantize_bit_exact(bits):
    rng = np.random.default_rng(bits)
    w = jnp.asarray(rng.standard_normal((3, 512, 256)) * 0.05, jnp.float32)
    qt = jquantize(w, bits=bits, group_size=128)
    got = dequantize(tq(qt), torch.float32).numpy()
    np.testing.assert_array_equal(got, dequantize_np(qt))


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_bit_exact(bits):
    rng = np.random.default_rng(10 + bits)
    w = (rng.standard_normal((384, 256)) * 0.05).astype(np.float32)
    want = jquantize(jnp.asarray(w), bits=bits, group_size=128)
    got = quantize(torch.from_numpy(w), bits, 128)
    np.testing.assert_array_equal(_bits(got.q), _bits(np.asarray(want.q)))
    np.testing.assert_array_equal(_bits(got.scales), _bits(np.asarray(want.scales)))


def test_int4_k_slice_bit_exact():
    """Group-aligned K slice of a packed int4 tensor re-pairs nibbles as the
    reference does (K/2 = 192 is not a multiple of the 128 group)."""
    rng = np.random.default_rng(3)
    w = jnp.asarray(rng.standard_normal((384, 128)) * 0.05, jnp.float32)
    qt = jquantize(w, bits=4, group_size=128)
    want = jslice_k(qt, 128, 256)
    got = slice_k(tq(qt), 128, 256)
    np.testing.assert_array_equal(_bits(got.q), _bits(np.asarray(want.q)))
    np.testing.assert_array_equal(_bits(got.scales), _bits(np.asarray(want.scales)))


def _assert_leaf_equal(got, want, where):
    if isinstance(want, dict):
        assert isinstance(got, QTensor), where
        assert (got.bits, got.group_size) == (want["bits"], want["group_size"]), where
        _assert_leaf_equal(got.q, want["q"], where + ".q")
        _assert_leaf_equal(got.scales, want["scales"], where + ".scales")
        return
    assert tuple(got.shape) == want.shape, where
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=where)


@pytest.mark.parametrize("layers", [2, 4, 27])
def test_pattern_info_matches(layers):
    """The stacking the bridge undoes: V2-Lite is 1 dense prefix layer plus
    one MoE layer repeated."""
    want = jax_pattern_info(jax_preset_config("deepseek-v2-lite", num_hidden_layers=layers))
    got = pattern_info(preset_config("deepseek-v2-lite", num_hidden_layers=layers))
    assert tuple(got) == tuple(want)


def test_bridge_round_trips_tiny_v2_lite_tree():
    jcfg = jax_tiny_config("deepseek-v2-lite", **OVERRIDES)
    jquant = JaxQuantConfig(expert_bits=4, group_size=128)
    tree = to_numpy_tree(jax_fold(jax_init(jcfg, jquant, jax.random.PRNGKey(0)),
                                  jcfg, jquant))
    params = port_params(tree)
    for name in ("embed", "final_norm", "lm_head"):
        _assert_leaf_equal(params[name], tree[name], name)
    reps = tree["pattern"][0]["input_norm"].shape[0]
    want_layers = list(tree["prefix_layers"]) + [
        {k: ({**v, "q": v["q"][r], "scales": v["scales"][r]} if isinstance(v, dict)
             else v[r]) for k, v in tree["pattern"][0].items()} for r in range(reps)]
    assert len(params["layers"]) == len(want_layers) == 4
    for i, (lp, want) in enumerate(zip(params["layers"], want_layers)):
        assert set(lp) == set(want), i
        for k in want:
            _assert_leaf_equal(lp[k], want[k], f"layers[{i}].{k}")


def test_fold_shared_experts_matches_reference():
    """Folding an unfolded tree in the port gives the reference's folded
    stacks and expert-bit shared leaves, bit for bit."""
    jcfg = jax_tiny_config("deepseek-v2-lite", **OVERRIDES)
    unfolded_q = JaxQuantConfig(expert_bits=4, group_size=128, fold_shared_decode=False)
    fold_q = JaxQuantConfig(expert_bits=4, group_size=128)
    unfolded = jax_init(jcfg, unfolded_q, jax.random.PRNGKey(1))
    want = port_params(jax_fold(unfolded, jcfg, fold_q))
    got = fold_shared_experts(port_params(unfolded),
                              tiny_config("deepseek-v2-lite", **OVERRIDES),
                              QuantConfig(expert_bits=4, group_size=128))
    E = jcfg.n_routed_experts
    assert got["layers"][1]["w13"].q.shape[0] == E + jcfg.n_shared_experts
    for i, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        for k in ("w13", "w2", "shared_w13", "shared_w2"):
            if k in w:
                _assert_leaf_equal(g[k], to_numpy_tree_q(w[k]), f"layers[{i}].{k}")


def to_numpy_tree_q(qt: QTensor):
    return {"q": _np(qt.q), "scales": _np(qt.scales), "bits": qt.bits,
            "group_size": qt.group_size}


def _np(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy()
    return x.numpy()
