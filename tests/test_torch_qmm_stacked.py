"""K1s: the plain stacked qmm against `qmm_stacked_pallas` in interpret
mode on the CPU, and `linear`'s handling of a stacked QTensor. Tolerance
2e-2, the reference's own for its qmm kernels (tests/test_pallas.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krasis_tpu.ops.qmm import linear as jax_linear
from krasis_tpu.ops.qmm_pallas import qmm_stacked_pallas, supported_stacked
from krasis_tpu.quant import quantize as jquantize
from krasis_tpu_torch.ops import qmm as port_qmm
from krasis_tpu_torch.ops import qmm_cuda
from krasis_tpu_torch.ops.qmm import linear
from krasis_tpu_torch.quant import dequantize

from torch_port_util import f32, t, tq

L, K, N = 3, 1024, 384      # K / gs = 8 groups: the Pallas kernel's own gate


def _bf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def _stack(bits, seed):
    rng = np.random.default_rng(seed)
    return jquantize(jnp.asarray(rng.standard_normal((L, K, N)) * 0.05, jnp.float32),
                     bits=bits, group_size=128)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("layer", [0, 2])
def test_qmm_stacked_plain_matches_pallas(bits, T, layer):
    w = _stack(bits, bits)
    x = _bf16(np.random.default_rng(T + layer).standard_normal((T, K)) * 0.5)
    assert supported_stacked(x, w)
    want = qmm_stacked_pallas(x, w, layer, out_dtype=jnp.float32, interpret=True)
    got = qmm_cuda.qmm_stacked(t(x), tq(w), layer, torch.float32)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)
    # not the neighbouring layer
    other = qmm_cuda.qmm_stacked(t(x), tq(w), 1, torch.float32)
    assert float(np.abs(f32(other) - f32(want)).max()) > 0.1


def test_stack_layer_is_a_view():
    """Indexing a stack copies nothing: layer l starts l layer-strides into
    the stack's own storage and is contiguous, which is what the kernel's
    in-place read of a layer relies on."""
    w = tq(_stack(4, 1))
    for l in range(L):
        lay = w[l]
        assert lay.q.data_ptr() == w.q.data_ptr() + l * w.q.stride(0) * w.q.element_size()
        assert lay.scales.data_ptr() == (w.scales.data_ptr()
                                         + l * w.scales.stride(0) * w.scales.element_size())
        assert lay.q.is_contiguous() and lay.scales.is_contiguous()
    assert (w.k_dim, w.n_dim) == (K, N) and w[1].k_dim == K
    np.testing.assert_array_equal(f32(dequantize(w, torch.float32)[1]),
                                  f32(dequantize(w[1], torch.float32)))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("T", [1, 40])
def test_linear_on_a_stack_matches_jax_linear(monkeypatch, bits, T):
    """Few rows take the stacked kernel's function, many rows a view of the
    layer, dequantize and one product; both equal the reference's `linear`
    with the same `layer_idx`."""
    w = _stack(bits, 10 + bits)
    x = _bf16(np.random.default_rng(T).standard_normal((2, T, K)) * 0.5)
    calls = []
    real = qmm_cuda.qmm_stacked
    monkeypatch.setattr(qmm_cuda, "qmm_stacked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for layer in (0, 2):
        want = jax_linear(x, w, layer_idx=layer)
        got = linear(t(x), tq(w), layer_idx=layer)
        assert got.shape == (2, T, N) and got.dtype == torch.bfloat16
        np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)
    assert len(calls) == (2 if 2 * T <= port_qmm.QMM_MAX_T else 0)
