"""Helpers for the tests that compare the PyTorch port with the JAX package:
moving JAX arrays, QTensors and parameter trees into the port via numpy."""

import numpy as np
import torch

from krasis_tpu.quant import QTensor as JaxQTensor
from krasis_tpu_torch.models.bridge import params_from_numpy, to_torch
from krasis_tpu_torch.quant import QTensor


def to_numpy_tree(tree):
    """JAX parameter tree → numpy leaves, QTensors as {q, scales, bits, group_size}."""
    if isinstance(tree, JaxQTensor):
        return {"q": np.asarray(tree.q), "scales": np.asarray(tree.scales),
                "bits": tree.bits, "group_size": tree.group_size}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def port_params(jax_params):
    return params_from_numpy(to_numpy_tree(jax_params), device="cpu")


def t(a) -> torch.Tensor:
    """A JAX or numpy array as a CPU torch tensor, bit-exact."""
    return to_torch(np.asarray(a), "cpu")


def tq(qt: JaxQTensor) -> QTensor:
    return QTensor(t(qt.q), t(qt.scales), qt.bits, qt.group_size)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)
