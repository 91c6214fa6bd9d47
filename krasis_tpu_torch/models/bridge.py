"""Carry the reference package's parameters into the port.

``params_from_numpy`` takes the tree that ``krasis_tpu.models.params``
builds (``init_synthetic_params`` plus ``fold_shared_experts``) with every
leaf already a numpy array and every QTensor given as a dict
``{q, scales, bits, group_size}``, and returns the port's parameters, so
both packages compute from the same values. It imports neither jax nor the
reference package: the caller does the jax → numpy step.

The reference's layout is ``prefix_layers`` plus ``pattern`` entries whose
leaves carry a leading ``reps`` dim; ``params.params_from_stacked`` turns
it into the port's ``layers`` list (prefix layers, then pattern × reps in
the order of ``pattern_layer_index``) with views. Expert stacks and dense
leaves become per-layer views, GPT-OSS's sinks, projection and expert
biases and router logit biases among them. A quantized attention / DeltaNet
projection stack (``STACKED_PROJECTIONS``) stays whole: each layer of its
pattern position holds the same stack and its own ``_layer_idx``, as
``init_synthetic_params`` builds them. An ``mtp`` entry is carried over.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..quant import QTensor
from .params import params_from_stacked


def to_torch(a: np.ndarray, device) -> torch.Tensor:
    """numpy → torch, bit-exact. bf16 arrives as ml_dtypes.bfloat16, which
    torch.from_numpy refuses: it travels as int16 and is viewed back."""
    a = np.array(a, copy=True, order="C")      # writable, owned
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _leaf(v, device):
    if isinstance(v, dict) and "q" in v and "scales" in v:
        return QTensor(to_torch(v["q"], device), to_torch(v["scales"], device),
                       int(v["bits"]), int(v["group_size"]))
    return to_torch(v, device)


def params_from_numpy(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    def conv(v):
        if isinstance(v, dict) and not ("q" in v and "scales" in v):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, list):
            return [conv(x) for x in v]
        return _leaf(v, device)

    return params_from_stacked(conv(tree))
