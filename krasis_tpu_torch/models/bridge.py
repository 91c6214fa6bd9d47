"""Carry the reference package's parameters into the port.

``params_from_numpy`` takes the tree that ``krasis_tpu.models.params``
builds (``init_synthetic_params`` plus ``fold_shared_experts``) with every
leaf already a numpy array and every QTensor given as a dict
``{q, scales, bits, group_size}``, and returns the port's parameters, so
both packages compute from the same values. It imports neither jax nor the
reference package: the caller does the jax → numpy step.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..quant import QTensor


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
    prefix = [{k: _leaf(v, device) for k, v in lp.items()}
              for lp in tree["prefix_layers"]]
    pattern = [{k: _leaf(v, device) for k, v in lp.items()}
               for lp in tree["pattern"]]
    layers = list(prefix)
    if pattern:
        reps = pattern[0]["input_norm"].shape[0]
        for r in range(reps):
            for lp in pattern:
                layers.append({k: v[r] for k, v in lp.items()})  # views
    return {
        "embed": to_torch(tree["embed"], device),
        "final_norm": to_torch(tree["final_norm"], device),
        "lm_head": _leaf(tree["lm_head"], device),
        "layers": layers,
    }
