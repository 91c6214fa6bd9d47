"""Sequence parallelism: each layer's MLP rows of a prefill split over an
``sp`` mesh axis (PyTorch).

The port of ``krasis_tpu/parallel/sp.py``. Prefill's work sits in the
MLPs, which are per token; attention couples positions and DeltaNet is a
recurrence, so both stay replicated: they run once on the mesh's first
device, which writes the one cache, valid for the ordinary decode. Each
layer's MLP then runs shard s's contiguous slice of the rows on grid row
s's devices (routing inside the slice) and the slices are gathered back
in order (``models/model._mlp``); rows that do not divide run whole.
Composed with ``ep`` on the second axis, each sp shard's experts are split
over the devices of its row (sp × ep).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from ..config import ModelConfig, QuantConfig
from ..models.model import forward
from .mesh import Mesh, _Placer, make_mesh, shard_layer

MLP_KEYS = ("mlp_w13", "mlp_w2", "gate_w", "gate_bias", "gate_logit_bias", "w13", "w2",
            "w13_bias", "w2_bias", "shared_w13", "shared_w2", "shared_gate_w")


def make_sp_mesh(n_devices: Optional[int] = None, ep: int = 1,
                 devices: Optional[Sequence] = None) -> Mesh:
    """An sp × ep mesh (tokens over sp, experts over ep) over the first n
    cards, or over `devices` (``make_mesh``'s rules)."""
    n = n_devices or (len(devices) if devices is not None else torch.cuda.device_count())
    if ep < 1 or n % ep:
        raise ValueError(f"{n} devices do not split into ep={ep}")
    return Mesh(make_mesh(n, dp=n // ep, devices=devices).devices, ("sp", "ep"))


def sp_shard_params(params: Dict[str, Any], cfg: ModelConfig, mesh: Mesh) -> Dict[str, Any]:
    """Every leaf on the mesh's first device, and each layer's MLP leaves
    for sp shard s on row s's devices (``_sp``; experts split over the row
    when ep > 1)."""
    place, home = _Placer(), mesh.home(0)
    layers = []
    for lp in params["layers"]:
        out = {k: place(v, home) for k, v in lp.items()}
        mlp = {k: v for k, v in lp.items() if k in MLP_KEYS}
        out["_sp"] = [dict(shard_layer(mlp, cfg, row, place),
                           _device=row[0]) for row in mesh.devices]
        layers.append(out)
    return {**{k: place(params[k], home) for k in ("embed", "final_norm", "lm_head")},
            "layers": layers}


def make_sp_prefill_fns(cfg: ModelConfig, quant: QuantConfig, mesh: Mesh):
    """(prefill_fn, chunk_fn_factory): prefill_fn(params, tokens, seq_lens,
    cache) runs the ordinary prefill forward with every layer's MLP rows
    split over sp; chunk_fn_factory(history) the same for a later chunk
    after `history` cached tokens. `params` are the ordinary ones (split
    when first seen); the cache is the ordinary one on the mesh's first
    device, and what they leave in it is valid for the ordinary decode."""
    seen: Dict[int, Any] = {}

    def sharded(params):
        if id(params) not in seen:
            seen.clear()
            seen[id(params)] = (params, sp_shard_params(params, cfg, mesh))
        return seen[id(params)][1]

    def chunk_fn_factory(history: int):
        def fn(params, tokens, seq_lens, cache):
            return forward(sharded(params), tokens, seq_lens, cache, cfg, quant, prefill=True,
                           history=history)
        return fn

    return chunk_fn_factory(0), chunk_fn_factory
