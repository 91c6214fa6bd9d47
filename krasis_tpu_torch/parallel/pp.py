"""Pipeline parallelism: contiguous blocks of the layer pattern's
repetitions on the devices of a ``pp`` mesh (PyTorch).

The port of ``krasis_tpu/parallel/pp.py``. Stage s holds reps / pp
contiguous repetitions of the repeated layer pattern (a contiguous block
of layers, the reference's stage split); the prefix layers and the
embedding run on stage 0's device and the final norm and lm_head on the
last stage's, none of them split. The hidden state moves from stage to
stage with ``.to(next device)``. One microbatch: the stages run one after
the other, the same layer work as the unsharded forward with the same
kernels in the same order, at 1 / pp of the per-device weight memory,
which is the point of PP. Each stage's layers keep their cache on its
device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from ..config import ModelConfig, QuantConfig
from ..models.model import make_layer_step, step_inputs
from ..models.params import STACKED_PROJECTIONS, layer_specs, pattern_info
from ..ops.norm import rms_norm
from ..ops.qmm import linear
from ..quant import QTensor
from .mesh import Mesh, _Placer, make_mesh


def make_pp_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D ``pp`` mesh over the first n cards, or over `devices`
    (``make_mesh``'s rules)."""
    return Mesh(make_mesh(n_devices, 1, devices).devices, ("pp",))


def pp_supported(cfg: ModelConfig, mesh: Optional[Mesh]) -> bool:
    if mesh is None or mesh.axis_names != ("pp",) or mesh.shape["pp"] <= 1:
        return False
    reps = pattern_info(cfg).reps
    return reps > 0 and reps % mesh.shape["pp"] == 0


def stage_of(cfg: ModelConfig, mesh: Mesh) -> List[int]:
    """Each layer's stage: the prefix layers stage 0, repetition r of the
    pattern stage r // (reps / pp)."""
    info = pattern_info(cfg)
    per = info.reps // mesh.shape["pp"]
    return [0 if i < info.prefix_n else (i - info.prefix_n) // info.period // per
            for i in range(cfg.num_hidden_layers)]


def pp_shard_params(params: Dict[str, Any], cfg: ModelConfig, mesh: Mesh) -> Dict[str, Any]:
    """Each layer on its stage's device. A quantized projection stack
    [reps, K(/2), N] shared by a pattern position's layers is cut to the
    stage's repetitions, and each layer's ``_layer_idx`` counted from the
    stage's first."""
    if not pp_supported(cfg, mesh):
        raise ValueError(f"PP needs pattern reps divisible by pp: reps="
                         f"{pattern_info(cfg).reps}, pp={mesh.shape['pp']}")
    info, devs, place = pattern_info(cfg), mesh.devices[0], _Placer()
    per = info.reps // mesh.shape["pp"]
    stages = stage_of(cfg, mesh)
    layers, cut = [], {}
    for i, (lp, s) in enumerate(zip(params["layers"], stages)):
        dev, out = devs[s], {}
        for k, v in lp.items():
            if k in STACKED_PROJECTIONS and isinstance(v, QTensor) and i >= info.prefix_n:
                key = (id(v), s)
                if key not in cut:
                    cut[key] = v[s * per:(s + 1) * per].to(dev)
                out[k] = cut[key]
            else:
                out[k] = place(v, dev)
        if "_layer_idx" in lp and i >= info.prefix_n:
            out["_layer_idx"] = lp["_layer_idx"] - s * per
        layers.append(out)
    return {"embed": place(params["embed"], devs[0]),
            "final_norm": place(params["final_norm"], devs[-1]),
            "lm_head": place(params["lm_head"], devs[-1]), "layers": layers, "mesh": mesh}


def pp_shard_cache(cache: Dict[str, Any], cfg: ModelConfig, mesh: Mesh) -> Dict[str, Any]:
    """Each layer's cache on its stage's device; the lengths on stage 0's."""
    devs = mesh.devices[0]
    return {"layers": [{k: v.to(devs[s]) for k, v in lc.items()}
                       for lc, s in zip(cache["layers"], stage_of(cfg, mesh))],
            "length": cache["length"].to(devs[0])}


def forward_pp(params: Dict[str, Any], tokens: torch.Tensor, seq_lens: torch.Tensor,
               cache: Dict[str, Any], cfg: ModelConfig, quant: QuantConfig, prefill: bool,
               return_all_logits: bool = False, history: int = 0) -> torch.Tensor:
    """``models/model.forward`` with the layers run stage by stage on their
    devices (parameters from ``pp_shard_params``, cache from
    ``pp_shard_cache``): the same numerics, in place on the cache; the
    logits on the last stage's device."""
    mesh: Mesh = params["mesh"]
    devs = mesh.devices[0]
    stages = stage_of(cfg, mesh)
    B, S = tokens.shape
    length = cache["length"]
    steps = {}

    def step_for(s: int):
        if s not in steps:
            dev = devs[s]
            buffers = [lc for lc, t in zip(cache["layers"], stages) if t == s]
            positions, valid, kv_len, at = step_inputs(length.to(dev), seq_lens.to(dev), S,
                                                       buffers, prefill)
            steps[s] = make_layer_step(
                cfg, prefill=prefill, positions=positions, valid=valid, kv_len=kv_len,
                activation="bf16" if prefill else quant.expert_activation,
                fresh=prefill and history == 0, at=at)
        return steps[s]

    x = params["embed"][tokens.to(devs[0])]
    for i, (lp, lc, spec) in enumerate(zip(params["layers"], cache["layers"], layer_specs(cfg))):
        x = step_for(stages[i])(x.to(devs[stages[i]]), lp, lc, spec, i)
    x = rms_norm(x.to(devs[-1]), params["final_norm"], cfg.rms_norm_eps, cfg.norm_plus_one)
    if not return_all_logits:
        last = torch.clamp(seq_lens.to(device=x.device, dtype=torch.int64) - 1, min=0)
        x = x[torch.arange(B, device=x.device), last]
    cache["length"] = length + seq_lens.to(device=length.device, dtype=length.dtype)
    return linear(x, params["lm_head"], out_dtype=torch.float32)


def make_pp_forward_fns(cfg: ModelConfig, quant: QuantConfig, mesh: Mesh):
    """(prefill_fn, decode_fn, prefill_all_logits_fn) over the ``pp`` mesh,
    as the reference's ``make_forward_fns``: prefill_fn(params, tokens,
    seq_lens, cache), decode_fn(params, tokens, cache)."""
    def prefill_fn(params, tokens, seq_lens, cache):
        return forward_pp(params, tokens, seq_lens, cache, cfg, quant, prefill=True)

    def decode_fn(params, tokens, cache):
        seq_lens = torch.ones((tokens.shape[0],), dtype=torch.int32, device=tokens.device)
        return forward_pp(params, tokens, seq_lens, cache, cfg, quant, prefill=False)

    def prefill_all_logits_fn(params, tokens, seq_lens, cache):
        return forward_pp(params, tokens, seq_lens, cache, cfg, quant, prefill=True,
                          return_all_logits=True)

    return prefill_fn, decode_fn, prefill_all_logits_fn
