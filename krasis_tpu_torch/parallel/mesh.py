"""Device mesh, and parameter and cache placement over it (PyTorch).

The port of ``krasis_tpu/parallel/mesh.py``. The reference's mesh is
single-controller: one process holds a ``jax.sharding.Mesh`` and GSPMD
splits the work. Here a ``Mesh`` is a dp × ep grid of ``torch.device``s in
one process, with the axes named ``dp`` and ``ep``:

* ``dp`` splits batch rows (the scheduler's slots) into groups; group d
  runs its rows on the devices of grid row d, its first device the rows'
  home, where the replicated work runs and the partials are combined;
* ``ep`` splits each routed expert stack on its expert dim into contiguous
  slices, one a device of the group, and, where the head counts divide and
  the projections are plain tensors, the attention heads too (q, k, v, o
  and MLA's ``w_kc`` / ``w_vc`` by head; the MLA latent and its cache are
  shared by the heads and kept once a device).

Each shard runs the ordinary forward and kernels on its slice
(``models/model.py``: ``_mlp``'s EP branch through ``parallel/ep.py``,
``_sharded_attention``); the partials come back to the home device and are
summed there in f32. A mesh may put several shards on one device (``make_mesh(...,
devices=["cuda:0"] * n)``), which runs every line of the sharded path on one
card; a leaf that is replicated is then held once a device, and the
expert and head slices are views of the one stack.

``shard_params`` returns the ordinary parameter dict of group 0 (its
``layers`` carry the sharded leaves), with ``mesh`` and ``dp`` (every
group's tree) added; ``cache_shardings`` lays an ``init_cache`` cache out
to match: the slots split over dp when they divide (``{"length", "dp":
[{"layers"}, ...]}``), and each head-sharded layer's buffers a list of
per-shard dicts (``{"shards": [...]}``).

``torch.distributed`` is used for the multi-host pieces alone
(``init_distributed``, ``make_multihost_mesh``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..config import ModelConfig
from ..quant import QTensor

EXPERT_KEYS = ("w13", "w2")
EXPERT_BIAS_KEYS = ("w13_bias", "w2_bias")

# head-sharded attention leaves: split on their output (by head), on their
# input (o_proj), on their head dim (MLA's absorb matrices), by head (GQA)
_TP_OUT = ("q_proj", "k_proj", "v_proj", "q_b_proj")
_TP_IN = ("o_proj",)
_TP_HEAD0 = ("w_kc", "w_vc")
_TP_VEC = ("q_bias", "k_bias", "v_bias", "sinks")
HEAD_KEYS = _TP_OUT + _TP_IN + _TP_HEAD0 + _TP_VEC
# replicated leaves the attention reads, held by each head shard as well
_ATTN_SHARED = ("q_a_proj", "q_a_norm", "kv_a_proj", "kv_a_norm", "q_norm", "k_norm",
                "_layer_idx")

OFFLOAD_MESH_ERROR = "--offload experts is single-chip for now (no --mesh)"


def _norm_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of devices: ``devices[d][e]`` holds ep shard e of dp group d
    (a mesh of one axis, such as ``pp``, is one row)."""

    devices: tuple
    axis_names: tuple = ("dp", "ep")

    @property
    def shape(self) -> Dict[str, int]:
        sizes = (len(self.devices), len(self.devices[0]))
        return dict(zip(self.axis_names, sizes[-len(self.axis_names):]))

    @property
    def dp(self) -> int:
        return len(self.devices)

    @property
    def ep(self) -> int:
        return len(self.devices[0])

    def home(self, d: int = 0) -> torch.device:
        return self.devices[d][0]

    def distinct(self) -> List[torch.device]:
        """The mesh's devices, each once, in grid order."""
        out: List[torch.device] = []
        for row in self.devices:
            out += [dev for dev in row if dev not in out]
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[[str(d) for d in row] for row in self.devices]})"


def make_mesh(n_devices: Optional[int] = None, dp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A dp × (n / dp) mesh over the first n cards, or over `devices` when the
    caller passes them (e.g. ``["cpu"] * n``, or ``["cuda:0"] * n`` to run
    every shard on one card). Fewer cards than shards raise, as the
    reference does: there is no fallback to fewer devices or to the CPU."""
    if devices is None:
        have = torch.cuda.device_count()
        n = n_devices or have
        if have < n or n == 0:
            raise ValueError(f"need {n} devices, have {have} (pass devices=[...] to put "
                             "several shards on one device, e.g. ['cpu'] * n)")
        devices = [f"cuda:{i}" for i in range(n)]
    else:
        n = n_devices or len(devices)
        if len(devices) < n:
            raise ValueError(f"need {n} devices, have {len(devices)}")
        devices = list(devices)[:n]
    if dp < 1 or n % dp:
        raise ValueError(f"{n} devices do not split into dp={dp}")
    from ..device import resolve_device

    for dev in set(str(d) for d in devices):
        resolve_device(dev)              # checks the device; sets the matmul flags
    devs = [_norm_device(d) for d in devices]
    ep = n // dp
    return Mesh(tuple(tuple(devs[r * ep:(r + 1) * ep]) for r in range(dp)))


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None) -> None:
    """Multi-host bring-up: ``torch.distributed.init_process_group`` from the
    arguments or the standard environment (``MASTER_ADDR`` / ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). Idempotent; a single process (no world size
    given or set) does nothing."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return
    world = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    if init_method is None:
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}")
    dist.init_process_group(backend or ("nccl" if torch.cuda.is_available() else "gloo"),
                            init_method=init_method, world_size=world, rank=rank)


def make_multihost_mesh(dp: Optional[int] = None, ep_per_host: Optional[int] = None,
                        devices: Optional[Sequence] = None) -> Mesh:
    """dp × ep for multi-host serving: ep spans one host's cards, dp the
    hosts, whose rows exchange nothing on the serving path. In a single
    process (no process group, or a world of one) it is ``make_mesh(dp · ep,
    dp)``; across processes each one serves its host's row, a 1 × ep mesh
    over its own cards."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    local = torch.cuda.device_count() if devices is None else len(devices)
    dp = dp or world
    ep = ep_per_host or (local * world // dp)
    if world == 1:
        return make_mesh(dp * ep, dp=dp, devices=devices)
    if dp != world:
        raise ValueError(f"a multi-host mesh has one dp row a process: dp={dp}, world={world}")
    return make_mesh(ep, dp=1, devices=devices)


class _Placer:
    """Puts leaves on devices, once a (leaf, device): a leaf shared by
    several layers or shards on one device is one tensor there, and a
    tensor already on the device is taken as it is."""

    def __init__(self):
        self._memo: Dict[Any, Any] = {}

    def __call__(self, leaf, dev: torch.device):
        if isinstance(leaf, QTensor):
            key = (id(leaf), dev)
            if key not in self._memo:
                self._memo[key] = (leaf, QTensor(leaf.q.to(dev), leaf.scales.to(dev),
                                                 leaf.bits, leaf.group_size))
            return self._memo[key][1]
        if isinstance(leaf, torch.Tensor):
            key = (id(leaf), dev)
            if key not in self._memo:
                self._memo[key] = (leaf, leaf.to(dev))
            return self._memo[key][1]
        return leaf


def _split(w, dim: int, e: int, n: int):
    """Part e of n of w along dim (a view); a QTensor along a leading dim."""
    if isinstance(w, QTensor):
        size = w.q.shape[dim] // n
        return w[e * size:(e + 1) * size]
    size = w.shape[dim] // n
    return w.narrow(dim, e * size, size)


def heads_shardable(lp: Dict[str, Any], cfg: ModelConfig, n: int) -> bool:
    """Whether a layer's attention splits by head over n shards: GQA or MLA,
    both head counts divisible by n, and every projection that the split
    cuts a plain tensor (a quantized one stays whole, as the reference keeps
    it, and then the whole layer's attention runs unsplit)."""
    if n <= 1 or cfg.num_attention_heads % n or cfg.num_key_value_heads % n:
        return False
    if "o_proj" not in lp or not ("q_proj" in lp or "q_b_proj" in lp):
        return False
    return not any(isinstance(lp.get(k), QTensor) for k in _TP_OUT + _TP_IN)


def experts_shardable(lp: Dict[str, Any], n: int, E: int) -> bool:
    """The reference's ``ep_supported`` on a layer's leaves: quantized
    stacks whose E routed experts divide over n > 1 shards."""
    w13, w2 = lp.get("w13"), lp.get("w2")
    return (n > 1 and isinstance(w13, QTensor) and isinstance(w2, QTensor)
            and w13.q.dim() == 3 and E % n == 0)


def _head_shard(lp: Dict[str, Any], e: int, n: int, dev, place):
    """Shard e of n of a layer's attention leaves, on dev."""
    out: Dict[str, Any] = {"_device": dev}
    for k in _ATTN_SHARED:
        if k in lp:
            out[k] = place(lp[k], dev)
    for k in HEAD_KEYS:
        if k in lp:
            w = lp[k]
            out[k] = _split(w, w.dim() - 1 if k in _TP_OUT else 0, e, n).to(dev)
    return out


def expert_shards(lp: Dict[str, Any], devs: Sequence[torch.device]) -> List[Dict[str, Any]]:
    """A layer's expert stacks (and biases) split over `devs`, a shard a
    device: dicts of ``w13``, ``w2``, their biases and ``_device``."""
    n = len(devs)
    return [dict({k: _split(lp[k], 0, e, n).to(dev) for k in EXPERT_KEYS + EXPERT_BIAS_KEYS
                  if lp.get(k) is not None}, _device=dev) for e, dev in enumerate(devs)]


def strip_virtual(w, E: int):
    """An expert stack without the folded shared experts' rows past E (a
    view): under a mesh the shared experts are computed densely."""
    if isinstance(w, QTensor):
        return w[:E] if w.q.shape[0] > E else w
    return w[:E] if w.dim() >= 3 and w.shape[0] > E else w


def shard_layer(lp: Dict[str, Any], cfg: ModelConfig, devs: Sequence[torch.device],
                place: Optional[_Placer] = None) -> Dict[str, Any]:
    """One layer on the devices `devs` of a dp group (devs[0] its home):
    experts split over them (``_ep``: one dict a shard, ``w13`` / ``w2``
    and their biases and ``_device``), attention by head where it splits
    (``_heads``), everything else replicated on the home device."""
    place = place or _Placer()
    n, home = len(devs), devs[0]
    E = cfg.n_routed_experts
    lp = {k: (strip_virtual(v, E) if k in EXPERT_KEYS else v) for k, v in lp.items()}
    experts = experts_shardable(lp, n, E)
    heads = heads_shardable(lp, cfg, n)
    skip = (EXPERT_KEYS + EXPERT_BIAS_KEYS if experts else ()) + (HEAD_KEYS if heads else ())
    out = {k: place(v, home) for k, v in lp.items() if k not in skip}
    if experts:
        out["_ep"] = expert_shards(lp, devs)
    if heads:
        out["_heads"] = [_head_shard(lp, e, n, dev, place) for e, dev in enumerate(devs)]
    return out


def shard_params(params: Dict[str, Any], cfg: ModelConfig, mesh: Mesh) -> Dict[str, Any]:
    """The parameters laid out over `mesh` (see the module docstring). Leaves
    go from wherever they are straight to their shard's device (a host tree
    from the weight cache included); idempotent for the same mesh."""
    if params.get("mesh") is mesh:
        return params
    if "mesh" in params:
        raise ValueError("these parameters are sharded over another mesh")
    place = _Placer()
    groups = []
    for d in range(mesh.dp):
        devs, home = mesh.devices[d], mesh.home(d)
        tree = {k: place(params[k], home) for k in ("embed", "final_norm", "lm_head")}
        tree["layers"] = [shard_layer(lp, cfg, devs, place) for lp in params["layers"]]
        if "mtp" in params:
            tree["mtp"] = {k: (shard_layer(v, cfg, devs, place) if k == "layer"
                               else place(v, home)) for k, v in params["mtp"].items()}
        groups.append(tree)
    return {**groups[0], "mesh": mesh, "dp": groups}


def placed(params: Dict[str, Any], cfg: ModelConfig, mesh: Optional[Mesh], device, offload):
    """(params, device) of an engine or scheduler: over `mesh`, the params
    sharded (unless they already are) and the mesh's first device, where
    its own tensors live; offload with a mesh refused, as the reference's
    server refuses it. Without a mesh, the params and `device` resolved."""
    from ..device import resolve_device

    if mesh is None:
        return params, resolve_device(device)
    if offload is not None:
        raise ValueError(OFFLOAD_MESH_ERROR)
    return shard_params(params, cfg, mesh), mesh.home(0)


def _layer_cache(lc: Dict[str, Any], lp: Dict[str, Any], rows: slice, home) -> Dict[str, Any]:
    if "_heads" not in lp:
        return {k: v[rows].to(home) for k, v in lc.items()}
    shards = []
    if "kv" in lc:                       # MLA: the latent cache, once a device
        per_dev: Dict[torch.device, torch.Tensor] = {}
        for sh in lp["_heads"]:
            dev = sh["_device"]
            if dev not in per_dev:
                per_dev[dev] = lc["kv"][rows].to(dev)
            shards.append({"kv": per_dev[dev]})
    else:                                # GQA: each shard its kv heads
        n = len(lp["_heads"])
        for e, sh in enumerate(lp["_heads"]):
            shards.append({k: _split(v[rows], 1, e, n).to(sh["_device"]).contiguous()
                           for k, v in lc.items()})
    return {"shards": shards}


def cache_shardings(cache: Dict[str, Any], params: Dict[str, Any]) -> Dict[str, Any]:
    """An ``init_cache`` (or ``init_mtp_cache``) cache laid out for sharded
    `params`: the slots split over dp when they divide (each group's rows on
    its devices; the lengths stay one [B] tensor on the home of group 0),
    else every row on group 0; a head-sharded layer's buffers per shard.
    The reference's ``cache_shardings`` (slots over dp)."""
    mesh: Mesh = params["mesh"]
    B = cache["length"].shape[0]
    split = mesh.dp > 1 and B % mesh.dp == 0
    n = mesh.dp if split else 1
    b = B // n
    mtp = "layer" in cache
    groups = []
    for d in range(n):
        rows, home, gp = slice(d * b, (d + 1) * b), mesh.home(d), params["dp"][d]
        if mtp:
            groups.append({"layer": _layer_cache(cache["layer"], gp["mtp"]["layer"], rows, home)})
        else:
            groups.append({"layers": [_layer_cache(lc, lp, rows, home)
                                      for lc, lp in zip(cache["layers"], gp["layers"])]})
    length = cache["length"].to(mesh.home(0))
    if split:
        return {"length": length, "dp": groups}
    return {**groups[0], "length": length}


def dp_groups(params: Dict[str, Any], cache: Dict[str, Any], run, rows: Sequence[torch.Tensor]):
    """`run(group params, group cache, *group rows)` for each dp group of a
    cache whose slots split over dp, each group's slice of the [B, ...]
    tensors `rows` moved to its home; the group caches' lengths are joined
    into cache["length"] after, and the outputs (a tensor or a tuple of
    them) joined on the home of group 0."""
    mesh: Mesh = params["mesh"]
    groups = cache["dp"]
    b = cache["length"].shape[0] // len(groups)
    home0 = mesh.home(0)
    outs, lengths = [], []
    for d, (gp, gc) in enumerate(zip(params["dp"], groups)):
        sl, dev = slice(d * b, (d + 1) * b), mesh.home(d)
        sub = {**gc, "length": cache["length"][sl].to(dev)}
        outs.append(run(gp, sub, *(t[sl].to(dev) for t in rows)))
        lengths.append(sub["length"].to(home0))
    cache["length"] = torch.cat(lengths)
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([o[i].to(home0) for o in outs]) for i in range(len(outs[0])))
    return torch.cat([o.to(home0) for o in outs])


def slot_layers(cache: Dict[str, Any], slot: int, key: str = "layers"):
    """(the layer caches holding `slot`, its row there) of a cache laid out
    by ``cache_shardings`` or a plain one."""
    if "dp" not in cache:
        return cache[key], slot
    b = cache["length"].shape[0] // len(cache["dp"])
    return cache["dp"][slot // b][key], slot % b


def copy_row(dst, src, row: int) -> None:
    """dst[row] = src[0] over matching trees of buffers (dicts, lists), each
    buffer once (a latent cache shared by head shards on one device)."""
    done = set()

    def walk(a, b):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            for x, y in zip(a, b):
                walk(x, y)
        elif id(a) not in done:
            done.add(id(a))
            a[row].copy_(b[0])

    walk(dst, src)


def shard_cfg(cfg: ModelConfig, n: int) -> ModelConfig:
    """The configuration one of n head shards sees."""
    return replace(cfg, num_attention_heads=cfg.num_attention_heads // n,
                   num_key_value_heads=cfg.num_key_value_heads // n)


def shard_bytes(params: Dict[str, Any]) -> Dict[str, int]:
    """Bytes of tensors held on each device of sharded `params` (each tensor
    storage counted once): the mesh's per-card weight footprint."""
    seen, out = set(), {}

    def walk(x):
        if isinstance(x, QTensor):
            walk(x.q)
            walk(x.scales)
        elif isinstance(x, torch.Tensor):
            key = (x.untyped_storage().data_ptr(), str(x.device))
            if key not in seen:
                seen.add(key)
                out[str(x.device)] = out.get(str(x.device), 0) + x.untyped_storage().nbytes()
        elif isinstance(x, dict):
            for k, v in x.items():
                if k not in ("mesh", "dp"):
                    walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    for gp in params["dp"]:
        walk(gp)
    return out


def position_bytes(params: Dict[str, Any]) -> int:
    """Weight bytes that shard 0 of dp group 0 of sharded `params` would hold
    on a card of its own: the replicated leaves and its expert and head
    slices (``budget.BudgetReport.per_chip``'s quantity)."""
    seen, total = set(), 0

    def add(v):
        nonlocal total
        if isinstance(v, QTensor):
            add(v.q)
            add(v.scales)
        elif isinstance(v, torch.Tensor) and id(v) not in seen:
            seen.add(id(v))
            total += v.numel() * v.element_size()

    for k in ("embed", "final_norm", "lm_head"):
        add(params[k])
    layers = params["layers"] + ([params["mtp"]["layer"]] if "mtp" in params else [])
    for lp in layers:
        for k, v in lp.items():
            if not k.startswith("_"):
                add(v)
        for key in ("_ep", "_heads"):
            for v in lp.get(key, [{}])[0].values():
                add(v)
    return total
