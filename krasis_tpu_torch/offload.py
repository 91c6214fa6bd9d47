"""Host-RAM expert offload: serve MoE models whose experts exceed the card.

The port of ``krasis_tpu/offload.py``. Attention, norms, routing, the shared
expert and the head stay on the card; each MoE layer's routed experts live
in host memory and are computed there by the C++ engine
(``native/hostmoe.cpp``), against the same packed INT4 / INT8 bytes and bf16
group scales the device kernels read (``quant.py``).

* ``HostExpertStore`` holds the routed stacks of every MoE layer (absolute
  layer index) as CPU tensors, pinned when the engine runs on the card, and
  runs a layer's picks: ``forward`` on the C++ engine, ``_forward_plain``
  (the engine's plain version, in PyTorch on CPU tensors) only when the
  caller asks for it (``plain=True``). It counts an expert heatmap (the
  hot-expert cache's input) and its host calls, seconds and live picks.
* ``dispatch`` / ``collect`` move one MoE layer's work across: the
  activations, ids and weights go down in one copy into a pinned buffer
  with an event recorded, the card goes on with the hot and shared experts,
  then ``collect`` waits on the event, runs the engine into a pinned output
  buffer and copies the result up, all without a device-wide sync.
* ``store_from_params`` splits a resident parameter tree into the device
  tree without routed stacks and a store holding copies of them (folded
  virtual rows cut off); ``build_hot_params`` places the hottest experts of
  each layer on the card as ``[n_hot, ...]`` substacks with ``hot_remap``
  [E]; ``build_synthetic_store`` fills a store from ``numpy``'s generator
  exactly as the reference does, so both packages' stores are bit-equal for
  a seed.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .config import ModelConfig, QuantConfig
from .ops.activations import swiglu
from .quant import QTensor, dequantize, pick_group_size

__all__ = ["HostExpertStore", "build_hot_params", "build_synthetic_store", "hot_expert_ids",
           "store_from_params"]

_TIERS = {0: "scalar", 1: "avx2", 2: "avx512"}


def _host(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """`t` as a contiguous CPU tensor: itself when it already is one (and is
    pinned, with `pin`), else a copy, page-locked with `pin`."""
    if t.device.type == "cpu" and t.is_contiguous() and (not pin or t.is_pinned()):
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
    out.copy_(t)
    return out


class HostExpertStore:
    """Routed-expert weights in host RAM, one entry per MoE layer (absolute
    layer index). `pin` keeps them in page-locked memory (the engine's
    device is the card: the streamed prefill copies them up at the DMA
    rate); `threads` is the C++ engine's OpenMP team (0: every core); `plain`
    runs every call through ``_forward_plain``."""

    def __init__(self, cfg: ModelConfig, quant: QuantConfig, pin: bool = False,
                 threads: int = 0, plain: bool = False):
        self.cfg = cfg
        self.quant = quant
        self.E = cfg.n_routed_experts
        self.H = cfg.hidden_size
        self.I = cfg.moe_intermediate_size
        self.bits = quant.expert_bits
        self.gs13 = pick_group_size(self.H, quant.group_size)
        self.gs2 = pick_group_size(self.I, quant.group_size)
        self.gpt_oss = cfg.model_type == "gpt_oss"
        self.swiglu_limit = cfg.swiglu_limit
        self.pin = pin
        self.threads = threads
        self.plain = plain
        # layer -> (w13_q, w13_scales, w2_q, w2_scales, w13_bias, w2_bias)
        self._layers: Dict[int, Tuple] = {}
        self._handle = None
        self._lib = None
        # layer -> int64 [E] pick counts (the hot-expert cache's input)
        self.heatmap: Dict[int, np.ndarray] = {}
        self.collect_heatmap = True
        self.host_calls = 0
        self.host_time_s = 0.0
        self.host_picks = 0
        # each thread's pinned buffers, freed with the thread
        self._bufs = threading.local()

    # -- construction ------------------------------------------------

    def add_layer(self, layer: int, w13_q, w13_scales, w2_q, w2_scales,
                  w13_bias=None, w2_bias=None) -> None:
        """w13_q int8 [E, H(/2), 2I], w13_scales bf16 [E, H/gs13, 2I], w2_q
        int8 [E, I(/2), H], w2_scales bf16 [E, I/gs2, H], biases f32 [E, 2I]
        and [E, H] (GPT-OSS): torch tensors on any device."""
        rows13 = self.H // 2 if self.bits == 4 else self.H
        rows2 = self.I // 2 if self.bits == 4 else self.I
        assert tuple(w13_q.shape) == (self.E, rows13, 2 * self.I), w13_q.shape
        assert tuple(w2_q.shape) == (self.E, rows2, self.H), w2_q.shape
        entry = tuple(None if a is None else _host(a, self.pin)
                      for a in (w13_q, w13_scales, w2_q, w2_scales, w13_bias, w2_bias))
        self._layers[layer] = entry
        if self._handle is not None:
            self._register(layer, entry)

    @property
    def layers(self):
        return sorted(self._layers)

    def nbytes(self) -> int:
        return sum(sum(a.numel() * a.element_size() for a in e if a is not None)
                   for e in self._layers.values())

    def layer_nbytes(self) -> int:
        """Bytes of one MoE layer's routed stacks (every layer holds the same)."""
        e = next(iter(self._layers.values()))
        return sum(a.numel() * a.element_size() for a in e if a is not None)

    # -- native engine -----------------------------------------------

    @staticmethod
    def _ptr(a: Optional[torch.Tensor]):
        return None if a is None else ctypes.c_void_p(a.data_ptr())

    def _register(self, layer: int, entry) -> None:
        rc = self._lib.krasish_set_layer(self._handle, layer,
                                         *(self._ptr(a) for a in entry))
        if rc != 0:
            raise RuntimeError(f"krasish_set_layer({layer}) rc={rc}")

    def _ensure_native(self) -> None:
        """Build and bind the C++ engine on first use; raises when it does
        not build."""
        if self._handle is not None:
            return
        from .native import load_hostmoe

        lib = load_hostmoe()
        n_layers = self.cfg.num_hidden_layers + max(self.cfg.num_nextn_predict_layers, 0)
        handle = lib.krasish_create(n_layers, self.E, self.H, self.I, self.bits, self.gs13,
                                    self.gs2, int(self.gpt_oss),
                                    float(self.swiglu_limit or 0.0), int(self.threads))
        if not handle:
            raise RuntimeError(f"krasish_create refused E={self.E} H={self.H} I={self.I} "
                               f"bits={self.bits} gs={self.gs13}/{self.gs2}")
        self._lib = lib
        self._handle = ctypes.c_void_p(handle)
        for layer, entry in self._layers.items():
            self._register(layer, entry)

    def native_tier(self) -> str:
        """The C++ engine's SIMD tier: 'avx512' | 'avx2' | 'scalar' (cpuid
        at create time; KRASISH_FORCE_TIER pins one)."""
        self._ensure_native()
        t = self._lib.krasish_tier(self._handle)
        return _TIERS.get(t, f"unknown({t})")

    def native_threads(self) -> int:
        self._ensure_native()
        return int(self._lib.krasish_threads(self._handle))

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            if self._handle is not None and self._lib is not None:
                self._lib.krasish_destroy(self._handle)
        except Exception:
            pass

    # -- forward -------------------------------------------------------

    def forward(self, layer: int, x: np.ndarray, topk_idx: np.ndarray, topk_w: np.ndarray,
                out: Optional[np.ndarray] = None, plain: Optional[bool] = None) -> np.ndarray:
        """Routed experts of `layer` for x [T, H] f32 at the picks topk_idx
        [T, k] int32 (id < 0: skipped) weighted by topk_w [T, k] f32 →
        [T, H] f32, written into `out` when given. `plain` (default: the
        store's) runs ``_forward_plain`` instead of the C++ engine."""
        t0 = time.perf_counter()
        x = np.ascontiguousarray(x, np.float32)
        topk_idx = np.ascontiguousarray(topk_idx, np.int32)
        topk_w = np.ascontiguousarray(topk_w, np.float32)
        T, k = topk_idx.shape
        if self.collect_heatmap:
            hm = self.heatmap.get(layer)
            if hm is None:
                hm = self.heatmap[layer] = np.zeros(self.E, np.int64)
            ids = topk_idx[topk_idx >= 0]
            if ids.size:
                np.add.at(hm, ids, 1)
        if out is None:
            out = np.empty((T, self.H), np.float32)
        if self.plain if plain is None else plain:
            out[...] = self._forward_plain(layer, torch.from_numpy(x), torch.from_numpy(topk_idx),
                                           torch.from_numpy(topk_w)).numpy()
        else:
            self._ensure_native()
            rc = self._lib.krasish_forward(
                self._handle, layer, T, k, x.ctypes.data_as(ctypes.c_void_p),
                topk_idx.ctypes.data_as(ctypes.c_void_p), topk_w.ctypes.data_as(ctypes.c_void_p),
                out.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise RuntimeError(f"krasish_forward(layer={layer}) rc={rc}")
        self.host_calls += 1
        self.host_picks += int((topk_idx >= 0).sum())
        self.host_time_s += time.perf_counter() - t0
        return out

    def _deq(self, q: torch.Tensor, s: torch.Tensor, gs: int) -> torch.Tensor:
        return dequantize(QTensor(q, s, self.bits, gs), torch.float32)

    def _forward_plain(self, layer: int, x: torch.Tensor, topk_idx: torch.Tensor,
                       topk_w: torch.Tensor) -> torch.Tensor:
        """The C++ engine's plain version on CPU tensors: each live pick's
        expert dequantized to f32, x @ w13 (+ bias), the activation, @ w2
        (+ bias), times the pick's weight, summed in pick order."""
        e13q, e13s, e2q, e2s, b13, b2 = self._layers[layer]
        T, k = topk_idx.shape
        x = x.to(torch.float32)
        out = torch.zeros((T, self.H), dtype=torch.float32)
        for t in range(T):
            for j in range(k):
                e, w = int(topk_idx[t, j]), float(topk_w[t, j])
                if e < 0 or w == 0.0:
                    continue
                h = x[t] @ self._deq(e13q[e], e13s[e], self.gs13)
                if b13 is not None:
                    h = h + b13[e]
                a = swiglu(h, self.swiglu_limit if self.gpt_oss else 0.0, self.gpt_oss)
                o = a @ self._deq(e2q[e], e2s[e], self.gs2)
                if b2 is not None:
                    o = o + b2[e]
                out[t] += w * o
        return out

    # -- one MoE layer across the host link ------------------------------

    def _buffer(self, kind: str, n: int) -> torch.Tensor:
        """A reusable pinned f32 host buffer of at least n elements for this
        thread (the scheduler's thread and a request thread never share one;
        a thread's buffers go when it ends)."""
        buf = getattr(self._bufs, kind, None)
        if buf is None or buf.numel() < n:
            with torch.inference_mode(False):      # writable from any mode
                buf = torch.empty(n, dtype=torch.float32, pin_memory=True)
            setattr(self._bufs, kind, buf)
        return buf[:n]

    def dispatch(self, x2d: torch.Tensor, topk_idx: torch.Tensor, topk_w: torch.Tensor):
        """Start one MoE layer's host work: [x | ids | weights] as one f32
        block [T, H + 2k] copied down into a pinned buffer with
        ``non_blocking``, and an event recorded after the copy. Returns the
        handle ``collect`` takes."""
        T, k = topk_idx.shape
        packed = torch.cat([x2d.to(torch.float32), topk_idx.to(torch.float32),
                            topk_w.to(torch.float32)], dim=1)
        if not packed.is_cuda:
            return packed, None, k
        buf = self._buffer("in", packed.numel()).view(packed.shape)
        buf.copy_(packed, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return buf, ev, k

    def collect(self, layer: int, handle, device: torch.device) -> torch.Tensor:
        """Finish what ``dispatch`` started: wait on its event, run the
        engine into a pinned output buffer and copy [T, H] f32 up to
        `device` with ``non_blocking``. A later layer may reuse both
        buffers: its own copy down follows this copy up on the stream, and
        the host waits on that copy before it writes again."""
        buf, ev, k = handle
        if ev is not None:
            ev.synchronize()
        a = buf.numpy()
        H = a.shape[1] - 2 * k
        idx = np.rint(a[:, H:H + k]).astype(np.int32)
        if device.type != "cuda":
            return torch.from_numpy(self.forward(layer, a[:, :H], idx, a[:, H + k:]))
        out = self._buffer("out", a.shape[0] * H).view(a.shape[0], H)
        self.forward(layer, a[:, :H], idx, a[:, H + k:], out=out.numpy())
        return out.to(device, non_blocking=True)


EXPERT_LEAVES = ("w13", "w2", "w13_bias", "w2_bias")


def expert_leaves(lp: Dict[str, Any], E: int):
    """A layer's routed stacks, ``add_layer``'s arguments, with folded
    virtual rows cut off."""
    w13, w2 = lp["w13"], lp["w2"]
    return (w13.q[:E], w13.scales[:E], w2.q[:E], w2.scales[:E],
            lp.get("w13_bias"), lp.get("w2_bias"))


def without_experts(lp: Dict[str, Any]) -> Dict[str, Any]:
    """A layer's leaves without its routed stacks and their biases."""
    return {k: v for k, v in lp.items() if k not in EXPERT_LEAVES}


def store_from_params(cfg: ModelConfig, quant: QuantConfig, params: Dict[str, Any],
                      pin: bool = False, threads: int = 0
                      ) -> Tuple[Dict[str, Any], HostExpertStore]:
    """(device params without routed expert stacks, a HostExpertStore
    holding copies of them in host memory, pinned with `pin`). The input
    tree is left as it was: a resident engine may keep serving from it.
    Folded stacks carry shared experts as virtual rows beyond E; the store
    holds the routed rows only, and the shared experts stay on the card."""
    store = HostExpertStore(cfg, quant, pin=pin, threads=threads)
    layers = []
    for i, lp in enumerate(params["layers"]):
        if "w13" in lp:
            store.add_layer(i, *expert_leaves(lp, cfg.n_routed_experts))
            lp = without_experts(lp)
        layers.append(lp)
    return {**params, "layers": layers}, store


def hot_expert_ids(store: HostExpertStore, layer: int, n_hot: int,
                   heatmap: Optional[Dict[int, np.ndarray]] = None) -> np.ndarray:
    """The n_hot most picked experts of a layer (sorted ids); the first
    n_hot while the layer has no heatmap counts yet."""
    hm = (heatmap or store.heatmap).get(layer)
    if hm is None or hm.sum() == 0:
        return np.arange(n_hot, dtype=np.int32)
    return np.sort(np.argsort(-hm)[:n_hot]).astype(np.int32)


def build_hot_params(cfg: ModelConfig, quant: QuantConfig, params: Dict[str, Any],
                     store: HostExpertStore, n_hot: int,
                     heatmap: Optional[Dict[int, np.ndarray]] = None,
                     device=None) -> Dict[str, Any]:
    """The hottest n_hot experts of each MoE layer in the store, on the
    card: ``hot_w13`` / ``hot_w2`` QTensors [n_hot, ...], ``hot_remap``
    int32 [E] (expert id → hot slot, -1 cold) and GPT-OSS's
    ``hot_w13_bias`` / ``hot_w2_bias``. A layer that already holds them has
    the new set copied into the same device buffers (shapes never change),
    so the returned tree shares its tensors with `params`."""
    device = torch.device(device or "cpu")
    layers = []
    for i, lp in enumerate(params["layers"]):
        if i not in store._layers:
            layers.append(lp)
            continue
        w13q, w13s, w2q, w2s, b13, b2 = store._layers[i]
        ids_np = hot_expert_ids(store, i, n_hot, heatmap)
        ids = torch.from_numpy(ids_np.astype(np.int64))
        remap = torch.full((store.E,), -1, dtype=torch.int32)
        remap[ids] = torch.arange(n_hot, dtype=torch.int32)
        new = {"hot_w13": QTensor(w13q[ids], w13s[ids], store.bits, store.gs13),
               "hot_w2": QTensor(w2q[ids], w2s[ids], store.bits, store.gs2),
               "hot_remap": remap}
        if b13 is not None:
            new["hot_w13_bias"] = b13[ids]
        if b2 is not None:
            new["hot_w2_bias"] = b2[ids]
        lp = dict(lp)
        for name, v in new.items():
            old = lp.get(name)
            if isinstance(v, QTensor):
                if old is None:
                    lp[name] = v.to(device)
                else:
                    old.q.copy_(v.q)
                    old.scales.copy_(v.scales)
            elif old is None:
                lp[name] = v.to(device)
            else:
                old.copy_(v)
        layers.append(lp)
    return {**params, "layers": layers}


def build_synthetic_store(cfg: ModelConfig, quant: QuantConfig, seed: int = 0,
                          pin: bool = False, threads: int = 0) -> HostExpertStore:
    """Random host-resident expert weights for every MoE layer, from
    ``np.random.default_rng(seed)`` in the reference's order of draws
    (weight bytes from ``rng.bytes``, scales uniform in [0.01, 0.03) rounded
    to bf16), so the store is bit-equal to the reference's for a seed."""
    store = HostExpertStore(cfg, quant, pin=pin, threads=threads)
    rng = np.random.default_rng(seed)
    E, H, I = store.E, store.H, store.I
    rows13 = H // 2 if store.bits == 4 else H
    rows2 = I // 2 if store.bits == 4 else I

    def scales(K, gs, N):
        s = rng.uniform(0.01, 0.03, (E, K // gs, N)).astype(np.float32)
        return torch.from_numpy(s).to(torch.bfloat16)

    def qbytes(shape):
        out = torch.empty(shape, dtype=torch.int8, pin_memory=pin)
        # one copy of the generator's bytes, into the store
        out.numpy()[...] = np.frombuffer(rng.bytes(out.numel()), np.int8).reshape(shape)
        return out

    for layer in range(cfg.num_hidden_layers):
        if not cfg.layer_is_moe(layer):
            continue
        kwargs = {}
        if cfg.model_type == "gpt_oss":
            kwargs["w13_bias"] = torch.zeros((E, 2 * I), dtype=torch.float32)
            kwargs["w2_bias"] = torch.zeros((E, H), dtype=torch.float32)
        store.add_layer(layer, qbytes((E, rows13, 2 * I)), scales(H, store.gs13, 2 * I),
                        qbytes((E, rows2, H)), scales(I, store.gs2, H), **kwargs)
    return store
