"""Offload-tier engine: streamed-weight prefill and host-expert decode.

The port of ``krasis_tpu/runtime/offload_engine.py``. A model whose routed
experts live in host memory (``offload.HostExpertStore``) prefills at the
card's speed by streaming the expert weights through two preallocated
device slots instead of computing MoE on the host: the layers run in
groups of ``pattern_info``'s period (one layer for DeepSeek-V2-Lite, four
for the Qwen3-Next hybrid), group-outer and chunk-inner, so every expert
byte crosses PCIe once per prefill whatever the prompt's length. The
prefix layers run resident first, over every chunk.

Group r's expert tensors go into slot r % 2 on a side ``torch.cuda.Stream``;
group r + 1's copy is issued before group r computes. Events order the two
streams: compute waits for its slot's copy, and the copy of group r + 2
waits for the compute of group r, which reads the same slot. Stores in
pageable memory (the weight cache's mmap) are staged through two pinned
host buffers first; a store in pinned memory is copied from directly.

``WeightStreamer`` owns the slots, the stream and the staging buffers; the
``OffloadEngine`` prefills a prompt through it, and the ``BatchScheduler``
each admission chunk (a chunk a loop turn, so each chunk streams the
weights once). Decode (and prefill with ``streaming=False``, the tests'
reference path) is ``Engine``'s: each MoE layer's routed picks run on the
host engine between launches (``models/model.py`` ``_offload_mlp``), the
hot-expert cache's picks on the card. Processing chunk c of group r needs
only chunks ≤ c of group r - 1, so group-outer / chunk-inner computes the
function the chunk-outer resident prefill computes, chunk for chunk on the
same rows.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..models.model import make_layer_step, step_inputs
from ..models.params import layer_specs, pattern_info, pattern_layer_index
from ..ops.norm import rms_norm
from ..ops.qmm import linear
from ..quant import QTensor
from .engine import Engine, padded_rows

log = logging.getLogger("krasis_tpu_torch.offload")


def _as_leaves(ts: Sequence[Optional[torch.Tensor]], store) -> Dict[str, Any]:
    """A slot's tensors as a layer's expert leaves."""
    out = {"w13": QTensor(ts[0], ts[1], store.bits, store.gs13),
           "w2": QTensor(ts[2], ts[3], store.bits, store.gs2)}
    if ts[4] is not None:
        out["w13_bias"] = ts[4]
    if ts[5] is not None:
        out["w2_bias"] = ts[5]
    return out


class WeightStreamer:
    """Prefill with a store's expert weights streamed through the card: two
    device slots the size of one layer group's expert tensors, filled on a
    side stream (staged through two pinned host buffers where the store's
    pages are pageable), made at first use and reused. `measure_h2d` times
    one group's copy alone first, which serialises it against the
    pipeline."""

    def __init__(self, cfg, store, device: torch.device):
        self.cfg, self.store, self.device = cfg, store, device
        self.info = pattern_info(cfg)
        self.specs = layer_specs(cfg)
        self.slots: Optional[List[list]] = None
        self.stage: Optional[List[list]] = None
        self.measure_h2d = False
        self.last_stats: Optional[Dict[str, Any]] = None

    def group_layers(self, r: int) -> List[int]:
        return [pattern_layer_index(self.info, t, r) for t in range(self.info.period)]

    def group_src(self, r: int):
        """Group r's host tensors, one entry per pattern position (None for
        a position without routed experts): a store entry's six tensors, w13
        q and scales, w2 q and scales, the two biases (or None)."""
        return [self.store._layers.get(layer) for layer in self.group_layers(r)]

    @staticmethod
    def _alloc(like, device, pin: bool = False):
        """Empty buffers shaped as `like`'s tensors, writable from any
        inference mode (made at first use, maybe inside one)."""
        with torch.inference_mode(False):
            return [None if ts is None else
                    [None if a is None else torch.empty(a.shape, dtype=a.dtype, device=device,
                                                        pin_memory=pin)
                     for a in ts] for ts in like]

    @staticmethod
    def _copy(src, dst, non_blocking: bool = False) -> None:
        for s_ts, d_ts in zip(src, dst):
            for a, b in zip(s_ts or (), d_ts or ()):
                if a is not None:
                    b.copy_(a, non_blocking=non_blocking)

    def slot_bytes(self) -> int:
        """Device bytes of the two slots (0 before the first prefill)."""
        return sum(a.numel() * a.element_size() for s in self.slots or () for ts in s if ts
                   for a in ts if a is not None)

    def prefill(self, params, cache, prompt_ids: Sequence[int], chunk: int, start: int = 0,
                all_logits: bool = False) -> torch.Tensor:
        """`prompt_ids` into `cache` after its `start` cached tokens (the
        first chunk attends to its own rows when `start` is 0), in chunks of
        `chunk` ids, the expert weights streamed group by group; sets
        cache["length"] and returns the last position's f32 logits [1, V],
        or every position's [n, V] with `all_logits`."""
        cfg, info, dev, store, specs = self.cfg, self.info, self.device, self.store, self.specs
        cuda = dev.type == "cuda"
        if self.slots is None:
            self.slots = [self._alloc(self.group_src(0), dev) for _ in range(2)]
        n = len(prompt_ids)
        chunks = [(start + pos, list(prompt_ids[pos:pos + chunk])) for pos in range(0, n, chunk)]

        # phase 1: the embedding and the prefix layers, every chunk
        xs, steps = [], []
        for pos, ids in chunks:
            tokens = padded_rows([ids], len(ids), dev)
            seq = torch.tensor([len(ids)], dtype=torch.int32, device=dev)
            length = torch.full((1,), pos, dtype=cache["length"].dtype, device=dev)
            positions, valid, kv_len, at = step_inputs(length, seq, tokens.shape[1],
                                                       cache["layers"], True)
            step = make_layer_step(cfg, prefill=True, positions=positions, valid=valid,
                                   kv_len=kv_len, activation="bf16", fresh=pos == 0, at=at,
                                   offload=store)
            x = params["embed"][tokens]
            for i in range(info.prefix_n):
                x = step(x, params["layers"][i], cache["layers"][i], specs[i], i)
            xs.append(x)
            steps.append(step)

        # phase 2: the pattern groups, weights streamed a group at a time
        G = info.reps
        copy_stream = torch.cuda.Stream(dev) if cuda else None
        copy_done: List[Any] = [None] * G
        compute_done: List[Any] = [None] * G
        staged = False

        def issue(r: int) -> None:
            nonlocal staged
            src, slot = self.group_src(r), self.slots[r % 2]
            if not cuda:
                self._copy(src, slot)
                return
            if any(a is not None and not a.is_pinned() for ts in src if ts for a in ts):
                # stage the pageable pages through pinned buffers: first wait
                # for the copy that last read this stage (group r - 2)
                staged = True
                if self.stage is None:
                    self.stage = [self._alloc(src, "cpu", pin=True) for _ in range(2)]
                if r >= 2:
                    copy_done[r - 2].synchronize()
                self._copy(src, self.stage[r % 2])
                src = self.stage[r % 2]
            with torch.cuda.stream(copy_stream):
                if r >= 2:                    # group r - 2 read this slot
                    copy_stream.wait_event(compute_done[r - 2])
                self._copy(src, slot, non_blocking=True)
                copy_done[r] = torch.cuda.Event()
                copy_done[r].record(copy_stream)

        group_bytes = self.slot_bytes() // 2
        h2d_first_s = None
        t_first = time.perf_counter()
        if G:
            issue(0)
            if self.measure_h2d and cuda:
                copy_done[0].synchronize()
                h2d_first_s = time.perf_counter() - t_first
        t_phase2 = time.perf_counter()
        for r in range(G):
            if r + 1 < G:
                issue(r + 1)                  # the next group's copy, before this compute
            if cuda:
                torch.cuda.current_stream(dev).wait_event(copy_done[r])
            slot = self.slots[r % 2]
            layers = self.group_layers(r)
            for c in range(len(xs)):
                x = xs[c]
                for t, li in enumerate(layers):
                    lp = params["layers"][li]
                    if slot[t] is not None:
                        lp = {**lp, **_as_leaves(slot[t], store)}
                    x = steps[c](x, lp, cache["layers"][li], specs[li], li)
                xs[c] = x
            if cuda:
                compute_done[r] = torch.cuda.Event()
                compute_done[r].record(torch.cuda.current_stream(dev))
        if cuda:
            torch.cuda.synchronize(dev)
        phase2_s = time.perf_counter() - t_phase2
        total = group_bytes * G
        self.last_stats = {
            "rep_bytes": int(group_bytes), "streamed_bytes": int(total),
            "groups": G, "staged": staged, "phase2_s": phase2_s,
            "effective_gbps_with_overlap": total / max(phase2_s, 1e-9) / 1e9}
        if h2d_first_s is not None:
            self.last_stats.update(h2d_first_rep_s=h2d_first_s,
                                   h2d_gbps_measured=group_bytes / h2d_first_s / 1e9)
        log.info("offload stream: %s", self.last_stats)

        cache["length"] = torch.full((1,), start + n, dtype=cache["length"].dtype, device=dev)
        if all_logits:
            rows = torch.cat([x[0, :len(ids)] for x, (_, ids) in zip(xs, chunks)])
            rows = rms_norm(rows, params["final_norm"], cfg.rms_norm_eps, cfg.norm_plus_one)
            return linear(rows, params["lm_head"], out_dtype=torch.float32)
        last = rms_norm(xs[-1], params["final_norm"], cfg.rms_norm_eps, cfg.norm_plus_one)
        return linear(last[:, len(chunks[-1][1]) - 1], params["lm_head"],
                      out_dtype=torch.float32)


class OffloadEngine(Engine):
    """Engine whose routed experts live in host RAM: streamed-weight
    prefill (``streaming=False`` prefills through the host engine instead)
    and host-expert decode, with the `hot_experts` most picked experts of
    each MoE layer held on the card (``offload.build_hot_params``)."""

    def __init__(self, cfg, quant, params, store, streaming: bool = True,
                 hot_experts: int = 0, max_len: int = 4096, device=None):
        from ..device import resolve_device
        from ..offload import build_hot_params

        dev = resolve_device(device)
        if hot_experts > 0:
            params = build_hot_params(cfg, quant, params, store, hot_experts, device=dev)
        super().__init__(cfg, quant, params, max_len=max_len, device=dev, offload=store)
        self.hot_experts = hot_experts
        self.streaming = streaming and pattern_info(cfg).reps > 0
        self.streamer = WeightStreamer(cfg, store, dev)

    @property
    def last_stream_stats(self) -> Optional[Dict[str, Any]]:
        return self.streamer.last_stats

    def update_hot_cache(self) -> None:
        """Re-select the hot experts from the heatmap gathered so far (it
        counts the host's cold picks while a cache is active) and copy them
        into the same device buffers: no tensor is reallocated."""
        if self.hot_experts <= 0:
            return
        from ..offload import build_hot_params

        self.params = build_hot_params(self.cfg, self.quant, self.params, self.offload,
                                       self.hot_experts, device=self.device)

    def _prefill_prompt_once(self, prompt_ids: Sequence[int], mtp: bool = False):
        if not self.streaming:
            return super()._prefill_prompt_once(prompt_ids, mtp)
        return self.streamer.prefill(self.params, self.cache, prompt_ids, self.chunk)

    @torch.inference_mode()
    def forward_all_logits(self, prompt_ids: Sequence[int]) -> torch.Tensor:
        """f32 logits [n, V] at every position, through the streamed prefill
        (the perplexity path of an offloaded model)."""
        if not self.streaming:
            return super().forward_all_logits(prompt_ids)
        self.reset()
        n = len(prompt_ids)
        if not 0 < n <= self.max_len:
            raise ValueError(f"window of {n} tokens does not fit max_len={self.max_len}")
        return self.streamer.prefill(self.params, self.cache, prompt_ids, self.chunk,
                                     all_logits=True)
