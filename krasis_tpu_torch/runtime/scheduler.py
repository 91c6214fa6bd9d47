"""Continuous batching: prefill at batch 1, insert into a slot, decode every
slot at once (PyTorch).

The port of ``krasis_tpu/runtime/scheduler.py``:

* a request's prompt is prefilled at batch 1 into one reusable prefill
  cache, one chunk per loop turn, so the active slots keep decoding while a
  long prompt is admitted, and a cancelled request stops at the next chunk;
* the prefilled cache rows and state are copied into a free slot of the
  batched decode cache (``kv_cache.insert_slot``);
* one ``decode_block_batched`` call advances every slot by ``decode_block``
  tokens, each slot with its own sampling parameters, and is read back once;
* with speculative decoding (``models/mtp.spec_config``: MTP drafts, or
  prompt lookup on any model) a block is ``decode_block`` verify steps
  instead, each committing 1 to k + 1 tokens a slot: the MTP module's
  cache is prefilled beside the main one and inserted with it, and prompt
  lookup keeps each slot's token history on the device;
* with ``offload`` (``offload.HostExpertStore``), a model whose routed experts
  live in host memory: the batched decode (T = slots rows) runs each MoE
  layer's cold picks on the host engine (``models/model.py``
  ``_offload_mlp``; hot-expert leaves in `params` run on the card), and
  each admission chunk streams the expert weights through the card
  (``offload_engine.WeightStreamer``). The shared experts are not folded
  and speculative decoding is off, as in the reference;
* with ``mesh`` (``parallel/mesh.py``), the parameters sharded over it and
  the slots split over its dp groups when they divide, each group's rows
  decoding on its own devices.

One scheduler thread owns the device; request threads submit and read their
tokens from per-request queues. A fault in that thread ends every waiting
request with the error recorded on it, and later submits raise.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..config import ModelConfig, QuantConfig
from ..models.model import chosen_logprob, decode_block_batched
from ..models.mtp import first_draft, spec_config, spec_decode_block
from ..models.params import fold_shared_experts, pattern_info
from ..models.spec_ngram import ngram_decode_block
from ..ops.sampling import SamplingParams, sample_batched
from .engine import CHUNK, halved_chunk, prefill_rows, spec_prefill_rows
from ..parallel.mesh import cache_shardings, placed
from .kv_cache import (init_cache, init_mtp_cache, insert_mtp_slot, insert_slot,
                       resolve_kv_quant)

log = logging.getLogger("krasis_tpu_torch.scheduler")


@dataclass
class Request:
    prompt_ids: List[int]
    max_new_tokens: int
    sampling: SamplingParams
    stop_ids: set
    out_queue: "queue.Queue[Optional[int]]" = field(default_factory=queue.Queue)
    cancelled: threading.Event = field(default_factory=threading.Event)
    # logprobs are opt-in: without it a token's logprob is 0 unless another
    # active slot asked for them in the same block (a block computes them
    # for every slot or for none); the first token's is always taken
    want_logprobs: bool = False
    # log P(token) under the raw model distribution, one per emitted token,
    # appended before the token reaches out_queue
    logprobs: List[float] = field(default_factory=list)
    slot: int = -1
    emitted: int = 0
    # the scheduler thread's fault, set before the end sentinel
    error: Optional[Exception] = None


class BatchScheduler:
    """Owns the device; runs admission prefill, slot insert and batched
    decode in a loop on its own thread."""

    def __init__(self, cfg: ModelConfig, quant: QuantConfig, params: Dict[str, Any],
                 max_len: int = 4096, num_slots: int = 4, decode_block: int = 8,
                 device=None, mesh=None, offload=None):
        self.mesh = mesh
        params, self.device = placed(params, cfg, mesh, device, offload)
        self.cfg = cfg
        self.quant = quant = resolve_kv_quant(cfg, quant, num_slots, max_len)
        self.offload = offload
        self.streamer = None
        if offload is not None and pattern_info(cfg).reps > 0:
            from .offload_engine import WeightStreamer

            self.streamer = WeightStreamer(cfg, offload, self.device)
        if quant.fold_shared_decode and offload is None and mesh is None:
            params = fold_shared_experts(params, cfg, quant)
        self.params = params
        self.max_len = max_len
        self.num_slots = num_slots
        self.decode_block = max(1, decode_block)
        self.chunk = CHUNK

        dev = self.device
        self.decode_cache = self._new_cache(num_slots)
        # one reusable batch-1 prefill cache: rows past its length are
        # masked and later overwritten
        self.prefill_cache = self._new_cache(1)
        # speculative decoding, gated as the engine is
        self.spec_mode, self.spec_k = spec_config(cfg, params)
        if offload is not None:
            self.spec_mode = None       # the reference has no spec path under offload
        self.spec = self.spec_mode == "mtp"
        self.spec_ngram_n = int(os.environ.get("KRASIS_TPU_NGRAM_N", "3"))
        self.stats_spec = {"steps": 0, "accepted": 0}
        if self.spec_mode == "ngram":
            # each slot's token history, on the device
            self._hist = torch.zeros((num_slots, max_len), dtype=torch.int64, device=dev)
        if self.spec:
            self.mtp_decode_cache = self._new_cache(num_slots, mtp=True)
            self.mtp_prefill_cache = self._new_cache(1, mtp=True)
            self._drafts = torch.zeros((num_slots, self.spec_k), dtype=torch.int64, device=dev)
        self._active: List[Optional[Request]] = [None] * num_slots
        self._tokens = [0] * num_slots
        self._seen = torch.zeros((num_slots, cfg.vocab_size), dtype=torch.bool, device=dev)
        self._temp = [0.0] * num_slots
        self._top_p = [1.0] * num_slots
        self._pres = [0.0] * num_slots
        self._top_k = [0] * num_slots
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(0)
        self._pending: Optional[Dict[str, Any]] = None    # the admission in progress
        # the tokens whose rows and state the prefill cache holds: a prompt
        # that strictly extends them resumes after them
        self._pc_tokens: List[int] = []
        self.stats = {"prefill_chunks": 0, "prefix_reused_tokens": 0, "decode_blocks": 0}

        self._in_queue: "queue.Queue[Request]" = queue.Queue()
        self._submit_lock = threading.Lock()
        self._error: Optional[Exception] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="krasis-scheduler")
        self._thread.start()

    def _new_cache(self, batch: int, mtp: bool = False) -> Dict[str, Any]:
        """A zeroed cache of `batch` slots (the MTP module's with `mtp`),
        laid out over the mesh when there is one: its slots split over dp
        when they divide."""
        make = init_mtp_cache if mtp else init_cache
        cache = make(self.cfg, self.quant, batch, self.max_len, self.device)
        return cache if self.mesh is None else cache_shardings(cache, self.params)

    # ------------------------------------------------------------------

    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int = 512,
               sampling: Optional[SamplingParams] = None, stop_ids: Optional[set] = None,
               want_logprobs: bool = False) -> Request:
        req = Request(prompt_ids=list(prompt_ids), max_new_tokens=max_new_tokens,
                      sampling=sampling or SamplingParams(),
                      stop_ids=stop_ids or {self.cfg.eos_token_id,
                                            *self.cfg.extra_stop_token_ids},
                      want_logprobs=want_logprobs)
        with self._submit_lock:
            if self._error is not None:
                raise RuntimeError(f"the scheduler stopped on {self._error!r}") from self._error
            self._in_queue.put(req)
        return req

    def shutdown(self):
        """Stop the loop; a request still waiting then ends with an error."""
        self._stop.set()
        self._thread.join(timeout=30)
        if not self._thread.is_alive():
            self._fail(RuntimeError("the scheduler was shut down"))

    # ------------------------------------------------------------------

    def _free_slot(self) -> int:
        for i, r in enumerate(self._active):
            if r is None:
                return i
        return -1

    def _start_admission(self) -> bool:
        """Take a queued request and reserve a free slot for it; its prefill
        then advances one chunk a loop turn (_admit_step)."""
        slot = self._free_slot()
        if slot < 0:
            return False
        while True:
            try:
                req = self._in_queue.get_nowait()
            except queue.Empty:
                return False
            if not req.cancelled.is_set():
                break
            req.out_queue.put(None)
        # an over-long prompt keeps its end; max_new_tokens is clamped to
        # the cache's room (a block's overshoot past the end is dropped)
        ids = req.prompt_ids
        if len(ids) > self.max_len - 2:
            ids = ids[-(self.max_len - 2):]
        req.max_new_tokens = max(1, min(req.max_new_tokens, self.max_len - len(ids) - 1))
        req.slot = slot
        pcache = self.prefill_cache
        # prefix reuse (multi-turn chat re-sends the conversation): only a
        # strict extension of the cached tokens qualifies, since DeltaNet
        # state cannot be rewound, and it leaves one token or more to prefill
        n_pc = len(self._pc_tokens)
        reuse = n_pc if 0 < n_pc < len(ids) and ids[:n_pc] == self._pc_tokens else 0
        if reuse == 0:
            pcache["length"].zero_()
            for lc in pcache["layers"]:
                if "state" in lc:          # DeltaNet state is not masked by length
                    lc["state"].zero_()
                    lc["conv"].zero_()
            self._pc_tokens = []
            if self.spec:
                self.mtp_prefill_cache["length"].zero_()
        else:
            self.stats["prefix_reused_tokens"] += reuse
            if self.spec:
                # the MTP rows up to the shared prefix are kept: the one at
                # reuse - 1 came from the earlier turn's sampled token, which
                # only lowers acceptance
                self.mtp_prefill_cache["length"].clamp_(max=reuse)
        self._pending = {"req": req, "ids": ids, "pos": reuse, "logits": None}
        return True

    def _admit_step(self):
        """Advance the admission in progress by one prefill chunk (starting
        one first if there is none), and at its last chunk insert it into
        its slot and sample its first token."""
        if self._pending is None and not self._start_admission():
            return
        p = self._pending
        req = p["req"]
        if req.cancelled.is_set():
            req.out_queue.put(None)
            self._pending = None
            return
        ids, pos = p["ids"], p["pos"]
        m = min(self.chunk, len(ids) - pos)
        if self.spec:
            p["logits"], p["h_last"] = spec_prefill_rows(
                self.params, ids, pos, m, self.prefill_cache, self.mtp_prefill_cache,
                self.cfg, self.quant)
        elif self.streamer is not None:
            p["logits"] = self.streamer.prefill(self.params, self.prefill_cache,
                                                ids[pos:pos + m], m, start=pos)
        else:
            p["logits"] = prefill_rows(self.params, ids[pos:pos + m], self.prefill_cache,
                                       self.cfg, self.quant, history=pos, offload=self.offload)
        p["pos"] = pos + m
        self.stats["prefill_chunks"] += 1
        self._pc_tokens = ids[:p["pos"]]
        if p["pos"] < len(ids):
            return
        slot = req.slot
        insert_slot(self.decode_cache, self.prefill_cache, slot)
        sp = req.sampling
        dev = self.device
        tok_t = sample_batched(
            p["logits"], torch.tensor([sp.temperature], device=dev),
            torch.tensor([sp.top_p], device=dev),
            torch.tensor([sp.presence_penalty], device=dev),
            torch.zeros((1, self.cfg.vocab_size), dtype=torch.bool, device=dev),
            torch.tensor([sp.top_k], dtype=torch.int32, device=dev), generator=self._gen)
        lp_t = chosen_logprob(p["logits"], tok_t)
        tok, lp = torch.stack([tok_t.to(torch.float64), lp_t.to(torch.float64)])[:, 0].tolist()
        tok = int(tok)
        req.logprobs.append(lp)
        if self.spec:
            self._drafts[slot] = first_draft(self.params, tok_t, p["h_last"],
                                             self.mtp_prefill_cache, self.cfg, self.quant,
                                             self.spec_k)[0]
            insert_mtp_slot(self.mtp_decode_cache, self.mtp_prefill_cache, slot)
        elif self.spec_mode == "ngram":
            # the slot's history: the prompt and the first token
            row = torch.zeros((self.max_len,), dtype=torch.int64)
            row[:len(ids)] = torch.tensor(ids, dtype=torch.int64)
            row[len(ids)] = tok
            self._hist[slot] = row.to(dev)
        self._seen[slot] = False
        self._seen[slot, tok] = True
        self._temp[slot], self._top_p[slot] = sp.temperature, sp.top_p
        self._pres[slot], self._top_k[slot] = sp.presence_penalty, sp.top_k
        self._active[slot] = req
        self._tokens[slot] = tok
        self._pending = None
        self._emit(req, tok)

    def _emit(self, req: Request, tok: int):
        req.emitted += 1
        req.out_queue.put(tok)
        if (tok in req.stop_ids or req.emitted >= req.max_new_tokens
                or req.cancelled.is_set()):
            req.out_queue.put(None)          # end of stream
            self._active[req.slot] = None

    def _admit_step_with_oom_retry(self):
        """An admission chunk that runs the card out of memory restarts that
        admission on a fresh prefill cache with half the chunk (down to
        MIN_CHUNK); the active slots decode on untouched."""
        try:
            self._admit_step()
            return
        except Exception as e:
            chunk = (halved_chunk(e, self.chunk, "admission prefill")
                     if self._pending is not None else None)
            if chunk is None:
                raise
        # out of the handler, so the failed chunk's tensors are released
        self.chunk = chunk
        self.prefill_cache = self._new_cache(1)
        if self.spec:
            self.mtp_prefill_cache = self._new_cache(1, mtp=True)
        self._pc_tokens = []
        p = self._pending
        self._pending = {"req": p["req"], "ids": p["ids"], "pos": 0, "logits": None}

    def _decode_block(self):
        """One block over every slot, read back once; each active slot's
        tokens are emitted in order until its stop."""
        dev = self.device
        # an idle slot decodes discarded tokens from position 0, so its
        # positions never run past the cache
        idle = [slot for slot, r in enumerate(self._active) if r is None]
        if idle:
            self.decode_cache["length"][idle] = 0
            if self.spec:
                self.mtp_decode_cache["length"][idle] = 0
        if self.spec_mode is not None:
            self._spec_decode_block()
            return
        need_lp = any(r is not None and r.want_logprobs for r in self._active)
        toks, lps = decode_block_batched(
            self.params, torch.tensor(self._tokens, dtype=torch.int64, device=dev),
            self.decode_cache, self.cfg, self.quant, self.decode_block, self._gen, self._seen,
            torch.tensor(self._temp, dtype=torch.float32, device=dev),
            torch.tensor(self._top_p, dtype=torch.float32, device=dev),
            torch.tensor(self._pres, dtype=torch.float32, device=dev),
            torch.tensor(self._top_k, dtype=torch.int32, device=dev), need_logprobs=need_lp,
            offload=self.offload)
        self.stats["decode_blocks"] += 1
        # f64 holds token ids and f32 logprobs exactly: one readback
        toks_h, lps_h = torch.stack([toks.to(torch.float64), lps.to(torch.float64)]).tolist()
        for step in range(len(toks_h)):
            for slot, req in enumerate(self._active):
                if req is None:
                    continue
                tok = int(toks_h[step][slot])
                self._tokens[slot] = tok
                req.logprobs.append(lps_h[step][slot])
                self._emit(req, tok)

    def _spec_decode_block(self):
        """One block of verify steps over every slot, read back once: each
        step commits 1 to spec_k + 1 tokens a slot, emitted in order until
        the slot's stop (``spec_decode_block`` / ``ngram_decode_block``)."""
        dev = self.device
        tok = torch.tensor(self._tokens, dtype=torch.int64, device=dev)
        args = (self._gen, self._seen, torch.tensor(self._temp, dtype=torch.float32, device=dev),
                torch.tensor(self._top_p, dtype=torch.float32, device=dev),
                torch.tensor(self._pres, dtype=torch.float32, device=dev),
                torch.tensor(self._top_k, dtype=torch.int32, device=dev))
        if self.spec:
            ts, lps, ncommit, _, _, self._drafts = spec_decode_block(
                self.params, tok, self._drafts, self.decode_cache, self.mtp_decode_cache,
                self.cfg, self.quant, self.decode_block, *args)
        else:
            ts, lps, ncommit, _, _ = ngram_decode_block(
                self.params, tok, self.decode_cache, self._hist, self.cfg, self.quant,
                self.decode_block, self.spec_k, *args, n_max=self.spec_ngram_n)
        self.stats["decode_blocks"] += 1
        S = self.spec_k + 1
        # f64 holds token ids and f32 logprobs exactly: one readback
        rows = torch.cat([ts.to(torch.float64), lps.to(torch.float64),
                          ncommit[..., None].to(torch.float64)], dim=2).tolist()
        for step in rows:                           # [slots][S tokens, S logprobs, n]
            for slot, req in enumerate(self._active):
                if req is None:
                    continue
                row = step[slot]
                n = int(row[-1])
                self.stats_spec["steps"] += 1
                self.stats_spec["accepted"] += n - 1
                for j in range(n):
                    if self._active[slot] is not req:       # ended inside the step
                        break
                    tok_j = int(row[j])
                    self._tokens[slot] = tok_j
                    req.logprobs.append(row[S + j])
                    self._emit(req, tok_j)

    def _loop(self):
        while not self._stop.is_set():
            self._admit_step_with_oom_retry()
            if not any(self._active):
                if self._pending is None:
                    time.sleep(0.002)
                continue
            self._decode_block()

    def _run(self):
        # inference mode is per thread: this thread alone runs the model
        try:
            with torch.inference_mode():
                self._loop()
        except Exception as e:  # the thread's boundary: every waiting request must hear of it
            log.exception("the scheduler loop stopped")
            self._fail(e)

    def _fail(self, e: Exception):
        """End every pending, active and queued request with the error; a
        submit after this raises (with the first error)."""
        with self._submit_lock:
            self._error = self._error or e
        reqs = [r for r in self._active if r is not None]
        if self._pending is not None:
            reqs.append(self._pending["req"])
        self._active = [None] * self.num_slots
        self._pending = None
        while True:
            try:
                reqs.append(self._in_queue.get_nowait())
            except queue.Empty:
                break
        for r in reqs:
            r.error = e
            r.out_queue.put(None)
