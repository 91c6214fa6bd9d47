"""Generation engine: chunked prefill, then a decode loop (PyTorch).

The port of ``krasis_tpu/runtime/engine.py`` ``Engine.generate`` for the
vanilla path, over any cache ``init_cache`` builds (KV buffers, and the
DeltaNet state and conv window of a hybrid, which a later chunk picks up
where the earlier one left them): a prompt is prefilled in ``CHUNK``-token chunks that attend
to the cache written by the earlier ones, then tokens are decoded one
forward at a time, with one host synchronisation per ``decode_block``
tokens. Prefill chunks are not padded to the reference's compile buckets
(no valid row depends on padding rows), except that a chunk gets at
least ``MIN_PREFILL_ROWS`` rows so that prefill always takes the grouped
MoE regime, as the reference's smallest bucket guarantees.

With speculative decoding available (``models/mtp.spec_config``), a
request decodes in blocks of ``decode_block`` verify steps instead, each
committing 1 to k + 1 tokens (``_generate_spec``; MTP drafts, whose module
is prefilled beside the model, or prompt lookup); one that asks for
``top_logprobs``, or whose spec block would overshoot the cache where
vanilla decode would not, takes the vanilla path.

``Engine(..., offload=store)`` serves a model whose routed experts live in
host memory (``offload.HostExpertStore``; the layers hold no expert
stacks): every forward hands each MoE layer's routed picks to the host
engine (``models/model.py`` ``_offload_mlp``), prefill included. The shared
experts are not folded and speculative decoding is off, as in the
reference. ``runtime/offload_engine.py`` ``OffloadEngine`` streams the
expert weights through the card for prefill instead.

``Engine(..., mesh=mesh)`` runs over a device mesh (``parallel/mesh.py``):
the parameters sharded (experts over ep, attention by head where it
splits), the shared experts not folded, the cache laid out by
``cache_shardings``; speculative decoding runs on the mesh as well. The
engine's one slot does not split over dp: its row runs on dp group 0.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..config import ModelConfig, QuantConfig
from ..models.model import chosen_logprob, forward
from ..models.mtp import first_draft, spec_config, spec_decode_block, spec_prefill
from ..models.params import fold_shared_experts
from ..models.spec_ngram import ngram_decode_block
from ..ops.sampling import SamplingParams, sample, sample_batched
from ..parallel.mesh import cache_shardings, placed
from .kv_cache import init_cache, init_mtp_cache, resolve_kv_quant

CHUNK = 2048
MIN_PREFILL_ROWS = 128
MIN_CHUNK = 128          # OOM halving stops here
HISTORY_BUCKETS = (2048, 4096, 8192, 16384, 32768, 65536)

log = logging.getLogger("krasis_tpu_torch.engine")


def _is_oom(e: BaseException) -> bool:
    """True for the card running out of memory."""
    return isinstance(e, torch.cuda.OutOfMemoryError)


def halved_chunk(e: BaseException, chunk: int, what: str) -> Optional[int]:
    """The prefill chunk to retry with after `e`: half of `chunk` when the
    card ran out of memory and `chunk` is above MIN_CHUNK, else None (the
    caller re-raises)."""
    if not _is_oom(e) or chunk <= MIN_CHUNK:
        return None
    log.warning("%s ran the card out of memory; retrying with chunk=%d", what, chunk // 2)
    return chunk // 2


def padded_rows(rows: Sequence[Sequence[int]], width: int, device) -> torch.Tensor:
    """Token rows [len(rows), max(width, MIN_PREFILL_ROWS)] on `device`,
    each row's ids then zeros: a prefill chunk padded so that it takes the
    grouped MoE regime."""
    tokens = torch.zeros((len(rows), max(width, MIN_PREFILL_ROWS)), dtype=torch.int64)
    for i, ids in enumerate(rows):
        tokens[i, :len(ids)] = torch.tensor(ids, dtype=torch.int64)
    return tokens.to(device)


def prefill_rows(params: Dict[str, Any], ids: Sequence[int], cache: Dict[str, Any],
                 cfg: ModelConfig, quant: QuantConfig, history: int = 0,
                 return_all_logits: bool = False, offload=None) -> torch.Tensor:
    """One prefill forward of `ids` into the batch-1 `cache` after `history`
    cached tokens, padded to at least MIN_PREFILL_ROWS rows so that it takes
    the grouped MoE regime."""
    dev = cache["length"].device
    return forward(params, padded_rows([ids], len(ids), dev),
                   torch.tensor([len(ids)], dtype=torch.int32, device=dev), cache, cfg, quant,
                   prefill=True, return_all_logits=return_all_logits, history=history,
                   offload=offload)


def spec_prefill_rows(params: Dict[str, Any], prompt_ids: Sequence[int], pos: int, m: int,
                      cache: Dict[str, Any], mtp_cache: Dict[str, Any], cfg: ModelConfig,
                      quant: QuantConfig):
    """``prefill_rows`` of a speculative engine: the `m` prompt tokens from
    `pos` into the batch-1 `cache`, and the MTP module over them shifted by
    one into `mtp_cache` (the prompt's last position waits for the first
    sampled token). Returns (last-token logits, last-position hidden)."""
    k = min(m, len(prompt_ids) - 1 - pos)      # the shifted chunk's valid rows
    dev = cache["length"].device
    tokens = padded_rows([prompt_ids[pos:pos + m], prompt_ids[pos + 1:pos + 1 + k]], m, dev)
    return spec_prefill(params, tokens[:1], tokens[1:],
                        torch.tensor([m], dtype=torch.int32, device=dev),
                        torch.tensor([k], dtype=torch.int32, device=dev), cache, mtp_cache,
                        cfg, quant, history=pos)


def max_top_k(sampling: SamplingParams, V: int) -> int:
    """The truncation a verify step's sampling needs: 1 when greedy (the
    sampled branch is discarded), the vocabulary when top_k is off, else
    top_k (the reference's ``static_max_top_k``)."""
    if sampling.temperature <= 0.0:
        return 1
    return V if sampling.top_k <= 0 else min(sampling.top_k, V)


def pick_cache_len(needed: int, max_len: int) -> int:
    """Smallest cache bucket covering `needed` tokens, at most max_len."""
    for b in HISTORY_BUCKETS:
        if needed <= b <= max_len:
            return b
    return max_len


@dataclass
class GenerationResult:
    tokens: List[int]
    prompt_len: int
    prefill_s: float
    decode_s: float
    logprobs: Optional[List[float]] = None
    top_logprobs: Optional[List[List[Tuple[int, float]]]] = None
    finite: bool = True       # every logit of the run was finite

    @property
    def prefill_tok_s(self) -> float:
        return self.prompt_len / self.prefill_s if self.prefill_s > 0 else 0.0

    @property
    def decode_tok_s(self) -> float:
        n = len(self.tokens)
        return n / self.decode_s if self.decode_s > 0 and n else 0.0


class Engine:
    """Single-sequence inference engine (one cache slot; continuous batching
    is ``runtime/scheduler.py``)."""

    def __init__(self, cfg: ModelConfig, quant: QuantConfig, params: Dict[str, Any],
                 max_len: int = 4096, device=None, offload=None, mesh=None):
        self.cfg = cfg
        self.quant = quant = resolve_kv_quant(cfg, quant, 1, max_len)
        # the host store of an offloaded model's routed experts
        self.offload = offload
        # a device mesh (parallel/mesh.py): the parameters sharded over it,
        # the cache laid out to match
        self.mesh = mesh
        params, self.device = placed(params, cfg, mesh, device, offload)
        if quant.fold_shared_decode and offload is None and mesh is None:
            params = fold_shared_experts(params, cfg, quant)
        self.params = params
        self.max_len = max_len
        self.decode_block = 8       # tokens (vanilla) or verify steps (spec) per host sync
        self.chunk = CHUNK          # prefill chunk; halves when the card runs out of memory
        # speculative decoding (models/mtp.py, models/spec_ngram.py): the
        # gate and the depth from spec_config
        self.spec_mode, self.spec_k = spec_config(cfg, params)
        if offload is not None:
            self.spec_mode = None       # the reference has no spec path under offload
        self.spec_available = self.spec_mode is not None
        self.spec_ngram_n = int(os.environ.get("KRASIS_TPU_NGRAM_N", "3"))
        self.last_spec_stats: Optional[Dict[str, int]] = None
        self.mtp_cache = None
        self.reset(max_len)

    def reset(self, cache_len: Optional[int] = None):
        self._cache_len = cache_len or self.max_len
        self.cache = self._placed(init_cache(self.cfg, self.quant, 1, self._cache_len,
                                             self.device))
        if self.spec_mode == "mtp":
            self.mtp_cache = self._placed(init_mtp_cache(self.cfg, self.quant, 1,
                                                         self._cache_len, self.device))

    def _placed(self, cache: Dict[str, Any]) -> Dict[str, Any]:
        return cache if self.mesh is None else cache_shardings(cache, self.params)

    def _forward(self, tokens: torch.Tensor, seq_lens: torch.Tensor,
                 prefill: bool, return_all_logits: bool = False,
                 history: int = 0) -> torch.Tensor:
        return forward(self.params, tokens, seq_lens, self.cache, self.cfg,
                       self.quant, prefill, return_all_logits, history, offload=self.offload)

    def _prefill_prompt(self, prompt_ids: Sequence[int], mtp: bool = False):
        """Prefill in chunks of self.chunk; returns last-position logits, and
        with `mtp` (the MTP module prefilled beside, ``spec_prefill_rows``)
        (logits, last-position hidden). A chunk that runs the card out of
        memory halves self.chunk (down to MIN_CHUNK) and prefills the prompt
        again on fresh caches."""
        while True:
            try:
                return self._prefill_prompt_once(prompt_ids, mtp)
            except Exception as e:
                chunk = halved_chunk(e, self.chunk, "prefill")
                if chunk is None:
                    raise
            # out of the handler, so the failed chunk's tensors are released
            self.chunk = chunk
            self.reset(self._cache_len)

    def _prefill_prompt_once(self, prompt_ids: Sequence[int], mtp: bool):
        out = None
        for pos in range(0, len(prompt_ids), self.chunk):
            if mtp:
                out = spec_prefill_rows(self.params, prompt_ids, pos,
                                        min(self.chunk, len(prompt_ids) - pos), self.cache,
                                        self.mtp_cache, self.cfg, self.quant)
            else:
                out = prefill_rows(self.params, prompt_ids[pos:pos + self.chunk], self.cache,
                                   self.cfg, self.quant, history=pos, offload=self.offload)
        return out

    @torch.inference_mode()
    def forward_all_logits(self, prompt_ids: Sequence[int]) -> torch.Tensor:
        """f32 logits [n, V] at every position of the prompt, through the
        serving prefill path in one forward over the whole window (the
        perplexity path)."""
        self.reset()
        n = len(prompt_ids)
        if not 0 < n <= self.max_len:
            raise ValueError(f"window of {n} tokens does not fit max_len={self.max_len}")
        return prefill_rows(self.params, prompt_ids, self.cache, self.cfg, self.quant,
                            return_all_logits=True, offload=self.offload)[0, :n]

    @torch.inference_mode()
    def generate(self, prompt_ids: Sequence[int], max_new_tokens: int = 64,
                 sampling: Optional[SamplingParams] = None,
                 stop_ids: Optional[set] = None, seed: int = 0,
                 on_token=None, on_token_lp=None, top_logprobs: int = 0,
                 want_logprobs: bool = True) -> GenerationResult:
        """Generate up to max_new_tokens after the prompt (slot 0).
        `on_token(tok)` raising StopIteration cancels cleanly;
        `on_token_lp(tok, logprob)` is its variant with the logprob, and both
        may be set (on_token fires first). `result.logprobs` holds the
        logprob of each chosen token under the raw model distribution (f32
        log_softmax of the logits, before temperature and penalty);
        `want_logprobs=False` skips that math in decode and returns zeros
        there. `top_logprobs=N` forces it on and also returns the N most
        likely (token, logprob) pairs of each step."""
        sampling = sampling or SamplingParams(temperature=0.0)
        stop_ids = stop_ids or {self.cfg.eos_token_id, *self.cfg.extra_stop_token_ids}
        n = len(prompt_ids)
        if self.spec_available and top_logprobs == 0:
            # a spec block overshoots by up to (k + 1)·decode_block positions:
            # a prompt near max_len takes the vanilla path rather than be
            # refused or cut shorter than vanilla decode would cut it
            spec_room = self.max_len - n - 1 - (self.spec_k + 1) * self.decode_block
            vanilla_room = self.max_len - n - 1 - self.decode_block
            if spec_room >= min(max_new_tokens, vanilla_room):
                return self._generate_spec(prompt_ids, max_new_tokens, sampling, stop_ids,
                                           seed, on_token, on_token_lp)
        self.last_spec_stats = None          # this request runs the vanilla path
        # decode may run a whole block past max_new_tokens: keep that
        # overshoot inside the cache. A hybrid's DeltaNet state advances
        # with the overshoot too, which is harmless because every request
        # starts from reset()
        room = self.max_len - n - 1 - self.decode_block
        if room < 1:
            raise ValueError(f"prompt ({n} tokens) leaves no room to generate "
                             f"within max_len={self.max_len}")
        max_new_tokens = min(max_new_tokens, room)
        self.reset(pick_cache_len(n + max_new_tokens + self.decode_block + 1,
                                  self.max_len))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        seen = torch.zeros((1, self.cfg.vocab_size), dtype=torch.bool, device=self.device)
        need_lp = want_logprobs or top_logprobs > 0

        def step(logits, with_lp):
            """Sample one token; its logprob (zero unless with_lp) and, when
            asked for, the top-N of the step, all left on the device."""
            tok = sample(logits, sampling, gen, seen)
            seen[0, tok] = True
            top = None
            if with_lp:
                lsm = torch.log_softmax(logits.to(torch.float32), dim=-1)
                lp = lsm[0, tok[0]]
                if top_logprobs > 0:
                    top = torch.topk(lsm[0], top_logprobs)
            else:
                lp = torch.zeros((), dtype=torch.float32, device=self.device)
            return tok, lp, top

        out_tokens: List[int] = []
        out_lps: List[float] = []
        out_top: List[List[Tuple[int, float]]] = []
        stopped = False

        def commit(steps) -> None:
            """Read one block of steps back (one host sync) and hand the
            tokens out until a stop."""
            nonlocal stopped
            cols = [torch.stack([t[0] for t, _, _ in steps])[:, None],
                    torch.stack([lp for _, lp, _ in steps])[:, None]]
            if top_logprobs > 0:
                cols += [torch.stack([top.indices for _, _, top in steps]),
                         torch.stack([top.values for _, _, top in steps])]
            # f64 holds token ids and f32 logprobs exactly: one readback
            rows = torch.cat([c.to(torch.float64) for c in cols], dim=1).tolist()
            for row in rows:
                tok, lp = int(row[0]), row[1]
                out_tokens.append(tok)
                out_lps.append(lp)
                if top_logprobs > 0:
                    out_top.append([(int(i), v) for i, v in
                                    zip(row[2:2 + top_logprobs], row[2 + top_logprobs:])])
                try:
                    if on_token is not None:
                        on_token(tok)
                    if on_token_lp is not None:
                        on_token_lp(tok, lp)
                except StopIteration:
                    stopped = True
                if tok in stop_ids or len(out_tokens) >= max_new_tokens:
                    stopped = True
                if stopped:
                    break

        self._sync()
        t0 = time.perf_counter()
        logits = self._prefill_prompt(prompt_ids)
        self._sync()
        t1 = time.perf_counter()

        finite = torch.isfinite(logits).all()
        # the first token's logprob is always taken, as the reference does
        first = step(logits, True)
        next_tok = first[0]
        commit([first])

        t2 = time.perf_counter()
        ones = torch.ones((1,), dtype=torch.int32, device=self.device)
        while not stopped:
            block = []
            for _ in range(self.decode_block):
                logits = self._forward(next_tok[:, None], ones, prefill=False)
                finite &= torch.isfinite(logits).all()
                block.append(step(logits, need_lp))
                next_tok = block[-1][0]
            commit(block)
        self._sync()
        t3 = time.perf_counter()
        return GenerationResult(tokens=out_tokens, prompt_len=n, prefill_s=t1 - t0,
                                decode_s=t3 - t2, logprobs=out_lps,
                                top_logprobs=out_top if top_logprobs > 0 else None,
                                finite=bool(finite))

    def _generate_spec(self, prompt_ids: Sequence[int], max_new_tokens: int,
                       sampling: SamplingParams, stop_ids: set, seed: int, on_token,
                       on_token_lp) -> GenerationResult:
        """Generation through speculative decoding, MTP drafts or prompt
        lookup by self.spec_mode: blocks of decode_block verify steps, each
        committing 1 to spec_k + 1 tokens, one readback a block. Greedy
        output equals the vanilla path's; sampled output follows its
        distribution. Counts land in self.last_spec_stats: verify steps,
        drafts accepted, tokens emitted."""
        mtp = self.spec_mode == "mtp"
        n = len(prompt_ids)
        block, S = self.decode_block, self.spec_k + 1
        span = S * block                 # the positions a block may touch
        room = self.max_len - n - 1 - span
        if room < 1:
            raise ValueError(f"prompt ({n} tokens) leaves no room to generate "
                             f"within max_len={self.max_len}")
        max_new_tokens = min(max_new_tokens, room)
        self.reset(pick_cache_len(n + max_new_tokens + span + 1, self.max_len))
        dev, V = self.device, self.cfg.vocab_size
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        seen = torch.zeros((1, V), dtype=torch.bool, device=dev)
        temp = torch.full((1,), float(sampling.temperature), device=dev)
        top_p = torch.full((1,), float(sampling.top_p), device=dev)
        pres = torch.full((1,), float(sampling.presence_penalty), device=dev)
        top_k = torch.full((1,), int(sampling.top_k), dtype=torch.int32, device=dev)
        mtk = max_top_k(sampling, V)

        out_tokens: List[int] = []
        out_lps: List[float] = []
        stopped = False

        def emit(tok: int, lp: float) -> None:
            nonlocal stopped
            out_tokens.append(tok)
            out_lps.append(lp)
            try:
                if on_token is not None:
                    on_token(tok)
                if on_token_lp is not None:
                    on_token_lp(tok, lp)
            except StopIteration:
                stopped = True
            if tok in stop_ids or len(out_tokens) >= max_new_tokens:
                stopped = True

        self._sync()
        t0 = time.perf_counter()
        if mtp:
            logits, h_last = self._prefill_prompt(prompt_ids, mtp=True)
        else:
            logits = self._prefill_prompt(prompt_ids)
        self._sync()
        t1 = time.perf_counter()
        finite = torch.isfinite(logits).all()
        tok = sample_batched(logits, temp, top_p, pres, seen, top_k, mtk, gen)
        seen[0, tok] = True
        first = torch.stack([tok[0].to(torch.float64),
                             chosen_logprob(logits, tok)[0].to(torch.float64)]).tolist()
        emit(int(first[0]), first[1])

        t2 = time.perf_counter()
        steps = accepted = 0
        args = (gen, seen, temp, top_p, pres, top_k, mtk)
        if mtp:
            drafts = first_draft(self.params, tok, h_last, self.mtp_cache, self.cfg,
                                 self.quant, self.spec_k)
        else:
            # the device-side history: the prompt and the first token
            hist = torch.zeros((1, self._cache_len), dtype=torch.int64)
            hist[0, :n] = torch.tensor(prompt_ids, dtype=torch.int64)
            hist = hist.to(dev)
            hist[0, n] = tok[0]
        while not stopped:
            if mtp:
                ts, lps, ncommit, ok, tok, drafts = spec_decode_block(
                    self.params, tok, drafts, self.cache, self.mtp_cache, self.cfg, self.quant,
                    block, *args)
            else:
                ts, lps, ncommit, ok, tok = ngram_decode_block(
                    self.params, tok, self.cache, hist, self.cfg, self.quant, block,
                    self.spec_k, *args, n_max=self.spec_ngram_n)
            finite &= ok
            # f64 holds token ids and f32 logprobs exactly: one readback
            rows = torch.cat([ts[:, 0].to(torch.float64), lps[:, 0].to(torch.float64),
                              ncommit[:, 0, None].to(torch.float64)], dim=1).tolist()
            for row in rows:
                nc = int(row[-1])
                steps += 1
                accepted += nc - 1
                for j in range(nc):
                    emit(int(row[j]), row[S + j])
                    if stopped:
                        break
                if stopped:
                    break
        self._sync()
        t3 = time.perf_counter()
        self.last_spec_stats = {"steps": steps, "accepted": accepted,
                                "emitted": len(out_tokens)}
        return GenerationResult(tokens=out_tokens, prompt_len=n, prefill_s=t1 - t0,
                                decode_s=t3 - t2, logprobs=out_lps, finite=bool(finite))

    def _sync(self):
        for dev in self.mesh.distinct() if self.mesh is not None else (self.device,):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
