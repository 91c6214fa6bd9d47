"""Generation engine: chunked prefill, then a decode loop (PyTorch).

The port of ``krasis_tpu/runtime/engine.py`` ``Engine.generate`` for the
vanilla path: a prompt is prefilled in ``CHUNK``-token chunks that attend
to the cache written by the earlier ones, then tokens are decoded one
forward at a time, with one host synchronisation per ``decode_block``
tokens. Prefill chunks are not padded to the reference's compile buckets
(no valid row depends on padding rows), except that a chunk gets at
least ``MIN_PREFILL_ROWS`` rows so that prefill always takes the grouped
MoE regime, as the reference's smallest bucket guarantees.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..config import ModelConfig, QuantConfig
from ..device import resolve_device
from ..models.model import forward
from ..models.params import fold_shared_experts
from ..ops.sampling import SamplingParams, sample
from .kv_cache import init_cache, resolve_kv_quant

CHUNK = 2048
MIN_PREFILL_ROWS = 128
HISTORY_BUCKETS = (2048, 4096, 8192, 16384, 32768, 65536)


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
    finite: bool = True       # every logit of the run was finite

    @property
    def prefill_tok_s(self) -> float:
        return self.prompt_len / self.prefill_s if self.prefill_s > 0 else 0.0

    @property
    def decode_tok_s(self) -> float:
        n = len(self.tokens)
        return n / self.decode_s if self.decode_s > 0 and n else 0.0


class Engine:
    """Single-sequence inference engine (one cache slot)."""

    def __init__(self, cfg: ModelConfig, quant: QuantConfig, params: Dict[str, Any],
                 max_len: int = 4096, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.quant = quant = resolve_kv_quant(cfg, quant, 1, max_len)
        if quant.fold_shared_decode:
            params = fold_shared_experts(params, cfg, quant)
        self.params = params
        self.max_len = max_len
        self.decode_block = 8       # tokens per host synchronisation
        self.chunk = CHUNK
        self._cache_len = max_len
        self.cache = init_cache(cfg, quant, 1, max_len, self.device)

    def reset(self, cache_len: Optional[int] = None):
        self._cache_len = cache_len or self.max_len
        self.cache = init_cache(self.cfg, self.quant, 1, self._cache_len, self.device)

    def _forward(self, tokens: torch.Tensor, seq_lens: torch.Tensor,
                 prefill: bool) -> torch.Tensor:
        return forward(self.params, tokens, seq_lens, self.cache, self.cfg,
                       self.quant, prefill)

    def _prefill_prompt(self, prompt_ids: Sequence[int]) -> torch.Tensor:
        """Prefill in chunks of self.chunk; returns last-position logits."""
        n = len(prompt_ids)
        pos = 0
        logits = None
        while pos < n:
            m = min(self.chunk, n - pos)
            tokens = torch.zeros((1, max(m, MIN_PREFILL_ROWS)), dtype=torch.int64)
            tokens[0, :m] = torch.tensor(prompt_ids[pos:pos + m], dtype=torch.int64)
            seq_lens = torch.tensor([m], dtype=torch.int32)
            logits = self._forward(tokens.to(self.device), seq_lens.to(self.device),
                                   prefill=True)
            pos += m
        return logits

    @torch.inference_mode()
    def generate(self, prompt_ids: Sequence[int], max_new_tokens: int = 64,
                 sampling: Optional[SamplingParams] = None,
                 stop_ids: Optional[set] = None, seed: int = 0,
                 on_token=None) -> GenerationResult:
        """Generate up to max_new_tokens after the prompt (slot 0).
        `on_token(tok)` raising StopIteration cancels cleanly."""
        sampling = sampling or SamplingParams(temperature=0.0)
        stop_ids = stop_ids or {self.cfg.eos_token_id, *self.cfg.extra_stop_token_ids}
        n = len(prompt_ids)
        # decode may run a whole block past max_new_tokens: keep that
        # overshoot inside the cache
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

        def step_sample(logits):
            tok = sample(logits, sampling, gen, seen)
            seen[0, tok] = True
            return tok

        self._sync()
        t0 = time.perf_counter()
        logits = self._prefill_prompt(prompt_ids)
        self._sync()
        t1 = time.perf_counter()

        finite = torch.isfinite(logits).all()
        next_tok = step_sample(logits)
        out_tokens: List[int] = [int(next_tok[0])]
        stopped = out_tokens[0] in stop_ids
        if on_token is not None:
            try:
                on_token(out_tokens[0])
            except StopIteration:
                stopped = True

        t2 = time.perf_counter()
        ones = torch.ones((1,), dtype=torch.int32, device=self.device)
        while not stopped and len(out_tokens) < max_new_tokens:
            block = []
            for _ in range(self.decode_block):
                logits = self._forward(next_tok[:, None], ones, prefill=False)
                finite &= torch.isfinite(logits).all()
                next_tok = step_sample(logits)
                block.append(next_tok[0])
            for tok in torch.stack(block).tolist():     # one sync per block
                out_tokens.append(tok)
                if on_token is not None:
                    try:
                        on_token(tok)
                    except StopIteration:
                        stopped = True
                        break
                if tok in stop_ids or len(out_tokens) >= max_new_tokens:
                    stopped = True
                    break
        self._sync()
        t3 = time.perf_counter()
        return GenerationResult(tokens=out_tokens, prompt_len=n, prefill_s=t1 - t0,
                                decode_s=t3 - t2, finite=bool(finite))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
