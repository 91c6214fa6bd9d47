"""Multi-token prediction (MTP) module and speculative decoding.

The port of ``krasis_tpu/models/mtp.py``. DeepSeek-V3 / Kimi checkpoints
ship one more decoder layer that predicts token t+2: its input at position
i is ``eh_proj([enorm(emb(t_{i+1})) ; hnorm(h_i)])``, with ``h_i`` the main
model's final-norm hidden, then one ordinary layer (its own KV cache), a
final norm and the shared lm_head.

A verify step feeds ``[t, d_1..d_k]`` (one forward at Sq = k + 1) and
samples the k + 1 positions in order; position i commits only while every
earlier draft equalled its sample, so each committed token's logits were
computed from valid cache rows. Greedy output is the vanilla greedy output
and sampled output follows the vanilla distribution; the drafts (the MTP
argmax, or prompt lookup in ``models/spec_ngram.py``) only set how many
tokens a step commits. Rejected positions leave stale cache rows past the
valid length: ``kv_len`` masks them and the next step's rows overwrite
them. A DeltaNet layer's state is advanced by the committed prefix alone
(``model.la_spec_commit``).

Everything stays on the device: a block of verify steps returns its
tokens, logprobs and commit counts as tensors, read back once by the
caller, as ``decode_block_batched`` does.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import ModelConfig, QuantConfig
from ..ops.norm import rms_norm
from ..ops.qmm import linear
from ..ops.sampling import sample_batched
from ..parallel.mesh import dp_groups
from .model import chosen_logprob, forward, la_spec_commit, make_layer_step, step_inputs
from .params import mtp_layer_spec


def spec_config(cfg: ModelConfig, params: Dict[str, Any]) -> Tuple[Optional[str], int]:
    """(mode, draft depth) of speculative decoding: the one gate of the
    engine and the scheduler. mode is "mtp" (the checkpoint's MTP module, on
    a model that is not a DeltaNet hybrid), "ngram" (prompt lookup, any
    model) or None (vanilla decode). ``KRASIS_TPU_SPEC_MODE`` ∈ auto / mtp /
    ngram / off (auto: mtp where the module is, else off);
    ``KRASIS_TPU_NO_SPEC`` set means off; ``KRASIS_TPU_SPEC_K`` the depth
    (default 1 for mtp, 3 for ngram), at least 1."""
    want = os.environ.get("KRASIS_TPU_SPEC_MODE", "auto").lower()
    if os.environ.get("KRASIS_TPU_NO_SPEC"):
        want = "off"
    mtp_ok = cfg.num_nextn_predict_layers > 0 and "mtp" in params and not cfg.is_hybrid
    if want in ("auto", "mtp"):
        chosen = "mtp" if mtp_ok else None
    elif want == "ngram":
        chosen = "ngram"
    else:
        chosen = None
    default_k = 3 if chosen == "ngram" else 1
    return chosen, max(1, int(os.environ.get("KRASIS_TPU_SPEC_K", str(default_k))))


def mtp_forward(params: Dict[str, Any], tokens: torch.Tensor, seq_lens: torch.Tensor,
                hidden: torch.Tensor, cache: Dict[str, Any], cfg: ModelConfig,
                quant: QuantConfig, prefill: bool, history: int = 0,
                return_all_logits: bool = False, return_hidden: bool = False):
    """One pass of the MTP module over tokens [B, S] (t_{i+1} beside the
    main model's hidden [B, S, H] at i), seq_lens [B] valid rows, after the
    MTP cache's own length; writes its rows and advances that length in
    place. Returns f32 logits ([B, V] at each row's last valid row, or [B,
    S, V]) and with `return_hidden` also the module's final-norm hidden [B,
    S, H], which feeds the next depth of a draft chain. Its layer runs with
    the decode expert activation in decode and bf16 in prefill, and on the
    first prefill chunk (`history` 0) attends to its own fresh rows. A
    cache whose slots split over a mesh's dp groups runs each group's rows
    on its devices (``parallel/mesh.dp_groups``)."""
    if "dp" in cache:
        return dp_groups(params, cache, lambda gp, gc, tok, sl, hid: mtp_forward(
            gp, tok, sl, hid, gc, cfg, quant, prefill, history, return_all_logits,
            return_hidden), (tokens, seq_lens, hidden))
    mtp = params["mtp"]
    B, S = tokens.shape
    positions, valid, kv_len, at = step_inputs(cache["length"], seq_lens, S, [cache["layer"]],
                                               prefill)
    emb = params["embed"][tokens]
    x = torch.cat([rms_norm(emb, mtp["enorm"], cfg.rms_norm_eps, cfg.norm_plus_one),
                   rms_norm(hidden, mtp["hnorm"], cfg.rms_norm_eps, cfg.norm_plus_one)],
                  dim=-1)
    x = linear(x, mtp["eh_proj"])
    step = make_layer_step(cfg, prefill=prefill, positions=positions, valid=valid,
                           kv_len=kv_len,
                           activation="bf16" if prefill else quant.expert_activation,
                           fresh=prefill and history == 0, at=at)
    x = step(x, mtp["layer"], cache["layer"], mtp_layer_spec(cfg))
    x = rms_norm(x, mtp["final_norm"], cfg.rms_norm_eps, cfg.norm_plus_one)
    h_out = x
    if not return_all_logits:
        last = torch.clamp(seq_lens.to(torch.int64) - 1, min=0)
        x = x[torch.arange(B, device=x.device), last]
    cache["length"] = kv_len
    logits = linear(x, mtp.get("head", params["lm_head"]), out_dtype=torch.float32)
    return (logits, h_out) if return_hidden else logits


def spec_prefill(params: Dict[str, Any], tokens: torch.Tensor, next_tokens: torch.Tensor,
                 seq_lens: torch.Tensor, mtp_seq_lens: torch.Tensor, cache: Dict[str, Any],
                 mtp_cache: Dict[str, Any], cfg: ModelConfig, quant: QuantConfig,
                 history: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One prompt chunk of speculative prefill: the main forward, then the
    MTP module over the chunk shifted by one (``next_tokens[i] =
    prompt[pos + i + 1]``). On the last chunk the caller passes
    ``mtp_seq_lens = seq_lens - 1``: the input at the last prompt position
    needs the first sampled token, which ``first_draft`` brings. Returns
    (last-token logits [B, V], last-position hidden [B, H])."""
    logits, hidden = forward(params, tokens, seq_lens, cache, cfg, quant, prefill=True,
                             history=history, return_hidden=True)
    mtp_forward(params, next_tokens, mtp_seq_lens, hidden, mtp_cache, cfg, quant,
                prefill=True, history=history)
    last = torch.clamp(seq_lens.to(torch.int64) - 1, min=0)
    return logits, hidden[torch.arange(tokens.shape[0], device=hidden.device), last]


def _draft_chain(params: Dict[str, Any], tok: torch.Tensor, h: torch.Tensor,
                 mtp_cache: Dict[str, Any], cfg: ModelConfig, quant: QuantConfig, k: int,
                 keep_rows: int) -> torch.Tensor:
    """k drafts [B, k] from the one MTP module, recursed: call 1 takes
    (emb(tok), h) at the cache's length, call j the previous draft and the
    module's own hidden. Only the first `keep_rows` rows written are real:
    the cache length ends `keep_rows` past where it began, and the rest are
    overwritten by the next verify step."""
    B = tok.shape[0]
    seq1 = torch.ones((B,), dtype=torch.int32, device=tok.device)
    commit_len = mtp_cache["length"] + keep_rows
    drafts = []
    cur_tok, cur_h = tok, h
    for _ in range(k):
        mlogits, mh = mtp_forward(params, cur_tok[:, None], seq1, cur_h[:, None, :], mtp_cache,
                                  cfg, quant, prefill=False, return_all_logits=True,
                                  return_hidden=True)
        cur_tok, cur_h = torch.argmax(mlogits[:, 0], dim=-1), mh[:, 0]
        drafts.append(cur_tok)
    mtp_cache["length"] = commit_len
    return torch.stack(drafts, dim=1)


def first_draft(params: Dict[str, Any], t1: torch.Tensor, h_last: torch.Tensor,
                mtp_cache: Dict[str, Any], cfg: ModelConfig, quant: QuantConfig,
                k: int = 1) -> torch.Tensor:
    """The draft chain at the last prompt position once the first token t1
    [B] is sampled: k drafts [B, k]; brings the MTP cache level with the
    main cache (both at the prompt's length)."""
    return _draft_chain(params, t1, h_last, mtp_cache, cfg, quant, k, keep_rows=1)


def verify_and_sample(logits: torch.Tensor, drafts: torch.Tensor,
                      generator: Optional[torch.Generator], seen: torch.Tensor,
                      temperature: torch.Tensor, top_p: torch.Tensor,
                      presence_penalty: torch.Tensor, top_k: torch.Tensor,
                      max_top_k: int = 64):
    """The exactness core of every verify step: logits [B, S, V] at the S =
    k + 1 positions fed [tok, d_1..d_k], drafts [B, k]. Samples the
    positions in order with ``sample_batched`` (one draw from `generator`
    each, as S vanilla steps draw), each with the presence mask of the
    committed prefix (seen [B, V], updated in place as tokens commit);
    position i commits only while every earlier draft equalled its sample.
    Returns (tokens [B, S] int64, logprobs [B, S] f32, committed [B] int32,
    1 to S)."""
    B, S = drafts.shape[0], drafts.shape[1] + 1
    rows = torch.arange(B, device=logits.device)
    ok = torch.ones((B,), dtype=torch.bool, device=logits.device)
    ncommit = torch.zeros((B,), dtype=torch.int32, device=logits.device)
    ts, lps = [], []
    for i in range(S):
        t_i = sample_batched(logits[:, i], temperature, top_p, presence_penalty, seen, top_k,
                             max_top_k, generator)
        ts.append(t_i)
        lps.append(chosen_logprob(logits[:, i], t_i))
        ncommit += ok.to(torch.int32)
        seen[rows, t_i] = seen[rows, t_i] | ok
        if i < S - 1:
            ok = ok & (drafts[:, i].to(t_i.dtype) == t_i)
    return torch.stack(ts, dim=1), torch.stack(lps, dim=1), ncommit


def verify_step(params: Dict[str, Any], tok: torch.Tensor, drafts: torch.Tensor,
                cache: Dict[str, Any], cfg: ModelConfig, quant: QuantConfig,
                generator: Optional[torch.Generator], seen: torch.Tensor,
                temperature: torch.Tensor, top_p: torch.Tensor, presence_penalty: torch.Tensor,
                top_k: torch.Tensor, max_top_k: int = 64, return_hidden: bool = False):
    """One verify step of either draft source over every row of the cache:
    the forward over [tok, d_1..d_k] (Sq = k + 1, DeltaNet state held back),
    ``verify_and_sample``, the DeltaNet layers advanced by each row's
    committed prefix, and the cache length stepped back on the device past
    it. Returns (tokens [B, S], logprobs [B, S], committed [B], whether every
    logit was finite, and with `return_hidden` the final-norm hidden [B, S,
    H])."""
    S = drafts.shape[1] + 1
    seqS = torch.full((tok.shape[0],), S, dtype=torch.int32, device=tok.device)
    out = forward(params, torch.cat([tok[:, None], drafts.to(tok.dtype)], dim=1), seqS, cache,
                  cfg, quant, prefill=False, return_all_logits=True,
                  return_hidden=return_hidden, spec_la=True)
    logits, hidden = out if return_hidden else (out, None)
    ts, lps, ncommit = verify_and_sample(logits, drafts, generator, seen, temperature, top_p,
                                         presence_penalty, top_k, max_top_k)
    la_spec_commit(cache, ncommit)
    # the uncommitted positions' rows are stale: step the valid length back,
    # so that they are masked and then overwritten
    cache["length"] = cache["length"] - (S - ncommit)
    finite = torch.isfinite(logits).all()
    return (ts, lps, ncommit, finite, hidden) if return_hidden else (ts, lps, ncommit, finite)


def spec_decode_block(params: Dict[str, Any], tok: torch.Tensor, drafts: torch.Tensor,
                      cache: Dict[str, Any], mtp_cache: Dict[str, Any], cfg: ModelConfig,
                      quant: QuantConfig, steps: int, generator: Optional[torch.Generator],
                      seen: torch.Tensor, temperature: torch.Tensor, top_p: torch.Tensor,
                      presence_penalty: torch.Tensor, top_k: torch.Tensor,
                      max_top_k: int = 64):
    """`steps` MTP verify steps over every row of the cache, each committing
    1 to k + 1 tokens a row (k = drafts.shape[1]; the reference's
    ``make_spec_decode_fn``). tok [B] is each row's last committed token and
    drafts [B, k] its drafts; both caches are updated in place, their
    lengths stepped back on the device by the uncommitted positions. Returns
    (tokens [steps, B, k + 1], logprobs alike, committed [steps, B],
    whether every logit was finite, the next tok, the next drafts), all
    left on the device: the host emits tokens[i, b, :committed[i, b]]."""
    B, k = drafts.shape
    S = k + 1
    seqS = torch.full((B,), S, dtype=torch.int32, device=tok.device)
    finite = torch.ones((), dtype=torch.bool, device=tok.device)
    rows = torch.arange(B, device=tok.device)
    out_t, out_lp, out_n = [], [], []
    for _ in range(steps):
        ts, lps, ncommit, ok, hidden = verify_step(
            params, tok, drafts, cache, cfg, quant, generator, seen, temperature, top_p,
            presence_penalty, top_k, max_top_k, return_hidden=True)
        finite &= ok
        # the module pairs each position's hidden with the token sampled
        # after it; its rows past the committed prefix are stale as well
        mlogits, mhidden = mtp_forward(params, ts, seqS, hidden, mtp_cache, cfg, quant,
                                       prefill=False, return_all_logits=True,
                                       return_hidden=True)
        mtp_cache["length"] = mtp_cache["length"] - (S - ncommit)
        last = (ncommit - 1).to(torch.int64)
        tok = ts[rows, last]
        d1 = torch.argmax(mlogits, dim=-1)[rows, last]
        if k > 1:
            deeper = _draft_chain(params, d1, mhidden[rows, last], mtp_cache, cfg, quant,
                                  k - 1, keep_rows=0)
            drafts = torch.cat([d1[:, None], deeper], dim=1)
        else:
            drafts = d1[:, None]
        out_t.append(ts)
        out_lp.append(lps)
        out_n.append(ncommit)
    return (torch.stack(out_t), torch.stack(out_lp), torch.stack(out_n), finite, tok, drafts)
