"""Where a request's decode numerics depend on the batch it decodes in:
V2-Lite Q4 at full width (random weights from seed 0), one prompt
prefilled at batch 1 and copied into row 0 of a 1-row and of a B-row cache
(``kv_cache.insert_slot``), then greedy decode steps on both in lockstep
(each fed the 1-row run's token; the other rows idle). At every step, for
every call the forward makes through ``linear``, ``flash_attention``,
``compute_routing`` and ``moe_forward``, row 0's input and output on both;
printed: the steps' logprob differences, the first call whose row-0 output
differs, and the MoE layers whose row-0 expert picks differ.

With ``--verify K`` the wide side is a speculative verify step instead: one
forward of the 1-row cache at Sq = K + 1 fed [t, b_1..b_K], against K + 1
one-row decode steps from the same state fed the same tokens (b the
one-row greedy tokens, so every draft is the one the decode takes). Each
window position p is compared with decode step p, call by call: the first
call whose row differs (its kind, width and largest difference over its
largest value), the MoE layers whose picks differ, and the logprob of the
fed token; a position is held where no layer picked other experts.

    python tools/batch_rows.py [--slots 4] [--steps 8] [--prompt 40]   # on the card
    python tools/batch_rows.py --verify 1 [--steps 10]                 # on the card

One JSON line at the end; the card's name and power limit beside it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    import numpy as np
    import torch

    from krasis_tpu_torch import build
    from krasis_tpu_torch.config import QuantConfig, preset_config
    from krasis_tpu_torch.models import model as M
    from krasis_tpu_torch.models.synthetic import build_synthetic_engine
    from krasis_tpu_torch.runtime.kv_cache import init_cache, insert_slot

    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=40)
    ap.add_argument("--verify", type=int, default=0, metavar="K",
                    help="compare a verify step at Sq = K + 1 with K + 1 decode steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("batch_rows: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    build.build()
    cfg = preset_config("deepseek-v2-lite")
    eng = build_synthetic_engine(cfg, QuantConfig(expert_bits=4, group_size=128), seed=0)
    params, quant, dev = eng.params, eng.quant, eng.device
    ids = np.random.default_rng(0).integers(100, cfg.vocab_size - 100, args.prompt).tolist()

    calls = []          # (kind, row-0 output) of the running forward, in call order
    window = [0]        # > 0: the forward is a 1-row verify step; keep its window's rows

    def recorded(kind, fn, pick=lambda out: out):
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            row = pick(out)
            row = (row.reshape(window[0], -1) if window[0]
                   else row.reshape(row.shape[0], -1)[:1])
            calls.append((kind, row.detach().clone()))
            return out
        return wrapper

    M.linear = recorded("linear", M.linear)
    M.moe_forward = recorded("moe", M.moe_forward)
    M.flash_attention = recorded("attention", M.flash_attention)
    M.compute_routing = recorded("routing", M.compute_routing, lambda r: r.topk_idx)

    if args.verify:
        verify_steps(args, cfg, params, quant, eng, ids, calls, window, card)
        return

    with torch.inference_mode():
        eng.reset(eng.max_len)
        logits = eng._prefill_prompt(ids)
        caches = {}
        for B in (1, args.slots):
            caches[B] = init_cache(cfg, quant, B, eng.max_len, dev)
            insert_slot(caches[B], eng.cache, 0)
        tok = int(torch.argmax(logits[0]))
        steps = []
        for step in range(args.steps):
            seen = {}
            for B in (1, args.slots):
                calls.clear()
                cur = torch.zeros(B, dtype=torch.int64, device=dev)
                cur[0] = tok
                lg = M.forward(params, cur[:, None], torch.ones(B, dtype=torch.int32, device=dev),
                               caches[B], cfg, quant, prefill=False)
                seen[B] = (torch.log_softmax(lg[0].float(), -1), list(calls))
            (l1, c1), (lb, cb) = seen[1], seen[args.slots]
            first = next(((i, k) for i, ((k, a), (_, b)) in enumerate(zip(c1, cb))
                          if not torch.equal(a, b)), None)
            flips = sum(1 for (k, a), (_, b) in zip(c1, cb)
                        if k == "routing" and not torch.equal(a.sort().values, b.sort().values))
            steps.append({"step": step, "token": tok,
                          "logprob_diff": float((l1[tok] - lb[tok]).abs()),
                          "logits_max_abs_diff": float((l1 - lb).abs().max()),
                          "calls": len(c1), "first_call_that_differs": first,
                          "routing_layers_with_other_picks": flips})
            print(f"[batch_rows] step {step}: {json.dumps(steps[-1])}", flush=True)
            tok = int(torch.argmax(l1))
    print(json.dumps({"tool": "batch_rows", "slots": args.slots, "prompt": args.prompt,
                      "card": card, "steps": steps}))


def verify_steps(args, cfg, params, quant, eng, ids, calls, window, card) -> None:
    """``--verify K``: each step from the committed state, K + 1 one-row
    decode steps (fed t and the greedy tokens they give) on one copy of the
    cache and the verify forward at Sq = K + 1 fed the same tokens on
    another; the decode copy becomes the next step's state."""
    import torch

    from krasis_tpu_torch.models import model as M

    S, dev = args.verify + 1, eng.device
    one = torch.ones(1, dtype=torch.int32, device=dev)

    def copy(cache):
        return {"layers": [{n: t.clone() for n, t in lc.items()} for lc in cache["layers"]],
                "length": cache["length"].clone()}

    positions, held = [], {p: [0, 0] for p in range(S)}
    with torch.inference_mode():
        eng.reset(eng.max_len)
        tok = int(torch.argmax(eng._prefill_prompt(ids)[0]))
        for step in range(args.steps):
            narrow, feed, n_calls, n_lsm = copy(eng.cache), [tok], [], []
            window[0] = 0
            for _ in range(S):
                calls.clear()
                lg = M.forward(params, torch.tensor([[feed[-1]]], device=dev), one, narrow, cfg,
                               quant, prefill=False)
                n_calls.append(list(calls))
                n_lsm.append(torch.log_softmax(lg[0].float(), -1))
                feed.append(int(torch.argmax(lg[0])))
            wide = copy(eng.cache)
            window[0] = S
            calls.clear()
            lg = M.forward(params, torch.tensor([feed[:S]], device=dev),
                           torch.full((1,), S, dtype=torch.int32, device=dev), wide, cfg, quant,
                           prefill=False, return_all_logits=True)
            window[0] = 0
            w_calls, w_lsm = list(calls), torch.log_softmax(lg[0].float(), -1)
            for p in range(S):
                first = None
                for i, ((kind, a), (_, b)) in enumerate(zip(w_calls, n_calls[p])):
                    wa, nb = a[p], b[0]
                    if kind == "routing":
                        wa, nb = wa.sort().values, nb.sort().values
                    if not torch.equal(wa, nb):
                        d = float((wa.float() - nb.float()).abs().max()
                                  / nb.float().abs().max().clamp(min=1e-30))
                        first = [i, kind, int(nb.numel()), d]
                        break
                flips = sum(1 for (kind, a), (_, b) in zip(w_calls, n_calls[p])
                            if kind == "routing"
                            and not torch.equal(a[p].sort().values, b[0].sort().values))
                t_p = feed[p + 1]
                held[p][0] += 1
                held[p][1] += int(flips == 0)
                positions.append({
                    "step": step, "position": p, "token": t_p,
                    "logprob_diff": float((w_lsm[p, t_p] - n_lsm[p][t_p]).abs()),
                    "logits_max_abs_diff": float((w_lsm[p] - n_lsm[p]).abs().max()),
                    "calls": [len(w_calls), len(n_calls[p])],
                    "first_call_that_differs": first,
                    "routing_layers_with_other_picks": flips})
                print(f"[batch_rows] verify k={args.verify}: {json.dumps(positions[-1])}",
                      flush=True)
            eng.cache, tok = narrow, feed[S]
    print(json.dumps({"tool": "batch_rows", "verify_k": args.verify, "prompt": args.prompt,
                      "card": card, "held_positions": {p: f"{h} of {n}"
                                                       for p, (n, h) in held.items()},
                      "positions": positions}))


if __name__ == "__main__":
    main()
