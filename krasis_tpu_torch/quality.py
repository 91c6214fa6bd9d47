"""The quantization quality matrix: perplexity deltas per quantization mode.

The port of ``krasis_tpu/quality.py``. A tiny Qwen3-MoE checkpoint in HF's
format (``config.json``, safetensors and a byte-level BPE tokenizer, both
trained here on the held-in domains of the prompt corpus) gives quantization
noise a trained model to move. Every mode is measured through the serving
path (``ModelConfig.from_model_path`` → ``models/loader.load_params``,
quantizing as serving does → ``Engine.forward_all_logits`` →
``perplexity.evaluate_perplexity``) at two window / stride shapes, and
through the teacher-forced decode path (``models/model.forced_decode``), on
held-out text:

    bf16        full-precision baseline (f32 weights)
    q8          int8 experts (with the int8 lm_head / shared / dense defaults)
    q4          int4 experts
    q4-w4a8     int4 experts with int8 activations (decode only)
    q4-attn-int8 / q4-attn-int4   quantized attention projections over q4
    q4-kvfp8    an fp8 e4m3 KV cache over q4
    q4-offload  the host-RAM expert tier (offload.py, native/hostmoe.cpp)

plus exactness rows for speculative decoding (greedy tokens equal with spec
on and off). Incremental modes are judged against q4, their base. The
tokenizer is ``runtime/bpe_train.py`` and the training model
``models/train_qwen3moe.py``: the card's machine has neither ``tokenizers``
nor ``transformers``. Checkpoints are cached under
``$KRASIS_TPU_HOME/quality_torch/<key>``.

    python -m krasis_tpu_torch.quality --steps 600 --seeds 0 --max-tokens 30000
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

VOCAB = 2048
TRAIN_DOMAINS = ("code", "docs", "headers", "catalog")
EVAL_DOMAINS = ("legal", "dialogue")
# train on the first TRAIN_FRACTION of each train domain; the tails are the
# same-distribution held-out text
TRAIN_FRACTION = 0.85
SPECIAL_TOKENS = ("<|endoftext|>", "<|user|>", "<|assistant|>", "<|system|>")

CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "{{ '<|' + message['role'] + '|>' + message['content'] }}"
    "{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|assistant|>' }}{% endif %}"
)

# mode -> (the base mode it is judged against, the largest accepted relative
# PPL increase)
THRESHOLDS: Dict[str, Tuple[Optional[str], float]] = {
    "bf16": (None, 0.0),
    "q8": ("bf16", 0.005),
    "q4": ("bf16", 0.02),
    "q4-w4a8": ("q4", 0.01),
    "q4-attn-int8": ("q4", 0.005),
    "q4-attn-int4": ("q4", 0.02),
    "q4-kvfp8": ("q4", 0.005),
    "q4-offload": ("q4", 0.003),
}


def _quant_for(mode: str, group_size: int):
    from .config import QuantConfig

    # the expert activation pinned per mode, so that each row isolates one lever
    base = dict(group_size=group_size, kv_cache_dtype="bf16", expert_activation="bf16")
    if mode == "bf16":
        return QuantConfig(expert_bits=16, lm_head="bf16", attention="bf16",
                           shared_expert="bf16", dense_mlp="bf16", **base)
    if mode == "q8":
        return QuantConfig(expert_bits=8, **base)
    if mode in ("q4", "q4-offload"):
        return QuantConfig(expert_bits=4, **base)
    if mode == "q4-w4a8":
        base["expert_activation"] = "int8"
        return QuantConfig(expert_bits=4, **base)
    if mode == "q4-attn-int8":
        return QuantConfig(expert_bits=4, attention="int8", **base)
    if mode == "q4-attn-int4":
        return QuantConfig(expert_bits=4, attention="int4", **base)
    if mode == "q4-kvfp8":
        base["kv_cache_dtype"] = "fp8"
        return QuantConfig(expert_bits=4, **base)
    raise ValueError(f"unknown mode {mode}")


# --------------------------------------------------------------------------
# The trained tiny checkpoint
# --------------------------------------------------------------------------

def _home() -> str:
    return os.environ.get("KRASIS_TPU_HOME", os.path.expanduser("~/.krasis_tpu"))


def _train_text() -> str:
    from .prompts import load_domain

    return "\n\n".join(load_domain(d)[: int(len(load_domain(d)) * TRAIN_FRACTION)]
                       for d in TRAIN_DOMAINS)


def build_quality_checkpoint(steps: int = 600, seed: int = 0, hidden: int = 256,
                             layers: int = 4, experts: int = 8, top_k: int = 2,
                             moe_intermediate: int = 128, batch: int = 8, seq: int = 256,
                             lr: float = 3e-3, out_dir: Optional[str] = None,
                             force: bool = False, log_every: int = 50, device=None) -> str:
    """Train the tokenizer and the tiny model and save them as an HF
    checkpoint; returns its directory. A finished build (meta.json present)
    is reused. The model trains on `device` (the card unless the caller asks
    for the CPU)."""
    import torch

    from .device import resolve_device
    from .models import train_qwen3moe as tq
    from .prompts import load_domain
    from .runtime.bpe_train import save_tokenizer, train_bpe
    from .runtime.tokenizer import Tokenizer
    from .utils.safetensors_io import write_safetensors

    key = (f"qw3moe-h{hidden}l{layers}e{experts}k{top_k}"
           f"m{moe_intermediate}-v{VOCAB}-s{steps}-b{batch}x{seq}"
           f"-lr{lr:g}-seed{seed}-v2")
    out = out_dir or os.path.join(_home(), "quality_torch", key)
    meta_path = os.path.join(out, "meta.json")
    if os.path.exists(meta_path) and not force:
        return out
    os.makedirs(out, exist_ok=True)
    dev = resolve_device(device)

    t0 = time.time()
    train_text = _train_text()
    vocab, merges = train_bpe(
        [train_text[i:i + 8192] for i in range(0, len(train_text), 8192)],
        VOCAB - 4, SPECIAL_TOKENS)
    save_tokenizer(out, vocab, merges, SPECIAL_TOKENS, eos_token=SPECIAL_TOKENS[0],
                   pad_token=SPECIAL_TOKENS[0], chat_template=CHAT_TEMPLATE)
    tok = Tokenizer(out)
    ids = torch.tensor(tok.encode(train_text), dtype=torch.int64)
    t_tok = time.time() - t0

    c = tq.Qwen3MoeTrainConfig(
        vocab_size=VOCAB, hidden_size=hidden, intermediate_size=2 * hidden,
        moe_intermediate_size=moe_intermediate, num_hidden_layers=layers,
        num_attention_heads=4, num_key_value_heads=2, head_dim=64, num_experts=experts,
        num_experts_per_tok=top_k, decoder_sparse_step=1, max_position_embeddings=4096,
        eos_token_id=tok.eos_token_id, router_aux_loss_coef=0.01)
    gen = torch.Generator()
    gen.manual_seed(seed)
    model = tq.Qwen3MoeForTraining(c, gen).to(dev)
    model.train()
    opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=0.01)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, tq.cosine_warmup(steps))

    t1 = time.time()
    losses: List[float] = []
    # explicit: other code in the process may have turned gradients off
    with torch.enable_grad():
        for step in range(steps):
            x = tq.sample_batch(ids, batch, seq, gen).to(dev)
            loss = model.loss(x)
            opt.zero_grad()
            loss.backward()
            torch.nn.utils.clip_grad_norm_(model.parameters(), 1.0)
            opt.step()
            sched.step()
            losses.append(float(loss.detach()))
            if log_every and (step + 1) % log_every == 0:
                print(f"[quality-train] step {step + 1}/{steps} "
                      f"loss={np.mean(losses[-log_every:]):.4f} "
                      f"({time.time() - t1:.0f}s)", flush=True)
    model.eval()

    def _torch_ppl(text):
        with torch.no_grad():
            t = torch.tensor(tok.encode(text)[:2048], dtype=torch.int64, device=dev)[None]
            nll = torch.nn.functional.cross_entropy(model(t)[0, :-1], t[0, 1:])
            return float(torch.exp(nll))

    holdout_ppl = _torch_ppl(load_domain(EVAL_DOMAINS[0])[:40_000])
    tail0 = load_domain(TRAIN_DOMAINS[0])
    tail_ppl = _torch_ppl(tail0[int(len(tail0) * TRAIN_FRACTION):][:40_000])

    write_safetensors(os.path.join(out, "model.safetensors"), tq.state_dict_f32(model))
    tq.write_config(out, c)
    meta = {
        "key": key, "steps": steps, "seed": seed,
        "final_train_loss": float(np.mean(losses[-20:])) if losses else float("nan"),
        "holdout_ppl_torch": holdout_ppl,
        "tail_ppl_torch": tail_ppl,
        "train_fraction": TRAIN_FRACTION,
        "train_domains": TRAIN_DOMAINS, "eval_domains": EVAL_DOMAINS,
        "train_tokens": int(len(ids)), "elapsed_s": round(time.time() - t0, 1),
        "tokenizer_s": round(t_tok, 1), "train_s": round(time.time() - t1, 1),
        "device": str(dev),
    }
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=2)
    print(f"[quality-train] done: train-loss {meta['final_train_loss']:.3f} "
          f"holdout-ppl {holdout_ppl:.2f} in {meta['elapsed_s']}s", flush=True)
    return out


def _load_training_model(ckpt: str, dev):
    """The checkpoint's base model as a ``Qwen3MoeForTraining`` on `dev`."""
    import torch

    from .models import train_qwen3moe as tq
    from .utils.safetensors_io import ShardedSafetensors

    with open(os.path.join(ckpt, "config.json")) as f:
        cj = json.load(f)
    fields = tq.Qwen3MoeTrainConfig.__dataclass_fields__
    c = tq.Qwen3MoeTrainConfig(**{k: v for k, v in cj.items() if k in fields})
    model = tq.Qwen3MoeForTraining(c)
    st = ShardedSafetensors(ckpt)
    want = model.state_dict()
    model.load_state_dict({k: st.tensor(k).clone() for k in want})
    st.close()
    return model.to(dev), c


def train_mtp_head(ckpt: str, steps: int = 400, seed: int = 0, batch: int = 8, seq: int = 256,
                   lr: float = 1e-3, log_every: int = 50, force: bool = False,
                   device=None) -> str:
    """Train a DeepSeek-V3-layout MTP module over the frozen checkpoint and
    append it: one more decoder layer at index num_hidden_layers whose input
    at position i is ``eh_proj([enorm(emb(t_{i+1})) ; hnorm(h_i)])``, trained
    on the t + 2 objective with the lm_head shared. Its tensors join
    model.safetensors under the V3 names and config.json gains
    ``num_nextn_predict_layers: 1``."""
    import torch

    from .device import resolve_device
    from .models import train_qwen3moe as tq
    from .runtime.tokenizer import Tokenizer
    from .utils.safetensors_io import ShardedSafetensors, write_safetensors

    meta_path = os.path.join(ckpt, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("mtp_steps") and not force:
        return ckpt
    dev = resolve_device(device)
    base, c = _load_training_model(ckpt, dev)
    base.eval()
    for p in base.parameters():
        p.requires_grad_(False)
    gen = torch.Generator()
    gen.manual_seed(seed + 101)
    head = tq.MTPHead(c, gen).to(dev)
    head.train()

    ids = torch.tensor(Tokenizer(ckpt).encode(_train_text()), dtype=torch.int64)
    opt = torch.optim.AdamW(head.parameters(), lr=lr, weight_decay=0.01)
    t0 = time.time()
    losses: List[float] = []
    with torch.enable_grad():
        for step in range(steps):
            x = tq.sample_batch(ids, batch, seq, gen).to(dev)
            loss = tq.mtp_loss(base, head, x)
            opt.zero_grad()
            loss.backward()
            torch.nn.utils.clip_grad_norm_(head.parameters(), 1.0)
            opt.step()
            losses.append(float(loss.detach()))
            if log_every and (step + 1) % log_every == 0:
                print(f"[mtp-train] step {step + 1}/{steps} "
                      f"loss={np.mean(losses[-log_every:]):.4f} "
                      f"({time.time() - t0:.0f}s)", flush=True)

    path = os.path.join(ckpt, "model.safetensors")
    st = ShardedSafetensors(ckpt)
    tensors = {k: st.tensor(k).clone() for k in st.keys()}
    st.close()
    tensors.update(head.tensors(c.num_hidden_layers))
    write_safetensors(path + ".tmp", tensors)
    os.replace(path + ".tmp", path)
    cfg_path = os.path.join(ckpt, "config.json")
    with open(cfg_path) as f:
        cj = json.load(f)
    cj["num_nextn_predict_layers"] = 1
    with open(cfg_path, "w") as f:
        json.dump(cj, f, indent=2)
    meta.update(mtp_steps=steps, mtp_final_loss=float(np.mean(losses[-20:])),
                mtp_elapsed_s=round(time.time() - t0, 1))
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=2)
    print(f"[mtp-train] done: loss {meta['mtp_final_loss']:.3f} in "
          f"{meta['mtp_elapsed_s']}s", flush=True)
    return ckpt


# --------------------------------------------------------------------------
# The matrix
# --------------------------------------------------------------------------

def _eval_tokens(ckpt: str, max_tokens: int) -> List[int]:
    """The held-out stream: the tails of the train domains (the same
    distribution) and then the cross-domain eval text, cut at max_tokens."""
    from .prompts import load_domain
    from .runtime.tokenizer import Tokenizer

    tok = Tokenizer(ckpt)
    tails = [load_domain(d)[int(len(load_domain(d)) * TRAIN_FRACTION):]
             for d in TRAIN_DOMAINS]
    text = "\n\n".join(tails + [load_domain(d) for d in EVAL_DOMAINS])
    return tok.encode(text)[:max_tokens]


def paired_bootstrap_delta(win_a: Sequence[Tuple[float, int]],
                           win_b: Sequence[Tuple[float, int]], n_boot: int = 2000,
                           seed: int = 0) -> Dict:
    """The relative PPL delta of mode a against base b from paired
    per-window NLL sums (the same windows and tokens), with a percentile
    bootstrap 95% CI over windows."""
    assert len(win_a) == len(win_b) and len(win_a) > 1
    na = np.asarray([w[0] for w in win_a])
    nb = np.asarray([w[0] for w in win_b])
    cnt = np.asarray([w[1] for w in win_a], np.float64)
    assert all(w[1] == v[1] for w, v in zip(win_a, win_b))

    def delta(idx):
        return math.exp((na[idx].sum() - nb[idx].sum()) / cnt[idx].sum()) - 1

    point = delta(np.arange(len(na)))
    rng = np.random.default_rng(seed)
    n = len(na)
    ds = np.empty(n_boot)
    for i in range(n_boot):
        ds[i] = delta(rng.integers(0, n, n))
    lo, hi = np.percentile(ds, [2.5, 97.5])
    return {"delta": round(point, 6),
            "ci95": [round(float(lo), 6), round(float(hi), 6)],
            "windows": n}


def _build_engine(ckpt: str, mode: str, group_size: int, max_len: int, device=None):
    import torch

    from .config import ModelConfig
    from .device import resolve_device
    from .models.loader import load_params
    from .runtime.engine import Engine

    dev = resolve_device(device)
    cfg = ModelConfig.from_model_path(ckpt)
    quant = _quant_for(mode, group_size)
    dtype = torch.float32 if mode == "bf16" else torch.bfloat16
    params = load_params(cfg, quant, dtype=dtype, device=dev)
    if mode == "q4-offload":
        from .offload import store_from_params
        from .runtime.offload_engine import OffloadEngine

        dev_params, store = store_from_params(cfg, quant, params, pin=dev.type == "cuda")
        return OffloadEngine(cfg, quant, dev_params, store, max_len=max_len, device=dev)
    return Engine(cfg, quant, params, max_len=max_len, device=dev)


def evaluate_decode_perplexity(engine, token_ids: Sequence[int], segment: int = 512) -> Dict:
    """PPL through the decode path (``models/model.forced_decode``): the
    precision decisions that exist only in decode (int8 expert activations
    first) show here and not in the prefill path. The stream is cut into
    `segment`-id segments; each prefills its first id, then runs the decode
    forward teacher-forced, scoring log P(tok[i+1] | tok[..i]) for i = 1 ..
    segment - 2. The context resets every segment, the same for every mode."""
    import torch

    from .models.model import forced_decode
    from .runtime.engine import pick_cache_len

    steps = segment - 2
    total_nll, total = 0.0, 0
    window_nlls: List[Tuple[float, int]] = []
    t0 = time.time()
    with torch.inference_mode():
        for s0 in range(0, len(token_ids) - segment + 1, segment):
            seg = list(token_ids[s0:s0 + segment])
            engine.reset(pick_cache_len(segment, engine.max_len))
            engine._prefill_prompt(seg[:1])
            toks = torch.tensor([seg[1:]], dtype=torch.int64, device=engine.device)
            lps = forced_decode(engine.params, engine.cache, toks, engine.cfg, engine.quant,
                                offload=engine.offload)
            seg_nll = -float(lps[0].to(torch.float64).sum())
            total_nll += seg_nll
            total += steps
            window_nlls.append((seg_nll, steps))
    return {
        "ppl": math.exp(total_nll / total),
        "tokens_scored": total,
        "segment": segment,
        "window_nlls": window_nlls,
        "elapsed_s": time.time() - t0,
    }


def kernel_launches() -> Dict[str, int]:
    """Each CUDA kernel's launch count and each plain MoE form's call count
    now (the counters are module globals)."""
    from .ops import flash_attention, gmm_cuda, moe, moe_cuda, qmm_cuda

    counts = {"K1": qmm_cuda.launches, "K1s": qmm_cuda.launches_stacked,
              "K2": flash_attention.launches, "K3": moe_cuda.launches,
              "K4": gmm_cuda.launches, "K5": moe_cuda.launches_bf16,
              "K6": moe_cuda.launches_gq, "K6a": moe_cuda.launches_gq_a8,
              "K7": gmm_cuda.launches_two_stage, "K7a": gmm_cuda.launches_a8}
    counts.update(moe.plain_routes)
    return counts


def run_matrix(ckpt: str, modes: Sequence[str] = tuple(THRESHOLDS),
               shapes: Sequence[Tuple[int, int]] = ((512, 256), (256, 128)),
               max_tokens: int = 30_000, group_size: int = 128, spec_checks: bool = True,
               decode_path: bool = True, device=None,
               decode_max_tokens: Optional[int] = None,
               decode_segment: Optional[int] = None) -> Dict:
    """PPL for every mode at every (window, stride) shape, on the prefill
    path and on the teacher-forced decode path (in segments of the largest
    window, or `decode_segment`, over the first `decode_max_tokens` ids when
    given), and the spec exactness rows. Each
    mode's entry also carries the kernel launches and plain MoE calls it
    made (``kernel_launches``). The offloaded engine decodes on the card
    through the host engine, so every mode has its decode-path column (the
    reference skips it on a backend without host callbacks)."""
    from .perplexity import evaluate_perplexity

    ids = _eval_tokens(ckpt, max_tokens)
    max_len = max(w for w, _ in shapes)
    rows: Dict[str, Dict] = {}
    for mode in modes:
        before = kernel_launches()
        eng = _build_engine(ckpt, mode, group_size, max_len, device)
        entry: Dict = {"shapes": {}}
        for window, stride in shapes:
            t0 = time.time()
            r = evaluate_perplexity(eng, ids, window=window, stride=stride, log_every=0)
            entry["shapes"][f"{window}/{stride}"] = {
                "ppl": round(r["ppl"], 4),
                "tokens_scored": r["tokens_scored"],
                "window_nlls": r["window_nlls"],
                "elapsed_s": round(time.time() - t0, 1),
            }
            print(f"[quality] {mode:14s} w{window}/s{stride}: "
                  f"ppl={r['ppl']:.4f} ({r['tokens_scored']} tok, "
                  f"{time.time() - t0:.0f}s)", flush=True)
        if decode_path:
            dec_ids = ids if decode_max_tokens is None else ids[:decode_max_tokens]
            r = evaluate_decode_perplexity(eng, dec_ids, segment=decode_segment or max_len)
            entry["decode"] = {
                "ppl": round(r["ppl"], 4),
                "tokens_scored": r["tokens_scored"],
                "segment": r["segment"],
                "window_nlls": r["window_nlls"],
                "elapsed_s": round(r["elapsed_s"], 1),
            }
            print(f"[quality] {mode:14s} decode-path: "
                  f"ppl={r['ppl']:.4f} ({r['tokens_scored']} tok, "
                  f"{r['elapsed_s']:.0f}s)", flush=True)
        after = kernel_launches()
        entry["launches"] = {k: after[k] - before[k] for k in after}
        rows[mode] = entry
        del eng

    # deltas and verdicts: a paired-bootstrap CI for each surface; a mode
    # accepts when the CI's upper bound of its worst surface is within tolerance
    for mode, entry in rows.items():
        base_mode, tol = THRESHOLDS.get(mode, ("bf16", 0.02))
        if base_mode is None or base_mode not in rows:
            entry["verdict"] = "baseline"
            continue
        worst = None
        for shp, r in entry["shapes"].items():
            b = rows[base_mode]["shapes"][shp]
            ci = paired_bootstrap_delta(r["window_nlls"], b["window_nlls"])
            r["delta_vs_" + base_mode] = ci["delta"]
            r["ci95"] = ci["ci95"]
            if worst is None or ci["ci95"][1] > worst["ci95"][1]:
                worst = ci
        if "decode" in entry and "decode" in rows[base_mode]:
            ci = paired_bootstrap_delta(entry["decode"]["window_nlls"],
                                        rows[base_mode]["decode"]["window_nlls"])
            entry["decode"]["delta_vs_" + base_mode] = ci["delta"]
            entry["decode"]["ci95"] = ci["ci95"]
            if worst is None or ci["ci95"][1] > worst["ci95"][1]:
                worst = ci
        entry["base"] = base_mode
        entry["tolerance"] = tol
        entry["worst_delta"] = worst["delta"]
        entry["worst_ci95"] = worst["ci95"]
        entry["verdict"] = "accept" if worst["ci95"][1] <= tol else "REJECT"

    # the noise floor: the baseline's even windows against its odd ones
    base0 = next(iter(rows))
    shp0 = next(iter(rows[base0]["shapes"]))
    wn = rows[base0]["shapes"][shp0]["window_nlls"]
    ev, od = wn[0::2], wn[1::2]
    m = min(len(ev), len(od))
    if m > 1:
        na = sum(w[0] for w in ev[:m]) / sum(w[1] for w in ev[:m])
        nb = sum(w[0] for w in od[:m]) / sum(w[1] for w in od[:m])
        noise_floor = abs(math.exp(na) / math.exp(nb) - 1.0)
    else:
        noise_floor = float("nan")

    out: Dict = {"checkpoint": ckpt, "eval_tokens": len(ids), "group_size": group_size,
                 "unpaired_noise_floor": round(noise_floor, 6), "modes": rows}
    meta_path = os.path.join(ckpt, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            out["checkpoint_meta"] = json.load(f)
    if spec_checks:
        out["spec"] = run_spec_exactness(ckpt, group_size, device=device)
    return out


SPEC_PROMPTS = ("Explain the os module in Python.",
                "Summarize the indemnification clause.",
                "List the catalog items and their part numbers.")


def run_spec_exactness(ckpt: str, group_size: int = 128, n_tokens: int = 48,
                       device=None) -> Dict:
    """Greedy tokens with speculative decoding on must equal the vanilla
    greedy tokens: prompt lookup (ngram) always, and MTP where the
    checkpoint has the module (``train_mtp_head``). The spec mode is read
    from ``KRASIS_TPU_SPEC_MODE`` when an engine is built."""
    from .ops.sampling import SamplingParams
    from .runtime.tokenizer import Tokenizer

    tok = Tokenizer(ckpt)
    prompts = [tok.apply_chat_template([{"role": "user", "content": p}])
               for p in SPEC_PROMPTS]
    greedy = SamplingParams(temperature=0.0)

    def run(eng):
        match, committed = True, 0
        for p, want in zip(prompts, vanilla):
            r = eng.generate(p, max_new_tokens=n_tokens, sampling=greedy, stop_ids={-1})
            committed += len(r.tokens)
            match &= r.tokens == want
        return match, committed

    eng = _build_engine(ckpt, "q4", group_size, 512, device)
    old = os.environ.get("KRASIS_TPU_SPEC_MODE")
    results = {}
    try:
        eng.spec_available = False
        vanilla = [eng.generate(p, max_new_tokens=n_tokens, sampling=greedy,
                                stop_ids={-1}).tokens for p in prompts]
        os.environ["KRASIS_TPU_SPEC_MODE"] = "ngram"
        eng2 = _build_engine(ckpt, "q4", group_size, 512, device)
        assert eng2.spec_mode == "ngram", eng2.spec_mode
        match, committed = run(eng2)
        results["ngram"] = {"exact": match, "tokens": committed,
                            "verdict": "accept" if match else "REJECT"}
        os.environ["KRASIS_TPU_SPEC_MODE"] = "mtp"
        eng3 = _build_engine(ckpt, "q4", group_size, 512, device)
        if eng3.spec_mode == "mtp":
            match, committed = run(eng3)
            results["mtp"] = {"exact": match, "tokens": committed, "checkpoint": "trained",
                              "verdict": "accept" if match else "REJECT"}
    finally:
        if old is None:
            os.environ.pop("KRASIS_TPU_SPEC_MODE", None)
        else:
            os.environ["KRASIS_TPU_SPEC_MODE"] = old
    return results


def write_markdown(results: Sequence[Dict], path: str) -> None:
    """Render one or more per-seed matrices; the cross-seed verdict accepts
    when every seed's CI-gated verdict does."""
    res = results[0]
    lines = ["# Quantization quality matrix (PPL deltas, 95% CIs)", ""]
    meta = res.get("checkpoint_meta", {})
    seeds = [r.get("checkpoint_meta", {}).get("seed", "?") for r in results]
    lines += [
        f"Checkpoints: trained tiny Qwen3-MoE ({meta.get('key', '?')}), "
        f"seeds {seeds}, "
        f"{meta.get('steps', '?')} steps; torch tail-holdout PPL "
        f"{meta.get('tail_ppl_torch', float('nan')):.2f} "
        f"(cross-domain {meta.get('holdout_ppl_torch', float('nan')):.2f}).",
        f"Eval: {res['eval_tokens']} HELD-OUT tokens — the unseen tails "
        f"({1 - TRAIN_FRACTION:.0%}) of the train domains followed by "
        f"cross-domain text ({', '.join(EVAL_DOMAINS)}); "
        f"group_size={res['group_size']}.",
        "",
        "Deltas carry PAIRED-bootstrap 95% CIs over windows (same "
        "windows, same tokens for mode and base — pairing cancels "
        "text-difficulty variance); a mode accepts only if the CI "
        "UPPER bound of its worst surface is within tolerance, on "
        "EVERY seed. Unpaired split-half noise floor of this eval: "
        f"{res.get('unpaired_noise_floor', float('nan')):.4%} — the "
        "paired CIs below are what make sub-floor deltas decidable.",
        "",
        "Every row runs the PRODUCTION loader/engine/kernels "
        "(reference discipline: perplexity/results/*.json; "
        "ADVANCED.md:30-47).", "",
    ]
    shapes = list(next(iter(res["modes"].values()))["shapes"])
    have_decode = any("decode" in e for e in res["modes"].values())
    cols = [f"PPL {s}" for s in shapes]
    if have_decode:
        cols.append("PPL decode-path")
    hdr = ("| mode | " + " | ".join(cols)
           + " | vs | worst Δ [95% CI] | tol | verdict |")
    lines += [hdr, "|" + "---|" * (len(cols) + 5)]
    for mode, e in res["modes"].items():
        cells = [f"{e['shapes'][s]['ppl']:.4f}" for s in shapes]
        if have_decode:
            cells.append(f"{e['decode']['ppl']:.4f}" if "decode" in e
                         else "(parity-tested)")
        if e.get("verdict") == "baseline":
            lines.append(f"| {mode} | " + " | ".join(cells)
                         + " | — | — | — | baseline |")
        else:
            verdicts = [r["modes"][mode].get("verdict") for r in results
                        if mode in r["modes"]]
            v = "accept" if all(x == "accept" for x in verdicts) else "REJECT"
            lo, hi = e["worst_ci95"]
            lines.append(
                f"| {mode} | " + " | ".join(cells)
                + f" | {e['base']} | {e['worst_delta']:+.3%} "
                f"[{lo:+.3%}, {hi:+.3%}] "
                f"| {e['tolerance']:.1%} | **{v}** |")
    if len(results) > 1:
        lines += ["", "## Per-seed worst Δ (CI upper bound)", ""]
        mode_names = [m for m, e in res["modes"].items()
                      if e.get("verdict") != "baseline"]
        lines += ["| mode | " + " | ".join(f"seed {s}" for s in seeds)
                  + " |", "|" + "---|" * (len(seeds) + 1)]
        for m in mode_names:
            cells = []
            for r in results:
                e = r["modes"].get(m, {})
                if "worst_ci95" in e:
                    cells.append(f"{e['worst_ci95'][1]:+.3%}"
                                 + (" ✗" if e.get("verdict") == "REJECT" else ""))
                else:
                    cells.append("—")
            lines.append(f"| {m} | " + " | ".join(cells) + " |")
    if have_decode:
        lines += [
            "",
            "`PPL decode-path` runs the teacher-forced SERVING DECODE "
            "graph (models/model.make_forced_decode_fn) — the only way "
            "to measure decode-only precision choices (W4A8 expert "
            "activations); context resets every segment, so compare "
            "deltas, not absolute values, against the prefill columns. "
            "The offload row's decode path is bit-pinned against the "
            "resident engine in tests/test_offload.py instead "
            "(host-callback-free backends can't run the forced fn).",
        ]
    if "spec" in res:
        lines += ["", "## Speculative decoding exactness", ""]
        for name, r in res["spec"].items():
            extra = (" (trained ckpt, V3-layout MTP module — "
                     "quality.train_mtp_head)"
                     if r.get("checkpoint") == "trained" else "")
            lines.append(f"- `{name}`: greedy tokens identical with spec "
                         f"on/off over {r['tokens']} tokens → "
                         f"**{r['verdict']}**{extra}")
        if "mtp" not in res["spec"]:
            lines.append("- `mtp`: exactness proven on synthetic weights "
                         "(tests/test_mtp.py greedy-equality suite)")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def spec_only(args, out_dir: str) -> None:
    """``--spec-only``: the spec-exactness rows on the first seed's
    checkpoint (built if absent, the MTP head trained if absent), spliced
    into that seed's newest saved matrix; QUALITY.md rewritten from each
    seed's newest matrix."""
    import glob

    ckpt = build_quality_checkpoint(steps=args.steps, seed=args.seeds[0], device=args.device)
    train_mtp_head(ckpt, steps=args.mtp_steps, device=args.device)
    spec = run_spec_exactness(ckpt, group_size=args.group_size, device=args.device)
    print(json.dumps(spec, indent=2))
    results = []
    for seed in args.seeds:
        found = sorted(glob.glob(os.path.join(out_dir, f"matrix_s{seed}_*.json")))
        if not found:
            continue
        with open(found[-1]) as f:
            res = json.load(f)
        if seed == args.seeds[0]:
            res["spec"] = spec
            with open(found[-1], "w") as f:
                json.dump(res, f, indent=2)
        results.append(res)
    if results:
        write_markdown(results, os.path.join(out_dir, "QUALITY.md"))
        print("wrote", os.path.join(out_dir, "QUALITY.md"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m krasis_tpu_torch.quality",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--max-tokens", type=int, default=120_000)
    ap.add_argument("--modes", nargs="*", default=list(THRESHOLDS))
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--mtp-steps", type=int, default=400)
    ap.add_argument("--no-spec", action="store_true")
    ap.add_argument("--force-train", action="store_true")
    ap.add_argument("--train-only", action="store_true",
                    help="build the checkpoints and exit")
    ap.add_argument("--spec-only", action="store_true",
                    help="re-run only the spec-exactness rows on the first seed's "
                         "checkpoint (training the MTP head if absent), splice them into "
                         "the newest saved matrix JSONs and rewrite QUALITY.md")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="the card (default) or, when asked, the CPU")
    ap.add_argument("--out", default=None,
                    help="results directory (default $KRASIS_TPU_HOME/quality_torch/results)")
    args = ap.parse_args(argv)

    out_dir = args.out or os.path.join(_home(), "quality_torch", "results")
    os.makedirs(out_dir, exist_ok=True)
    if args.spec_only:
        spec_only(args, out_dir)
        return
    results = []
    for seed in args.seeds:
        ckpt = build_quality_checkpoint(steps=args.steps, seed=seed, force=args.force_train,
                                        device=args.device)
        if seed == args.seeds[0] and not args.no_spec:
            train_mtp_head(ckpt, steps=args.mtp_steps, device=args.device)
        if args.train_only:
            continue
        res = run_matrix(ckpt, modes=args.modes, max_tokens=args.max_tokens,
                         group_size=args.group_size,
                         spec_checks=not args.no_spec and seed == args.seeds[0],
                         device=args.device)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        jpath = os.path.join(out_dir, f"matrix_s{seed}_{stamp}.json")
        with open(jpath, "w") as f:
            json.dump(res, f, indent=2)
        results.append(res)
        print(json.dumps({m: e.get("verdict") for m, e in res["modes"].items()}, indent=2))
        print(f"seed {seed} results:", jpath, flush=True)
    if results:
        write_markdown(results, os.path.join(out_dir, "QUALITY.md"))
        print("wrote", os.path.join(out_dir, "QUALITY.md"))


if __name__ == "__main__":
    main()
