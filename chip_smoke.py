#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (krasis_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card and toolchain: the card's name and power limit, torch and CUDA
   versions; TF32 off;
2. build: the CUDA sources of krasis_tpu_torch/csrc with nvcc, in parallel;
3. reference: a tiny DeepSeek-V2-Lite (int4 experts, and int8 experts in
   the two-stage class) and a tiny Qwen3-Coder-Next hybrid run on the card
   through the kernels against the same models on the CPU through their
   plain versions;
4. DeepSeek-V2-Lite Q4 at full width (MLA, 27 layers, random weights from a
   seed): each of its kernels (K1 qmm, K2 attention with V inside K: a
   prefill, a chunk, and split-KV decode at kv_len 2560, 2500 and 40 over
   the engine's 4096-row cache view; K3 W4A8 decode MoE, K4 grouped GEMM on
   the main path's tile plan) against its plain PyTorch version at
   main-path shapes on the model's own weights, with kernel, plain,
   library-call (SDPA for K2, grouped_mm on pre-dequantized stacks for the
   grouped GEMM's products) and bound times; then three greedy requests
   through Engine.generate and a profile of one prefill and one decode;
5. Qwen3-Coder-Next at full width (48 layers: 36 Gated DeltaNet + 12 GQA,
   512 experts top-10 + 1 shared, int8 projections): the same for the
   kernels this path adds or reshapes (K1s stacked qmm, K2 with a separate
   V, K5 bf16 decode MoE, and K1, K3, K4 at this model's shapes); three
   requests with int8 expert activations, one with bf16, and the profile;
6. DeepSeek-V2-Lite Q8 at full width and depth (int8 experts of 8.65 MB a
   pick: the two-stage expert class): K6 / K6a gathered products on w13 and
   w2 with 8 picks of 66, once under a pick_valid mask; K7 two-stage grouped
   GEMM at both call shapes, and K7 + SwiGLU + K7 equal bit for bit to K4's
   fused result on the same plan; K7a int8 grouped GEMM stage by stage and
   through moe_prefill(activation="int8"); the fused kernels timed at the
   same shapes for the class boundary; then requests with int8 and bf16
   activations, one with top_logprobs=5, the perplexity entry point over
   4096 token ids (window 2048, stride 1024), the int8 prefill A/B entry,
   and the profile. Its routed experts must not launch K3, K4 or K5.

In every family every logit must be finite and every kernel of the path
must have been launched by the requests. The last two lines are the card's
name and power limit and the JSON result; the line before them lists the
kernels.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
PEAK_BF16 = 989e12             # dense tensor-core rates, H100 SXM data sheet
PEAK_INT8 = 1979e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters: int, flush=None) -> float:
    """Median of per-launch CUDA-event times; `flush` (a large buffer) is
    rewritten before each launch so the launch finds the L2 cache cold."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def max_err(got, want, tol: float):
    """Elementwise |got - want| <= tol * (|want| + rms(want)): relative to
    each element, with a floor set by the tensor's typical size (not its
    largest value). Returns max|Δ| and the worst |Δ| over its limit, which
    must be at most 1."""
    import torch

    got, want = got.to(torch.float32), want.to(torch.float32)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("kernel output is not finite")
    diff = (got - want).abs()
    rms = float(want.square().mean().sqrt())
    limit = tol * (want.abs() + rms)
    return float(diff.max()), float((diff / limit).max())


def device_per_call(fn, name_part: str, flush, calls: int = 20, tries: int = 4):
    """Device time of one call, from torch.profiler: the summed device time
    of the kernels whose names contain `name_part` over their launches in
    `calls` calls (the L2 flushed before each, as for the event times);
    and the number of device kernels one call launches, from a second
    profile of `calls` calls with nothing between them. Each profile
    records its second step (the first warms the tracer up) and is taken
    again, up to `tries` times, until it holds a whole number of
    `name_part` launches and of all launches a call: the tracer on the
    card at times leaves kernels out. Returns (us, kernels per call); raises if no profile
    was whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.autograd.DeviceType.CUDA

    def rows(between):
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                         schedule=schedule(wait=0, warmup=1, active=1)) as prof:
                for _ in range(2):
                    for _ in range(calls):
                        between()
                        fn()
                    torch.cuda.synchronize()
                    prof.step()
            got = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == cuda and not e.key.startswith("ProfilerStep")]
            named = sum(n for key, _, n in got if name_part in key)
            if named > 0 and named % calls == 0 and sum(n for _, _, n in got) % calls == 0:
                return got
        raise AssertionError(f"the profiler never saw whole calls of {name_part}")

    fn()
    torch.cuda.synchronize()
    timed = [(us, n) for key, us, n in rows(flush.zero_) if name_part in key]
    counted = rows(lambda: None)
    per_launch = sum(us for us, _ in timed) / sum(n for _, n in timed)
    named_per_call = sum(n for key, _, n in counted if name_part in key) / calls
    return per_launch * named_per_call, sum(n for _, _, n in counted) / calls


def check_kernel(results, name, counter, replaces, run_kernel, run_plain, run_library,
                 tol, nbytes, ops, peak, iters, flush, select=None, device_name=None):
    """Hold one kernel to its plain version and time both. `counter` is the
    (module, attribute) of the wrapper's launch count, filled in later from
    the main path's run. With `device_name`, the kernel's device time per
    call and the kernels a call launches are taken from the profiler too."""
    module = counter[0]
    got, want = run_kernel(), run_plain()
    if select is not None:
        got, want = select(got), select(want)
    err, ratio = max_err(got, want, tol)
    ms = time_ms(run_kernel, iters, flush)
    plain_ms = time_ms(run_plain, max(2, iters // 10), flush)
    lib_ms = time_ms(run_library, iters, flush) if run_library else None
    b_ms, b_by = bound(nbytes, ops, peak)
    res = {"name": name, "route": "cuda", "source": module.SOURCE, "replaces": replaces,
           "launches": None, "max_abs_err": err, "max_abs_diff": err, "tol": tol,
           "err_over_limit": ratio,
           "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by}
    device = ""
    if device_name is not None:
        us, per_call = device_per_call(run_kernel, device_name, flush)
        res.update(device_us=us, kernels_per_call=per_call)
        device = f" device {us:.2f} us a call (profiler), {per_call:g} kernels a call"
    print(f"[kernel] {name}: max|Δ| {err:.3g}, {ratio:.3g} of the limit (tol {tol}) kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} ms library {lib_ms} ms bound {b_ms:.4f} ms ({b_by}){device}",
          flush=True)
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    results.append((counter, res))


def reference_phase(label, cfg, quant, tol):
    """A tiny model: kernels on the card against plain versions on the CPU.
    A model-level check, as the CPU tests hold the port to the JAX package:
    bf16 rounding differences compound over the layers, so the limit is
    `tol` of the larger of 1 and the largest logit."""
    import torch
    from krasis_tpu_torch.models.model import forward
    from krasis_tpu_torch.models.params import init_synthetic_params
    from krasis_tpu_torch.runtime.kv_cache import init_cache

    cpu = init_synthetic_params(cfg, quant, seed=1, device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev) if hasattr(tree, "to") else tree

    gpu = to(cpu, "cuda")
    prompt = torch.randint(1, cfg.vocab_size, (1, 160), generator=torch.Generator().manual_seed(3))
    worst, worst_rel = 0.0, 0.0
    for params, dev in ((cpu, "cpu"), (gpu, "cuda")):
        cache = init_cache(cfg, quant, 1, 512, dev)
        logits = [forward(params, prompt.to(dev), torch.tensor([160], dtype=torch.int32, device=dev),
                          cache, cfg, quant, prefill=True)]
        for tok in (7, 11, 13):
            logits.append(forward(params, torch.tensor([[tok]], device=dev),
                                  torch.ones(1, dtype=torch.int32, device=dev),
                                  cache, cfg, quant, prefill=False))
        if dev == "cpu":
            ref = [x.clone() for x in logits]
        else:
            for step, (g, r) in enumerate(zip(logits, ref)):
                g, r = g.cpu().to(torch.float32), r.to(torch.float32)
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"{label} step {step}: non-finite logits")
                err = float((g - r).abs().max())
                limit = tol * max(1.0, float(r.abs().max()))
                worst = max(worst, err)
                worst_rel = max(worst_rel, err / float(r.square().mean().sqrt()))
                if not err <= limit:
                    raise AssertionError(f"{label} step {step}: card vs CPU {err} > {limit}")
    print(f"[reference] {label} on the card vs the CPU plain path: max|Δ| logits {worst:.3g} "
          f"({worst_rel:.3g} of their rms, limit {tol})", flush=True)


def reference_phases():
    from krasis_tpu_torch.config import QuantConfig
    from krasis_tpu_torch.models.synthetic import tiny_config

    # every token picks all 8 routed experts: with random tiny routers a
    # top-k choice can sit on a near-tie that the two devices' summation
    # orders break differently; picking all experts keeps the comparison
    # about the arithmetic
    reference_phase(
        "tiny V2-Lite",
        tiny_config("deepseek-v2-lite", moe_intermediate_size=128, num_hidden_layers=4,
                    num_experts_per_tok=8),
        QuantConfig(expert_bits=4, group_size=128, kv_cache_dtype="bf16"), 2e-2)
    # int8 experts in the two-stage class: the limits that sort full-size
    # experts are shrunk for the tiny ones, so prefill and decode (grouped
    # too, with every expert picked) go through K7
    from krasis_tpu_torch.ops import expert_class
    limits = expert_class.MAX_FUSED_PICK_BYTES, expert_class.MAX_FUSED_BLOCK_BYTES
    expert_class.MAX_FUSED_PICK_BYTES = expert_class.MAX_FUSED_BLOCK_BYTES = 1024
    try:
        reference_phase(
            "tiny V2-Lite, int8 experts, two-stage class",
            tiny_config("deepseek-v2-lite", moe_intermediate_size=128, num_hidden_layers=4,
                        num_experts_per_tok=8),
            QuantConfig(expert_bits=8, group_size=128, kv_cache_dtype="bf16"), 2e-2)
    finally:
        expert_class.MAX_FUSED_PICK_BYTES, expert_class.MAX_FUSED_BLOCK_BYTES = limits
    # the hybrid's limit is the one tests/test_torch_hybrid.py states. With
    # every expert picked, decode too takes the grouped kernel (T·k ≥ 0.75·E):
    # the gathered decode kernels are held at full shapes in the kernel phases
    reference_phase(
        "tiny Qwen3-Coder-Next hybrid",
        tiny_config("qwen3-coder-next", num_experts_per_tok=8),
        QuantConfig(expert_bits=4, group_size=128, kv_cache_dtype="bf16", attention="int8"),
        5e-2)


def counters():
    """The launch count of each kernel: (module, attribute)."""
    from krasis_tpu_torch.ops import flash_attention, gmm_cuda, moe_cuda, qmm_cuda
    return {"K1": (qmm_cuda, "launches"), "K1s": (qmm_cuda, "launches_stacked"),
            "K2": (flash_attention, "launches"), "K3": (moe_cuda, "launches"),
            "K4": (gmm_cuda, "launches"), "K5": (moe_cuda, "launches_bf16"),
            "K6": (moe_cuda, "launches_gq"), "K6a": (moe_cuda, "launches_gq_a8"),
            "K7": (gmm_cuda, "launches_two_stage"), "K7a": (gmm_cuda, "launches_a8")}


def qmm_checks(results, prefix, cases, g, flush):
    """K1 / K1s. cases: (name, weight, layer or None, out dtype[, rows T]),
    T = 1 unless given."""
    import torch
    from krasis_tpu_torch.ops import qmm_cuda
    from krasis_tpu_torch.quant import dequantize, qtensor_bytes

    C = counters()
    for name, qt, layer, out_dtype, *rest in cases:
        T = rest[0] if rest else 1
        K, N = qt.k_dim, qt.n_dim
        x = torch.randn((T, K), generator=g, device=qt.q.device).to(torch.bfloat16)
        one = qt if layer is None else qt[layer]
        w = dequantize(one, torch.bfloat16)
        nbytes = (qtensor_bytes(one) + x.numel() * 2
                  + T * N * (4 if out_dtype == torch.float32 else 2))
        if layer is None:
            run, counter, replaces = (lambda: qmm_cuda.qmm(x, qt, out_dtype)), C["K1"], qmm_cuda.REPLACES
        else:
            run = lambda: qmm_cuda.qmm_stacked(x, qt, layer, out_dtype)
            counter, replaces = C["K1s"], qmm_cuda.REPLACES_STACKED
        check_kernel(results, prefix + name, counter, replaces, run,
                     lambda: qmm_cuda.qmm_plain(x, one, out_dtype),
                     lambda: torch.matmul(x, w),
                     2e-2, nbytes, 2 * T * K * N, PEAK_BF16, 50, flush, device_name="qmm")
        del w
        if results[-1][1]["kernels_per_call"] != 1:
            raise AssertionError(f"{prefix}{name}: a call launched "
                                 f"{results[-1][1]['kernels_per_call']} device kernels, not 1")


def qmm_split_checks(name, qt, layer, g):
    """At a split shape: two calls on the same inputs are equal bit for bit
    (the split sums meet in a fixed order), and the element-wise check
    refuses a plain version that leaves out one K split."""
    import torch
    from krasis_tpu_torch.ops import qmm_cuda
    from krasis_tpu_torch.quant import dequantize

    one = qt[layer]
    K, N = one.k_dim, one.n_dim
    p = qmm_cuda.plan(1, K, N, one.bits, one.group_size)
    if p.ks < 2:
        raise AssertionError(f"{name}: not a split shape ({p})")
    x = torch.randn((1, K), generator=g, device=qt.q.device).to(torch.bfloat16)
    a, b = qmm_cuda.qmm_stacked(x, qt, layer), qmm_cuda.qmm_stacked(x, qt, layer)
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two calls differ by {float((a - b).abs().max())}")
    w = dequantize(one, torch.bfloat16).to(torch.float32)
    r0, r1 = p.split_rows(K // 2 if one.bits == 4 else K)[p.ks // 2]
    w[r0:r1] = 0.0
    if one.bits == 4:
        w[K // 2 + r0:K // 2 + r1] = 0.0
    dropped = (x.to(torch.float32) @ w).to(torch.bfloat16)
    _, fault = max_err(dropped, qmm_cuda.qmm_plain(x, one), 2e-2)
    print(f"[kernel] {name}: {p.ks} splits in one cluster; two calls equal bit for bit; a plain "
          f"version without split {p.ks // 2} (rows {r0}-{r1}) reads {fault:.3g} of the limit",
          flush=True)
    if not fault > 1.0:
        raise AssertionError(f"{name}: the check cannot see a dropped split")


def attention_checks(results, prefix, Hq, Hkv, lanes, Dp, v_dim, separate_v, scale, q_std,
                     g, flush):
    """K2 at the main path's shapes: a 2048-row prefill, a 452-row chunk
    over 2048 rows of history (one launch each), and decode at kv_len 2560,
    2500 and 40 over the engine's 4096-row cache view (split-KV: two
    launches). `lanes` of the Dp-wide rows are real, the rest zero pad, and
    the scores run over the real lanes as on the main path. Keys and values are
    unit-scale rows, as normed keys are, and queries have std `q_std`,
    chosen so that the scores' std is about 3: the softmax is then peaked
    and the outputs O(1), so a masking fault moves them well past the
    limit. With flat scores the outputs are sums that nearly cancel, and
    the bf16 rounding of p alone (taken against the running maximum in the
    kernel, the final one in the plain version) reaches the limit."""
    import torch
    import torch.nn.functional as F
    from krasis_tpu_torch.ops import flash_attention as fa

    dev = flush.device
    G = Hq // Hkv

    def rows(shape, std=1.0):
        t = torch.zeros(shape[:-1] + (Dp,), dtype=torch.bfloat16, device=dev)
        t[..., :lanes] = (std * torch.randn(shape[:-1] + (lanes,), generator=g, device=dev)
                          ).to(torch.bfloat16)
        return t

    k_cache = rows((1, Hkv, 4096, lanes))
    v_cache = rows((1, Hkv, 4096, lanes)) if separate_v else None
    for name, sq, q_off, kv_len, view, replaces in (
            ("attention:prefill_2048", 2048, 0, 2048, 2048, fa.REPLACES),
            ("attention:chunk_452_at_2048", 452, 2048, 2500, 2500, fa.REPLACES),
            ("attention:decode_kv_2560", 1, 2559, 2560, 4096, fa.REPLACES_DECODE),
            ("attention:decode_kv_2500", 1, 2499, 2500, 4096, fa.REPLACES_DECODE),
            ("attention:decode_kv_40", 1, 39, 40, 4096, fa.REPLACES_DECODE)):
        q = rows((1, sq, Hq, lanes), q_std)
        kv = k_cache[:, :, :view]
        v = v_cache[:, :, :view] if separate_v else None
        qo = torch.tensor([q_off], dtype=torch.int32, device=dev)
        kl = torch.tensor([kv_len], dtype=torch.int32, device=dev)

        def per_q_head(t):                                   # [1, Hkv, S, D] → [1, Hq, S, D]
            return t[:, :, None].expand(1, Hkv, G, kv_len, t.shape[-1]).reshape(
                1, Hq, kv_len, t.shape[-1])

        qh, kh = q.transpose(1, 2), per_q_head(kv[:, :, :kv_len])
        vh = per_q_head((kv if v is None else v)[:, :, :kv_len])[..., :v_dim]
        pos = q_off + torch.arange(sq, device=dev)
        mask = torch.arange(kv_len, device=dev)[None, :] <= pos[:, None]
        visible = int(mask.sum())
        # the function needs the real lanes; the zero pad to Dp is not work
        nbytes = (sq * Hq + kv_len * Hkv) * lanes * 2 + sq * Hq * v_dim * 2
        if separate_v:
            nbytes += kv_len * Hkv * v_dim * 2
        ops = 2 * Hq * visible * (lanes + v_dim)
        check_kernel(results, prefix + name, counters()["K2"], replaces,
                     lambda: fa.flash_attention(q, kv, qo, kl, scale, v_dim, v=v, qk_dim=lanes),
                     lambda: fa.flash_attention_plain(q, kv, qo, kl, scale, v_dim, v, lanes),
                     lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                            scale=scale),
                     2e-2, nbytes, ops, PEAK_BF16, 20 if sq > 1 else 50, flush)
        if kv_len == 2560:
            # the same check must refuse a combine that lost the split holding
            # each row's largest score
            chunk, n = fa.split_plan(view, Hkv, 1, torch.cuda.get_device_properties(dev)
                                     .multi_processor_count)
            o, m, l = fa.decode_split_plain(q, kv, qo, kl, scale, v_dim, chunk, v, lanes)
            dropped = m.clone().scatter_(2, m.argmax(dim=2, keepdim=True), fa.NEG_INF)
            _, fault = max_err(fa._unstack(fa.decode_combine_plain(o, dropped, l), 1),
                               fa.flash_attention_plain(q, kv, qo, kl, scale, v_dim, v, lanes),
                               2e-2)
            live = -(-kv_len // chunk)
            print(f"[kernel] {prefix}{name}: {n} splits of {chunk} rows ({live} before kv_len); "
                  f"a combine without one split reads {fault:.3g} of the limit; combine bound "
                  f"{live * Hq * v_dim * 4 / HBM_BYTES_S * 1e3:.5f} ms (bytes)", flush=True)
            if not fault > 1.0:
                raise AssertionError(f"{prefix}{name}: the check cannot see a dropped split")
        if sq > 1:
            # the same check must refuse a kernel that dropped the causal mask
            _, fault = max_err(fa.flash_attention_plain(q, kv, kl - 1, kl, scale, v_dim, v=v),
                               fa.flash_attention_plain(q, kv, qo, kl, scale, v_dim, v=v), 2e-2)
            print(f"[kernel] {prefix}{name}: without the causal mask the check reads "
                  f"{fault:.3g} of the limit", flush=True)
            if not fault > 1.0:
                raise AssertionError(f"{prefix}{name}: the check cannot see a dropped causal mask")


def grouped_mm_library(label, rows, w, plan, out_dtype, want):
    """The yardstick of a grouped GEMM launch: one PyTorch grouped_mm over
    the plan's real rows sorted by expert (offs = cumulative counts, int32)
    on the stack dequantized to bf16 [E, K, N] beforehand, or None when this
    PyTorch has no such call or refuses the shape (the error is printed).
    `want` is the plain version's result on the same rows, for a look at
    whether the call computes the same function."""
    import torch
    import torch.nn.functional as F
    from krasis_tpu_torch.quant import dequantize

    fn = getattr(F, "grouped_mm", None)
    if fn is None:
        print(f"[library] {label}: this PyTorch has no grouped_mm", flush=True)
        return None
    E = w.q.shape[0]
    experts = plan.tile_e.repeat_interleave(plan.tm)[plan.row_src >= 0].long()
    offs = torch.cumsum(torch.bincount(experts, minlength=E), 0).to(torch.int32)
    stack = torch.stack([dequantize(w[e], torch.bfloat16) for e in range(E)])
    a = rows.to(torch.bfloat16).contiguous()

    def run():
        return fn(a, stack, offs=offs, out_dtype=out_dtype)

    try:
        got = run()
        torch.cuda.synchronize()
    except Exception as err:                     # noqa: BLE001 — the refusal is the finding
        print(f"[library] {label}: grouped_mm refused: {type(err).__name__}: "
              f"{str(err).splitlines()[0][:300]}", flush=True)
        return None
    diff, ratio = max_err(got, want, 3e-2)
    print(f"[library] {label}: torch.nn.functional.grouped_mm over "
          f"{a.shape[0]} sorted rows, out {out_dtype}: max|Δ| {diff:.3g} from the plain "
          f"version, {ratio:.3g} of the 3e-2 limit", flush=True)
    return run


def moe_checks(results, prefix, w13, w2, cfg, g, flush, bf16_too):
    """K3 (and K5) at T = 1 with the routed picks plus the folded shared
    experts; K4 at T = 2048 over the whole stack."""
    import torch
    from krasis_tpu_torch.ops import gmm_cuda, moe_cuda
    from krasis_tpu_torch.quant import qtensor_bytes

    dev = flush.device
    C = counters()
    E_r, E_all, k = cfg.n_routed_experts, w13.q.shape[0], cfg.num_experts_per_tok
    Hd, I = cfg.hidden_size, cfg.moe_intermediate_size
    x = torch.randn((1, Hd), generator=g, device=dev).to(torch.bfloat16)
    routed = torch.randperm(E_r, generator=g, device=dev)[:k]
    idx = torch.cat([routed, torch.arange(E_r, E_all, device=dev)])[None].to(torch.int32)
    wts = torch.cat([torch.rand((k,), generator=g, device=dev) * 0.3,
                     torch.ones(E_all - E_r, device=dev)])[None]
    P = idx.shape[1]
    per_pick = (qtensor_bytes(w13) + qtensor_bytes(w2)) // E_all
    decode_ops = 2 * P * (Hd * 2 * I + I * Hd)
    check_kernel(results, prefix + "moe_decode", C["K3"], moe_cuda.REPLACES,
                 lambda: moe_cuda.moe_w4a8(x, w13, w2, idx, wts),
                 lambda: moe_cuda.moe_w4a8_plain(x, w13, w2, idx, wts),
                 None, 3e-2, P * per_pick + Hd * 4, decode_ops, PEAK_INT8, 50, flush)
    if bf16_too:
        check_kernel(results, prefix + "moe_decode_bf16", C["K5"], moe_cuda.REPLACES_BF16,
                     lambda: moe_cuda.moe_bf16(x, w13, w2, idx, wts),
                     lambda: moe_cuda.moe_bf16_plain(x, w13, w2, idx, wts),
                     None, 3e-2, P * per_pick + Hd * 4, decode_ops, PEAK_BF16, 50, flush)

    T = 2048
    x = torch.randn((T, Hd), generator=g, device=dev).to(torch.bfloat16)
    topk = torch.rand((T, E_r), generator=g, device=dev).topk(k, dim=-1).indices.to(torch.int32)
    M = T * k
    plan = gmm_cuda.plan_tiles(topk, E_all, gmm_cuda.choose_tm(M, E_all))   # the main path's
    real = plan.row_src >= 0
    hit = int((torch.bincount(topk.reshape(-1).long(), minlength=E_all) > 0).sum())
    print(f"[kernel] {prefix}gmm: {plan.tm}-row tiles, {int(plan.tile_valid.sum())} of "
          f"{plan.n_tiles} computed", flush=True)
    a_plain = gmm_cuda.gmm_plain(x, plan.row_src, w13, plan, True)
    h_plain = gmm_cuda.gmm_plain(x, plan.row_src, w13, plan, False)[real]
    lib13 = grouped_mm_library(prefix + "gmm:w13 (product alone, no SwiGLU)",
                               x[plan.row_src[real].long()], w13, plan, torch.bfloat16, h_plain)
    del h_plain
    check_kernel(results, prefix + "gmm:w13_swiglu", C["K4"], gmm_cuda.REPLACES,
                 lambda: gmm_cuda.gmm(x, plan.row_src, w13, plan, True),
                 lambda: gmm_cuda.gmm_plain(x, plan.row_src, w13, plan, True),
                 lib13, 3e-2, hit * qtensor_bytes(w13) / E_all + T * Hd * 2 + M * I * 2,
                 2 * M * Hd * 2 * I, PEAK_BF16, 10, None, select=lambda o: o[real])
    o_plain = gmm_cuda.gmm_plain(a_plain, None, w2, plan, False)
    lib2 = grouped_mm_library(prefix + "gmm:w2", a_plain[real], w2, plan, torch.float32,
                              o_plain[real])
    check_kernel(results, prefix + "gmm:w2_f32", C["K4"], gmm_cuda.REPLACES_W2,
                 lambda: gmm_cuda.gmm(a_plain, None, w2, plan, False),
                 lambda: gmm_cuda.gmm_plain(a_plain, None, w2, plan, False),
                 lib2, 3e-2, hit * qtensor_bytes(w2) / E_all + M * I * 2 + M * Hd * 4,
                 2 * M * I * Hd, PEAK_BF16, 10, None, select=lambda o: o[real])


def v2lite_kernel_phase(params, cfg, results, g, flush):
    import torch
    from krasis_tpu_torch.ops.rope import yarn_softmax_scale

    # K1 — qmm at T = 1: the int8 lm_head and the decode dense MLP
    layer0 = params["layers"][0]
    qmm_checks(results, "", (("qmm:lm_head", params["lm_head"], None, torch.float32),
                             ("qmm:mlp_w13", layer0["mlp_w13"], None, torch.bfloat16),
                             ("qmm:mlp_w2", layer0["mlp_w2"], None, torch.bfloat16)), g, flush)
    # K2 — attention over the MLA cache: 16 heads on one [ckv; kpe] row
    L, DR = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    scale = yarn_softmax_scale((cfg.qk_nope_head_dim + DR) ** -0.5, cfg.rope_scaling)
    # score std = scale * sqrt(576) = 3.2 at unit-scale queries
    attention_checks(results, "", cfg.num_attention_heads, 1, L + DR, 640, L, False, scale,
                     1.0, g, flush)
    # K3, K4 — 6 routed picks of 64 plus the 2 folded shared experts
    moe = next(lp for lp in params["layers"] if "w13" in lp)
    moe_checks(results, "", moe["w13"], moe["w2"], cfg, g, flush, bf16_too=False)


def hybrid_kernel_phase(params, cfg, results, g, flush):
    import torch

    from krasis_tpu_torch.quant import quantize

    la, gqa = params["layers"][0], params["layers"][3]
    layer = la["qkvz_proj"].q.shape[0] - 1                   # the last layer of each stack
    # an int4 weight at qkvz_proj's shape, quantized on the card from a
    # seeded bf16 weight: no full-width path runs int4 through K1
    K, N = la["qkvz_proj"].k_dim, la["qkvz_proj"].n_dim
    w4 = quantize((torch.randn((K, N), generator=g, device=flush.device) * 0.02)
                  .to(torch.bfloat16), 4, 128)
    # K1 — the int8 lm_head; K1s — every stacked int8 projection of a decode step
    qmm_checks(results, "qcn/", (
        ("qmm:lm_head", params["lm_head"], None, torch.float32),
        ("qmm:int4_at_qkvz_shape", w4, None, torch.bfloat16),
        ("qmm_stacked:qkvz_proj", la["qkvz_proj"], layer, torch.bfloat16),
        ("qmm_stacked:qkvz_proj_T16", la["qkvz_proj"], layer, torch.bfloat16, 16),
        ("qmm_stacked:ba_proj", la["ba_proj"], layer, torch.bfloat16),
        ("qmm_stacked:la_out_proj", la["la_out_proj"], layer, torch.bfloat16),
        ("qmm_stacked:q_proj", gqa["q_proj"], layer, torch.bfloat16),
        ("qmm_stacked:k_proj", gqa["k_proj"], layer, torch.bfloat16),
        ("qmm_stacked:o_proj", gqa["o_proj"], layer, torch.bfloat16)), g, flush)
    qmm_split_checks("qcn/qmm_stacked:o_proj", gqa["o_proj"], layer, g)
    # K2 — GQA: 16 query heads on 2 kv heads of 256, K and V in two buffers
    d = cfg.qk_head_dim
    # score std = d^-0.5 * sqrt(d) * q_std = 3
    attention_checks(results, "qcn/", cfg.num_attention_heads, cfg.num_key_value_heads, d, d, d,
                     True, d ** -0.5, 3.0, g, flush)
    # K3, K5, K4 — 10 routed picks of 512 plus the folded shared expert
    moe_checks(results, "qcn/", la["w13"], la["w2"], cfg, g, flush, bf16_too=True)


def q8_kernel_phase(params, cfg, results, g, flush):
    """The two-stage expert class at DeepSeek-V2-Lite's int8-expert shapes:
    K6 / K6a at T = 1 with the 6 routed picks plus the 2 folded shared
    experts, K7 / K7a at T = 2048 over the whole stack, and the fused
    kernels at the same shapes for the class boundary."""
    import torch
    from krasis_tpu_torch.ops import gmm_cuda, moe_cuda
    from krasis_tpu_torch.ops.activations import swiglu
    from krasis_tpu_torch.quant import qtensor_bytes

    dev = flush.device
    C = counters()
    moe = next(lp for lp in params["layers"] if "w13" in lp)
    w13, w2 = moe["w13"], moe["w2"]
    E_r, E_all, k = cfg.n_routed_experts, w13.q.shape[0], cfg.num_experts_per_tok
    Hd, I = cfg.hidden_size, cfg.moe_intermediate_size
    bf16 = torch.bfloat16

    def held(name, got, want, tol):
        err, ratio = max_err(got, want, tol)
        print(f"[kernel] {name}: max|Δ| {err:.3g}, {ratio:.3g} of the limit (tol {tol})",
              flush=True)
        if not ratio <= 1.0:
            raise AssertionError(f"{name}: kernel disagrees with its plain version")

    # --- decode: K6 (bf16 rows) and K6a (int8 rows) on w13 and on w2
    x = torch.randn((1, Hd), generator=g, device=dev).to(bf16)
    routed = torch.randperm(E_r, generator=g, device=dev)[:k]
    idx = torch.cat([routed, torch.arange(E_r, E_all, device=dev)]).to(torch.int32)
    P = idx.shape[0]
    wts = torch.cat([torch.rand((k,), generator=g, device=dev) * 0.3,
                     torch.ones(E_all - E_r, device=dev)])[None]
    mask = torch.ones(P, dtype=torch.int32, device=dev)
    mask[[1, P - 2]] = 0
    x_rows = x.expand(P, Hd).contiguous()
    xq, sx = moe_cuda.quantize_activations(x_rows, w13.group_size)
    a = swiglu(moe_cuda.gathered_qmm_plain(x_rows, w13, idx).to(bf16))
    aq, sa = moe_cuda.quantize_activations(
        swiglu(moe_cuda.gathered_qmm_a8_plain(xq, sx, w13, idx)), w2.group_size)
    for name, w, rows, rq, rs in (("w13", w13, x_rows, xq, sx), ("w2", w2, a, aq, sa)):
        one = qtensor_bytes(w) // E_all
        K, N = w.k_dim, w.n_dim
        check_kernel(results, f"q8/gathered_qmm:{name}", C["K6"], moe_cuda.REPLACES_GQ,
                     lambda: moe_cuda.gathered_qmm(rows, w, idx),
                     lambda: moe_cuda.gathered_qmm_plain(rows, w, idx), None, 2e-2,
                     P * one + P * K * 2 + P * N * 4, 2 * P * K * N, PEAK_BF16, 50, flush)
        check_kernel(results, f"q8/gathered_qmm_a8:{name}", C["K6a"], moe_cuda.REPLACES_GQ_A8,
                     lambda: moe_cuda.gathered_qmm_a8(rq, rs, w, idx),
                     lambda: moe_cuda.gathered_qmm_a8_plain(rq, rs, w, idx), None, 3e-2,
                     P * one + P * K + P * (K // w.group_size) * 4 + P * N * 4,
                     2 * P * K * N, PEAK_INT8, 50, flush)
        # under a pick_valid mask: the skipped picks read back zero
        for label, got, want, tol in (
                ("gathered_qmm", moe_cuda.gathered_qmm(rows, w, idx, mask),
                 moe_cuda.gathered_qmm_plain(rows, w, idx, mask), 2e-2),
                ("gathered_qmm_a8", moe_cuda.gathered_qmm_a8(rq, rs, w, idx, mask),
                 moe_cuda.gathered_qmm_a8_plain(rq, rs, w, idx, mask), 3e-2)):
            held(f"q8/{label}:{name} with pick_valid", got, want, tol)
            if bool(got[mask == 0].any()) or not bool(got[mask == 1].any()):
                raise AssertionError(f"q8/{label}:{name}: skipped picks must read back zero")

    # --- prefill: K7 at both call shapes
    T = 2048
    xs = torch.randn((T, Hd), generator=g, device=dev).to(bf16)
    topk = torch.rand((T, E_r), generator=g, device=dev).topk(k, dim=-1).indices.to(torch.int32)
    pw = torch.rand((T, k), generator=g, device=dev)
    M = T * k
    plan = gmm_cuda.plan_tiles(topk, E_all, gmm_cuda.choose_tm(M, E_all))   # the main path's
    real = plan.row_src >= 0
    computed = plan.tile_valid.to(torch.bool).repeat_interleave(plan.tm)
    hit = int((torch.bincount(topk.reshape(-1).long(), minlength=E_all) > 0).sum())
    e13, e2 = qtensor_bytes(w13) / E_all, qtensor_bytes(w2) / E_all
    h_plain = gmm_cuda.gmm_plain(xs, plan.row_src, w13, plan, False)
    a_plain = swiglu(h_plain.to(bf16))
    lib13 = grouped_mm_library("q8/gmm_two_stage:w13", xs[plan.row_src[real].long()], w13, plan,
                               torch.float32, h_plain[real])
    del h_plain
    check_kernel(results, "q8/gmm_two_stage:w13", C["K7"], gmm_cuda.REPLACES_TWO_STAGE,
                 lambda: gmm_cuda.gmm_two_stage(xs, plan.row_src, w13, plan),
                 lambda: gmm_cuda.gmm_plain(xs, plan.row_src, w13, plan, False), lib13, 2e-2,
                 hit * e13 + T * Hd * 2 + M * 2 * I * 4, 2 * M * Hd * 2 * I, PEAK_BF16, 10,
                 None, select=lambda o: o[real])
    lib2 = grouped_mm_library("q8/gmm_two_stage:w2", a_plain[real], w2, plan, torch.float32,
                              gmm_cuda.gmm_plain(a_plain, None, w2, plan, False)[real])
    check_kernel(results, "q8/gmm_two_stage:w2", C["K7"], gmm_cuda.REPLACES_TWO_STAGE,
                 lambda: gmm_cuda.gmm_two_stage(a_plain, None, w2, plan),
                 lambda: gmm_cuda.gmm_plain(a_plain, None, w2, plan, False), lib2, 2e-2,
                 hit * e2 + M * I * 2 + M * Hd * 4, 2 * M * I * Hd, PEAK_BF16, 10,
                 None, select=lambda o: o[real])

    # K7 + SwiGLU + K7 against K4's fused epilogue on the same plan: equal
    def fused():
        return gmm_cuda.gmm(gmm_cuda.gmm(xs, plan.row_src, w13, plan, True), None, w2, plan,
                            False)

    def two_stage():
        h = gmm_cuda.gmm_two_stage(xs, plan.row_src, w13, plan)
        return gmm_cuda.gmm_two_stage(swiglu(h.to(bf16)), None, w2, plan)

    a4 = gmm_cuda.gmm(xs, plan.row_src, w13, plan, True)
    a7 = swiglu(gmm_cuda.gmm_two_stage(xs, plan.row_src, w13, plan).to(bf16))
    d_a = float((a4[computed].float() - a7[computed].float()).abs().max())
    d_o = float((fused()[computed] - two_stage()[computed]).abs().max())
    print(f"[kernel] q8/gmm_two_stage: K7 + SwiGLU + K7 against K4 fused on one plan: "
          f"max|Δ| hidden {d_a}, output {d_o}", flush=True)
    if d_a != 0.0 or d_o != 0.0:
        raise AssertionError("the two-stage grouped form must equal the fused one bit for bit")

    # --- K7a: each stage, then the whole int8 entry, on the 64-row plan
    # that moe_prefill gives its int8 rows
    plan8 = gmm_cuda.plan_tiles(topk, E_all)
    real8 = plan8.row_src >= 0
    gs13, gs2 = w13.group_size, w2.group_size
    xsq, xss = moe_cuda.quantize_activations(xs, gs13)
    h8 = gmm_cuda.gmm_a8_plain(xsq, xss, plan8.row_src, w13, plan8)
    a8q, a8s = moe_cuda.quantize_activations(swiglu(h8), gs2)
    check_kernel(results, "q8/gmm_a8:w13", C["K7a"], gmm_cuda.REPLACES_A8,
                 lambda: gmm_cuda.gmm_a8(xsq, xss, plan8.row_src, w13, plan8),
                 lambda: gmm_cuda.gmm_a8_plain(xsq, xss, plan8.row_src, w13, plan8), None, 3e-2,
                 hit * e13 + T * Hd + T * (Hd // gs13) * 4 + M * 2 * I * 4,
                 2 * M * Hd * 2 * I, PEAK_INT8, 10, None, select=lambda o: o[real8])
    check_kernel(results, "q8/gmm_a8:w2", C["K7a"], gmm_cuda.REPLACES_A8,
                 lambda: gmm_cuda.gmm_a8(a8q, a8s, None, w2, plan8),
                 lambda: gmm_cuda.gmm_a8_plain(a8q, a8s, None, w2, plan8), None, 3e-2,
                 hit * e2 + M * I + M * (I // gs2) * 4 + M * Hd * 4, 2 * M * I * Hd,
                 PEAK_INT8, 10, None, select=lambda o: o[real8])
    o8 = gmm_cuda.gmm_a8_plain(a8q, a8s, None, w2, plan8)
    want = (o8[plan8.dest].reshape(T, k, Hd) * pw[..., None]).sum(dim=1).to(bf16)
    held('q8/moe_prefill(activation="int8")',
         gmm_cuda.moe_prefill(xs, w13, w2, topk, pw, activation="int8"), want, 3e-2)

    # --- the fused kernels at the same shapes, for a later look at the class
    # boundary on this card (the port keeps the reference's boundary)
    one_idx = idx[None]
    times = {
        "decode_int8_two_stage_K6a_ms": time_ms(lambda: moe_cuda.moe_gathered_tiled(
            x, w13, w2, one_idx, wts, activation="int8"), 50, flush),
        "decode_int8_fused_K3_ms": time_ms(lambda: moe_cuda.moe_w4a8(
            x, w13, w2, one_idx, wts), 50, flush),
        "decode_bf16_two_stage_K6_ms": time_ms(lambda: moe_cuda.moe_gathered_tiled(
            x, w13, w2, one_idx, wts), 50, flush),
        "decode_bf16_fused_K5_ms": time_ms(lambda: moe_cuda.moe_bf16(
            x, w13, w2, one_idx, wts), 50, flush),
        "prefill_two_stage_K7_swiglu_K7_ms": time_ms(two_stage, 10),
        "prefill_fused_K4_K4_ms": time_ms(fused, 10),
    }
    print("[class] " + json.dumps({"model": "deepseek-v2-lite int8 experts",
                                   "decode": f"T=1, {P} picks of {E_all}",
                                   "prefill": f"T={T}, k={k}, E={E_all}", **times}),
          flush=True)


def q8_entry_points(eng, rng):
    """This path's other entry points, inside the counted run: perplexity
    over 4096 token ids, forward_all_logits against the prefill's own last
    logits, and the int8 grouped form through moe_prefill(activation="int8")
    on a layer's own stacks and router."""
    import math

    import torch
    from krasis_tpu_torch.models.model import forward
    from krasis_tpu_torch.ops.gmm_cuda import moe_prefill
    from krasis_tpu_torch.ops.routing import compute_routing
    from krasis_tpu_torch.perplexity import evaluate_perplexity, sliding_windows

    cfg, dev = eng.cfg, eng.device
    ids = rng.integers(100, cfg.vocab_size - 100, 4096).tolist()
    out = evaluate_perplexity(eng, ids, window=2048, stride=1024, log_every=0)
    expect = sum(max(0, end - start - 1 - s0)
                 for start, end, s0 in sliding_windows(len(ids), 2048, 1024))
    print("[perplexity] " + json.dumps({k: out[k] for k in (
        "ppl", "bits_per_token", "tokens_scored", "windows", "elapsed_s")}), flush=True)
    if not (math.isfinite(out["ppl"]) and out["ppl"] > 1.0 and out["tokens_scored"] == expect):
        raise AssertionError(f"perplexity: {out['ppl']} over {out['tokens_scored']} tokens, "
                             f"expected {expect} scored")

    window = ids[:2048]
    all_logits = eng.forward_all_logits(window)
    if tuple(all_logits.shape) != (2048, cfg.vocab_size) or not bool(
            torch.isfinite(all_logits).all()):
        raise AssertionError("forward_all_logits: wrong shape or non-finite logits")
    last_row = all_logits[-1].clone()
    del all_logits
    eng.reset()
    with torch.inference_mode():
        last = forward(eng.params, torch.tensor([window], device=dev),
                       torch.tensor([2048], dtype=torch.int32, device=dev), eng.cache, cfg,
                       eng.quant, prefill=True)[0]
    rms = float(last.square().mean().sqrt())
    err = float((last_row - last).abs().max())
    print(f"[perplexity] forward_all_logits[-1] vs the prefill's last logits: max|Δ| {err:.3g} "
          f"({err / rms:.3g} of their rms, limit 0.02)", flush=True)
    if not err <= 2e-2 * rms:
        raise AssertionError("forward_all_logits disagrees with the prefill's last logits")

    lp = next(lp for lp in eng.params["layers"] if "w13" in lp)
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    x = torch.randn((2048, cfg.hidden_size), generator=g, device=dev).to(torch.bfloat16)
    routing = compute_routing(x, lp["gate_w"], cfg)
    outs, ms = {}, {}
    for act in ("bf16", "int8"):
        run = lambda: moe_prefill(x, lp["w13"], lp["w2"], routing.topk_idx,
                                  routing.topk_weights, activation=act)
        outs[act] = run().to(torch.float32)
        ms[act] = time_ms(run, 5)
    rel = float((outs["int8"] - outs["bf16"]).square().mean().sqrt()
                / outs["bf16"].square().mean().sqrt())
    print(f"[entry] moe_prefill on one layer, T = 2048: bf16 rows {ms['bf16']:.3f} ms, int8 rows "
          f"{ms['int8']:.3f} ms, rms difference {rel:.3g} of the output's rms", flush=True)
    if not (math.isfinite(rel) and rel < 5e-2):
        raise AssertionError("moe_prefill(activation='int8') strays from the bf16 form")


def profile_phase(eng, prompt, new: int):
    """Device time by kernel over one request, against the wall time of the
    same request run without the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompt, max_new_tokens=new, stop_ids={-1})
    wall_ms = (time.perf_counter() - t0) * 1e3
    # the second step is recorded: the first, one small kernel, warms the
    # tracer up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        eng.generate(prompt, max_new_tokens=new, stop_ids={-1})
        torch.cuda.synchronize()
        prof.step()
    # the step markers' spans on the device timeline are not kernels
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"[profile] prompt {len(prompt)} + {new} tokens: wall {wall_ms:.1f} ms unprofiled, "
          f"device kernels {busy:.1f} ms ({100 * busy / wall_ms:.1f}% busy), "
          f"{sum(r[2] for r in rows)} launches")
    for key, ms, count in rows[:12]:
        print(f"[profile]   {ms:9.2f} ms {count:6d}x  {key[:90]}")
    k1 = [(ms, count) for key, ms, count in rows if "qmm_kernel" in key]
    if k1:
        ms, count = sum(r[0] for r in k1), sum(r[1] for r in k1)
        print(f"[profile]   K1 + K1s: {ms:.2f} ms over {count} launches, "
              f"{1e3 * ms / count:.2f} us each")
    for key, ms, count in rows:                       # K2's launches, each form
        if "attention_kernel" in key or "combine_kernel" in key:
            name = key.split("((")[0].replace("void (anonymous namespace)::", "")
            print(f"[profile]   K2 {name}: {count} launches, {1e3 * ms / count:.2f} us each")


def run_family(label, preset, quant, kernel_phase, requests, on_path, results, rng,
               profile_decode, off_path=(), entry_points=None):
    """One model family at full width: build the engine, hold its kernels to
    their plain versions, answer `requests` ((prompt tokens, new tokens,
    expert activation[, top_logprobs])) and run `entry_points` with the
    launch counts set to 0 just before and read just after, then profile one
    prefill and one decode. Kernels named in `on_path` must have been
    launched in that run, those in `off_path` must not. Fills the launch
    counts into this family's entries of `results`."""
    import gc
    from dataclasses import replace

    import torch
    from krasis_tpu_torch.config import preset_config
    from krasis_tpu_torch.models.synthetic import build_synthetic_engine
    from krasis_tpu_torch.runtime.engine import Engine

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = preset_config(preset)
    eng = build_synthetic_engine(cfg, quant, seed=0)
    torch.cuda.synchronize()
    print(f"[engine] {label}: {cfg.num_hidden_layers} layers at full width built in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card", flush=True)

    first = len(results)
    g = torch.Generator(device="cuda")
    g.manual_seed(1234)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    kernel_phase(eng.params, cfg, results, g, flush)
    del flush
    torch.cuda.empty_cache()
    t_kernels = time.perf_counter()

    # the same weights under the other expert activation, where a request asks
    engines = {eng.quant.expert_activation: eng}
    for _, _, act, *_ in requests:
        if act not in engines:
            engines[act] = Engine(cfg, replace(eng.quant, expert_activation=act), eng.params,
                                  max_len=eng.max_len)
    C = counters()
    eng.generate(rng.integers(100, cfg.vocab_size - 100, 256).tolist(), max_new_tokens=8,
                 stop_ids={-1})                          # warm-up: cuBLAS, allocator
    for m, attr in C.values():
        setattr(m, attr, 0)
    for n, new, act, *rest in requests:
        top = rest[0] if rest else 0
        before = {name: getattr(m, attr) for name, (m, attr) in C.items()}
        prompt = rng.integers(100, cfg.vocab_size - 100, n).tolist()
        res = engines[act].generate(prompt, max_new_tokens=new, stop_ids={-1},
                                    top_logprobs=top)
        if not res.finite:
            raise AssertionError(f"{label}: non-finite logits in the {n}-token request")
        if len(res.tokens) != new:
            raise AssertionError(f"{label}: {n}-token request gave {len(res.tokens)} tokens")
        if not all(lp == lp and -1e30 < lp <= 0.0 for lp in res.logprobs):
            raise AssertionError(f"{label}: logprobs must be finite and at most 0")
        if top:
            # greedy: the chosen token leads its step's top-N, with its logprob
            for tok, lp, alts in zip(res.tokens, res.logprobs, res.top_logprobs):
                if (len(alts) != top or alts[0][0] != tok or abs(alts[0][1] - lp) > 1e-6
                        or not all(-1e30 < v <= 0.0 for _, v in alts)):
                    raise AssertionError(f"{label}: top_logprobs of token {tok}: {alts}")
        print("[request] " + json.dumps({
            "model": preset, "expert_activation": act, "top_logprobs": top,
            "prompt": n, "tokens": len(res.tokens), "prefill_tok_s": res.prefill_tok_s,
            "decode_tok_s": res.decode_tok_s, "prefill_s": res.prefill_s,
            "decode_s": res.decode_s,
            "launches": {name: getattr(m, attr) - before[name]
                         for name, (m, attr) in C.items()}}), flush=True)
    t_requests = time.perf_counter()
    if entry_points is not None:
        entry_points(eng, rng)
    counts = {name: getattr(m, attr) for name, (m, attr) in C.items()}
    print(f"[launches] {label}: {json.dumps(counts)}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on the card", flush=True)
    for name in on_path:
        if counts[name] <= 0:
            raise AssertionError(f"{label}: {name} was never launched on the main path")
    for name in off_path:
        if counts[name] != 0:
            raise AssertionError(f"{label}: {name} was launched {counts[name]} times, but "
                                 "this model's experts belong to the other class")
    by_counter = {C[name]: n for name, n in counts.items()}
    for counter, res in results[first:]:
        res["launches"] = by_counter[counter]

    t_entries = time.perf_counter()
    profile_phase(eng, rng.integers(100, cfg.vocab_size - 100, 2048).tolist(), 1)   # prefill
    profile_phase(eng, rng.integers(100, cfg.vocab_size - 100, 40).tolist(), profile_decode)
    print(f"[time] {label}: kernel checks {t_kernels - t0:.1f} s (engine build included), "
          f"requests {t_requests - t_kernels:.1f} s, other entry points "
          f"{t_entries - t_requests:.1f} s, profiles {time.perf_counter() - t_entries:.1f} s",
          flush=True)
    del eng, engines
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from krasis_tpu_torch import build
    from krasis_tpu_torch.config import QuantConfig
    from krasis_tpu_torch.device import set_exact_matmul_flags

    t_start = time.perf_counter()
    card = card_line()
    set_exact_matmul_flags()
    print(f"[card] {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    logs = build.build()
    print(f"[build] {len(logs)} kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")

    reference_phases()

    results = []
    rng = np.random.default_rng(0)
    run_family("DeepSeek-V2-Lite Q4", "deepseek-v2-lite",
               QuantConfig(expert_bits=4, group_size=128), v2lite_kernel_phase,
               ((2048, 64, "int8"), (2500, 32, "int8"), (40, 32, "int8")),
               ("K1", "K2", "K3", "K4"), results, rng, profile_decode=16)
    run_family("Qwen3-Coder-Next Q4, int8 projections", "qwen3-coder-next",
               QuantConfig(expert_bits=4, group_size=128, attention="int8"),
               hybrid_kernel_phase,
               ((2048, 32, "int8"), (2500, 16, "int8"), (40, 16, "int8"), (40, 16, "bf16")),
               ("K1", "K1s", "K2", "K3", "K4", "K5"), results, rng, profile_decode=16)

    run_family("DeepSeek-V2-Lite Q8 (two-stage expert class)", "deepseek-v2-lite",
               QuantConfig(expert_bits=8, group_size=128), q8_kernel_phase,
               ((2048, 128, "int8"), (40, 32, "int8", 5), (40, 16, "bf16")),
               ("K1", "K2", "K6", "K6a", "K7", "K7a"), results, rng, profile_decode=16,
               off_path=("K3", "K4", "K5"), entry_points=q8_entry_points)

    print(f"[time] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": [r for _, r in results]}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
