#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (krasis_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card and toolchain: the card's name and power limit, torch and CUDA
   versions; TF32 off;
2. build: the four CUDA kernels from krasis_tpu_torch/csrc with nvcc;
3. reference: a tiny DeepSeek-V2-Lite run on the card through the kernels
   against the same model on the CPU through their plain versions;
4. each kernel against its plain PyTorch version at main-path shapes, on
   the full-width model's own weights, with kernel, plain, library-call
   and bound times;
5. main path: full-width DeepSeek-V2-Lite Q4 (random weights from a seed)
   answers three greedy requests through Engine.generate; every logit must
   be finite and every kernel must have been launched.

The last two lines are the card's name and power limit and the JSON
result; the line before them lists the kernels.
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


def check_kernel(results, name, module, replaces, run_kernel, run_plain, run_library,
                 tol, nbytes, ops, peak, iters, flush, select=None):
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
    print(f"[kernel] {name}: max|Δ| {err:.3g}, {ratio:.3g} of the limit (tol {tol}) kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} ms library {lib_ms} ms bound {b_ms:.4f} ms ({b_by})",
          flush=True)
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    results.append((module, res))


def reference_phase():
    """Tiny model: kernels on the card against plain versions on the CPU."""
    import torch
    from krasis_tpu_torch.config import QuantConfig
    from krasis_tpu_torch.models.model import forward
    from krasis_tpu_torch.models.params import init_synthetic_params
    from krasis_tpu_torch.models.synthetic import tiny_config
    from krasis_tpu_torch.runtime.kv_cache import init_cache

    # every token picks all 8 routed experts: with random tiny routers a
    # top-k choice can sit on a near-tie that the two devices' summation
    # orders break differently; picking all experts keeps the comparison
    # about the arithmetic
    cfg = tiny_config("deepseek-v2-lite", moe_intermediate_size=128, num_hidden_layers=4,
                      num_experts_per_tok=8)
    quant = QuantConfig(expert_bits=4, group_size=128, kv_cache_dtype="bf16")
    cpu = init_synthetic_params(cfg, quant, seed=1, device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    gpu = to(cpu, "cuda")
    prompt = torch.randint(1, cfg.vocab_size, (1, 160), generator=torch.Generator().manual_seed(3))
    # a model-level check, as tests/test_torch_model.py holds the port to the
    # JAX package: bf16 rounding differences compound over the layers, so
    # the limit is 2e-2 of the larger of 1 and the largest logit
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
                    raise AssertionError(f"tiny model step {step}: non-finite logits")
                err = float((g - r).abs().max())
                limit = 2e-2 * max(1.0, float(r.abs().max()))
                worst = max(worst, err)
                worst_rel = max(worst_rel, err / float(r.square().mean().sqrt()))
                if not err <= limit:
                    raise AssertionError(f"tiny model step {step}: card vs CPU {err} > {limit}")
    print(f"[reference] tiny V2-Lite on the card vs the CPU plain path: max|Δ| logits {worst:.3g} "
          f"({worst_rel:.3g} of their rms)", flush=True)


def kernel_phase(params, cfg, results, dev="cuda"):
    import torch
    import torch.nn.functional as F
    from krasis_tpu_torch.ops import flash_attention as fa
    from krasis_tpu_torch.ops import gmm_cuda, moe_cuda, qmm_cuda
    from krasis_tpu_torch.ops.rope import yarn_softmax_scale
    from krasis_tpu_torch.quant import dequantize, qtensor_bytes

    dev = torch.device(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    # K1 — qmm at T = 1: the int8 lm_head and the decode dense MLP
    layer0 = params["layers"][0]
    for name, qt, out_dtype in (("qmm:lm_head", params["lm_head"], torch.float32),
                                ("qmm:mlp_w13", layer0["mlp_w13"], torch.bfloat16),
                                ("qmm:mlp_w2", layer0["mlp_w2"], torch.bfloat16)):
        K, N = qt.k_dim, qt.n_dim
        x = torch.randn((1, K), generator=g, device=dev).to(torch.bfloat16)
        w = dequantize(qt, torch.bfloat16)
        nbytes = qtensor_bytes(qt) + x.numel() * 2 + N * (4 if out_dtype == torch.float32 else 2)
        check_kernel(results, name, qmm_cuda, qmm_cuda.REPLACES,
                     lambda: qmm_cuda.qmm(x, qt, out_dtype),
                     lambda: qmm_cuda.qmm_plain(x, qt, out_dtype),
                     lambda: torch.matmul(x, w),
                     2e-2, nbytes, 2 * K * N, PEAK_BF16, 50, flush)
        del w

    # K2 — attention over the MLA cache: prefill, chunk, decode
    H, L, DR = cfg.num_attention_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    Dp = 640
    scale = yarn_softmax_scale((cfg.qk_nope_head_dim + DR) ** -0.5, cfg.rope_scaling)
    cache = torch.zeros((1, 1, 4096, Dp), dtype=torch.bfloat16, device=dev)
    # unit-scale rows, as the normed latents are: the scores are peaked and
    # the outputs O(1), so a masking fault moves them well past the limit
    cache[..., :L + DR] = torch.randn((1, 1, 4096, L + DR), generator=g, device=dev
                                      ).to(torch.bfloat16)
    for name, sq, q_off, kv_len, replaces in (
            ("attention:prefill_2048", 2048, 0, 2048, fa.REPLACES),
            ("attention:chunk_452_at_2048", 452, 2048, 2500, fa.REPLACES),
            ("attention:decode_kv_2560", 1, 2559, 2560, fa.REPLACES_DECODE)):
        q = torch.zeros((1, sq, H, Dp), dtype=torch.bfloat16, device=dev)
        q[..., :L + DR] = torch.randn((1, sq, H, L + DR), generator=g, device=dev
                                      ).to(torch.bfloat16)
        kv = cache[:, :, :kv_len]
        qo = torch.tensor([q_off], dtype=torch.int32, device=dev)
        kl = torch.tensor([kv_len], dtype=torch.int32, device=dev)
        qh = q.transpose(1, 2)
        kh = kv.expand(1, H, kv_len, Dp)
        vh = kh[..., :L]
        pos = q_off + torch.arange(sq, device=dev)
        mask = torch.arange(kv_len, device=dev)[None, :] <= pos[:, None]
        visible = int(mask.sum())
        # the function needs the L + DR real lanes; the zero pad to Dp is not work
        nbytes = (sq * H + kv_len) * (L + DR) * 2 + sq * H * L * 2
        ops = 2 * H * visible * (L + DR + L)
        check_kernel(results, name, fa, replaces,
                     lambda: fa.flash_attention(q, kv, qo, kl, scale, L),
                     lambda: fa.flash_attention_plain(q, kv, qo, kl, scale, L),
                     lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                            scale=scale),
                     2e-2, nbytes, ops, PEAK_BF16, 20 if sq > 1 else 50, flush)
        if sq > 1:
            # the same check must refuse a kernel that dropped the causal mask
            _, fault = max_err(fa.flash_attention_plain(q, kv, kl - 1, kl, scale, L),
                               fa.flash_attention_plain(q, kv, qo, kl, scale, L), 2e-2)
            print(f"[kernel] {name}: without the causal mask the check reads "
                  f"{fault:.3g} of the limit", flush=True)
            if not fault > 1.0:
                raise AssertionError(f"{name}: the check cannot see a dropped causal mask")

    # K3 — W4A8 decode MoE: 6 routed picks of 64 plus the 2 folded shared experts
    moe_layers = [lp for lp in params["layers"] if "w13" in lp]
    w13, w2 = moe_layers[0]["w13"], moe_layers[0]["w2"]
    E_r = cfg.n_routed_experts
    x = torch.randn((1, cfg.hidden_size), generator=g, device=dev).to(torch.bfloat16)
    routed = torch.randperm(E_r, generator=g, device=dev)[:cfg.num_experts_per_tok]
    idx = torch.cat([routed, torch.arange(E_r, w13.q.shape[0], device=dev)])[None].to(torch.int32)
    wts = torch.cat([torch.rand((cfg.num_experts_per_tok,), generator=g, device=dev) * 0.3,
                     torch.ones(idx.shape[1] - cfg.num_experts_per_tok, device=dev)])[None]
    P = idx.shape[1]
    per_pick = (qtensor_bytes(w13) + qtensor_bytes(w2)) // w13.q.shape[0]
    I = cfg.moe_intermediate_size
    Hd = cfg.hidden_size
    check_kernel(results, "moe_decode", moe_cuda, moe_cuda.REPLACES,
                 lambda: moe_cuda.moe_w4a8(x, w13, w2, idx, wts),
                 lambda: moe_cuda.moe_w4a8_plain(x, w13, w2, idx, wts),
                 None, 3e-2, P * per_pick + Hd * 4, 2 * P * (Hd * 2 * I + I * Hd),
                 PEAK_INT8, 50, flush)

    # K4 — grouped GEMM at T = 2048, 6 picks over the 66-expert stack
    T, k = 2048, cfg.num_experts_per_tok
    x = torch.randn((T, Hd), generator=g, device=dev).to(torch.bfloat16)
    topk = torch.rand((T, E_r), generator=g, device=dev).topk(k, dim=-1).indices.to(torch.int32)
    plan = gmm_cuda.plan_tiles(topk, w13.q.shape[0])
    real = plan.row_src >= 0
    hit = int((torch.bincount(topk.reshape(-1).long(), minlength=w13.q.shape[0]) > 0).sum())
    E_all = w13.q.shape[0]
    M = T * k
    a_plain = gmm_cuda.gmm_plain(x, plan.row_src, w13, plan, True)
    check_kernel(results, "gmm:w13_swiglu", gmm_cuda, gmm_cuda.REPLACES,
                 lambda: gmm_cuda.gmm(x, plan.row_src, w13, plan, True),
                 lambda: gmm_cuda.gmm_plain(x, plan.row_src, w13, plan, True),
                 None, 3e-2, hit * qtensor_bytes(w13) / E_all + T * Hd * 2 + M * I * 2,
                 2 * M * Hd * 2 * I, PEAK_BF16, 10, None, select=lambda o: o[real])
    check_kernel(results, "gmm:w2_f32", gmm_cuda, gmm_cuda.REPLACES_W2,
                 lambda: gmm_cuda.gmm(a_plain, None, w2, plan, False),
                 lambda: gmm_cuda.gmm_plain(a_plain, None, w2, plan, False),
                 None, 3e-2, hit * qtensor_bytes(w2) / E_all + M * I * 2 + M * Hd * 4,
                 2 * M * I * Hd, PEAK_BF16, 10, None, select=lambda o: o[real])


def profile_phase(eng, prompt, new: int):
    """Device time by kernel over one request, against the wall time of the
    same request run without the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompt, max_new_tokens=new, stop_ids={-1})
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.generate(prompt, max_new_tokens=new, stop_ids={-1})
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"[profile] prompt {len(prompt)} + {new} tokens: wall {wall_ms:.1f} ms unprofiled, "
          f"device kernels {busy:.1f} ms ({100 * busy / wall_ms:.1f}% busy)")
    for key, ms, count in rows[:12]:
        print(f"[profile]   {ms:9.2f} ms {count:6d}x  {key[:90]}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from krasis_tpu_torch import build
    from krasis_tpu_torch.config import QuantConfig, preset_config
    from krasis_tpu_torch.device import set_exact_matmul_flags
    from krasis_tpu_torch.models.synthetic import build_synthetic_engine
    from krasis_tpu_torch.ops import flash_attention, gmm_cuda, moe_cuda, qmm_cuda

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

    reference_phase()

    t0 = time.perf_counter()
    cfg = preset_config("deepseek-v2-lite")
    eng = build_synthetic_engine(cfg, QuantConfig(expert_bits=4, group_size=128), seed=0)
    torch.cuda.synchronize()
    print(f"[engine] full-width V2-Lite Q4 built in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card", flush=True)

    results = []
    kernel_phase(eng.params, cfg, results)
    torch.cuda.empty_cache()

    modules = (qmm_cuda, flash_attention, moe_cuda, gmm_cuda)
    rng = np.random.default_rng(0)
    eng.generate(rng.integers(100, cfg.vocab_size - 100, 256).tolist(), max_new_tokens=8,
                 stop_ids={-1})                          # warm-up: cuBLAS, allocator
    for m in modules:
        m.launches = 0
    for n, new in ((2048, 128), (2500, 32), (40, 32)):
        before = [m.launches for m in modules]
        prompt = rng.integers(100, cfg.vocab_size - 100, n).tolist()
        res = eng.generate(prompt, max_new_tokens=new, stop_ids={-1})
        if not res.finite:
            raise AssertionError(f"non-finite logits in the {n}-token request")
        if len(res.tokens) != new:
            raise AssertionError(f"{n}-token request gave {len(res.tokens)} tokens")
        print("[request] " + json.dumps({
            "prompt": n, "tokens": len(res.tokens), "prefill_tok_s": res.prefill_tok_s,
            "decode_tok_s": res.decode_tok_s, "prefill_s": res.prefill_s,
            "decode_s": res.decode_s,
            "launches": {m.__name__.rsplit(".", 1)[1]: m.launches - b
                         for m, b in zip(modules, before)}}), flush=True)
    counts = {m: m.launches for m in modules}
    profile_phase(eng, rng.integers(100, cfg.vocab_size - 100, 2048).tolist(), 1)   # prefill
    profile_phase(eng, rng.integers(100, cfg.vocab_size - 100, 40).tolist(), 64)    # decode
    for m, c in counts.items():
        if c <= 0:
            raise AssertionError(f"{m.__name__} was never launched on the main path")

    for m, res in results:
        res["launches"] = counts[m]
    print(json.dumps({"kernels": [r for _, r in results]}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
