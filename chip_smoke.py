#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (krasis_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card and toolchain: the card's name and power limit, torch and CUDA
   versions; TF32 off;
2. build: the CUDA sources of krasis_tpu_torch/csrc with nvcc, in parallel
   (krasis_tpu_torch/build.py), in a thread while this one trains phase 14
   (d)'s quality checkpoint on the card, which needs none of the kernels;
3. reference: a tiny DeepSeek-V2-Lite (int4 experts, and int8 experts in
   the two-stage class), a tiny Qwen3-Coder-Next hybrid and a tiny GPT-OSS
   over an fp8 cache (top-4 of 8 biased experts: its decode MoE runs on K6
   and its prefill MoE on K7, which must both have launched) run on the card through the kernels against
   the same models on the CPU through their plain versions; then groups of
   16 (ROADMAP C-2) through moe_forward in each regime, each taking the
   reference's form on that form's kernel; and moe_prefill(activation=
   "int8") on a gs-16 int4 stack (ROADMAP C-3): two K7a launches, no K4 or
   K7, within 3e-2 of the same call on the CPU;
4. DeepSeek-V2-Lite Q4 at full width (MLA, 27 layers, random weights from a
   seed): each of its kernels (K1 qmm, K2 attention with V inside K: a
   prefill, a chunk, and split-KV decode at kv_len 2560, 2500 and 40 over
   the engine's 4096-row cache view; K3 W4A8 decode MoE, two device
   kernels a call, each call equal bit for bit to the next, and the plain
   version without any one pick's weight the check must refuse; K5, the
   bf16-row decode MoE on K1's core, the same way within 3e-2; K4
   grouped GEMM on the main path's tile plan) against its plain PyTorch
   version at
   main-path shapes on the model's own weights, with kernel, plain,
   library-call (SDPA for K2, grouped_mm on pre-dequantized stacks for the
   grouped GEMM's products) and bound times, K2's forms again over the
   cache in e4m3 (equal bit for bit to K2 over that cache cast to bf16);
   then five greedy requests through Engine.generate, one with an fp8
   cache and one with bf16 expert activations (K5), and a profile of one
   prefill and one decode;
5. Qwen3-Coder-Next at full width (48 layers: 36 Gated DeltaNet + 12 GQA,
   512 experts top-10 + 1 shared, int8 projections): the same for the
   kernels this path adds or reshapes (K1s stacked qmm, K2 with a separate
   V, K5 bf16 decode MoE, and K1, K3, K4 at this model's shapes); three
   requests with int8 expert activations, one with bf16, and the profile,
   and a profile of that bf16 request, which must show K5's two kernels
   (K1's kernel with its ACT and PSUM flags) and no K3 kernel;
6. DeepSeek-V2-Lite Q8 at full width and depth (int8 experts of 8.65 MB a
   pick: the two-stage expert class): K6 (on K1's core, with device us and
   a bmm yardstick) and K6a's one product (gathered products) on w13 and w2
   with 8 picks of 66, once under a pick_valid mask;
   K6a's chain moe_gathered_tiled(activation="int8") at the same picks (two
   device kernels a call under K6a's names, each call equal bit for bit to
   the next, and the plain version without any one pick's weight the check
   must refuse), again under the mask, where it must also agree with K3's
   function with the skipped picks' weights set to 0; K7 two-stage grouped
   GEMM at both call shapes, and K7 + SwiGLU + K7 equal bit for bit to K4's
   fused result on the same plan; K7a int8 grouped GEMM (the int8 tensor
   cores) stage by stage on the 64-row plan and on the 128-row plan that
   choose_tm gives T = 2048, with device us and max|Δ| (0 expected: int8
   stacks fold in the plain version's order), and the whole
   moe_prefill(activation="int8") within 3e-2 of its plain version, timed in
   turns with the bf16 moe_prefill on the same routing; the fused kernels timed at the
   same shapes for the class boundary; then requests with int8 and bf16
   activations, one with top_logprobs=5, the perplexity entry point over
   4096 token ids (window 2048, stride 1024), the int8 prefill A/B entry,
   and the profile. Its routed experts must not launch K3, K4 or K5 (by
   counter, and in the profiles by K3's and K5's kernel names; K4 shares
   its kernel with K7);
7. GPT-OSS-20B at full width and depth (24 layers alternating sliding
   (window 128) and full GQA attention with sinks, 32 biased experts top-4
   at int4 gs 32, an int8 lm_head [2880, 201088]): K1 on the lm_head, K2's
   window, sink and fp8 forms on the layers' own K / V with random nonzero
   sinks (a 2048-row prefill, a 452-row chunk at q_off 2048, split decode
   at kv_len 2560, 2500 and 40; sliding and full; each over the cache in
   bf16 and in e4m3), with device times from the profiler, the combine
   launch's own, and three negative controls the check must refuse (no
   window, no sinks, the sink added in every split); requests 2048 + 32,
   2500 + 16, 40 + 16, 2500 + 16 over an fp8 cache, and 40 + 16 on an
   engine at max_len 131,072 whose "auto" cache resolves to fp8; every K2
   form must have been launched by them. The biased experts: K6 at T = 1
   and 2 (4 and 8 picks) on layer 0's w13 and w2 (2880 columns: a 64-column
   tail), with a bmm yardstick and under a pick_valid mask; the biased chain
   (two K6 launches, the biases between) against the plain gathered path,
   refusing a dropped w13 bias, a dropped w2 bias and each dropped pick; one
   layer's decode MoE device time, plain path and chain in turns. In the
   grouped regime: K7 on w13 and w2 (w2's last column CTA has 64 live
   columns of 128) on plans from layer 0's router at T = 2048 (128-row
   tiles), 452 and 40 (64-row tiles), each also under a pick_valid mask,
   with device us and grouped_mm's bf16-out product as a yardstick; the
   biased grouped chain (moe_prefill with the biases: two K7 launches, the
   biases between) against the plain moe_forward_ragged at T = 2048 and 40,
   refusing a dropped w13 bias, a dropped w2 bias and the biases of each
   tile's neighbour's expert; one layer's prefill MoE device time, plain
   path and chain in turns. Decode runs its MoE on K6 and prefill on K7,
   which must both have launched, with no plain MoE form: no K3-K6a or K7a
   launch, no K6 kernel in the prefill's profile and gmm_kernel in it.

8. the probes (krasis_tpu_torch/probes, the H100 counterparts of the TPU
   probes under benchmarks/): the four entry points at their own full-width
   V2-Lite expert shapes with the launch counts set to 0 just before, then
   each probe kernel against its plain version (P4-P8 exactly: the stream
   floor, the two unpack forms, the s4 and s8 int4 products, the int4
   view; K3 and K5 at T 1 and T 8; the grouped probe forms within 2e-2),
   K4 / K7 at 256 and 512 rows against 128 rows bit for bit (P3's full
   term is K7's own launch), and two negative controls (a stream plain
   version without one pick, a 128-row plan with one tile's expert
   changed) the checks must refuse; K7a with int4 rows at V2-Lite's w13
   and w2 (w2's K/2 = 704 cuts a group of 128) on the 128-row plan.

9. checkpoints from disk: DeepSeek-V2-Lite in bf16 safetensors (3 layers,
   every width, 3.34 GB in 2 shards) and GPT-OSS-20B in its MXFP4 layout
   (2 layers, 3.27 GB), written from a seed into a temporary directory that
   also holds the weight cache ($KRASIS_TPU_HOME, removed at the end); for
   each: ModelConfig.from_model_path (fields that differ from the preset
   printed), load_params with an empty cache (the build, quantized on the
   card) and again (the hit), timed, every leaf of the hit equal to the
   build's, the head, every layer's non-expert leaves, experts 0, the last
   and two seeded ones of every MoE layer, the folded virtual experts and
   the MXFP4 decode bit-equal to the port's CPU load; the quantizer's
   division on the checkpoint's tensors (ROADMAP C-5); a 2048 + 16 greedy
   request on each load through Engine.generate (finite, no plain MoE form,
   K1-K4 for V2-Lite and K1, K2, K6, K7 for GPT-OSS launched, the same
   tokens); then the division on f32 inputs, and the GGUF codecs on the
   card against the CPU bit for bit. Phase 10 (a)'s two servers, phase
   13 (c)'s, the launcher and the suite (16 (c), (d)) run as processes of
   their own beside phase 9 (serve_beside), so the rates phase 9 prints are
   taken beside them.

10. serving (krasis_tpu_torch/server.py): (b) inside phase 9, the V2-Lite
   checkpoint's engine with the committed test tokenizer
   (tests/data/torch_tokenizer, copied into the checkpoint) served in this
   process through start_temp_server on the native and then the stdlib
   transport: a chat message that templates to about 2048 ids and a short
   one (16 greedy tokens each, logprobs) and the short one with 64, streamed
   and in turns with direct generate calls; usage.prompt_tokens must equal
   the template's length, the served text and logprobs Engine.generate's on
   the same ids, and the served requests must launch K1, K2 (one-launch and
   split), K3 and K4 with no plain MoE route; (a) beside phase 9, python -m
   krasis_tpu_torch.cli serve --synthetic deepseek-v2-lite (27 layers, int4
   gs 128, int8 expert activations; part of the flags from a config file,
   16 (b)) on the native transport as a subprocess: /health,
   /v1/models, a 404, a 512-id prompt + 32 greedy tokens unstreamed and
   streamed (the same ids, logprobs, usage), a stop string across two
   tokens that ends a stream where it first occurs, a stream the client drops (the next request must be
   answered in about its own time), two concurrent requests (both answered,
   one after the other), then SIGTERM and exit 0. The [serve] lines give the
   role and first content chunk times and the served prefill / decode tok/s
   beside a direct Engine.generate's.

11. continuous batching (krasis_tpu_torch/runtime/scheduler.py), at the end
   of phase 4 on its V2-Lite Q4 engine (27 layers, int8 expert activations,
   max_len 4096): (a) K1 on the lm_head at T = 4 and 8, K3 at T = 2 and 4,
   K2's split form at B = 4 with kv_len 40 / 600 / 2048 / 2560 over bf16 and
   e4m3 (and a row past the cache end, ROADMAP C-7), K4 at decode T = 8 (64
   picks), each against its plain version and each row against the row run
   alone; decode blocks of 1, 4 and 8 busy slots run directly (launches a
   step, aggregate tok/s beside Engine.generate's, a profile of one 4-slot
   block); (b) a 4-slot BatchScheduler: six requests at once (40, 512, 2048,
   2500, 40, 600 ids, 8 greedy tokens), a 3000-id request cancelled after
   its first chunk, the next request, and a turn that extends it (prefix
   reuse); (d) that scheduler served on the native transport, four streams
   one at a time and then at once; (c) an 8-slot scheduler, eight 40 + 8
   requests, whose decode runs K4 and no K3. Each stream is held to the
   same request run alone on the same shapes (batch-1 prefill, then decode
   over as many cache rows as the scheduler has slots): equal up to a first
   divergence, accepted only under a 0.02-nat top-two gap, logprobs before
   it within 2e-2; (b)'s six are also compared with the batch-1
   Engine.generate (reported). Phase 3 also runs its tiny hybrid
   through a 2-slot scheduler on the card against Engine.generate on the
   CPU.

12. speculative decoding (krasis_tpu_torch/models/mtp.py, spec_ngram.py):
   (a) after phase 3, a tiny V2-Lite with an MTP module at k = 1 and 3 and
   the tiny hybrid under prompt lookup at k = 3 through Engine.generate and
   a 2-slot BatchScheduler on the card, each stream held to the CPU's
   vanilla stream (gap and logprob 5e-2); (b) K2's split form at the verify
   shapes Sq = 2 and 4 (kv_len 40, 600, 2560; V2-Lite's MLA over bf16 and
   e4m3, the hybrid's GQA), the window's later keys scaled so that a control
   without the in-window causal mask must be refused; K1s at T = 4 on the
   hybrid's six projections and K3 at its T = 4; (c) after phase 11, a
   synthetic MTP module at V2-Lite's widths on phase 4's weights (V2-Lite's
   checkpoint has none): forced acceptance and rejection at k = 1 and 3
   through the engine's own verify block (commit k + 1, but at a near-tie,
   and 1; the cache lengths; each committed token the verify argmax), each
   committed position teacher-forced against the batch-1 decode at the batch
   phase's limits; launches a verify step and one profiled verify block; 2048 + 16
   and 40 + 16 at k = 1 and 3 and prompt lookup on a 200-id block repeated
   four times + 32, each beside the vanilla path; 4-slot schedulers under
   MTP k = 1 and prompt lookup k = 3 with six requests each, every stream
   teacher-forced at the scheduler's shapes; one request through the
   in-process server, whose answer carries timing.spec; (d) after phase 5,
   prompt lookup on the hybrid (40 + 16, the repeated block + 16) with
   every DeltaNet commit held to the recurrence over the committed prefix,
   and the forced controls at k = 3.

13. the host-RAM expert offload tier (krasis_tpu_torch/offload.py,
   runtime/offload_engine.py, native/hostmoe.cpp): (d) first, the host's
   memory and CPUs and format_budget of Qwen3-235B at Q4 (resident bytes
   and the offload split); (a) after phase 3, tiny V2-Lite, Qwen3-MoE,
   hybrid and GPT-OSS OffloadEngines on the card (streamed prefill, n_hot
   0, half and all) against the same engines on the CPU through the plain
   versions, at phase 3's rule; (b) after phase 12, on phase 4's V2-Lite
   weights copied into a pinned host store (7.42 GB): the host engine
   against its plain version, K4 on a streamed slot and K5 on a 16-expert
   hot substack with masked picks, each MoE layer's offloaded sublayer
   against the plain gathered MoE, the streamed prefill of 2048 and 2500
   ids against the resident one, requests at n_hot 0, 16 (after
   update_hot_cache) and 64 with their launch counts, a profiled decode,
   device bytes, and a 2-slot offloaded BatchScheduler teacher-forced
   (``offload_phase``); (c) after phase 10's servers, python -m
   krasis_tpu_torch.server --offload experts --hot-experts 16 as a
   subprocess (phase 10a's requests); phase 10a's first server must log
   that --offload auto kept V2-Lite resident.

14. the measurement entry points (krasis_tpu_torch/benchmark.py, prompts.py,
   quality.py, perplexity.py), after phase 13 (b) on phase 4's V2-Lite Q4
   weights (``measure_phase``): (a) run_engine_benchmark at 2048 and 8192
   corpus ids and 3 x 32 decode tokens, [bench] lines with median, IQR and
   flagged runs, and K2's chunk at q_off 6144 against its plain version;
   (b) run_network_benchmark on both transports, whose streamed chunks must
   equal the engine's tokens; (c) run_slots_benchmark at 1 and 4 slots;
   (d) the quality matrix on the card (a tiny Qwen3-MoE trained there from
   the corpus with a byte-level BPE trained there too, an MTP head, during
   phase 2), eight modes' prefill PPL each within 1e-2 of the CPU plain
   path (its matrix a process of its own from phase 4 on), the bf16
   forced decode against its prefill log-probabilities, exact ngram and MTP
   spec, no plain MoE form in a quantized mode; verdicts printed.
   ``python tools/measure_phases.py`` runs it alone and then the full
   protocols.

15. the device mesh (krasis_tpu_torch/parallel/), after phase 14 on phase
   4's V2-Lite Q4 weights (``mesh_phase``), its shards on distinct cards
   where the host has them, else all on the first card (the device list is
   printed): (a) a dp 1 x ep 2 mesh engine (32 experts a shard, 8 of 16
   MLA heads a shard, the shared experts dense): a 2048-id prefill's
   last-position logits within 3e-2 of the unsharded engine's with the
   same argmax, generate(2048, 16) with the launch counts (K1, K2's two
   forms, K3, K4; no plain MoE form), its decode teacher-forced against
   the unsharded decode from one state, K1 / K2 / K3 / K4 at the shard
   shapes against their plain versions (bounds over the live picks), and
   one decode step profiled on both; (b) PP 2, SP 2 and SP 2 x EP 2 on a
   512-id prefill against the unsharded logits; (c) a BatchScheduler on a
   dp 2 x ep 2 mesh, 4 slots: three requests of + 8 tokens and a cancel,
   each stream teacher-forced against the mesh engine; (d) a request
   through the server's handler over the mesh engine, and --mesh 1,2
   refused by the number of devices on a one-card host.
   ``python tools/mesh_phases.py`` runs it alone.

16. the tooling entry points (krasis_tpu_torch/cli.py, syscheck.py,
   runlog.py, tracing.py, the timing flags, stress_test.py, suite.py,
   fused_moe.py, auto_optimise.py, launcher.py), after phase 15 on phase
   4's V2-Lite Q4 engine (``tooling_phase``): (a) cli check names the card
   and its memory, run_startup_checks accepts V2-Lite Q4 and refuses
   Qwen3-235B at Q4 resident and, with offload, against the host's RAM, and
   cli budget runs without --hbm-gb; (e) KrasisTpuMoE on one layer's 64
   experts at T = 1 (K5) and 2048 (K4), a third of the picks masked with -1,
   and forward_routed from the layer's gate, within 3e-2 of the plain
   gathered / ragged forms, no plain route; (f) capture_trace around a
   40 + 8 request under annotate("prefill") / annotate("decode"): the trace
   names both and K1, K2 (one-launch and split), K3 and K4; (g)
   KRASIS_TPU_DIAG: one [diag] line a layer in layer order, finite; (i)
   auto_optimise over decode blocks 8 and 16, the winner set on a fresh
   engine by apply_tuning. Beside phase 9: (h) the stress battery, in a
   process of its own on phase 4's engine built again from seed 0 (prompts
   and the sampling sweep at 8 tokens, the contract edges on an engine at
   max_len 160, the scheduler churn: 8 requests of 32 tokens on 4 slots,
   one cancelled), holding what holds whatever the weights (determinism,
   logprobs, the stop token, the room, the streams, the cancel) and
   printing the degeneracy verdicts; (b) phase 10 (a)'s two servers start as
   python -m krasis_tpu_torch.cli serve in one working directory, from a
   --config file with one flag overridden on the command line, --note and
   --min-free-ram-gb 2; the run log must begin with the second's note, hold
   the file's values and the override, and the first's be archived under
   logs/; (c) cli launch --non-interactive serves the phase 9 V2-Lite
   checkpoint named by its config_torch, answers a chat request and stops
   with its server on SIGTERM; (d) python -m krasis_tpu_torch.suite runs
   one combo (the tiny Qwen3-MoE on the card), its row rc 0 with numbers.
   ``python tools/tooling_phases.py`` runs it alone.

In every family every logit must be finite and every kernel (and K2 form)
of the path must have been launched by the requests. The last two lines are the card's
name and power limit and the JSON result; the line before them lists the
kernels.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12             # dense tensor-core rates, H100 SXM data sheet
PEAK_INT8 = 1979e12
PEAK_CUDA_CORES = 67e12        # f32 outside the tensor cores; the probes' integer adds run there


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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


def check_kernel(results, name, counter, replaces, run_kernel, run_plain, run_library,
                 tol, nbytes, ops, peak, iters, flush, select=None, device_name=None,
                 calls=20, source=None):
    """Hold one kernel to its plain version and time both; tol 0 asks for
    equality. `counter` is the (module, attribute) of the wrapper's launch
    count, filled in later from the main path's run; `source` the kernel's
    file where it is not the counter module's SOURCE. With `device_name`,
    the kernel's device time per call (over `calls` calls) and the kernels
    a call launches are taken from the profiler too."""
    import torch
    from krasis_tpu_torch.timing import device_per_call, timeit_ms

    module = counter[0]
    got, want = run_kernel(), run_plain()
    if select is not None:
        got, want = select(got), select(want)
    if tol == 0:
        err = float((got.to(torch.float64) - want.to(torch.float64)).abs().max())
        ratio = 0.0 if torch.equal(got, want) else float("inf")
    else:
        err, ratio = max_err(got, want, tol)
    ms = timeit_ms(run_kernel, iters, flush)
    plain_ms = timeit_ms(run_plain, max(2, iters // 10), flush)
    lib_ms = timeit_ms(run_library, iters, flush) if run_library else None
    b_ms, b_by = bound(nbytes, ops, peak)
    res = {"name": name, "route": "cuda", "source": source or module.SOURCE, "replaces": replaces,
           "launches": None, "max_abs_err": err, "max_abs_diff": err, "tol": tol,
           "err_over_limit": ratio,
           "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by}
    device = ""
    if device_name is not None:
        us, per_call, whole = device_per_call(run_kernel, device_name, flush, calls)
        res.update(device_us=us, kernels_per_call=per_call, profile_whole=whole)
        device = (f" device {us:.2f} us a call (profiler), {per_call:g} kernels a call"
                  + ("" if whole else " (from a profile that missed launches)"))
    print(f"[kernel] {name}: max|Δ| {err:.3g}, {ratio:.3g} of the limit (tol {tol}) kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} ms library {lib_ms} ms bound {b_ms:.4f} ms ({b_by}){device}",
          flush=True)
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    results.append((counter, res))


def reference_phase(label, cfg, quant, tol, prepare=None, launched=()):
    """A tiny model: kernels on the card against plain versions on the CPU.
    A model-level check, as the CPU tests hold the port to the JAX package:
    bf16 rounding differences compound over the layers, so the limit is
    `tol` of the larger of 1 and the largest logit. `prepare` edits the
    CPU parameters before they are copied to the card; each kernel named in
    `launched` must have been launched by the card's run."""
    import torch
    from krasis_tpu_torch.models.model import forward
    from krasis_tpu_torch.models.params import init_synthetic_params
    from krasis_tpu_torch.runtime.kv_cache import init_cache

    cpu = init_synthetic_params(cfg, quant, seed=1, device="cpu")
    if prepare is not None:
        prepare(cpu)
    C = counters()
    for m, attr in C.values():
        setattr(m, attr, 0)

    gpu = to_device(cpu, "cuda")
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
    counts = {name: getattr(*C[name]) for name in launched}
    print(f"[reference] {label} on the card vs the CPU plain path: max|Δ| logits {worst:.3g} "
          f"({worst_rel:.3g} of their rms, limit {tol})"
          + (f"; launches {json.dumps(counts)}" if counts else ""), flush=True)
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{label}: {name} was never launched on the card")


def lift_four(params):
    """Each GPT-OSS layer's router logit bias lifts 4 of 8 experts by 8
    above the others (the logits span about ±0.8), so the pick set cannot
    sit on a near-tie that two devices' summation orders would break
    differently; random expert biases."""
    import torch

    g = torch.Generator().manual_seed(4)
    for lp in params["layers"]:
        lift = torch.tensor([4.0] * 4 + [-4.0] * 4)[torch.randperm(8, generator=g)]
        lp["gate_logit_bias"] = lp["gate_logit_bias"] + lift
        lp["w13_bias"] = (torch.randn(lp["w13_bias"].shape, generator=g) * 0.05).to(
            lp["w13_bias"].dtype)
        lp["w2_bias"] = (torch.randn(lp["w2_bias"].shape, generator=g) * 0.05).to(
            lp["w2_bias"].dtype)


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
    # GPT-OSS over an fp8 cache, window 4 so that the 160-token prefill and
    # the decode steps cut it. Top-4 of 8 experts, so that decode is in the
    # gathered regime, where the biased experts run on K6 with the biases
    # between its launches (prefill: the ragged form on K7, likewise). Each layer's
    # router logit bias lifts 4 experts 8 above the others (the logits span
    # about ±0.8): the pick set cannot sit on a near-tie that the two
    # devices' summation orders would break differently. So every token
    # takes the same 4 experts in a layer here; K6 under picks that change
    # from token to token is held by the biased-chain check of the GPT-OSS
    # phase (random picks a token) and run by its full-width requests.
    reference_phase(
        "tiny GPT-OSS, fp8 cache",
        tiny_config("gpt-oss-20b", num_hidden_layers=4, sliding_window=4,
                    num_experts_per_tok=4),
        QuantConfig(expert_bits=4, group_size=32, kv_cache_dtype="fp8"), 5e-2,
        prepare=lift_four, launched=("K6", "K7"))


def c2_phase():
    """Groups of 16 (ROADMAP C-2): stacks of 4 experts, H 256, I 128, gs 16,
    int4 and int8, through ``moe_forward`` on the card in the five regimes —
    fused int8, two-stage int8, fused bf16, two-stage bf16 (the class
    limits shrunk for the two-stage ones, as the tiny reference models do)
    and grouped (T 64). Each takes the reference's form and runs it on that
    form's kernel (K3, K6a, K5, K6, K4: two launches, the kernels' forms for
    groups of 16 where they have one) and on nothing else, with no call on
    a plain form (``moe.plain_routes``); each result within 3e-2 of the same
    call on the CPU (the plain versions)."""
    import torch
    from krasis_tpu_torch.ops import expert_class, moe
    from krasis_tpu_torch.quant import random_qtensor

    g = torch.Generator().manual_seed(16)
    E, H, I, k = 4, 256, 128, 2
    C = counters()
    regimes = (("fused int8", 1, "int8", False, "fused_int8", "K3"),
               ("two-stage int8", 1, "int8", True, "tiled_int8", "K6a"),
               ("fused bf16", 1, "bf16", False, "fused_bf16", "K5"),
               ("two-stage bf16", 1, "bf16", True, "tiled_bf16", "K6"),
               ("grouped", 64, "bf16", False, "grouped", "K4"))
    limits = expert_class.MAX_FUSED_PICK_BYTES
    for bits in (4, 8):
        w13 = random_qtensor((E, H, 2 * I), bits, 16, g, "cpu", scale_mag=0.03)
        w2 = random_qtensor((E, I, H), bits, 16, g, "cpu", scale_mag=0.03)
        cw13, cw2 = w13.to("cuda"), w2.to("cuda")
        for label, T, act, two_stage, form, kernel in regimes:
            x = torch.randn((T, H), generator=g).to(torch.bfloat16)
            idx = torch.rand((T, E), generator=g).topk(k, dim=-1).indices.to(torch.int32)
            wts = torch.rand((T, k), generator=g)
            if two_stage:
                expert_class.MAX_FUSED_PICK_BYTES = 1024
            try:
                r = moe.route(x.cuda(), cw13, cw2, idx.cuda(), False, act)
                if r != form:
                    raise AssertionError(f"C-2 int{bits} {label}: form {r}, want {form}")
                for m, attr in C.values():
                    setattr(m, attr, 0)
                moe.plain_routes.update(ragged_plain=0, gathered_plain=0)
                got = moe.moe_forward(x.cuda(), cw13, cw2, idx.cuda(), wts.cuda(),
                                      activation=act)
                torch.cuda.synchronize()
                launched = {name: getattr(m, attr) for name, (m, attr) in C.items()
                            if getattr(m, attr)}
                plain_routes = dict(moe.plain_routes)
                want = moe.moe_forward(x, w13, w2, idx, wts, activation=act)
            finally:
                expert_class.MAX_FUSED_PICK_BYTES = limits
            err, ratio = max_err(got.cpu(), want, 3e-2)
            print(f"[c2] gs 16, int{bits}, {label}: form {r}; launches {json.dumps(launched)}, "
                  f"plain routes {json.dumps(plain_routes)}; card vs CPU max|Δ| {err:.3g}, "
                  f"{ratio:.3g} of the limit (tol 3e-2)", flush=True)
            if not ratio <= 1.0:
                raise AssertionError(f"C-2 int{bits} {label}: the card disagrees with the CPU")
            if launched != {kernel: 2} or any(plain_routes.values()):
                raise AssertionError(f"C-2 int{bits} {label}: launches {launched}, plain "
                                     f"routes {plain_routes}, want {{{kernel!r}: 2}} only")


def c3_phase():
    """ROADMAP C-3: moe_prefill(activation="int8") on gs-16 stacks (4
    experts, H 256, I 128, int4, T 64) takes the reference's int8 form on
    the card: two K7a launches and no K4 or K7, within 3e-2 of the same call
    on the CPU (its plain version)."""
    import torch
    from krasis_tpu_torch.ops import gmm_cuda
    from krasis_tpu_torch.quant import random_qtensor

    g = torch.Generator().manual_seed(13)
    E, H, I, T, k = 4, 256, 128, 64, 2
    w13 = random_qtensor((E, H, 2 * I), 4, 16, g, "cpu", scale_mag=0.03)
    w2 = random_qtensor((E, I, H), 4, 16, g, "cpu", scale_mag=0.03)
    x = torch.randn((T, H), generator=g).to(torch.bfloat16)
    idx = torch.rand((T, E), generator=g).topk(k, dim=-1).indices.to(torch.int32)
    wts = torch.rand((T, k), generator=g)
    C = counters()
    for m, attr in C.values():
        setattr(m, attr, 0)
    got = gmm_cuda.moe_prefill(x.cuda(), w13.to("cuda"), w2.to("cuda"), idx.cuda(), wts.cuda(),
                               activation="int8")
    torch.cuda.synchronize()
    launched = {name: getattr(m, attr) for name, (m, attr) in C.items() if getattr(m, attr)}
    want = gmm_cuda.moe_prefill(x, w13, w2, idx, wts, activation="int8")
    err, ratio = max_err(got.cpu(), want, 3e-2)
    print(f"[c3] gs 16, int4, moe_prefill(activation=\"int8\"), T {T}: launches "
          f"{json.dumps(launched)}; card vs CPU max|Δ| {err:.3g}, {ratio:.3g} of the limit "
          "(tol 3e-2)", flush=True)
    if launched != {"K7a": 2}:
        raise AssertionError(f"C-3: launches {launched}, want {{'K7a': 2}} only")
    if not ratio <= 1.0:
        raise AssertionError("C-3: the card disagrees with the CPU")


def counters():
    """The launch count of each kernel: (module, attribute)."""
    from krasis_tpu_torch.ops import flash_attention, gmm_cuda, moe_cuda, qmm_cuda
    return {"K1": (qmm_cuda, "launches"), "K1s": (qmm_cuda, "launches_stacked"),
            "K2": (flash_attention, "launches"), "K3": (moe_cuda, "launches"),
            "K4": (gmm_cuda, "launches"), "K5": (moe_cuda, "launches_bf16"),
            "K6": (moe_cuda, "launches_gq"), "K6a": (moe_cuda, "launches_gq_a8"),
            "K6a product": (moe_cuda, "launches_gq_a8_product"),
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
                     g, flush, fp8=False, cases=None):
    """K2 at the main path's shapes: a 2048-row prefill, a 452-row chunk
    over 2048 rows of history (one launch each), and decode at kv_len 2560,
    2500 and 40 over the engine's 4096-row cache view (split-KV: two
    launches); with `fp8`, each again over the cache cast to e4m3, which
    must equal K2 over that cache cast back to bf16 bit for bit. `lanes` of
    the Dp-wide rows are real, the rest zero pad, and the scores run over
    the real lanes as on the main path. Keys and values are unit-scale
    rows, as normed keys are, and queries have std `q_std`, chosen so that
    the scores' std is about 3: the softmax is then peaked and the outputs
    O(1), so a masking fault moves them well past the limit. With flat
    scores the outputs are sums that nearly cancel, and the bf16 rounding
    of p alone (taken against the running maximum in the kernel, the final
    one in the plain version) reaches the limit."""
    import torch
    import torch.nn.functional as F
    from krasis_tpu_torch.ops import flash_attention as fa
    from krasis_tpu_torch.runtime.kv_cache import to_cache

    dev = flush.device
    G = Hq // Hkv

    def rows(shape, std=1.0):
        t = torch.zeros(shape[:-1] + (Dp,), dtype=torch.bfloat16, device=dev)
        t[..., :lanes] = (std * torch.randn(shape[:-1] + (lanes,), generator=g, device=dev)
                          ).to(torch.bfloat16)
        return t

    S_cache = max([4096] + [case[4] for case in cases or ()])
    k_cache = rows((1, Hkv, S_cache, lanes))
    v_cache = rows((1, Hkv, S_cache, lanes)) if separate_v else None
    caches = [("", k_cache, v_cache)]
    if fp8:
        caches.append((":fp8", to_cache(k_cache, torch.float8_e4m3fn),
                       None if v_cache is None else to_cache(v_cache, torch.float8_e4m3fn)))
    cases = cases or [("attention:prefill_2048", 2048, 0, 2048, 2048, fa.REPLACES),
             ("attention:chunk_452_at_2048", 452, 2048, 2500, 2500, fa.REPLACES),
             ("attention:decode_kv_2560", 1, 2559, 2560, 4096, fa.REPLACES_DECODE),
             ("attention:decode_kv_2500", 1, 2499, 2500, 4096, fa.REPLACES_DECODE),
             ("attention:decode_kv_40", 1, 39, 40, 4096, fa.REPLACES_DECODE)]
    for suffix, k_all, v_all in caches:
        elem = k_all.element_size()
        for name, sq, q_off, kv_len, view, replaces, *boost in cases:
            q = rows((1, sq, Hq, lanes), q_std)
            kv = k_all[:, :, :view]
            if boost:
                # a verify window: its keys after the first query scaled by
                # `boost` (scores of std ~13), so that a query seeing them
                # against the causal mask moves far off
                kv = kv.clone()
                win = slice(kv_len - sq + 1, kv_len)
                kv[:, :, win] = (kv[:, :, win].to(torch.bfloat16) * boost[0]).to(kv.dtype)
            v = v_all[:, :, :view] if separate_v else None
            qo = torch.tensor([q_off], dtype=torch.int32, device=dev)
            kl = torch.tensor([kv_len], dtype=torch.int32, device=dev)

            def per_q_head(t):                               # [1, Hkv, S, D] → [1, Hq, S, D]
                return t[:, :, None].expand(1, Hkv, G, kv_len, t.shape[-1]).reshape(
                    1, Hq, kv_len, t.shape[-1]).to(torch.bfloat16)

            qh, kh = q.transpose(1, 2), per_q_head(kv[:, :, :kv_len])
            vh = per_q_head((kv if v is None else v)[:, :, :kv_len])[..., :v_dim]
            pos = q_off + torch.arange(sq, device=dev)
            mask = torch.arange(kv_len, device=dev)[None, :] <= pos[:, None]
            visible = int(mask.sum())
            # the function needs the real lanes; the zero pad to Dp is not work
            nbytes = sq * Hq * lanes * 2 + kv_len * Hkv * lanes * elem + sq * Hq * v_dim * 2
            if separate_v:
                nbytes += kv_len * Hkv * v_dim * elem
            ops = 2 * Hq * visible * (lanes + v_dim)
            run = (lambda: fa.flash_attention(q, kv, qo, kl, scale, v_dim, v=v, qk_dim=lanes))
            check_kernel(results, prefix + name + suffix, counters()["K2"], replaces, run,
                         lambda: fa.flash_attention_plain(q, kv, qo, kl, scale, v_dim, v, lanes),
                         lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                                scale=scale),
                         2e-2, nbytes, ops, PEAK_BF16, 20 if sq > 1 else 50, flush)
            results[-1][1]["form"] = fa.form_name(sq * G <= fa.MAX_SPLIT_ROWS, 0, False,
                                                  bool(suffix))
            if suffix:
                wide = fa.flash_attention(q, kv.to(torch.bfloat16), qo, kl, scale, v_dim,
                                          v=None if v is None else v.to(torch.bfloat16),
                                          qk_dim=lanes)
                if not torch.equal(run(), wide):
                    raise AssertionError(f"{prefix}{name}{suffix}: K2 over the e4m3 cache "
                                         "differs from K2 over it cast to bf16")
                continue
            if kv_len == 2560 and sq == 1:
                # the same check must refuse a combine that lost the split holding
                # each row's largest score
                chunk, n = fa.split_plan(view, Hkv, 1, torch.cuda.get_device_properties(dev)
                                         .multi_processor_count)
                o, m, l = fa.decode_split_plain(q, kv, qo, kl, scale, v_dim, chunk, v, lanes)
                dropped = m.clone().scatter_(2, m.argmax(dim=2, keepdim=True), fa.NEG_INF)
                _, fault = max_err(fa._unstack(fa.decode_combine_plain(o, dropped, l), 1),
                                   fa.flash_attention_plain(q, kv, qo, kl, scale, v_dim, v,
                                                            lanes), 2e-2)
                live = -(-kv_len // chunk)
                print(f"[kernel] {prefix}{name}: {n} splits of {chunk} rows ({live} before "
                      f"kv_len); a combine without one split reads {fault:.3g} of the limit; "
                      f"combine bound {live * Hq * v_dim * 4 / HBM_BYTES_S * 1e3:.5f} ms (bytes)",
                      flush=True)
                if not fault > 1.0:
                    raise AssertionError(f"{prefix}{name}: the check cannot see a dropped split")
            if sq > 1:
                # the same check must refuse a kernel that dropped the causal mask
                _, fault = max_err(fa.flash_attention_plain(q, kv, kl - 1, kl, scale, v_dim, v=v),
                                   fa.flash_attention_plain(q, kv, qo, kl, scale, v_dim, v=v),
                                   2e-2)
                print(f"[kernel] {prefix}{name}: without the causal mask the check reads "
                      f"{fault:.3g} of the limit", flush=True)
                if not fault > 1.0:
                    raise AssertionError(f"{prefix}{name}: the check cannot see a dropped "
                                         "causal mask")


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


# K3 and its plain version take the same rounding points in the same order,
# so no more than a last bf16 bit (at most 2^-7 of |want|) may part them:
# K3's limit sits just above that. The reference's 3e-2 for the MoE kernels
# would not see the synthetic hybrid's shared expert dropped (0.796 of it).
# K6a's chain runs on K3's core and is held to the same limit.
K3_TOL = 1e-2


def core_checks(results, name, counter, kernels, replaces, run, plain, wts, nbytes, ops,
                flush, iters=50, controls=None, tol=K3_TOL, peak=PEAK_INT8, source=None):
    """A two-kernel decode MoE call (K3, K6a's chain, or K5 with `tol`
    3e-2, `peak` bf16 and its `source`) against its plain version, `run(w)`
    and `plain(w)` on routing weights w, with device time from the
    profiler; a call must launch exactly the two device kernels named
    `kernels` and repeat bit for bit, and the check must refuse the plain
    version with any one pick's routing weight set to 0 (the folded shared
    experts among them). `controls` lists (weights, picks): the picks
    dropped from run(weights), by default every pick of `wts`."""
    import torch
    from krasis_tpu_torch.ops import moe_cuda

    check_kernel(results, name, counter, replaces, lambda: run(wts), lambda: plain(wts), None,
                 tol, nbytes, ops, peak, iters, flush, device_name=kernels, calls=10,
                 source=source or moe_cuda.SOURCE_W4A8)
    res = results[-1][1]
    if res["kernels_per_call"] != 2:
        raise AssertionError(f"{name}: a call launched {res['kernels_per_call']} device "
                             "kernels, not 2")
    got = run(wts)
    res["bit_equal_repeat"] = torch.equal(got, run(wts))
    if not res["bit_equal_repeat"]:
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    ratios = [None] * wts.shape[1]
    for w, picks in controls or [(wts, range(wts.shape[1]))]:
        got = run(w)
        for j in picks:
            dropped = w.clone()
            dropped[:, j] = 0
            ratios[j] = max_err(got, plain(dropped), tol)[1]
    res["dropped_pick_over_limit"] = ratios
    tried = [r for r in ratios if r is not None]         # picks a control dropped
    low = ratios.index(min(tried))
    last = next(r for r in reversed(ratios) if r is not None)
    print(f"[kernel] {name}: two calls equal bit for bit; the plain version with one pick's "
          f"weight set to 0 is {min(tried):.3g} (pick {low}) to "
          f"{max(tried):.3g} of the limit away, the last pick dropped {last:.3g}", flush=True)
    if not min(tried) > 1.0:
        raise AssertionError(f"{name}: the check cannot see pick {low} dropped")


def k3_checks(results, name, x, w13, w2, idx, wts, replaces, nbytes, ops, flush, iters=50):
    """K3 (``moe_w4a8``) through ``core_checks``."""
    from krasis_tpu_torch.ops import moe_cuda

    core_checks(results, name, counters()["K3"], moe_cuda.K3_KERNELS, replaces,
                lambda w: moe_cuda.moe_w4a8(x, w13, w2, idx, w),
                lambda w: moe_cuda.moe_w4a8_plain(x, w13, w2, idx, w), wts, nbytes, ops, flush,
                iters)


def k5_checks(results, name, x, w13, w2, idx, wts, nbytes, ops, flush, n_routed):
    """K5 (``moe_bf16``, two instances of K1's kernel) through
    ``core_checks`` at 3e-2: two device kernels a call, bit-equal repeats,
    no PyTorch cast of the rows or picks, and every one-pick-dropped control
    refused. At 3e-2 a pick of small weight hides in the others, so the
    controls weight the routed picks equally and alone, then the folded
    shared picks (the last P - n_routed) alone."""
    from krasis_tpu_torch.ops import moe_cuda

    P = wts.shape[1]
    routed_only, shared_only = wts.clone(), wts.clone()
    routed_only[:, :n_routed], routed_only[:, n_routed:] = 1.0 / n_routed, 0.0
    shared_only[:, :n_routed] = 0.0
    controls = [(routed_only, range(n_routed))]
    if P > n_routed:
        controls.append((shared_only, range(n_routed, P)))
    casts = moe_cuda.k5_casts
    core_checks(results, name, counters()["K5"], moe_cuda.K5_KERNELS, moe_cuda.REPLACES_BF16,
                lambda w: moe_cuda.moe_bf16(x, w13, w2, idx, w),
                lambda w: moe_cuda.moe_bf16_plain(x, w13, w2, idx, w), wts, nbytes, ops, flush,
                controls=controls, tol=3e-2, peak=PEAK_BF16, source=moe_cuda.SOURCE)
    if moe_cuda.k5_casts != casts:
        raise AssertionError(f"{name}: K5 cast its rows or picks with PyTorch first")


def moe_checks(results, prefix, w13, w2, cfg, g, flush, bf16_too, T=2048):
    """K3 (and K5) at T = 1 with the routed picks plus the folded shared
    experts; K4 at T rows (2048) over the whole stack."""
    import torch
    from krasis_tpu_torch.ops import moe_cuda
    from krasis_tpu_torch.quant import qtensor_bytes

    dev = flush.device
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
    k3_checks(results, prefix + "moe_decode", x, w13, w2, idx, wts, moe_cuda.REPLACES,
              P * per_pick + Hd * 4, decode_ops, flush)
    if bf16_too:
        k5_checks(results, prefix + "moe_decode_bf16", x, w13, w2, idx, wts,
                  P * per_pick + Hd * 4, decode_ops, flush, k)

    x = torch.randn((T, Hd), generator=g, device=dev).to(torch.bfloat16)
    topk = torch.rand((T, E_r), generator=g, device=dev).topk(k, dim=-1).indices.to(torch.int32)
    k4_checks(results, prefix, x, topk, w13, w2, cfg)


def k4_checks(results, prefix, x, topk, w13, w2, cfg, iters=10, pick_valid=None):
    """K4's two launches (w13 with the SwiGLU epilogue, w2 with the f32 one)
    on the main path's tile plan for the picks topk [T, k], against their
    plain versions, with grouped_mm as the yardstick of each product. With
    `pick_valid` (an ep shard's picks) the plan leaves the others out, and
    the bounds count the live picks alone."""
    import torch
    from krasis_tpu_torch.ops import gmm_cuda
    from krasis_tpu_torch.quant import qtensor_bytes

    C = counters()
    E_all = w13.q.shape[0]
    T, k = topk.shape
    Hd, I = cfg.hidden_size, cfg.moe_intermediate_size
    plan = gmm_cuda.plan_tiles(topk, E_all, gmm_cuda.choose_tm(T * k, E_all),
                               pick_valid)                                 # the main path's
    real = plan.row_src >= 0
    live = topk.reshape(-1).long()
    if pick_valid is not None:
        live = live[pick_valid.reshape(-1)]
    M = live.numel()
    hit = int((torch.bincount(live, minlength=E_all) > 0).sum())
    print(f"[kernel] {prefix}gmm: {plan.tm}-row tiles, {int(plan.tile_valid.sum())} of "
          f"{plan.n_tiles} computed, {hit} of {E_all} experts hit", flush=True)
    a_plain = gmm_cuda.gmm_plain(x, plan.row_src, w13, plan, True)
    h_plain = gmm_cuda.gmm_plain(x, plan.row_src, w13, plan, False)[real]
    lib13 = grouped_mm_library(prefix + "gmm:w13 (product alone, no SwiGLU)",
                               x[plan.row_src[real].long()], w13, plan, torch.bfloat16, h_plain)
    del h_plain
    check_kernel(results, prefix + "gmm:w13_swiglu", C["K4"], gmm_cuda.REPLACES,
                 lambda: gmm_cuda.gmm(x, plan.row_src, w13, plan, True),
                 lambda: gmm_cuda.gmm_plain(x, plan.row_src, w13, plan, True),
                 lib13, 3e-2, hit * qtensor_bytes(w13) / E_all + T * Hd * 2 + M * I * 2,
                 2 * M * Hd * 2 * I, PEAK_BF16, iters, None, select=lambda o: o[real])
    o_plain = gmm_cuda.gmm_plain(a_plain, None, w2, plan, False)
    lib2 = grouped_mm_library(prefix + "gmm:w2", a_plain[real], w2, plan, torch.float32,
                              o_plain[real])
    check_kernel(results, prefix + "gmm:w2_f32", C["K4"], gmm_cuda.REPLACES_W2,
                 lambda: gmm_cuda.gmm(a_plain, None, w2, plan, False),
                 lambda: gmm_cuda.gmm_plain(a_plain, None, w2, plan, False),
                 lib2, 3e-2, hit * qtensor_bytes(w2) / E_all + M * I * 2 + M * Hd * 4,
                 2 * M * I * Hd, PEAK_BF16, iters, None, select=lambda o: o[real])


def v2lite_kernel_phase(params, cfg, results, g, flush):
    import torch
    from krasis_tpu_torch.ops.rope import yarn_softmax_scale

    # K1 — qmm at T = 1: the int8 lm_head and the decode dense MLP
    layer0 = params["layers"][0]
    qmm_checks(results, "", (("qmm:lm_head", params["lm_head"], None, torch.float32),
                             ("qmm:mlp_w13", layer0["mlp_w13"], None, torch.bfloat16),
                             ("qmm:mlp_w2", layer0["mlp_w2"], None, torch.bfloat16)), g, flush)
    # K2 — attention over the MLA cache: 16 heads on one [ckv; kpe] row, in
    # bf16 and in e4m3
    L, DR = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    scale = yarn_softmax_scale((cfg.qk_nope_head_dim + DR) ** -0.5, cfg.rope_scaling)
    # score std = scale * sqrt(576) = 3.2 at unit-scale queries
    attention_checks(results, "", cfg.num_attention_heads, 1, L + DR, 640, L, False, scale,
                     1.0, g, flush, fp8=True)
    # K3, K5, K4 — 6 routed picks of 64 plus the 2 folded shared experts
    moe = next(lp for lp in params["layers"] if "w13" in lp)
    moe_checks(results, "", moe["w13"], moe["w2"], cfg, g, flush, bf16_too=True)


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


def k6_checks(results, name, w, rows, idx, flush, mask=None):
    """K6 (``gathered_qmm``, K1's core) against its plain version: one device
    kernel a call, device us from the profiler, the bound over the distinct
    experts' packed weights and scales (rows in, f32 out), and as library
    call ``torch.bmm`` on the picks' weights gathered and dequantized to
    bf16 beforehand; under `mask` it is held again and the skipped picks
    must read back zero."""
    import torch
    from krasis_tpu_torch.ops import moe_cuda
    from krasis_tpu_torch.quant import dequantize, qtensor_bytes

    P, K = rows.shape
    N, E = w.n_dim, w.q.shape[0]
    distinct = int(torch.unique(idx).numel())
    wg = dequantize(w[idx.long()], torch.bfloat16)                     # [P, K, N]
    r3 = rows.to(torch.bfloat16)[:, None, :]
    check_kernel(results, name, counters()["K6"], moe_cuda.REPLACES_GQ,
                 lambda: moe_cuda.gathered_qmm(rows, w, idx),
                 lambda: moe_cuda.gathered_qmm_plain(rows, w, idx), lambda: torch.bmm(r3, wg),
                 2e-2, distinct * qtensor_bytes(w) / E + P * K * 2 + P * N * 4, 2 * P * K * N,
                 PEAK_BF16, 50, flush, device_name="qmm_kernel", calls=10,
                 source=moe_cuda.SOURCE_GQ)
    del wg
    res = results[-1][1]
    res["picks"], res["experts"] = P, distinct
    if res["kernels_per_call"] != 1:
        raise AssertionError(f"{name}: a call launched {res['kernels_per_call']} device "
                             "kernels, not 1")
    if mask is not None:
        got = moe_cuda.gathered_qmm(rows, w, idx, mask)
        err, ratio = max_err(got, moe_cuda.gathered_qmm_plain(rows, w, idx, mask), 2e-2)
        print(f"[kernel] {name} with pick_valid: max|Δ| {err:.3g}, {ratio:.3g} of the limit",
              flush=True)
        if not ratio <= 1.0 or bool(got[mask == 0].any()) or not bool(got[mask == 1].any()):
            raise AssertionError(f"{name}: under pick_valid the kernel disagrees, or a skipped "
                                 "pick does not read back zero")


def gptoss_moe_checks(results, params, cfg, g, flush):
    """GPT-OSS-20B's biased experts on layer 0's stacks (32 experts, H and I
    2880, int4 gs 32): K6 at T = 1 (4 picks) and T = 2 (8 picks) on w13 and
    on w2 (its 2880 columns end in a 64-column tile), each also under a
    pick_valid mask; the biased chain (``moe_gathered_tiled`` with biases)
    against the plain ``moe_forward_gathered`` within 3e-2, with seeded
    nonzero biases of half the size of h and of a pick's output (the
    synthetic biases are zero), and controls the check must refuse: the
    w13 bias dropped, the w2 bias dropped, each pick dropped in turn; then
    one layer's decode MoE device time, plain path and chain, in turns."""
    import torch
    from krasis_tpu_torch.ops import moe, moe_cuda
    from krasis_tpu_torch.ops.activations import swiglu
    from krasis_tpu_torch.timing import device_per_call

    dev = flush.device
    lp = params["layers"][0]
    w13, w2 = lp["w13"], lp["w2"]
    E, k, Hd, I = cfg.n_routed_experts, cfg.num_experts_per_tok, cfg.hidden_size, w2.k_dim
    lim, bf16 = cfg.swiglu_limit, torch.bfloat16
    x = torch.randn((2, Hd), generator=g, device=dev).to(bf16)
    picks = torch.randperm(E, generator=g, device=dev)[:2 * k].to(torch.int32).reshape(2, k)
    for T in (1, 2):
        idx = picks[:T].reshape(-1)
        rows = x[:T].repeat_interleave(k, dim=0)
        a = swiglu(moe_cuda.gathered_qmm_plain(rows, w13, idx).to(bf16), lim, True)
        mask = torch.ones(T * k, dtype=torch.int32, device=dev)
        mask[[1, T * k - 2]] = 0
        for name, w, r in (("w13", w13, rows), ("w2", w2, a)):
            k6_checks(results, f"gptoss/gathered_qmm:{name} T={T}", w, r, idx, flush, mask)

    # the biased chain at T = 1
    x1, idx1 = x[:1], picks[:1]
    wts = torch.rand((1, k), generator=g, device=dev) + 0.5
    wts = wts / wts.sum()
    eids = idx1.reshape(-1).long()
    h = moe_cuda.gathered_qmm_plain(x1.repeat_interleave(k, dim=0), w13, idx1.reshape(-1))
    b13 = (torch.randn((E, 2 * I), generator=g, device=dev) * 0.5
           * h.square().mean().sqrt()).to(lp["w13_bias"].dtype)
    a = swiglu(h.to(bf16) + b13[eids].to(bf16), lim, True)
    o = moe_cuda.gathered_qmm_plain(a, w2, idx1.reshape(-1))
    b2 = (torch.randn((E, Hd), generator=g, device=dev) * 0.5
          * o.square().mean().sqrt()).to(lp["w2_bias"].dtype)

    def chain(bias13=b13, bias2=b2, w=wts):
        return moe_cuda.moe_gathered_tiled(x1, w13, w2, idx1, w, lim, True, w13_bias=bias13,
                                           w2_bias=bias2)

    def plain(bias13=b13, bias2=b2, w=wts):
        return moe.moe_forward_gathered(x1, w13, w2, idx1, w, lim, True, w13_bias=bias13,
                                        w2_bias=bias2)

    C = counters()
    before = getattr(*C["K6"])
    got = chain()
    if getattr(*C["K6"]) != before + 2:
        raise AssertionError("gptoss/moe biased chain: not two K6 launches a call")
    err, ratio = max_err(got, plain(), 3e-2)
    controls = {"w13 bias dropped": plain(bias13=None), "w2 bias dropped": plain(bias2=None)}
    for j in range(k):
        w = wts.clone()
        w[:, j] = 0
        controls[f"pick {j} dropped"] = plain(w=w)
    refused = {c: max_err(got, want, 3e-2)[1] for c, want in controls.items()}
    print(f"[moe] gptoss biased chain (two K6 launches, biases between) against "
          f"moe_forward_gathered: max|Δ| {err:.3g}, {ratio:.3g} of the limit (tol 3e-2); "
          f"controls, fraction of the limit: "
          + ", ".join(f"{c} {v:.3g}" for c, v in refused.items()), flush=True)
    if not ratio <= 1.0:
        raise AssertionError("gptoss/moe: the biased chain disagrees with moe_forward_gathered")
    missed = [c for c, v in refused.items() if not v > 1.0]
    if missed:
        raise AssertionError(f"gptoss/moe: the check cannot see {missed}")

    # one decode MoE layer's device time, the plain path against the chain,
    # in turns (plain, chain, chain, plain); L2 is not flushed
    times = {"plain": [], "chain": []}
    for which in ("plain", "chain", "chain", "plain"):
        us, n, whole = device_per_call(plain if which == "plain" else chain, "", None, calls=5)
        times[which].append((round(us, 2), n, whole))
    print("[moe] " + json.dumps({"model": "gpt-oss-20b", "decode MoE layer":
                                 f"T=1, {k} of {E} picks, biases", "device us, kernels a call, whole": times}),
          flush=True)
    gptoss_grouped_checks(results, lp, cfg, g, flush)


def gptoss_grouped_checks(results, lp, cfg, g, flush):
    """GPT-OSS-20B's biased experts in the grouped regime (prefill) on one
    layer's stacks: K7 on w13 [32, 2880, 5760] and on w2 [32, 2880, 2880]
    (its last column CTA holds 64 live columns of 128) against gmm_plain
    within 2e-2, on plans from the layer's own router at T = 2048 (128-row
    tiles), 452 and 40 (64-row tiles), each again under a pick_valid mask,
    with device us a call and grouped_mm's bf16-out product as a yardstick
    (grouped_mm refuses f32 output); the biased chain (``moe_prefill`` with
    the biases: two K7 launches, the biases between) against the plain
    ``moe_forward_ragged`` within 3e-2 at T = 2048 and 40, with seeded
    nonzero biases of half the size of h and of a pick's output, and
    controls the check must refuse: the w13 bias dropped, the w2 bias
    dropped, the biases indexed by each tile's neighbour's expert (tile_e
    rolled by one); then one layer's prefill MoE device time, plain path
    and chain in turns, at T = 2048 and 40."""
    import torch
    from krasis_tpu_torch.ops import gmm_cuda, moe
    from krasis_tpu_torch.ops.activations import swiglu
    from krasis_tpu_torch.ops.norm import rms_norm
    from krasis_tpu_torch.ops.routing import compute_routing
    from krasis_tpu_torch.quant import qtensor_bytes
    from krasis_tpu_torch.timing import device_per_call, timeit_ms

    dev = flush.device
    C = counters()
    w13, w2 = lp["w13"], lp["w2"]
    E, k, Hd, I = cfg.n_routed_experts, cfg.num_experts_per_tok, cfg.hidden_size, w2.k_dim
    lim, bf16 = cfg.swiglu_limit, torch.bfloat16
    e13, e2 = qtensor_bytes(w13) / E, qtensor_bytes(w2) / E
    chains = {}
    for T in (2048, 452, 40):
        x = rms_norm(torch.randn((T, Hd), generator=g, device=dev).to(bf16),
                     torch.ones(Hd, dtype=bf16, device=dev), cfg.rms_norm_eps)
        routing = compute_routing(x, lp["gate_w"], cfg, lp.get("gate_bias"),
                                  logit_bias=lp.get("gate_logit_bias"))
        topk, wts = routing.topk_idx, routing.topk_weights
        M = T * k
        tm = gmm_cuda.choose_tm(M, E)                                  # the main path's
        plan = gmm_cuda.plan_tiles(topk, E, tm)
        real = plan.row_src >= 0
        hit = int((torch.bincount(topk.reshape(-1).long(), minlength=E) > 0).sum())
        h_plain = gmm_cuda.gmm_plain(x, plan.row_src, w13, plan, False)
        a = swiglu(h_plain.to(bf16), lim, True)
        print(f"[kernel] gptoss/gmm_two_stage T={T}: {tm}-row tiles, "
              f"{int(plan.tile_valid.sum())} of {plan.n_tiles} computed, {hit} of {E} experts hit; "
              f"{w2.n_dim % gmm_cuda.cta_cols(tm)} live columns in w2's last CTA", flush=True)
        for name, w, rows, row_src, nbytes, ops in (
                ("w13", w13, x, plan.row_src, hit * e13 + T * Hd * 2 + M * 2 * I * 4,
                 2 * M * Hd * 2 * I),
                ("w2", w2, a, None, hit * e2 + M * I * 2 + M * Hd * 4, 2 * M * I * Hd)):
            label = f"gptoss/gmm_two_stage:{name} T={T}"
            want = h_plain if name == "w13" else gmm_cuda.gmm_plain(a, None, w2, plan, False)
            lib = grouped_mm_library(label + " (bf16 out)",
                                     rows[plan.row_src[real].long()] if name == "w13"
                                     else rows[real], w, plan, bf16, want[real])
            del want
            check_kernel(results, label, C["K7"], gmm_cuda.REPLACES_TWO_STAGE,
                         lambda: gmm_cuda.gmm_two_stage(rows, row_src, w, plan),
                         lambda: gmm_cuda.gmm_plain(rows, row_src, w, plan, False), None, 2e-2,
                         nbytes, ops, PEAK_BF16, 10, None, select=lambda o: o[real],
                         device_name="gmm_kernel", calls=5)
            res = results[-1][1]
            res.update(tile_rows=tm, picks=M, experts=hit,
                       grouped_mm_bf16_out_ms=timeit_ms(lib, 10) if lib else None)
            if res["kernels_per_call"] != 1:
                raise AssertionError(f"{label}: a call launched {res['kernels_per_call']} "
                                     "device kernels, not 1")
            # under a pick_valid mask: the skipped picks are in no tile
            pv = torch.rand((T, k), generator=g, device=dev) > 0.2
            pm = gmm_cuda.plan_tiles(topk, E, tm, pick_valid=pv)
            rm = pm.row_src >= 0
            if name == "w13":
                rows_m, src_m = rows, pm.row_src
            else:
                rows_m, src_m = swiglu(gmm_cuda.gmm_plain(x, pm.row_src, w13, pm, False).to(bf16),
                                       lim, True), None
            err, ratio = max_err(gmm_cuda.gmm_two_stage(rows_m, src_m, w, pm)[rm],
                                 gmm_cuda.gmm_plain(rows_m, src_m, w, pm, False)[rm], 2e-2)
            print(f"[kernel] {label} with pick_valid ({int(rm.sum())} of {M} picks): max|Δ| "
                  f"{err:.3g}, {ratio:.3g} of the limit", flush=True)
            if not ratio <= 1.0:
                raise AssertionError(f"{label}: under pick_valid the kernel disagrees")
        del h_plain, a
        if T in (2048, 40):
            chains[T] = (x, topk, wts, plan)

    for T, (x, topk, wts, plan) in chains.items():
        # seeded nonzero biases: half the rms of h and of a pick's output
        real = plan.row_src >= 0
        h = gmm_cuda.gmm_plain(x, plan.row_src, w13, plan, False)
        b13 = (torch.randn((E, 2 * I), generator=g, device=dev) * 0.5
               * h[real].square().mean().sqrt()).to(lp["w13_bias"].dtype)
        a = swiglu(gmm_cuda._add_tile_bias(h.to(bf16), b13.to(bf16), plan), lim, True)
        del h
        o = gmm_cuda.gmm_plain(a, None, w2, plan, False)[real]
        b2 = (torch.randn((E, Hd), generator=g, device=dev) * 0.5
              * o.square().mean().sqrt()).to(lp["w2_bias"].dtype)
        del a, o

        def chain(bias13=b13, bias2=b2):
            return gmm_cuda.moe_prefill(x, w13, w2, topk, wts, lim, True, w13_bias=bias13,
                                        w2_bias=bias2)

        def plain(bias13=b13, bias2=b2):
            return moe.moe_forward_ragged(x, w13, w2, topk, wts, lim, True, w13_bias=bias13,
                                          w2_bias=bias2)

        before = {n: getattr(*C[n]) for n in ("K4", "K7", "K7a")}
        got = chain()
        launched = {n: getattr(*C[n]) - before[n] for n in before}
        if launched != {"K4": 0, "K7": 2, "K7a": 0}:
            raise AssertionError(f"gptoss/moe_prefill biased T={T}: launches {launched}, want "
                                 "two K7 only")
        want = plain()
        err, ratio = max_err(got, want, 3e-2)
        real_add = gmm_cuda._add_tile_bias
        gmm_cuda._add_tile_bias = lambda y, b, p: real_add(y, b,
                                                           p._replace(tile_e=p.tile_e.roll(1)))
        try:
            rolled = chain()
        finally:
            gmm_cuda._add_tile_bias = real_add
        refused = {"w13 bias dropped": max_err(got, plain(bias13=None), 3e-2)[1],
                   "w2 bias dropped": max_err(got, plain(bias2=None), 3e-2)[1],
                   "biases of tile_e rolled by one": max_err(rolled, want, 3e-2)[1]}
        print(f"[moe] gptoss biased grouped chain T={T} ({plan.tm}-row tiles; two K7 launches, "
              f"biases between) against moe_forward_ragged: max|Δ| {err:.3g}, {ratio:.3g} of the "
              f"limit (tol 3e-2); controls, fraction of the limit: "
              + ", ".join(f"{c} {v:.3g}" for c, v in refused.items()), flush=True)
        if not ratio <= 1.0:
            raise AssertionError(f"gptoss/moe_prefill T={T}: the biased chain disagrees with "
                                 "moe_forward_ragged")
        missed = [c for c, v in refused.items() if not v > 1.0]
        if missed:
            raise AssertionError(f"gptoss/moe_prefill T={T}: the check cannot see {missed}")
        # one prefill MoE layer's device time, the plain path against the
        # chain, in turns (plain, chain, chain, plain); L2 is not flushed
        times = {"plain": [], "chain": []}
        for which in ("plain", "chain", "chain", "plain"):
            us, n, whole = device_per_call(plain if which == "plain" else chain, "", None,
                                           calls=3)
            times[which].append((round(us, 2), n, whole))
        print("[moe] " + json.dumps({"model": "gpt-oss-20b", "prefill MoE layer":
                                     f"T={T}, top-{k} of {E}, biases, {plan.tm}-row tiles",
                                     "device us, kernels a call, whole": times}), flush=True)


def k7a_checks(results, name, xq, sx, w13, w2, plan, hit, T):
    """K7a (``gmm_a8``, the int8 tensor cores) on w13 (gathered int8 rows)
    and w2 (the hidden requantized) on one plan, with device us: within 3e-2
    of ``gmm_a8_plain``, max|Δ| and whether it is 0 (int8 stacks fold their
    groups in the plain version's order) printed. `name` has a {} for the
    stack."""
    import torch
    from krasis_tpu_torch.ops import gmm_cuda, moe_cuda
    from krasis_tpu_torch.ops.activations import swiglu
    from krasis_tpu_torch.quant import qtensor_bytes

    C = counters()
    E = w13.q.shape[0]
    M = plan.dest.numel()
    Hd, I = w13.k_dim, w2.k_dim
    real = plan.row_src >= 0
    h8 = gmm_cuda.gmm_a8_plain(xq, sx, plan.row_src, w13, plan)
    aq, sa = moe_cuda.quantize_activations(swiglu(h8), w2.group_size)
    del h8
    for stack, w, rows, scales, src, K, N in (("w13", w13, xq, sx, plan.row_src, Hd, 2 * I),
                                              ("w2", w2, aq, sa, None, I, Hd)):
        in_rows = T if src is not None else M
        check_kernel(results, name.format(stack), C["K7a"], gmm_cuda.REPLACES_A8,
                     lambda: gmm_cuda.gmm_a8(rows, scales, src, w, plan),
                     lambda: gmm_cuda.gmm_a8_plain(rows, scales, src, w, plan), None, 3e-2,
                     hit * qtensor_bytes(w) / E + in_rows * K + in_rows * (K // w.group_size) * 4
                     + M * N * 4, 2 * M * K * N, PEAK_INT8, 10, None, select=lambda o: o[real],
                     device_name="gmm_a8_kernel", calls=5)
        res = results[-1][1]
        got = gmm_cuda.gmm_a8(rows, scales, src, w, plan)[real]
        res["bit_equal_plain"] = torch.equal(got, gmm_cuda.gmm_a8_plain(rows, scales, src, w,
                                                                         plan)[real])
        print(f"[kernel] {name.format(stack)}: int{w.bits} gs {w.group_size}, {plan.tm}-row "
              f"tiles, max|Δ| {res['max_abs_err']:.3g} against gmm_a8_plain, equal bit for bit: "
              f"{res['bit_equal_plain']}", flush=True)


def q8_kernel_phase(params, cfg, results, g, flush):
    """The two-stage expert class at DeepSeek-V2-Lite's int8-expert shapes:
    K6 / K6a at T = 1 with the 6 routed picks plus the 2 folded shared
    experts, K7 / K7a at T = 2048 over the whole stack, and the fused
    kernels at the same shapes for the class boundary."""
    import torch
    from krasis_tpu_torch.ops import gmm_cuda, moe_cuda
    from krasis_tpu_torch.ops.activations import swiglu
    from krasis_tpu_torch.quant import qtensor_bytes
    from krasis_tpu_torch.timing import timeit_ms

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

    # --- decode: K6 (bf16 rows) and K6a's one product (int8 rows) on w13 and on w2
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
        k6_checks(results, f"q8/gathered_qmm:{name}", w, rows, idx, flush)
        check_kernel(results, f"q8/gathered_qmm_a8:{name}", C["K6a product"],
                     moe_cuda.REPLACES_GQ_A8,
                     lambda: moe_cuda.gathered_qmm_a8(rq, rs, w, idx),
                     lambda: moe_cuda.gathered_qmm_a8_plain(rq, rs, w, idx), None, 3e-2,
                     P * one + P * K + P * (K // w.group_size) * 4 + P * N * 4,
                     2 * P * K * N, PEAK_INT8, 50, flush,
                     device_name=moe_cuda.K6A_PRODUCT_KERNEL, calls=10,
                     source=moe_cuda.SOURCE_W4A8)
        # under a pick_valid mask: the skipped picks read back zero
        for label, got, want, tol in (
                ("gathered_qmm", moe_cuda.gathered_qmm(rows, w, idx, mask),
                 moe_cuda.gathered_qmm_plain(rows, w, idx, mask), 2e-2),
                ("gathered_qmm_a8", moe_cuda.gathered_qmm_a8(rq, rs, w, idx, mask),
                 moe_cuda.gathered_qmm_a8_plain(rq, rs, w, idx, mask), 3e-2)):
            held(f"q8/{label}:{name} with pick_valid", got, want, tol)
            if bool(got[mask == 0].any()) or not bool(got[mask == 1].any()):
                raise AssertionError(f"q8/{label}:{name}: skipped picks must read back zero")

    # --- decode: K6a's chain, the main path's call moe_gathered_tiled(activation="int8"):
    # two device kernels, the picks summed inside
    one_idx = idx[None]
    per_pick = (qtensor_bytes(w13) + qtensor_bytes(w2)) // E_all
    # The folded shared experts are quantized from N(0, 0.02) weights, the
    # routed int8 experts are random bytes times scales near 0.02: a shared
    # pick adds ~1e-4 of the output, under any limit a bf16 result allows.
    # So the shared picks are dropped from a call in which they alone are
    # weighted (the routed picks at weight 0, still computed).
    shared_only = wts.clone()
    shared_only[:, :k] = 0
    core_checks(results, "q8/moe_gathered_a8", C["K6a"], moe_cuda.K6A_KERNELS,
                moe_cuda.REPLACES_GQ_A8,
                lambda w: moe_cuda.moe_gathered_tiled(x, w13, w2, one_idx, w, activation="int8"),
                lambda w: moe_cuda.moe_gathered_a8_plain(x, w13, w2, one_idx, w), wts,
                P * per_pick + Hd * 4, 2 * P * (Hd * 2 * I + I * Hd), flush,
                controls=[(wts, range(k)), (shared_only, range(k, P))])
    # under the pick_valid mask: as the plain chain, and as K3's function with
    # the skipped picks' weights set to 0 (both classes round at the same points)
    pv = mask[None].bool()
    got = moe_cuda.moe_gathered_tiled(x, w13, w2, one_idx, wts, pick_valid=pv, activation="int8")
    held("q8/moe_gathered_a8 with pick_valid", got,
         moe_cuda.moe_gathered_a8_plain(x, w13, w2, one_idx, wts, pick_valid=pv), K3_TOL)
    held("q8/moe_gathered_a8 with pick_valid, against K3's function with the skipped weights 0",
         got, moe_cuda.moe_w4a8_plain(x, w13, w2, one_idx, wts * mask), K3_TOL)
    unmasked = max_err(got, moe_cuda.moe_gathered_a8_plain(x, w13, w2, one_idx, wts), K3_TOL)[1]
    print(f"[kernel] q8/moe_gathered_a8 with pick_valid: the plain version without the mask is "
          f"{unmasked:.3g} of the limit away", flush=True)
    if not unmasked > 1.0:
        raise AssertionError("q8/moe_gathered_a8: the check cannot see the mask")

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

    # --- K7a: each stage on the 64-row plan and on the 128-row plan that
    # choose_tm gives this T (M = 12288 >= 128 x 66), then the whole int8 entry
    gs13, gs2 = w13.group_size, w2.group_size
    xsq, xss = moe_cuda.quantize_activations(xs, gs13)
    for tm in (64, 128):
        plan8 = plan if tm == plan.tm else gmm_cuda.plan_tiles(topk, E_all, tm)
        k7a_checks(results, f"q8/gmm_a8:{{}}_tm{tm}", xsq, xss, w13, w2, plan8, hit, T)
    o8 = gmm_cuda.gmm_a8_plain(*moe_cuda.quantize_activations(
        swiglu(gmm_cuda.gmm_a8_plain(xsq, xss, plan.row_src, w13, plan)), gs2), None, w2, plan)
    want = (o8[plan.dest].reshape(T, k, Hd) * pw[..., None]).sum(dim=1).to(bf16)
    before = gmm_cuda.launches_a8
    got8 = gmm_cuda.moe_prefill(xs, w13, w2, topk, pw, activation="int8")
    held('q8/moe_prefill(activation="int8"), 128-row plan', got8, want, 3e-2)
    if gmm_cuda.launches_a8 != before + 2:
        raise AssertionError("moe_prefill(activation='int8') did not launch K7a twice")
    # the whole int8 entry in turns with the bf16 one (K7 + SwiGLU + K7) on
    # the same routing and stacks: does int8 prefill pay on this card?
    entry = {"bf16": lambda: gmm_cuda.moe_prefill(xs, w13, w2, topk, pw),
             "int8": lambda: gmm_cuda.moe_prefill(xs, w13, w2, topk, pw, activation="int8")}
    turns = [(act, timeit_ms(entry[act], 10)) for act in ("bf16", "int8", "int8", "bf16")]
    print("[entry] " + json.dumps({"moe_prefill T=2048, in turns (ms)": turns,
                                   "plan rows": plan.tm}), flush=True)

    # --- the fused kernels at the same shapes, for a later look at the class
    # boundary on this card (the port keeps the reference's boundary)
    times = {
        "decode_int8_two_stage_K6a_ms": timeit_ms(lambda: moe_cuda.moe_gathered_tiled(
            x, w13, w2, one_idx, wts, activation="int8"), 50, flush),
        "decode_int8_fused_K3_ms": timeit_ms(lambda: moe_cuda.moe_w4a8(
            x, w13, w2, one_idx, wts), 50, flush),
        "decode_bf16_two_stage_K6_ms": timeit_ms(lambda: moe_cuda.moe_gathered_tiled(
            x, w13, w2, one_idx, wts), 50, flush),
        "decode_bf16_fused_K5_ms": timeit_ms(lambda: moe_cuda.moe_bf16(
            x, w13, w2, one_idx, wts), 50, flush),
        "prefill_two_stage_K7_swiglu_K7_ms": timeit_ms(two_stage, 10),
        "prefill_fused_K4_K4_ms": timeit_ms(fused, 10),
    }
    print("[class] " + json.dumps({"model": "deepseek-v2-lite int8 experts",
                                   "decode": f"T=1, {P} picks of {E_all}",
                                   "prefill": f"T={T}, k={k}, E={E_all}", **times}),
          flush=True)


def gptoss_attention_checks(results, params, cfg, g, flush):
    """K2's window, sink and fp8 forms at GPT-OSS-20B's shapes (64 query heads
    on 8 kv heads of 64 lanes in 128-lane rows), on each layer kind's own
    K / V: 4096 rms-normed seeded hidden states through layer 0's (sliding,
    window 128) or layer 1's (full) q / k / v projections and biases. The
    sinks are random, N(5, 1): near the rows' largest scores, so that their
    term weighs against the window's 128 keys. A 2048-row prefill and a
    452-row chunk at q_off 2048 (one launch), split decode at kv_len 2560,
    2500 and 40 over the engine's 4096-row cache view; each over the cache
    in bf16 and in e4m3, the e4m3 form equal bit for bit to K2 over that
    cache cast to bf16. The library call is SDPA with the window mask; it
    leaves out the sink term. Three negative controls must fail the check:
    a plain version without the window, one without the sinks, and a
    combine that adds the sink in every split."""
    import torch
    import torch.nn.functional as F
    from krasis_tpu_torch.ops import flash_attention as fa
    from krasis_tpu_torch.ops.norm import rms_norm
    from krasis_tpu_torch.ops.qmm import linear
    from krasis_tpu_torch.runtime.kv_cache import to_cache
    from krasis_tpu_torch.timing import device_per_call

    dev = flush.device
    Hq, Hkv, d, S = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, 4096
    G, scale = Hq // Hkv, d ** -0.5
    x = torch.randn((S, cfg.hidden_size), generator=g, device=dev).to(torch.bfloat16)
    x = rms_norm(x, torch.ones(cfg.hidden_size, dtype=torch.bfloat16, device=dev),
                 cfg.rms_norm_eps)
    sinks = 5.0 + torch.randn((Hq,), generator=g, device=dev)
    C = counters()
    for kind, lp, window in (("sliding", params["layers"][0], cfg.sliding_window),
                             ("full", params["layers"][1], 0)):
        def proj(name, heads):
            y = linear(x, lp[name + "_proj"]) + lp[name + "_bias"].to(torch.bfloat16)
            return F.pad(y.reshape(S, heads, d), (0, 128 - d))

        q_all = proj("q", Hq)[None]                                  # [1, S, Hq, 128]
        k16 = proj("k", Hkv).transpose(0, 1)[None].contiguous()      # [1, Hkv, S, 128]
        v16 = proj("v", Hkv).transpose(0, 1)[None].contiguous()
        for suffix, k_all, v_all in (("", k16, v16),
                                     (":fp8", to_cache(k16, torch.float8_e4m3fn),
                                      to_cache(v16, torch.float8_e4m3fn))):
            elem = k_all.element_size()
            for case, sq, q_off, kv_len, view in (("prefill_2048", 2048, 0, 2048, 2048),
                                                  ("chunk_452_at_2048", 452, 2048, 2500, 2500),
                                                  ("decode_kv_2560", 1, 2559, 2560, S),
                                                  ("decode_kv_2500", 1, 2499, 2500, S),
                                                  ("decode_kv_40", 1, 39, 40, S)):
                name = f"gptoss/attention:{case}_{kind}{suffix}"
                q = q_all[:, q_off:q_off + sq]
                kv, v = k_all[:, :, :view], v_all[:, :, :view]
                qo = torch.tensor([q_off], dtype=torch.int32, device=dev)
                kl = torch.tensor([kv_len], dtype=torch.int32, device=dev)
                split = sq * G <= fa.MAX_SPLIT_ROWS
                kw = dict(qk_dim=d, window=window, sinks=sinks)

                def run():
                    return fa.flash_attention(q, kv, qo, kl, scale, d, v, **kw)

                def plain(**over):
                    return fa.flash_attention_plain(q, kv, qo, kl, scale, d, v,
                                                    **{**kw, **over})

                pos = q_off + torch.arange(sq, device=dev)
                kp = torch.arange(kv_len, device=dev)
                mask = kp[None, :] <= pos[:, None]
                if window:
                    mask &= kp[None, :] > pos[:, None] - window
                visible, needed = int(mask.sum()), int(mask.any(dim=0).sum())

                def per_q_head(t):
                    return t[:, :, None, :kv_len, :d].expand(1, Hkv, G, kv_len, d).reshape(
                        1, Hq, kv_len, d).to(torch.bfloat16)

                qh, kh, vh = q[..., :d].transpose(1, 2), per_q_head(kv), per_q_head(v)
                nbytes = (sq * Hq * d * 2 + 2 * needed * Hkv * d * elem + sq * Hq * d * 2
                          + Hq * 4)
                check_kernel(results, name, C["K2"],
                             fa.REPLACES_DECODE if split else fa.REPLACES, run, plain,
                             lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                                    scale=scale),
                             2e-2, nbytes, 2 * Hq * visible * 2 * d, PEAK_BF16,
                             50 if split else 20, flush,
                             device_name=("attention_kernel", "combine_kernel"))
                res = results[-1][1]
                res["form"] = fa.form_name(split, window, True, bool(suffix))
                if split:
                    res["combine_device_us"] = device_per_call(run, "combine_kernel", flush)[0]
                    print(f"[kernel] {name}: combine launch {res['combine_device_us']:.2f} us "
                          "on the device", flush=True)
                if suffix:
                    wide = fa.flash_attention(q, kv.to(torch.bfloat16), qo, kl, scale, d,
                                              v.to(torch.bfloat16), **kw)
                    if not torch.equal(run(), wide):
                        raise AssertionError(f"{name}: K2 over the e4m3 cache differs from K2 "
                                             "over it cast to bf16")
                    continue
                controls = []
                if window and case in ("prefill_2048", "decode_kv_2560"):
                    controls.append(("without the window", plain(window=0)))
                if (kind, case) in (("sliding", "decode_kv_2560"), ("full", "prefill_2048")):
                    controls.append(("without the sinks", plain(sinks=None)))
                if (kind, case) == ("full", "decode_kv_2560"):
                    # the sink added to each split's own row sum: counted once per live split
                    chunk, _ = fa.split_plan(view, Hkv, 1, torch.cuda.get_device_properties(dev)
                                             .multi_processor_count)
                    o, m, l = fa.decode_split_plain(q, kv, qo, kl, scale, d, chunk, v, d, window)
                    live = m > fa.NEG_INF / 2
                    rs = fa._row_sinks(sinks, Hkv, G)[None, :, None]
                    l_wrong = l + torch.where(live, torch.exp(rs - torch.where(
                        live, m, torch.zeros_like(m))), torch.zeros_like(l))
                    controls.append((f"with the sink in each of {int(live[0, 0, :, 0].sum())} "
                                     "live splits",
                                     fa._unstack(fa.decode_combine_plain(o, m, l_wrong), 1)))
                for what, wrong in controls:
                    _, fault = max_err(wrong, plain(), 2e-2)
                    print(f"[kernel] {name}: a plain version {what} reads {fault:.3g} of the "
                          "limit", flush=True)
                    if not fault > 1.0:
                        raise AssertionError(f"{name}: the check cannot see a version {what}")


def gptoss_kernel_phase(params, cfg, results, g, flush):
    import torch

    # K1 — the int8 lm_head [2880, 201088] at gs 32 (K / gs = 90)
    qmm_checks(results, "gptoss/", (("qmm:lm_head", params["lm_head"], None, torch.float32),),
               g, flush)
    gptoss_attention_checks(results, params, cfg, g, flush)
    gptoss_moe_checks(results, params, cfg, g, flush)


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
    from krasis_tpu_torch.timing import timeit_ms

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
        ms[act] = timeit_ms(run, 5)
    rel = float((outs["int8"] - outs["bf16"]).square().mean().sqrt()
                / outs["bf16"].square().mean().sqrt())
    print(f"[entry] moe_prefill on one layer, T = 2048: bf16 rows {ms['bf16']:.3f} ms, int8 rows "
          f"{ms['int8']:.3f} ms, rms difference {rel:.3g} of the output's rms", flush=True)
    if not (math.isfinite(rel) and rel < 5e-2):
        raise AssertionError("moe_prefill(activation='int8') strays from the bf16 form")


# K6 in profiler rows: K1's kernel in its gathered instances (K5's stages
# are its ACT and PSUM instances, moe_cuda.K5_KERNELS)
K6_KERNELS = ("qmm_kernel<1, 4, float, true, false, false>",
              "qmm_kernel<1, 8, float, true, false, false>")
OLD_K5_KERNELS = ("w13_bf16_kernel", "w2_bf16_kernel")   # K5 before it moved onto K1's core


def is_k6(key: str) -> bool:
    return any(name in key for name in K6_KERNELS)


def is_k5(key: str) -> bool:
    from krasis_tpu_torch.ops import moe_cuda
    return any(name in key for name in moe_cuda.K5_KERNELS)


def profile_phase(eng, prompt, new: int, forbid=(), require=()):
    """Device time by kernel over one request, against the wall time of the
    same request run without the profiler. No kernel whose name holds one of
    `forbid` may run, and for each of `require` one whose name holds it
    must. The decode runs in blocks of at most `new` steps, so that both
    runs hold the steps asked for and no more."""
    import torch
    from krasis_tpu_torch.timing import recorded_step, traced_kernels
    from torch.profiler import ProfilerActivity, profile, schedule

    block, eng.decode_block = eng.decode_block, min(eng.decode_block, new)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompt, max_new_tokens=new, stop_ids={-1})
        wall_ms = (time.perf_counter() - t0) * 1e3
        # the second step is recorded: the first, one small kernel, warms the
        # tracer up. Device activity alone: the rows are device kernels, and
        # host-side events of a 60,000-launch request only add tracing work
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            torch.ones(1, device="cuda").add_(1)
            recorded_step(prof)
            eng.generate(prompt, max_new_tokens=new, stop_ids={-1})
            torch.cuda.synchronize()
            prof.step()
    finally:
        eng.decode_block = block
    rows = [(key, us / 1e3, count) for key, us, count in traced_kernels(prof) if us > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"[profile] prompt {len(prompt)} + {new} tokens: wall {wall_ms:.1f} ms unprofiled, "
          f"device kernels {busy:.1f} ms ({100 * busy / wall_ms:.1f}% busy), "
          f"{sum(r[2] for r in rows)} launches")
    for key, ms, count in rows[:12]:
        print(f"[profile]   {ms:9.2f} ms {count:6d}x  {key[:90]}")
    banned = [key for key, _, _ in rows if any(part in key for part in forbid)]
    if banned:
        raise AssertionError(f"kernels of the other expert class ran: {banned}")
    missing = [part for part in require if not any(part in key for key, _, _ in rows)]
    if missing:
        raise AssertionError(f"no device kernel named {missing} in the profile")
    for label, named in (("K1 + K1s", lambda key: "qmm_kernel" in key and not is_k6(key)
                          and not is_k5(key)),
                         ("K6", is_k6), ("K5", is_k5), ("K3", lambda key: "w4a8_stage" in key),
                         ("K6a", lambda key: "gq_a8_stage" in key),
                         ("K4 / K7", lambda key: "gmm_kernel" in key)):
        hits = [(ms, count) for key, ms, count in rows if named(key)]
        if hits:
            ms, count = sum(r[0] for r in hits), sum(r[1] for r in hits)
            print(f"[profile]   {label}: {ms:.2f} ms over {count} launches, "
                  f"{1e3 * ms / count:.2f} us each")
    for key, ms, count in rows:                       # K2's launches, each form
        if "attention_kernel" in key or "combine_kernel" in key:
            name = key.split("((")[0].replace("void (anonymous namespace)::", "")
            print(f"[profile]   K2 {name}: {count} launches, {1e3 * ms / count:.2f} us each")


def run_family(label, preset, quant, kernel_phase, requests, on_path, results, rng,
               profile_decode, off_path=(), entry_points=None, forms=(), off_names=(),
               prefill_off_names=(), prefill_on_names=(), profile_bf16=0, batched=None,
               spec=None, offload=None, measure=None, mesh=None, tooling=None,
               profile_prefill=2048):
    """One model family at full width: build the engine, hold its kernels to
    their plain versions, answer `requests` ((prompt tokens, new tokens,
    expert activation[, top_logprobs[, kv cache]]), the kv cache None for
    the engine's own, a dtype, or (dtype, max_len) for an engine of that
    length) and run `entry_points` with the launch counts set to 0 just
    before and read just after, then profile one prefill (`profile_prefill`
    ids + 1) and one decode.
    Kernels named in `on_path`, and the K2 launch forms in `forms`, must
    have been launched in that run, those in `off_path` must not, nor may the
    profiles show a device kernel whose name holds one of `off_names` (the
    prefill's profile one of `prefill_off_names` either); the prefill's
    profile must show one for each of `prefill_on_names`. With
    `profile_bf16`, a 40 + `profile_bf16` request under bf16 expert
    activations is profiled too: it must show K5's two kernels (this
    family's bits) and neither K3's nor K5's earlier ones. No MoE call may
    take a plain form (``moe.plain_routes``). Fills the launch counts into
    this family's entries of `results` (by form for K2 entries that name
    one). Then `batched(eng, cfg, results, rng)`, the continuous-batching
    phase on the same weights, `spec(eng, cfg, results, rng)`, the
    speculative-decoding phase, `offload(eng, cfg, results, rng)`, the
    offload tier's, `measure(eng, cfg, results, rng)`, the measurement
    entry points', `mesh(eng, cfg, results, rng)`, the mesh's, and
    `tooling(eng, cfg, results, rng)`, the tooling's, when given."""
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

    from krasis_tpu_torch.ops import flash_attention as fa
    from krasis_tpu_torch.ops import moe

    # the same weights under another expert activation or kv cache, where a
    # request asks; built when first asked for
    engines = {(eng.quant.expert_activation, None): eng}

    def engine_for(act, kv):
        if (act, kv) not in engines:
            q, max_len = replace(eng.quant, expert_activation=act), eng.max_len
            if kv is not None:
                dtype, max_len = kv if isinstance(kv, tuple) else (kv, max_len)
                q = replace(q, kv_cache_dtype=dtype)
            e = Engine(cfg, q, eng.params, max_len=max_len)
            held = sum(t.numel() * t.element_size() for lc in e.cache["layers"]
                       for t in lc.values())
            print(f"[engine] {label}: kv cache {kv!r} resolves to {e.quant.kv_cache_dtype} at "
                  f"max_len {max_len}: {held / 1e9:.2f} GB", flush=True)
            if kv is not None and e.quant.kv_cache_dtype != "fp8":
                raise AssertionError(f"{label}: kv cache {kv!r} did not resolve to fp8")
            engines[(act, kv)] = e
        return engines[(act, kv)]

    C = counters()
    eng.generate(rng.integers(100, cfg.vocab_size - 100, 256).tolist(), max_new_tokens=8,
                 stop_ids={-1})                          # warm-up: cuBLAS, allocator
    for m, attr in C.values():
        setattr(m, attr, 0)
    fa.form_launches.clear()
    moe.plain_routes.update(ragged_plain=0, gathered_plain=0)
    for n, new, act, *rest in requests:
        top = rest[0] if rest else 0
        kv = rest[1] if len(rest) > 1 else None
        before = {name: getattr(m, attr) for name, (m, attr) in C.items()}
        prompt = rng.integers(100, cfg.vocab_size - 100, n).tolist()
        engine = engine_for(act, kv)
        res = engine.generate(prompt, max_new_tokens=new, stop_ids={-1}, top_logprobs=top)
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
            "kv_cache_dtype": engine.quant.kv_cache_dtype, "max_len": engine.max_len,
            "prompt": n, "tokens": len(res.tokens), "prefill_tok_s": res.prefill_tok_s,
            "decode_tok_s": res.decode_tok_s, "prefill_s": res.prefill_s,
            "decode_s": res.decode_s,
            "launches": {name: getattr(m, attr) - before[name]
                         for name, (m, attr) in C.items()}}), flush=True)
    t_requests = time.perf_counter()
    if entry_points is not None:
        entry_points(eng, rng)
    counts = {name: getattr(m, attr) for name, (m, attr) in C.items()}
    by_form = dict(fa.form_launches)
    print(f"[launches] {label}: {json.dumps(counts)}; K2 by form {json.dumps(by_form)}; MoE "
          f"calls on a plain route {moe.plain_routes}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on the card", flush=True)
    for name in on_path:
        if counts[name] <= 0:
            raise AssertionError(f"{label}: {name} was never launched on the main path")
    if any(moe.plain_routes.values()):
        raise AssertionError(f"{label}: MoE calls on a plain form {moe.plain_routes}, want none")
    for form in forms:
        if by_form.get(form, 0) <= 0:
            raise AssertionError(f"{label}: K2's {form} form was never launched on the main path")
    for name in off_path:
        if counts[name] != 0:
            raise AssertionError(f"{label}: {name} was launched {counts[name]} times, but "
                                 "this model's experts belong to the other class")
    by_counter = {C[name]: n for name, n in counts.items()}
    for counter, res in results[first:]:
        res["launches"] = by_form.get(res["form"], 0) if "form" in res else by_counter[counter]

    t_entries = time.perf_counter()
    profile_phase(eng, rng.integers(100, cfg.vocab_size - 100, profile_prefill).tolist(), 1,
                  tuple(off_names) + tuple(prefill_off_names), prefill_on_names)
    profile_phase(eng, rng.integers(100, cfg.vocab_size - 100, 40).tolist(), profile_decode,
                  off_names)
    if profile_bf16:
        from krasis_tpu_torch.ops import moe_cuda

        bits = next(lp for lp in eng.params["layers"] if "w13" in lp)["w13"].bits
        print(f"[profile] {label}, expert_activation=\"bf16\":", flush=True)
        profile_phase(engine_for("bf16", None),
                      rng.integers(100, cfg.vocab_size - 100, 40).tolist(), profile_bf16,
                      tuple(off_names) + moe_cuda.K3_KERNELS + OLD_K5_KERNELS,
                      tuple(n for n in moe_cuda.K5_KERNELS if f"<1, {bits}," in n))
    print(f"[time] {label}: kernel checks {t_kernels - t0:.1f} s (engine build included), "
          f"requests {t_requests - t_kernels:.1f} s, other entry points "
          f"{t_entries - t_requests:.1f} s, profiles {time.perf_counter() - t_entries:.1f} s",
          flush=True)
    if batched is not None:
        batched(eng, cfg, results, rng)
    if spec is not None:
        spec(eng, cfg, results, rng)
    if offload is not None:
        offload(eng, cfg, results, rng)
    if measure is not None:
        measure(eng, cfg, results, rng)
    if mesh is not None:
        t_mesh = time.perf_counter()
        mesh(eng, cfg, results, rng)
        print(f"[time] {label}: mesh phase {time.perf_counter() - t_mesh:.1f} s", flush=True)
    if tooling is not None:
        tooling(eng, cfg, results, rng)
    del eng, engines, engine
    gc.collect()
    torch.cuda.empty_cache()


def probe_counters():
    """The launch count of each probe kernel and probe form: (module,
    attribute)."""
    from krasis_tpu_torch.ops import gmm_cuda, probes_cuda
    return {"P4": (probes_cuda, "launches_stream"),
            "P8:maskxor": (probes_cuda, "launches_unpack_maskxor"),
            "P8:shift": (probes_cuda, "launches_unpack_shift"),
            "P5": (probes_cuda, "launches_int4_native"), "P6": (probes_cuda, "launches_int4_cast"),
            "P7": (probes_cuda, "launches_int4_view"),
            **{f"P3:{mode}": (gmm_cuda, f"launches_{mode}")
               for mode in ("copy", "nounpack", "unpackonly")},
            "P2:v2": (gmm_cuda, "launches_v2")}


def probe_phase(results):
    """8. The TPU probes under benchmarks/ as H100 probes
    (krasis_tpu_torch/probes). Their main path is the four entry points run
    at their own full-width V2-Lite expert shapes (timings cut to 3
    launches), with every launch count set to 0 just before; then each
    probe kernel against its plain version at those shapes (P4-P8 exactly,
    K3 / K5 within 3e-2, the grouped forms within 2e-2), K4 / K7 at 256 and
    512 rows against 128 rows bit for bit, and two negative controls the
    checks must refuse."""
    import torch
    from krasis_tpu_torch.ops import gmm_cuda, moe_cuda, probes_cuda
    from krasis_tpu_torch.probes import (probe_gmm_terms, probe_int4_mxu,
                                         probe_unpack_variants, probe_w4a8)
    from krasis_tpu_torch.quant import qtensor_bytes, unpack_int4
    from krasis_tpu_torch.timing import timeit_ms

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    first = len(results)
    mods = (probe_int4_mxu, probe_w4a8, probe_unpack_variants, probe_gmm_terms)
    inp = {m: m.make_inputs(dev) for m in mods}
    C = {**counters(), **probe_counters()}
    for m, attr in C.values():
        setattr(m, attr, 0)
    for m in mods:       # device times: the checks below take them, for every probe kernel
        print(f"[probe] {m.__name__.rsplit('.', 1)[1]}:", flush=True)
        m.run(inp[m], iters=3, device_time=False)
    counts = {name: getattr(m, attr) for name, (m, attr) in C.items()}
    print(f"[launches] probes: {json.dumps(counts)}", flush=True)
    for name in (*probe_counters(), "K3", "K4", "K5", "K7"):
        if counts[name] <= 0:
            raise AssertionError(f"probes: {name} was never launched by the probes' entry points")
    t_path = time.perf_counter()

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(8)

    # --- P4, P8: the stream floor and the two unpack forms; K5 and K3 at the
    # same picks (T = 1, sections B and C), for the rates beside P4's
    mx = inp[probe_int4_mxu]
    w13, w2, x0, idx, wts = (mx[k] for k in ("w13", "w2", "x0", "idx", "wts"))
    H, k = mx["shape"]["H"], mx["shape"]["K_TOP"]
    eids = idx.reshape(-1)
    packed, with_scales = probe_int4_mxu.pick_bytes(mx)
    check_kernel(results, "probe/stream", C["P4"], probes_cuda.REPLACES_STREAM,
                 lambda: probes_cuda.stream(w13.q, w2.q, eids, H),
                 lambda: probes_cuda.stream_plain(w13.q, w2.q, eids, H), None, 0,
                 k * packed + H * 4, k * packed, PEAK_CUDA_CORES, 50, flush,
                 device_name="colsum_kernel", calls=10)
    res = results[-1][1]
    res["gb_s"] = stream_gb_s = k * packed / res["device_us"] / 1e3
    dropped = probes_cuda.stream_plain(w13.q, w2.q, eids[:-1], H)
    wrong = int((probes_cuda.stream(w13.q, w2.q, eids, H) != dropped).sum())
    print(f"[kernel] probe/stream: {res['gb_s']:.1f} GB/s on the device; a plain version "
          f"without the last pick differs in {wrong} of {H} columns", flush=True)
    if wrong == 0:
        raise AssertionError("probe/stream: the check cannot see a dropped pick")
    for mode in ("maskxor", "shift"):
        block = w13.q[0]
        check_kernel(results, f"probe/unpack:{mode}", C[f"P8:{mode}"],
                     probes_cuda.REPLACES_UNPACK, lambda: probes_cuda.unpack_colsum(block, mode),
                     lambda: probes_cuda.unpack_colsum_plain(block, mode), None, 0,
                     block.numel() + block.shape[1] * 4, 2 * block.numel() * 4,
                     PEAK_CUDA_CORES, 50, flush, device_name="colsum_kernel", calls=10)
    per_pick = (qtensor_bytes(w13) + qtensor_bytes(w2)) // w13.q.shape[0]
    ops1 = 2 * k * (H * w13.n_dim + w2.k_dim * H)
    k5_checks(results, "probe/moe_bf16_T1", x0, w13, w2, idx, wts, k * per_pick + H * 4, ops1,
              flush, k)
    k3_checks(results, "probe/moe_w4a8_T1", x0, w13, w2, idx, wts, moe_cuda.REPLACES,
              k * per_pick + H * 4, ops1, flush)
    res = results[-1][1]
    res["gb_s"] = k * with_scales / res["device_us"] / 1e3
    print(f"[kernel] probe: K3 streams its picks at {res['gb_s']:.1f} GB/s on the device, the "
          f"stream floor at {stream_gb_s:.1f}", flush=True)

    # --- P5, P6, P7 at the probe's shapes, on seeded values
    q = torch.randint(-128, 128, (64, 256), generator=g, device=dev, dtype=torch.int8)
    x4 = torch.randint(-8, 8, (8, 128), generator=g, device=dev, dtype=torch.int8)
    x8 = torch.randint(-128, 128, (8, 128), generator=g, device=dev, dtype=torch.int8)
    w8 = unpack_int4(q)
    dot_bytes, dot_ops = 8 * 128 + q.numel() + 8 * 256 * 4, 2 * 8 * 128 * 256

    def int_mm():
        return torch._int_mm(x8, w8)

    try:
        int_mm()
        torch.cuda.synchronize()
    except Exception as err:                     # noqa: BLE001 — the refusal is the finding
        print(f"[library] probe/int4_dot:s8: torch._int_mm refused [8, 128] x [128, 256]: "
              f"{type(err).__name__}: {str(err).splitlines()[0][:200]}", flush=True)
        int_mm = None
    check_kernel(results, "probe/int4_dot:s4", C["P5"], probes_cuda.REPLACES_NATIVE,
                 lambda: probes_cuda.int4_dot_native(x4, q),
                 lambda: probes_cuda.int4_dot_plain(x4, q), None, 0, dot_bytes, dot_ops,
                 PEAK_INT8, 50, flush, device_name="int4_dot_kernel", calls=10)
    check_kernel(results, "probe/int4_dot:s8", C["P6"], probes_cuda.REPLACES_CAST,
                 lambda: probes_cuda.int4_dot(x8, q), lambda: probes_cuda.int4_dot_plain(x8, q),
                 int_mm, 0, dot_bytes, dot_ops, PEAK_INT8, 50, flush,
                 device_name="int4_dot_kernel", calls=10)
    u8 = torch.randint(0, 256, (128, 256), generator=g, device=dev, dtype=torch.uint8)
    check_kernel(results, "probe/int4_view", C["P7"], probes_cuda.REPLACES_VIEW,
                 lambda: probes_cuda.int4_view_shape(u8),
                 lambda: probes_cuda.int4_view_shape_plain(u8), None, 0, u8.numel() + 8,
                 2 * u8.numel(), PEAK_CUDA_CORES, 50, flush, device_name="int4_view_kernel",
                 calls=10)

    # --- P1: K3 (and K5) at T 8, 48 picks
    w4 = inp[probe_w4a8]
    w13, w2, x, idx, wts = (w4[k] for k in ("w13", "w2", "x", "idx", "wts"))
    hit = int(torch.unique(idx).numel())
    P = idx.numel()
    per_pick = (qtensor_bytes(w13) + qtensor_bytes(w2)) // w13.q.shape[0]
    ops8 = 2 * P * (w13.k_dim * w13.n_dim + w2.k_dim * w2.n_dim)
    k3_checks(results, "probe/moe_w4a8_T8", x, w13, w2, idx, wts, probe_w4a8.REPLACES,
              hit * per_pick + x.numel() * 4, ops8, flush)
    k5_checks(results, "probe/moe_bf16_T8", x, w13, w2, idx, wts,
              hit * per_pick + x.numel() * 4, ops8, flush, idx.shape[1])
    print(f"[kernel] probe/moe_w4a8_T8: {P} picks over {hit} distinct experts", flush=True)
    del flush
    torch.cuda.empty_cache()

    # --- K4 / K7 at 256 and 512 rows against 128 rows; P2's v2 form
    uv = inp[probe_unpack_variants]
    w13, w2, idx, x = uv["w13"], uv["w2"], uv["idx"], uv["x"]
    E, Hd = w13.q.shape[0], w13.k_dim
    M, N13, I = idx.numel(), w13.n_dim, w2.k_dim
    e13, e2 = qtensor_bytes(w13) / E, qtensor_bytes(w2) / E
    hit = int((torch.bincount(idx.reshape(-1).long(), minlength=E) > 0).sum())
    plans = {tm: gmm_cuda.plan_tiles(idx, E, tm) for tm in (128, 256, 512)}
    p128 = plans[128]
    a = {tm: gmm_cuda.gmm(x, p.row_src, w13, p, True) for tm, p in plans.items()}
    o = {tm: gmm_cuda.gmm(a[tm], None, w2, p, False) for tm, p in plans.items()}
    h = {tm: gmm_cuda.gmm_two_stage(x, p.row_src, w13, p) for tm, p in plans.items()}
    for tm in (256, 512):
        p = plans[tm]
        same = [torch.equal(r[128][p128.dest], r[tm][p.dest]) for r in (a, o, h)]
        print(f"[kernel] probe/tile rows {tm} against 128, each pick's row: K4 w13 + SwiGLU "
              f"{same[0]}, K4 w2 {same[1]}, K7 w13 {same[2]} (bit for bit)", flush=True)
        if not all(same):
            raise AssertionError(f"K4 / K7 at {tm} rows differ from 128 rows")
    bad_e = p128.tile_e.clone()
    t_bad = int(torch.nonzero(p128.tile_valid)[5])
    bad_e[t_bad] = (bad_e[t_bad] + 1) % E
    bad = p128._replace(tile_e=bad_e)
    h_bad = gmm_cuda.gmm_two_stage(x, bad.row_src, w13, bad)
    moved = int((h_bad[p128.dest] != h[512][plans[512].dest]).any(dim=1).sum())
    print(f"[kernel] probe/tile rows: a 128-row plan with tile {t_bad}'s expert changed differs "
          f"from the 512-row plan in {moved} rows", flush=True)
    if moved == 0:
        raise AssertionError("the row comparison cannot see a changed tile expert")
    del a, o, h, h_bad
    real128 = p128.row_src >= 0
    lib13 = grouped_mm_library("probe/gmm:w13 (product alone, no SwiGLU)",
                               x[p128.row_src[real128].long()], w13, p128, torch.bfloat16,
                               gmm_cuda.gmm_plain(x, p128.row_src, w13, p128, False)[real128])
    for tm in (256, 512):
        p = plans[tm]
        real = p.row_src >= 0
        a_plain = gmm_cuda.gmm_plain(x, p.row_src, w13, p, True)
        check_kernel(results, f"probe/gmm:w13_swiglu_tm{tm}", C["K4"], gmm_cuda.REPLACES,
                     lambda: gmm_cuda.gmm(x, p.row_src, w13, p, True),
                     lambda: gmm_cuda.gmm_plain(x, p.row_src, w13, p, True), lib13, 3e-2,
                     hit * e13 + x.numel() * 2 + M * I * 2, 2 * M * Hd * N13, PEAK_BF16, 10,
                     None, select=lambda r: r[real], device_name="gmm_kernel", calls=5)
        check_kernel(results, f"probe/gmm:w2_f32_tm{tm}", C["K4"], gmm_cuda.REPLACES_W2,
                     lambda: gmm_cuda.gmm(a_plain, None, w2, p, False),
                     lambda: gmm_cuda.gmm_plain(a_plain, None, w2, p, False), None, 3e-2,
                     hit * e2 + M * I * 2 + M * Hd * 4, 2 * M * I * Hd, PEAK_BF16, 10, None,
                     select=lambda r: r[real], device_name="gmm_kernel", calls=5)
        del a_plain
    # K7a with int4 rows at V2-Lite's w13 / w2 on the 128-row plan: w2's
    # K/2 = 704 cuts a group of 128 in two
    xq4, sx4 = moe_cuda.quantize_activations(x, w13.group_size)
    k7a_checks(results, "probe/gmm_a8:{}_int4_tm128", xq4, sx4, w13, w2, p128, hit,
               x.shape[0])
    del xq4, sx4
    for tm in (128, 256, 512):
        p, x_tiles = probe_unpack_variants.tile_inputs(uv, tm)
        live = p.tile_valid.to(torch.bool).repeat_interleave(tm)
        nbytes = hit * e13 + M * Hd * 2 + M * N13 * 4
        if tm > 128:
            check_kernel(results, f"probe/gmm_two_stage:w13_tm{tm}", C["K7"],
                         gmm_cuda.REPLACES_TWO_STAGE,
                         lambda: gmm_cuda.gmm_two_stage(x_tiles, None, w13, p),
                         lambda: gmm_cuda.gmm_plain(x_tiles, None, w13, p, False), None, 2e-2,
                         nbytes, 2 * M * Hd * N13, PEAK_BF16, 10, None,
                         select=lambda r: r[live], device_name="gmm_kernel", calls=5)
        check_kernel(results, f"probe/gmm_v2:tm{tm}", C["P2:v2"], gmm_cuda.REPLACES_V2,
                     lambda: gmm_cuda.gmm_probe(x_tiles, w13, p, "v2"),
                     lambda: gmm_cuda.gmm_probe_plain(x_tiles, w13, p, "v2"), None, 2e-2,
                     nbytes, 2 * M * Hd * N13, PEAK_BF16, 10, None, select=lambda r: r[live],
                     device_name="gmm_kernel", calls=5)
        del x_tiles

    # --- P3: the terms of one step at the 128-row plan, and the row gather
    gt = inp[probe_gmm_terms]
    plan, x_tiles = gt["plan"], gt["x_tiles"]
    live = plan.tile_valid.to(torch.bool).repeat_interleave(plan.tm)
    real = plan.row_src >= 0
    M = int(real.sum())
    hit = int((torch.bincount(gt["idx"].reshape(-1).long(), minlength=E) > 0).sum())
    for bits, modes in probe_gmm_terms.MODES:
        w = gt[bits]
        ew = qtensor_bytes(w) / w.q.shape[0]
        for mode in modes:
            product = mode in ("nounpack", "full")         # full: K7's own launch
            check_kernel(results, f"probe/gmm_terms:{bits}_{mode}",
                         C["K7" if mode == "full" else f"P3:{mode}"],
                         gmm_cuda.REPLACES_TERMS,
                         lambda: gmm_cuda.gmm_probe(x_tiles, w, plan, mode),
                         lambda: gmm_cuda.gmm_probe_plain(x_tiles, w, plan, mode), None,
                         2e-2 if product else 0, hit * ew + M * Hd * 2 + M * N13 * 4,
                         2 * M * Hd * N13 if product else 0, PEAK_BF16, 10, None,
                         select=lambda r: r[live], device_name="gmm_kernel", calls=5)
    w = gt["w4"]
    lib = grouped_mm_library("probe/gmm_terms: grouped_mm at the plan", x_tiles[real], w, plan,
                             torch.bfloat16,
                             gmm_cuda.gmm_probe_plain(x_tiles, w, plan, "full")[real])
    xg = (torch.randn((gt["idx"].shape[0], Hd), generator=g, device=dev) * 0.1).to(torch.bfloat16)
    gather = {
        "grouped_mm_product_bf16_ms": timeit_ms(lib, 10) if lib else None,
        "K7_w13_tile_aligned_rows_ms": timeit_ms(
            lambda: gmm_cuda.gmm_two_stage(x_tiles, None, w, plan), 10),
        "K7_w13_gathered_rows_ms": timeit_ms(
            lambda: gmm_cuda.gmm_two_stage(xg, plan.row_src, w, plan), 10),
        "K4_w13_swiglu_gathered_rows_ms": timeit_ms(
            lambda: gmm_cuda.gmm(xg, plan.row_src, w, plan, True), 10),
        **{f"w4_{mode}_gathered_rows_ms": timeit_ms(
            lambda: gmm_cuda.gmm_probe(xg, w, plan, mode, row_src=plan.row_src), 10)
           for mode in ("copy", "nounpack", "unpackonly")}}
    for mode in ("copy", "unpackonly"):       # the gathered forms hold too
        got = gmm_cuda.gmm_probe(xg, w, plan, mode, row_src=plan.row_src)[live]
        if not torch.equal(got, gmm_cuda.gmm_probe_plain(xg, w, plan, mode,
                                                         row_src=plan.row_src)[live]):
            raise AssertionError(f"probe/gmm_terms:w4_{mode} over gathered rows disagrees")
    print("[probe] gmm_terms yardsticks at the same 128-row plan " + json.dumps(gather),
          flush=True)
    by_counter = {C[name]: n for name, n in counts.items()}
    for counter, res in results[first:]:
        res["launches"] = by_counter[counter]
    print(f"[time] probes: entry points {t_path - t0:.1f} s, checks "
          f"{time.perf_counter() - t_path:.1f} s", flush=True)


# --------------------------------------------------------------------------
# 9. [load]: checkpoints on disk through the loader, the cache and the engine
# --------------------------------------------------------------------------

LOAD_DEVICE = "cuda"     # where the checkpoints are made and the card-side checks run

# DeepSeek-V2-Lite's published config.json, cut to 3 layers (layer 0 dense,
# layers 1-2 MoE); every width is the model's.
V2LITE_CONFIG = {
    "architectures": ["DeepseekV2ForCausalLM"], "model_type": "deepseek_v2",
    "hidden_size": 2048, "intermediate_size": 10944, "moe_intermediate_size": 1408,
    "num_hidden_layers": 3, "num_attention_heads": 16, "num_key_value_heads": 16,
    "vocab_size": 102400, "kv_lora_rank": 512, "q_lora_rank": None,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "n_routed_experts": 64, "num_experts_per_tok": 6, "n_shared_experts": 2,
    "first_k_dense_replace": 1, "moe_layer_freq": 1, "n_group": 1, "topk_group": 1,
    "topk_method": "greedy", "scoring_func": "softmax", "norm_topk_prob": False,
    "routed_scaling_factor": 1.0, "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707},
    "max_position_embeddings": 163840, "tie_word_embeddings": False, "hidden_act": "silu",
    "attention_bias": False, "bos_token_id": 100000, "eos_token_id": 100001,
    "torch_dtype": "bfloat16"}
# GPT-OSS-20B's published config.json, cut to 2 layers (one sliding, one
# full); its experts are MXFP4 blocks.
GPTOSS_CONFIG = {
    "architectures": ["GptOssForCausalLM"], "model_type": "gpt_oss",
    "hidden_size": 2880, "intermediate_size": 2880, "num_hidden_layers": 2,
    "num_attention_heads": 64, "num_key_value_heads": 8, "head_dim": 64,
    "vocab_size": 201088, "num_local_experts": 32, "num_experts_per_tok": 4,
    "experts_per_token": 4, "sliding_window": 128, "swiglu_limit": 7.0,
    "attention_bias": True, "layer_types": ["sliding_attention", "full_attention"],
    "rms_norm_eps": 1e-05, "rope_theta": 150000,
    "rope_scaling": {"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0, "beta_slow": 1.0,
                     "original_max_position_embeddings": 4096, "truncate": False},
    "max_position_embeddings": 131072, "initial_context_length": 4096,
    "tie_word_embeddings": False, "hidden_act": "silu", "eos_token_id": 200002,
    "pad_token_id": 199999, "torch_dtype": "bfloat16",
    "quantization_config": {"quant_method": "mxfp4", "modules_to_not_convert": [
        "model.layers.*.self_attn", "model.layers.*.mlp.router", "model.embed_tokens",
        "lm_head"]}}


def v2lite_tensors(cfg):
    """(name, shape, kind) of DeepSeek-V2-Lite's checkpoint in HF names."""
    H, V, I, Im = cfg["hidden_size"], cfg["vocab_size"], cfg["intermediate_size"], \
        cfg["moe_intermediate_size"]
    hq, dn, dr, dv, L = (cfg[k] for k in ("num_attention_heads", "qk_nope_head_dim",
                                          "qk_rope_head_dim", "v_head_dim", "kv_lora_rank"))
    out = [("model.embed_tokens.weight", (V, H), "w")]
    for i in range(cfg["num_hidden_layers"]):
        P = f"model.layers.{i}"
        out += [(f"{P}.input_layernorm.weight", (H,), "norm"),
                (f"{P}.post_attention_layernorm.weight", (H,), "norm"),
                (f"{P}.self_attn.q_proj.weight", (hq * (dn + dr), H), "w"),
                (f"{P}.self_attn.kv_a_proj_with_mqa.weight", (L + dr, H), "w"),
                (f"{P}.self_attn.kv_a_layernorm.weight", (L,), "norm"),
                (f"{P}.self_attn.kv_b_proj.weight", (hq * (dn + dv), L), "w"),
                (f"{P}.self_attn.o_proj.weight", (H, hq * dv), "w")]
        if i < cfg["first_k_dense_replace"]:
            out += [(f"{P}.mlp.{n}.weight", s, "w") for n, s in (
                ("gate_proj", (I, H)), ("up_proj", (I, H)), ("down_proj", (H, I)))]
            continue
        out.append((f"{P}.mlp.gate.weight", (cfg["n_routed_experts"], H), "w"))
        for e in range(cfg["n_routed_experts"]):
            out += [(f"{P}.mlp.experts.{e}.{n}.weight", s, "w") for n, s in (
                ("gate_proj", (Im, H)), ("up_proj", (Im, H)), ("down_proj", (H, Im)))]
        Is = Im * cfg["n_shared_experts"]
        out += [(f"{P}.mlp.shared_experts.{n}.weight", s, "w") for n, s in (
            ("gate_proj", (Is, H)), ("up_proj", (Is, H)), ("down_proj", (H, Is)))]
    out += [("model.norm.weight", (H,), "norm"), ("lm_head.weight", (V, H), "w")]
    return out


def gptoss_tensors(cfg):
    """(name, shape, kind) of GPT-OSS-20B's published MXFP4 checkpoint."""
    H, V, I, E = cfg["hidden_size"], cfg["vocab_size"], cfg["intermediate_size"], \
        cfg["num_local_experts"]
    hq, hkv, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    out = [("model.embed_tokens.weight", (V, H), "w")]
    for i in range(cfg["num_hidden_layers"]):
        P, M = f"model.layers.{i}", f"model.layers.{i}.mlp"
        out += [(f"{P}.input_layernorm.weight", (H,), "norm"),
                (f"{P}.post_attention_layernorm.weight", (H,), "norm")]
        for n, rows in (("q_proj", hq * d), ("k_proj", hkv * d), ("v_proj", hkv * d)):
            out += [(f"{P}.self_attn.{n}.weight", (rows, H), "w"),
                    (f"{P}.self_attn.{n}.bias", (rows,), "bias")]
        out += [(f"{P}.self_attn.o_proj.weight", (H, hq * d), "w"),
                (f"{P}.self_attn.o_proj.bias", (H,), "bias"),
                (f"{P}.self_attn.sinks", (hq,), "sinks"),
                (f"{M}.router.weight", (E, H), "w"), (f"{M}.router.bias", (E,), "bias"),
                (f"{M}.experts.gate_up_proj_blocks", (E, 2 * I, H // 32, 16), "blocks"),
                (f"{M}.experts.gate_up_proj_scales", (E, 2 * I, H // 32), "scales"),
                (f"{M}.experts.gate_up_proj_bias", (E, 2 * I), "bias"),
                (f"{M}.experts.down_proj_blocks", (E, H, I // 32, 16), "blocks"),
                (f"{M}.experts.down_proj_scales", (E, H, I // 32), "scales"),
                (f"{M}.experts.down_proj_bias", (E, H), "bias")]
    out += [("model.norm.weight", (H,), "norm"), ("lm_head.weight", (V, H), "w")]
    return out


def write_checkpoint(path, config, tensors, shards=2):
    """config.json and `shards` safetensors shards with their index, the
    tensors made on the card from a generator seeded 0: weights N(0, 0.02)
    in bf16, norms 1 + N(0, 0.05), biases N(0, 0.02), sinks N(0, 1), MXFP4
    blocks random bytes (every byte is two valid e2m1 codes) and e8m0
    scales in 118-127. Returns the bytes written."""
    import math
    import os

    import torch
    from krasis_tpu_torch.utils.safetensors_io import write_safetensors

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    g = torch.Generator(device=LOAD_DEVICE)
    g.manual_seed(0)

    def make(shape, kind):
        if kind == "blocks":
            return torch.randint(0, 256, shape, generator=g, device=LOAD_DEVICE, dtype=torch.uint8)
        if kind == "scales":
            return torch.randint(118, 128, shape, generator=g, device=LOAD_DEVICE, dtype=torch.uint8)
        x = torch.randn(shape, generator=g, device=LOAD_DEVICE)
        x = {"w": x * 0.02, "bias": x * 0.02, "norm": 1.0 + x * 0.05, "sinks": x}[kind]
        return x.to(torch.bfloat16)

    total = sum(math.prod(s) * (1 if k in ("blocks", "scales") else 2) for _, s, k in tensors)
    weight_map, written, start = {}, 0, 0
    for n in range(shards):
        shard = f"model-{n + 1:05d}-of-{shards:05d}.safetensors"
        part, size = {}, 0
        for name, shape, kind in tensors[start:]:
            if size >= total / shards and n < shards - 1:
                break
            part[name] = make(shape, kind).cpu()
            size += part[name].numel() * part[name].element_size()
            weight_map[name] = shard
        start += len(part)
        write_safetensors(os.path.join(path, shard), part)
        written += size
        del part
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": written}, "weight_map": weight_map}, f)
    return written


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (a NaN may carry another payload)."""
    import torch

    a, b = a.detach().cpu().reshape(-1), b.detach().cpu().reshape(-1)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    same = a.view(ints) == b.view(ints)
    if a.dtype.is_floating_point:
        same |= torch.isnan(a) & torch.isnan(b)
    return bool(same.all())


def leaves(tree, prefix=""):
    """(path, tensor) pairs of a parameter tree; a QTensor gives .q and
    .scales."""
    from krasis_tpu_torch.quant import QTensor

    if isinstance(tree, QTensor):
        yield f"{prefix}.q", tree.q
        yield f"{prefix}.scales", tree.scales
    elif isinstance(tree, dict):
        for k, v in tree.items():
            if k != "_layer_idx":
                yield from leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def scale_moves(w, bits: int, gs: int):
    """The on-card quantizer's division (ROADMAP C-5): groups of w [K, N] (on
    the card) whose f32 scale amax / qmax, and whose bf16 scale, differ
    between a division by a Python float (PyTorch multiplies by its
    reciprocal on CUDA; quant.quantize took it before C-5) and by a 0-dim tensor
    (IEEE division, as quantize_np), with the largest change of a
    dequantized weight that the bf16 moves make."""
    import torch

    K, N = w.shape
    if not bool(torch.isfinite(w).all()):
        raise AssertionError("scale_moves wants finite weights")
    g = w.to(torch.float32).reshape(K // gs, gs, N)
    amax = g.abs().amax(dim=1, keepdim=True)
    qmax = 7.0 if bits == 4 else 127.0
    one = torch.ones_like(amax)
    by_float = torch.where(amax == 0, one, amax / qmax)
    by_tensor = torch.where(amax == 0, one, amax / torch.full((), qmax, device=w.device))
    f32 = int((by_float != by_tensor).sum())
    old, new = by_float.to(torch.bfloat16), by_tensor.to(torch.bfloat16)
    moved = int((old != new).sum())
    delta = 0.0
    if moved:
        lo, hi = (-8, 7) if bits == 4 else (-128, 127)

        def deq(s):
            s = s.to(torch.float32)
            return torch.clamp(torch.round(g * (1.0 / s)), lo, hi) * s
        delta = float((deq(old) - deq(new)).abs().max())
    return {"f32_scales_moved": f32, "bf16_scales_moved": moved, "groups": amax.numel(),
            "max_abs_weight_change": delta}


def cpu_checks(label, path, cfg, quant, params, rng):
    """Bit for bit against the port's CPU load of the same checkpoint
    tensors: every non-expert leaf (head, each layer, the folded shared
    leaves), experts 0, the last and two seeded ones of every MoE layer,
    the folded virtual experts, and (MXFP4) the decode on the card. Returns
    the number of tensors compared."""
    import torch
    from krasis_tpu_torch.models.loader import WeightLoader, _empty_qtensor
    from krasis_tpu_torch.models.params import fold_layer, fold_width, layer_specs
    from krasis_tpu_torch.quant import dequant_mxfp4, pick_group_size, quantize

    wl = WeightLoader(cfg, quant, device="cpu")
    n = 0

    def check(name, got, want):
        nonlocal n
        if not same_bits(got, want):
            raise AssertionError(f"{label}: {name} on the card differs from the CPU's load")
        n += 1

    for name, want in wl.load_head().items():
        for sub, t in leaves(want, name):
            check(sub, dict(leaves(params[name], name))[sub], t)
    E, H, I = cfg.n_routed_experts, cfg.hidden_size, cfg.moe_intermediate_size
    bits, gs = quant.expert_bits, quant.group_size
    fold = quant.fold_shared_decode and cfg.n_shared_experts > 0
    for i, spec in enumerate(layer_specs(cfg)):
        card = params["layers"][i]
        experts = {}
        if spec.mlp_kind == "moe":
            pick = [0, E - 1] + sorted(rng.choice(range(1, E - 1), 2, replace=False).tolist())
            wl.experts = pick

            def sink(e, w13_e, w2_e):
                experts[e] = (quantize(w13_e, bits, gs), quantize(w2_e, bits, gs))
            lp = wl._load_layer(i, spec, expert_sink=sink)
            if sorted(experts) != sorted(pick):
                raise AssertionError(f"{label}: layer {i} read experts {sorted(experts)}")
            n_virt = 0
            if fold and "shared_w13" in lp:
                Is = lp["shared_w13"].n_dim // 2
                n_virt = fold_width(cfg, bits, pick_group_size(I, gs), Is, "w13_bias" in lp)
            lp["w13"] = _empty_qtensor((E + n_virt, H, 2 * I), bits, pick_group_size(H, gs),
                                       "cpu")
            lp["w2"] = _empty_qtensor((E + n_virt, I, H), bits, pick_group_size(I, gs), "cpu")
            lp = fold_layer(lp, cfg, reserved=True)
            for name in ("w13", "w2"):
                if tuple(card[name].q.shape) != tuple(lp[name].q.shape):
                    raise AssertionError(f"{label}: layer {i} {name} {tuple(card[name].q.shape)}")
                for e, qts in experts.items():
                    qt = qts[0 if name == "w13" else 1]
                    check(f"layer {i} {name}[{e}].q", card[name].q[e], qt.q)
                    check(f"layer {i} {name}[{e}].scales", card[name].scales[e], qt.scales)
                if n_virt:
                    check(f"layer {i} {name} virtual .q", card[name].q[E:], lp[name].q[E:])
                    check(f"layer {i} {name} virtual .scales", card[name].scales[E:],
                          lp[name].scales[E:])
            M = f"model.layers.{i}.mlp.experts"
            if f"{M}.gate_up_proj_blocks" in wl.st:
                for e in pick:
                    for part in ("gate_up_proj", "down_proj"):
                        b, s = (wl.st.tensor(f"{M}.{part}_{k}")[e] for k in ("blocks", "scales"))
                        check(f"layer {i} {part}[{e}] MXFP4 decode",
                              dequant_mxfp4(b.to(LOAD_DEVICE), s.to(LOAD_DEVICE)), dequant_mxfp4(b, s))
            rest = {k: v for k, v in lp.items() if k not in ("w13", "w2")}
        else:
            rest = wl._load_layer(i, spec)
        mine = {k for k in card if k not in ("w13", "w2", "_layer_idx")}
        if mine != set(rest):
            raise AssertionError(f"{label}: layer {i} leaves {sorted(mine ^ set(rest))} differ")
        for name, want in rest.items():
            got = dict(leaves(card[name], name))
            for sub, t in leaves(want, name):
                check(f"layer {i} {sub}", got[sub], t)
    wl.experts = None
    return n


def load_family(label, preset, config, tensors, quant, root, on_path, rng):
    """One checkpoint: write it, load it with an empty cache (the build)
    and again (the hit), hold the hit to the build and the sampled leaves
    to the CPU's, count the on-card quantizer's scale moves, and answer a
    2048 + 16 greedy request on both loads."""
    import dataclasses
    import gc
    import os

    import torch
    from krasis_tpu_torch.config import ModelConfig, preset_config
    from krasis_tpu_torch.models.loader import WeightLoader, _cache_dir, load_params
    from krasis_tpu_torch.models.params import layer_specs
    from krasis_tpu_torch.ops import flash_attention as fa
    from krasis_tpu_torch.ops import moe
    from krasis_tpu_torch.runtime.engine import Engine

    card = card_line()
    path = os.path.join(root, preset)
    t0 = time.perf_counter()
    nbytes = write_checkpoint(path, config, tensors(config))
    print(f"[load] {label}: wrote {nbytes / 1e9:.2f} GB in 2 shards in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    cfg = ModelConfig.from_model_path(path)
    ref = preset_config(preset)
    diff = {k: (v, getattr(ref, k)) for k, v in dataclasses.asdict(cfg).items()
            if v != getattr(ref, k) and k not in ("model_path",)}
    print(f"[load] {label}: config.json fields that differ from the {preset} preset: "
          f"{json.dumps({k: [str(a)[:60], str(b)[:60]] for k, (a, b) in diff.items()})}",
          flush=True)
    for k in ("hidden_size", "intermediate_size", "moe_intermediate_size", "vocab_size",
              "n_routed_experts", "num_attention_heads", "num_key_value_heads"):
        if getattr(cfg, k) != getattr(ref, k):
            raise AssertionError(f"{label}: {k} {getattr(cfg, k)} is not the preset's")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build = load_params(cfg, quant)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    peak_build = torch.cuda.max_memory_allocated()
    cache = _cache_dir(cfg, quant)
    cache_bytes = sum(os.path.getsize(os.path.join(cache, f)) for f in os.listdir(cache))
    t0 = time.perf_counter()
    hit = load_params(cfg, quant)
    torch.cuda.synchronize()
    t_hit = time.perf_counter() - t0
    peak_hit = torch.cuda.max_memory_allocated()
    lb, lh = dict(leaves(build)), dict(leaves(hit))
    if lb.keys() != lh.keys() or not all(torch.equal(lb[k], lh[k]) for k in lb):
        raise AssertionError(f"{label}: the cache hit differs from the build")
    print(f"[load] {label}: build {t_build:.2f} s ({nbytes / 1e9 / t_build:.2f} GB/s of "
          f"checkpoint, quantized on the card, cache {cache_bytes / 1e9:.2f} GB), hit "
          f"{t_hit:.2f} s ({cache_bytes / 1e9 / t_hit:.2f} GB/s of cache), the files in the page "
          f"cache; hit = build on all {len(lb)} tensors; peak {peak_build / 2**30:.2f} GiB "
          f"(build), {peak_hit / 2**30:.2f} GiB (both loads held) on {card}", flush=True)

    t0 = time.perf_counter()
    checked = cpu_checks(label, path, cfg, quant, hit, rng)
    print(f"[load] {label}: {checked} tensors bit-equal to the port's CPU load "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # the on-card quantizer's division: every expert of the first MoE layer
    # and the lm_head, from this checkpoint
    wl = WeightLoader(cfg, quant)
    i = next(j for j, s in enumerate(layer_specs(cfg)) if s.mlp_kind == "moe")
    moved = {"lm_head": scale_moves(wl._get("lm_head.weight").float().T, 8, quant.group_size)}
    tot = None
    for _, w13_e, w2_e in wl._iter_experts(i):
        for w in (w13_e, w2_e):
            m = scale_moves(w, quant.expert_bits, quant.group_size)
            tot = m if tot is None else {k: (max(v, m[k]) if k.startswith("max") else v + m[k])
                                         for k, v in tot.items()}
    moved[f"layer {i} experts"] = tot
    del wl
    print("[quant] " + json.dumps({"model": preset, "card": card, "groups": moved}), flush=True)

    C = counters()
    prompt = rng.integers(100, cfg.vocab_size - 100, 2048).tolist()
    tokens = []
    for name, params in (("hit", hit), ("build", build)):
        eng = Engine(cfg, quant, params, max_len=4096)
        for m, attr in C.values():
            setattr(m, attr, 0)
        fa.form_launches.clear()
        moe.plain_routes.update(ragged_plain=0, gathered_plain=0)
        res = eng.generate(prompt, max_new_tokens=16, stop_ids={-1})
        counts = {k: getattr(m, attr) for k, (m, attr) in C.items()}
        if not res.finite or len(res.tokens) != 16:
            raise AssertionError(f"{label}: request on the {name} load: finite {res.finite}, "
                                 f"{len(res.tokens)} tokens")
        if any(moe.plain_routes.values()):
            raise AssertionError(f"{label}: MoE calls on a plain form {moe.plain_routes}")
        missing = [k for k in on_path if counts[k] <= 0]
        if missing:
            raise AssertionError(f"{label}: {missing} never launched on the loaded model")
        print("[request] " + json.dumps({
            "model": f"{preset} checkpoint ({cfg.num_hidden_layers} layers)", "load": name,
            "prompt": len(prompt), "tokens": len(res.tokens), "prefill_s": res.prefill_s,
            "decode_s": res.decode_s, "launches": counts, "K2_forms": dict(fa.form_launches),
            "plain_moe_routes": dict(moe.plain_routes)}), flush=True)
        tokens.append(res.tokens)
        del eng
    if tokens[0] != tokens[1]:
        raise AssertionError(f"{label}: the hit load's tokens {tokens[0]} differ from the "
                             f"build load's {tokens[1]}")
    print(f"[load] {label}: 2048 + 16 greedy tokens equal on both loads; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}", flush=True)
    del build, hit, lb, lh
    gc.collect()
    torch.cuda.empty_cache()


def f32_scale_moves():
    """scale_moves on f32 inputs, where a quotient can sit on a bf16
    rounding edge: N(0, 0.02) at V2-Lite's lm_head at int8 and int4, and
    fp8 blocks dequantized (DeepSeek-V3's input format; e4m3 values well
    inside its ±448) at a V3 expert's w13 and w2 at int4."""
    import torch
    from krasis_tpu_torch.quant import dequant_fp8_block

    g = torch.Generator(device=LOAD_DEVICE)
    g.manual_seed(0)
    w = torch.randn((2048, 102400), generator=g, device=LOAD_DEVICE) * 0.02
    out = {"f32 N(0, 0.02) [2048, 102400] int8 gs 128": scale_moves(w, 8, 128),
           "f32 N(0, 0.02) [2048, 102400] int4 gs 128": scale_moves(w, 4, 128)}
    for K, N in ((7168, 4096), (2048, 7168)):
        w8 = (torch.randn((N, K), generator=g, device=LOAD_DEVICE) * 30).to(torch.float8_e4m3fn)
        sinv = 1e-4 + 1e-3 * torch.rand((-(-N // 128), -(-K // 128)), generator=g,
                                        device=LOAD_DEVICE)
        w = dequant_fp8_block(w8, sinv).T.contiguous()                # [in K, out N]
        out[f"fp8 blocks dequantized [{K}, {N}] int4 gs 128"] = scale_moves(w, 4, 128)
    print("[quant] " + json.dumps({"model": "f32 inputs", "card": card_line(), "groups": out}),
          flush=True)


def gguf_card_checks():
    """The GGUF codecs on the card against the CPU, bit for bit, over ~4 MB
    of seeded blocks of each type (finite f16 scales)."""
    import torch
    from krasis_tpu_torch.utils import gguf

    g = torch.Generator(device=LOAD_DEVICE)
    g.manual_seed(0)
    scale_at = {gguf.GGML_Q8_0: (0,), gguf.GGML_Q4_0: (0,), gguf.GGML_Q5_0: (0,),
                gguf.GGML_Q4_K: (0, 2), gguf.GGML_Q5_K: (0, 2), gguf.GGML_Q6_K: (208,)}
    done = []
    for ttype, name in sorted(gguf.TYPE_NAMES.items()):
        be, bb = gguf.BLOCK_INFO[ttype]
        n_blocks = (4 << 20) // bb
        if be == 1:
            dt = {gguf.GGML_F32: torch.float32, gguf.GGML_F16: torch.float16,
                  gguf.GGML_BF16: torch.bfloat16}[ttype]
            raw = torch.randn((n_blocks,), generator=g, device=LOAD_DEVICE).to(dt).view(torch.uint8)
        else:
            raw = torch.randint(0, 256, (n_blocks, bb), generator=g, device=LOAD_DEVICE,
                                dtype=torch.uint8)
            for off in scale_at[ttype]:
                d = (torch.randn((n_blocks,), generator=g, device=LOAD_DEVICE) * 0.05)
                raw[:, off:off + 2] = d.to(torch.float16).view(torch.uint8).reshape(n_blocks, 2)
        raw = raw.reshape(-1)
        n = raw.numel() // bb * be
        if not same_bits(gguf.dequantize_raw(raw, ttype, n),
                         gguf.dequantize_raw(raw.cpu(), ttype, n)):
            raise AssertionError(f"GGUF {name}: the card's decode differs from the CPU's")
        done.append(f"{name} {raw.numel() / 2**20:.1f} MB")
    print(f"[load] GGUF codecs bit-equal on the card and the CPU: {', '.join(done)}", flush=True)


def load_phase():
    """9. Checkpoints on disk: DeepSeek-V2-Lite in bf16 safetensors (3
    layers) and GPT-OSS-20B in its MXFP4 layout (2 layers), at full width,
    written into a temporary directory that also holds the weight cache
    (KRASIS_TPU_HOME), removed at the end; then the GGUF codecs. Beside
    10b, the launcher serves the V2-Lite checkpoint (16 (c))."""
    import os
    import shutil
    import tempfile

    import numpy as np
    from krasis_tpu_torch.config import QuantConfig

    root = tempfile.mkdtemp(prefix="chip_smoke_load_")
    home = os.environ.get("KRASIS_TPU_HOME")
    os.environ["KRASIS_TPU_HOME"] = os.path.join(root, "home")
    t0 = time.perf_counter()
    try:
        rng = np.random.default_rng(0)
        quant = QuantConfig(expert_bits=4, group_size=128)
        load_family("DeepSeek-V2-Lite bf16 safetensors (3 layers)", "deepseek-v2-lite",
                    V2LITE_CONFIG, v2lite_tensors, quant, root, ("K1", "K2", "K3", "K4"), rng)
        t_serve = time.perf_counter()
        path = os.path.join(root, "deepseek-v2-lite")
        src = os.path.join(ROOT, SERVE_TOKENIZER)
        for f in os.listdir(src):
            shutil.copy(os.path.join(src, f), path)
        # 16 (c): the launcher serves this checkpoint from a process beside 10b
        launched = in_thread(launcher_check, path, os.environ["KRASIS_TPU_HOME"])
        try:
            serve_checkpoint_phase(path, quant)
            print(f"[time] serve phase, in process: {time.perf_counter() - t_serve:.1f} s",
                  flush=True)
            offload_load_check(path, quant, rng)
        finally:
            launched()
        for done in ("deepseek-v2-lite", "home"):
            shutil.rmtree(os.path.join(root, done))
        load_family("GPT-OSS-20B MXFP4 (2 layers)", "gpt-oss-20b", GPTOSS_CONFIG,
                    gptoss_tensors, QuantConfig(expert_bits=4, group_size=32), root,
                    ("K1", "K2", "K6", "K7"), rng)
        f32_scale_moves()
        gguf_card_checks()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if home is None:
            os.environ.pop("KRASIS_TPU_HOME", None)
        else:
            os.environ["KRASIS_TPU_HOME"] = home
    print(f"[time] load phase {time.perf_counter() - t0:.1f} s", flush=True)


# --------------------------------------------------------------------------
# 10. [serve]: the OpenAI-compatible server, in a subprocess and in process
# --------------------------------------------------------------------------

SERVE_TOKENIZER = "tests/data/torch_tokenizer"     # the committed test tokenizer
SERVE_DEVICE = "cuda"    # where the in-process server's engine runs
SERVE_SYNTHETIC = ("--synthetic", "deepseek-v2-lite", "--expert-activation", "int8")
SERVE_ON_PATH = ("K1", "K2", "K3", "K4")
SERVE_FORMS = ("one-launch", "split")


def http_call(port, method, path, body=None, timeout=600.0):
    """(status, content type, body bytes) of one request on its own connection."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def sse_stream(port, body, timeout=600.0):
    """Stream one request: (chunks, seconds to the role chunk, seconds to
    the first content chunk and its chunk index, seconds to [DONE])."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    if r.status != 200 or r.getheader("Content-Type") != "text/event-stream":
        raise AssertionError(f"[serve] stream answered {r.status} {r.read()[:300]!r}")
    chunks, t_role, t_content, done = [], None, None, False
    for raw in r:
        line = raw.decode().strip()
        if not line.startswith("data: "):
            continue
        if line == "data: [DONE]":
            done = True
            break
        obj = json.loads(line[6:])
        delta = (obj["choices"] or [{}])[0].get("delta", {})
        if t_role is None and delta.get("role") == "assistant":
            t_role = time.perf_counter() - t0
        if t_content is None and delta.get("content"):
            t_content = (time.perf_counter() - t0, len(chunks))
        chunks.append(obj)
    t_done = time.perf_counter() - t0
    conn.close()
    if not done or t_role is None:
        raise AssertionError("[serve] the stream lacks its role chunk or [DONE]")
    return chunks, t_role, t_content, t_done


def stream_text(chunks) -> str:
    return "".join((c["choices"] or [{}])[0].get("delta", {}).get("content", "") for c in chunks)


def stream_usage(chunks):
    return next((c["usage"] for c in chunks if c.get("usage")), None)


def free_port() -> int:
    return free_ports(1)[0]


def free_ports(n: int) -> list:
    """n distinct free ports, their sockets bound together and then closed."""
    import socket

    with contextlib.ExitStack() as stack:
        socks = [stack.enter_context(socket.socket()) for _ in range(n)]
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]


def serve_more_requests(port, req, ids, new, fail):
    """Phase 10a's requests after the first two: a stop string that ends a
    stream early, a stream the client drops (the next request must be
    answered promptly), two requests at once. Returns (the stop, the token
    it ended at, the request after the drop and alone, s; the pair, s)."""
    import threading

    # the stop: text across the boundary of tokens 8 and 9; the stream
    # must end where the stop's first occurrence completes (random weights
    # repeat tokens, so that can be earlier)
    pieces = [f"<{t}>" for t in ids]
    whole = "".join(pieces)
    cut = len("".join(pieces[:8]))
    stop = whole[cut - 3:cut + 3]
    at = whole.find(stop)
    k = next(j for j in range(1, new + 1) if len("".join(pieces[:j])) >= at + len(stop))
    cut_chunks, _, _, _ = sse_stream(port, {**req, "stream": True, "stop": [stop],
                                            "stream_options": {"include_usage": True}})
    got = stream_text(cut_chunks)
    if got != whole[:at] or stream_usage(cut_chunks)["completion_tokens"] != k:
        fail(f"the stop {stop!r} did not end the stream at token {k}: {got[:80]!r}, "
             f"{stream_usage(cut_chunks)}")

    # a client that drops a long stream: its decode must stop, so a short
    # request right after is answered in about its own time
    t_short0 = time.perf_counter()
    http_call(port, "POST", "/v1/chat/completions", {**req, "max_tokens": 4})
    t_short = time.perf_counter() - t_short0
    import socket
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    raw = json.dumps({**req, "max_tokens": 2048, "stream": True}).encode()
    s.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\nContent-Type: "
              b"application/json\r\nContent-Length: " + str(len(raw)).encode()
              + b"\r\n\r\n" + raw)
    s.recv(256)
    s.close()
    t_next0 = time.perf_counter()
    status, _, body = http_call(port, "POST", "/v1/chat/completions",
                                {**req, "max_tokens": 4})
    t_next = time.perf_counter() - t_next0
    if status != 200 or t_next > max(10.0, 4 * t_short):
        fail(f"after a dropped stream the next request took {t_next:.2f} s "
             f"(alone {t_short:.2f} s)")

    results = []

    def worker():
        results.append(http_call(port, "POST", "/v1/chat/completions",
                                 {**req, "max_tokens": 16}))
    ts = [threading.Thread(target=worker) for _ in range(2)]
    t_pair0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    t_pair = time.perf_counter() - t_pair0
    if len(results) != 2 or any(r[0] != 200 for r in results) or any(
            [int(x) for x in json.loads(r[2])["choices"][0]["message"]["content"].split()]
            != ids[:16] for r in results):
        fail(f"two concurrent requests: {[(r[0], r[2][:120]) for r in results]}")

    return stop, k, t_next, t_short, t_pair


def serve_subprocess_phase(server_args=SERVE_SYNTHETIC, new=64, expect_log=(),
                           every_request=True, port=None, procs=None, run_log=None):
    """10a. ``python -m krasis_tpu_torch.server`` at full width on the native
    transport, as a user starts it (with ``--slots N`` among `server_args`,
    through a BatchScheduler): health, models, a 404, a 512-id prompt
    (the synthetic path's cap) with `new` greedy tokens unstreamed and then
    streamed with logprobs and usage (the same ids), a stop string that ends
    a stream early, a stream the client drops (the next request must be
    answered promptly), two requests at once; then SIGTERM and exit 0. Each
    tuple of `expect_log` must have all its strings in one line of the
    server's log, which is printed. Without `every_request`, only the unstreamed and
    streamed 512-id requests run between the start and SIGTERM. `port` is
    the server's (a free one by default); the server's process is appended
    to `procs` where given, so that a caller can stop it. The server runs in
    its own temporary directory, where it opens its run log, unless
    `run_log` (phase 16 (b), ``cli_serve_command``) starts it through the
    CLI in a directory it shares with another server."""
    import os
    import shutil
    import signal
    import tempfile

    card = card_line()
    home = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    port = port or free_port()
    log_path = os.path.join(home, "server.log")
    if run_log is None:
        cmd, cwd = ["-m", "krasis_tpu_torch.server", *server_args, "--server-backend",
                    "native"], home
    else:
        cmd, cwd = cli_serve_command(server_args, run_log), run_log["dir"]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, *cmd, "--port", str(port)], stdout=log,
                                stderr=subprocess.STDOUT, env=subprocess_env(home), cwd=cwd)
    if procs is not None:
        procs.append(proc)

    def fail(msg):
        with open(log_path) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"[serve] {msg}; server log:\n{tail}")

    try:
        while True:
            if proc.poll() is not None:
                fail(f"the server exited with {proc.returncode} before answering")
            try:
                if http_call(port, "GET", "/health", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            if time.perf_counter() - t0 > 600:
                fail("no /health within 600 s")
            time.sleep(0.5)
        t_up = time.perf_counter() - t0
        status, _, body = http_call(port, "GET", "/v1/models")
        model = json.loads(body)["data"][0]["id"]
        if status != 200 or model != "synthetic/" + server_args[1]:
            fail(f"/v1/models answered {status} {body!r}")
        if http_call(port, "GET", "/nope")[0] != 404:
            fail("/nope did not answer 404")
        # the native transport answers while run_server is still writing the
        # registry entry (it needs the bound port): give it a moment
        entry = os.path.join(home, "servers", f"{port}.json")

        def registered():
            try:
                with open(entry) as f:
                    return json.load(f)["port"] == port
            except (OSError, ValueError):
                return False
        deadline = time.perf_counter() + 10
        while not registered() and time.perf_counter() < deadline:
            time.sleep(0.05)
        if not registered():
            fail("the registry entry is missing")

        text = "".join(chr(0x41 + (i * 7) % 26) for i in range(600))      # hashes to 512 ids
        req = {"messages": [{"role": "user", "content": text}], "max_tokens": new,
               "temperature": 0.0}
        status, _, body = http_call(port, "POST", "/v1/chat/completions", req)
        if status != 200:
            fail(f"the request answered {status} {body[:300]!r}")
        full = json.loads(body)
        ids = [int(t) for t in full["choices"][0]["message"]["content"].split()]
        usage = full["usage"]
        if len(ids) != new or usage != {"prompt_tokens": 512, "completion_tokens": new,
                                        "total_tokens": 512 + new}:
            fail(f"{len(ids)} tokens, usage {usage}")
        chunks, t_role, t_content, t_done = sse_stream(port, {
            **req, "stream": True, "logprobs": True, "stream_options": {"include_usage": True}})
        streamed = [int(t) for t in stream_text(chunks).replace("<", " ").replace(">", " ").split()]
        lps = [e for c in chunks if c["choices"] and c["choices"][0].get("logprobs")
               for e in c["choices"][0]["logprobs"]["content"]]
        if streamed != ids:
            fail(f"streamed ids {streamed[:8]}... differ from the unstreamed {ids[:8]}...")
        if stream_usage(chunks) != usage or len(lps) != new or not all(
                -1e30 < e["logprob"] <= 0.0 for e in lps):
            fail(f"stream usage {stream_usage(chunks)}, {len(lps)} logprob entries")

        if every_request:
            stop, k, t_next, t_short, t_pair = serve_more_requests(port, req, ids, new, fail)

        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        if rc != 0:
            fail(f"the server exited with {rc} on SIGTERM")
        if os.listdir(os.path.join(home, "servers")):
            fail("the registry entry outlived the server")
        with open(log_path) as f:
            log_lines = f.read().splitlines()
        for want in expect_log:
            hits = [line for line in log_lines if all(part in line for part in want)]
            if not hits:
                fail(f"no line of the server's log holds {want}")
            say(f"[serve] server log: {hits[0]}")
        # the single-request path reports its engine's timing; the scheduler's does not
        timing = full.get("timing")
        timing = (f"timing prefill {timing['prefill_tok_s']} tok/s, decode "
                  f"{timing['decode_tok_s']} tok/s; " if timing else "")
        more = (f"the stop {stop!r} ended the stream at token {k}; after a dropped 2048-token "
                f"stream the next 4-token request took {t_next:.2f} s (alone {t_short:.2f} s); "
                f"two concurrent 16-token requests {t_pair:.2f} s, both answered; "
                if every_request else "")
        say(f"[serve] subprocess {'cli serve ' if run_log else ''}{' '.join(server_args)}, "
            f"native transport: up in "
              f"{t_up:.1f} s; 512 + {new} greedy: unstreamed ids = streamed ids, usage right; "
              f"role chunk at {1e3 * t_role:.1f} ms, first content chunk at "
              f"{1e3 * t_content[0]:.1f} ms, [DONE] at {t_done:.2f} s; {timing}{more}exit 0 on "
              f"SIGTERM; {card}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(home, ignore_errors=True)


def say(msg: str) -> None:
    """One line in one write: for lines printed while other threads print."""
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


def serve_beside(work, runs=None, beside=()):
    """The servers of `runs` (default SERVE_RUNS), each as its own process
    driven from a thread of this one, and the callables of `beside`, each
    in a thread, all started together and run while `work()` runs here;
    then wait for them. A failure of `work` stops the servers; the first
    failure raises. The servers share the card and the host with `work`, so
    the rates either prints are taken beside the others. The runs through
    the CLI start one after another in one working directory, from one
    config file, and their run logs are checked at the end (16 (b))."""
    import shutil
    import tempfile

    runs = SERVE_RUNS if runs is None else runs
    procs = []
    shared = tempfile.mkdtemp(prefix="chip_smoke_cli_serve_")
    config = os.path.join(shared, "serve.cfg")
    with open(config, "w") as f:
        f.write(RUN_LOG_CONFIG)
    notes, logs = [], []
    for args in runs:
        run_log = None
        if args[4]:
            notes.append(f"chip_smoke 16 (b), server {len(notes) + 1}: {' '.join(args[0])}")
            run_log = {"dir": shared, "config": config, "note": notes[-1],
                       "after": notes[-2] if len(notes) > 1 else None}
        logs.append(run_log)

    def serve_run(args, port, run_log):
        t0 = time.perf_counter()
        serve_subprocess_phase(*args[:4], port=port, procs=procs, run_log=run_log)
        say(f"[time] serve phase, server subprocess {' '.join(args[0][2:])}: "
            f"{time.perf_counter() - t0:.1f} s (beside the others)")

    t0 = time.perf_counter()
    waits = [in_thread(serve_run, args, port, run_log)
             for args, port, run_log in zip(runs, free_ports(len(runs)), logs)]
    waits += [in_thread(fn) for fn in beside]
    try:
        failed = None
        try:
            work()
        except BaseException as e:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            failed = e
        for wait in waits:                 # every thread ends before the first failure raises
            try:
                wait()
            except BaseException as e:
                failed = failed or e
        if failed is not None:
            raise failed
        if len(notes) > 1:
            run_log_check(shared, notes)
    finally:
        shutil.rmtree(shared, ignore_errors=True)
    say(f"[time] served subprocesses and the work beside them: "
        f"{time.perf_counter() - t0:.1f} s")


def long_message(tok, target=2000) -> str:
    """A user message whose chat template gives about `target` ids."""
    words = ("The server streams tokens as they are decoded, and a client that "
             "leaves cancels the rest of the request. ")
    msg = words
    while len(tok.apply_chat_template([{"role": "user", "content": msg}])) < target:
        msg += words
    return msg


def serve_checkpoint_phase(path, quant):
    """10b. The engine over the checkpoint at `path` (its weight cache warm)
    with the committed test tokenizer (copied in by the caller), served in
    process on each transport:
    a chat message that templates to about 2048 ids (a whole prefill chunk)
    and a short one, 16 greedy tokens each with logprobs, and the short one
    with 64 tokens streamed. usage.prompt_tokens must be the template's
    length, the served text and per-token logprobs those of Engine.generate
    on the same ids (the tokenizer knows only ids below 4096 of the model's
    102400, so most tokens decode to no text and the logprobs carry the
    check), and the served requests must launch K1, K2 (both forms), K3 and
    K4 and no plain MoE route. Then the short request's 64 tokens in turns
    direct, served, served, direct (unstreamed and streamed) for the
    [serve] times."""
    import gc
    import os
    import shutil
    import statistics

    import torch
    from krasis_tpu_torch import server
    from krasis_tpu_torch.config import ModelConfig
    from krasis_tpu_torch.models.loader import load_params
    from krasis_tpu_torch.ops import flash_attention as fa
    from krasis_tpu_torch.ops import moe
    from krasis_tpu_torch.runtime.engine import Engine
    from krasis_tpu_torch.runtime.tokenizer import Tokenizer

    card = card_line()
    cfg = ModelConfig.from_model_path(path)
    eng = Engine(cfg, quant, load_params(cfg, quant, device=SERVE_DEVICE), max_len=4096,
                 device=SERVE_DEVICE)
    tok = Tokenizer(path)
    name = os.path.basename(path)
    short = [{"role": "user", "content": "Explain the os module in two sentences."}]
    cases = [([{"role": "user", "content": long_message(tok)}], 16), (short, 16)]
    direct = []
    for msgs, new in cases + [(short, 64)]:
        ids = tok.apply_chat_template(msgs)
        eng.generate(ids, max_new_tokens=new)                       # warm: the same shapes
        direct.append((ids, eng.generate(ids, max_new_tokens=new)))
    C = counters()
    for backend in ("native", "python"):
        httpd = server.start_temp_server(eng, tok, name, port=0, backend=backend)
        try:
            if httpd.backend != backend:
                raise AssertionError(f"[serve] asked for {backend}, got {httpd.backend}")
            for m, attr in C.values():
                setattr(m, attr, 0)
            fa.form_launches.clear()
            moe.plain_routes.update(ragged_plain=0, gathered_plain=0)
            served = [http_call(httpd.port, "POST", "/v1/chat/completions", {
                "messages": msgs, "max_tokens": new, "temperature": 0.0, "logprobs": True})
                for msgs, new in cases]
            chunks, t_role, t_content, _ = sse_stream(httpd.port, {
                "messages": short, "max_tokens": 64, "temperature": 0.0, "stream": True,
                "stream_options": {"include_usage": True}})
            counts = {k: getattr(m, attr) for k, (m, attr) in C.items()}
            forms = dict(fa.form_launches)
            missing = [k for k in SERVE_ON_PATH if counts[k] <= 0] + [
                f for f in SERVE_FORMS if not any(k.split("+")[0] == f and n > 0
                                                  for k, n in forms.items())]
            if missing or any(moe.plain_routes.values()):
                raise AssertionError(f"[serve] {backend}: not launched {missing}, plain MoE "
                                     f"routes {moe.plain_routes}")
            for (status, _, body), (ids, res) in zip(served, direct):
                obj = json.loads(body) if status == 200 else None
                if obj is None:
                    raise AssertionError(f"[serve] {backend}: {status} {body[:300]!r}")
                text = obj["choices"][0]["message"]["content"]
                lps = [e["logprob"] for e in obj["choices"][0]["logprobs"]["content"]]
                if obj["usage"]["prompt_tokens"] != len(ids) or \
                        obj["usage"]["completion_tokens"] != len(res.tokens):
                    raise AssertionError(f"[serve] {backend}: usage {obj['usage']}, template "
                                         f"{len(ids)} ids, {len(res.tokens)} tokens")
                if text != tok.decode(res.tokens) or len(lps) != len(res.tokens) or any(
                        abs(a - round(b, 6)) > 1e-6 for a, b in zip(lps, res.logprobs)):
                    raise AssertionError(f"[serve] {backend}: served text {text[:80]!r} or its "
                                         "logprobs differ from Engine.generate's")
                in_vocab = sum(t < len(tok.id_to_token) for t in res.tokens)
                print(f"[serve] {backend}: {len(ids)} + {len(res.tokens)}: usage, text and "
                      f"logprobs = Engine.generate's ({in_vocab} of {len(res.tokens)} tokens "
                      "have text)", flush=True)
            ids, res = direct[-1]
            want, got = tok.decode(res.tokens), stream_text(chunks)
            # the incremental decoder holds back a last incomplete character
            if stream_usage(chunks)["completion_tokens"] != len(res.tokens) or not (
                    got == want or (want.endswith("\ufffd") and want.startswith(got))):
                raise AssertionError(f"[serve] {backend}: the stream differs from "
                                     "Engine.generate's text")
            print(f"[serve] {backend}: launches {json.dumps(counts)}, K2 by form "
                  f"{json.dumps(forms)}, plain MoE routes {dict(moe.plain_routes)}", flush=True)

            # times, in turns: direct, served, served, direct
            req = {"messages": short, "max_tokens": 64, "temperature": 0.0}
            d_pre, d_dec, d_wall, s_pre, s_dec, st_wall, st_role, st_first = ([] for _ in range(8))
            for turn in ("direct", "served", "served", "direct"):
                if turn == "direct":
                    t0 = time.perf_counter()
                    r = eng.generate(tok.apply_chat_template(short), max_new_tokens=64)
                    d_wall.append(time.perf_counter() - t0)
                    d_pre.append(r.prefill_tok_s)
                    d_dec.append(r.decode_tok_s)
                    continue
                timing = json.loads(http_call(httpd.port, "POST", "/v1/chat/completions",
                                              req)[2])["timing"]
                s_pre.append(timing["prefill_tok_s"])
                s_dec.append(timing["decode_tok_s"])
                _, role, first, done = sse_stream(httpd.port, {**req, "stream": True})
                st_wall.append(done)
                st_role.append(role)
                st_first.append(first[0] if first else float("nan"))
            med = statistics.median
            print(f"[serve] {backend}: {len(ids)} + 64, medians of two turns each: direct "
                  f"generate prefill {med(d_pre):.2f} / decode {med(d_dec):.2f} tok/s, "
                  f"{1e3 * med(d_wall):.1f} ms; served unstreamed timing prefill "
                  f"{med(s_pre):.2f} / decode {med(s_dec):.2f} tok/s (decode "
                  f"{100 * (med(s_dec) / med(d_dec) - 1):+.1f}%); served streamed: role chunk "
                  f"{1e3 * med(st_role):.1f} ms, first content chunk {1e3 * med(st_first):.1f} "
                  f"ms (the first token with text), [DONE] {1e3 * med(st_wall):.1f} ms "
                  f"({100 * (med(st_wall) / med(d_wall) - 1):+.1f}% on the direct call's wall); "
                  f"{card}", flush=True)
        finally:
            httpd.shutdown()
    del eng
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# 11. [batch]: continuous batching (runtime/scheduler.py) on V2-Lite Q4
# --------------------------------------------------------------------------

BATCH_PROMPTS = (40, 512, 2048, 2500, 40, 600)   # (b): six requests at once on 4 slots
BATCH_NEW = 8        # tokens a request of (b) and (d), cut to fit the time limit
EIGHT_NEW = 8        # tokens a request of (c): one decode block
GAP_NATS = 0.02     # a batched stream may leave its solo stream only under this top-2 gap
STREAM_LP_TOL = 2e-2
# A batched row against the batch-1 decode from the same state, on the steps
# where every MoE layer picked the same experts for it: cuBLAS takes other
# algorithms at M = 1 than at M = slots, and 27 random layers carry the
# rounding on. Set from card readings of V2-Lite Q4 at 4 / 8 slots: token
# logprobs median 0.0003 / 0.0015 nats, largest 0.068 / 0.055; written cache
# rows median 0.005 / 0.011, largest 0.076 / 0.041 (0.08-0.8 where routers
# picked other experts). A decode row written one position off moves its
# cache rows by more than 1.
FORCED_LP_TOL = 0.15       # each held step
FORCED_LP_MEDIAN = 5e-3    # the median of a run's held steps
FORCED_ROW_TOL = 0.25      # a cache row the step wrote, relative to its largest value


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev) if hasattr(tree, "to") else tree


def stream_check(label, tokens, logprobs, solo, gap=GAP_NATS, lp_tol=STREAM_LP_TOL):
    """A batched stream against a solo run of the same ids (`solo`: tokens,
    logprobs and each step's top two (token, logprob), or None where the
    solo run gives none): tokens equal up to a first divergence, accepted
    only where the solo run's top-two logprob gap at that step is under
    `gap`, and logprobs before it within `lp_tol`. Returns (the step of the
    divergence or None, the worst logprob difference before it)."""
    if len(tokens) != len(solo.tokens):
        raise AssertionError(f"{label}: {len(tokens)} tokens, the solo run {len(solo.tokens)}")
    first = next((i for i, (a, b) in enumerate(zip(tokens, solo.tokens)) if a != b), None)
    upto = len(tokens) if first is None else first
    worst = max((abs(a - b) for a, b in zip(logprobs[:upto], solo.logprobs[:upto])),
                default=0.0)
    if not worst <= lp_tol:
        raise AssertionError(f"{label}: logprobs {worst:.3g} from the solo run's")
    if first is not None:
        if solo.top_logprobs is None:
            raise AssertionError(f"{label}: left the solo stream at step {first}")
        (_, top1), (_, top2) = solo.top_logprobs[first][:2]
        if not top1 - top2 < gap:
            raise AssertionError(f"{label}: left the solo stream at step {first}, where its "
                                 f"top-two gap is {top1 - top2:.4f} nats")
    return first, worst


def teacher_forced(eng, prompt, toks, slots, chunk):
    """A scheduler's stream `toks` teacher-forced through two decode paths
    that start every step from one state. The wide path has the
    scheduler's shapes: the prompt prefilled at batch 1 in `chunk`-token
    chunks (the batch-1 engine's prefill), its cache copied into row 0 of a
    `slots`-row cache, decode forwards over every row, the others idle. The
    narrow path is Engine.generate's batch-1 decode forward, with bf16
    expert activations where `slots` rows take the grouped MoE regime and
    one row the gathered (``moe.use_grouped_path``), as the grouped regime's
    rows are bf16 (for V2-Lite: 8 slots, K4 against K5). Both are fed
    the stream's previous token; after each step the wide cache's row 0 is
    copied over the batch-1 cache, so a step's difference is that one
    forward's; and the cache rows the step wrote for row 0 are compared
    before that copy, as the batch-1 path reads the wide path's cache. Per
    step: each path's greedy token, top two logprobs and logprob of the
    stream's token, the largest logprob difference over the vocabulary, how
    many MoE layers picked other experts for row 0 (``compute_routing``),
    and the largest difference of a written cache row relative to the
    row's largest value. Returns the narrow path's expert activation and
    the steps."""
    from dataclasses import replace

    import torch
    from krasis_tpu_torch.models import model as M
    from krasis_tpu_torch.ops.moe import use_grouped_path
    from krasis_tpu_torch.parallel.mesh import cache_shardings, slot_layers
    from krasis_tpu_torch.runtime.kv_cache import init_cache, insert_slot

    cfg, quant, dev = eng.cfg, eng.quant, eng.device
    offload = getattr(eng, "offload", None)
    mesh = getattr(eng, "mesh", None)
    moe_lp = next((lp for lp in eng.params["layers"] if "w13" in lp or "_ep" in lp), None)
    if offload is not None:            # no folded shared experts under offload
        E, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    elif "_ep" in moe_lp:              # nor under a mesh: a shard's local stack
        E, k = moe_lp["_ep"][0]["w13"].q.shape[0], cfg.num_experts_per_tok
    else:                              # the folded shared experts
        E = moe_lp["w13"].q.shape[0]
        k = cfg.num_experts_per_tok + E - cfg.n_routed_experts
    narrow_quant = (replace(quant, expert_activation="bf16")
                    if use_grouped_path(slots, k, E) and not use_grouped_path(1, k, E)
                    else quant)
    picks = []
    real = M.compute_routing

    def recorded(*a, **kw):
        out = real(*a, **kw)
        picks.append(out.topk_idx[:1].sort(dim=-1).values)
        return out

    def decode(cur, ones, cache, quant):
        return M.forward(eng.params, cur, ones, cache, cfg, quant, prefill=False,
                         offload=offload)

    def read(logits, tok):
        lsm = torch.log_softmax(logits[0].to(torch.float32), -1)
        top = torch.topk(lsm, 2)
        return lsm, torch.cat([top.indices.to(torch.float64), top.values.to(torch.float64),
                               lsm[tok][None].to(torch.float64)])

    engine_chunk = eng.chunk
    M.compute_routing = recorded
    try:
        with torch.inference_mode():
            eng.chunk = chunk
            try:
                eng.reset(eng.max_len)
                logits = eng._prefill_prompt(prompt)
            finally:
                eng.chunk = engine_chunk
            narrow = eng.cache
            wide = init_cache(cfg, quant, slots, eng.max_len, dev)
            if mesh is not None:           # the scheduler's layout: slots over dp
                wide = cache_shardings(wide, eng.params)
            insert_slot(wide, narrow, 0)
            cur_w = torch.zeros((slots, 1), dtype=torch.int64, device=dev)
            cur_n = torch.zeros((1, 1), dtype=torch.int64, device=dev)
            ones_w = torch.ones(slots, dtype=torch.int32, device=dev)
            ones_n = torch.ones(1, dtype=torch.int32, device=dev)
            lsm, w = read(logits, toks[0])
            steps = [torch.cat([w, w, torch.zeros(3, dtype=torch.float64, device=dev)])]

            def written(cache, at):
                """What row 0's step wrote: each layer's cache row at `at`
                (a DeltaNet state, the whole of it; a mesh cache's row 0 in
                its dp group, shard by shard)."""
                layers, r = slot_layers(cache, 0)
                return [(buf[r] if name in ("state", "conv") else buf[r, :, at]).float()
                        for lc in layers for part in lc.get("shards", [lc])
                        for name, buf in part.items()]

            for s in range(1, len(toks)):
                cur_w[0, 0] = cur_n[0, 0] = toks[s - 1]
                picks.clear()
                lw, w = read(decode(cur_w, ones_w, wide, quant), toks[s])
                pw = list(picks)
                picks.clear()
                ln, n = read(decode(cur_n, ones_n, narrow, narrow_quant), toks[s])
                flips = sum((a != b).any().to(torch.float64) for a, b in zip(pw, picks))
                at = len(prompt) + s - 1
                row = torch.stack([(a - b).abs().max() / b.abs().max().clamp(min=1e-30)
                                   for a, b in zip(written(wide, at), written(narrow, at))]).max()
                steps.append(torch.cat([w, n, (lw - ln).abs().max()[None].to(torch.float64),
                                        torch.as_tensor(flips, dtype=torch.float64,
                                                        device=dev)[None],
                                        row[None].to(torch.float64)]))
                # the forward may put new buffers in the cache: view them now
                layers, r = slot_layers(wide, 0)
                insert_slot(narrow, {"layers": rows_of(layers, r),
                                     "length": wide["length"][:1]}, 0)
            rows = torch.stack(steps).tolist()
            del wide
    finally:
        M.compute_routing = real
    return narrow_quant.expert_activation, [
        {"wide": (int(r[0]), r[2], r[3], r[4]), "narrow": (int(r[5]), r[7], r[8], r[9]),
         "vocab_diff": r[10], "flips": int(r[11]), "row_diff": r[12]} for r in rows]


def rows_of(tree, r):
    """Row r of every buffer of a cache tree (dicts, lists), as [1, ...] views."""
    if isinstance(tree, dict):
        return {k: rows_of(v, r) for k, v in tree.items()}
    if isinstance(tree, list):
        return [rows_of(v, r) for v in tree]
    return tree[r:r + 1]


def hold_teacher_forced(label, toks, lps, steps):
    """Hold a scheduler stream to ``teacher_forced``'s two paths. The wide
    path (the scheduler's shapes): at every step its greedy token is the
    stream's unless its top-two gap is under GAP_NATS, and its logprob of
    the stream's token is the scheduler's within STREAM_LP_TOL. The batch-1
    path, on every step where no MoE layer picked other experts for the row:
    its logprob of the stream's token is the wide path's within
    FORCED_LP_TOL, and its greedy token is the stream's unless its top-two
    gap is under twice that (the caller holds the median, FORCED_LP_MEDIAN),
    and the cache rows the step wrote are the wide path's within
    FORCED_ROW_TOL of their largest value. Returns (steps, the held steps'
    logprob differences, their largest logprob difference over the
    vocabulary, their largest cache row difference, the steps with other
    picks and their count of layers)."""
    if len(toks) != len(steps):
        raise AssertionError(f"{label}: {len(toks)} tokens, {len(steps)} steps forced")
    held, vocab, row, flipped = [], 0.0, 0.0, []
    for s, (tok, lp, st) in enumerate(zip(toks, lps, steps)):
        w_tok, w1, w2, w_lp = st["wide"]
        n_tok, n1, n2, n_lp = st["narrow"]
        if (w_tok != tok and not w1 - w2 < GAP_NATS) or not abs(w_lp - lp) <= STREAM_LP_TOL:
            raise AssertionError(f"{label}: step {s} on the scheduler's shapes gives token "
                                 f"{w_tok} (the stream {tok}, top-two gap {w1 - w2:.4f}), "
                                 f"logprob {w_lp:.5f} against the scheduler's {lp:.5f}")
        if st["flips"]:
            flipped.append((s, st["flips"]))
            continue
        held.append(abs(n_lp - w_lp))
        vocab, row = max(vocab, st["vocab_diff"]), max(row, st["row_diff"])
        if ((n_tok != tok and not n1 - n2 < 2 * FORCED_LP_TOL) or not held[-1] <= FORCED_LP_TOL
                or not st["row_diff"] <= FORCED_ROW_TOL):
            raise AssertionError(f"{label}: step {s}, same experts in every layer: the batch-1 "
                                 f"decode gives token {n_tok} (the stream {tok}, top-two gap "
                                 f"{n1 - n2:.4f}), logprob {n_lp:.5f} against {w_lp:.5f}, "
                                 f"cache rows {st['row_diff']:.3g} apart")
    return len(steps), held, vocab, row, flipped


def row_alone(entry, batched, alone):
    """Whether each row of a batched kernel call equals the row run alone."""
    import torch

    diff = float((batched.float() - alone.float()).abs().max())
    entry["row_alone_max_abs_diff"] = diff
    entry["row_alone_bit_equal"] = bool(torch.equal(batched, alone))
    print(f"[kernel] {entry['name']}: each row against the row alone: "
          f"{'equal bit for bit' if entry['row_alone_bit_equal'] else f'max|Δ| {diff:.3g}'}",
          flush=True)


def batch_kernel_checks(params, cfg, g, flush):
    """(a) The kernels at the shapes batched decode gives them on V2-Lite Q4:
    K1 on the lm_head at T = 4 and 8, K3 at T = 2 and 4, K2's split form at
    B = 4 over a 4096-row view with a different kv_len a row (bf16 and e4m3;
    and a row past the cache end, ROADMAP C-7), K4 at T = 8 (64 picks); each
    against its plain version, and each row against the row run alone."""
    import torch
    import torch.nn.functional as F
    from krasis_tpu_torch.ops import flash_attention as fa
    from krasis_tpu_torch.ops import gmm_cuda, moe_cuda, qmm_cuda
    from krasis_tpu_torch.ops.rope import yarn_softmax_scale
    from krasis_tpu_torch.quant import qtensor_bytes
    from krasis_tpu_torch.runtime.kv_cache import to_cache

    dev = flush.device
    mine = []
    lm_head = params["lm_head"]
    for T in (4, 8):
        qmm_checks(mine, "batch/", ((f"qmm:lm_head_T{T}", lm_head, None, torch.float32, T),),
                   g, flush)
        x = torch.randn((T, lm_head.k_dim), generator=g, device=dev).to(torch.bfloat16)
        row_alone(mine[-1][1], qmm_cuda.qmm(x, lm_head, torch.float32),
                  torch.cat([qmm_cuda.qmm(x[r:r + 1], lm_head, torch.float32)
                             for r in range(T)]))

    moe = next(lp for lp in params["layers"] if "w13" in lp)
    w13, w2 = moe["w13"], moe["w2"]
    E_r, E_all, k = cfg.n_routed_experts, w13.q.shape[0], cfg.num_experts_per_tok
    Hd, I = cfg.hidden_size, cfg.moe_intermediate_size
    per_expert = (qtensor_bytes(w13) + qtensor_bytes(w2)) / E_all

    def picks(T):
        """A decode step's picks: each row's k routed experts and the folded shared ones."""
        routed = torch.rand((T, E_r), generator=g, device=dev).topk(k, dim=-1).indices
        shared = torch.arange(E_r, E_all, device=dev).expand(T, E_all - E_r)
        wts = torch.cat([torch.rand((T, k), generator=g, device=dev) * 0.3,
                         torch.ones((T, E_all - E_r), device=dev)], dim=1)
        return torch.cat([routed, shared], dim=1).to(torch.int32), wts

    for T in (2, 4):
        x = torch.randn((T, Hd), generator=g, device=dev).to(torch.bfloat16)
        idx, wts = picks(T)
        hit = int(torch.unique(idx).numel())
        k3_checks(mine, f"batch/moe_decode_T{T}", x, w13, w2, idx, wts, moe_cuda.REPLACES,
                  hit * per_expert + T * Hd * 4, 2 * idx.numel() * (Hd * 2 * I + I * Hd), flush)
        mine[-1][1]["experts_hit"] = hit
        row_alone(mine[-1][1], moe_cuda.moe_w4a8(x, w13, w2, idx, wts),
                  torch.cat([moe_cuda.moe_w4a8(x[r:r + 1], w13, w2, idx[r:r + 1], wts[r:r + 1])
                             for r in range(T)]))

    # K2's split form over each slot's cache row: 16 heads on one [ckv; kpe]
    # row, unit-scale keys (score std 3.2), kv_len 40 / 600 / 2048 / 2560
    L, DR = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    lanes, Dp, Hq, S, B = L + DR, 640, cfg.num_attention_heads, 4096, 4
    scale = yarn_softmax_scale((cfg.qk_nope_head_dim + DR) ** -0.5, cfg.rope_scaling)
    lens = torch.tensor([40, 600, 2048, 2560], dtype=torch.int32, device=dev)

    def rows(shape):
        t = torch.zeros(shape[:-1] + (Dp,), dtype=torch.bfloat16, device=dev)
        t[..., :lanes] = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        return t

    kv16, q = rows((B, 1, S, lanes)), rows((B, 1, Hq, lanes))
    qo = lens - 1
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    qh = q.transpose(1, 2)[..., :lanes]
    total = int(lens.sum())
    chunk, n = fa.split_plan(S, 1, B, torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"[kernel] batch/attention: split_plan at B = {B}: {n} splits of {chunk} rows "
          f"(B = 1: {fa.split_plan(S, 1, 1)[0]}-row splits)", flush=True)
    for suffix, kv in (("", kv16), (":fp8", to_cache(kv16, torch.float8_e4m3fn))):
        kh = kv.to(torch.bfloat16)[..., :lanes].expand(B, Hq, S, lanes)

        def run(kv=kv, qo=qo, lens=lens):
            return fa.flash_attention(q, kv, qo, lens, scale, L, qk_dim=lanes)
        check_kernel(mine, "batch/attention:decode_B4_kv_40_600_2048_2560" + suffix,
                     counters()["K2"], fa.REPLACES_DECODE, run,
                     lambda kv=kv: fa.flash_attention_plain(q, kv, qo, lens, scale, L, None,
                                                            lanes),
                     lambda kh=kh: F.scaled_dot_product_attention(qh, kh, kh[..., :L],
                                                                  attn_mask=mask, scale=scale),
                     2e-2, B * Hq * lanes * 2 + total * lanes * kv.element_size()
                     + B * Hq * L * 2, 2 * Hq * total * (lanes + L), PEAK_BF16, 50, flush)
        mine[-1][1]["form"] = "split" + ("+fp8" if suffix else "")
        row_alone(mine[-1][1], run(), torch.cat([
            fa.flash_attention(q[b:b + 1], kv[b:b + 1], qo[b:b + 1], lens[b:b + 1], scale, L,
                               qk_dim=lanes) for b in range(B)]))
        # ROADMAP C-7: a row whose kv_len runs past the cache end (its row was
        # dropped) reads the whole cache and nothing past it
        over = lens.clone()
        over[3] = S + 3
        at_end = lens.clone()
        at_end[3] = S
        past, end = run(qo=over - 1, lens=over), run(qo=at_end - 1, lens=at_end)
        want = fa.flash_attention_plain(q, kv, at_end - 1, at_end, scale, L, None, lanes)
        print(f"[kernel] batch/attention{suffix}: a row at kv_len S + 3 "
              f"{'equals' if torch.equal(past, end) else 'differs from'} the row at kv_len S "
              f"bit for bit; {max_err(past, want, 2e-2)[1]:.3g} of the limit from the plain "
              "version", flush=True)
        if not torch.equal(past, end):
            raise AssertionError("C-7: K2 read past the cache end")

    T = 8
    x = torch.randn((T, Hd), generator=g, device=dev).to(torch.bfloat16)
    idx, wts = picks(T)
    k4_checks(mine, "batch/decode_T8_", x, idx, w13, w2, cfg, iters=50)
    row_alone(mine[-1][1], gmm_cuda.moe_prefill(x, w13, w2, idx, wts),
              torch.cat([gmm_cuda.moe_prefill(x[r:r + 1], w13, w2, idx[r:r + 1], wts[r:r + 1])
                         for r in range(T)]))
    return mine


def batch_phase(eng, cfg, results, rng):
    """11. Continuous batching on phase 4's V2-Lite Q4 engine (its weights,
    27 layers at full width, int8 expert activations, max_len 4096): (a) the
    kernels at batched shapes; decode blocks of 1, 4 and 8 busy slots run
    directly (launches a step by kernel, the aggregate rate beside
    Engine.generate's, a profile of one 4-slot block); (b) a 4-slot
    BatchScheduler with six requests submitted at once, a 3000-id request
    cancelled mid-prefill, the next request, and a turn that extends it
    (prefix reuse); (d) that scheduler served on the native transport, four
    streams one at a time and then at once; (c) an 8-slot scheduler with
    eight requests at once, whose decode runs K4 and no K3. Every scheduler
    stream is teacher-forced through the scheduler's shapes and the batch-1
    decode from one state each step (``teacher_forced``) and held to both
    (``hold_teacher_forced``); a served stream is held to the same request
    served alone (``stream_check``). (b)'s six are also compared with the
    free-running batch-1 Engine.generate (reported, not held). The launch
    counts are set to 0 before (b) and (c) and read after each."""
    import statistics
    import threading
    from types import SimpleNamespace

    import torch
    from krasis_tpu_torch import server
    from krasis_tpu_torch.models.model import decode_block_batched
    from krasis_tpu_torch.ops import flash_attention as fa
    from krasis_tpu_torch.ops import moe
    from krasis_tpu_torch.ops.sampling import SamplingParams
    from krasis_tpu_torch.runtime.kv_cache import init_cache, insert_slot
    from krasis_tpu_torch.runtime.scheduler import BatchScheduler
    from krasis_tpu_torch.timing import recorded_step, traced_kernels
    from torch.profiler import ProfilerActivity, profile, schedule

    t0 = time.perf_counter()
    card = card_line()
    V = cfg.vocab_size
    dev = eng.device        # the card; the CPU in a rehearsal at tiny widths
    on_card = dev.type == "cuda"      # the plain versions a CPU rehearsal runs count nothing

    def sync():
        if on_card:
            torch.cuda.synchronize()

    mine = []
    if on_card:
        g = torch.Generator(device=dev)
        g.manual_seed(4321)
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        mine = batch_kernel_checks(eng.params, cfg, g, flush)
        del flush
    t_kernels = time.perf_counter()

    C = counters()
    greedy = SamplingParams(temperature=0.0)

    def zero():
        for m, attr in C.values():
            setattr(m, attr, 0)
        fa.form_launches.clear()
        moe.plain_routes.update(ragged_plain=0, gathered_plain=0)

    def read():
        if any(moe.plain_routes.values()):
            raise AssertionError(f"[batch] MoE calls on a plain form {moe.plain_routes}")
        return {name: getattr(m, attr) for name, (m, attr) in C.items()}

    def ids(n):
        return rng.integers(100, V - 100, n).tolist()

    def drain(req):
        toks = []
        while (t := req.out_queue.get(timeout=600)) is not None:
            toks.append(t)
        if req.error is not None:
            raise AssertionError(f"[batch] the scheduler failed: {req.error!r}")
        return toks

    checked = []          # (label, step of divergence or None, worst logprob difference)
    forced = []           # (label, hold_teacher_forced's summary)

    def check(label, prompt, toks, lps, new, slots, chunk=None):
        """Hold a scheduler stream to ``teacher_forced``'s two paths (`chunk`:
        where the scheduler prefilled in other chunks than the engine's, a
        prefix reused from its cache)."""
        if len(toks) != new:
            raise AssertionError(f"[batch] {label}: {len(toks)} tokens, not {new}")
        act, steps = teacher_forced(eng, prompt, toks, slots, chunk or sched_chunk)
        forced.append((f"{label} (batch-1 at {act} expert activations)",
                       hold_teacher_forced(label, toks, lps, steps)))

    # --- decode blocks run directly: launches a step, aggregate rate, profile
    solo_rate = eng.generate(ids(40), max_new_tokens=BATCH_NEW, stop_ids={-1}).decode_tok_s
    per_step, rates = {}, {}
    with torch.inference_mode():
        for B in (1, 4, 8):
            cache = init_cache(cfg, eng.quant, B, eng.max_len, dev)
            state = dict(tok=torch.full((B,), 100, dtype=torch.int64, device=dev),
                         seen=torch.zeros((B, V), dtype=torch.bool, device=dev),
                         temperature=torch.zeros(B, device=dev),
                         top_p=torch.ones(B, device=dev),
                         presence_penalty=torch.zeros(B, device=dev),
                         top_k=torch.zeros(B, dtype=torch.int32, device=dev))
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)

            def block(steps):
                cache["length"].fill_(600)
                toks, _ = decode_block_batched(eng.params, cache=cache, cfg=cfg,
                                               quant=eng.quant, steps=steps, generator=gen,
                                               need_logprobs=False, **state)
                return toks.tolist()

            block(1)
            zero()
            block(1)
            per_step[B] = read()
            walls = []
            for _ in range(3):
                sync()
                t = time.perf_counter()
                block(8)
                walls.append(time.perf_counter() - t)
            wall = sorted(walls)[1]
            rates[B] = B * 8 / wall
            if B == 4 and on_card:
                with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                             schedule=schedule(wait=0, warmup=1, active=1)) as prof:
                    torch.ones(1, device=dev).add_(1)
                    recorded_step(prof)
                    block(8)
                    torch.cuda.synchronize()
                    prof.step()
                rows = sorted(((key, us / 1e3, n) for key, us, n in traced_kernels(prof) if us > 0),
                              key=lambda r: -r[1])
                busy = sum(r[1] for r in rows)
                print(f"[profile] one 4-slot decode block (8 steps, kv_len 600): wall "
                      f"{1e3 * wall:.1f} ms unprofiled, device kernels {busy:.1f} ms "
                      f"({100 * busy / (1e3 * wall):.1f}% busy), "
                      f"{sum(r[2] for r in rows)} launches", flush=True)
                for key, ms, n in rows[:10]:
                    print(f"[profile]   {ms:9.2f} ms {n:6d}x  {key[:90]}")
            del cache
    print(f"[batch] launches a decode step by slots: {json.dumps(per_step)}", flush=True)
    print(f"[batch] aggregate decode tok/s (blocks of 8 steps run directly, kv_len 600): "
          + ", ".join(f"{B} slots {r:.2f}" for B, r in rates.items())
          + f"; Engine.generate one slot (40 + {BATCH_NEW}) {solo_rate:.2f}; {card}", flush=True)
    for name in ("K1", "K2", "K3"):
        if on_card and per_step[4][name] <= 0:
            raise AssertionError(f"[batch] a 4-slot decode step launched no {name}")
    if on_card and (per_step[4]["K4"] != 0 or per_step[8]["K3"] != 0 or per_step[8]["K4"] <= 0):
        raise AssertionError("[batch] 4 slots must decode on K3 and 8 slots on K4")
    t_blocks = time.perf_counter()

    # --- (b) a 4-slot scheduler: six requests at once, a cancel, prefix reuse
    sched = BatchScheduler(cfg, eng.quant, eng.params, max_len=eng.max_len, num_slots=4,
                           decode_block=8, device=dev)
    sched_chunk = sched.chunk
    try:
        drain(sched.submit(ids(256), max_new_tokens=4, sampling=greedy))     # warm-up
        prompts = [ids(n) for n in BATCH_PROMPTS]
        zero()
        t = time.perf_counter()
        reqs = [sched.submit(p, max_new_tokens=BATCH_NEW, sampling=greedy, stop_ids={-1},
                             want_logprobs=True) for p in prompts]
        outs = [drain(r) for r in reqs]
        wall_b = time.perf_counter() - t
        # a 3000-id request (two chunks) cancelled after its first chunk: a
        # request decoding beside it puts a decode block between the chunks
        beside = sched.submit(ids(40), max_new_tokens=32, sampling=greedy,
                              stop_ids={-1})
        if beside.out_queue.get(timeout=600) is None:
            raise AssertionError("[batch] the request beside the cancelled one ended at once")
        chunks = sched.stats["prefill_chunks"]
        long = sched.submit(ids(3000), max_new_tokens=16, sampling=greedy, stop_ids={-1})
        deadline = time.perf_counter() + 600
        while sched.stats["prefill_chunks"] == chunks and time.perf_counter() < deadline:
            time.sleep(0.001)
        long.cancelled.set()
        cancelled = drain(long)
        cancelled_chunks = sched.stats["prefill_chunks"] - chunks
        drain(beside)
        turn1 = ids(300)
        r1 = sched.submit(turn1, max_new_tokens=16, sampling=greedy, stop_ids={-1},
                          want_logprobs=True)
        out1 = drain(r1)
        reused = sched.stats["prefix_reused_tokens"]
        turn2 = turn1 + ids(200)
        r2 = sched.submit(turn2, max_new_tokens=16, sampling=greedy, stop_ids={-1},
                          want_logprobs=True)
        out2 = drain(r2)
        reused = sched.stats["prefix_reused_tokens"] - reused
        counts_b, forms_b = read(), dict(fa.form_launches)
        print(f"[batch] 4 slots: {len(BATCH_PROMPTS)} requests ({'+'.join(map(str, BATCH_PROMPTS))} "
              f"ids, {BATCH_NEW} greedy tokens each) answered in {wall_b:.2f} s "
              f"({len(BATCH_PROMPTS) * BATCH_NEW / wall_b:.2f} tok/s); a 3000-id request "
              f"cancelled after its first chunk ran {cancelled_chunks} of its 2 chunks and gave "
              f"{len(cancelled)} tokens, and the next request was answered; the next turn "
              f"reused {reused} cached tokens; "
              f"{sched.stats['prefill_chunks']} prefill chunks, "
              f"{sched.stats['decode_blocks']} decode blocks; launches {json.dumps(counts_b)}; "
              f"K2 by form {json.dumps(forms_b)}; {card}", flush=True)
        if cancelled or cancelled_chunks != 1 or reused != len(turn1):
            raise AssertionError(f"[batch] the cancel ran {cancelled_chunks} chunks and gave "
                                 f"{len(cancelled)} tokens; the reuse took {reused}")
        for name in ("K1", "K2", "K3", "K4"):
            if on_card and counts_b[name] <= 0:
                raise AssertionError(f"[batch] the 4-slot run launched no {name}")
        t_b = time.perf_counter()
        for n, p, r, out in zip(BATCH_PROMPTS, prompts, reqs, outs):
            check(f"4 slots, {n} ids", p, out, r.logprobs, BATCH_NEW, 4)
        check("4 slots, the turn before", turn1, out1, r1.logprobs, 16, 4)
        check("4 slots, prefix reuse", turn2, out2, r2.logprobs, 16, 4, chunk=len(turn1))
        # the same six against the batch-1 Engine.generate over their first 16
        # tokens, reported: its decode runs the cuBLAS products at M = 1, not 4
        apart = []
        for n, p, r, out in zip(BATCH_PROMPTS, prompts, reqs, outs):
            one = eng.generate(p, max_new_tokens=16, stop_ids={-1}, top_logprobs=2)
            first = next((i for i, (a, b) in enumerate(zip(out, one.tokens)) if a != b), None)
            upto = 16 if first is None else first
            gap = None if first is None else one.top_logprobs[first][0][1] - one.top_logprobs[first][1][1]
            apart.append({"ids": n, "first_divergence": first, "solo_top2_gap": gap,
                          "lp_max_abs_diff_before": max(abs(a - b) for a, b in
                                                        zip(r.logprobs[:upto], one.logprobs[:upto]))
                          if upto else 0.0})
        print(f"[batch] 4 slots against the batch-1 Engine.generate (reported, not held): "
              f"{json.dumps(apart)}", flush=True)
        t_b_check = time.perf_counter() - t_b

        # --- (d) served through the scheduler, native transport
        httpd = server.start_temp_server(eng, None, "synthetic/deepseek-v2-lite", port=0,
                                         backend="native", scheduler=sched)
        try:
            texts = ["".join(chr(0x41 + (i * m) % 26) for i in range(600)) for m in (3, 5, 7, 11)]
            bodies = [{"messages": [{"role": "user", "content": s}], "max_tokens": BATCH_NEW,
                       "temperature": 0.0, "stream": True, "logprobs": True} for s in texts]
            solo = [sse_stream(httpd.port, b) for b in bodies]
            solo_walls = [x[3] for x in solo]
            got = [None] * 4

            def worker(i):
                got[i] = sse_stream(httpd.port, bodies[i])
            threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            wall_d = time.perf_counter() - t
        finally:
            httpd.shutdown()
        if any(x is None for x in got):
            raise AssertionError("[batch] a concurrent served stream was not answered")
        def served(chunks):
            toks = [int(x) for x in stream_text(chunks).replace("<", " ").replace(">", " ")
                    .split()]
            lps = [e["logprob"] for c in chunks if c["choices"] and c["choices"][0].get("logprobs")
                   for e in c["choices"][0]["logprobs"]["content"]]
            if len(toks) != BATCH_NEW or len(lps) != BATCH_NEW:
                raise AssertionError(f"[batch] a served stream gave {len(toks)} tokens")
            return SimpleNamespace(tokens=toks, logprobs=lps, top_logprobs=None)
        # each concurrent stream against the same request served alone
        for i, (x, alone) in enumerate(zip(got, solo)):
            x, alone = served(x[0]), served(alone[0])
            checked.append((f"served stream {i}",)
                           + stream_check(f"served stream {i}", x.tokens, x.logprobs, alone))
        print(f"[batch] served, native transport, 4 slots: four concurrent streams of 512 ids + "
              f"{BATCH_NEW} tokens in {wall_d:.2f} s against {sum(solo_walls):.2f} s for the "
              f"same four one at a time ({', '.join(f'{w:.2f}' for w in solo_walls)} s); "
              f"{4 * BATCH_NEW / wall_d:.2f} tok/s at once, "
              f"{4 * BATCH_NEW / sum(solo_walls):.2f} one at a time; {card}", flush=True)
    finally:
        sched.shutdown()
    del sched
    torch.cuda.empty_cache()

    # --- (c) 8 slots: eight 40 + 8 requests at once (one decode block); decode on K4, no K3
    sched = BatchScheduler(cfg, eng.quant, eng.params, max_len=eng.max_len, num_slots=8,
                           decode_block=8, device=dev)
    try:
        drain(sched.submit(ids(256), max_new_tokens=4, sampling=greedy))     # warm-up
        prompts8 = [ids(40) for _ in range(8)]
        zero()
        t = time.perf_counter()
        reqs = [sched.submit(p, max_new_tokens=EIGHT_NEW, sampling=greedy, stop_ids={-1},
                             want_logprobs=True) for p in prompts8]
        outs = [drain(r) for r in reqs]
        wall_c = time.perf_counter() - t
        counts_c = read()
    finally:
        sched.shutdown()
    del sched
    torch.cuda.empty_cache()
    print(f"[batch] 8 slots: eight 40 + {EIGHT_NEW} requests in {wall_c:.2f} s "
          f"({8 * EIGHT_NEW / wall_c:.2f} tok/s); launches {json.dumps(counts_c)}; {card}", flush=True)
    if on_card and (counts_c["K3"] != 0 or counts_c["K4"] <= 0):
        raise AssertionError(f"[batch] 8-slot decode must run K4 and no K3: {counts_c}")
    for i, (p, r, out) in enumerate(zip(prompts8, reqs, outs)):
        check(f"8 slots, request {i}", p, out, r.logprobs, EIGHT_NEW, 8)

    diverged = [(label, step) for label, step, _ in checked if step is not None]
    print(f"[batch] served streams: {len(checked)}, each against the same request served "
          f"alone; {len(diverged)} left it, each at a top-two gap under {GAP_NATS} nats: "
          f"{diverged}; logprobs before that within {max(w for _, _, w in checked):.3g} "
          f"(limit {STREAM_LP_TOL})", flush=True)
    for label, (n, held, vocab, row, flipped) in forced:
        print(f"[batch] teacher-forced {label}: {n} steps, {len(held)} with the same experts as "
              f"the batch-1 decode in every MoE layer, held there: token logprobs within "
              f"{max(held, default=0.0):.3g} (limit {FORCED_LP_TOL}), median "
              f"{statistics.median(held) if held else 0.0:.3g}, vocabulary within {vocab:.3g}, "
              f"written cache rows within {row:.3g} (limit {FORCED_ROW_TOL}); steps with other "
              f"picks (step, layers): {flipped}", flush=True)
    for slots in (4, 8):
        runs = [f for label, f in forced if label.startswith(f"{slots} slots")]
        held = [d for f in runs for d in f[1]]
        total = sum(f[0] for f in runs)
        median = statistics.median(held) if held else None
        print(f"[batch] teacher-forced stream check, {slots} slots: {len(runs)} scheduler "
              f"streams, {total} steps; the scheduler's shapes gave each stream's tokens and "
              f"logprobs; {len(held)} steps picked the same experts as the batch-1 decode "
              f"in every MoE layer and were held to it: token logprobs within "
              f"{max(held, default=0.0):.3g} (limit {FORCED_LP_TOL}), median {median} "
              f"(limit {FORCED_LP_MEDIAN}), written cache rows within "
              f"{max(f[3] for f in runs):.3g}; {total - len(held)} picked others in 1 or more "
              f"layers; {card}", flush=True)
        if median is None or not median <= FORCED_LP_MEDIAN:
            raise AssertionError(f"[batch] {slots} slots against the batch-1 decode: median "
                                 f"{median} over {len(held)} held steps")

    slot_counts = {"K1": (counts_b, counts_c), "K2": (counts_b, None), "K3": (counts_b, None),
                   "K4": (None, counts_c)}
    by_counter = {C[name]: name for name in slot_counts}
    for counter, res in mine:
        name = by_counter[counter]
        four, eight = slot_counts[name]
        if "form" in res:
            res["launches"] = forms_b.get(res["form"], 0)
        else:
            res["launches"] = (eight if "_T8" in res["name"] else four or eight)[name]
        res["launches_4slot_step"] = per_step[4][name]
        res["launches_8slot_step"] = per_step[8][name]
    results.extend(mine)
    print(f"[time] batch phase {time.perf_counter() - t0:.1f} s: kernel checks "
          f"{t_kernels - t0:.1f} s, decode blocks {t_blocks - t_kernels:.1f} s, stream checks "
          f"of (b) {t_b_check:.1f} s", flush=True)


def hybrid_scheduler_reference():
    """Phase 3's tiny hybrid (every expert picked) through a 2-slot
    BatchScheduler on the card, three requests at once, against the port's
    Engine.generate on the CPU (``stream_check`` at the phase's limit)."""
    import torch
    from krasis_tpu_torch.config import QuantConfig
    from krasis_tpu_torch.models.params import init_synthetic_params
    from krasis_tpu_torch.models.synthetic import tiny_config
    from krasis_tpu_torch.ops.sampling import SamplingParams
    from krasis_tpu_torch.runtime.engine import Engine
    from krasis_tpu_torch.runtime.scheduler import BatchScheduler

    cfg = tiny_config("qwen3-coder-next", num_experts_per_tok=8)
    quant = QuantConfig(expert_bits=4, group_size=128, kv_cache_dtype="bf16", attention="int8")
    cpu = init_synthetic_params(cfg, quant, seed=1, device="cpu")
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist() for n in (24, 60, 100)]
    sched = BatchScheduler(cfg, quant, to_device(cpu, "cuda"), max_len=256, num_slots=2,
                           decode_block=4)
    try:
        reqs = [sched.submit(p, max_new_tokens=8, sampling=SamplingParams(temperature=0.0),
                             stop_ids={-1}, want_logprobs=True) for p in prompts]
        outs = []
        for r in reqs:
            toks = []
            while (t := r.out_queue.get(timeout=300)) is not None:
                toks.append(t)
            if r.error is not None:
                raise AssertionError(f"[reference] hybrid scheduler failed: {r.error!r}")
            outs.append(toks)
    finally:
        sched.shutdown()
    ref = Engine(cfg, quant, cpu, max_len=256, device="cpu")
    checked = [stream_check(f"tiny hybrid scheduler, {len(p)} ids", toks, r.logprobs,
                            ref.generate(p, max_new_tokens=8, stop_ids={-1}, top_logprobs=2),
                            gap=5e-2, lp_tol=5e-2)
               for p, r, toks in zip(prompts, reqs, outs)]
    print(f"[reference] tiny Qwen3-Coder-Next hybrid through a 2-slot BatchScheduler on the card "
          f"vs Engine.generate on the CPU: {len(checked)} streams of 8 tokens, divergences "
          f"{[c[0] for c in checked]} (only under a 0.05-nat top-two gap), logprobs within "
          f"{max(c[1] for c in checked):.3g} (limit 5e-2)", flush=True)


SPEC_STEPS = 10         # forced verify steps a run
SPEC_SCHED_NEW = 8      # tokens a scheduler stream
REPEAT_BLOCK = 200      # the ngram request: a block of ids repeated four times


@contextlib.contextmanager
def spec_env(mode, k=None):
    """The reference's environment names set for `mode` / `k` (k None
    leaves KRASIS_TPU_SPEC_K unset) and KRASIS_TPU_NO_SPEC unset while an
    engine or a scheduler is built: ``spec_config`` reads them there."""
    names = ("KRASIS_TPU_SPEC_MODE", "KRASIS_TPU_SPEC_K", "KRASIS_TPU_NO_SPEC")
    saved = {n: os.environ.pop(n, None) for n in names}
    os.environ["KRASIS_TPU_SPEC_MODE"] = mode
    if k is not None:
        os.environ["KRASIS_TPU_SPEC_K"] = str(k)
    try:
        yield
    finally:
        for n in names:
            os.environ.pop(n, None)
            if saved[n] is not None:
                os.environ[n] = saved[n]


def clone_cache(cache):
    return {"layers": [{name: t.clone() for name, t in lc.items()} for lc in cache["layers"]],
            "length": cache["length"].clone()}


def spec_reference():
    """12 (a). Tiny models on the card against the port's CPU engine: a tiny
    V2-Lite with an MTP module at k = 1 and 3, and the tiny hybrid under
    prompt lookup at k = 3 (every expert picked, as phase 3's), each through
    Engine.generate and a 2-slot BatchScheduler on the card; each stream
    held by ``stream_check`` to the CPU's vanilla greedy stream at the
    limits of ``hybrid_scheduler_reference`` (gap 5e-2, logprob 5e-2)."""
    import torch
    from krasis_tpu_torch.config import QuantConfig
    from krasis_tpu_torch.models.params import init_synthetic_params
    from krasis_tpu_torch.models.synthetic import tiny_config
    from krasis_tpu_torch.ops.sampling import SamplingParams
    from krasis_tpu_torch.runtime.engine import Engine
    from krasis_tpu_torch.runtime.scheduler import BatchScheduler

    t0 = time.perf_counter()
    greedy = SamplingParams(temperature=0.0)
    cases = (("tiny V2-Lite + MTP", tiny_config(
        "deepseek-v2-lite", moe_intermediate_size=128, num_hidden_layers=4,
        num_experts_per_tok=8, num_nextn_predict_layers=1),
        QuantConfig(expert_bits=4, group_size=128, kv_cache_dtype="bf16"),
        (("mtp", 1), ("mtp", 3))),
        ("tiny Qwen3-Coder-Next hybrid", tiny_config("qwen3-coder-next", num_experts_per_tok=8),
         QuantConfig(expert_bits=4, group_size=128, kv_cache_dtype="bf16", attention="int8"),
         (("ngram", 3),)))
    summary = []
    for label, cfg, quant, modes in cases:
        cpu = init_synthetic_params(cfg, quant, seed=1, device="cpu")
        card = to_device(cpu, "cuda")
        with spec_env("off"):
            ref = Engine(cfg, quant, cpu, max_len=256, device="cpu")
        g = torch.Generator().manual_seed(3)
        # each prompt ends on a repeat of its start, so prompt lookup drafts
        prompts = [(lambda p: p + p[:12])(torch.randint(1, cfg.vocab_size, (n,),
                                                        generator=g).tolist())
                   for n in (24, 60, 100)]
        solos = [ref.generate(p, max_new_tokens=8, stop_ids={-1}, top_logprobs=2)
                 for p in prompts]
        for mode, k in modes:
            with spec_env(mode, k):
                eng = Engine(cfg, quant, card, max_len=256)
                sched = BatchScheduler(cfg, quant, card, max_len=256, num_slots=2,
                                       decode_block=4)
            try:
                reqs = [sched.submit(p, max_new_tokens=8, sampling=greedy, stop_ids={-1},
                                     want_logprobs=True) for p in prompts]
                outs = []
                for r in reqs:
                    toks = []
                    while (tk := r.out_queue.get(timeout=300)) is not None:
                        toks.append(tk)
                    if r.error is not None:
                        raise AssertionError(f"[spec] {label} scheduler failed: {r.error!r}")
                    outs.append(toks)
                steps = dict(sched.stats_spec)
            finally:
                sched.shutdown()
            for p, solo, r, toks in zip(prompts, solos, reqs, outs):
                res = eng.generate(p, max_new_tokens=8, stop_ids={-1})
                if eng.last_spec_stats is None or not res.finite:
                    raise AssertionError(f"[spec] {label}: Engine.generate left the spec path")
                summary.append(stream_check(f"{label} {mode} k={k} generate, {len(p)} ids",
                                            res.tokens, res.logprobs, solo, gap=5e-2,
                                            lp_tol=5e-2))
                summary.append(stream_check(f"{label} {mode} k={k} scheduler, {len(p)} ids",
                                            toks, r.logprobs, solo, gap=5e-2, lp_tol=5e-2))
            print(f"[spec] {label}, {mode} k = {k}, on the card vs the CPU's vanilla "
                  f"Engine.generate: scheduler {json.dumps(steps)}", flush=True)
        del card
    print(f"[spec] tiny references: {len(summary)} streams of 8 tokens, divergences "
          f"{[s[0] for s in summary]} (only under a 0.05-nat top-two gap), logprobs within "
          f"{max(s[1] for s in summary):.3g} (limit 5e-2); {time.perf_counter() - t0:.1f} s",
          flush=True)


class SpecHooks:
    """While active: the verify logits of every verify step (``mtp.
    verify_and_sample``'s input), each MoE layer's picks for row 0
    (``compute_routing``), forced prompt-lookup drafts (``spec_ngram.
    ngram_draft``) when `drafts` is set, and every DeltaNet commit held to
    the recurrence (``check_commit``)."""

    def __init__(self, check_commit=False):
        self.logits, self.picks, self.drafts = [], [], None
        self.check_commit = check_commit
        self.commits = []          # (bit-equal, largest difference over the state's largest)

    def __enter__(self):
        from krasis_tpu_torch.models import model as M
        from krasis_tpu_torch.models import mtp, spec_ngram

        self.saved = (M.compute_routing, mtp.verify_and_sample, spec_ngram.ngram_draft,
                      mtp.la_spec_commit)
        real_route, real_verify, real_draft, real_commit = self.saved

        def route(*a, **kw):
            out = real_route(*a, **kw)
            self.picks.append(out.topk_idx.sort(dim=-1).values)
            return out

        def verify(logits, *a, **kw):
            self.logits.append(logits.detach().clone())
            return real_verify(logits, *a, **kw)

        def draft(hist, hlen, k, n_max=3):
            return real_draft(hist, hlen, k, n_max) if self.drafts is None else self.drafts

        def commit(cache, ncommit):
            pre = ([{n: t.clone() for n, t in lc.items()} if "p_k" in lc else None
                    for lc in cache["layers"]] if self.check_commit else None)
            real_commit(cache, ncommit)
            if pre is not None:
                self.hold_commit(pre, cache, ncommit)

        M.compute_routing, mtp.verify_and_sample = route, verify
        spec_ngram.ngram_draft, mtp.la_spec_commit = draft, commit
        return self

    def hold_commit(self, pre, cache, ncommit):
        """Each DeltaNet layer's committed state and conv window against
        ``gated_delta_rule_recurrent`` over each row's committed prefix from
        the pre-window state."""
        import torch
        from krasis_tpu_torch.ops.deltanet import gated_delta_rule_recurrent

        for b, n in enumerate(ncommit.tolist()):
            for old, lc in zip(pre, cache["layers"]):
                if old is None:
                    continue
                sl = slice(b, b + 1)
                k_ = old["p_k"][sl, :n]
                _, want = gated_delta_rule_recurrent(k_, k_, old["p_v"][sl, :n],
                                                     old["p_g"][sl, :n], old["p_b"][sl, :n],
                                                     old["state"][sl])
                hist = torch.cat([old["conv"][sl].to(old["p_x"].dtype), old["p_x"][sl, :n]], 1)
                conv = hist[:, n:].to(old["conv"].dtype)
                got = lc["state"][sl]
                equal = torch.equal(got, want) and torch.equal(lc["conv"][sl], conv)
                diff = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
                self.commits.append((equal, diff))
                if not torch.equal(lc["conv"][sl], conv) or not diff <= 1e-5:
                    raise AssertionError(f"[spec] a DeltaNet commit of {n} tokens: state "
                                         f"{diff:.3g} of its largest value from the recurrence")

    def __exit__(self, *exc):
        from krasis_tpu_torch.models import model as M
        from krasis_tpu_torch.models import mtp, spec_ngram

        (M.compute_routing, mtp.verify_and_sample, spec_ngram.ngram_draft,
         mtp.la_spec_commit) = self.saved
        return False


def forced_verify(label, eng, prompt, k, steps, accept, run_step, hooks):
    """Verify steps with forced drafts through the engine's own block
    (`run_step(tok, drafts)` → (tokens [S], committed, next tok), one step
    from the engine's caches). Each step's drafts are the tokens that the
    batch-1 greedy decode gives from the same state (forced acceptance) or
    those plus one (forced rejection). Exact mechanics: a step commits one
    more token than its leading drafts equal to the verify argmax, each
    committed token is that argmax, and the cache lengths (the MTP cache's
    too) end at the committed count; forced rejection commits 1, forced
    acceptance k + 1 except where the verify's top-two gap at a mismatch is
    under 2·FORCED_LP_TOL. With acceptance, each committed position is also
    teacher-forced against the batch-1 decode forward fed the same tokens
    from the same state (``teacher_forced``'s measures). Returns (steps
    taking k + 1, position records)."""
    import torch
    from krasis_tpu_torch.models.model import forward

    cfg, params, dev = eng.cfg, eng.params, eng.device
    V = cfg.vocab_size
    one = torch.ones(1, dtype=torch.int32, device=dev)
    n0 = len(prompt)
    full, records, committed = 0, [], 0
    tok = hooks.first_tok

    def written(cache, at):
        """(whether it is DeltaNet state, what row 0 holds): each layer's
        cache row at `at`, a DeltaNet state and conv window whole."""
        return [(name in ("state", "conv"),
                 (buf[0] if name in ("state", "conv") else buf[0, :, at]).float().clone())
                for lc in cache["layers"] for name, buf in lc.items()]

    for step in range(steps):
        narrow = clone_cache(eng.cache)
        feed, n_lsm, n_picks, n_rows = [tok], [], [], []
        for i in range(k + 1):
            hooks.picks.clear()
            lg = forward(params, feed[-1].reshape(1, 1), one, narrow, cfg, eng.quant,
                         prefill=False)
            n_picks.append([p[0] for p in hooks.picks])
            n_lsm.append(torch.log_softmax(lg[0].float(), -1))
            n_rows.append(written(narrow, n0 + committed + i))
            feed.append(torch.argmax(lg, dim=-1))
        b = torch.cat(feed[1:])                                          # [k + 1]
        drafts = b[:k] if accept else (b[:k] + 1) % V
        hooks.picks.clear()
        hooks.logits.clear()
        ts, nc, tok = run_step(tok, drafts[None])
        vl = torch.log_softmax(hooks.logits[-1][0].float(), -1)          # [S, V]
        top = torch.topk(vl, 2, dim=-1)
        arg = top.indices[:, 0]
        match = 0
        while match < k and int(drafts[match]) == int(arg[match]):
            match += 1
        if nc != match + 1 or ts[:nc].tolist() != arg[:nc].tolist():
            raise AssertionError(f"[spec] {label} step {step}: committed {nc} of tokens "
                                 f"{ts.tolist()}, the verify argmax {arg.tolist()}, drafts "
                                 f"{drafts.tolist()}")
        committed += nc
        lens = [int(eng.cache["length"][0])] + (
            [int(eng.mtp_cache["length"][0])] if eng.mtp_cache is not None else [])
        if any(n != n0 + committed for n in lens):
            raise AssertionError(f"[spec] {label} step {step}: cache lengths {lens}, "
                                 f"{n0 + committed} committed")
        if not accept:
            if nc != 1:
                raise AssertionError(f"[spec] {label} step {step}: forced rejection committed {nc}")
            continue
        if nc == k + 1:
            full += 1
        else:
            gap = float(top.values[match, 0] - top.values[match, 1])
            if not gap < 2 * FORCED_LP_TOL:
                raise AssertionError(f"[spec] {label} step {step}: forced acceptance committed "
                                     f"{nc} of {k + 1}, the verify's top-two gap at the "
                                     f"mismatch {gap:.4f}")
        w_rows = [written(eng.cache, n0 + committed - nc + i) for i in range(nc)]
        for i in range(nc):
            flips = sum(int(not torch.equal(wp[i], npk))
                        for wp, npk in zip(hooks.picks, n_picks[i]))
            t_i = int(ts[i])
            n_top = torch.topk(n_lsm[i], 2)
            # a DeltaNet state is compared after the step's last committed token
            rows = [(a - c).abs().max() / c.abs().max().clamp(min=1e-30)
                    for (state, a), (_, c) in zip(w_rows[i], n_rows[i])
                    if not state or i == nc - 1]
            records.append({"i": i, "flips": flips, "narrow_tok": int(n_top.indices[0]),
                            "vocab_diff": float((vl[i] - n_lsm[i]).abs().max()),
                            "narrow_gap": float(n_top.values[0] - n_top.values[1]),
                            "tok": t_i, "lp_diff": float((vl[i, t_i] - n_lsm[i][t_i]).abs()),
                            "row_diff": float(torch.stack(rows).max())})
    return full, records


def hold_forced(label, records):
    """``hold_teacher_forced``'s batch-1 rule on forced verify positions:
    where every MoE layer picked the same experts, the batch-1 logprob of
    the committed token within FORCED_LP_TOL, the written rows within
    FORCED_ROW_TOL, the batch-1 greedy token the committed one unless its
    top-two gap is under 2·FORCED_LP_TOL. Returns (held lp differences,
    positions with other picks, largest row difference)."""
    held, other, row = [], 0, 0.0
    for i, r in enumerate(records):
        if r["flips"]:
            other += 1
            continue
        held.append(r["lp_diff"])
        row = max(row, r["row_diff"])
        if ((r["narrow_tok"] != r["tok"] and not r["narrow_gap"] < 2 * FORCED_LP_TOL)
                or not r["lp_diff"] <= FORCED_LP_TOL or not r["row_diff"] <= FORCED_ROW_TOL):
            raise AssertionError(f"[spec] {label} position {i}, same experts in every layer: "
                                 f"{r}")
    return held, other, row


def forced_runs(label, eng, prompt, ks, steps, prefill, run_step, check_commit=False):
    """Forced acceptance and rejection at each draft depth in `ks` from the
    prompt's prefill (`prefill(k)` → the first token, resetting the
    engine's caches), printed and held; returns the held differences."""
    import statistics

    held_all = []
    for k in ks:
        commits, runs = [], {}
        for accept in (True, False):
            with SpecHooks(check_commit) as hooks:
                hooks.first_tok = prefill(k)
                runs[accept] = forced_verify(label, eng, prompt, k, steps, accept,
                                             lambda tok, d, k=k: run_step(k, tok, d, hooks),
                                             hooks)
            commits += hooks.commits
        full, records = runs[True]
        held, other, row = hold_forced(f"{label} k={k}", records)
        held_all += held
        # where in the window the other picks fall, and how far they move
        at = [(i, sum(1 for r in records if r["i"] == i),
               sum(1 for r in records if r["i"] == i and r["flips"]),
               max((r["lp_diff"] for r in records if r["i"] == i and r["flips"]), default=0.0),
               max(r["vocab_diff"] for r in records if r["i"] == i))
              for i in range(k + 1) if any(r["i"] == i for r in records)]
        line = (f"k = {k}: forced acceptance {full} of {steps} steps committed {k + 1} (the "
                f"rest at a near-tie), teacher-forced {len(records)} positions: {len(held)} "
                f"held, logprobs within {max(held, default=0.0):.3g} (median "
                f"{statistics.median(held) if held else None}), rows within {row:.3g}, "
                f"{other} ({100 * other / max(1, len(records)):.0f}%) with other picks (window "
                f"position, positions, with other picks, their largest logprob difference, the "
                f"largest over the vocabulary: "
                f"{[(i, n, f, round(d, 4), round(v, 4)) for i, n, f, d, v in at]}); "
                f"forced rejection {steps} of {steps} steps committed 1")
        if commits:
            line += (f"; {len(commits)} DeltaNet commits held to the recurrence, "
                     f"{sum(e for e, _ in commits)} bit-equal, largest difference "
                     f"{max(d for _, d in commits):.3g} of the state's largest value")
        print(f"[spec] {label}, {line}", flush=True)
    return held_all


def replay_at_slots(eng, prompt, toks, lps, slots, k, chunk):
    """A scheduler stream teacher-forced at the scheduler's shapes: the
    prompt prefilled at batch 1 in `chunk`-token chunks, its cache in row 0
    of a `slots`-row cache, then verify forwards of k + 1 rows a slot fed
    the stream's own tokens (every draft accepted, the other rows idle).
    Returns per token (stream token, greedy token, top-two gap, logprob
    difference)."""
    import torch
    from krasis_tpu_torch.models.model import forward
    from krasis_tpu_torch.runtime.kv_cache import init_cache, insert_slot

    cfg, quant, dev = eng.cfg, eng.quant, eng.device
    S = k + 1
    out = []

    def take(lsm, i):
        top = torch.topk(lsm, 2)
        return (toks[i], int(top.indices[0]), float(top.values[0] - top.values[1]),
                abs(float(lsm[toks[i]]) - lps[i]))

    saved = eng.chunk
    eng.chunk = chunk
    try:
        eng.reset(eng.max_len)
        logits = eng._prefill_prompt(prompt)
    finally:
        eng.chunk = saved
    out.append(take(torch.log_softmax(logits[0].float(), -1), 0))
    wide = init_cache(cfg, quant, slots, eng.max_len, dev)
    insert_slot(wide, eng.cache, 0)
    seq = torch.full((slots,), S, dtype=torch.int32, device=dev)
    for j in range(0, len(toks) - 1, S):
        x = torch.zeros((slots, S), dtype=torch.int64, device=dev)
        feed = toks[j:j + S]
        x[0, :len(feed)] = torch.tensor(feed, device=dev)
        wide["length"][1:] = 0
        lsm = torch.log_softmax(forward(eng.params, x, seq, wide, cfg, quant, prefill=False,
                                        return_all_logits=True)[0].float(), -1)
        for i in range(S):
            if j + i + 1 < len(toks):
                out.append(take(lsm[i], j + i + 1))
    return out


def spec_kernel_profile(label, eng, prompt, k, on_card):
    """Launches a verify step and a vanilla decode step by kernel, and one
    profiled block of 8 verify steps (busy share) from the prompt's state."""
    import torch
    from krasis_tpu_torch.models import mtp
    from krasis_tpu_torch.models.model import forward
    from krasis_tpu_torch.timing import recorded_step, traced_kernels
    from torch.profiler import ProfilerActivity, profile, schedule

    C = counters()
    dev, V = eng.device, eng.cfg.vocab_size
    args = (None, torch.zeros((1, V), dtype=torch.bool, device=dev), torch.zeros(1, device=dev),
            torch.ones(1, device=dev), torch.zeros(1, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))
    eng.spec_k = k
    eng.reset(eng.max_len)
    logits, h = eng._prefill_prompt(prompt, mtp=True)
    tok = torch.argmax(logits, dim=-1)
    drafts = mtp.first_draft(eng.params, tok, h, eng.mtp_cache, eng.cfg, eng.quant, k)
    # V2-Lite has no DeltaNet state: a block starts again from the lengths
    base = eng.cache["length"].clone(), eng.mtp_cache["length"].clone()

    def block(steps):
        eng.cache["length"], eng.mtp_cache["length"] = base[0].clone(), base[1].clone()
        out = mtp.spec_decode_block(eng.params, tok, drafts, eng.cache, eng.mtp_cache, eng.cfg,
                                    eng.quant, steps, *args)
        return out[2].tolist()

    def measured(fn, n):
        """(launches a step by kernel, the median of three walls of `fn` in
        ms): the counts set to 0 before the first of the three runs and read
        after it."""
        walls = []
        for i in range(3):
            if i == 0:
                for m, attr in C.values():
                    setattr(m, attr, 0)
            if on_card:
                torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            if on_card:
                torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            if i == 0:
                launched = {name: getattr(m, attr) / n for name, (m, attr) in C.items()
                            if getattr(m, attr)}
        return launched, sorted(walls)[1]

    one = torch.ones(1, dtype=torch.int32, device=dev)

    def vanilla(steps=8):
        eng.cache["length"] = base[0].clone()
        for _ in range(steps):
            forward(eng.params, tok[:, None], one, eng.cache, eng.cfg, eng.quant, prefill=False)

    block(1)
    spec_step, wall = measured(lambda: block(8), 8)
    vanilla_step, v_wall = measured(vanilla, 8)
    # derived, not measured: were every draft accepted, a step would give
    # k + 1 tokens for the same wall
    print(f"[spec] {label}: a verify step at k = {k} {wall / 8:.2f} ms, a vanilla decode step "
          f"{v_wall / 8:.2f} ms (host clock, from {len(prompt)} ids): {wall / v_wall:.3f} vanilla "
          f"steps; derived for full acceptance ((k + 1) x vanilla wall / verify wall): "
          f"{(k + 1) * v_wall / wall:.3f}x vanilla decode tok/s", flush=True)
    busy = None
    if on_card:
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            torch.ones(1, device=dev).add_(1)
            recorded_step(prof)
            block(8)
            torch.cuda.synchronize()
            prof.step()
        rows = [(key, us / 1e3, n) for key, us, n in traced_kernels(prof) if us > 0]
        dev_ms = sum(r[1] for r in rows)
        busy = 100 * dev_ms / wall
        print(f"[profile] {label}: one block of 8 verify steps at k = {k} from "
              f"{len(prompt)} ids: wall {wall:.1f} ms unprofiled, device kernels {dev_ms:.1f} ms "
              f"({busy:.1f}% busy), {sum(r[2] for r in rows)} launches", flush=True)
        for key, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
            print(f"[profile]   {ms:9.2f} ms {n:6d}x  {key[:90]}")
    print(f"[spec] {label}: launches a verify step at k = {k} {json.dumps(spec_step)}; a "
          f"vanilla decode step {json.dumps(vanilla_step)}", flush=True)
    return spec_step, vanilla_step, busy, wall / v_wall


def spec_phase(eng, cfg, results, rng):
    """12 (b)-(c). Speculative decoding on phase 4's V2-Lite Q4 weights
    (27 layers at full width, int8 expert activations, max_len 4096) with a
    synthetic MTP module at V2-Lite's widths attached (seed 0; V2-Lite's
    checkpoint has none: DeepSeek-V3's MTP layer at V2-Lite's widths): K2's
    split form at the verify shapes Sq = 2 and 4 over the MLA cache (bf16
    and e4m3, kv_len 40 / 600 / 2560, and a control without the in-window
    causal mask that the check must refuse); forced acceptance and
    rejection at k = 1 and 3, teacher-forced against the batch-1 decode;
    launches a verify step and one profiled verify block; requests 2048 +
    16 and 40 + 16 at k = 1 and 3 and prompt lookup at k = 3 on a repeated
    block, each beside the vanilla path in this call; a 4-slot
    BatchScheduler under MTP k = 1 and prompt lookup k = 3 with six requests
    at once, each stream teacher-forced at the scheduler's shapes; one
    request through the in-process server. Launch counts are set to 0 just
    before each spec request and each scheduler and read just after, before
    any vanilla or checking run (a scheduler's K4 from its verify blocks
    alone); no MoE call takes a plain form."""
    import statistics
    from dataclasses import replace

    import torch
    from krasis_tpu_torch import server
    from krasis_tpu_torch.models import mtp
    from krasis_tpu_torch.models.params import init_mtp_params
    from krasis_tpu_torch.ops import flash_attention as fa
    from krasis_tpu_torch.ops import moe
    from krasis_tpu_torch.ops.rope import yarn_softmax_scale
    from krasis_tpu_torch.ops.sampling import SamplingParams
    from krasis_tpu_torch.runtime.engine import Engine
    from krasis_tpu_torch.runtime.scheduler import BatchScheduler

    t0 = time.perf_counter()
    card = card_line()
    dev = eng.device
    on_card = dev.type == "cuda"
    V = cfg.vocab_size
    mine = []
    if on_card:
        g = torch.Generator(device=dev)
        g.manual_seed(5678)
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        L, DR = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        scale = yarn_softmax_scale((cfg.qk_nope_head_dim + DR) ** -0.5, cfg.rope_scaling)
        attention_checks(mine, "spec/", cfg.num_attention_heads, 1, L + DR, 640, L, False, scale,
                         1.0, g, flush, fp8=True, cases=verify_cases())
        # K1 at a verify step's rows (the lm_head at T = 4 is the batch
        # phase's line); K4 at the 4-slot prompt-lookup verify, T = 16 (T = 8,
        # MTP k = 1 on 4 slots, is the batch phase's 8-slot decode shape)
        dense = eng.params["layers"][0]
        qmm_checks(mine, "spec/", (
            ("qmm:lm_head_T2", eng.params["lm_head"], None, torch.float32, 2),
            ("qmm:mlp_w13_T2", dense["mlp_w13"], None, torch.bfloat16, 2),
            ("qmm:mlp_w13_T4", dense["mlp_w13"], None, torch.bfloat16, 4),
            ("qmm:mlp_w2_T2", dense["mlp_w2"], None, torch.bfloat16, 2),
            ("qmm:mlp_w2_T4", dense["mlp_w2"], None, torch.bfloat16, 4)), g, flush)
        moe_lp = next(lp for lp in eng.params["layers"] if "w13" in lp)
        w13, E_all, T = moe_lp["w13"], moe_lp["w13"].q.shape[0], 16
        E_r, k_r = cfg.n_routed_experts, cfg.num_experts_per_tok
        x = torch.randn((T, cfg.hidden_size), generator=g, device=dev).to(torch.bfloat16)
        routed = torch.rand((T, E_r), generator=g, device=dev).topk(k_r, dim=-1).indices
        idx = torch.cat([routed, torch.arange(E_r, E_all, device=dev).expand(T, E_all - E_r)],
                        dim=1).to(torch.int32)
        k4_checks(mine, "spec/decode_T16_", x, idx, w13, moe_lp["w2"], cfg, iters=50)
        del flush
    t_kernels = time.perf_counter()

    cfg1 = replace(cfg, num_nextn_predict_layers=1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = {**eng.params, "mtp": init_mtp_params(cfg1, eng.quant, gen, dev)}
    with spec_env("mtp", 1):
        se = Engine(cfg1, eng.quant, params, max_len=eng.max_len, device=dev)
    greedy = SamplingParams(temperature=0.0)
    V = cfg.vocab_size

    def ids(n):
        return rng.integers(100, V - 100, n).tolist()

    # --- forced acceptance / rejection, teacher-forced against batch-1 decode
    prompt = ids(40)
    zargs = (torch.zeros((1, V), dtype=torch.bool, device=dev), torch.zeros(1, device=dev),
             torch.ones(1, device=dev), torch.zeros(1, device=dev),
             torch.zeros(1, dtype=torch.int32, device=dev))

    def prefill(k):
        se.spec_k = k
        se.reset(se.max_len)
        logits, h = se._prefill_prompt(prompt, mtp=True)
        tok = torch.argmax(logits, dim=-1)
        se._drafts = mtp.first_draft(params, tok, h, se.mtp_cache, cfg1, se.quant, k)
        return tok

    def run_step(k, tok, drafts, hooks):
        ts, _, nc, _, nxt, _ = mtp.spec_decode_block(params, tok, drafts, se.cache, se.mtp_cache,
                                                     cfg1, se.quant, 1, None, *zargs)
        return ts[0, 0], int(nc[0, 0]), nxt

    with torch.inference_mode():
        held = forced_runs("V2-Lite Q4 + MTP", se, prompt, (1, 3), SPEC_STEPS, prefill, run_step)
    median = statistics.median(held) if held else None
    if median is None or not median <= FORCED_LP_MEDIAN:
        raise AssertionError(f"[spec] forced verify against the batch-1 decode: median {median}")
    t_forced = time.perf_counter()

    # --- launches a step, one profiled verify block
    with torch.inference_mode():
        launches = {k: spec_kernel_profile("V2-Lite Q4 + MTP", se, ids(600), k, on_card)
                    for k in (1, 3)}

    # --- requests: spec beside vanilla, in this call. The counts are set to
    # 0 just before each spec request and read just after: they count the
    # spec path alone, never a vanilla or a checking run
    C = counters()

    def zero():
        for m, attr in C.values():
            setattr(m, attr, 0)
        fa.form_launches.clear()
        moe.plain_routes.update(ragged_plain=0, gathered_plain=0)

    def read():
        if any(moe.plain_routes.values()):
            raise AssertionError(f"[spec] MoE calls on a plain form {moe.plain_routes}")
        return {name: getattr(m, attr) for name, (m, attr) in C.items()}

    def add(total, got):
        for name, c in got.items():
            total[name] = total.get(name, 0) + c

    def nonzero(c):
        return json.dumps({name: v for name, v in c.items() if v})

    with spec_env("ngram", 3):
        ng = Engine(cfg, eng.quant, eng.params, max_len=eng.max_len, device=dev)
    with spec_env("mtp", 3):
        fp8 = Engine(cfg1, replace(eng.quant, kv_cache_dtype="fp8"), params,
                     max_len=eng.max_len, device=dev)
    block = ids(REPEAT_BLOCK)
    se.generate(ids(256), max_new_tokens=8, stop_ids={-1})                   # warm-up
    rates, counts, forms = [], {}, {}
    # one vanilla run a prompt, then the spec runs of that prompt at each k
    for label, e, ks, n, new, p in (
            ("mtp", se, (1, 3), 2048, 16, None), ("mtp", se, (1, 3), 40, 16, None),
            ("ngram", ng, (3,), 4 * REPEAT_BLOCK, 32, block * 4),
            ("mtp fp8 cache", fp8, (3,), 40, 16, None)):
        p = p or ids(n)
        e.spec_available = False
        van = e.generate(p, max_new_tokens=new, stop_ids={-1})
        e.spec_available = True
        for k in ks:
            e.spec_k = k
            zero()
            spec = e.generate(p, max_new_tokens=new, stop_ids={-1})
            launched = read()
            add(counts, launched)
            add(forms, fa.form_launches)
            stats = e.last_spec_stats
            if not (spec.finite and van.finite) or len(spec.tokens) != new or stats is None:
                raise AssertionError(f"[spec] {label} k={k} {n} + {new}: {stats}")
            first = next((i for i, (a, b) in enumerate(zip(spec.tokens, van.tokens)) if a != b),
                         None)
            rates.append((label, k, n, new, van.decode_tok_s, spec.decode_tok_s))
            print("[spec] " + json.dumps({
                "request": f"{n} + {new}", "draft": label, "k": k,
                "vanilla": {"prefill_tok_s": van.prefill_tok_s, "decode_tok_s": van.decode_tok_s},
                "spec": {"prefill_tok_s": spec.prefill_tok_s, "decode_tok_s": spec.decode_tok_s,
                         "stats": stats},
                "decode_ratio": spec.decode_tok_s / van.decode_tok_s,
                "first_divergence_from_vanilla": first,
                "launches_spec_request": {name: c for name, c in launched.items() if c},
                "k2_forms": dict(fa.form_launches)}), flush=True)
    del fp8, e
    for name in ("K1", "K2", "K3"):
        if on_card and counts.get(name, 0) <= 0:
            raise AssertionError(f"[spec] the spec requests launched no {name}")
    for form in ("split", "split+fp8"):
        if on_card and forms.get(form, 0) <= 0:
            raise AssertionError(f"[spec] the spec requests never launched K2's {form} form")
    t_requests = time.perf_counter()

    # --- a 4-slot scheduler under each draft source: six requests at once.
    # The counts are set to 0 before each scheduler and read when it is shut
    # down, before the replay; the verify blocks' own launches are summed
    # over its _spec_decode_block calls (admission prefills excluded)
    forced_sched, block_counts = [], {}
    for mode, k, p_params, p_cfg in (("mtp", 1, params, cfg1), ("ngram", 3, eng.params, cfg)):
        zero()
        with spec_env(mode, k):
            sched = BatchScheduler(p_cfg, eng.quant, p_params, max_len=eng.max_len,
                                   num_slots=4, decode_block=8, device=dev)
        in_blocks = {}

        def counted_block(real=sched._spec_decode_block, in_blocks=in_blocks):
            before = {name: getattr(m, attr) for name, (m, attr) in C.items()}
            real()
            add(in_blocks, {name: getattr(m, attr) - before[name]
                            for name, (m, attr) in C.items()})
        sched._spec_decode_block = counted_block
        try:
            prompts = [ids(n) for n in BATCH_PROMPTS]
            prompts[-1] = (prompts[-1][:150] * 4)[:600]            # one that lookup can draft
            t = time.perf_counter()
            reqs = [sched.submit(p, max_new_tokens=SPEC_SCHED_NEW, sampling=greedy,
                                 stop_ids={-1}, want_logprobs=True) for p in prompts]
            outs = []
            for r in reqs:
                toks = []
                while (tk := r.out_queue.get(timeout=600)) is not None:
                    toks.append(tk)
                if r.error is not None or len(toks) != SPEC_SCHED_NEW:
                    raise AssertionError(f"[spec] the {mode} scheduler: {r.error!r}, "
                                         f"{len(toks)} tokens")
                outs.append(toks)
            wall = time.perf_counter() - t
            stats = dict(sched.stats_spec)
            chunk = sched.chunk
        finally:
            sched.shutdown()
        del sched
        launched = read()
        add(block_counts, in_blocks)
        if on_card and in_blocks.get("K4", 0) <= 0:
            raise AssertionError(f"[spec] the {mode} scheduler's 4-slot verify blocks "
                                 f"launched no K4")
        worst, apart = 0.0, []
        with torch.inference_mode():
            for n, p, r, toks in zip(BATCH_PROMPTS, prompts, reqs, outs):
                for i, (tok, w_tok, gap, lp_diff) in enumerate(
                        replay_at_slots(se if mode == "mtp" else ng, p, toks, r.logprobs, 4, k,
                                        chunk)):
                    if (w_tok != tok and not gap < GAP_NATS) or not lp_diff <= STREAM_LP_TOL:
                        raise AssertionError(f"[spec] {mode} scheduler, {n} ids, token {i}: "
                                             f"the scheduler's shapes give {w_tok} (the stream "
                                             f"{tok}, gap {gap:.4f}), logprob {lp_diff:.3g} off")
                    worst = max(worst, lp_diff)
                    if w_tok != tok:
                        apart.append((n, i))
        forced_sched.append(f"{mode} k = {k}: {len(BATCH_PROMPTS)} requests "
                            f"({'+'.join(map(str, BATCH_PROMPTS))} ids, {SPEC_SCHED_NEW} greedy "
                            f"tokens) in {wall:.2f} s "
                            f"({len(BATCH_PROMPTS) * SPEC_SCHED_NEW / wall:.2f} tok/s), "
                            f"{json.dumps(stats)}; each stream teacher-forced at the "
                            f"scheduler's shapes: logprobs within {worst:.3g}, tokens apart "
                            f"(under a {GAP_NATS}-nat gap) {apart}; launches in the run "
                            f"{nonzero(launched)}, of them in its verify blocks "
                            f"{nonzero(in_blocks)}")
    for line in forced_sched:
        print(f"[spec] 4-slot BatchScheduler, {line}; {card}", flush=True)
    t_sched = time.perf_counter()

    # --- one request through the in-process server over the spec engine
    se.spec_k = 1
    httpd = server.start_temp_server(se, None, "synthetic/deepseek-v2-lite+mtp", port=0,
                                     backend="native")
    try:
        status, _, body = http_call(httpd.port, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "speculative " * 40}], "max_tokens": 16,
            "temperature": 0.0})
    finally:
        httpd.shutdown()
    answer = json.loads(body)
    spec_stats = answer.get("timing", {}).get("spec")
    if status != 200 or not spec_stats or spec_stats["emitted"] != 16:
        raise AssertionError(f"[spec] the served request: {status} {answer}")
    print(f"[spec] served through the spec engine (native transport): timing "
          f"{json.dumps(answer['timing'])}", flush=True)

    name_of = {v: n for n, v in C.items()}
    for counter, res in mine:
        name = name_of[counter]
        if "form" in res:
            res["launches"] = forms.get(res["form"], 0)
        else:        # K1 in the spec requests, K4 in the 4-slot verify blocks
            res["launches"] = (block_counts if name == "K4" else counts).get(name, 0)
        res["launches_verify_step"] = {k: launches[k][0].get(name, 0) for k in launches}
    results.extend(mine)
    print(f"[spec] decode tok/s, spec against vanilla in this call (request, draft, k: "
          f"vanilla / spec): " + "; ".join(f"{n} + {new} {lab} k={k}: {v:.2f} / {s:.2f}"
                                            for lab, k, n, new, v, s in rates)
          + f"; busy share of a verify block k=1 / k=3: {launches[1][2]} / {launches[3][2]}; "
          f"{card}", flush=True)
    print(f"[time] spec phase {time.perf_counter() - t0:.1f} s: kernel checks "
          f"{t_kernels - t0:.1f} s, forced verify {t_forced - t_kernels:.1f} s, requests "
          f"{t_requests - t_forced:.1f} s, schedulers {t_sched - t_requests:.1f} s", flush=True)
    del se, ng
    if on_card:
        torch.cuda.empty_cache()


def verify_cases():
    """K2's cases at the verify shapes: Sq = 2 and 4 at kv_len 40, 600 and
    2560 over the engine's 4096-row view (the split form), the window's
    later keys scaled by 4 so that the causal mask inside it matters."""
    from krasis_tpu_torch.ops import flash_attention as fa

    return [(f"attention:verify_Sq{sq}_kv_{kv}", sq, kv - sq, kv, 4096, fa.REPLACES_DECODE, 4.0)
            for sq in (2, 4) for kv in (40, 600, 2560)]


def hybrid_spec_phase(eng, cfg, results, rng):
    """12 (d). Prompt lookup on phase 5's Qwen3-Coder-Next Q4 (int8
    projections), k = 3: K2's split form at Sq = 2 and 4 on its GQA layers
    (with the no-mask control), K1s at T = 4 on the six stacked
    projections, K3 at T = 4 (44 picks of 513); requests 40 + 16 and a
    200-id block repeated four times + 16, beside the vanilla path, with
    every DeltaNet commit held to the recurrence over the committed prefix
    from the pre-window state; forced acceptance and rejection, teacher-
    forced against the batch-1 decode."""
    import statistics

    import torch
    from krasis_tpu_torch.models import spec_ngram
    from krasis_tpu_torch.ops import flash_attention as fa
    from krasis_tpu_torch.ops import moe, moe_cuda
    from krasis_tpu_torch.quant import qtensor_bytes
    from krasis_tpu_torch.runtime.engine import Engine

    t0 = time.perf_counter()
    card = card_line()
    dev = eng.device
    on_card = dev.type == "cuda"
    V = cfg.vocab_size
    mine = []
    if on_card:
        g = torch.Generator(device=dev)
        g.manual_seed(8765)
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        la, gqa = eng.params["layers"][0], eng.params["layers"][3]
        layer = la["qkvz_proj"].q.shape[0] - 1
        qmm_checks(mine, "qcn/spec/", tuple(
            (f"qmm_stacked:{name}_T4", lp[name], layer, torch.bfloat16, 4)
            for lp, name in ((la, "qkvz_proj"), (la, "ba_proj"), (la, "la_out_proj"),
                             (gqa, "q_proj"), (gqa, "k_proj"), (gqa, "o_proj"))), g, flush)
        d = cfg.qk_head_dim
        attention_checks(mine, "qcn/spec/", cfg.num_attention_heads, cfg.num_key_value_heads,
                         d, d, d, True, d ** -0.5, 3.0, g, flush, cases=verify_cases())
        w13, w2 = la["w13"], la["w2"]
        E_r, E_all, k = cfg.n_routed_experts, w13.q.shape[0], cfg.num_experts_per_tok
        Hd, I, T = cfg.hidden_size, cfg.moe_intermediate_size, 4
        x = torch.randn((T, Hd), generator=g, device=dev).to(torch.bfloat16)
        routed = torch.rand((T, E_r), generator=g, device=dev).topk(k, dim=-1).indices
        idx = torch.cat([routed, torch.arange(E_r, E_all, device=dev).expand(T, E_all - E_r)],
                        dim=1).to(torch.int32)
        wts = torch.cat([torch.rand((T, k), generator=g, device=dev) * 0.3,
                         torch.ones((T, E_all - E_r), device=dev)], dim=1)
        hit = int(torch.unique(idx).numel())
        k3_checks(mine, "qcn/spec/moe_decode_T4", x, w13, w2, idx, wts, moe_cuda.REPLACES,
                  hit * (qtensor_bytes(w13) + qtensor_bytes(w2)) / E_all + T * Hd * 4,
                  2 * idx.numel() * (Hd * 2 * I + I * Hd), flush)
        mine[-1][1]["experts_hit"] = hit
        del flush
    t_kernels = time.perf_counter()

    with spec_env("ngram", 3):
        ng = Engine(cfg, eng.quant, eng.params, max_len=eng.max_len, device=dev)
    C = counters()
    counts, forms = {}, {}
    block = rng.integers(100, V - 100, REPEAT_BLOCK).tolist()
    rates = []
    with SpecHooks(check_commit=True) as hooks:
        for label, p in (("40 + 16", rng.integers(100, V - 100, 40).tolist()),
                         (f"{REPEAT_BLOCK} ids x 4 + 16", block * 4)):
            ng.spec_available = False
            van = ng.generate(p, max_new_tokens=16, stop_ids={-1})
            ng.spec_available = True
            # the counts are set to 0 just before the spec request and read
            # just after: the spec path alone
            for m, attr in C.values():
                setattr(m, attr, 0)
            fa.form_launches.clear()
            moe.plain_routes.update(ragged_plain=0, gathered_plain=0)
            spec = ng.generate(p, max_new_tokens=16, stop_ids={-1})
            if any(moe.plain_routes.values()):
                raise AssertionError(f"[spec] qcn: MoE calls on a plain form {moe.plain_routes}")
            for name, (m, attr) in C.items():
                counts[name] = counts.get(name, 0) + getattr(m, attr)
            for form, c in fa.form_launches.items():
                forms[form] = forms.get(form, 0) + c
            if not spec.finite or len(spec.tokens) != 16 or ng.last_spec_stats is None:
                raise AssertionError(f"[spec] qcn {label}: {ng.last_spec_stats}")
            rates.append((label, van.decode_tok_s, spec.decode_tok_s, ng.last_spec_stats))
        commits = list(hooks.commits)
    for name in ("K1", "K1s", "K2", "K3"):
        if on_card and counts[name] <= 0:
            raise AssertionError(f"[spec] qcn: the spec requests launched no {name}")
    print(f"[spec] Qwen3-Coder-Next, prompt lookup k = 3 (decode tok/s vanilla / spec): "
          + "; ".join(f"{lab}: {v:.2f} / {s:.2f} {json.dumps(st)}" for lab, v, s, st in rates)
          + f"; {len(commits)} DeltaNet commits held to the recurrence, "
          f"{sum(e for e, _ in commits)} bit-equal, largest difference "
          f"{max((d for _, d in commits), default=0.0):.3g} of the state's largest value; "
          f"launches of the spec requests {json.dumps(counts)}; {card}", flush=True)
    t_requests = time.perf_counter()

    prompt = rng.integers(100, V - 100, 40).tolist()
    zargs = (torch.zeros((1, V), dtype=torch.bool, device=dev), torch.zeros(1, device=dev),
             torch.ones(1, device=dev), torch.zeros(1, device=dev),
             torch.zeros(1, dtype=torch.int32, device=dev))
    hist = torch.zeros((1, ng.max_len), dtype=torch.int64, device=dev)

    def prefill(k):
        ng.reset(ng.max_len)
        return torch.argmax(ng._prefill_prompt(prompt), dim=-1)

    def run_step(k, tok, drafts, hooks):
        hooks.drafts = drafts
        ts, _, nc, _, nxt = spec_ngram.ngram_decode_block(ng.params, tok, ng.cache, hist, cfg,
                                                          ng.quant, 1, k, None, *zargs)
        return ts[0, 0], int(nc[0, 0]), nxt

    with torch.inference_mode():
        held = forced_runs("Qwen3-Coder-Next, prompt lookup", ng, prompt, (3,), SPEC_STEPS,
                           prefill, run_step, check_commit=True)
    median = statistics.median(held) if held else None
    if median is None or not median <= FORCED_LP_MEDIAN:
        raise AssertionError(f"[spec] qcn forced verify against the batch-1 decode: median "
                             f"{median}")
    for counter, res in mine:
        res["launches"] = (forms.get(res["form"], 0) if "form" in res
                           else counts[{v: n for n, v in C.items()}[counter]])
    results.extend(mine)
    del ng
    print(f"[time] hybrid spec phase {time.perf_counter() - t0:.1f} s: kernel checks "
          f"{t_kernels - t0:.1f} s, requests {t_requests - t_kernels:.1f} s", flush=True)


OFFLOAD_HOT = 16           # the partial hot-expert cache of phase 13's requests
OFFLOAD_SUBLAYER_TOL = 3e-2
HOST_REL_TOL = 2e-6        # the host engine against its plain version, relative to the max
SERVE_OFFLOAD = ("--synthetic", "deepseek-v2-lite", "--offload", "experts", "--hot-experts",
                 str(OFFLOAD_HOT))


def host_line() -> str:
    """The host's memory (/proc/meminfo) and the CPUs this process may use."""
    import os

    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                mem[key] = int(value.split()[0]) * 1024
    return (f"host MemTotal {mem['MemTotal'] / 2**30:.1f} GiB, MemAvailable "
            f"{mem['MemAvailable'] / 2**30:.1f} GiB, nproc {len(os.sched_getaffinity(0))}")


def budget_phase():
    """13 (d). The budget of a model that does not fit the card (Qwen3-235B
    at Q4): resident bytes, and the device / host split under offload."""
    from krasis_tpu_torch.budget import card_memory, format_budget
    from krasis_tpu_torch.config import QuantConfig, preset_config

    text = format_budget(preset_config("qwen3-235b"), QuantConfig(expert_bits=4, group_size=128),
                         1, card_memory())
    for line in text.splitlines():
        print(f"[budget] {line}", flush=True)
    print(f"[budget] {host_line()}; {card_line()}", flush=True)


def offload_reference():
    """13 (a). Tiny V2-Lite, Qwen3-MoE, Qwen3-Coder-Next hybrid and GPT-OSS
    (phase 3's configurations, their weights from seed 1) with the routed
    experts offloaded: the OffloadEngine on the card (streamed prefill, the
    C++ host engine, n_hot 0, half and all) against the same engine on the
    CPU through the plain versions (the host engine's too), at phase 3's
    rule: a 160-id streamed prefill and three decode steps on fixed tokens,
    logits within the case's tolerance of the larger of 1 and the largest
    logit; then a 40 + 8 greedy stream, equal to the CPU's up to a step
    where the CPU's top two logprobs are within twice that tolerance. K2 and
    K4 must have launched, and no MoE call may take a plain form."""
    import torch
    from krasis_tpu_torch.config import QuantConfig
    from krasis_tpu_torch.models.params import init_synthetic_params
    from krasis_tpu_torch.models.synthetic import tiny_config
    from krasis_tpu_torch.offload import store_from_params
    from krasis_tpu_torch.ops import moe
    from krasis_tpu_torch.runtime.offload_engine import OffloadEngine

    t0 = time.perf_counter()
    q = dict(expert_bits=4, group_size=128, kv_cache_dtype="bf16")
    cases = (
        ("tiny V2-Lite", tiny_config("deepseek-v2-lite", moe_intermediate_size=128,
                                     num_hidden_layers=4, num_experts_per_tok=8),
         QuantConfig(**q), 2e-2, None),
        ("tiny Qwen3-MoE", tiny_config("qwen3-moe", moe_intermediate_size=128,
                                       num_experts_per_tok=8), QuantConfig(**q), 2e-2, None),
        ("tiny Qwen3-Coder-Next hybrid", tiny_config("qwen3-coder-next", num_experts_per_tok=8),
         QuantConfig(**q, attention="int8"), 5e-2, None),
        ("tiny GPT-OSS, fp8 cache", tiny_config("gpt-oss-20b", num_hidden_layers=4,
                                                sliding_window=4, num_experts_per_tok=4),
         QuantConfig(expert_bits=4, group_size=32, kv_cache_dtype="fp8"), 5e-2, lift_four))
    C = counters()
    for m, attr in C.values():
        setattr(m, attr, 0)
    moe.plain_routes.update(ragged_plain=0, gathered_plain=0)
    prompt = torch.randint(1, 500, (160,), generator=torch.Generator().manual_seed(3)).tolist()
    for label, cfg, quant, tol, prepare in cases:
        cpu = init_synthetic_params(cfg, quant, seed=1, device="cpu")
        if prepare is not None:
            prepare(cpu)
        sp_cpu, store_cpu = store_from_params(cfg, quant, cpu)
        store_cpu.plain = True
        _, store_gpu = store_from_params(cfg, quant, cpu, pin=True)
        sp_gpu = to_device(sp_cpu, "cuda")
        E = cfg.n_routed_experts
        for n_hot in (0, E // 2, E):
            worst, diverged = 0.0, None
            engines = [OffloadEngine(cfg, quant, sp, st, hot_experts=n_hot, max_len=512,
                                     device=dev)
                       for sp, st, dev in ((sp_cpu, store_cpu, "cpu"),
                                           (sp_gpu, store_gpu, "cuda"))]
            runs = []
            with torch.inference_mode():
                for e in engines:
                    e.reset(512)
                    logits = [e._prefill_prompt(prompt)]
                    for tok in (7, 11, 13):
                        logits.append(e._forward(torch.tensor([[tok]], device=e.device),
                                                 torch.ones(1, dtype=torch.int32,
                                                            device=e.device), prefill=False))
                    runs.append([x.float().cpu() for x in logits])
            for step, (r, g) in enumerate(zip(*runs)):
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"[offload] {label} n_hot {n_hot} step {step}: "
                                         "non-finite logits")
                err = float((g - r).abs().max())
                worst = max(worst, err)
                if not err <= tol * max(1.0, float(r.abs().max())):
                    raise AssertionError(f"[offload] {label} n_hot {n_hot} step {step}: card "
                                         f"vs CPU {err}")
            want = engines[0].generate(prompt[:40], max_new_tokens=8, stop_ids={-1},
                                       top_logprobs=2)
            got = engines[1].generate(prompt[:40], max_new_tokens=8, stop_ids={-1})
            diverged = next((i for i, (a, b) in enumerate(zip(got.tokens, want.tokens))
                             if a != b), None)
            if diverged is not None:
                (_, t1), (_, t2) = want.top_logprobs[diverged][:2]
                if not t1 - t2 < 2 * tol:
                    raise AssertionError(f"[offload] {label} n_hot {n_hot}: the card's stream "
                                         f"left the CPU's at step {diverged}, top-two gap "
                                         f"{t1 - t2:.4f}")
            print(f"[offload] reference {label}, n_hot {n_hot} of {E}: streamed prefill + 3 "
                  f"decode steps on the card vs the CPU plain path, max|Δ| logits "
                  f"{worst:.3g} (limit {tol}); 40 + 8 greedy "
                  + ("equal" if diverged is None else f"equal up to a near-tie at step "
                     f"{diverged}") + f"; host calls on the card {store_gpu.host_calls}",
                  flush=True)
            del engines
    counts = {name: getattr(*C[name]) for name in ("K2", "K4")}
    print(f"[offload] reference phase {time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps(counts)}; MoE calls on a plain route {moe.plain_routes}", flush=True)
    if min(counts.values()) <= 0 or any(moe.plain_routes.values()):
        raise AssertionError(f"[offload] reference: launches {counts}, plain routes "
                             f"{moe.plain_routes}")


def offload_load_check(path, quant, rng):
    """13 (b), from disk: load_params_offload on phase 9's V2-Lite checkpoint
    through its weight cache. The store is the cache's mmap'd pages
    (pageable, no pinned copy), so the streamed prefill stages them through
    pinned buffers: the H2D time of one group alone and the rate with
    overlap; then a 2048 + 8 greedy request, finite, on no plain MoE form."""
    import torch
    from krasis_tpu_torch.config import ModelConfig
    from krasis_tpu_torch.models.loader import load_params_offload
    from krasis_tpu_torch.ops import moe
    from krasis_tpu_torch.runtime.offload_engine import OffloadEngine

    card = card_line()
    cfg = ModelConfig.from_model_path(path)
    t = time.perf_counter()
    params, store = load_params_offload(cfg, quant)
    t_load = time.perf_counter() - t
    if any(a.is_pinned() for e in store._layers.values() for a in e if a is not None):
        raise AssertionError("[offload] load_params_offload copied the store into pinned memory")
    eng = OffloadEngine(cfg, quant, params, store, max_len=4096)
    prompt = rng.integers(100, cfg.vocab_size - 100, 2048).tolist()
    with torch.inference_mode():
        eng.reset()
        eng.streamer.measure_h2d = True
        eng._prefill_prompt(prompt)
        alone = dict(eng.last_stream_stats)
        eng.streamer.measure_h2d = False
    moe.plain_routes.update(ragged_plain=0, gathered_plain=0)
    res = eng.generate(prompt, max_new_tokens=8, stop_ids={-1})
    st = eng.last_stream_stats
    print(f"[offload] load_params_offload, {os.path.basename(path)} ({cfg.num_hidden_layers} "
          f"layers) through its weight cache: {store.nbytes() / 1e9:.3f} GB of experts in the "
          f"cache's pages (pageable), loaded in {t_load:.2f} s; streamed prefill staged through "
          f"pinned buffers: one group alone {alone['h2d_first_rep_s'] * 1e3:.2f} ms, "
          f"{alone['h2d_gbps_measured']:.2f} GB/s (staging included), "
          f"{st['effective_gbps_with_overlap']:.2f} GB/s with overlap over {st['groups']} "
          f"groups; 2048 + 8: prefill {res.prefill_tok_s:.1f} tok/s, decode "
          f"{res.decode_tok_s:.2f} tok/s; {card}", flush=True)
    if not (st["staged"] and res.finite and len(res.tokens) == 8) or any(
            moe.plain_routes.values()):
        raise AssertionError(f"[offload] from disk: staged {st['staged']}, finite {res.finite}, "
                             f"{len(res.tokens)} tokens, plain routes {moe.plain_routes}")
    del eng, params, store
    torch.cuda.empty_cache()


def device_bytes(tree) -> int:
    """Bytes of the distinct device storages a parameter tree holds."""
    import torch
    from krasis_tpu_torch.quant import QTensor

    seen = {}

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        elif isinstance(t, QTensor):
            walk(t.q)
            walk(t.scales)
        elif isinstance(t, torch.Tensor) and t.is_cuda:
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    walk(tree)
    return sum(seen.values())


def offload_phase(eng, cfg, results, rng):
    """13 (b). The offload tier on phase 4's V2-Lite Q4 weights (27 layers at
    full width): its 26 MoE layers' routed experts (folded shared rows cut
    off) copied into a pinned host store, 7.42 GB. The host engine against
    its plain version on a real layer at T = 1 and 4 (2e-6 relative), with
    every one-pick-dropped control refused, and its time a layer; K4 on a
    streamed slot (E = 64) at T = 2048 and K5 on a 16-expert hot substack
    with 3 of 6 picks masked (a dropped hot pick refused); each MoE layer's
    offloaded sublayer (16 hot + host) at one decode step against the plain
    gathered MoE over the full stack; the streamed prefill of 2048 and 2500
    ids against the resident prefill (K4's tolerance; bit-equality
    reported), with the H2D rate of one group alone and with overlap; then,
    with the launch counts set to 0 just before and read just after,
    requests 2048 + 16 at n_hot 0, update_hot_cache from its heatmap (the
    same device buffers), 40 + 16 at n_hot 16 (fewer host picks a token
    than 40 + 16 at n_hot 0), 40 + 16 all hot (no host call) and 40 + 16 at
    n_hot 0; K1, K2 (both forms), K4 and K5 launched, K3, K6, K6a, K7, K7a
    not, no plain MoE form. A profiled 40 + 8 decode (busy share), the
    device bytes offloaded against resident, and a 2-slot BatchScheduler
    with offload on two 40 + 16 requests, each stream held teacher-forced."""
    import statistics

    import numpy as np
    import torch
    from krasis_tpu_torch.models import model as M
    from krasis_tpu_torch.offload import build_hot_params, store_from_params
    from krasis_tpu_torch.ops import flash_attention as fa
    from krasis_tpu_torch.ops import moe, moe_cuda
    from krasis_tpu_torch.ops.moe import moe_forward_gathered
    from krasis_tpu_torch.ops.routing import compute_routing
    from krasis_tpu_torch.ops.sampling import SamplingParams
    from krasis_tpu_torch.quant import QTensor
    from krasis_tpu_torch.runtime.engine import CHUNK
    from krasis_tpu_torch.runtime.offload_engine import OffloadEngine
    from krasis_tpu_torch.runtime.scheduler import BatchScheduler

    t0 = time.perf_counter()
    card = card_line()
    dev = eng.device
    on_card = dev.type == "cuda"
    H, I, E, k = cfg.hidden_size, cfg.moe_intermediate_size, cfg.n_routed_experts, \
        cfg.num_experts_per_tok
    V = cfg.vocab_size
    mine = []
    quant = eng.quant

    def sync():
        if on_card:
            torch.cuda.synchronize()

    sync()
    t = time.perf_counter()
    sp, store = store_from_params(cfg, quant, eng.params, pin=on_card)
    sync()
    t_store = time.perf_counter() - t
    layer_bytes = store.layer_nbytes()
    pick_bytes = layer_bytes / E
    n_moe = len(store.layers)
    print(f"[offload] store: {n_moe} MoE layers, {store.nbytes() / 1e9:.3f} GB of host memory "
          f"({'pinned' if on_card else 'pageable'}; {layer_bytes / 1e6:.2f} MB a layer, "
          f"{pick_bytes / 1e6:.3f} MB a pick), copied from the card in {t_store:.2f} s; host "
          f"engine tier {store.native_tier()}, {store.native_threads()} threads; {host_line()}; "
          f"{card}", flush=True)

    # --- the host engine against its plain version on a real layer
    layer = store.layers[0]
    host_ms = {}
    for T in (1, 4):
        x = torch.randn((T, H), generator=torch.Generator().manual_seed(T)).to(
            torch.bfloat16).float().numpy()
        idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)]).astype(np.int32)
        w = rng.random((T, k)).astype(np.float32)
        w /= w.sum(axis=1, keepdims=True)
        got = store.forward(layer, x, idx, w)
        want = store.forward(layer, x, idx, w, plain=True)
        scale = float(np.abs(want).max())
        rel = float(np.abs(got - want).max()) / scale
        dropped = []
        for j in range(k):
            w0 = w.copy()
            w0[:, j] = 0.0
            dropped.append(float(np.abs(got - store.forward(layer, x, idx, w0, plain=True)).max())
                           / scale / HOST_REL_TOL)
        times = []
        for _ in range(20 if T == 1 else 10):
            t = time.perf_counter()
            store.forward(layer, x, idx, w)
            times.append(time.perf_counter() - t)
        t = time.perf_counter()
        store.forward(layer, x, idx, w, plain=True)
        plain_ms = (time.perf_counter() - t) * 1e3
        host_ms[T] = statistics.median(times) * 1e3
        print(f"[offload] host engine, layer {layer}, T = {T} ({T * k} picks): max|Δ| "
              f"{rel:.3g} of the largest value against its plain version (limit "
              f"{HOST_REL_TOL}); the plain version without one pick is {min(dropped):.3g} to "
              f"{max(dropped):.3g} of the limit away; {host_ms[T]:.3f} ms a call (median of "
              f"{len(times)}), plain {plain_ms:.1f} ms; "
              f"{T * k * pick_bytes / (host_ms[T] / 1e3) / 1e9:.2f} GB/s of pick bytes; {card}",
              flush=True)
        if not rel < HOST_REL_TOL:
            raise AssertionError(f"[offload] host engine vs plain {rel} >= {HOST_REL_TOL}")
        if not min(dropped) > 1.0:
            raise AssertionError("[offload] the host check cannot see a pick dropped")
    # a decode token's pattern: each call another layer and other picks, so
    # the picks come from DRAM, not from a cache the repeated call warmed
    xs1 = torch.randn((1, H), generator=torch.Generator().manual_seed(5)).to(
        torch.bfloat16).float().numpy()
    cycle = []
    for _ in range(3):
        for li in store.layers:
            idx = rng.choice(E, k, replace=False).astype(np.int32)[None]
            t = time.perf_counter()
            store.forward(li, xs1, idx, np.full((1, k), 1.0 / k, np.float32))
            cycle.append(time.perf_counter() - t)
    cold_ms = statistics.median(cycle) * 1e3
    print(f"[offload] host engine, T = 1, every layer in turn with fresh picks (3 sweeps): "
          f"{cold_ms:.3f} ms a call (median), {k * pick_bytes / (cold_ms / 1e3) / 1e9:.2f} GB/s "
          f"of pick bytes (the repeated call above: {host_ms[1]:.3f} ms); a decode token at "
          f"n_hot 0: {n_moe} x {cold_ms:.3f} = {n_moe * cold_ms:.1f} ms of host compute for "
          f"{n_moe * k * pick_bytes / 1e6:.0f} MB of picks; {card}", flush=True)
    store.heatmap.clear()

    if on_card:
        g = torch.Generator(device=dev)
        g.manual_seed(4321)
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        w13q, w13s, w2q, w2s, _, _ = store._layers[layer]
        # K4 on a streamed slot: the group's 64 routed experts as the
        # streamed prefill holds them, at the 2048-row chunk
        slot13 = QTensor(w13q.to(dev), w13s.to(dev), store.bits, store.gs13)
        slot2 = QTensor(w2q.to(dev), w2s.to(dev), store.bits, store.gs2)
        xs = torch.randn((2048, H), generator=g, device=dev).to(torch.bfloat16)
        topk = torch.rand((2048, E), generator=g, device=dev).topk(k, dim=-1).indices.to(
            torch.int32)
        k4_checks(mine, "offload/slot ", xs, topk, slot13, slot2, cfg)
        del slot13, slot2, xs
        # K5 on a 16-expert hot substack, 3 of the 6 picks hot, the cold 3
        # masked (id 0, weight 0)
        hot_ids = torch.arange(0, E, E // OFFLOAD_HOT)[:OFFLOAD_HOT]
        hw13 = QTensor(w13q[hot_ids].to(dev), w13s[hot_ids].to(dev), store.bits, store.gs13)
        hw2 = QTensor(w2q[hot_ids].to(dev), w2s[hot_ids].to(dev), store.bits, store.gs2)
        remap = torch.full((E,), -1, dtype=torch.int32)
        remap[hot_ids] = torch.arange(OFFLOAD_HOT, dtype=torch.int32)
        picks = torch.tensor([int(hot_ids[1]), 1, int(hot_ids[6]), 3, int(hot_ids[11]), 5])
        local = remap[picks].to(dev)[None]
        valid = local >= 0
        idx = torch.where(valid, local, torch.zeros_like(local))
        x1 = torch.randn((1, H), generator=g, device=dev).to(torch.bfloat16)
        wts = torch.where(valid, torch.rand((1, k), generator=g, device=dev) * 0.3 + 0.05,
                          torch.zeros((1, k), device=dev))
        n_valid = int(valid.sum())
        alone = torch.where(valid, torch.full_like(wts, 1.0 / n_valid), torch.zeros_like(wts))
        casts = moe_cuda.k5_casts
        core_checks(mine, "offload/hot16 moe_decode_bf16", counters()["K5"], moe_cuda.K5_KERNELS,
                    moe_cuda.REPLACES_BF16, lambda w: moe_cuda.moe_bf16(x1, hw13, hw2, idx, w),
                    lambda w: moe_cuda.moe_bf16_plain(x1, hw13, hw2, idx, w), wts,
                    n_valid * pick_bytes + H * 4, 2 * n_valid * (H * 2 * I + I * H), flush,
                    controls=[(alone, [j for j in range(k) if bool(valid[0, j])])], tol=3e-2,
                    peak=PEAK_BF16, source=moe_cuda.SOURCE)
        if moe_cuda.k5_casts != casts:
            raise AssertionError("[offload] K5 cast its rows or picks with PyTorch first")
        del hw13, hw2, flush
        torch.cuda.empty_cache()
    t_kernels = time.perf_counter()

    # --- each MoE layer's offloaded sublayer at one decode step
    hot16 = build_hot_params(cfg, quant, sp, store, OFFLOAD_HOT, device=dev)
    worst = 0.0
    gx = torch.Generator(device=dev)
    gx.manual_seed(77)
    with torch.inference_mode():
        for li in store.layers:
            full, off = eng.params["layers"][li], hot16["layers"][li]
            x = torch.randn((1, H), generator=gx, device=dev).to(torch.bfloat16)
            r = compute_routing(x, full["gate_w"], cfg, full.get("gate_bias"))
            got = M._offload_mlp(off, x, cfg, r, store, li)
            want = moe_forward_gathered(x, full["w13"], full["w2"], r.topk_idx,
                                        r.topk_weights) + M._shared_expert(full, x)
            err, ratio = max_err(got, want, OFFLOAD_SUBLAYER_TOL)
            worst = max(worst, ratio)
            if not ratio <= 1.0:
                raise AssertionError(f"[offload] layer {li}: the offloaded sublayer is {ratio:.3g} "
                                     "of the limit from the plain gathered MoE")
    print(f"[offload] one decode step, each of the {n_moe} MoE layers: offloaded sublayer "
          f"({OFFLOAD_HOT} hot on the card + the host) against the plain gathered MoE over the "
          f"full stack (+ the shared expert), worst {worst:.3g} of the limit (tol "
          f"{OFFLOAD_SUBLAYER_TOL}); {card}", flush=True)
    del hot16
    store.heatmap.clear()

    # --- the streamed prefill against the resident prefill
    off0 = OffloadEngine(cfg, quant, sp, store, max_len=eng.max_len, device=dev)
    for n in (2048, 2500):
        prompt = rng.integers(100, V - 100, n).tolist()
        with torch.inference_mode():
            off0.reset()
            off0.streamer.measure_h2d = True
            off0._prefill_prompt(prompt)           # the H2D of one group alone
            alone = dict(off0.last_stream_stats)
            off0.streamer.measure_h2d = False
            walls = {"resident": [], "streamed": []}
            # resident, streamed, streamed, resident: each rate the faster of two
            for name, e in (("resident", eng), ("streamed", off0), ("streamed", off0),
                            ("resident", eng)):
                e.reset()
                sync()
                t = time.perf_counter()
                out = e._prefill_prompt(prompt)
                sync()
                walls[name].append(time.perf_counter() - t)
                if name == "resident":
                    want = out
                else:
                    got, st = out, dict(off0.last_stream_stats)
            t_res, t_off = min(walls["resident"]), min(walls["streamed"])
        err, ratio = max_err(got, want, 3e-2)
        bit = bool(torch.equal(got, want))
        one = (f"{alone['h2d_first_rep_s'] * 1e3:.2f} ms, {alone['h2d_gbps_measured']:.2f} GB/s"
               if "h2d_first_rep_s" in alone else "not measured (no card)")
        print(f"[offload] streamed prefill {n} ids: {n / t_off:.1f} tok/s against resident "
              f"{n / t_res:.1f} tok/s (each the faster of two, in turns); logits max|Δ| "
              f"{err:.3g} from the resident prefill's, {ratio:.3g} of K4's limit, {'bit-equal' if bit else 'not bit-equal'}; "
              f"{st['groups']} groups of {st['rep_bytes'] / 1e6:.1f} MB, "
              f"{st['streamed_bytes'] / 1e9:.3f} GB streamed in {st['phase2_s']:.3f} s: "
              f"{st['effective_gbps_with_overlap']:.2f} GB/s with overlap; one group alone "
              f"{one} ({'staged' if st['staged'] else 'no staging'}); {card}", flush=True)
        if not ratio <= 1.0:
            raise AssertionError(f"[offload] streamed prefill of {n} ids: {ratio:.3g} of the "
                                 "limit from the resident prefill")
    t_prefill = time.perf_counter()

    # --- requests; the launch counts over them alone
    off16 = OffloadEngine(cfg, quant, sp, store, hot_experts=OFFLOAD_HOT, max_len=eng.max_len,
                          device=dev)
    off64 = OffloadEngine(cfg, quant, sp, store, hot_experts=E, max_len=eng.max_len, device=dev)
    ptrs = [off16.params["layers"][li]["hot_w13"].q.data_ptr() for li in store.layers]
    warm = rng.integers(100, V - 100, 40).tolist()
    for e in (off0, off16, off64):
        e.generate(warm, max_new_tokens=4, stop_ids={-1})          # warm-up
    store.heatmap.clear()
    C = counters()
    for m, attr in C.values():
        setattr(m, attr, 0)
    fa.form_launches.clear()
    moe.plain_routes.update(ragged_plain=0, gathered_plain=0)
    rates = {}

    def request(label, e, n, new):
        prompt = rng.integers(100, V - 100, n).tolist()
        c0, p0, s0 = store.host_calls, store.host_picks, store.host_time_s
        res = e.generate(prompt, max_new_tokens=new, stop_ids={-1})
        if not res.finite or len(res.tokens) != new:
            raise AssertionError(f"[offload] {label}: {len(res.tokens)} tokens, finite "
                                 f"{res.finite}")
        calls, picks = store.host_calls - c0, store.host_picks - p0
        # decode forwards after the prefill's token: whole blocks
        steps = -(-(new - 1) // e.decode_block) * e.decode_block
        out = dict(prefill_tok_s=res.prefill_tok_s, decode_tok_s=res.decode_tok_s,
                   host_calls=calls, host_picks=picks,
                   host_ms_token=(store.host_time_s - s0) * 1e3 / max(steps, 1),
                   picks_token=picks / max(steps, 1))
        rates[label] = out
        print("[offload] request " + json.dumps({"request": label, "prompt": n, "tokens": new,
                                                  **out}) + f"; {card}", flush=True)
        return res

    request("2048 + 16, n_hot 0", off0, 2048, 16)
    off16.update_hot_cache()
    if [off16.params["layers"][li]["hot_w13"].q.data_ptr() for li in store.layers] != ptrs:
        raise AssertionError("[offload] update_hot_cache reallocated the hot buffers")
    request(f"40 + 16, n_hot {OFFLOAD_HOT}", off16, 40, 16)
    request(f"40 + 16, n_hot {E} (all)", off64, 40, 16)
    request("40 + 16, n_hot 0", off0, 40, 16)
    counts = {name: getattr(m, attr) for name, (m, attr) in C.items()}
    by_form = dict(fa.form_launches)
    print(f"[offload] launches over the requests {json.dumps(counts)}; K2 by form "
          f"{json.dumps(by_form)}; MoE calls on a plain route {moe.plain_routes}", flush=True)
    if rates[f"40 + 16, n_hot {E} (all)"]["host_calls"] != 0:
        raise AssertionError("[offload] the all-hot request called the host")
    if not (rates[f"40 + 16, n_hot {OFFLOAD_HOT}"]["picks_token"]
            < rates["40 + 16, n_hot 0"]["picks_token"]):
        raise AssertionError(f"[offload] host picks a token did not fall at n_hot "
                             f"{OFFLOAD_HOT}: {rates}")
    if on_card:
        for name in ("K1", "K2", "K4", "K5"):
            if counts[name] <= 0:
                raise AssertionError(f"[offload] {name} was never launched on the offload path")
        for name in ("K3", "K6", "K6a", "K6a product", "K7", "K7a"):
            if counts[name] != 0:
                raise AssertionError(f"[offload] {name} was launched {counts[name]} times")
        for form in ("one-launch", "split"):
            if by_form.get(form, 0) <= 0:
                raise AssertionError(f"[offload] K2's {form} form was never launched")
    if any(moe.plain_routes.values()):
        raise AssertionError(f"[offload] MoE calls on a plain form {moe.plain_routes}")
    res_rate = eng.generate(rng.integers(100, V - 100, 40).tolist(), max_new_tokens=16,
                            stop_ids={-1})
    print(f"[offload] decode tok/s at n_hot 0 / {OFFLOAD_HOT} / {E}: "
          f"{rates['40 + 16, n_hot 0']['decode_tok_s']:.2f} / "
          f"{rates[f'40 + 16, n_hot {OFFLOAD_HOT}']['decode_tok_s']:.2f} / "
          f"{rates[f'40 + 16, n_hot {E} (all)']['decode_tok_s']:.2f}, resident (its "
          f"{quant.expert_activation} expert activations) {res_rate.decode_tok_s:.2f}; {card}",
          flush=True)
    name_of = {v: n for n, v in C.items()}
    for counter, res in mine:
        res["launches"] = counts[name_of[counter]]
    results.extend(mine)
    t_requests = time.perf_counter()

    # --- device memory, offloaded against resident; the busy share
    slots = off0.streamer.slot_bytes()
    res_b, off_b = device_bytes(eng.params), device_bytes(sp)
    hot_b = device_bytes(off16.params) - off_b
    del off64
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        off0.generate(rng.integers(100, V - 100, 2048).tolist(), max_new_tokens=8,
                      stop_ids={-1})
        peak_off = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        eng.generate(rng.integers(100, V - 100, 2048).tolist(), max_new_tokens=8,
                     stop_ids={-1})
        peak_res = torch.cuda.max_memory_allocated() - base
    else:
        peak_off = peak_res = 0
    print(f"[offload] device memory: resident weights {res_b / 2**30:.2f} GiB; offloaded "
          f"weights {off_b / 2**30:.2f} GiB + the two slots {slots / 2**30:.3f} GiB "
          f"(+ {hot_b / 2**30:.2f} GiB for {OFFLOAD_HOT} hot experts a layer); "
          f"{(res_b - off_b - slots) / 2**30:.2f} GiB less at n_hot 0; a 2048 + 8 request's "
          f"peak above the weights and caches held: offloaded {peak_off / 2**30:.2f} GiB, "
          f"resident {peak_res / 2**30:.2f} GiB; {card}", flush=True)
    if on_card:
        print("[profile] offloaded V2-Lite Q4, n_hot 0, 40 + 8:", flush=True)
        profile_phase(off0, rng.integers(100, V - 100, 40).tolist(), 8,
                      moe_cuda.K3_KERNELS)

    # --- a 2-slot BatchScheduler with offload, each stream teacher-forced
    greedy = SamplingParams(temperature=0.0)
    sched = BatchScheduler(cfg, quant, sp, max_len=eng.max_len, num_slots=2, decode_block=8,
                           device=dev, offload=store)
    try:
        prompts = [rng.integers(100, V - 100, 40).tolist() for _ in range(2)]
        t = time.perf_counter()
        reqs = [sched.submit(p, max_new_tokens=16, sampling=greedy, stop_ids={-1},
                             want_logprobs=True) for p in prompts]
        outs = []
        for r in reqs:
            toks = []
            while (tok := r.out_queue.get(timeout=600)) is not None:
                toks.append(tok)
            if r.error is not None:
                raise AssertionError("[offload] the scheduler failed") from r.error
            outs.append(toks)
        wall = time.perf_counter() - t
    finally:
        sched.shutdown()
    lines = []
    for i, (p, r, toks) in enumerate(zip(prompts, reqs, outs)):
        if len(toks) != 16:
            raise AssertionError(f"[offload] scheduler stream {i}: {len(toks)} tokens")
        act, steps = teacher_forced(off0, p, toks, 2, CHUNK)     # the same streamed prefill
        n, held, vocab, row, flipped = hold_teacher_forced(f"[offload] 2-slot stream {i}", toks,
                                                           r.logprobs, steps)
        median = statistics.median(held) if held else None
        if median is None or not median <= FORCED_LP_MEDIAN:
            raise AssertionError(f"[offload] 2-slot stream {i}: median logprob difference "
                                 f"{median} (limit {FORCED_LP_MEDIAN})")
        lines.append(f"stream {i}: {n} steps, {len(held)} held (median {median:.3g}, max "
                     f"{max(held):.3g}), rows within {row:.3g}, other picks at {flipped}")
    print(f"[offload] 2-slot BatchScheduler with offload (streamed admission prefill): two 40 "
          f"+ 16 requests at once in "
          f"{wall:.2f} s ({32 / wall:.2f} tok/s), teacher-forced: " + "; ".join(lines)
          + f"; {card}", flush=True)
    print(f"[time] offload phase {time.perf_counter() - t0:.1f} s: store {t_store:.1f} s, "
          f"kernel checks {t_kernels - t0:.1f} s, prefill {t_prefill - t_kernels:.1f} s, "
          f"requests {t_requests - t_prefill:.1f} s", flush=True)
    del off0, off16, sp, store
    if on_card:
        torch.cuda.empty_cache()


MEASURE_DEVICE = "cuda"              # a CPU rehearsal at tiny widths sets "cpu"
MEASURE_PREFILL = (2048, 8192)       # (a): run_engine_benchmark's timed prompts
MEASURE_QUALITY_STEPS = 200          # (d): training steps (the tools run: 600)
MEASURE_MTP_STEPS = 100
MEASURE_QUALITY_TOKENS = 4096        # held-out ids a mode scores on the prefill path
MEASURE_DECODE_TOKENS = 256          # and on the forced decode path,
MEASURE_DECODE_SEGMENT = 128         # in two 128-id segments (the tools run: 512-id ones)
QUALITY_PPL_RTOL = 1e-2              # a mode's card PPL against the CPU plain path
FORCED_ATOL, FORCED_MEAN = 0.15, 0.01   # forced decode against prefill (tests/test_quality_matrix.py)


CPU_MATRIX = """
import json, sys
import torch
torch.set_num_threads(max(1, torch.get_num_threads() // 2))
from krasis_tpu_torch import quality
ck, n, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
res = quality.run_matrix(ck, shapes=((512, 256),), max_tokens=n, device="cpu",
                         decode_path=False, spec_checks=False)
with open(out, "w") as f:
    json.dump(res, f)
"""


def zero_counts():
    from krasis_tpu_torch.ops import flash_attention as fa
    from krasis_tpu_torch.ops import moe

    for m, attr in counters().values():
        setattr(m, attr, 0)
    fa.form_launches.clear()
    moe.plain_routes.update(ragged_plain=0, gathered_plain=0)


def read_counts(label, on_path, forms=()):
    """The launch counts since zero_counts(); every kernel of `on_path` and
    K2 form of `forms` must have launched, and no MoE call taken a plain form."""
    from krasis_tpu_torch.ops import flash_attention as fa
    from krasis_tpu_torch.ops import moe

    counts = {name: getattr(m, attr) for name, (m, attr) in counters().items()}
    by_form = dict(fa.form_launches)
    print(f"[launches] {label}: {json.dumps(counts)}; K2 by form {json.dumps(by_form)}; MoE "
          f"calls on a plain route {moe.plain_routes}", flush=True)
    for name in on_path:
        if counts[name] <= 0:
            raise AssertionError(f"{label}: {name} was never launched")
    for form in forms:
        if by_form.get(form, 0) <= 0:
            raise AssertionError(f"{label}: K2's {form} form was never launched")
    if any(moe.plain_routes.values()):
        raise AssertionError(f"{label}: MoE calls on a plain form {moe.plain_routes}")
    return counts, by_form


def quality_kernel_checks(results, ck, g, flush):
    """The quality model's kernels at its own shapes (hidden 256, GQA 4 / 2
    heads of 64, 8 experts of 128 top-2, gs 128, so K / gs = 2 and 1): K1 on
    the int8 lm_head and K1s on an int8 q_proj stack at T = 1, K2's
    one-launch form over a 512-id window and its split form at kv_len 511,
    K3 and K5 at T = 1 and K4 at a window's T = 512, each against its plain
    version."""
    import torch
    from krasis_tpu_torch import quality
    from krasis_tpu_torch.config import ModelConfig
    from krasis_tpu_torch.models.loader import load_params
    from krasis_tpu_torch.ops import flash_attention as fa

    qcfg = ModelConfig.from_model_path(ck)
    p4 = load_params(qcfg, quality._quant_for("q4", 128), device="cuda")
    p8 = load_params(qcfg, quality._quant_for("q4-attn-int8", 128), device="cuda")
    q_proj = p8["layers"][0]["q_proj"]
    qmm_checks(results, "quality/", (
        ("qmm:lm_head", p4["lm_head"], None, torch.float32),
        ("qmm:q_proj_int8", q_proj, 0 if q_proj.q.dim() == 3 else None, torch.bfloat16)),
        g, flush)
    d = qcfg.qk_head_dim
    # score std = d^-0.5 * sqrt(d) * q_std = 3
    attention_checks(results, "quality/", qcfg.num_attention_heads, qcfg.num_key_value_heads, d,
                     128, d, True, d ** -0.5, 3.0, g, flush,
                     cases=[("attention:prefill_512", 512, 0, 512, 512, fa.REPLACES),
                            ("attention:decode_kv_511", 1, 510, 511, 512, fa.REPLACES_DECODE)])
    moe = next(lp for lp in p4["layers"] if "w13" in lp)
    moe_checks(results, "quality/", moe["w13"], moe["w2"], qcfg, g, flush, bf16_too=True,
               T=512)
    del p4, p8


@contextlib.contextmanager
def krasis_home(path):
    """KRASIS_TPU_HOME set to `path` inside the block, restored after it."""
    old = os.environ.get("KRASIS_TPU_HOME")
    os.environ["KRASIS_TPU_HOME"] = path
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("KRASIS_TPU_HOME", None)
        else:
            os.environ["KRASIS_TPU_HOME"] = old


def quality_prepare(home):
    """14 (d)'s checkpoint, which needs none of the port's kernels:
    build_quality_checkpoint (hidden 256, 4 layers, 8 experts top-2,
    MEASURE_QUALITY_STEPS steps) and train_mtp_head on MEASURE_DEVICE, in
    `home`, the measure phase's KRASIS_TPU_HOME. main runs it while nvcc
    builds the kernels. Returns the state measure_phase takes as `early`;
    cpu_matrix_start starts its CPU matrix."""
    from krasis_tpu_torch import quality

    t0 = time.perf_counter()
    with krasis_home(home):
        ck = quality.build_quality_checkpoint(steps=MEASURE_QUALITY_STEPS,
                                              out_dir=os.path.join(home, "quality"),
                                              device=MEASURE_DEVICE)
        quality.train_mtp_head(ck, steps=MEASURE_MTP_STEPS, device=MEASURE_DEVICE)
    with open(os.path.join(ck, "meta.json")) as f:
        meta = json.load(f)
    print(f"[quality] checkpoint: {MEASURE_QUALITY_STEPS} steps (reduced; the tools run "
          f"takes 600), tokenizer {meta['tokenizer_s']} s, training {meta['train_s']} s on "
          f"the card, loss {meta['final_train_loss']:.3f}, tail PPL "
          f"{meta['tail_ppl_torch']:.2f}; MTP {MEASURE_MTP_STEPS} steps, loss "
          f"{meta['mtp_final_loss']:.3f}; {time.perf_counter() - t0:.1f} s in all", flush=True)
    return {"home": home, "ck": ck, "ref": None, "cpu_json": os.path.join(home, "cpu_matrix.json")}


def cpu_matrix_start(early):
    """The CPU plain path's quality matrix over `early`'s checkpoint, in a
    process of its own on the host's other cores: measure_phase reads it."""
    with krasis_home(early["home"]):
        early["ref"] = subprocess.Popen(
            [sys.executable, "-c", CPU_MATRIX, early["ck"], str(MEASURE_QUALITY_TOKENS),
             early["cpu_json"]],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.DEVNULL)


def cpu_matrix_stop(early):
    """Stop `early`'s CPU matrix if it still runs."""
    ref = early.get("ref")
    if ref is not None and ref.poll() is None:
        ref.kill()
        ref.wait()


def measure_phase(eng, cfg, results, rng, early=None):
    """14. The measurement entry points on phase 4's V2-Lite Q4 weights, each
    with the launch counts set to 0 just before and read just after: (a)
    benchmark.run_engine_benchmark on an engine at max_len 16384 (warm-up on
    the warmup domain, prompts of 2048 and 8192 corpus ids, decode 3 x 32
    tokens at 2048 context), printed as [bench] lines with median, IQR and
    flagged runs, and K2 at the 8192 prompt's last chunk (2048 rows at
    q_off 6144 over a 16384-row view) against its plain version; (b)
    run_network_benchmark through start_temp_server on the native and the
    stdlib transports, 512 + 32, whose streamed chunks must equal the
    tokens of a direct generate on the served ids; (c)
    run_slots_benchmark at 1 and 4 slots, 512 + 32; (d) the quality matrix
    on the card: build_quality_checkpoint (hidden 256, 4 layers, 8 experts
    top-2, MEASURE_QUALITY_STEPS steps on the card), train_mtp_head, and
    run_matrix over the eight modes at window 512 / stride 256 on 4096
    held-out ids, the forced decode path over 256 (two 128-id segments), and
    the spec rows. Each
    mode's prefill PPL is held to the CPU plain path's on the same
    checkpoint and ids within 1e-2 relative (the CPU's matrix runs in a
    subprocess beside the card's); the bf16 engine's forced-decode
    log-probabilities to its prefill all-logits ones (atol 0.15, mean 0.01);
    ngram and MTP spec must be exact; no quantized mode may take a plain MoE
    form (bf16's unquantized experts take the reference's plain forms). The
    verdicts are printed, not held: the reduced run cannot resolve them.
    With `early` (quality_prepare's state, its CPU matrix started) the
    checkpoint was trained before and `early["home"]` is the phase's
    KRASIS_TPU_HOME; without, (d) trains it here."""
    import shutil
    import tempfile

    import torch
    from krasis_tpu_torch import benchmark, quality
    from krasis_tpu_torch.models.model import forced_decode
    from krasis_tpu_torch.ops import flash_attention as fa
    from krasis_tpu_torch.ops.rope import yarn_softmax_scale
    from krasis_tpu_torch.ops.sampling import SamplingParams
    from krasis_tpu_torch.runtime.engine import Engine
    from krasis_tpu_torch.server import ServerState, prompt_ids, start_temp_server

    dev = MEASURE_DEVICE
    on_path = ("K1", "K2", "K3", "K4") if dev == "cuda" else ()    # the CPU counts no launch
    t0 = time.perf_counter()
    home = early["home"] if early else tempfile.mkdtemp(prefix="krasis_measure_")
    old_home = os.environ.get("KRASIS_TPU_HOME")
    os.environ["KRASIS_TPU_HOME"] = home          # the corpus, weight cache and checkpoint
    greedy = SamplingParams(temperature=0.0)
    try:
        # (a) the engine protocol
        long = Engine(cfg, eng.quant, eng.params, max_len=16384, device=dev)
        long.decode_block = 32
        zero_counts()
        rep = benchmark.run_engine_benchmark(long, prefill_lengths=MEASURE_PREFILL,
                                             decode_runs=3, decode_tokens=32)
        _, by_form = read_counts("measure (a) run_engine_benchmark", on_path,
                                 ("one-launch", "split") if on_path else ())
        for n, r in rep["prefill"].items():
            print(f"[bench] prefill {n} ids ({r['domain']}): {r['tok_s']} tok/s, TTFT "
                  f"{r['ttft_s']} s", flush=True)
        d = rep["decode"]
        print(f"[bench] decode at {d['context']} context, {d['tokens_per_run']} tokens a run: "
              f"median {d['tok_s_median']} tok/s, IQR {d['tok_s_iqr']}, runs {d['tok_s_runs']}, "
              f"flagged {d['flagged_runs']}", flush=True)
        if dev == "cuda":
            g = torch.Generator(device="cuda")
            g.manual_seed(1414)
            flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
            L, DR = cfg.kv_lora_rank, cfg.qk_rope_head_dim
            scale = yarn_softmax_scale((cfg.qk_nope_head_dim + DR) ** -0.5, cfg.rope_scaling)
            attention_checks(results, "measure/", cfg.num_attention_heads, 1, L + DR, 640, L,
                             False, scale, 1.0, g, flush,
                             cases=[("attention:chunk_2048_at_6144", 2048, 6144, 8192, 16384,
                                     fa.REPLACES)])
            results[-1][1]["launches"] = by_form.get(results[-1][1]["form"], 0)
            del flush
        t_a = time.perf_counter()

        # (b) through the HTTP server, both transports
        msg = [{"role": "user", "content": "benchmark " * 512}]
        ids = prompt_ids(ServerState(long, None, "synthetic/deepseek-v2-lite"), msg)
        want = len(long.generate(ids, max_new_tokens=32, sampling=greedy).tokens)
        for backend in ("native", "python"):
            zero_counts()
            httpd = start_temp_server(long, None, "synthetic/deepseek-v2-lite", port=0,
                                      backend=backend)
            try:
                net = benchmark.run_network_benchmark(httpd.port, n_prompt_tokens=1024,
                                                      decode_tokens=32)
            finally:
                httpd.shutdown()
            read_counts(f"measure (b) network, {backend}", on_path)
            over = (None if not net["network_decode_tok_s"] else
                    round(100.0 * (1 - net["network_decode_tok_s"] / d["tok_s_median"]), 1))
            print(f"[bench] network {backend} ({httpd.backend}), {len(ids)} + 32: "
                  f"{json.dumps(net)}; against the engine's decode median: {over}%", flush=True)
            if net["streamed_chunks"] != want:
                raise AssertionError(f"measure (b) {backend}: {net['streamed_chunks']} streamed "
                                     f"chunks, the engine gives {want} tokens")
        del long
        torch.cuda.empty_cache()
        t_b = time.perf_counter()

        # (c) continuous batching
        zero_counts()
        slots = benchmark.run_slots_benchmark(cfg, eng.quant, eng.params, slots_list=(1, 4),
                                              max_len=2048, prompt_len=512, decode_tokens=32,
                                              device=dev)
        read_counts("measure (c) run_slots_benchmark", on_path)
        for n, r in slots.items():
            print(f"[bench] slots {n}, 512 + 32: {json.dumps(r)}", flush=True)
        torch.cuda.empty_cache()
        t_c = time.perf_counter()

        # (d) the quality matrix on the card, against the CPU plain path
        if early is None:
            early = quality_prepare(home)
            cpu_matrix_start(early)
        ck, ref, cpu_json = early["ck"], early["ref"], early["cpu_json"]
        t_train = time.perf_counter()
        try:
            zero_counts()
            card = quality.run_matrix(ck, shapes=((512, 256),),
                                      max_tokens=MEASURE_QUALITY_TOKENS, device=dev,
                                      decode_max_tokens=MEASURE_DECODE_TOKENS,
                                      decode_segment=MEASURE_DECODE_SEGMENT)
            q_counts = {name: getattr(m, attr) for name, (m, attr) in counters().items()}
            q_forms = dict(fa.form_launches)
            t_card = time.perf_counter()
            rc = ref.wait(timeout=900)
        finally:
            cpu_matrix_stop(early)
        if rc != 0:
            raise AssertionError(f"quality: the CPU matrix exited {rc}")
        with open(cpu_json) as f:
            cpu = json.load(f)
        for mode, e in card["modes"].items():
            got, ref = e["shapes"]["512/256"]["ppl"], cpu["modes"][mode]["shapes"]["512/256"]["ppl"]
            rel = abs(got - ref) / ref
            launched = {k: v for k, v in e["launches"].items() if v}
            print(f"[quality] {mode}: PPL card {got} CPU {ref} ({rel:.3g} relative, limit "
                  f"{QUALITY_PPL_RTOL}), decode path {e['decode']['ppl']}, verdict "
                  f"{e['verdict']}; launches {json.dumps(launched)}", flush=True)
            if not rel <= QUALITY_PPL_RTOL:
                raise AssertionError(f"quality {mode}: card PPL {got} against the CPU's {ref}")
            plain = e["launches"]["ragged_plain"] + e["launches"]["gathered_plain"]
            if mode != "bf16" and plain:
                raise AssertionError(f"quality {mode}: {plain} MoE calls on a plain form")
        print(f"[quality] verdicts (printed, not held): "
              f"{json.dumps({m: e['verdict'] for m, e in card['modes'].items()})}; spec "
              f"{json.dumps(card['spec'])}", flush=True)
        for name in ("ngram", "mtp"):
            if not card["spec"].get(name, {}).get("exact"):
                raise AssertionError(f"quality: {name} spec is not exact: {card['spec']}")
        print(f"[launches] measure (d) the card's matrix, every mode: {json.dumps(q_counts)}; "
              f"K2 by form {json.dumps(q_forms)}", flush=True)
        if dev == "cuda":
            first = len(results)
            g = torch.Generator(device="cuda")
            g.manual_seed(1919)
            flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
            quality_kernel_checks(results, ck, g, flush)
            del flush
            by_counter = {counters()[name]: n for name, n in q_counts.items()}
            for counter, res in results[first:]:
                res["launches"] = (q_forms.get(res["form"], 0) if "form" in res
                                   else by_counter[counter])

        bf = quality._build_engine(ck, "bf16", 128, 512, dev)
        ids = quality._eval_tokens(ck, 512)
        lsm = torch.log_softmax(bf.forward_all_logits(ids).to(torch.float32), dim=-1)
        tgt = torch.tensor(ids[1:], device=dev)
        lp_pre = lsm[:-1].gather(1, tgt[:, None])[:, 0].cpu()
        bf.reset(512)
        with torch.inference_mode():
            bf._prefill_prompt(ids[:1])
            lp_dec = forced_decode(bf.params, bf.cache, tgt[None], cfg=bf.cfg, quant=bf.quant)[0]
        diff = (lp_dec - lp_pre[1:]).abs()
        print(f"[quality] bf16 forced decode against prefill over {len(diff)} positions: "
              f"max|Δ| {float(diff.max()):.4g} (limit {FORCED_ATOL}), mean "
              f"{float(diff.mean()):.4g} (limit {FORCED_MEAN})", flush=True)
        if not (float(diff.max()) <= FORCED_ATOL and float(diff.mean()) < FORCED_MEAN):
            raise AssertionError("quality: forced decode leaves the prefill log-probabilities")
        del bf
        torch.cuda.empty_cache()
        print(f"[time] measure phase {time.perf_counter() - t0:.1f} s: (a) engine "
              f"{t_a - t0:.1f} s, (b) network {t_b - t_a:.1f} s, (c) slots {t_c - t_b:.1f} s, "
              f"(d) training in this phase {t_train - t_c:.1f} s, card matrix "
              f"{t_card - t_train:.1f} s, the CPU matrix's wait and the checks "
              f"{time.perf_counter() - t_card:.1f} s", flush=True)
    finally:
        if old_home is None:
            os.environ.pop("KRASIS_TPU_HOME", None)
        else:
            os.environ["KRASIS_TPU_HOME"] = old_home
        shutil.rmtree(home, ignore_errors=True)


MESH_PROMPT = 2048        # (a): the main mesh path's prefill ids
MESH_NEW = 16             # and decode tokens
MESH_PP_SP = 512          # (b): the PP / SP prefill ids
MESH_SCHED_NEW = 8        # (c): tokens a scheduler request
MESH_TOL = 3e-2           # tests/test_parallel.py's rtol and atol


MESH_DEVICE = "cuda"      # a CPU rehearsal at tiny widths sets "cpu"


def mesh_devices(n: int):
    """n devices for a mesh: n distinct cards where the host has them, else
    the first card n times (every line of the sharded path on one card)."""
    import torch

    if MESH_DEVICE == "cpu":
        return ["cpu"] * n
    return ([f"cuda:{i}" for i in range(n)] if torch.cuda.device_count() >= n
            else ["cuda:0"] * n)


def logits_close(label, got, want, tol=MESH_TOL):
    """Sharded logits against unsharded: |Δ| ≤ tol + tol·|want| element by
    element (numpy's assert_allclose at rtol = atol = tol) and the same
    argmax. Returns max|Δ|."""
    import torch

    got, want = got.float(), want.float().to(got.device)
    diff = (got - want).abs()
    worst = float((diff / (tol + tol * want.abs())).max())
    same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    print(f"[mesh] {label}: max|Δ| {float(diff.max()):.4g} against max|logit| "
          f"{float(want.abs().max()):.4g}, {worst:.3g} of the limit (rtol = atol = {tol}); "
          f"argmax {'equal' if same else 'differs'}", flush=True)
    if not (worst <= 1.0 and same):
        raise AssertionError(f"{label}: sharded logits are not the unsharded ones")
    return float(diff.max())


def mesh_forced(eng, meng, prompt, toks):
    """The mesh engine's stream `toks` teacher-forced through the mesh decode
    and the unsharded one from one state: after each step the mesh cache's
    rows (each layer's first head shard's latent cache: the whole cache on
    its device) are copied over the unsharded cache. The unsharded path
    runs the phase 4 weights with the folded shared-expert rows left out
    (views), so its decode computes the shared experts densely as the mesh
    does; the folded engine's logprob is read beside it. Per step: (mesh
    token, its logprob, top-two gap), (unsharded token, logprob, gap), the
    folded logprob, and how many MoE layers picked other experts."""
    import torch
    from krasis_tpu_torch.models import model as M
    from krasis_tpu_torch.parallel.mesh import strip_virtual

    cfg, quant = eng.cfg, eng.quant
    E = cfg.n_routed_experts
    dense = {**eng.params, "layers": [{k: (strip_virtual(v, E) if k in ("w13", "w2") else v)
                                       for k, v in lp.items()} for lp in eng.params["layers"]]}
    picks = []
    real = M.compute_routing

    def recorded(*a, **kw):
        out = real(*a, **kw)
        picks.append(out.topk_idx[:1].sort(dim=-1).values)
        return out

    def read(logits, tok):
        lsm = torch.log_softmax(logits[0].float(), -1)
        top = torch.topk(lsm, 2)
        return torch.stack([top.indices[0].double(), lsm[tok].double(),
                            (top.values[0] - top.values[1]).double()])

    L = meng._cache_len
    one = torch.ones((1,), dtype=torch.int32, device=eng.device)
    rows = []
    M.compute_routing = recorded
    try:
        with torch.inference_mode():
            eng.reset(L)
            meng.reset(L)
            meng._prefill_prompt(prompt)
            for s in range(1, len(toks)):
                cur = torch.tensor([[toks[s - 1]]], device=eng.device)
                base = meng.cache["length"].clone()
                picks.clear()
                m = read(M.forward(meng.params, cur, one, meng.cache, cfg, quant, prefill=False),
                         toks[s])
                pm = list(picks)
                out = []
                for params in (dense, eng.params):
                    # the step's state: the mesh cache (each layer's first head
                    # shard holds its device's whole latent cache) before it
                    for dst, lc in zip(eng.cache["layers"], meng.cache["layers"]):
                        src = lc["shards"][0] if "shards" in lc else lc
                        for name, buf in dst.items():
                            buf.copy_(src[name])
                    eng.cache["length"].copy_(base)
                    picks.clear()
                    out.append(read(M.forward(params, cur, one, eng.cache, cfg, quant,
                                              prefill=False), toks[s]))
                    if params is dense:
                        flips = sum(bool((a != b).any()) for a, b in zip(pm, picks))
                rows.append((torch.cat([m, out[0], out[1][1:2]]), flips))
    finally:
        M.compute_routing = real
    return [dict(zip(("mesh_tok", "mesh_lp", "mesh_gap", "tok", "lp", "gap", "folded_lp"),
                     r.tolist()), flips=flips) for r, flips in rows]


def hold_mesh_forced(label, toks, lps, steps):
    """The mesh path gives the stream's tokens and logprobs (it is the mesh
    engine's own decode); on steps where every MoE layer picked the same
    experts, the unsharded logprob of the stream's token is within
    FORCED_LP_TOL of the mesh's (median FORCED_LP_MEDIAN) and its greedy
    token the stream's unless its top-two gap is under twice that, as the
    batch phase holds its streams."""
    import statistics

    held, flipped = [], []
    for s, st in enumerate(steps, start=1):
        if int(st["mesh_tok"]) != toks[s] or not abs(st["mesh_lp"] - lps[s]) <= STREAM_LP_TOL:
            raise AssertionError(f"{label}: step {s}: the mesh forward gives token "
                                 f"{int(st['mesh_tok'])} ({toks[s]}), logprob "
                                 f"{st['mesh_lp']:.5f} ({lps[s]:.5f})")
        if st["flips"]:
            flipped.append((s, st["flips"]))
            continue
        held.append(abs(st["lp"] - st["mesh_lp"]))
        if ((int(st["tok"]) != toks[s] and not st["gap"] < 2 * FORCED_LP_TOL)
                or not held[-1] <= FORCED_LP_TOL):
            raise AssertionError(f"{label}: step {s}, same experts in every layer: unsharded "
                                 f"token {int(st['tok'])} (gap {st['gap']:.4f}), logprob "
                                 f"{st['lp']:.5f} against the mesh's {st['mesh_lp']:.5f}")
    med = statistics.median(held) if held else 0.0
    folded = max(abs(st["folded_lp"] - st["mesh_lp"]) for st in steps)
    print(f"[mesh] {label}: {len(steps)} steps forced, {len(held)} held (same experts in "
          f"every MoE layer): unsharded logprob within {max(held, default=0.0):.4g} of the "
          f"mesh's (median {med:.4g}); other picks at {flipped}; the folded engine's logprob "
          f"within {folded:.4g} (its shared experts run through the routed kernel)",
          flush=True)
    if not held or not med <= FORCED_LP_MEDIAN:
        raise AssertionError(f"{label}: median held logprob difference {med:.4g}")


def sp_forced(eng, cfg, smesh, ids, want, label):
    """SP (or SP x EP) prefill against the unsharded one, layer-forced: each
    layer of both runs from the unsharded run's input, so a layer's
    difference is that layer's. SP runs its MLP products at half the rows,
    where cuBLAS takes other algorithms (the router's f32 product, the
    shared experts' and the dense MLP's dequantized products), so the
    random model's router near-ties pick other experts at some positions:
    a position is held where every MoE layer picked the same experts for
    it, its layer outputs within MESH_TOL · (|want| + rms(want)) of the
    unsharded layer's. The whole SP prefill's last-position logits are
    then held within the limit of ``logits_close`` where that position
    picked the same experts in every layer of the two whole runs, and read
    beside it otherwise."""
    import torch
    from krasis_tpu_torch.models import model as M
    from krasis_tpu_torch.models.params import layer_specs
    from krasis_tpu_torch.parallel.sp import make_sp_prefill_fns, sp_shard_params
    from krasis_tpu_torch.runtime.kv_cache import init_cache

    q, dev = eng.quant, eng.device
    sp_params = sp_shard_params(eng.params, cfg, smesh)
    picks = []
    real = M.compute_routing

    def recorded(*a, **kw):
        out = real(*a, **kw)
        picks.append(out.topk_idx.sort(dim=-1).values)
        return out

    def one_run(params, cache, fn):
        """fn(params, cache) with each MoE layer's picks of every row."""
        picks.clear()
        out = fn(params, cache)
        # SP routes each row slice on its own: join a layer's slices
        per = len(picks) // max(1, sum(1 for lp in params["layers"] if "gate_w" in lp))
        return out, [torch.cat(picks[i:i + per]) for i in range(0, len(picks), per)]

    S = ids.shape[1]
    sl = torch.full((1,), S, dtype=torch.int32, device=dev)
    M.compute_routing = recorded
    try:
        caches = [init_cache(cfg, q, 1, 1024, dev) for _ in range(2)]
        positions, valid, kv_len, at = [], [], [], []
        steps = []
        for cache in caches:
            p_, v_, k_, a_ = M.step_inputs(cache["length"], sl, S, cache["layers"], True)
            steps.append(M.make_layer_step(cfg, prefill=True, positions=p_, valid=v_, kv_len=k_,
                                           activation="bf16", fresh=True, at=a_))
        x = eng.params["embed"][ids]
        held = flipped_rows = 0
        worst = 0.0
        for i, spec in enumerate(layer_specs(cfg)):
            picks.clear()
            ya = steps[0](x, eng.params["layers"][i], caches[0]["layers"][i], spec, i)
            pa = torch.cat(picks) if picks else None
            picks.clear()
            yb = steps[1](x, sp_params["layers"][i], caches[1]["layers"][i], spec, i)
            pb = torch.cat(picks) if picks else None
            same = (torch.ones(S, dtype=torch.bool, device=dev) if pa is None
                    else (pa == pb).all(dim=-1))
            flipped_rows += int((~same).sum())
            if bool(same.any()):
                _, ratio = max_err(yb[0][same], ya[0][same], MESH_TOL)
                worst = max(worst, ratio)
                held += int(same.sum())
            x = ya
        print(f"[mesh] {label}, layer-forced: {held} (position, layer) pairs held within "
              f"{worst:.3g} of the limit (tol {MESH_TOL}), {flipped_rows} with other experts "
              "picked", flush=True)
        if not held or not worst <= 1.0:
            raise AssertionError(f"{label}: a layer's output left the unsharded layer's")
        sp_prefill, _ = make_sp_prefill_fns(cfg, q, smesh)
        got, sp_picks = one_run(eng.params, init_cache(cfg, q, 1, 1024, dev),
                                lambda p, c: sp_prefill(p, ids, sl, c))
        _, un_picks = one_run(eng.params, init_cache(cfg, q, 1, 1024, dev),
                              lambda p, c: M.forward(p, ids, sl, c, cfg, q, prefill=True))
    finally:
        M.compute_routing = real
    last = sum(bool((a[-1] != b[-1]).any()) for a, b in zip(sp_picks, un_picks))
    if last == 0:
        logits_close(label, got, want)
    else:
        diff = float((got.float() - want.float()).abs().max())
        print(f"[mesh] {label}: the last position picked other experts in {last} MoE layers of "
              f"the whole runs; its logits {diff:.4g} from the unsharded ones (max|logit| "
              f"{float(want.abs().max()):.4g}), argmax "
              f"{'equal' if torch.equal(got.argmax(-1), want.argmax(-1)) else 'differs'}: not held",
              flush=True)


def profile_decode_step(eng, prompt, label):
    """One decode step of `eng` after `prompt`: its wall time (unprofiled)
    and device time, busy share and launches from the profiler."""
    import torch
    from krasis_tpu_torch.timing import recorded_step, traced_kernels
    from torch.profiler import ProfilerActivity, profile, schedule

    one = torch.ones((1,), dtype=torch.int32, device=eng.device)
    with torch.inference_mode():
        eng.reset(eng._cache_len)
        logits = eng._prefill_prompt(prompt)
        cur = logits.argmax(-1)[:, None]
        base = eng.cache["length"].clone()

        def step():
            eng.cache["length"].copy_(base)
            return eng._forward(cur, one, prefill=False)

        step()
        eng._sync()
        t0 = time.perf_counter()
        step()
        eng._sync()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            torch.ones(1, device="cuda").add_(1)
            recorded_step(prof)
            step()
            eng._sync()
            prof.step()
    rows = [(key, us / 1e3, count) for key, us, count in traced_kernels(prof) if us > 0]
    busy, launches = sum(r[1] for r in rows), sum(r[2] for r in rows)
    print(f"[mesh] profile {label}: one decode step, wall {wall:.2f} ms unprofiled, device "
          f"kernels {busy:.2f} ms ({100 * busy / wall:.1f}% busy), {launches} launches",
          flush=True)
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"[mesh]   {ms:8.3f} ms {count:5d}x  {key[:90]}")
    return wall, busy, launches


def mesh_kernel_checks(meng, cfg, results, g, flush):
    """The kernels of the mesh path at the shard shapes, against their plain
    versions: K1 at the shared experts' dense products (decode runs them
    densely under a mesh), K2 at 8 of 16 MLA heads (a 2048-row prefill, and
    decode's split form at R = 8 rows), K3 on shard 0's 32-expert stacks
    with the EP id convention (3 live picks, 3 remote ones at weight 0 on
    the last live id), K4 on those stacks with the pick_valid tile plan.
    Bounds over the live picks alone."""
    import torch
    from krasis_tpu_torch.ops import flash_attention as fa
    from krasis_tpu_torch.ops import moe_cuda
    from krasis_tpu_torch.ops.rope import yarn_softmax_scale
    from krasis_tpu_torch.parallel.ep import local_picks
    from krasis_tpu_torch.quant import qtensor_bytes

    dev = flush.device
    lp = next(lp for lp in meng.params["layers"] if "_ep" in lp)
    qmm_checks(results, "mesh/", (("qmm:shared_w13", lp["shared_w13"], None, torch.bfloat16),
                                  ("qmm:shared_w2", lp["shared_w2"], None, torch.bfloat16)),
               g, flush)
    Hs = len(lp["_heads"])
    L, DR = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    scale = yarn_softmax_scale((cfg.qk_nope_head_dim + DR) ** -0.5, cfg.rope_scaling)
    view = meng._cache_len
    kv = MESH_PROMPT + MESH_NEW
    attention_checks(results, "mesh/", cfg.num_attention_heads // Hs, 1, L + DR, 640, L,
                     False, scale, 1.0, g, flush, cases=[
                         (f"attention:prefill_{MESH_PROMPT}", MESH_PROMPT, 0, MESH_PROMPT,
                          MESH_PROMPT, fa.REPLACES),
                         (f"attention:decode_kv_{kv}", 1, kv - 1, kv, view,
                          fa.REPLACES_DECODE)])
    sh = lp["_ep"][0]
    w13, w2 = sh["w13"], sh["w2"]
    E_l, E, k = w13.q.shape[0], cfg.n_routed_experts, cfg.num_experts_per_tok
    Hd, I = cfg.hidden_size, cfg.moe_intermediate_size
    x = torch.randn((1, Hd), generator=g, device=dev).to(torch.bfloat16)
    mine = torch.randperm(E_l, generator=g, device=dev)[:k // 2]
    other = E_l + torch.randperm(E - E_l, generator=g, device=dev)[:k - k // 2]
    glob = torch.stack([mine, other], 1).reshape(1, -1)        # local and remote interleaved
    gw = torch.rand((1, k), generator=g, device=dev) * 0.3 + 0.05
    ids, wts, valid = local_picks(glob, gw, 0, E_l)
    live = int(valid.sum())
    per_pick = (qtensor_bytes(w13) + qtensor_bytes(w2)) // E_l
    print(f"[kernel] mesh/moe_decode: global picks {glob.tolist()} → shard 0's ids "
          f"{ids.tolist()}, {live} live", flush=True)
    core_checks(results, "mesh/moe_decode_local", counters()["K3"], moe_cuda.K3_KERNELS,
                moe_cuda.REPLACES, lambda w: moe_cuda.moe_w4a8(x, w13, w2, ids, w),
                lambda w: moe_cuda.moe_w4a8_plain(x, w13, w2, ids, w), wts,
                live * per_pick + Hd * 4, 2 * live * (Hd * 2 * I + I * Hd), flush,
                controls=[(wts, [j for j in range(k) if bool(valid[0, j])])])
    T = MESH_PROMPT
    x = torch.randn((T, Hd), generator=g, device=dev).to(torch.bfloat16)
    topk = torch.rand((T, E), generator=g, device=dev).topk(k, dim=-1).indices.to(torch.int32)
    ids, _, valid = local_picks(topk, torch.ones((T, k), device=dev), 0, E_l)
    k4_checks(results, "mesh/", x, ids, w13, w2, cfg, pick_valid=valid)


def mesh_phase(eng, cfg, results, rng):
    """Phase 15: the mesh on phase 4's V2-Lite Q4 weights (see the module
    docstring)."""
    import statistics
    import types

    import torch
    from krasis_tpu_torch import server
    from krasis_tpu_torch.budget import compute_budget
    from krasis_tpu_torch.models.model import forward
    from krasis_tpu_torch.models.params import pattern_info
    from krasis_tpu_torch.ops.sampling import SamplingParams
    from krasis_tpu_torch.parallel.mesh import make_mesh, position_bytes, shard_bytes
    from krasis_tpu_torch.parallel.pp import (make_pp_forward_fns, make_pp_mesh, pp_shard_cache,
                                              pp_shard_params)
    from krasis_tpu_torch.parallel.sp import make_sp_mesh, make_sp_prefill_fns
    from krasis_tpu_torch.runtime.engine import Engine, pick_cache_len
    from krasis_tpu_torch.runtime.kv_cache import init_cache
    from krasis_tpu_torch.runtime.scheduler import BatchScheduler

    t0 = time.perf_counter()
    vocab = cfg.vocab_size
    cards = torch.cuda.device_count()
    mesh = make_mesh(2, devices=mesh_devices(2))
    print(f"[mesh] {cards} card(s) on this host: {mesh}", flush=True)
    before = torch.cuda.memory_allocated() if MESH_DEVICE == "cuda" else 0
    meng = Engine(cfg, eng.quant, eng.params, max_len=eng.max_len, mesh=mesh)
    held = shard_bytes(meng.params)
    more = (torch.cuda.memory_allocated() if MESH_DEVICE == "cuda" else 0) - before
    print(f"[mesh] sharded in {time.perf_counter() - t0:.1f} s, "
          f"{more / 2**20:.1f} MiB more on the card (the caches included); "
          f"held a device {json.dumps({k: round(v / 2**30, 3) for k, v in held.items()})} GiB; "
          f"on cards of their own each shard would hold {position_bytes(meng.params) / 2**30:.3f}"
          f" GiB, budget.py's per-card figure at ep 2 with head-sharded attention "
          f"{compute_budget(cfg, eng.quant).per_chip(2, tp_shard_attention=True) / 2**30:.3f}"
          " GiB", flush=True)
    results_from = len(results)

    # (a) prefill logits, then the main mesh path with the launch counts
    prompt = rng.integers(100, vocab - 100, MESH_PROMPT).tolist()
    L = pick_cache_len(MESH_PROMPT + MESH_NEW + meng.decode_block + 1, eng.max_len)
    with torch.inference_mode():
        eng.reset(L)
        meng.reset(L)
        want = eng._prefill_prompt(prompt)
        got = meng._prefill_prompt(prompt)
    logits_close(f"1 x 2 prefill of {MESH_PROMPT} ids, last position", got, want)
    meng.generate(prompt[:256], max_new_tokens=4, stop_ids={-1})          # warm-up
    zero_counts()
    res = meng.generate(prompt, max_new_tokens=MESH_NEW, stop_ids={-1})
    on_card = eng.device.type == "cuda"     # a CPU rehearsal launches no kernel
    counts, by_form = read_counts(f"mesh 1 x 2 generate({MESH_PROMPT}, {MESH_NEW})",
                                  ("K1", "K2", "K3", "K4") if on_card else (),
                                  ("one-launch", "split") if on_card else ())
    if not res.finite or len(res.tokens) != MESH_NEW:
        raise AssertionError(f"mesh generate: {len(res.tokens)} tokens, finite {res.finite}")
    steps = mesh_forced(eng, meng, prompt, res.tokens)
    hold_mesh_forced("mesh 1 x 2 decode, teacher-forced", res.tokens, res.logprobs, steps)
    if on_card:                            # the kernel checks and profiles
        g = torch.Generator(device="cuda")
        g.manual_seed(4321)
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        mesh_kernel_checks(meng, cfg, results, g, flush)
        del flush
        by_counter = {counters()[name]: n for name, n in counts.items()}
        for counter, entry in results[results_from:]:
            entry["launches"] = (by_form.get(entry["form"], 0) if "form" in entry
                                 else by_counter[counter])
        short = prompt[:40]
        w1, b1, n1 = profile_decode_step(eng, short, "unsharded (phase 4's engine)")
        wm, bm, nm = profile_decode_step(meng, short, "mesh 1 x 2")
        print(f"[mesh] one decode step: mesh {wm:.2f} ms wall / {bm:.2f} ms device / {nm} "
              f"launches against unsharded {w1:.2f} / {b1:.2f} / {n1}: "
              f"{nm / max(n1, 1):.2f}x the launches", flush=True)
    t_a = time.perf_counter()

    # (b) pipeline and sequence parallel prefill against the unsharded one
    dev = eng.device
    ids = torch.tensor([rng.integers(100, vocab - 100, MESH_PP_SP).tolist()], device=dev)
    sl = torch.tensor([MESH_PP_SP], dtype=torch.int32, device=dev)
    q = eng.quant
    with torch.inference_mode():
        want = forward(eng.params, ids, sl, init_cache(cfg, q, 1, 1024, dev), cfg, q,
                       prefill=True)
        pmesh = make_pp_mesh(2, devices=mesh_devices(2))
        prefill_fn, _, _ = make_pp_forward_fns(cfg, q, pmesh)
        got = prefill_fn(pp_shard_params(eng.params, cfg, pmesh), ids, sl,
                         pp_shard_cache(init_cache(cfg, q, 1, 1024, dev), cfg, pmesh))
        reps = pattern_info(cfg).reps
        if not torch.equal(got, want):
            raise AssertionError(f"PP 2: logits {float((got - want).abs().max())} from the "
                                 "unsharded prefill's (the same kernels in the same order)")
        print(f"[mesh] PP 2 ({reps} repetitions, {reps // 2} a stage) prefill of {MESH_PP_SP} "
              "ids: logits equal to the unsharded prefill's bit for bit", flush=True)
        for n, ep in ((2, 1), (4, 2)):
            smesh = make_sp_mesh(n, ep=ep, devices=mesh_devices(n))
            sp_forced(eng, cfg, smesh, ids, want,
                      f"SP {n // ep}{f' x EP {ep}' if ep > 1 else ''} prefill of {MESH_PP_SP} ids")
    t_b = time.perf_counter()

    # (c) the scheduler on a dp 2 x ep 2 mesh: three requests and a cancel
    dmesh = make_mesh(4, dp=2, devices=mesh_devices(4))
    deng = Engine(cfg, q, eng.params, max_len=eng.max_len, mesh=dmesh)
    sch = BatchScheduler(cfg, q, deng.params, max_len=eng.max_len, num_slots=4,
                         decode_block=8, mesh=dmesh)
    prompts = [rng.integers(100, vocab - 100, n).tolist() for n in (40, 300, 40)]
    greedy = SamplingParams(temperature=0.0)
    try:
        victim = sch.submit(rng.integers(100, vocab - 100, 40).tolist(), max_new_tokens=64,
                            sampling=greedy, stop_ids={-1})
        reqs = [sch.submit(p, max_new_tokens=MESH_SCHED_NEW, sampling=greedy, stop_ids={-1},
                           want_logprobs=True) for p in prompts]
        if victim.out_queue.get(timeout=600) is None:
            raise AssertionError("mesh scheduler: the victim ended before its first token")
        victim.cancelled.set()
        tail = 0
        while victim.out_queue.get(timeout=600) is not None:
            tail += 1
        streams = []
        for r in reqs:
            toks = []
            while (tok := r.out_queue.get(timeout=600)) is not None:
                toks.append(tok)
            if r.error is not None or len(toks) != MESH_SCHED_NEW:
                raise AssertionError(f"mesh scheduler: {len(toks)} tokens, error {r.error!r}")
            streams.append((toks, list(r.logprobs)))
    finally:
        sch.shutdown()
    if victim.error is not None or tail >= 63:
        raise AssertionError(f"mesh scheduler: the cancel was ignored ({tail} more tokens)")
    print(f"[mesh] scheduler dp 2 x ep 2 ({dmesh}), 4 slots: three requests of "
          f"+{MESH_SCHED_NEW}, the cancelled one ended {tail} tokens after its first", flush=True)
    held = []
    for p, (toks, lps) in zip(prompts, streams):
        _, fsteps = teacher_forced(deng, p, toks, 4, deng.chunk)
        n, hld, _, row, flipped = hold_teacher_forced(f"mesh scheduler stream of {len(p)} ids",
                                                      toks, lps, fsteps)
        held += hld
        print(f"[mesh] scheduler stream of {len(p)} ids: {n} steps teacher-forced, {len(hld)} "
              f"held within {max(hld, default=0.0):.4g} of the mesh engine's batch-1 decode, "
              f"written cache rows within {row:.3g}; other picks at {flipped}", flush=True)
    med = statistics.median(held) if held else None
    print(f"[mesh] scheduler streams: {len(held)} steps held, median logprob difference "
          f"{med} (limit {FORCED_LP_MEDIAN})", flush=True)
    if med is None or not med <= FORCED_LP_MEDIAN:
        raise AssertionError(f"mesh scheduler streams: median held difference {med}")
    del deng
    t_c = time.perf_counter()

    # (d) a request through the server's handler over the mesh engine; --mesh
    # with more shards than cards refused by the number of devices
    msgs = [{"role": "user", "content": "Shard the experts over two devices."}]
    sids = server.prompt_ids(types.SimpleNamespace(tokenizer=None, engine=meng), msgs)
    direct = meng.generate(sids, max_new_tokens=8, stop_ids={-1})
    httpd = server.start_temp_server(meng, None, "mesh", port=0, backend="python")
    try:
        status, _, body = http_call(httpd.port, "POST", "/v1/chat/completions", {
            "messages": msgs, "max_tokens": 8, "temperature": 0.0, "logprobs": True})
    finally:
        httpd.shutdown()
    obj = json.loads(body) if status == 200 else None
    if obj is None:
        raise AssertionError(f"[mesh] server: {status} {body[:300]!r}")
    lps = [e["logprob"] for e in obj["choices"][0]["logprobs"]["content"]]
    if (obj["usage"]["completion_tokens"] != 8 or len(lps) != 8
            or not all(abs(a - b) <= 1e-6 for a, b in zip(lps, direct.logprobs))):
        raise AssertionError(f"[mesh] served logprobs {lps} against generate's {direct.logprobs}")
    print(f"[mesh] server handler over the 1 x 2 mesh engine: 8 tokens, logprobs within 1e-6 "
          "of generate's (the JSON's 6 decimals)", flush=True)
    if cards < 2 and MESH_DEVICE == "cuda":
        def serve(*a, **kw):                 # a server that got this far was not refused
            raise AssertionError("--mesh 1,2 on a one-card host was not refused")
        real_serve, server.run_server = server.run_server, serve
        try:
            with run_log_dir():
                server.main(["--synthetic", "deepseek-v2-lite", "--mesh", "1,2", "--no-warmup"])
        except ValueError as e:
            if "need 2 devices, have 1" not in str(e):
                raise
            print(f"[mesh] --mesh 1,2 on this one-card host refused: {e}", flush=True)
        finally:
            server.run_server = real_serve
    else:
        print(f"[mesh] --mesh 1,2 refusal not checked: this host has {cards} cards", flush=True)
    del meng
    torch.cuda.empty_cache()
    print(f"[time] mesh phase: (a) {t_a - t0:.1f} s, (b) {t_b - t_a:.1f} s, "
          f"(c) {t_c - t_b:.1f} s, (d) {time.perf_counter() - t_c:.1f} s", flush=True)


# --------------------------------------------------------------------------
# 16. [tooling]: the operator's entry points around the engine and server
# --------------------------------------------------------------------------

TOOLING_TOL = 3e-2        # (e): KrasisTpuMoE against the plain MoE forms
TOOLING_T = (1, 2048)     # (e): rows, one decode step and one prefill chunk
TOOLING_BLOCKS = (8, 16)  # (i): the decode blocks auto_optimise measures
TOOLING_EDGE_LEN = 160    # (h): the contract edges' engine max_len


def subprocess_env(home):
    """The environment of a process this script starts outside the repo:
    the package importable from any working directory, KRASIS_TPU_HOME at
    `home`."""
    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    return {**os.environ, "KRASIS_TPU_HOME": home, "PYTHONPATH": path}


@contextlib.contextmanager
def run_log_dir():
    """server.main in process: its run log (runlog.setup_run_logging) opens
    in the working directory and hooks the root logger and sys.excepthook.
    A temporary working directory inside the block, removed after it, the
    hooks put back: the script leaves no file in the repo."""
    import logging
    import shutil
    import tempfile

    root = logging.getLogger()
    handlers, hook, cwd = list(root.handlers), sys.excepthook, os.getcwd()
    path = tempfile.mkdtemp(prefix="chip_smoke_runlog_")
    os.chdir(path)
    try:
        yield path
    finally:
        os.chdir(cwd)
        for h in root.handlers[:]:
            if h not in handlers:
                root.removeHandler(h)
                h.close()
        sys.excepthook = hook
        shutil.rmtree(path, ignore_errors=True)


def captured(fn, *args, **kw):
    """(fn's result, what it printed)."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args, **kw)
    return res, out.getvalue()


def tooling_checks(cfg):
    """16 (a): cli check names the card and its memory; run_startup_checks
    accepts V2-Lite Q4 and refuses Qwen3-235B at Q4 resident and, with
    offload, against the host's RAM, in the reference's words; cli budget
    runs without --hbm-gb."""
    import torch
    from krasis_tpu_torch import cli, syscheck
    from krasis_tpu_torch.budget import card_memory, format_budget
    from krasis_tpu_torch.config import QuantConfig, preset_config

    rc, out = captured(cli.main, ["check"])
    rep = json.loads(out.split("[syscheck]", 1)[1])
    name, mem = torch.cuda.get_device_name(0), card_memory(0)
    dev = rep["devices"][0]
    if (rc != 0 or rep["backend"] != "cuda" or dev["kind"] != name
            or abs(dev["memory_gb"] - mem / 2**30) > 0.01):
        raise AssertionError(f"[tooling] cli check reported {rep['devices']}, want {name} with "
                             f"{mem / 2**30:.2f} GiB")
    q4 = QuantConfig(expert_bits=4, group_size=128)
    fit = syscheck.run_startup_checks(cfg, q4, verbose=False)
    refusals = []
    for offload, want in ((False, "GiB/chip but HBM is"), (True, "RAM but host has")):
        try:
            syscheck.run_startup_checks(preset_config("qwen3-235b"), q4, verbose=False,
                                        offload=offload)
        except RuntimeError as e:
            if want not in str(e) or "refusing to start" not in str(e):
                raise
            refusals.append(str(e))
        else:
            raise AssertionError(f"[tooling] Qwen3-235B Q4 (offload={offload}) was not refused")
    rc, out = captured(cli.main, ["budget", "deepseek-v2-lite"])
    if rc != 0 or out.strip() != format_budget(preset_config("deepseek-v2-lite"),
                                               QuantConfig(expert_bits=4), 1, mem).strip():
        raise AssertionError(f"[tooling] cli budget printed {out!r}")
    print(f"[tooling] (a) cli check: {dev['kind']}, {dev['memory_gb']} GiB; V2-Lite Q4 fits "
          f"({fit['per_chip_gb']} GiB a card, max context {fit['max_context']}); Qwen3-235B Q4 "
          f"refused: {refusals[0]!r}; with offload: {refusals[1]!r}; cli budget without "
          f"--hbm-gb: {out.strip().splitlines()[0]!r}", flush=True)


def fused_moe_check(eng, cfg, g):
    """16 (e): KrasisTpuMoE over one MoE layer's routed experts at T = 1
    (K5) and 2048 (K4), a third of the picks masked with -1, against the
    plain gathered / ragged forms on the same picks (masked: expert 0 at
    weight 0, the reference's clamp-and-zero); forward_routed from the
    layer's gate against the plain form on compute_routing's picks."""
    import torch
    from krasis_tpu_torch.fused_moe import KrasisTpuMoE
    from krasis_tpu_torch.ops.moe import moe_forward_gathered, moe_forward_ragged
    from krasis_tpu_torch.ops.routing import compute_routing

    lp = next(lp for lp in eng.params["layers"] if "w13" in lp)
    layer = KrasisTpuMoE(lp["w13"], lp["w2"], cfg.num_experts_per_tok)
    k, dev = cfg.num_experts_per_tok, lp["gate_w"].device
    lines = []
    zero_counts()
    for T in TOOLING_T:
        plain = moe_forward_gathered if T == 1 else moe_forward_ragged
        x = torch.randn(T, cfg.hidden_size, generator=g, device=dev).to(torch.bfloat16)
        r = compute_routing(x, lp["gate_w"], cfg, lp.get("gate_bias"))
        masked = (torch.arange(T * k, device=dev) % 3 == 0).view(T, k)
        idx = torch.where(masked, -1, r.topk_idx)
        got = layer(x, idx, r.topk_weights)
        want = plain(x, lp["w13"], lp["w2"], torch.where(masked, 0, r.topk_idx),
                     torch.where(masked, 0.0, r.topk_weights.float()))
        err, over = max_err(got, want, TOOLING_TOL)
        routed = layer.forward_routed(x, lp["gate_w"], cfg, lp.get("gate_bias"))
        rerr, rover = max_err(routed, plain(x, lp["w13"], lp["w2"], r.topk_idx,
                                            r.topk_weights), TOOLING_TOL)
        if over > 1 or rover > 1:
            raise AssertionError(f"[tooling] KrasisTpuMoE at T = {T}: masked {err:.3g} "
                                 f"({over:.2f} of the limit), routed {rerr:.3g} ({rover:.2f})")
        lines.append(f"T = {T}: masked max|d| {err:.3g} ({over:.2f} of the limit), "
                     f"forward_routed {rerr:.3g} ({rover:.2f})")
    counts, _ = read_counts("[tooling] KrasisTpuMoE", ("K4", "K5"))
    print(f"[tooling] (e) KrasisTpuMoE on a layer's {cfg.n_routed_experts} routed experts (a "
          f"stack of {lp['w13'].q.shape[0]}, the shared folded in) top-{k}, a third of the picks "
          f"masked: {'; '.join(lines)}; K5 {counts['K5']}, K4 {counts['K4']} launches, no plain "
          "route", flush=True)


# 16 (f): the kernels the trace must name, by their kernel records' names
TRACE_KERNELS = {
    "K1": lambda n: "qmm_kernel" in n and not is_k5(n) and not is_k6(n),
    "K2 one-launch": lambda n: "attention_kernel" in n,
    "K2 split": lambda n: "combine_kernel" in n,
    "K3": lambda n: "w4a8_stage" in n,
    "K4": lambda n: "gmm_kernel" in n,
}


def trace_check(eng, cfg, rng):
    """16 (f): capture_trace around one 40 + 8 request, its prefill under
    annotate("prefill") and its decode steps under annotate("decode"); the
    trace must name both and K1, K2 (one-launch and split + combine), K3
    and K4."""
    import shutil
    import tempfile

    from krasis_tpu_torch import tracing

    out = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    prefill, forward = eng._prefill_prompt, eng._forward

    def annotated_prefill(*a, **kw):
        with tracing.annotate("prefill"):
            return prefill(*a, **kw)

    def annotated_forward(*a, prefill=False, **kw):
        if prefill:
            return forward(*a, prefill=prefill, **kw)
        with tracing.annotate("decode"):
            return forward(*a, prefill=prefill, **kw)

    prompt = rng.integers(100, cfg.vocab_size - 100, 40).tolist()
    eng._prefill_prompt, eng._forward = annotated_prefill, annotated_forward
    t0 = time.perf_counter()
    try:
        with tracing.capture_trace(out):
            res = eng.generate(prompt, max_new_tokens=8, stop_ids={-1})
            t_run = time.perf_counter()
        t_export = time.perf_counter()
        path = os.path.join(out, tracing.TRACE_NAME)
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        del eng._prefill_prompt, eng._forward
        shutil.rmtree(out, ignore_errors=True)
    names = {e.get("name", "") for e in events}
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    want = {"prefill": "prefill" in names, "decode": "decode" in names}
    want.update({name: any(map(hit, kernels)) for name, hit in TRACE_KERNELS.items()})
    missing = [name for name, hit in want.items() if not hit]
    if missing or len(res.tokens) != 8:
        raise AssertionError(f"[tooling] the trace names no {missing} ({len(kernels)} kernel "
                             f"names, {len(res.tokens)} tokens)")
    print(f"[tooling] (f) capture_trace of 40 + 8: {len(events)} events ({size / 1e6:.1f} MB), "
          f"{len(kernels)} kernel names; it names {', '.join(want)}; the request traced "
          f"{t_run - t0:.1f} s, the export {t_export - t_run:.1f} s, the read "
          f"{time.perf_counter() - t_export:.1f} s", flush=True)


def diag_check(eng, cfg):
    """16 (g): KRASIS_TPU_DIAG's lines for one 8-id prefill: one a layer, in
    the model's layer order, each finite; none with the flag off."""
    import math

    import torch
    from krasis_tpu_torch.models.model import forward
    from krasis_tpu_torch.models.params import layer_specs
    from krasis_tpu_torch.runtime.kv_cache import init_cache
    from krasis_tpu_torch.timing import TIMING

    dev = eng.device
    ids = torch.zeros((1, 128), dtype=torch.int64, device=dev)     # 8 ids in a 128-row chunk
    ids[0, :8] = torch.arange(100, 108)
    n = torch.tensor([8], dtype=torch.int32, device=dev)

    def run():
        with torch.inference_mode():
            forward(eng.params, ids, n, init_cache(cfg, eng.quant, 1, 256, dev), cfg,
                    eng.quant, prefill=True)

    TIMING.diag = True
    try:
        _, out = captured(run)
    finally:
        TIMING.diag = False
    _, off = captured(run)
    lines = [line.split() for line in out.splitlines() if line.startswith("[diag] ")]
    kinds = [spec.attn_kind for spec in layer_specs(cfg)]
    rms = [float(parts[2].split("=")[1]) for parts in lines]
    if ([parts[1] for parts in lines] != kinds or not all(map(math.isfinite, rms))
            or "[diag]" in off):
        raise AssertionError(f"[tooling] diag lines {lines}, want kinds {kinds}; with the "
                             f"flag off: {off[:200]!r}")
    print(f"[tooling] (g) KRASIS_TPU_DIAG: {len(lines)} [diag] lines in layer order, in_rms "
          f"{min(rms):.4f}-{max(rms):.4f}; none with the flag off", flush=True)


def stress_check(eng, cfg):
    """16 (h): the stress battery on phase 4's engine. Held: greedy and
    seeded determinism, finite logprobs at most 0, the stop token, the
    near-max_len room, churn streams that end whole, the cancel. The
    degeneracy verdicts judge trained weights and are printed only."""
    from krasis_tpu_torch import stress_test
    from krasis_tpu_torch.runtime.engine import Engine

    prompts = stress_test.run_stress(eng, None, max_new_tokens=8)
    sweep = stress_test.run_sampling_sweep(eng, None, n_tokens=8)
    edge_eng = Engine(cfg, eng.quant, eng.params, max_len=TOOLING_EDGE_LEN, device=eng.device)
    edges = stress_test.run_contract_edges(edge_eng, None)
    del edge_eng
    churn = stress_test.run_scheduler_churn(cfg, eng.quant, eng.params)
    held = {
        "greedy determinism": sweep["greedy_deterministic"]["ok"],
        "seeded determinism": sweep["seeded_sampling_deterministic"]["ok"],
        "logprobs": not any("bad_logprob" in v["issues"] for v in sweep.values()),
        "stop token": edges.get("stop_token", {}).get("ok", False),
        "near max_len": edges["near_max_len"]["ok"],
        "churn": all(v["n"] == 32 and not any(i.startswith("error") for i in v["issues"])
                     for name, v in churn.items() if name != "req1_cancelled"),
        "cancel": churn["req1_cancelled"]["ok"] and not churn["req1_cancelled"]["issues"]}
    failed = [name for name, ok in held.items() if not ok]
    if failed:
        raise AssertionError(f"[tooling] stress battery: {failed}; sweep {sweep}, edges "
                             f"{edges}, churn {churn}")
    rates = sorted(v["decode_tok_s"] for k, v in prompts.items() if not k.startswith("_"))
    verdicts = {f"{section}.{name}": v["issues"]
                for section, cases in (("prompts", prompts), ("sampling", sweep),
                                       ("contracts", edges), ("scheduler", churn))
                for name, v in cases.items() if isinstance(v, dict) and v.get("issues")}
    print(f"[tooling] (h) stress battery: held {', '.join(held)}; {len(rates)} prompts x 8 "
          f"tokens at {rates[len(rates) // 2]} tok/s median decode ({rates[0]}-{rates[-1]}); "
          f"near-max_len {edges['near_max_len']['n']} tokens, cancelled stream "
          f"{churn['req1_cancelled']['n']} of 32; {card_line()}", flush=True)
    print(f"[stress] degeneracy verdicts (random weights, not held): "
          f"{json.dumps(verdicts) if verdicts else 'none'}", flush=True)


def auto_optimise_check(eng, cfg):
    """16 (i): tune_engine over two decode blocks with KRASIS_TPU_HOME
    temporary; apply_tuning sets the winner on a fresh Engine."""
    import shutil
    import tempfile

    from krasis_tpu_torch import auto_optimise
    from krasis_tpu_torch.runtime.engine import Engine

    home = tempfile.mkdtemp(prefix="chip_smoke_auto_")
    block = eng.decode_block
    try:
        with krasis_home(home):
            res = auto_optimise.tune_engine(eng, blocks=TOOLING_BLOCKS, runs=1, prompt_len=256)
            fresh = Engine(cfg, eng.quant, eng.params, device=eng.device)
            fresh.decode_block = 0
            applied = auto_optimise.apply_tuning(fresh)
        stored = os.listdir(os.path.join(home, auto_optimise.STORE_DIR))
    finally:
        eng.decode_block = block
        shutil.rmtree(home, ignore_errors=True)
    if (not applied or fresh.decode_block != res["best_decode_block"]
            or sorted(res["decode_blocks"]) != sorted(map(str, TOOLING_BLOCKS))):
        raise AssertionError(f"[tooling] auto_optimise {res}; applied {applied}, block "
                             f"{fresh.decode_block}")
    print(f"[tooling] (i) auto_optimise decode tok/s by block {res['decode_blocks']}, winner "
          f"{res['best_decode_block']} (stored as {stored}), set on a fresh engine by "
          f"apply_tuning; {card_line()}", flush=True)


def tooling_phase(eng, cfg, results, rng):
    """Phase 16 in this process, on phase 4's V2-Lite Q4 engine: (a), (e)-(g)
    and (i) of the module docstring. (b)-(d) and (h) run beside phase 9."""
    import torch

    t = [time.perf_counter()]
    g = torch.Generator(device=eng.device)
    g.manual_seed(16)
    for step in (lambda: tooling_checks(cfg), lambda: fused_moe_check(eng, cfg, g),
                 lambda: trace_check(eng, cfg, rng), lambda: diag_check(eng, cfg),
                 lambda: auto_optimise_check(eng, cfg)):
        step()
        t.append(time.perf_counter())
    spans = ", ".join(f"({p}) {b - a:.1f} s" for p, a, b in zip("aefgi", t, t[1:]))
    print(f"[time] tooling phase {t[-1] - t[0]:.1f} s: {spans}", flush=True)


def stress_process():
    """16 (h)'s process: phase 4's engine built again (DeepSeek-V2-Lite Q4 from
    seed 0: the same weights) and the stress battery on it."""
    from krasis_tpu_torch.config import QuantConfig, preset_config
    from krasis_tpu_torch.models.synthetic import build_synthetic_engine

    cfg = preset_config("deepseek-v2-lite")
    stress_check(build_synthetic_engine(cfg, QuantConfig(expert_bits=4, group_size=128),
                                        seed=0), cfg)


def stress_beside():
    """16 (h) beside phase 9, in a process of its own (``stress_process``),
    whose lines are printed here: the battery decodes some 350 tokens on a
    host-bound path, which would hold up this process."""
    import shutil
    import tempfile

    home = tempfile.mkdtemp(prefix="chip_smoke_stress_")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.stress_process()"], cwd=home,
            env=subprocess_env(home), capture_output=True, text=True, timeout=900)
    finally:
        shutil.rmtree(home, ignore_errors=True)
    if proc.returncode != 0:
        raise AssertionError(f"[tooling] the stress battery's process exited "
                             f"{proc.returncode}: {proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    say("\n".join(line for line in proc.stdout.splitlines()
                  if line.startswith(("[tooling]", "[stress]")))
        + f"\n[time] (h) stress battery, a process beside phase 9: "
        f"{time.perf_counter() - t0:.1f} s")


# 16 (b): phase 10 (a)'s V2-Lite servers start through the CLI, in one
# working directory, part of their flags from this config file; the command
# line's --expert-activation overrides the file's
RUN_LOG_CONFIG = ("# phase 10 (a)'s V2-Lite servers, through the CLI\n"
                  "synthetic=deepseek-v2-lite\nexpert-activation=bf16\nserver-backend=native\n")
RUN_LOG_OVERRIDE = ("--expert-activation", "int8")


def cli_serve_command(server_args, run_log):
    """16 (b): ``-m krasis_tpu_torch.cli serve`` for phase 10 (a)'s
    `server_args` (SERVE_SYNTHETIC and more): the model, the expert
    activation and the transport from `run_log`'s config file, the
    activation again on the command line (RUN_LOG_OVERRIDE), the rest of
    `server_args` as they are, the server's note and the RAM watchdog's
    floor. With `run_log["after"]`, waits until the run log of the
    directory begins with that note, so that this start archives that
    server's log."""
    if tuple(server_args[:4]) != SERVE_SYNTHETIC:
        raise ValueError(f"the config file holds {SERVE_SYNTHETIC}, not {server_args[:4]}")
    after = run_log.get("after")
    if after is not None:
        path = os.path.join(run_log["dir"], "krasis_tpu_torch.log")
        deadline = time.perf_counter() + 300
        while True:
            try:
                with open(path) as f:
                    if f.readline().startswith(f"=== RUN NOTE: {after} ==="):
                        break
            except OSError:
                pass
            if time.perf_counter() > deadline:
                raise AssertionError(f"[serve] no run log from the server noted {after!r}")
            time.sleep(0.2)
    return ["-m", "krasis_tpu_torch.cli", "serve", "--config", run_log["config"],
            *RUN_LOG_OVERRIDE, *server_args[4:], "--note", run_log["note"],
            "--min-free-ram-gb", "2"]


def run_log_check(path, notes):
    """16 (b), after both servers ended: the run log in `path` begins with
    the second server's note and holds the config file's values and the
    command line's override; the first server's log, archived under logs/
    by the second start, begins with its note."""
    with open(os.path.join(path, "krasis_tpu_torch.log")) as f:
        text = f.read()
    archived = sorted(os.listdir(os.path.join(path, "logs")))
    first = ""
    if len(archived) == 1 and archived[0].startswith("krasis_tpu_torch_"):
        with open(os.path.join(path, "logs", archived[0])) as f:
            first = f.read()
    lines = text.splitlines()
    config = [line for line in lines if "config file" in line
              and "'expert_activation': 'bf16'" in line and "'server_backend': 'native'" in line]
    args = [line for line in lines if "arguments: " in line
            and "'expert_activation': 'int8'" in line and "'min_free_ram_gb': 2.0" in line]
    if (not text.startswith(f"=== RUN NOTE: {notes[1]} ===") or not config or not args
            or not first.startswith(f"=== RUN NOTE: {notes[0]} ===")):
        raise AssertionError(f"[tooling] run log: {text[:2000]!r}; archived {archived}: "
                             f"{first[:300]!r}")
    say(f"[tooling] (b) cli serve x 2 in one directory: krasis_tpu_torch.log begins with "
        f"{notes[1]!r}, holds the config file's values ({config[0].split(': ', 1)[1][:160]}) "
        f"and the command line's {' '.join(RUN_LOG_OVERRIDE)}; the first server's log archived "
        f"as logs/{archived[0]} ({len(first.splitlines())} lines)")


LAUNCH_SETTINGS = "expert_activation=int8\n"     # (c): config_torch beside the model and port
SUITE_TOML = """[suite]
prefill_lengths = [256]

[[combo]]
name = "tiny"
synthetic = "tiny"
max_len = 1024
"""


def suite_check():
    """16 (d): ``python -m krasis_tpu_torch.suite`` on one combo, the tiny
    Qwen3-MoE on the card, in a temporary directory that is also its
    KRASIS_TPU_HOME: the summary row must have rc 0 and numbers."""
    import shutil
    import tempfile

    d = tempfile.mkdtemp(prefix="chip_smoke_suite_")
    try:
        toml = os.path.join(d, "suite.toml")
        with open(toml, "w") as f:
            f.write(SUITE_TOML)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "krasis_tpu_torch.suite", toml, "--out-dir",
                               os.path.join(d, "out")], cwd=d, env=subprocess_env(d),
                              capture_output=True, text=True, timeout=600)
        rows = [line for line in proc.stdout.splitlines() if line.startswith("| tiny |")]
        cells = [c.strip() for c in rows[0].strip().strip("|").split("|")] if rows else []

        def number(c):
            try:
                return float(c) > 0
            except ValueError:
                return False
        if proc.returncode != 0 or len(cells) != 5 or cells[4] != "0" or not (
                number(cells[1]) and number(cells[2])):
            log = os.path.join(d, "out", "suite_logs", "tiny.log")
            tail = open(log).read()[-3000:] if os.path.exists(log) else ""
            raise AssertionError(f"[tooling] suite: rc {proc.returncode}, rows {rows}; "
                                 f"{proc.stdout[-1500:]}{proc.stderr[-1500:]}{tail}")
        say(f"[tooling] (d) suite, one combo (synthetic tiny on the card): {rows[0]} in "
            f"{time.perf_counter() - t0:.1f} s; {card_line()}")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def launcher_check(model, home):
    """16 (c): ``python -m krasis_tpu_torch.cli launch --non-interactive``
    with KRASIS_TPU_HOME at `home`, whose config_torch names the checkpoint
    at `model`: the launcher starts krasis_tpu_torch.server, which answers
    one chat request; SIGTERM to the launcher stops both, exit 0."""
    import shutil
    import signal
    import tempfile

    port = free_port()
    with open(os.path.join(home, "config_torch"), "w") as f:
        f.write(f"model={model}\nport={port}\n{LAUNCH_SETTINGS}")
    cwd = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    log_path = os.path.join(cwd, "launcher.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "krasis_tpu_torch.cli", "launch", "--non-interactive"],
            stdout=log, stderr=subprocess.STDOUT, env=subprocess_env(home), cwd=cwd,
            start_new_session=True)    # its group: the launcher and the server it starts

    def fail(msg):
        with open(log_path) as f:
            raise AssertionError(f"[tooling] launcher: {msg}; its log:\n{f.read()[-4000:]}")

    try:
        while True:
            if proc.poll() is not None:
                fail(f"exited with {proc.returncode} before its server answered")
            try:
                if http_call(port, "GET", "/health", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            if time.perf_counter() - t0 > 600:
                fail("no /health within 600 s")
            time.sleep(0.5)
        t_up = time.perf_counter() - t0
        status, _, body = http_call(port, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Hello from the launcher."}],
            "max_tokens": 8, "temperature": 0.0})
        usage = json.loads(body).get("usage", {}) if status == 200 else {}
        if not 1 <= usage.get("completion_tokens", 0) <= 8:
            fail(f"the chat request answered {status} {body[:300]!r}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        alive = alive_group(proc.pid)
        with open(log_path) as f:
            launched = [line for line in f.read().splitlines() if line.startswith("launching:")]
        if rc != 0 or alive:
            fail(f"exit {rc} on SIGTERM, a process of its group alive: {alive}")
        if not launched or f"-m krasis_tpu_torch.server --model {model} " not in launched[0]:
            fail(f"it launched {launched}")
        say(f"[tooling] (c) cli launch --non-interactive: {launched[0][len('launching: '):][:200]}"
            f"; up in {t_up:.1f} s, a chat request answered ({usage}), launcher and server "
            f"stopped by SIGTERM, exit 0; {card_line()}")
    finally:
        if proc.poll() is None or alive_group(proc.pid):
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        shutil.rmtree(cwd, ignore_errors=True)


def alive_group(pgid) -> bool:
    try:
        os.killpg(pgid, 0)
        return True
    except ProcessLookupError:
        return False


def beside_error(fn, *args):
    """fn(*args) in a thread beside other work: None, or what it raised."""
    try:
        fn(*args)
    except BaseException as e:             # the caller raises it
        return e
    return None


def in_thread(fn, *args, timeout=900):
    """fn(*args) started in a thread; returns a function that waits for it
    and raises what it raised."""
    import threading

    out = []
    t = threading.Thread(target=lambda: out.append(beside_error(fn, *args)), daemon=True)
    t.start()

    def join():
        t.join(timeout)
        if not out:
            raise AssertionError(f"{fn.__name__} did not end within {timeout} s")
        if out[0] is not None:
            raise out[0]
    return join


# phase 10a's servers and 13 (c)'s: (server arguments, new tokens, log lines
# expected, every request, through the CLI). The default --offload auto must
# keep V2-Lite resident; the last is the offload tier as a user starts it.
# Those through the CLI share a working directory and a config file (16 (b))
SERVE_RUNS = (
    (SERVE_SYNTHETIC, 32, (("--offload auto:", "GiB: resident"),), True, True),
    (SERVE_SYNTHETIC + ("--slots", "4"), 32, (), True, True),
    (SERVE_OFFLOAD, 32, (("--offload experts:", "GB of routed experts in host RAM"),), False,
     False))


def run_phases(results, early, since):
    """Phases 3-16 in order, with phase 9 and the served subprocesses
    together; `early` is quality_prepare's state, `since` main's start."""
    import functools

    import numpy as np
    from krasis_tpu_torch.config import QuantConfig
    from krasis_tpu_torch.ops import moe_cuda

    def mark(what):
        print(f"[time] {time.perf_counter() - since:.1f} s: {what}", flush=True)

    budget_phase()
    mark("references")
    reference_phases()
    hybrid_scheduler_reference()
    spec_reference()
    offload_reference()
    c2_phase()
    c3_phase()

    # 14 (d)'s CPU matrix runs on the host's other cores from here on
    cpu_matrix_start(early)
    rng = np.random.default_rng(0)
    mark("DeepSeek-V2-Lite Q4")
    run_family("DeepSeek-V2-Lite Q4", "deepseek-v2-lite",
               QuantConfig(expert_bits=4, group_size=128), v2lite_kernel_phase,
               ((2048, 32, "int8"), (2500, 32, "int8"), (40, 32, "int8"),
                (2500, 16, "int8", 0, "fp8"), (40, 16, "bf16")),
               ("K1", "K2", "K3", "K4", "K5"), results, rng, profile_decode=8,
               forms=("one-launch", "split", "one-launch+fp8", "split+fp8"),
               batched=batch_phase, spec=spec_phase, offload=offload_phase,
               measure=functools.partial(measure_phase, early=early), mesh=mesh_phase,
               tooling=tooling_phase)
    mark("Qwen3-Coder-Next Q4")
    run_family("Qwen3-Coder-Next Q4, int8 projections", "qwen3-coder-next",
               QuantConfig(expert_bits=4, group_size=128, attention="int8"),
               hybrid_kernel_phase,
               ((2048, 32, "int8"), (2500, 16, "int8"), (40, 16, "int8"), (40, 16, "bf16")),
               ("K1", "K1s", "K2", "K3", "K4", "K5"), results, rng, profile_decode=2,
               profile_bf16=4, spec=hybrid_spec_phase, profile_prefill=1024)

    mark("DeepSeek-V2-Lite Q8")
    run_family("DeepSeek-V2-Lite Q8 (two-stage expert class)", "deepseek-v2-lite",
               QuantConfig(expert_bits=8, group_size=128), q8_kernel_phase,
               ((2048, 128, "int8"), (40, 32, "int8", 5), (40, 16, "bf16")),
               ("K1", "K2", "K6", "K6a", "K7", "K7a"), results, rng, profile_decode=8,
               off_path=("K3", "K4", "K5"), entry_points=q8_entry_points,
               off_names=moe_cuda.K3_KERNELS + moe_cuda.K5_KERNELS)
    gptoss_forms = tuple(f"{form}{tags}+sinks{fp8}" for form in ("one-launch", "split")
                         for tags in ("+window", "") for fp8 in ("", "+fp8"))
    mark("GPT-OSS-20B")
    run_family("GPT-OSS-20B (sliding window 128, sinks, biased experts)", "gpt-oss-20b",
               QuantConfig(expert_bits=4, group_size=32), gptoss_kernel_phase,
               ((2048, 32, "int8"), (2500, 16, "int8"), (40, 16, "int8"),
                (2500, 16, "int8", 0, "fp8"), (40, 16, "int8", 0, ("auto", 131072))),
               ("K1", "K2", "K6", "K7"), results, rng, profile_decode=8,
               off_path=("K1s", "K3", "K4", "K5", "K6a", "K6a product", "K7a"),
               forms=gptoss_forms,
               off_names=moe_cuda.K3_KERNELS + moe_cuda.K5_KERNELS + moe_cuda.K6A_KERNELS,
               prefill_off_names=K6_KERNELS + ("gmm_a8_kernel", moe_cuda.K6A_PRODUCT_KERNEL),
               prefill_on_names=("gmm_kernel",))
    mark("probes")
    probe_phase(results)
    # phase 9 in this process while 10a's and 13 (c)'s servers and 16 (d)'s
    # suite and (h)'s stress battery run beside it
    mark("checkpoints, with the served subprocesses beside them")
    serve_beside(load_phase, beside=(suite_check, stress_beside))
    mark("done")


def main() -> int:
    import shutil
    import tempfile
    import threading

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from krasis_tpu_torch import build, timing
    from krasis_tpu_torch.device import set_exact_matmul_flags

    t_start = time.perf_counter()
    card = card_line()
    set_exact_matmul_flags()
    print(f"[card] {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    # nvcc builds the kernels in a thread while this one trains 14 (d)'s
    # quality checkpoint on the card, which needs none of them
    built = {}

    def nvcc():
        t0 = time.perf_counter()
        try:
            built["logs"] = build.build()
        except BaseException as e:         # raised below, in this thread
            built["error"] = e
        built["s"] = time.perf_counter() - t0

    builder = threading.Thread(target=nvcc)
    builder.start()
    early = {"home": tempfile.mkdtemp(prefix="krasis_measure_")}
    results = []
    try:
        early = quality_prepare(early["home"])
        builder.join()
        if "error" in built:
            raise built["error"]
        logs = built["logs"]
        print(f"[build] {len(logs)} kernels built in {built['s']:.1f} s (the quality "
              "checkpoint trained beside it)", flush=True)
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[ptxas] {name}: {line.strip()}")
        run_phases(results, early, t_start)
    finally:
        builder.join()
        cpu_matrix_stop(early)
        shutil.rmtree(early["home"], ignore_errors=True)

    print(f"[profiler] the tracer kept {timing.head_kept} of the {timing.head_made} throwaway "
          "launches that open its recorded steps")
    print(f"[time] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": [r for _, r in results]}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
