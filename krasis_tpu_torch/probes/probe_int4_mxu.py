"""What does the gathered decode-MoE kernel pay for? The H100 counterpart of
``benchmarks/probe_int4_mxu.py``, at V2-Lite's expert shapes (H 2048, I
1408, gs 128, 6 picks of 64, T = 1):

  A. stream floor — P4 (``ops/probes_cuda.stream``): only streams the packed
     expert bytes of the 6 picks and column-sums them: the rate the
     gathered access pattern reaches on this card.
  B. W4A16        — K5 (``moe_cuda.moe_bf16``) at these shapes.
  C. W4A8         — K3 (``moe_cuda.moe_w4a8``) at these shapes.
  D. int4 native  — P5 / P6: int8 x [8, 128] · int4 w [128, 256] through s4
     tensor-core products on the packed nibbles, and through s8 after an
     unpack in registers; P7: the shape of a u8 [128, 256] block seen as
     int4.
  E. unpack forms — P8: one expert's w13 unpacked by mask-xor-sub and by
     shifts, column-summed.

Every launch finds the L2 cache cold (a 256 MB rewrite before it).

    python -m krasis_tpu_torch.probes.probe_int4_mxu [A B C E D]
    python -m krasis_tpu_torch.probes.probe_int4_mxu --device cpu --small
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops import moe_cuda, probes_cuda
from ..quant import pack_int4, quantize
from ..timing import flush_buffer
from ._timing import ITERS, arguments, report, time_on

FULL = {"E": 64, "H": 2048, "I": 1408, "GS": 128, "K_TOP": 6}
SMALL = {"E": 8, "H": 256, "I": 128, "GS": 128, "K_TOP": 3}


def make_inputs(dev: torch.device, small: bool = False) -> dict:
    """Seeded expert stacks quantized from normal weights (std 0.05), one
    token, the picks spread over the stack (expert 3p), equal weights."""
    s = SMALL if small else FULL
    E, H, I, GS, k = s["E"], s["H"], s["I"], s["GS"], s["K_TOP"]
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    w13 = quantize(torch.randn((E, H, 2 * I), generator=g, device=dev) * 0.05, 4, GS)
    w2 = quantize(torch.randn((E, I, H), generator=g, device=dev) * 0.05, 4, GS)
    x0 = torch.randn((1, H), generator=g, device=dev).to(torch.bfloat16)
    idx = (torch.arange(k, device=dev, dtype=torch.int32) * 3 % E)[None]
    wts = torch.full((1, k), 1.0 / k, device=dev)
    return {"shape": s, "w13": w13, "w2": w2, "x0": x0, "idx": idx, "wts": wts,
            # section D's operands, all ones as in the TPU probe
            "x_ones": torch.ones((8, 128), dtype=torch.int8, device=dev),
            "q_ones": pack_int4(torch.ones((128, 256), dtype=torch.int8, device=dev)),
            "u8": torch.zeros((128, 256), dtype=torch.uint8, device=dev)}


def pick_bytes(inp: dict) -> tuple:
    """(packed bytes of one pick, with its bf16 scales) — what the stream
    and the expert kernels read a pick."""
    w13, w2 = inp["w13"], inp["w2"]
    packed = w13.q[0].numel() + w2.q[0].numel()
    return packed, packed + 2 * (w13.scales[0].numel() + w2.scales[0].numel())


def run(inp: dict, sections=("A", "B", "C", "E", "D"), iters: int = ITERS,
        device_time: bool = True) -> dict:
    """The sections' results; device_time adds each kernel's device us a
    call from the profiler (rates are over the device time when taken)."""
    w13, w2, x0, idx, wts = (inp[k] for k in ("w13", "w2", "x0", "idx", "wts"))
    dev = x0.device
    H, k = inp["shape"]["H"], inp["shape"]["K_TOP"]
    flush = flush_buffer(dev)
    packed, with_scales = pick_bytes(inp)
    res = {}

    def timed(key, label, fn, nbytes, kernel):
        ms, us = time_on(dev, fn, n=iters, flush=flush, kernel=kernel if device_time else None)
        res[key + "_ms"], res[key + "_device_us"] = ms, us
        if ms is None:
            print(f"{label:28s} not measured (CPU)", flush=True)
            return
        t = ms if us is None else us / 1e3
        res[key + "_gb_s"] = nbytes / t / 1e6
        device = "" if us is None else f" (device {us:.2f} us)"
        print(f"{label:28s} {ms:8.4f} ms/iter{device}  {nbytes / t / 1e6:7.1f} GB/s", flush=True)

    k3, k5 = moe_cuda.K3_KERNELS, moe_cuda.K5_KERNELS
    if "A" in sections:
        timed("A_stream", "A. stream floor", lambda: probes_cuda.stream(w13.q, w2.q, idx, H),
              k * packed, "colsum_kernel")
    if "B" in sections:
        timed("B_w4a16", "B. W4A16 (K5)", lambda: moe_cuda.moe_bf16(x0, w13, w2, idx, wts),
              k * with_scales, k5)
    if "C" in sections:
        timed("C_w4a8", "C. W4A8 (K3)", lambda: moe_cuda.moe_w4a8(x0, w13, w2, idx, wts),
              k * with_scales, k3)
    if "E" in sections:
        eb = w13.q[0].numel()
        print(f"== E. unpack-only (one expert w13, {eb / 1e6:.2f} MB) ==", flush=True)
        for mode, label in (("maskxor", "E. unpack mask-xor-sub"), ("shift", "E. unpack shl/sar")):
            timed(f"E_unpack_{mode}", label,
                  lambda m=mode: probes_cuda.unpack_colsum(w13.q[0], m), eb, "colsum_kernel")
    if "D" in sections:
        print("== D. native int4 support ==", flush=True)
        for key, label, fn in (
                ("D_int4_native", "s4 x s4 tensor-core dot (int4 operands as they lie)",
                 probes_cuda.int4_dot_native),
                ("D_int4_cast", "int4 -> s8 in registers, s8 tensor-core dot",
                 probes_cuda.int4_dot)):
            out = fn(inp["x_ones"], inp["q_ones"])
            res[key] = int(out[0, 0])
            print(f"{label}: OK -> {res[key]}", flush=True)
        shape = probes_cuda.int4_view_shape(inp["u8"])
        res["D_bitcast_shape"] = [int(v) for v in shape[0].tolist()]
        print(f"u8 -> int4 view, result shape: {res['D_bitcast_shape']}", flush=True)
    return res


def main(argv=None) -> None:
    ap = arguments("The gathered decode-MoE probe (P4-P8, K3, K5).")
    ap.add_argument("sections", nargs="*", default=["A", "B", "C", "E", "D"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    inp = make_inputs(dev, small=args.small)
    res = run(inp, [s.upper() for s in args.sections])
    report("probe_int4_mxu", {"shape": inp["shape"], **res}, dev, args.out)


if __name__ == "__main__":
    main()
