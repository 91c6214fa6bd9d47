"""The W4A8 gathered decode-MoE kernel against the W4A16 one at eight tokens:
the H100 counterpart of ``benchmarks/probe_w4a8.py``. Its TPU kernel
(``moe_gathered_w4a8``) is the prototype of K3's function, so K3
(``moe_cuda.moe_w4a8``) is timed here, against K5 (``moe_cuda.moe_bf16``),
at V2-Lite's expert shapes with T 8 and 6 picks of 64 (48 picks), and both
are held to the plain gathered reference (``moe.moe_forward_gathered``) by
their largest error over the reference's largest value, as the TPU probe
reports it.

    python -m krasis_tpu_torch.probes.probe_w4a8
    python -m krasis_tpu_torch.probes.probe_w4a8 --device cpu --small
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops import moe_cuda
from ..ops.moe import moe_forward_gathered
from ..quant import quantize
from ..timing import flush_buffer
from ._timing import ITERS, arguments, report, time_on

REPLACES = "benchmarks/probe_w4a8.py:150"   # its pallas_call; K3 is the port's kernel
FULL = {"E": 64, "H": 2048, "I": 1408, "GS": 128, "T": 8, "K_TOP": 6}
SMALL = {"E": 8, "H": 256, "I": 128, "GS": 128, "T": 4, "K_TOP": 3}


def make_inputs(dev: torch.device, small: bool = False) -> dict:
    """Seeded stacks quantized from normal weights (std 0.05), x with std
    0.5, picks uniform over the stack (repeats allowed), weights uniform in
    [0, 1/k)."""
    s = SMALL if small else FULL
    E, H, I, GS, T, k = (s[n] for n in ("E", "H", "I", "GS", "T", "K_TOP"))
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    w13 = quantize(torch.randn((E, H, 2 * I), generator=g, device=dev) * 0.05, 4, GS)
    w2 = quantize(torch.randn((E, I, H), generator=g, device=dev) * 0.05, 4, GS)
    x = (torch.randn((T, H), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    idx = torch.randint(0, E, (T, k), generator=g, device=dev, dtype=torch.int32)
    wts = torch.rand((T, k), generator=g, device=dev) / k
    return {"shape": s, "w13": w13, "w2": w2, "x": x, "idx": idx, "wts": wts}


def relerr(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.to(torch.float32), b.to(torch.float32)
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def run(inp: dict, iters: int = ITERS, device_time: bool = True) -> dict:
    """The relative errors and both kernels' times; device_time adds their
    device us a call from the profiler."""
    w13, w2, x, idx, wts = (inp[k] for k in ("w13", "w2", "x", "idx", "wts"))
    dev = x.device
    ref = moe_forward_gathered(x, w13, w2, idx, wts)
    base = moe_cuda.moe_bf16(x, w13, w2, idx, wts)
    got = moe_cuda.moe_w4a8(x, w13, w2, idx, wts)
    res = {"relerr_base_vs_ref": relerr(base, ref), "relerr_w4a8_vs_ref": relerr(got, ref),
           "distinct_experts": int(torch.unique(idx).numel())}
    print(f"relerr base vs ref : {res['relerr_base_vs_ref']}", flush=True)
    print(f"relerr w4a8 vs ref : {res['relerr_w4a8_vs_ref']}", flush=True)
    flush = flush_buffer(dev)
    tb, ub = time_on(dev, lambda: moe_cuda.moe_bf16(x, w13, w2, idx, wts), n=iters, flush=flush,
                     kernel=moe_cuda.K5_KERNELS if device_time else None)
    tw, uw = time_on(dev, lambda: moe_cuda.moe_w4a8(x, w13, w2, idx, wts), n=iters, flush=flush,
                     kernel=moe_cuda.K3_KERNELS if device_time else None)
    res.update(w4a16_ms=tb, w4a8_ms=tw, w4a16_device_us=ub, w4a8_device_us=uw)
    if tb is None:
        print("kernel times not measured (CPU)", flush=True)
    else:
        print(f"baseline W4A16 kernel: {tb:.4f} ms (device {ub} us)", flush=True)
        print(f"W4A8 kernel:           {tw:.4f} ms (device {uw} us)  "
              f"({(tb / tw - 1) * 100:+.1f}%)", flush=True)
    return res


def main(argv=None) -> None:
    args = arguments("K3 (W4A8) against K5 (W4A16) at T 8, 6 picks of 64.").parse_args(argv)
    dev = resolve_device(args.device)
    inp = make_inputs(dev, small=args.small)
    report("probe_w4a8", {"shape": inp["shape"], **run(inp)}, dev, args.out)


if __name__ == "__main__":
    main()
