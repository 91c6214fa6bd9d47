"""One grouped-GEMM step split into terms: the H100 counterpart of
``benchmarks/probe_gmm_terms.py`` at V2-Lite's w13 shapes (M = 12,288 rows
of T 2048 x k 6 over E 64, K 2048, N 2816, 128-row tiles). Each term is a
compile-time form of K4 / K7's own kernel (``gmm_cuda.gmm_probe``) that
streams the same bytes through the same ring:

  copy        out[r, n] = x[r, n mod tn]             (the ring alone)
  nounpack    x @ the scales broadcast over groups    (ring + product)
  unpackonly  the first 128 rows of the dequantized   (ring + dequantization)
              tile
  full        K7 itself                              (ring + dequantization + product)

for int4 weights, and unpackonly / full for int8 weights. chip_smoke.py
times the ``grouped_mm`` product at the same plan beside them.

    python -m krasis_tpu_torch.probes.probe_gmm_terms
    python -m krasis_tpu_torch.probes.probe_gmm_terms --device cpu --small
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops import gmm_cuda
from ..quant import random_qtensor
from ._timing import ITERS, arguments, report, time_on
from .probe_unpack_variants import shape

TM = 128
MODES = (("w4", ("copy", "nounpack", "unpackonly", "full")), ("w8", ("unpackonly", "full")))


def make_inputs(dev: torch.device, small: bool = False) -> dict:
    """Picks uniform over the stack, the 128-row plan, tile-aligned rows
    with std 0.1, random int4 and int8 w13 stacks."""
    s = shape(small)
    T, H, I, E, k = (s[n] for n in ("T", "H", "I", "E", "K_TOP"))
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    idx = torch.randint(0, E, (T, k), generator=g, device=dev, dtype=torch.int32)
    plan = gmm_cuda.plan_tiles(idx, E, TM)
    x_tiles = (torch.randn((plan.n_tiles * TM, H), generator=g, device=dev) * 0.1
               ).to(torch.bfloat16)
    return {"shape": s, "idx": idx, "plan": plan, "x_tiles": x_tiles,
            "w4": random_qtensor((E, H, 2 * I), 4, 128, g, dev),
            "w8": random_qtensor((E, H, 2 * I), 8, 128, g, dev)}


def run(inp: dict, iters: int = ITERS, device_time: bool = True) -> dict:
    """Each term's ms (device_time adds its device us a call from the
    profiler, under "<key>_device_us")."""
    plan, x_tiles = inp["plan"], inp["x_tiles"]
    dev = x_tiles.device
    res = {}
    for bits, modes in MODES:
        w = inp[bits]
        for mode in modes:
            ms, us = time_on(dev, lambda: gmm_cuda.gmm_probe(x_tiles, w, plan, mode), n=iters,
                             kernel="gmm_kernel" if device_time else None)
            res[f"{bits}_{mode}"], res[f"{bits}_{mode}_device_us"] = ms, us
            print(f"int{bits[1]} {mode:10s}: {ms} ms (device {us} us)", flush=True)
    return res


def main(argv=None) -> None:
    args = arguments("One grouped-GEMM step split into terms.").parse_args(argv)
    dev = resolve_device(args.device)
    inp = make_inputs(dev, small=args.small)
    report("probe_gmm_terms", {"shape": inp["shape"], **run(inp)}, dev, args.out)


if __name__ == "__main__":
    main()
