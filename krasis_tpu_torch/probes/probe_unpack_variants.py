"""The grouped GEMM's unpack form and tile height: the H100 counterpart of
``benchmarks/probe_unpack_variants.py`` at V2-Lite's w13 shapes (T 2048,
k 6, E 64, H 2048, I 1408, int4 gs 128).

1. At 128-, 256- and 512-row tiles, K7 (``gmm_cuda.gmm_two_stage``, the
   base: grouped GEMM over tile-aligned rows to f32) against its "v2" form
   (``gmm_cuda.gmm_probe(mode="v2")``: each nibble sign-extended by two
   shifts and converted, then the bf16 scale product), with the largest
   difference between them over the computed tiles' rows.
2. The whole V2-Lite Q4 MoE layer per tile height through
   ``moe_prefill(tile_rows=tm)``: K4 + K4 and the f32 combine.

    python -m krasis_tpu_torch.probes.probe_unpack_variants
    python -m krasis_tpu_torch.probes.probe_unpack_variants --device cpu --small
"""

from __future__ import annotations

import torch

from ..config import preset_config
from ..device import resolve_device
from ..ops import gmm_cuda
from ..quant import random_qtensor
from ._timing import ITERS, arguments, report, time_on

TILE_ROWS = (128, 256, 512)
LAYER_CALLS = 10        # calls of the whole layer timed, their median kept


def shape(small: bool) -> dict:
    if small:
        return {"T": 64, "H": 256, "I": 128, "E": 4, "K_TOP": 2}
    cfg = preset_config("deepseek-v2-lite")
    return {"T": 2048, "H": cfg.hidden_size, "I": cfg.moe_intermediate_size,
            "E": cfg.n_routed_experts, "K_TOP": cfg.num_experts_per_tok}


def make_inputs(dev: torch.device, small: bool = False) -> dict:
    """Random quantized stacks (uniform bytes, scales 0.02·[0.5, 1.5)), picks
    uniform over the stack, x with std 0.1, softmax pick weights."""
    s = shape(small)
    T, H, I, E, k = (s[n] for n in ("T", "H", "I", "E", "K_TOP"))
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    return {"shape": s,
            "w13": random_qtensor((E, H, 2 * I), 4, 128, g, dev),
            "w2": random_qtensor((E, I, H), 4, 128, g, dev),
            "idx": torch.randint(0, E, (T, k), generator=g, device=dev, dtype=torch.int32),
            "x": (torch.randn((T, H), generator=g, device=dev) * 0.1).to(torch.bfloat16),
            "wts": torch.softmax(torch.randn((T, k), generator=g, device=dev), dim=-1),
            "gen": g}


def tile_inputs(inp: dict, tm: int):
    """The plan at tm rows and tile-aligned rows x_tiles [Mp, H] (std 0.1)."""
    plan = gmm_cuda.plan_tiles(inp["idx"], inp["shape"]["E"], tm)
    x_tiles = (torch.randn((plan.n_tiles * tm, inp["shape"]["H"]), generator=inp["gen"],
                           device=inp["idx"].device) * 0.1).to(torch.bfloat16)
    return plan, x_tiles


def run(inp: dict, iters: int = ITERS, device_time: bool = True) -> dict:
    """Per tile height, K7 and v2 over `iters` calls (device_time adds
    their device us a call from the profiler), then the MoE layer (the
    median of LAYER_CALLS calls by events)."""
    w13, w2, idx, x, wts = (inp[k] for k in ("w13", "w2", "idx", "x", "wts"))
    dev = x.device
    s = inp["shape"]
    kernel = "gmm_kernel" if device_time else None
    res = {}
    for tm in TILE_ROWS:
        plan, x_tiles = tile_inputs(inp, tm)
        base, base_us = time_on(dev, lambda: gmm_cuda.gmm_two_stage(x_tiles, None, w13, plan),
                                n=iters, kernel=kernel)
        v2, v2_us = time_on(dev, lambda: gmm_cuda.gmm_probe(x_tiles, w13, plan, "v2"), n=iters,
                            kernel=kernel)
        live = plan.tile_valid.to(torch.bool).repeat_interleave(tm)
        a = gmm_cuda.gmm_two_stage(x_tiles, None, w13, plan)[live]
        b = gmm_cuda.gmm_probe(x_tiles, w13, plan, "v2")[live]
        nvalid = int(plan.tile_valid.sum())
        res[f"gmm_w13_tm{tm}"] = {"base_ms": base, "v2_ms": v2, "base_device_us": base_us,
                                  "v2_device_us": v2_us, "n_tiles": plan.n_tiles,
                                  "valid_tiles": nvalid,
                                  "max_abs_err": float((a - b).abs().max())}
        print(f"tm={tm}: base {base} ms ({base_us} us), v2 {v2} ms ({v2_us} us), valid "
              f"{nvalid}/{plan.n_tiles}, err {res[f'gmm_w13_tm{tm}']['max_abs_err']:.3e}",
              flush=True)
    flops = 2 * s["T"] * s["K_TOP"] * (s["H"] * 2 * s["I"] + s["I"] * s["H"])
    for tm in TILE_ROWS:
        ms, _ = time_on(dev, lambda: gmm_cuda.moe_prefill(x, w13, w2, idx, wts, tile_rows=tm),
                        n=LAYER_CALLS)
        res[f"moe_layer_tm{tm}"] = {"ms": ms, "gf_s": None if ms is None else flops / ms / 1e6}
        print(f"moe layer tm={tm}: {ms} ms", flush=True)
    return res


def main(argv=None) -> None:
    args = arguments("K7 against its shift-unpack form, and the MoE layer, "
                     "at 128-, 256- and 512-row tiles.").parse_args(argv)
    dev = resolve_device(args.device)
    inp = make_inputs(dev, small=args.small)
    report("probe_unpack_variants", {"shape": inp["shape"], **run(inp)}, dev,
           args.out)


if __name__ == "__main__":
    main()
