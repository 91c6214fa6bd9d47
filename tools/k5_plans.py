"""K5 (``moe_cuda.moe_bf16``) under other launch plans than ``plan_k5``'s:
device us a call (``timing.device_per_call``) at the hybrid's and V2-Lite's
T = 1 shapes and the probe's T = 8, for every stage-1 split (1-8 ranks) and
step (64, 128 packed rows) and stage-2 split (2-8) and step (32-128), the
fastest eight and ``plan_k5``'s own.

    python tools/k5_plans.py           # on the card

Random int4 gs-128 stacks from a seed; each plan's result is compared with
the default plan's (the splits add in another order, so a few bf16 last
bits may move).
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# (T, k, H, I, E)
SHAPES = {"hybrid": (1, 11, 2048, 512, 64), "v2lite": (1, 8, 2048, 1408, 66),
          "probe_T8": (8, 6, 2048, 1408, 64)}


def main() -> None:
    import torch
    from krasis_tpu_torch.ops import moe_cuda, qmm_cuda
    from krasis_tpu_torch.quant import random_qtensor
    from krasis_tpu_torch.timing import device_per_call, flush_buffer

    dev = torch.device("cuda")
    flush = flush_buffer(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    report = {"card": card.strip().splitlines()[0]}
    planner = moe_cuda._k5_plan
    try:
        for name, (T, k, H, I, E) in SHAPES.items():
            moe_cuda._k5_plan = planner
            w13 = random_qtensor((E, H, 2 * I), 4, 128, g, dev, scale_mag=0.02)
            w2 = random_qtensor((E, I, H), 4, 128, g, dev, scale_mag=0.02)
            x = torch.randn((T, H), generator=g, device=dev).to(torch.bfloat16)
            idx = torch.rand((T, E), generator=g, device=dev).topk(k, dim=-1).indices
            idx = idx.to(torch.int32)
            wts = torch.rand((T, k), generator=g, device=dev)
            base = moe_cuda.plan_k5(T, k, H, I, 4, 128)
            want = moe_cuda.moe_bf16(x, w13, w2, idx, wts)
            rows2, units1 = I // 2, (H // 2) // base.w13.unit
            rows = []
            for ks1, pk1, ks2, pk2 in itertools.product((1, 2, 4, 8), (64, 128), (2, 4, 8),
                                                        (32, 64, 128)):
                if rows2 % pk2 or ks2 > k * rows2 // pk2 or ks1 > units1:
                    continue
                s1 = base.w13._replace(ks=ks1, pk=pk1, grid=base.w13.grid[:2] + (ks1,))
                s2 = qmm_cuda.Plan(1, pk2, ks2, pk2, (H // 128, T, ks2))
                moe_cuda._k5_plan = lambda *a, _p=moe_cuda.K5Plan(s1, s2, base.smem): _p
                got = moe_cuda.moe_bf16(x, w13, w2, idx, wts)
                us = device_per_call(lambda: moe_cuda.moe_bf16(x, w13, w2, idx, wts),
                                     moe_cuda.K5_KERNELS, flush, calls=10)[0]
                rows.append({"us": us, "w13": [ks1, pk1], "w2": [ks2, pk2],
                             "max_abs_vs_default": float((got.float() - want.float()).abs().max())})
            rows.sort(key=lambda r: r["us"])
            default = next(r for r in rows if r["w13"] == [base.w13.ks, base.w13.pk]
                           and r["w2"] == [base.w2.ks, base.w2.pk])
            report[name] = {"plan_k5": default, "fastest": rows[:8], "plans": len(rows)}
            print(f"[k5_plans] {name}: plan_k5 {default['us']:.2f} us (w13 ks/pk "
                  f"{default['w13']}, w2 {default['w2']}); fastest {rows[0]['us']:.2f} us "
                  f"(w13 {rows[0]['w13']}, w2 {rows[0]['w2']}) of {len(rows)} plans", flush=True)
    finally:
        moe_cuda._k5_plan = planner
    print(json.dumps(report))


if __name__ == "__main__":
    main()
