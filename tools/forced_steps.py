"""The readings chip_smoke's teacher-forced limits come from: its batch phase
alone on V2-Lite Q4 at full width (random weights from seed 0), with
``FORCED_LP_TOL``, ``FORCED_LP_MEDIAN`` and ``FORCED_ROW_TOL`` lifted, every
step of every scheduler stream written to ``chiprun_out/forced_steps.json``
(slots, prompt length, the batch-1 side's expert activation, and per step
each path's token, top two and stream-token logprobs, the vocabulary
difference, the MoE layers with other picks and the written-row
difference), and a summary of the held steps printed at the end.

    python tools/forced_steps.py        # on the card, about 4 minutes
"""

from __future__ import annotations

import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    import numpy as np
    import torch

    import chip_smoke
    from krasis_tpu_torch import build
    from krasis_tpu_torch.config import QuantConfig, preset_config
    from krasis_tpu_torch.device import set_exact_matmul_flags
    from krasis_tpu_torch.models.synthetic import build_synthetic_engine

    if not torch.cuda.is_available():
        raise SystemExit("forced_steps: no CUDA device")
    out = ROOT / "chiprun_out"
    os.makedirs(out, exist_ok=True)
    build.build()
    set_exact_matmul_flags()
    cfg = preset_config("deepseek-v2-lite")
    eng = build_synthetic_engine(cfg, QuantConfig(expert_bits=4, group_size=128), seed=0)
    runs = []
    forced = chip_smoke.teacher_forced

    def recorded(eng, prompt, toks, slots, chunk):
        act, steps = forced(eng, prompt, toks, slots, chunk)
        runs.append({"slots": slots, "prompt": len(prompt), "activation": act, "steps": steps})
        return act, steps

    chip_smoke.teacher_forced = recorded
    chip_smoke.FORCED_LP_TOL = chip_smoke.FORCED_LP_MEDIAN = chip_smoke.FORCED_ROW_TOL = 1e9
    chip_smoke.batch_phase(eng, cfg, [], np.random.default_rng(0))
    with open(out / "forced_steps.json", "w") as f:
        json.dump(runs, f)
    for slots in sorted({r["slots"] for r in runs}):
        steps = [st for r in runs if r["slots"] == slots for st in r["steps"][1:]]
        held = [st for st in steps if not st["flips"]]
        lp = [abs(st["narrow"][3] - st["wide"][3]) for st in held]
        row = [st["row_diff"] for st in held]
        print(json.dumps({"tool": "forced_steps", "slots": slots, "steps": len(steps),
                          "held": len(held), "lp_median": statistics.median(lp),
                          "lp_max": max(lp), "row_median": statistics.median(row),
                          "row_max": max(row), "card": chip_smoke.card_line()}))


if __name__ == "__main__":
    main()
