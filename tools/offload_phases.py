"""chip_smoke's offload-tier phases alone (phase 13), for iterating on them
without the rest of the script: the kernels built, then the budget line
(``budget``), the tiny references (``ref``), V2-Lite Q4 at full width with
random weights from seed 0 (``v2``: ``chip_smoke.offload_phase``) and the
offloaded server as a subprocess (``serve``); prints the phases' lines and
their kernel entries.

    python tools/offload_phases.py [budget] [ref] [v2] [serve]    # on the card; all by default
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(which) -> None:
    import numpy as np
    import torch

    import chip_smoke
    from krasis_tpu_torch import build
    from krasis_tpu_torch.config import QuantConfig, preset_config
    from krasis_tpu_torch.device import set_exact_matmul_flags
    from krasis_tpu_torch.models.synthetic import build_synthetic_engine

    if not torch.cuda.is_available():
        raise SystemExit("offload_phases: no CUDA device")
    t0 = time.perf_counter()
    set_exact_matmul_flags()
    print(chip_smoke.card_line(), flush=True)
    build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    if "budget" in which:
        chip_smoke.budget_phase()
    if "ref" in which:
        chip_smoke.offload_reference()
    results = []
    if "v2" in which:
        cfg = preset_config("deepseek-v2-lite")
        eng = build_synthetic_engine(cfg, QuantConfig(expert_bits=4, group_size=128), seed=0)
        rng = np.random.default_rng(0)
        eng.generate(rng.integers(100, 1000, 256).tolist(), max_new_tokens=8,
                     stop_ids={-1})                               # warm-up
        chip_smoke.offload_phase(eng, cfg, results, rng)
        del eng
        torch.cuda.empty_cache()
    if "serve" in which:
        chip_smoke.serve_subprocess_phase(
            chip_smoke.SERVE_OFFLOAD, 32,
            (("--offload experts:", "GB of routed experts in host RAM"),), every_request=False)
    print(json.dumps({"kernels": [r for _, r in results]}))
    print(f"[time] {time.perf_counter() - t0:.1f} s in all", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["budget", "ref", "v2", "serve"])
