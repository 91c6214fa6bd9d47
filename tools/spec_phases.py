"""chip_smoke's speculative-decoding phases alone (phase 12), for iterating
on them without the rest of the script: the kernels built, then the tiny
references (``ref``), V2-Lite Q4 at full width with its synthetic MTP
module (``v2``: ``chip_smoke.spec_phase``) and Qwen3-Coder-Next Q4 with
int8 projections (``qcn``: ``chip_smoke.hybrid_spec_phase``), random
weights from seed 0; prints the phases' lines and their kernel entries.

    python tools/spec_phases.py [ref] [v2] [qcn]    # on the card; all three by default
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
        raise SystemExit("spec_phases: no CUDA device")
    t0 = time.perf_counter()
    set_exact_matmul_flags()
    print(chip_smoke.card_line(), flush=True)
    build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    if "ref" in which:
        chip_smoke.spec_reference()
    rng = np.random.default_rng(0)
    results = []
    for name, preset, quant, phase in (
            ("v2", "deepseek-v2-lite", QuantConfig(expert_bits=4, group_size=128),
             chip_smoke.spec_phase),
            ("qcn", "qwen3-coder-next", QuantConfig(expert_bits=4, group_size=128,
                                                    attention="int8"),
             chip_smoke.hybrid_spec_phase)):
        if name not in which:
            continue
        cfg = preset_config(preset)
        eng = build_synthetic_engine(cfg, quant, seed=0)
        eng.generate(rng.integers(100, 1000, 256).tolist(), max_new_tokens=8,
                     stop_ids={-1})                               # warm-up
        phase(eng, cfg, results, rng)
        del eng
        torch.cuda.empty_cache()
    print(json.dumps({"kernels": [r for _, r in results]}))
    print(f"[time] {time.perf_counter() - t0:.1f} s in all", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["ref", "v2", "qcn"])
