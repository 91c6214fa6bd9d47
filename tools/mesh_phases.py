"""chip_smoke's mesh phase alone (phase 15), for iterating on it without the
rest of the script: the kernels built, then DeepSeek-V2-Lite Q4 at full
width with random weights from seed 0 (phase 4's engine) and
``chip_smoke.mesh_phase`` on it; prints the phase's lines and its kernel
entries.

    python tools/mesh_phases.py            # on the card
"""

from __future__ import annotations

import json
import sys
import time
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
        raise SystemExit("mesh_phases: no CUDA device")
    t0 = time.perf_counter()
    set_exact_matmul_flags()
    print(chip_smoke.card_line(), flush=True)
    build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = preset_config("deepseek-v2-lite")
    eng = build_synthetic_engine(cfg, QuantConfig(expert_bits=4, group_size=128), seed=0)
    rng = np.random.default_rng(0)
    eng.generate(rng.integers(100, 1000, 256).tolist(), max_new_tokens=8,
                 stop_ids={-1})                               # warm-up
    results = []
    t1 = time.perf_counter()
    chip_smoke.mesh_phase(eng, cfg, results, rng)
    print(f"[time] mesh phase {time.perf_counter() - t1:.1f} s", flush=True)
    print(json.dumps({"kernels": [r for _, r in results]}))
    print(f"[time] {time.perf_counter() - t0:.1f} s in all", flush=True)


if __name__ == "__main__":
    main()
