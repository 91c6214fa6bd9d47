"""chip_smoke's tooling phase alone (phase 16), for iterating on it without
the rest of the script: the kernels built, DeepSeek-V2-Lite Q4 at full width
with random weights from seed 0 (phase 4's engine) and
``chip_smoke.tooling_phase`` on it ((a), (e)-(g), (i)); then what the
script runs beside phase 9: phase 10 (a)'s two servers through the CLI with
the run-log checks (b), the launcher on a 3-layer V2-Lite checkpoint written
here (c), the suite (d) and the stress battery's process (h).

    python tools/tooling_phases.py            # on the card
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def launcher_on_a_checkpoint(chip_smoke):
    """16 (c) on the 3-layer V2-Lite checkpoint of phase 9, written into a
    temporary directory that is also the launcher's KRASIS_TPU_HOME."""
    root = tempfile.mkdtemp(prefix="tooling_phases_")
    try:
        path = os.path.join(root, "deepseek-v2-lite")
        chip_smoke.write_checkpoint(path, chip_smoke.V2LITE_CONFIG,
                                    chip_smoke.v2lite_tensors(chip_smoke.V2LITE_CONFIG))
        src = ROOT / chip_smoke.SERVE_TOKENIZER
        for f in os.listdir(src):
            shutil.copy(src / f, path)
        chip_smoke.launcher_check(path, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> None:
    import numpy as np
    import torch

    import chip_smoke
    from krasis_tpu_torch import build
    from krasis_tpu_torch.config import QuantConfig, preset_config
    from krasis_tpu_torch.device import set_exact_matmul_flags
    from krasis_tpu_torch.models.synthetic import build_synthetic_engine

    if not torch.cuda.is_available():
        raise SystemExit("tooling_phases: no CUDA device")
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
    chip_smoke.tooling_phase(eng, cfg, [], rng)
    del eng
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    chip_smoke.serve_beside(lambda: launcher_on_a_checkpoint(chip_smoke),
                            runs=[r for r in chip_smoke.SERVE_RUNS if r[4]],
                            beside=(chip_smoke.suite_check, chip_smoke.stress_beside))
    print(f"[time] (b)-(d) {time.perf_counter() - t1:.1f} s", flush=True)
    print(f"[time] {time.perf_counter() - t0:.1f} s in all", flush=True)


if __name__ == "__main__":
    main()
