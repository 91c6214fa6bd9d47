"""chip_smoke's measurement phase (14) alone, then the full protocols of the
measurement entry points, on the card:

    python tools/measure_phases.py [phase] [k2] [bench] [slots] [quality]   # all by default

``phase``: the kernels built, V2-Lite Q4 at full width with random weights
from seed 0, and ``chip_smoke.measure_phase`` on it. ``k2``: K2's one-launch
form at the last chunk of a 50,000-id prompt (848 rows at q_off 49,152 over
a 65,536-row view) and at q_off 16,384 and 32,768, against its plain version
(chip_smoke's attention check). ``bench``: ``python -m
krasis_tpu_torch.benchmark --synthetic deepseek-v2-lite --network`` (20K /
35K / 50K prefill, decode 5 x 64, both transports). ``slots``: the same with
``--slots-bench 1 4 8 16``. ``quality``: ``python -m krasis_tpu_torch.quality
--steps 600 --seeds 0 --max-tokens 30000``. Each protocol runs as its own
process with ``$KRASIS_TPU_HOME`` in a temporary directory; its output goes
to ``<out>/<name>.log`` (``--out``, default ``build/measure``) and the
quality matrix's JSON and markdown to ``<out>/quality``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PROTOCOLS = {
    "bench": ["-m", "krasis_tpu_torch.benchmark", "--synthetic", "deepseek-v2-lite",
              "--network", "--port", "0"],
    "slots": ["-m", "krasis_tpu_torch.benchmark", "--synthetic", "deepseek-v2-lite",
              "--slots-bench", "1", "4", "8", "16"],
    "quality": ["-m", "krasis_tpu_torch.quality", "--steps", "600", "--seeds", "0",
                "--max-tokens", "30000"],
}
K2_LONG = (("attention:chunk_848_at_49152", 848, 49152, 50000, 65536),
           ("attention:chunk_2048_at_32768", 2048, 32768, 34816, 65536),
           ("attention:chunk_2048_at_16384", 2048, 16384, 18432, 32768))


def phase() -> list:
    import numpy as np
    import torch

    import chip_smoke
    from krasis_tpu_torch.config import QuantConfig, preset_config
    from krasis_tpu_torch.models.synthetic import build_synthetic_engine

    cfg = preset_config("deepseek-v2-lite")
    eng = build_synthetic_engine(cfg, QuantConfig(expert_bits=4, group_size=128), seed=0)
    rng = np.random.default_rng(0)
    eng.generate(rng.integers(100, 1000, 256).tolist(), max_new_tokens=8,
                 stop_ids={-1})                               # warm-up
    results = []
    chip_smoke.measure_phase(eng, cfg, results, rng)
    del eng
    torch.cuda.empty_cache()
    return results


def k2_long() -> list:
    import torch

    import chip_smoke
    from krasis_tpu_torch.config import preset_config
    from krasis_tpu_torch.ops import flash_attention as fa
    from krasis_tpu_torch.ops.rope import yarn_softmax_scale

    cfg = preset_config("deepseek-v2-lite")
    L, DR = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    scale = yarn_softmax_scale((cfg.qk_nope_head_dim + DR) ** -0.5, cfg.rope_scaling)
    g = torch.Generator(device="cuda")
    g.manual_seed(4915)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    results = []
    chip_smoke.attention_checks(results, "measure/", cfg.num_attention_heads, 1, L + DR, 640, L,
                                False, scale, 1.0, g, flush,
                                cases=[c + (fa.REPLACES,) for c in K2_LONG])
    return results


def protocol(name: str, out: Path) -> None:
    home = tempfile.mkdtemp(prefix="krasis_measure_")
    args = list(PROTOCOLS[name])
    if name == "quality":
        args += ["--out", str(out / "quality")]
    env = dict(os.environ, KRASIS_TPU_HOME=home)
    t0 = time.perf_counter()
    log = out / f"{name}.log"
    try:
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, *args], cwd=ROOT, env=env, stdout=f,
                                stderr=subprocess.STDOUT).returncode
    finally:
        shutil.rmtree(home, ignore_errors=True)
    print(f"[{name}] {' '.join(args)}: rc {rc} in {time.perf_counter() - t0:.1f} s; "
          f"output in {log}", flush=True)
    tail = log.read_text(errors="replace")
    print(tail[-6000:], flush=True)
    if rc != 0:
        raise SystemExit(f"measure_phases: {name} failed (rc {rc})")


def main(which, out: Path) -> None:
    import torch

    import chip_smoke
    from krasis_tpu_torch import build
    from krasis_tpu_torch.device import set_exact_matmul_flags

    if not torch.cuda.is_available():
        raise SystemExit("measure_phases: no CUDA device")
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    set_exact_matmul_flags()
    print(chip_smoke.card_line(), flush=True)
    build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    results = []
    if "phase" in which:
        results += phase()
    if "k2" in which:
        results += k2_long()
    print(json.dumps({"kernels": [r for _, r in results]}), flush=True)
    torch.cuda.empty_cache()
    for name in PROTOCOLS:
        if name in which:
            protocol(name, out)
    print(f"[time] {time.perf_counter() - t0:.1f} s in all", flush=True)
    print(chip_smoke.card_line(), flush=True)


if __name__ == "__main__":
    argv = sys.argv[1:]
    out_dir = ROOT / "build" / "measure"
    if "--out" in argv:
        i = argv.index("--out")
        out_dir = Path(argv[i + 1])
        del argv[i:i + 2]
    main(argv or ["phase", "k2", "bench", "slots", "quality"], out_dir)
