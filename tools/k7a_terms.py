"""Where K7a's time goes: compile-time variants of its kernel, each without
one part of a step, timed at DeepSeek-V2-Lite Q8's w13 shape (int8 experts)
and V2-Lite Q4's (int4), at 64- and 128-row tiles.

    python tools/k7a_terms.py          # on the card

Each variant is ``krasis_tpu_torch/csrc/gmm.cu`` with one textual switch
(the K4 / K7 entry points left out, so only K7a's instances build), written
to ``build/k7a_terms/`` and built with the port's nvcc flags:

    base      the kernel as it is (checked equal to the built library's K7a)
    nofold    a group's fold returns at once (the dots are never scaled)
    foldnodot the fold reads no dot and zeroes none (no wait on the mma)
    noscales  no scale rows staged
    noloads   no row, weight or scale bytes staged (the ring's waits remain)

Prints one line a variant and shape, then one JSON object. The variants'
outputs are wrong by design; only their times mean anything.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "k7a_terms"

FOLD = ("  auto fold_as = [&](auto to_float, int (&dd)[2][4][4], const float* sxs,\n"
        "                     const __nv_bfloat16* sws, int sl) {\n")
SCALES = "    for (int c = tid; c < TMR * SLOTS; c += THREADS) {\n"
SCALES_END = ("        ktt::cp_async16(sws + sl * BNC + c8, ok ? se + (long)pick(grp, sl) * N + n0 + c8 "
              ": se, ok);\n    }\n")
ROWS = "    for (int c = tid; c < TMR * HALVES * 2; c += THREADS) {\n"
WEIGHTS_END = "                      ok ? qe + (long)(p0 + r) * N + n0 + ch * 16 : qe, ok);\n    }\n"
DOT = "          const float dv = to_float(IS4 ? dd[i][n][v] >> 4 : dd[i][n][v]);\n"
ZERO = "          dd[i][n][v] = 0;\n"


def variant(src: str, name: str) -> str:
    """gmm.cu with K4 / K7's entry points left out and `name`'s switch."""
    def swap(text, old, new):
        if text.count(old) != 1:
            raise SystemExit(f"k7a_terms: the {name} switch no longer matches csrc/gmm.cu")
        return text.replace(old, new)

    cut = src.index("template <int TMR, int MODE, bool TAIL = false>\nint gmm_launch_tm(")
    src = src[:cut] + "#if 0\n" + src[cut:] + "#endif\n"
    if name == "nofold":
        src = swap(src, FOLD, FOLD + "    return;\n")
    if name == "foldnodot":
        src = swap(src, DOT, "          const float dv = to_float(v + i);\n")
        src = swap(src, ZERO, "")

    if name in ("noscales", "noloads"):
        a = src.index(SCALES)
        b = src.index(SCALES_END, a) + len(SCALES_END)
        src = src[:a] + "#if 0\n" + src[a:b] + "#endif\n" + src[b:]
    if name == "noloads":
        a = src.index(ROWS)
        b = src.index(WEIGHTS_END, a) + len(WEIGHTS_END)
        src = src[:a] + "#if 0\n" + src[a:b] + "#endif\n" + src[b:]
    return src


def main() -> None:
    import torch
    from krasis_tpu_torch import build
    from krasis_tpu_torch.ops import gmm_cuda, moe_cuda
    from krasis_tpu_torch.quant import random_qtensor
    from krasis_tpu_torch.timing import timeit_ms

    names = ("base", "nofold", "foldnodot", "noscales", "noloads")
    OUT.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "gmm.cu").read_text()
    procs = {}
    for name in names:
        cu = OUT / f"gmm_{name}.cu"
        cu.write_text(variant(src, name))
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               str(OUT / f"lib_{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"k7a_terms: {name} did not build:\n{log[-3000:]}")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    E, K, N, T, k = 66, 2048, 2816, 2048, 6
    stacks = {"q8_w13_int8": random_qtensor((E, K, N), 8, 128, g, dev),
              "v2l_w13_int4": random_qtensor((E, K, N), 4, 128, g, dev)}
    x = torch.randn((T, K), generator=g, device=dev).to(torch.bfloat16)
    xq, sx = moe_cuda.quantize_activations(x, 128)
    topk = torch.rand((T, E), generator=g, device=dev).topk(k, dim=-1).indices.to(torch.int32)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    res = {"card": card.strip().splitlines()[0], "ms": {}}
    for sname, w in stacks.items():
        for tm in (64, 128):
            plan = gmm_cuda.plan_tiles(topk, E, tm)
            real = plan.row_src >= 0
            want = gmm_cuda.gmm_a8(xq, sx, plan.row_src, w, plan)
            for name in names:
                fn = ctypes.CDLL(str(OUT / f"lib_{name}.so")).gmm_a8_launch
                fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_long] * 2
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
                out = torch.empty((plan.n_tiles * tm, N), dtype=torch.float32, device=dev)

                def run():
                    build.check(fn(xq.data_ptr(), sx.data_ptr(), plan.row_src.data_ptr(),
                                   w.q.data_ptr(), w.scales.data_ptr(), plan.tile_e.data_ptr(),
                                   plan.tile_valid.data_ptr(), out.data_ptr(), plan.n_tiles, tm,
                                   K, N, w.bits, w.group_size, w.q.stride(0), w.scales.stride(0),
                                   torch.cuda.current_stream().cuda_stream), name)

                ms = timeit_ms(run, 10)
                if name == "base" and not torch.equal(out[real], want[real]):
                    raise SystemExit("k7a_terms: the base variant differs from the built K7a")
                res["ms"][f"{sname}_tm{tm}_{name}"] = ms
                print(f"[k7a_terms] {sname} {tm}-row tiles {name:9s} {ms:.4f} ms", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
