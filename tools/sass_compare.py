"""Compare the SASS of the port's kernels between two source trees.

    python tools/sass_compare.py --parent DIR [--sources qmm moe_w4a8 ...]

Builds each named source (``<name>.cu``) of DIR and of
``krasis_tpu_torch/csrc`` with the port's nvcc flags (``build.NVCC_FLAGS``,
the headers of ``csrc``), disassembles both with ``cuobjdump -sass`` and
compares each kernel's instructions, addresses and encodings left out and
whitespace collapsed (the dump's column alignment moves with the name
lengths). Kernels are matched by their demangled names (``cu++filt``)
without namespace and parameter list (parameters may be appended), and
with trailing template arguments ``false`` dropped, so that an instance
keeps its key when flags are appended to a kernel template with its old
behavior at ``false``. Prints,
and writes to ``build/sass/compare.json``, the kernels that are the same,
that differ (with the count of differing lines), and those found on one
side only. Needs the CUDA toolkit; nothing runs on the card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from krasis_tpu_torch import build  # noqa: E402

OUT = build.BUILD_DIR.parent / "sass"


def tool(name: str) -> str:
    """A CUDA toolkit program: on the PATH, else beside nvcc."""
    return shutil.which(name) or str(Path(build.nvcc_path()).parent / name)


def disassemble(src: Path, tag: str) -> Dict[str, List[str]]:
    """{mangled kernel name: its instructions} of one source built as the
    port builds it."""
    lib = OUT / tag / f"lib{src.stem}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib),
                    str(src)], check=True)
    dump = subprocess.run([tool("cuobjdump"), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs: Dict[str, List[str]] = {}
    cur = None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
        elif cur is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*(/\*.*)?$", line)
            if m and m.group(1):
                funcs[cur].append(" ".join(m.group(1).split()))
    return funcs


def key(demangled: str) -> str:
    """A kernel's name and template arguments: no return type, namespace,
    parameter list or integer casts, and trailing template arguments false
    dropped."""
    d = demangled.replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
    d = re.sub(r"^void ", "", d)
    if d.endswith(")"):  # the parameter list: the last top-level parentheses
        depth, i = 0, len(d) - 1
        while i >= 0:
            depth += {")": 1, "(": -1}.get(d[i], 0)
            if depth == 0:
                break
            i -= 1
        d = d[:i]
    while re.search(r", (?:\(bool\)0|false)>$", d):
        d = re.sub(r", (?:\(bool\)0|false)>$", ">", d)
    return re.sub(r"\((?:int|bool)\)", "", d)


def keys(mangled: List[str]) -> Dict[str, str]:
    """{mangled name: its key}, demangled by cu++filt."""
    out = subprocess.run([tool("cu++filt")], input="\n".join(mangled), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return {m: key(d) for m, d in zip(mangled, out)}


def compare(parent: Path, sources) -> dict:
    report = {"same": [], "differ": {}, "parent_only": [], "new_only": []}
    for name in sources:
        old = disassemble(parent / f"{name}.cu", "parent")
        new = disassemble(build.CSRC / f"{name}.cu", "new")
        ko, kn = keys(list(old)), keys(list(new))
        old = {ko[k]: v for k, v in old.items()}
        new = {kn[k]: v for k, v in new.items()}
        for k in sorted(set(old) | set(new)):
            if k not in new:
                report["parent_only"].append(k)
            elif k not in old:
                report["new_only"].append(k)
            elif old[k] == new[k]:
                report["same"].append(k)
            else:
                report["differ"][k] = (sum(a != b for a, b in zip(old[k], new[k]))
                                       + abs(len(old[k]) - len(new[k])))
    return report


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="a directory holding the other tree's <name>.cu sources")
    ap.add_argument("--sources", nargs="+", default=["qmm"])
    args = ap.parse_args()
    report = compare(args.parent, args.sources)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "compare.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"same": len(report["same"]), **{k: v for k, v in report.items()
                                                      if k != "same"}}, indent=1))


if __name__ == "__main__":
    main()
