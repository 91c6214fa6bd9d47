"""The benchmark prompt corpus, built offline from text already on the machine.

The port of ``krasis_tpu/prompts.py``. Six domain-distinct corpora (Python
stdlib source and docstrings, Debian copyright texts, C system headers,
package descriptions, a synthetic support dialogue) plus a ``warmup`` domain
that only warm-up runs read, because random-token prompts give MoE routing
and linear-attention state unrealistically uniform statistics. Text is
tokenized with the model's tokenizer or, for synthetic checkpoints without
one, with a frequency-preserving hash vocabulary: each distinct word maps to
a stable id, so the repetition statistics that routing sees survive.

The corpus lives in ``$KRASIS_TPU_HOME/prompts_torch`` (default
``~/.krasis_tpu``), apart from the JAX package's.
"""

from __future__ import annotations

import glob
import gzip
import hashlib
import io
import os
import re
from typing import Dict, List, Optional

DOMAINS = ("code", "docs", "legal", "headers", "catalog", "dialogue")
WARMUP_DOMAIN = "warmup"
TARGET_BYTES = 400_000

_LEGAL_GLOB = "/usr/share/doc/*/copyright"
_HEADERS_GLOB = "/usr/include/*.h"
_DPKG_STATUS = "/var/lib/dpkg/status"


def _home() -> str:
    return os.environ.get("KRASIS_TPU_HOME", os.path.expanduser("~/.krasis_tpu"))


def corpus_dir() -> str:
    """The default corpus directory, ``$KRASIS_TPU_HOME/prompts_torch``."""
    return os.path.join(_home(), "prompts_torch")


def _stdlib_dir() -> str:
    import sysconfig

    return sysconfig.get_paths()["stdlib"]


def _stdlib_files() -> List[str]:
    files = sorted(glob.glob(os.path.join(_stdlib_dir(), "*.py")))
    return [f for f in files if os.path.getsize(f) > 2000]


def _read(path: str) -> str:
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt", errors="replace") as f:
                return f.read()
        with io.open(path, "r", errors="replace") as f:
            return f.read()
    except OSError:
        return ""


def _build_code(target: int) -> str:
    out: List[str] = []
    n = 0
    for f in _stdlib_files():
        t = _read(f)
        out.append(f"# ===== {os.path.basename(f)} =====\n{t}")
        n += len(t)
        if n >= target:
            break
    return "\n".join(out)


def _build_docs(target: int) -> str:
    """Docstring prose of the stdlib modules."""
    out: List[str] = []
    n = 0
    pat = re.compile(r'"""(.*?)"""', re.S)
    for f in _stdlib_files():
        for m in pat.finditer(_read(f)):
            d = m.group(1).strip()
            if len(d) > 200:
                out.append(d)
                n += len(d)
        if n >= target:
            break
    return "\n\n".join(out)


def _glob_docs(pattern: str, target: int, header: str) -> str:
    out: List[str] = []
    n = 0
    for f in sorted(glob.glob(pattern)):
        t = _read(f)
        if len(t) < 500:
            continue
        out.append(f"===== {header}: {f.split('/')[-2]} =====\n{t}")
        n += len(t)
        if n >= target:
            break
    return "\n".join(out)


def _build_legal(target: int) -> str:
    return _glob_docs(_LEGAL_GLOB, target, "license")


def _build_headers(target: int) -> str:
    """C system headers: macro- and declaration-heavy, unlike Python source."""
    return _glob_docs(_HEADERS_GLOB, target, "header")


def _build_catalog(target: int) -> str:
    """Package descriptions: short structured prose paragraphs."""
    t = _read(_DPKG_STATUS)
    blocks = []
    n = 0
    for para in t.split("\n\n"):
        keep = [ln for ln in para.splitlines()
                if ln.startswith(("Package:", "Description", " "))]
        if len(keep) > 3:
            blocks.append("\n".join(keep))
            n += sum(len(k) for k in keep)
        if n >= target:
            break
    return "\n\n".join(blocks)


def _build_dialogue(target: int) -> str:
    """A synthetic support transcript: question and answer turns paired from
    docstring prose."""
    docs = _build_docs(target * 2).split("\n\n")
    out: List[str] = []
    n = 0
    for i in range(0, len(docs) - 1, 2):
        q = docs[i].split(".")[0].strip().replace("\n", " ")
        a = docs[i + 1].strip()
        turn = f"User: Can you explain {q.lower()}?\nAssistant: {a}\n"
        out.append(turn)
        n += len(turn)
        if n >= target:
            break
    return "\n".join(out)


def _build_warmup(target: int) -> str:
    """The warm-up domain: comment lines of the stdlib source, whose token
    statistics differ from the timed code domain's."""
    t = _build_code(target * 3)
    lines = [ln for ln in t.splitlines() if ln.lstrip().startswith("#")]
    return "\n".join(lines)[:target]


_BUILDERS = {
    "code": _build_code,
    "docs": _build_docs,
    "legal": _build_legal,
    "headers": _build_headers,
    "catalog": _build_catalog,
    "dialogue": _build_dialogue,
    WARMUP_DOMAIN: _build_warmup,
}


def domain_source(domain: str) -> str:
    """Where a domain's text comes from (the glob or file it reads)."""
    stdlib = os.path.join(_stdlib_dir(), "*.py")
    return {"legal": _LEGAL_GLOB, "headers": _HEADERS_GLOB,
            "catalog": _DPKG_STATUS}.get(domain, stdlib)


def build_corpus(out_dir: Optional[str] = None,
                 target_bytes: int = TARGET_BYTES) -> Dict[str, str]:
    """Write one .txt per domain into `out_dir` (default ``corpus_dir()``);
    returns {domain: path}. A file of at least half the target is kept."""
    out_dir = out_dir or corpus_dir()
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for dom, fn in _BUILDERS.items():
        path = os.path.join(out_dir, f"{dom}.txt")
        if not (os.path.exists(path)
                and os.path.getsize(path) >= target_bytes // 2):
            text = fn(target_bytes)
            with open(path, "w") as f:
                f.write(text)
        paths[dom] = path
    return paths


def load_domain(domain: str, out_dir: Optional[str] = None) -> str:
    out_dir = out_dir or corpus_dir()
    path = os.path.join(out_dir, f"{domain}.txt")
    if not os.path.exists(path):
        build_corpus(out_dir)
    return _read(path)


_WORD_RE = re.compile(r"[A-Za-z_]+|\d|[^\sA-Za-z_\d]")


def hash_tokenize(text: str, vocab_size: int, n: Optional[int] = None,
                  reserve: int = 1_000) -> List[int]:
    """Frequency-preserving pseudo-tokenization for runs without a
    tokenizer: each distinct word or symbol maps to a stable id in
    [reserve, vocab_size - 100) by blake2b, so repeated words repeat ids."""
    hi = vocab_size - 100 - reserve
    ids: List[int] = []
    for m in _WORD_RE.finditer(text):
        w = m.group(0)
        h = int.from_bytes(hashlib.blake2b(
            w.encode(), digest_size=4).digest(), "little")
        ids.append(reserve + (h % hi))
        if n is not None and len(ids) >= n:
            break
    return ids


def prompt_ids(domain: str, n: int, vocab_size: int, tokenizer=None,
               out_dir: Optional[str] = None) -> List[int]:
    """n prompt token ids from a domain corpus, the text repeated when short.
    A domain with no text on this machine raises ValueError (the reference
    loops forever there)."""
    text = load_domain(domain, out_dir)
    ids = tokenizer.encode(text) if tokenizer is not None else hash_tokenize(text, vocab_size)
    if not ids:
        raise ValueError(f"prompt domain {domain!r} has no text on this machine "
                         f"(its source: {domain_source(domain)})")
    while len(ids) < n:
        ids = ids + ids
    return ids[:n]
