"""Oniguruma patterns of ``tokenizer.json`` as Python ``re`` patterns.

A published tokenizer's ``Split`` pre-tokenizer (and the GPT-2 pattern of
``ByteLevel``) is an Oniguruma regex, as the ``tokenizers`` package runs
it. Python 3.12's ``re`` has the same grammar for what those patterns use
(scoped ``(?i:…)``, lookahead, possessive quantifiers, atomic groups) but
no ``\\p{…}``, and some escapes mean other things. ``translate`` rewrites a
pattern so that ``re`` gives the same matches:

- ``\\p{X}`` / ``\\P{X}`` / ``\\p{^X}`` for a general category (one letter,
  two letters, or ``LC``) become explicit code-point classes, built once
  at import from ``unicodedata`` over U+0000-U+10FFFF; inside ``[…]`` and
  ``[^…]`` they become the ranges themselves;
- ``\\s`` is Unicode White_Space, as in Oniguruma (Python's ``\\s`` also
  takes U+001C-U+001F, which Oniguruma's does not), ``\\d`` is ``Nd``,
  ``\\h`` is a hex digit; their capitals are the complements;
- ``^`` and ``$`` are Oniguruma's (Ruby's) line anchors: ``$`` matches
  before every newline, ``^`` after one;
- ``\\x{H…}`` is a code point.

What has no faithful translation raises ``NotImplementedError`` naming it
(``\\w`` and ``\\b``, whose word characters are Unicode's Alphabetic
property, which ``unicodedata`` lacks; nested classes and class
intersections; script and binary property names). Python 3.12 ships
Unicode 15.0, ``tokenizers`` 0.22's Oniguruma a later version: code points
that Unicode 15.0 leaves unassigned can fall in another class there
(``tests/test_torch_tokenizer.py`` lists them).
"""

from __future__ import annotations

import functools
import re
import sys
import unicodedata
from typing import Dict, List, Tuple

Ranges = List[Tuple[int, int]]

MAX_CP = sys.maxunicode
GROUPS = {"L": ("Lu", "Ll", "Lt", "Lm", "Lo"), "LC": ("Lu", "Ll", "Lt"),
          "M": ("Mn", "Mc", "Me"), "N": ("Nd", "Nl", "No"),
          "P": ("Pc", "Pd", "Ps", "Pe", "Pi", "Pf", "Po"), "S": ("Sm", "Sc", "Sk", "So"),
          "Z": ("Zs", "Zl", "Zp"), "C": ("Cc", "Cf", "Cs", "Co", "Cn")}
# Unicode White_Space: Oniguruma's \s
WHITE_SPACE: Ranges = [(0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                       (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                       (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000)]
HEX_DIGIT: Ranges = [(0x30, 0x39), (0x41, 0x46), (0x61, 0x66)]


def _category_ranges() -> Dict[str, Ranges]:
    """{two-letter general category: sorted code-point ranges}."""
    out: Dict[str, Ranges] = {}
    start, prev = 0, unicodedata.category("\0")
    for cp in range(1, MAX_CP + 2):
        cat = unicodedata.category(chr(cp)) if cp <= MAX_CP else None
        if cat != prev:
            out.setdefault(prev, []).append((start, cp - 1))
            start, prev = cp, cat
    return out


CATEGORIES = _category_ranges()


def merge(ranges: Ranges) -> Ranges:
    out: Ranges = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(hi, out[-1][1]))
        else:
            out.append((lo, hi))
    return out


def complement(ranges: Ranges) -> Ranges:
    out, nxt = [], 0
    for lo, hi in merge(ranges):
        if lo > nxt:
            out.append((nxt, lo - 1))
        nxt = hi + 1
    if nxt <= MAX_CP:
        out.append((nxt, MAX_CP))
    return out


@functools.lru_cache(maxsize=None)
def property_ranges(name: str) -> Tuple[Tuple[int, int], ...]:
    """The code points of general category `name` (``L``, ``Lu``, ``P``, …)."""
    if name in GROUPS:
        cats = GROUPS[name]
    elif name in CATEGORIES or (len(name) == 2 and name[0] in GROUPS):
        cats = (name,)
    else:
        raise NotImplementedError(f"regex property \\p{{{name}}} (only general categories)")
    return tuple(merge([r for c in cats for r in CATEGORIES.get(c, [])]))


def _esc(cp: int) -> str:
    return f"\\u{cp:04x}" if cp <= 0xFFFF else f"\\U{cp:08x}"


def class_body(ranges: Ranges) -> str:
    """Ranges as the inside of a ``[…]`` class, every code point escaped."""
    parts = []
    for lo, hi in ranges:
        parts.append(_esc(lo) if lo == hi else
                     _esc(lo) + _esc(hi) if hi == lo + 1 else f"{_esc(lo)}-{_esc(hi)}")
    return "".join(parts)


ESCAPE_CLASSES = {"s": WHITE_SPACE, "h": HEX_DIGIT}


def _escape_ranges(letter: str) -> Ranges:
    low = letter.lower()
    ranges = list(property_ranges("Nd")) if low == "d" else ESCAPE_CLASSES[low]
    return complement(ranges) if letter.isupper() else ranges


def _property_at(pattern: str, i: int) -> Tuple[Ranges, int]:
    """Ranges of the ``\\p{…}`` / ``\\P{…}`` starting at pattern[i] (the
    backslash) and the index after it."""
    end = pattern.find("}", i)
    if pattern[i + 2:i + 3] != "{" or end < 0:
        raise NotImplementedError(f"regex escape {pattern[i:i + 3]!r} (one-letter property)")
    name, negate = pattern[i + 3:end], pattern[i + 1] == "P"
    if name.startswith("^"):
        name, negate = name[1:], not negate
    ranges = list(property_ranges(name))
    return (complement(ranges) if negate else ranges), end + 1


def _hex_at(pattern: str, i: int) -> Tuple[str, int]:
    end = pattern.find("}", i)
    return _esc(int(pattern[i + 3:end], 16)), end + 1


def translate(pattern: str) -> str:
    """The Python ``re`` pattern with the matches of Oniguruma `pattern`."""
    out: List[str] = []
    i, n = 0, len(pattern)
    while i < n:
        c = pattern[i]
        if c == "\\":
            nxt = pattern[i + 1:i + 2]
            if nxt in ("p", "P"):
                ranges, i = _property_at(pattern, i)
                out.append(f"[{class_body(ranges)}]")
                continue
            if nxt in "sSdDhH" and nxt:
                out.append(f"[{class_body(_escape_ranges(nxt))}]")
            elif nxt == "x" and pattern[i + 2:i + 3] == "{":
                esc, i = _hex_at(pattern, i)
                out.append(esc)
                continue
            elif nxt in ("w", "W", "b", "B"):
                raise NotImplementedError(f"regex escape \\{nxt} (Unicode Alphabetic)")
            elif nxt in ("z", "Z", "G", "K", "R", "X", "k", "g"):
                raise NotImplementedError(f"regex escape \\{nxt}")
            else:
                out.append(pattern[i:i + 2])
            i += 2
        elif c == "[":
            body, i = _class(pattern, i)
            out.append(body)
        elif c == "^":
            out.append(r"(?:\A|(?<=\n))")
            i += 1
        elif c == "$":
            out.append(r"(?=\n|\Z)")
            i += 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _class(pattern: str, i: int) -> Tuple[str, int]:
    """Translate the class opening at pattern[i]; returns it and the index
    after its ``]``."""
    j = i + 1
    head = "["
    if pattern[j:j + 1] == "^":
        head, j = "[^", j + 1
    items: List[str] = []
    first = True
    while True:
        if j >= len(pattern):
            raise ValueError(f"unterminated character class in {pattern!r}")
        c = pattern[j]
        if c == "]" and not first:
            return head + "".join(items) + "]", j + 1
        first = False
        if c == "\\":
            nxt = pattern[j + 1:j + 2]
            if nxt in ("p", "P"):
                ranges, j = _property_at(pattern, j)
                items.append(class_body(ranges))
                continue
            if nxt in ("w", "W"):
                raise NotImplementedError(f"regex escape \\{nxt} (Unicode Alphabetic)")
            if nxt in "sSdDhH" and nxt:
                items.append(class_body(_escape_ranges(nxt)))
            elif nxt == "x" and pattern[j + 2:j + 3] == "{":
                esc, j = _hex_at(pattern, j)
                items.append(esc)
                continue
            else:
                items.append(pattern[j:j + 2])
            j += 2
        elif c == "[" or pattern.startswith("&&", j):
            raise NotImplementedError(f"nested character class or intersection in {pattern!r}")
        elif c == "]":
            items.append(r"\]")
            j += 1
        else:
            items.append(c)
            j += 1


@functools.lru_cache(maxsize=64)
def compile(pattern: str) -> "re.Pattern[str]":  # noqa: A001 (re.compile's name)
    return re.compile(translate(pattern))
