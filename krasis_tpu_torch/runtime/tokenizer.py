"""Tokenizer: byte-level BPE over ``tokenizer.json``, chat template,
incremental decode.

The port of ``krasis_tpu/runtime/tokenizer.py``, which wraps
``transformers.AutoTokenizer``. The card's machine has neither
``transformers`` nor ``tokenizers``, so this module reads
``tokenizer.json`` and ``tokenizer_config.json`` itself and runs the same
pipeline as the ``tokenizers`` package, giving the same ids and text:

1. added and special tokens are split out of the text (the leftmost
   longest match, with their ``lstrip`` / ``rstrip`` / ``single_word`` /
   ``normalized`` flags);
2. the normalizer (``NFC``, ``NFKC``, ``NFD``, ``NFKD``, ``Sequence``) runs
   on the pieces between them;
3. the pre-tokenizer (``ByteLevel``, ``Split``, ``Digits``, ``Sequence``)
   cuts each piece; its Oniguruma patterns run through
   ``utils/unicode_re.py``;
4. the ``BPE`` model merges each pre-token by rank (``ignore_merges``; no
   ``unk`` for byte-level vocabularies: a symbol the vocabulary lacks is
   dropped, as ``tokenizers`` drops it);
5. the post-processor (``TemplateProcessing``, ``ByteLevel``, ``Sequence``)
   adds the special tokens of a single sequence when ``encode`` asks for
   them.

``decode`` maps ids to tokens (an id the vocabulary lacks is skipped, as in
``tokenizers``), runs the ``ByteLevel`` decoder (bytes decoded as UTF-8,
each ill-formed subsequence one U+FFFD) and, when ``tokenizer_config.json``
sets ``clean_up_tokenization_spaces``, ``transformers``' clean-up. A
feature the files use and this module lacks (``Metaspace``,
``byte_fallback``, a ``WordPiece`` model, …) raises ``NotImplementedError``
naming it when the tokenizer is loaded.
"""

from __future__ import annotations

import heapq
import json
import os
import re
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils import unicode_re

# tokenizers' ByteLevel pre-tokenizer pattern (GPT-2's)
BYTE_LEVEL_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
                      r"|\s+(?!\S)|\s+")
SPECIAL_TOKEN_ATTRIBUTES = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                            "cls_token", "mask_token", "additional_special_tokens")
WHITE_SPACE = frozenset(chr(c) for lo, hi in unicode_re.WHITE_SPACE for c in range(lo, hi + 1))


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte → printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_CHAR = bytes_to_unicode()
CHAR_BYTE = {c: b for b, c in BYTE_CHAR.items()}


# ---- splitting (tokenizers' Pattern::find_matches and SplitDelimiterBehavior)

Piece = Tuple[int, int, bool]          # start, end, is a match


def find_matches(text: str, pattern: "re.Pattern[str]") -> List[Piece]:
    if not text:
        return [(0, 0, False)]
    out, prev = [], 0
    for m in pattern.finditer(text):
        if prev != m.start():
            out.append((prev, m.start(), False))
        out.append((m.start(), m.end(), True))
        prev = m.end()
    if prev != len(text):
        out.append((prev, len(text), False))
    return out


def find_char_matches(text: str, pred: Callable[[str], bool]) -> List[Piece]:
    """Each character for which `pred` holds is a match of its own."""
    if not text:
        return [(0, 0, False)]
    out, prev = [], 0
    for i, ch in enumerate(text):
        if pred(ch):
            if prev != i:
                out.append((prev, i, False))
            out.append((i, i + 1, True))
            prev = i + 1
    if prev != len(text):
        out.append((prev, len(text), False))
    return out


def split_pieces(text: str, matches: List[Piece], behavior: str) -> List[str]:
    """The pieces `behavior` makes of `text` (empty pieces dropped)."""
    spans: List[List[int]] = []
    if behavior == "Removed":
        spans = [[s, e] for s, e, m in matches if not m]
    elif behavior == "Isolated":
        spans = [[s, e] for s, e, _ in matches]
    elif behavior in ("Contiguous", "MergedWithPrevious"):
        previous = False
        for s, e, m in matches:
            glue = m == previous if behavior == "Contiguous" else (m and not previous)
            if glue and spans:
                spans[-1][1] = e
            else:
                spans.append([s, e])
            previous = m
    elif behavior == "MergedWithNext":
        previous = False
        for s, e, m in reversed(matches):
            if m and not previous and spans:
                spans[-1][0] = s
            else:
                spans.append([s, e])
            previous = m
        spans.reverse()
    else:
        raise NotImplementedError(f"Split behavior {behavior!r}")
    return [text[s:e] for s, e in spans if e > s]


def _split_regex(spec: dict) -> "re.Pattern[str]":
    pat = spec["pattern"]
    if "Regex" in pat:
        return unicode_re.compile(pat["Regex"])
    return re.compile(re.escape(pat["String"]))


def is_numeric(ch: str) -> bool:
    """Rust's ``char::is_numeric``: general category N."""
    return unicodedata.category(ch)[0] == "N"


# ---- pipeline stages built from tokenizer.json -------------------------------

def build_normalizer(spec: Optional[dict]) -> Callable[[str], str]:
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind in ("NFC", "NFKC", "NFD", "NFKD"):
        return lambda s: unicodedata.normalize(kind, s)
    if kind == "Sequence":
        steps = [build_normalizer(n) for n in spec["normalizers"]]

        def run(s: str) -> str:
            for f in steps:
                s = f(s)
            return s
        return run
    raise NotImplementedError(f"normalizer {kind!r}")


def byte_level(piece: str) -> str:
    return "".join(BYTE_CHAR[b] for b in piece.encode("utf-8"))


def build_pre_tokenizer(spec: Optional[dict]) -> Callable[[List[str]], List[str]]:
    """A function from pieces to pieces."""
    if spec is None:
        return lambda pieces: pieces
    kind = spec["type"]
    if kind == "Sequence":
        steps = [build_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def run(pieces: List[str]) -> List[str]:
            for f in steps:
                pieces = f(pieces)
            return pieces
        return run
    if kind == "ByteLevel":
        prefix = spec.get("add_prefix_space", False)
        pattern = unicode_re.compile(BYTE_LEVEL_PATTERN) if spec.get("use_regex", True) else None

        def run(pieces: List[str]) -> List[str]:
            out = []
            for p in pieces:
                if prefix and not p.startswith(" "):
                    p = " " + p
                parts = [p] if pattern is None else split_pieces(
                    p, find_matches(p, pattern), "Isolated")
                out.extend(byte_level(q) for q in parts if q)
            return out
        return run
    if kind == "Split":
        pattern, behavior = _split_regex(spec), spec["behavior"]
        invert = spec.get("invert", False)

        def run(pieces: List[str]) -> List[str]:
            out = []
            for p in pieces:
                matches = find_matches(p, pattern)
                if invert:
                    matches = [(s, e, not m) for s, e, m in matches]
                out.extend(split_pieces(p, matches, behavior))
            return out
        return run
    if kind == "Digits":
        behavior = "Isolated" if spec.get("individual_digits", False) else "Contiguous"
        return lambda pieces: [q for p in pieces
                               for q in split_pieces(p, find_char_matches(p, is_numeric),
                                                     behavior)]
    raise NotImplementedError(f"pre-tokenizer {kind!r}")


class BPE:
    """tokenizers' BPE model: a word's symbols merged lowest rank first,
    leftmost first among equal ranks, through a heap with its stale-entry
    rule (``Word::merge_all``)."""

    def __init__(self, spec: dict):
        for key in ("dropout", "unk_token", "continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key) not in (None, 0.0, ""):
                raise NotImplementedError(f"BPE {key}={spec[key]!r} (not a byte-level vocabulary)")
        if spec.get("byte_fallback"):
            raise NotImplementedError("BPE byte_fallback (a SentencePiece-style vocabulary)")
        self.vocab: Dict[str, int] = spec["vocab"]
        self.ignore_merges = spec.get("ignore_merges", False)
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec["merges"]):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            if a not in self.vocab or b not in self.vocab or a + b not in self.vocab:
                raise ValueError(f"BPE merge {a!r} + {b!r}: a part or the result is not in "
                                 "the vocabulary")
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        self._cache: Dict[str, List[int]] = {}

    def tokenize(self, word: str) -> List[int]:
        hit = self._cache.get(word)
        if hit is None:
            hit = self._tokenize(word)
            if len(self._cache) < 100_000:
                self._cache[word] = hit
        return hit

    def _tokenize(self, word: str) -> List[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        # a character the vocabulary lacks is dropped (no unk token)
        c = [self.vocab[ch] for ch in word if ch in self.vocab]
        n = len(c)
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = self.merges.get((c[i], c[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = self.merges.get((c[pos], c[right]))
            if m is None or m[1] != new:
                continue                       # a stale entry
            c[pos] = new
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] != -1:
                prv[nxt[pos]] = pos
            p = prv[pos]
            if p != -1:
                m = self.merges.get((c[p], c[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
            if nxt[pos] != -1:
                m = self.merges.get((c[pos], c[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [t for t, a in zip(c, alive) if a]


def build_post_processor(spec: Optional[dict], token_id: Callable[[str], int]
                         ) -> Callable[[List[int]], List[int]]:
    """The single-sequence post-processor with special tokens added."""
    if spec is None:
        return lambda ids: ids
    kind = spec["type"]
    if kind == "ByteLevel":
        return lambda ids: ids
    if kind == "TemplateProcessing":
        specials = spec.get("special_tokens", {})
        parts: List[Optional[List[int]]] = []
        for item in spec["single"]:
            if "Sequence" in item:
                parts.append(None)
            else:
                parts.append(list(specials[item["SpecialToken"]["id"]]["ids"]))
        return lambda ids: [t for p in parts for t in (ids if p is None else p)]
    if kind == "Sequence":
        steps = [build_post_processor(p, token_id) for p in spec["processors"]]

        def run(ids: List[int]) -> List[int]:
            for f in steps:
                ids = f(ids)
            return ids
        return run
    raise NotImplementedError(f"post-processor {kind!r}")


def _byte_level_decode(tokens: List[str]) -> str:
    out = bytearray()
    for t in tokens:
        try:
            out.extend(CHAR_BYTE[ch] for ch in t)
        except KeyError:                      # a token outside the byte alphabet
            out.extend(t.encode("utf-8"))
    return out.decode("utf-8", errors="replace")


def build_decoder(spec: Optional[dict]) -> Callable[[List[str]], str]:
    if spec is None:
        return " ".join
    kind = spec["type"]
    if kind == "ByteLevel":
        return _byte_level_decode
    if kind == "Sequence" and all(d["type"] == "ByteLevel" for d in spec["decoders"]):
        return _byte_level_decode
    raise NotImplementedError(f"decoder {kind!r}")


def clean_up_tokenization(text: str) -> str:
    """transformers' ``clean_up_tokenization``."""
    return (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!").replace(" ,", ",")
            .replace(" ' ", "'").replace(" n't", "n't").replace(" 'm", "'m")
            .replace(" 's", "'s").replace(" 've", "'ve").replace(" 're", "'re"))


class AddedToken:
    def __init__(self, spec: dict, normalize: Callable[[str], str]):
        self.id = spec["id"]
        self.content = spec["content"]
        self.lstrip = spec.get("lstrip", False)
        self.rstrip = spec.get("rstrip", False)
        self.single_word = spec.get("single_word", False)
        self.normalized = spec.get("normalized", not spec.get("special", False))
        self.special = spec.get("special", False)
        self.match = normalize(self.content) if self.normalized else self.content


def _is_word(ch: str) -> bool:
    return ch.isalnum() or ch == "_"


def _extract(text: str, tokens: List[AddedToken], pattern: Optional["re.Pattern[str]"],
             by_text: Dict[str, AddedToken]) -> List[Tuple[Optional[int], str]]:
    """tokenizers' ``AddedVocabulary::find_matches``: the text cut into
    (added token id or None, piece)."""
    if pattern is None or not text:
        return [(None, text)]
    out: List[Tuple[Optional[int], str]] = []
    done = 0
    pos = 0
    while True:
        m = pattern.search(text, pos)
        if m is None:
            break
        start, stop = m.start(), m.end()
        pos = stop if stop > start else start + 1
        tok = by_text[m.group()]
        if tok.single_word:
            if (start > 0 and _is_word(text[start - 1])) or (
                    stop < len(text) and _is_word(text[stop])):
                continue
        if tok.lstrip:
            s = start
            while s > 0 and text[s - 1] in WHITE_SPACE:
                s -= 1
            start = max(s, done)
        if tok.rstrip:
            while stop < len(text) and text[stop] in WHITE_SPACE:
                stop += 1
        if done < start:
            out.append((None, text[done:start]))
        out.append((tok.id, text[start:stop]))
        done = stop
        pos = max(pos, stop)
    if done != len(text):
        out.append((None, text[done:]))
    return out


def _alternation(tokens: List[AddedToken]) -> Optional["re.Pattern[str]"]:
    """Leftmost-longest matching of the tokens' texts."""
    texts = sorted({t.match for t in tokens if t.match}, key=len, reverse=True)
    return re.compile("|".join(re.escape(t) for t in texts)) if texts else None


def _token_text(value) -> Optional[str]:
    if isinstance(value, dict):
        return value.get("content")
    return value


class Tokenizer:
    """``tokenizer.json`` + ``tokenizer_config.json`` of `model_path`."""

    def __init__(self, model_path: str):
        with open(os.path.join(model_path, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        self.config = _read_json(os.path.join(model_path, "tokenizer_config.json"))
        special_map = _read_json(os.path.join(model_path, "special_tokens_map.json"))
        model = spec["model"]
        if model.get("type", "BPE") != "BPE":
            raise NotImplementedError(f"tokenizer model {model.get('type')!r}")
        self.model = BPE(model)
        self.normalize = build_normalizer(spec.get("normalizer"))
        self.pre_tokenize = build_pre_tokenizer(spec.get("pre_tokenizer"))
        self.decode_tokens = build_decoder(spec.get("decoder"))
        self.added = [AddedToken(t, self.normalize) for t in spec.get("added_tokens", [])]
        raw = [t for t in self.added if not t.normalized]
        norm = [t for t in self.added if t.normalized]
        self._raw_split = (_alternation(raw), {t.match: t for t in raw})
        self._norm_split = (_alternation(norm), {t.match: t for t in norm})
        self.id_to_token: Dict[int, str] = {i: t for t, i in self.model.vocab.items()}
        self.id_to_token.update({t.id: t.content for t in self.added})
        self.token_to_id: Dict[str, int] = dict(self.model.vocab)
        self.token_to_id.update({t.content: t.id for t in self.added})
        self.post_process = build_post_processor(
            _llama_template(self.config, self.token_to_id) or spec.get("post_processor"),
            self.token_to_id.__getitem__)
        self.clean_up = bool(self.config.get("clean_up_tokenization_spaces", False))
        self.special_tokens: Dict[str, object] = {}
        for attr in SPECIAL_TOKEN_ATTRIBUTES:
            value = self.config.get(attr, special_map.get(attr))
            if attr == "additional_special_tokens":
                value = [_token_text(v) for v in value or []]
            else:
                value = _token_text(value)
            if value:
                self.special_tokens[attr] = value
        self.chat_template = _read_template(model_path, self.config)

    @property
    def eos_token_id(self) -> Optional[int]:
        eos = self.special_tokens.get("eos_token")
        return None if eos is None else self.token_to_id.get(eos)

    def _encode(self, text: str, add_special_tokens: bool) -> List[int]:
        ids: List[int] = []
        raw_pattern, raw_by_text = self._raw_split
        norm_pattern, norm_by_text = self._norm_split
        for tid, piece in _extract(text, self.added, raw_pattern, raw_by_text):
            if tid is not None:
                ids.append(tid)
                continue
            for tid2, sub in _extract(self.normalize(piece), self.added, norm_pattern,
                                      norm_by_text):
                if tid2 is not None:
                    ids.append(tid2)
                elif sub:
                    for word in self.pre_tokenize([sub]):
                        ids.extend(self.model.tokenize(word))
        return self.post_process(ids) if add_special_tokens else ids

    def encode(self, text: str) -> List[int]:
        return self._encode(text, add_special_tokens=True)

    def decode(self, ids: Sequence[int]) -> str:
        tokens = [t for t in (self.id_to_token.get(int(i)) for i in ids) if t is not None]
        text = self.decode_tokens(tokens)
        return clean_up_tokenization(text) if self.clean_up else text

    def apply_chat_template(self, messages: List[dict],
                            enable_thinking: Optional[bool] = None) -> List[int]:
        from .chat_template import render

        if self.chat_template is None:
            raise ValueError("the tokenizer has no chat_template")
        kwargs = dict(self.special_tokens, add_generation_prompt=True)
        if enable_thinking is not None:
            kwargs["enable_thinking"] = enable_thinking
        try:
            text = render(self.chat_template, messages, **kwargs)
        except TypeError:  # template without enable_thinking support
            kwargs.pop("enable_thinking", None)
            text = render(self.chat_template, messages, **kwargs)
        return self._encode(text, add_special_tokens=False)


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _read_template(model_path: str, config: dict) -> Optional[str]:
    """chat_template.jinja beside the files (what transformers writes and
    reads first), else tokenizer_config's ``chat_template`` (a string, or a
    list of named templates of which "default" is taken)."""
    path = os.path.join(model_path, "chat_template.jinja")
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            return f.read()
    tpl = config.get("chat_template")
    if isinstance(tpl, list):
        tpl = {t["name"]: t["template"] for t in tpl}.get("default")
    return tpl


def _llama_template(config: dict, token_to_id: Dict[str, int]) -> Optional[dict]:
    """transformers' ``LlamaTokenizerFast.update_post_processor``: a
    TemplateProcessing from ``add_bos_token`` / ``add_eos_token``, which
    that class puts in place of the file's post-processor."""
    if config.get("tokenizer_class") != "LlamaTokenizerFast":
        return None
    single: List[dict] = []
    specials: Dict[str, dict] = {}
    for flag, attr, default in (("add_bos_token", "bos_token", True), (None, None, None),
                                ("add_eos_token", "eos_token", False)):
        if flag is None:
            single.append({"Sequence": {"id": "A", "type_id": 0}})
            continue
        tok = _token_text(config.get(attr))
        if config.get(flag, default):
            if tok is None:
                raise ValueError(f"{flag} is set but {attr} is None")
            single.append({"SpecialToken": {"id": tok, "type_id": 0}})
            specials[tok] = {"id": tok, "ids": [token_to_id[tok]], "tokens": [tok]}
    return {"type": "TemplateProcessing", "single": single, "special_tokens": specials}


class IncrementalDecoder:
    """Streams text token-by-token, holding back bytes until stable
    (reference tokenizer.py incremental decode)."""

    def __init__(self, tokenizer: Tokenizer):
        self.tk = tokenizer
        self.ids: List[int] = []
        self.emitted = 0

    def push(self, token_id: int) -> str:
        self.ids.append(token_id)
        text = self.tk.decode(self.ids)
        # Hold back if the tail is an incomplete UTF-8 sequence (the
        # replacement char at the end signals a split codepoint).
        if text.endswith("�"):
            return ""
        delta = text[self.emitted:]
        self.emitted = len(text)
        return delta
