"""A byte-level BPE trainer in plain Python, saved as ``transformers`` saves a
tokenizer.

It stands in for ``tokenizers.BpeTrainer`` with a ``ByteLevel``
pre-tokenizer (``add_prefix_space`` off), which the card's machine does not
have: the text is split by the GPT-2 pattern of the port's ``ByteLevel``
pre-tokenizer (``runtime/tokenizer.py``), each piece mapped to its byte
characters, and the vocabulary starts with the special tokens, then the 256
byte characters in code-point order; merges are added, the most frequent
adjacent pair first (ties: the smallest pair of ids), until the vocabulary
holds `vocab_size` entries. Pair counts are kept up to date incrementally:
a merge touches only the words that hold its pair. The merges need not equal
``tokenizers``' (it breaks ties another way), but the files read the same in
both tokenizers.
"""

from __future__ import annotations

import heapq
import json
import os
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .tokenizer import BYTE_CHAR, build_pre_tokenizer

PRE_TOKENIZER = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                 "use_regex": True}
DECODER = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
           "use_regex": True}

Pair = Tuple[int, int]


def count_words(texts: Iterable[str]) -> Counter:
    """Byte-level pieces of every text and how often each occurs."""
    split = build_pre_tokenizer(PRE_TOKENIZER)
    words: Counter = Counter()
    for text in texts:
        words.update(split([text]))
    return words


def train_bpe(texts: Iterable[str], vocab_size: int, special_tokens: Sequence[str] = ()
              ) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """(vocab, merges) of a byte-level BPE trained on `texts`: the special
    tokens, the 256 byte characters, then merges up to `vocab_size` entries
    in all (fewer when no pair is left)."""
    vocab: Dict[str, int] = {}
    for t in special_tokens:
        vocab.setdefault(t, len(vocab))
    for ch in sorted(BYTE_CHAR.values()):
        vocab.setdefault(ch, len(vocab))
    id_to_tok = {i: t for t, i in vocab.items()}

    counts = count_words(texts)
    words: List[List[int]] = [[vocab[c] for c in w] for w in counts]
    freq: List[int] = list(counts.values())

    pair_count: Dict[Pair, int] = defaultdict(int)
    where: Dict[Pair, set] = defaultdict(set)
    for wi, syms in enumerate(words):
        for p in zip(syms, syms[1:]):
            pair_count[p] += freq[wi]
            where[p].add(wi)
    heap = [(-c, p) for p, c in pair_count.items()]
    heapq.heapify(heap)

    merges: List[Tuple[str, str]] = []
    while len(vocab) < vocab_size and heap:
        neg, pair = heapq.heappop(heap)
        if pair_count.get(pair, 0) != -neg or -neg <= 0:
            continue                                      # a stale entry
        a, b = pair
        text = id_to_tok[a] + id_to_tok[b]
        new = vocab.get(text)
        if new is None:
            new = vocab[text] = len(vocab)
            id_to_tok[new] = text
        merges.append((id_to_tok[a], id_to_tok[b]))
        touched: Dict[Pair, int] = {}
        for wi in where.pop(pair):
            syms, f = words[wi], freq[wi]
            for p in zip(syms, syms[1:]):                 # the word's old pairs out
                pair_count[p] -= f
                touched[p] = pair_count[p]
                if p != pair:
                    where[p].discard(wi)
            out, i = [], 0
            while i < len(syms):
                if i + 1 < len(syms) and syms[i] == a and syms[i + 1] == b:
                    out.append(new)
                    i += 2
                else:
                    out.append(syms[i])
                    i += 1
            words[wi] = out
            for p in zip(out, out[1:]):                   # and its new pairs in
                pair_count[p] += f
                touched[p] = pair_count[p]
                where[p].add(wi)
        for p in touched:
            c = pair_count.get(p, 0)
            if c > 0:
                heapq.heappush(heap, (-c, p))
            else:
                pair_count.pop(p, None)
    return vocab, merges


def _added(tid: int, content: str) -> dict:
    return {"id": tid, "content": content, "single_word": False, "lstrip": False,
            "rstrip": False, "normalized": False, "special": True}


def save_tokenizer(out_dir: str, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                   special_tokens: Sequence[str], eos_token: Optional[str] = None,
                   pad_token: Optional[str] = None,
                   chat_template: Optional[str] = None) -> None:
    """``tokenizer.json``, ``tokenizer_config.json`` and
    ``special_tokens_map.json`` in the form ``transformers`` saves a
    ``PreTrainedTokenizerFast``."""
    os.makedirs(out_dir, exist_ok=True)
    added = [_added(vocab[t], t) for t in special_tokens]
    spec = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": None, "pre_tokenizer": PRE_TOKENIZER, "post_processor": None,
        "decoder": DECODER,
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": [list(m) for m in merges]},
    }
    config = {
        "added_tokens_decoder": {str(a["id"]): {k: a[k] for k in (
            "content", "lstrip", "normalized", "rstrip", "single_word", "special")}
            for a in added},
        "chat_template": chat_template,
        "clean_up_tokenization_spaces": False,
        "eos_token": eos_token,
        "extra_special_tokens": {},
        "model_max_length": 1000000000000000019884624838656,
        "pad_token": pad_token,
        "tokenizer_class": "PreTrainedTokenizerFast",
    }
    specials = {k: v for k, v in (("eos_token", eos_token), ("pad_token", pad_token)) if v}
    for name, obj in (("tokenizer.json", spec), ("tokenizer_config.json", config),
                      ("special_tokens_map.json", specials)):
        with open(os.path.join(out_dir, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, indent=2, ensure_ascii=False)
