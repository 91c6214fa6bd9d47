"""Byte-level BPE tokenizers trained here with the ``tokenizers`` package,
one for each pre-tokenizer shape the supported families publish, saved as
transformers saves a checkpoint's tokenizer (``tokenizer.json``,
``tokenizer_config.json``, ``chat_template.jinja``). The tests hold the
port's tokenizer to ``krasis_tpu.runtime.tokenizer.Tokenizer`` on them.

    python tests/torch_tokenizer_util.py

rewrites the committed test tokenizer under ``tests/data/torch_tokenizer/``
(Qwen-style Split + NFC, ChatML), which the card's run serves."""

from __future__ import annotations

import json
import os
import sys

# Qwen2 / Qwen3 (tokenizer.json pre_tokenizer Split)
QWEN_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
                r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
# GPT-OSS (o200k_harmony)
O200K_PATTERN = "|".join([
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+"
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)?",
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*"
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)?",
    r"\p{N}{1,3}", r" ?[^\s\p{L}\p{N}]+[\r\n/]*", r"\s*[\r\n]+", r"\s+(?!\S)", r"\s+"])
# DeepSeek-V2's Split sequence (its letter class shortened to a few of its
# ranges), then Digits, then ByteLevel without its regex
DEEPSEEK_V2_SPLITS = [
    r"[\r\n]",
    r"\s?[A-Za-zµÀ-ÖØ-öø-ƺƼ-ƿǄ-ʓʕ-ʯͰ-ͳͶͷͻ-ͽͿΆΈ-ΊΌΎ-ΡΣ-ϵϷ-ҁҊ-ԯԱ-ՖႠ-ჅᎠ-Ᏽᏸ-ᏽ"
    r"Ა-ᲺᲽ-Ჿᴀ-ᴫᵫ-ᵷᵹ-ᶚḀ-ἕＡ-Ｚａ-ｚ𐐀-𐑏]+",
    r"\s?[!-/:-~！-／：-～‘-‟　-。]+",
    r"\s+$",
    r"[一-龥ࠀ-一가-퟿]+",
]
# DeepSeek-V3's Split sequence
DEEPSEEK_V3_SPLITS = [
    r"\p{N}{1,3}",
    r"[一-龥぀-ゟ゠-ヿ]+",
    r"[!\"#$%&'()*+,\-./:;<=>?@\[\\\]^_`{|}~][A-Za-z]+|[^\r\n\p{L}\p{P}\p{S}]?[\p{L}\p{M}]+"
    r"| ?[\p{P}\p{S}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
]

CHATML_TEMPLATE = (
    "{%- for message in messages %}"
    "{{- '<|im_start|>' + message['role'] + '\\n' + message['content'] + '<|im_end|>' + '\\n' }}"
    "{%- endfor %}"
    "{%- if add_generation_prompt %}"
    "{{- '<|im_start|>assistant\\n' }}"
    "{%- if enable_thinking is defined and enable_thinking is false %}"
    "{{- '<think>\\n\\n</think>\\n\\n' }}"
    "{%- endif %}"
    "{%- endif %}")

SHAPES = ("gpt2", "qwen", "o200k", "deepseek_v2", "deepseek_v3")
COMMITTED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_tokenizer")


def corpus(limit: int = 300_000) -> str:
    from krasis_tpu.prompts import load_domain

    return load_domain("docs")[:limit]


def train(shape: str, path: str, vocab_size: int = 1024, text: str | None = None,
          chat_template: str = CHATML_TEMPLATE) -> str:
    """Train a byte-level BPE of `shape` on the docs corpus and save it into
    `path` with `chat_template` and an EOS; returns `path`."""
    from tokenizers import AddedToken, Regex, Tokenizer, decoders, normalizers, processors
    from tokenizers import pre_tokenizers as pt
    from tokenizers.models import BPE
    from tokenizers.trainers import BpeTrainer
    from transformers import LlamaTokenizerFast, PreTrainedTokenizerFast

    raw = Tokenizer(BPE(unk_token=None))
    no_regex = pt.ByteLevel(add_prefix_space=False, use_regex=False, trim_offsets=False)
    splits = {"qwen": [QWEN_PATTERN], "o200k": [O200K_PATTERN],
              "deepseek_v2": DEEPSEEK_V2_SPLITS, "deepseek_v3": DEEPSEEK_V3_SPLITS}
    if shape == "gpt2":
        raw.pre_tokenizer = pt.ByteLevel(add_prefix_space=False)
    else:
        steps = [pt.Split(Regex(p), behavior="isolated", invert=False) for p in splits[shape]]
        if shape == "deepseek_v2":
            steps.append(pt.Digits(individual_digits=True))
        raw.pre_tokenizer = pt.Sequence(steps + [no_regex])
    if shape == "qwen":
        raw.normalizer = normalizers.NFC()
    raw.decoder = decoders.ByteLevel()
    raw.post_processor = processors.ByteLevel(trim_offsets=False)
    if shape.startswith("deepseek"):
        specials = ["<｜begin▁of▁sentence｜>", "<｜end▁of▁sentence｜>"]
        bos, eos = specials
    else:
        specials = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
        bos, eos = None, "<|im_end|>"
    trainer = BpeTrainer(vocab_size=vocab_size - 3, show_progress=False, special_tokens=specials,
                         initial_alphabet=pt.ByteLevel.alphabet())
    text = corpus() if text is None else text
    raw.train_from_iterator([text[i:i + 4096] for i in range(0, len(text), 4096)], trainer)
    # added tokens with each flag: a plain one (normalized), one that takes
    # the spaces around it, one that stands only as a word
    raw.add_tokens([AddedToken("<think>", normalized=False, special=False),
                    AddedToken("</think>", normalized=False, special=False),
                    AddedToken("[tool]", normalized=True),
                    AddedToken("<|sep|>", lstrip=True, rstrip=True, normalized=False),
                    AddedToken("qux", single_word=True, normalized=True)])
    if shape.startswith("deepseek"):
        tok = LlamaTokenizerFast(tokenizer_object=raw, bos_token=bos, eos_token=eos,
                                 add_bos_token=True, add_eos_token=False, legacy=True,
                                 chat_template=chat_template)
    else:
        tok = PreTrainedTokenizerFast(tokenizer_object=raw, eos_token=eos,
                                      pad_token="<|endoftext|>", chat_template=chat_template)
    tok.save_pretrained(path)
    return path


def write_committed(path: str = COMMITTED) -> str:
    """The committed test tokenizer: Qwen-style, 4096 ids, ChatML."""
    os.makedirs(path, exist_ok=True)
    train("qwen", path, vocab_size=4096)
    # the template inside tokenizer_config.json, as published files have it
    with open(os.path.join(path, "chat_template.jinja"), encoding="utf-8") as f:
        template = f.read()
    cfg_path = os.path.join(path, "tokenizer_config.json")
    with open(cfg_path, encoding="utf-8") as f:
        cfg = json.load(f)
    cfg["chat_template"] = template
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump(cfg, f, indent=2, ensure_ascii=False)
    for extra in ("chat_template.jinja", "special_tokens_map.json"):
        os.remove(os.path.join(path, extra))
    return path


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    print(write_committed())
