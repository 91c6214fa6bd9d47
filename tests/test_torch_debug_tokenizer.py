"""debug_tokenizer (krasis_tpu_torch/debug_tokenizer.py) against the
reference's krasis_tpu/debug_tokenizer.py on the committed test tokenizer
(tests/data/torch_tokenizer): the port's own byte-level BPE prints the
fields the reference prints through transformers (vocab size, template
present, eos, the templated ids and their decode, the plain encode and its
round trip) with the same values; the tokenizer class is the port's, and
the versions are Python's and torch's."""

import sys

import pytest

from krasis_tpu import debug_tokenizer as jdebug
from krasis_tpu_torch import debug_tokenizer

from torch_tokenizer_util import COMMITTED

FIELDS = ("vocab size:", "has chat_template:", "eos:", "templated ids:", "decoded:",
          "plain encode:", "round trip:")


def _fields(text):
    return [line for line in text.splitlines() if line.startswith(FIELDS)]


@pytest.mark.parametrize("prompt,thinking", [
    ("hello", False), ("Hi there, what's 2+2?", False), ("éèê 中文 \U0001f600 tabs\tand\nlines", False),
    ("think about it", True)])
def test_fields_equal_the_reference_s(monkeypatch, capsys, prompt, thinking):
    argv = [str(COMMITTED), "--prompt", prompt] + (["--thinking"] if thinking else [])
    monkeypatch.setattr(sys, "argv", ["debug_tokenizer", *argv])
    jdebug.main()
    want = capsys.readouterr().out
    debug_tokenizer.main(argv)
    got = capsys.readouterr().out
    assert _fields(got) == _fields(want) and len(_fields(got)) == len(FIELDS)
    assert "tokenizer class: Tokenizer" in got
    assert "torch:" in got and "python:" in got and "transformers" not in got
