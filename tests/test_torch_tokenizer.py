"""The port's tokenizer (runtime/tokenizer.py, utils/unicode_re.py) against
the reference's ``krasis_tpu.runtime.tokenizer.Tokenizer`` (transformers
over the ``tokenizers`` package), with no tolerance: the same ids from
``encode`` and the same text from ``decode``.

The tokenizers are byte-level BPEs trained here on the docs corpus, one for
each pre-tokenizer shape the supported families publish (GPT-2's
ByteLevel; Qwen2/3's Split + ByteLevel without its regex, with NFC;
GPT-OSS's o200k pattern; DeepSeek-V2's Split sequence with Digits and
DeepSeek-V3's, both with the BOS TemplateProcessing of
LlamaTokenizerFast), each with added tokens of every flag
(tests/torch_tokenizer_util.py). No published tokenizer.json is in the
repository; a test against one waits until such files are.

Python 3.12 has Unicode 15.0, the ``tokenizers`` package's Oniguruma a later
version: ``test_unicode_classes`` lists the code points classified
differently (all unassigned in 15.0)."""

import json
import os
import unicodedata

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from krasis_tpu.runtime.tokenizer import IncrementalDecoder as RefDecoder
from krasis_tpu.runtime.tokenizer import Tokenizer as RefTokenizer
from krasis_tpu_torch.runtime.tokenizer import IncrementalDecoder, Tokenizer
from krasis_tpu_torch.utils import unicode_re

from torch_tokenizer_util import COMMITTED, SHAPES, train

INPUTS = [
    "The os module provides a portable way of using operating system dependent functionality.",
    "def f(x):\n    return x ** 2  # square\n",
    "CJK 漢字テスト한국어 混合 中文字符串",
    "emoji 😀👍🏽 family 👨‍👩‍👧 flags 🇫🇷",
    "combining é ä ñ (NFD) and é ä ñ (NFC)",
    "عربي مرحبا بالعالم ١٢٣",
    "digits 1234567890 12 3 ٣٤ ½ ²",
    "ws   runs\t\t\n\n\n  x   ",
    "crlf\r\nline\r\n\r\n",
    "ctl a\x1cb\x1dc\x1e\x1fd",
    "nel a\x85b", "nbsp a\xa0b", "ideographic a　b",
    "I'M YOU'RE WE'LL THEY'D IT'S HE'S can't 'S 's",
    "special <|im_start|>user\nhi<|im_end|> and <think>x</think><|endoftext|>",
    "added [tool] here  <|sep|>  there qux quxes aqux qux_ (qux)",
    "<｜begin▁of▁sentence｜>bos inside<｜end▁of▁sentence｜>",
    "", " ", "\n",
    "ǅ ǈ Ǉ ǉ ℌ 𝔘 Ⅻ ſ ﬁ ß STRASSE",
    "x/y/z\n/ path/to/file.py:12",
]
IDS_BEYOND = [3, 200, 1023, 1024, 1025, 1031, 50000]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """{shape: (port tokenizer, reference tokenizer)}."""
    from torch_tokenizer_util import corpus

    text = corpus()
    out = {}
    for shape in SHAPES:
        path = train(shape, str(tmp_path_factory.mktemp(shape)), text=text)
        out[shape] = (Tokenizer(path), RefTokenizer(path))
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_encode_decode_match_reference(trained, shape):
    port, ref = trained[shape]
    for text in INPUTS:
        want = ref.encode(text)
        assert port.encode(text) == want, text
        for ids in (want, want + IDS_BEYOND, IDS_BEYOND):
            assert port.decode(ids) == ref.decode(ids), ids
    assert port.eos_token_id == ref.eos_token_id is not None


@pytest.mark.parametrize("shape", SHAPES)
def test_printable_unicode_matches_reference(trained, shape):
    """One seeded hypothesis run: text of any assigned character (controls
    and white space included), and id sequences anywhere in the vocabulary."""
    port, ref = trained[shape]

    @settings(max_examples=150, derandomize=True, deadline=None, database=None)
    @given(st.text(st.characters(exclude_categories=("Cs", "Cn", "Co")), max_size=40),
           st.lists(st.integers(0, 1100), max_size=12))
    def check(text, ids):
        assert port.encode(text) == ref.encode(text)
        assert port.decode(ids) == ref.decode(ids)

    check()


@pytest.mark.parametrize("shape", ["gpt2", "qwen"])
def test_incremental_decoder_streams_split_characters(trained, shape):
    """A multi-byte character spread over several tokens is held back until
    it is whole, as the reference's decoder does."""
    port, ref = trained[shape]
    text = "é€😀 漢字 👨‍👩‍👧"
    ids = ref.encode(text)
    assert len(ids) > len(text)            # some characters span tokens
    dec, rdec = IncrementalDecoder(port), RefDecoder(ref)
    deltas = [dec.push(t) for t in ids]
    assert deltas == [rdec.push(t) for t in ids]
    assert "" in deltas and "".join(deltas) == text


def test_committed_tokenizer_matches_reference():
    """The committed test tokenizer (served on the card): Qwen-style Split +
    NFC, 4096 ids, a ChatML template and an EOS in tokenizer_config.json."""
    files = sorted(os.listdir(COMMITTED))
    assert files == ["tokenizer.json", "tokenizer_config.json"]
    assert sum(os.path.getsize(os.path.join(COMMITTED, f)) for f in files) < 300_000
    port, ref = Tokenizer(COMMITTED), RefTokenizer(COMMITTED)
    spec = json.load(open(os.path.join(COMMITTED, "tokenizer.json")))
    assert spec["normalizer"]["type"] == "NFC" and len(spec["model"]["vocab"]) == 4093
    assert port.eos_token_id == ref.eos_token_id == 2
    for text in INPUTS:
        assert port.encode(text) == ref.encode(text)
        assert port.decode(ref.encode(text)) == ref.decode(ref.encode(text))
    msgs = [{"role": "system", "content": "You are terse."},
            {"role": "user", "content": "Explain the os module. 😀"}]
    assert port.apply_chat_template(msgs) == ref.apply_chat_template(msgs)


# Oniguruma patterns (as tokenizer.json gives them) and texts where Python's
# own reading of the pattern would differ
PATTERNS = [
    (r"\s+", "a\x1cb c\x85d　e\x1f f"),           # \s is White_Space, not str.isspace
    (r"\s+$", "a  \nb  \n c  "),                        # $ before every newline
    (r"^[a-z]", "ab\ncd\n"),                            # ^ after every newline
    (r"(?i:'s|'t|'re)", "IT'S it's 'ſ 'T 'RE"),
    (r"[^\s\p{L}\p{N}]+", "a!!\x1c b?? ½ ¼"),
    (r"\p{^L}+|\P{N}", "ab12cd"),
    (r"[\p{Lu}\p{Lt}]+[\p{Ll}\p{M}]*", "ǅemo HELLO Élan é"),
    (r"\d+|\h+", "٣٤x_y ab12 ³ Fe"),
    (r"\x{4E00}-\x{9FA5}|[一-龥]+", "汉字 かな"),
    (r"[!-/:-~！-／：-～‘-‟　-。]+", "a,b！？“x” 。"),
    (r" ?[\p{P}\p{S}]+[\r\n]*", "x+y = z!\n\n"),
    (r"\p{N}{1,3}", "1234567 ١٢٣٤"),
]


@pytest.mark.parametrize("pattern,text", PATTERNS)
def test_translated_pattern_matches_oniguruma(pattern, text):
    from tokenizers import Regex
    from tokenizers import pre_tokenizers as pt

    want = [s for s, _ in pt.Split(Regex(pattern), "isolated").pre_tokenize_str(text)]
    port = unicode_re.compile(pattern)
    from krasis_tpu_torch.runtime.tokenizer import find_matches, split_pieces
    assert split_pieces(text, find_matches(text, port), "Isolated") == want


@pytest.mark.parametrize("behavior", ["removed", "isolated", "merged_with_previous",
                                      "merged_with_next", "contiguous"])
@pytest.mark.parametrize("invert", [False, True])
def test_split_behaviors_match_tokenizers(behavior, invert):
    """Every Split behaviour and its inversion, against the tokenizers
    package's Split on the same text."""
    from tokenizers import Regex
    from tokenizers import pre_tokenizers as pt

    from krasis_tpu_torch.runtime.tokenizer import build_pre_tokenizer

    text = "  a,,b  c,d,, ,e  "
    want = [s for s, _ in pt.Split(Regex(r",| +"), behavior, invert).pre_tokenize_str(text)]
    name = "".join(w.capitalize() for w in behavior.split("_"))
    split = build_pre_tokenizer({"type": "Split", "pattern": {"Regex": r",| +"},
                                 "behavior": name, "invert": invert})
    assert split([text]) == want


def test_unicode_classes(tmp_path):
    """Each category class and \\s against Oniguruma's over planes 0-3 and
    14 (the others are unassigned or private in both): every code point
    classified differently is one Unicode 15.0 leaves unassigned, and their
    counts are listed here."""
    from tokenizers import Regex
    from tokenizers import pre_tokenizers as pt

    cps = [c for c in list(range(0x40000)) + list(range(0xE0000, 0xE1000))
           if not 0xD800 <= c <= 0xDFFF]
    text = "".join(map(chr, cps))
    differ = {}
    for name in ("L", "Lu", "Ll", "Lt", "Lm", "Lo", "M", "N", "P", "S", "s"):
        pattern = r"\s" if name == "s" else rf"\p{{{name}}}"
        split = pt.Split(Regex(pattern), behavior="removed", invert=True)
        onig = {s for s, _ in split.pre_tokenize_str(text)}
        port = set(unicode_re.compile(pattern).findall(text))
        diff = onig ^ port
        assert all(unicodedata.category(c) == "Cn" for c in diff), name
        assert port <= onig, name                      # none that Oniguruma lacks
        differ[name] = len(diff)
    assert unicodedata.unidata_version == "15.0.0"
    assert differ == {"L": 4924, "Lu": 27, "Ll": 25, "Lt": 0, "Lm": 7, "Lo": 4865, "M": 51,
                      "N": 80, "P": 13, "S": 744, "s": 0}


@pytest.mark.parametrize("change,feature", [
    (lambda s: s.update(pre_tokenizer={"type": "Metaspace", "replacement": "▁"}), "Metaspace"),
    (lambda s: s["model"].update(byte_fallback=True), "byte_fallback"),
    (lambda s: s["model"].update(unk_token="<unk>"), "unk_token"),
    (lambda s: s["model"].update(type="WordPiece"), "WordPiece"),
    (lambda s: s.update(decoder={"type": "Fuse"}), "Fuse"),
    (lambda s: s.update(normalizer={"type": "Precompiled", "precompiled_charsmap": ""}),
     "Precompiled"),
    (lambda s: s.update(pre_tokenizer={"type": "Split", "pattern": {"Regex": r"\p{Han}"},
                                       "behavior": "Isolated", "invert": False}), "Han"),
    (lambda s: s.update(pre_tokenizer={"type": "Split", "pattern": {"Regex": r"\w+"},
                                       "behavior": "Isolated", "invert": False}), "Alphabetic"),
])
def test_features_not_ported_raise(tmp_path, change, feature):
    spec = json.load(open(os.path.join(COMMITTED, "tokenizer.json")))
    change(spec)
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(NotImplementedError, match=feature):
        Tokenizer(str(tmp_path))
