"""The port's prompt corpus (krasis_tpu_torch/prompts.py) against the JAX
package's: the same files from the same machine text, the same hash ids and
prompt ids on every domain, and an error where the reference would loop
forever (a domain with no text). Every corpus goes to a temporary directory:
the JAX package's default one is under benchmarks/, which these tests
neither read nor write."""

import os

import pytest

import krasis_tpu.prompts as jp
import krasis_tpu_torch.prompts as tp

TARGET = 20_000
DOMAINS = jp.DOMAINS + (jp.WARMUP_DOMAIN,)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_prompts"))
    pdir = str(tmp_path_factory.mktemp("torch_prompts"))
    return jp.build_corpus(jdir, target_bytes=TARGET), tp.build_corpus(pdir, target_bytes=TARGET)


def test_domains_are_the_reference_ones():
    assert tp.DOMAINS == jp.DOMAINS and tp.WARMUP_DOMAIN == jp.WARMUP_DOMAIN
    assert tp.TARGET_BYTES == jp.TARGET_BYTES


@pytest.mark.parametrize("domain", DOMAINS)
def test_corpus_files_are_byte_equal(corpora, domain):
    jpaths, ppaths = corpora
    with open(jpaths[domain], "rb") as f:
        want = f.read()
    with open(ppaths[domain], "rb") as f:
        got = f.read()
    assert got == want
    assert os.path.basename(ppaths[domain]) == f"{domain}.txt"


@pytest.mark.parametrize("domain", DOMAINS)
@pytest.mark.parametrize("vocab", [2048, 102400])
def test_hash_ids_and_prompt_ids_match(corpora, monkeypatch, domain, vocab):
    jpaths, ppaths = corpora
    jdir, pdir = os.path.dirname(jpaths[domain]), os.path.dirname(ppaths[domain])
    text = tp.load_domain(domain, pdir)
    if not text:
        pytest.skip(f"no {domain} text on this machine")
    assert tp.hash_tokenize(text, vocab) == jp.hash_tokenize(text, vocab)
    assert tp.hash_tokenize(text, vocab, n=300) == jp.hash_tokenize(text, vocab, n=300)
    load = jp.load_domain
    monkeypatch.setattr(jp, "load_domain", lambda d, out_dir=jdir: load(d, out_dir))
    for n in (64, 5000, 3 * len(tp.hash_tokenize(text, vocab)) + 7):   # the last repeats
        assert tp.prompt_ids(domain, n, vocab, out_dir=pdir) == jp.prompt_ids(domain, n, vocab)


def test_default_corpus_dir_is_under_home(monkeypatch, tmp_path):
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path))
    assert tp.corpus_dir() == os.path.join(str(tmp_path), "prompts_torch")
    assert "benchmarks" not in tp.corpus_dir()


def test_empty_domain_raises_naming_its_source(monkeypatch, tmp_path):
    """A machine without /usr/share/doc: the legal domain's glob matches no
    file, its text is empty, and prompt_ids raises (the reference's loop
    never ends, so the JAX function is not called)."""
    missing = str(tmp_path / "no_such_doc" / "*" / "copyright")
    monkeypatch.setattr(tp, "_LEGAL_GLOB", missing)
    out = str(tmp_path / "corpus")
    tp.build_corpus(out, target_bytes=TARGET)
    assert tp.load_domain("legal", out) == ""
    with pytest.raises(ValueError, match="legal") as e:
        tp.prompt_ids("legal", 16, 2048, out_dir=out)
    assert missing in str(e.value)
    assert len(tp.prompt_ids("code", 16, 2048, out_dir=out)) == 16
