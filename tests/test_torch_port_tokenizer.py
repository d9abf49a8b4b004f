"""The port's copy of the CLIP BPE tokenizer pinned to cgd_tpu's, with the
tiny synthetic merge table of tests/test_clip.py (the real
bpe_simple_vocab_16e6.txt.gz is not in the repository), and the standard
library's pre-tokenizer pattern (taken where the ``regex`` package is
missing) pinned to the ``regex`` one."""

import re

import numpy as np
import pytest

pytest.importorskip("torch")
regex = pytest.importorskip("regex")

from cgd_tpu.models.clip import tokenizer as jtok  # noqa: E402
from cgd_tpu_torch.models.clip import tokenizer as ttok  # noqa: E402

TEXTS = ["hello", "the and", "The cat AND the dog", "  HELLO\n\tthe ", "hello, world! 42x",
         "it's an inn<|endoftext|>ing", "a_b__c !? 3.14", "Café naïve &amp; ok", ""]


@pytest.fixture(scope="module")
def tiny_bpe(tmp_path_factory):
    path = tmp_path_factory.mktemp("bpe") / "merges.txt"
    merges = ["t h", "th e</w>", "a n", "an d</w>", "i n", "in g</w>",
              "h e", "he l", "hel l", "hell o</w>"]
    path.write_text("#version: tiny\n" + "\n".join(merges) + "\n")
    return str(path)


def _pair(path):
    return (jtok.SimpleTokenizer(path, vocab_limit=256 + 2 + 10),
            ttok.SimpleTokenizer(path, vocab_limit=256 + 2 + 10))


def test_vocab_and_merges_match(tiny_bpe):
    j, t = _pair(tiny_bpe)
    assert t.encoder == j.encoder and t.bpe_ranks == j.bpe_ranks
    assert (t.vocab_size, t.sot_token, t.eot_token) == (j.vocab_size, j.sot_token, j.eot_token)


@pytest.mark.parametrize("text", TEXTS)
def test_encode_decode_match(tiny_bpe, text):
    j, t = _pair(tiny_bpe)
    assert t.encode(text) == j.encode(text)
    assert t.decode(t.encode(text)) == j.decode(j.encode(text))


def test_tokenize_contract_matches(tiny_bpe):
    j, t = _pair(tiny_bpe)
    np.testing.assert_array_equal(t.tokenize(TEXTS, context_length=16),
                                  j.tokenize(TEXTS, context_length=16))
    np.testing.assert_array_equal(t.tokenize("hello " * 20, context_length=8, truncate=True),
                                  j.tokenize("hello " * 20, context_length=8, truncate=True))
    with pytest.raises(RuntimeError, match="too long"):
        t.tokenize("hello " * 20, context_length=8)


def test_gz_merge_table_and_the_default_tokenizer(tiny_bpe, tmp_path, monkeypatch):
    import gzip

    gz = tmp_path / "merges.txt.gz"
    with open(tiny_bpe, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    tok = ttok.SimpleTokenizer(str(gz), vocab_limit=268)
    assert tok.encode("hello the") == ttok.SimpleTokenizer(tiny_bpe, vocab_limit=268).encode(
        "hello the")
    monkeypatch.setattr(ttok, "_DEFAULT_TOKENIZER", tok)
    assert ttok.get_tokenizer() is tok


@pytest.mark.parametrize("text", TEXTS + ["x1y22 -- __ ¡hola! 5€"])
def test_the_stdlib_pattern_splits_like_the_regex_one(text):
    cleaned = ttok._clean_text(text)
    assert (re.compile(ttok._PAT_STDLIB, re.IGNORECASE).findall(cleaned)
            == regex.compile(ttok._PAT_UNICODE, regex.IGNORECASE).findall(cleaned))
    assert ttok._PAT.pattern == jtok._PAT.pattern  # with regex installed: the original's
