r"""CLIP BPE tokenizer, a copy of ``cgd_tpu/models/clip/tokenizer.py``
(pinned to it by tests/test_torch_port_tokenizer.py).

Byte-level BPE over the 16e6 merge table, 49408-token vocab with
``<|startoftext|>``/``<|endoftext|>`` specials, 77-token context, lowercasing
and whitespace cleanup; ftfy text fixing when the library is available.

The merge table (``bpe_simple_vocab_16e6.txt.gz``) is not in the repository;
``get_tokenizer`` looks for it in the checkpoint cache and downloads it
there if it is missing, as the JAX package does. Without the ``regex``
package the pre-tokenizer pattern is the standard library's equivalent
(Unicode word characters that are not digits for ``\p{L}``, decimal digits
for ``\p{N}``), which splits ASCII text the same.
"""

from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from typing import List, Sequence, Union

import numpy as np

# the pre-tokenizer: with the regex package's Unicode classes, and the
# standard library's equivalent (letters: word characters that are not
# digits or '_'; numbers: decimal digits; the rest: neither space nor word
# character, or '_')
_PAT_UNICODE = r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
_PAT_STDLIB = r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+"""

try:
    import regex as re

    _PAT_SRC = _PAT_UNICODE
except ImportError:
    import re  # type: ignore

    _PAT_SRC = _PAT_STDLIB

try:
    import ftfy

    _HAS_FTFY = True
except ImportError:
    _HAS_FTFY = False

BPE_VOCAB_URL = (
    "https://github.com/openai/CLIP/raw/main/clip/bpe_simple_vocab_16e6.txt.gz"
)

_PAT = re.compile(_PAT_SRC, re.IGNORECASE)


@lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> printable-unicode map (GPT-2/CLIP convention)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _clean_text(text: str) -> str:
    if _HAS_FTFY:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


class SimpleTokenizer:
    def __init__(self, bpe_path: str, vocab_limit: int = 49152):
        """``bpe_path``: path to bpe_simple_vocab_16e6.txt.gz (or plain txt).

        ``vocab_limit`` exists so tests can use tiny synthetic merge tables;
        the real file yields the canonical 49408-entry vocab.
        """
        if bpe_path.endswith(".gz"):
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
        else:
            with open(bpe_path, encoding="utf-8") as f:
                lines = f.read().split("\n")
        merges = lines[1 : vocab_limit - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        for token in re.findall(_PAT, _clean_text(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        data = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(
        self,
        texts: Union[str, Sequence[str]],
        context_length: int = 77,
        truncate: bool = False,
    ) -> np.ndarray:
        """Batch-tokenize to an int32 [N, context_length] array (the
        ``clip.tokenize`` contract: SOT + tokens + EOT, zero padding,
        RuntimeError on overflow unless truncate)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(tokens) > context_length:
                if truncate:
                    tokens = tokens[:context_length]
                    tokens[-1] = self.eot_token
                else:
                    raise RuntimeError(
                        f"Input {text!r} is too long for context length {context_length}"
                    )
            out[i, : len(tokens)] = tokens
        return out


_DEFAULT_TOKENIZER = None


def get_tokenizer(bpe_path: str = None) -> SimpleTokenizer:
    """Load (and cache) the default tokenizer, downloading the merge table
    into the checkpoint cache if needed."""
    global _DEFAULT_TOKENIZER
    if _DEFAULT_TOKENIZER is not None and bpe_path is None:
        return _DEFAULT_TOKENIZER
    if bpe_path is None:
        from cgd_tpu_torch.io_utils.download import CACHE_PATH, download

        bpe_path = os.path.join(CACHE_PATH, "bpe_simple_vocab_16e6.txt.gz")
        if not os.path.exists(bpe_path):
            download(BPE_VOCAB_URL, "bpe_simple_vocab_16e6.txt.gz", root=CACHE_PATH)
    tok = SimpleTokenizer(bpe_path)
    if _DEFAULT_TOKENIZER is None:
        _DEFAULT_TOKENIZER = tok
    return tok


def tokenize(texts, context_length: int = 77, truncate: bool = False) -> np.ndarray:
    return get_tokenizer().tokenize(texts, context_length, truncate)
