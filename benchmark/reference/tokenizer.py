"""CLIP byte-pair-encoding tokenizer, a frozen copy for the reference.

OpenAI CLIP's tokenizer (simple_tokenizer.py): the merge table
``bpe_simple_vocab_16e6.txt.gz``, the byte alphabet, SOT/EOT and the
77-token zero-padded output. The merge table is read as data from the
program's ``clip/`` folder, the one file both sides read; nothing of the
program is imported.
"""
from __future__ import annotations

import functools
import gzip
import html
import os
import re as _std_re
from typing import List, Union

import numpy as np

_FALLBACK_PATTERN = _std_re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+""",
    _std_re.IGNORECASE | _std_re.UNICODE,
)
try:
    import regex as _re

    _TOKEN_PATTERN = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:
    _TOKEN_PATTERN = _FALLBACK_PATTERN

try:
    import ftfy

    def _fix_text(text: str) -> str:
        return ftfy.fix_text(text)

except ImportError:

    def _fix_text(text: str) -> str:
        return text


_VOCAB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                           "semantic_abstraction_tpu_torch", "clip",
                           "bpe_simple_vocab_16e6.txt.gz")
CONTEXT_LENGTH = 77
SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"


def _bytes_to_unicode():
    """GPT-2 style reversible byte <-> printable-unicode mapping."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    codepoints = printable[:]
    offset = 0
    for b in range(256):
        if b not in printable:
            codepoints.append(256 + offset)
            offset += 1
    ordered_bytes = printable + [b for b in range(256) if b not in printable]
    return dict(zip(ordered_bytes, (chr(c) for c in codepoints)))


def _clean_text(text: str) -> str:
    text = _fix_text(text)
    text = html.unescape(html.unescape(text))
    text = " ".join(text.split())
    return text.strip().lower()


class ClipTokenizer:
    def __init__(self, vocab_path: str = _VOCAB_PATH):
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            merge_lines = f.read().split("\n")
        # line 0 is a version header; CLIP uses merges [1 : 49152-256-2+1]
        merges = [tuple(line.split()) for line in merge_lines[1 : 49152 - 256 - 2 + 1]]
        alphabet = list(self.byte_encoder.values())
        vocab = alphabet + [ch + "</w>" for ch in alphabet]
        vocab.extend("".join(m) for m in merges)
        vocab.extend([SOT_TOKEN, EOT_TOKEN])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.merge_ranks = {m: i for i, m in enumerate(merges)}
        self._bpe_cache = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}

    @property
    def sot_token(self) -> int:
        return self.encoder[SOT_TOKEN]

    @property
    def eot_token(self) -> int:
        return self.encoder[EOT_TOKEN]

    def _bpe(self, token: str) -> str:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.merge_ranks.get(p, float("inf")))
            if best not in self.merge_ranks:
                break
            first, second = best
            merged = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        result = " ".join(word)
        self._bpe_cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        for chunk in _TOKEN_PATTERN.findall(_clean_text(text)):
            mapped = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self._bpe(mapped).split(" "))
        return tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache(maxsize=1)
def default_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(
    texts: Union[str, List[str]],
    context_length: int = CONTEXT_LENGTH,
    truncate: bool = False,
) -> np.ndarray:
    """Tokenize to an (N, context_length) int32 array, zero-padded.

    Matches reference ``tokenize`` (clip_explainability.py:237-273): SOT +
    BPE tokens + EOT, errors on overflow unless ``truncate``.
    """
    if isinstance(texts, str):
        texts = [texts]
    tok = default_tokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [tok.sot_token] + tok.encode(text) + [tok.eot_token]
        if len(tokens) > context_length:
            if truncate:
                tokens = tokens[:context_length]
                tokens[-1] = tok.eot_token
            else:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length {context_length}"
                )
        result[i, : len(tokens)] = tokens
    return result
