"""CLIP byte-level BPE tokenizer for the plain reference.

Source: a frozen copy of the measured program's tokenizer
(``models/clip/tokenizer.py``, itself written from the BPE algorithm of
OpenAI CLIP's ``simple_tokenizer.py``), with its vocabulary search replaced
by the copy of OpenAI's merge table beside this file. It imports nothing of
the measured program.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import regex as re

CONTEXT_LENGTH = 77
VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bpe_simple_vocab_16e6.txt.gz")


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 style reversible byte->unicode map (avoids control chars)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    try:  # pragma: no cover - optional dependency
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return text.strip()


_WS_RE = re.compile(r"\s+")


def _whitespace_clean(text: str) -> str:
    return _WS_RE.sub(" ", text).strip()


class ClipTokenizer:
    """Byte-level BPE with the CLIP merge table."""

    def __init__(self, bpe_path: str | None = None):
        bpe_path = bpe_path or VOCAB
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # CLIP uses merges[1 : 49152-256-2+1]
        merge_lines = lines[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merge_lines]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
            r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
            re.IGNORECASE,
        )

    @property
    def sot_token(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot_token(self) -> int:
        return self.encoder["<|endoftext|>"]

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
            new_word: List[str] = []
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
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


_DEFAULT: ClipTokenizer | None = None


def default_tokenizer() -> ClipTokenizer:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = ClipTokenizer()
    return _DEFAULT


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = CONTEXT_LENGTH,
    truncate: bool = False,
    tokenizer: ClipTokenizer | None = None,
) -> np.ndarray:
    """Tokenize text(s) to a fixed [N, context_length] int32 array.

    Matches the reference's ``clip.tokenize`` semantics
    (reference: third_party/modified_CLIP/clip/clip.py:197-237), returning
    numpy (host-side; feed to the device text encoder).
    """
    if isinstance(texts, str):
        texts = [texts]
    tk = tokenizer or default_tokenizer()
    sot, eot = tk.sot_token, tk.eot_token
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [sot] + tk.encode(text) + [eot]
        if len(tokens) > context_length:
            if truncate:
                tokens = tokens[:context_length]
                tokens[-1] = eot
            else:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length {context_length}"
                )
        result[i, : len(tokens)] = tokens
    return result
