"""The port's own copy of ``hybridgl_tpu/lang/heuristic.py``, kept verbatim apart from its
imports and build paths, so that the port imports nothing of the JAX package.

Dependency-free heuristic expression parser.

A rule-based fallback when spaCy isn't installed: regex tokenisation, a
small closed-class grammar for noun chunking (articles / adjectives before
a noun head, chunks split at prepositions and relative markers), and
first-occurrence keyword scans for the direction / relation flags (the
reference picks the token whose *head* is shallowest — without a parse we
approximate with leftmost occurrence, which agrees on the short RefCOCO
expressions in the common case).

Accuracy parity with the reference requires the spaCy parser
(lang/spacy_parser.py); this module keeps the full pipeline runnable —
and deterministic to test — anywhere.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from . import base
from .base import ParsedExpression

_TOKEN_RE = re.compile(r"[a-z0-9']+|[^\sa-z0-9']")

# words that terminate / split noun chunks
PREPOSITIONS = {
    "of", "in", "on", "at", "by", "with", "near", "under", "over", "behind",
    "above", "below", "beside", "between", "against", "across", "from", "to",
    "next", "inside", "outside", "front", "back", "atop", "around", "holding",
    "wearing", "sitting", "standing", "looking", "facing", "riding", "carrying",
}
DETERMINERS = {"the", "a", "an", "this", "that", "these", "those", "its", "his",
               "her", "their", "my", "your", "our", "some", "any", "no"}
CONJUNCTIONS = {"and", "or", "but", "that", "who", "which", "whose", "is", "are",
                "was", "were", "has", "have", "had", "not"}
NON_NOUN = (
    PREPOSITIONS
    | DETERMINERS
    | CONJUNCTIONS
    | {"very", "most", "more", "closest", "farthest", "nearest"}
)


def tokenize(sentence: str) -> List[str]:
    return _TOKEN_RE.findall(sentence.lower())


def noun_chunks(tokens: List[str]) -> List[Tuple[int, int]]:
    """Greedy chunker: maximal runs of non-splitting tokens ending at a
    plausible noun (the run's last token)."""
    chunks = []
    start = None
    for i, t in enumerate(tokens):
        splitter = t in PREPOSITIONS or t in CONJUNCTIONS or not t.isalnum()
        if splitter:
            if start is not None:
                chunks.append((start, i))
                start = None
        else:
            if start is None:
                start = i
    if start is not None:
        chunks.append((start, len(tokens)))
    # strip leading determiners; drop empty/determiner-only chunks
    out = []
    for s, e in chunks:
        while s < e and tokens[s] in DETERMINERS:
            s += 1
        if s < e:
            out.append((s, e))
    return out


class HeuristicParser:
    def __init__(self, rela_right_bug: bool = True):
        self.rela_right_bug = rela_right_bug

    def parse(self, sentence: str) -> ParsedExpression:
        sentence = sentence.lower()
        tokens = tokenize(sentence)
        clean = " ".join(tokens)
        chunks = noun_chunks(tokens)

        if chunks:
            s, e = chunks[0]
            # head chunk = first chunk; drop pure relation-word chunks
            while (s, e) and tokens[e - 1] in base.RELATION_WORDS and len(chunks) > 1:
                chunks = chunks[1:]
                s, e = chunks[0]
            noun_phrase = " ".join(tokens[s:e])
            head_noun = tokens[e - 1]
            rest = chunks[1:]
        else:
            noun_phrase, head_noun, rest = clean, clean, []

        other_phrases, nouns = [], []
        for s, e in rest:
            root = tokens[e - 1]
            if root in base.RELATION_WORDS or root in NON_NOUN:
                continue
            phrase = " ".join(tokens[s:e])
            if phrase == noun_phrase:
                continue
            other_phrases.append(phrase)
            nouns.append(root)

        return ParsedExpression(
            sentence=clean,
            noun_phrase=noun_phrase,
            head_noun=head_noun,
            other_noun_phrases=other_phrases,
            nouns=nouns,
            dir_flag=self._dir_flag(tokens),
            rela_flag=self._rela_flag(tokens, nouns),
        )

    def _dir_flag(self, tokens):
        table = [
            ("left", base.DIR_LEFT),
            ("right", base.DIR_RIGHT),
            ("middle", base.DIR_MIDDLE),
            ("up", base.DIR_UP),
            ("down", base.DIR_DOWN),
        ]
        for t in tokens:
            for name, words in table:
                if t in words:
                    return name
        return "none"

    def _rela_flag(self, tokens, nouns):
        if set(nouns) & base.NULL_KEYWORDS:
            return "none"
        right_words = set() if self.rela_right_bug else base.RIGHT_KEYWORDS
        table = [
            ("left", base.LEFT_KEYWORDS),
            ("right", right_words),
            ("up", base.UP_KEYWORDS),
            ("down", base.DOWN_KEYWORDS),
            ("big", base.BIG_KEYWORDS),
            ("small", base.SMALL_KEYWORDS),
            ("within", base.WITHIN_KEYWORDS),
        ]
        for t in tokens:
            for name, words in table:
                if t in words:
                    return name
        return "none"
