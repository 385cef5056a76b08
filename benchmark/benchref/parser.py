"""The rule-based expression parser, for the plain reference.

Source: a frozen copy of the measured program's heuristic parser
(``lang/heuristic.py`` with the keyword sets and result type of
``lang/base.py``, which mirror the reference's ``utils.py:72-80, 198-205``):
noun chunks, the head noun phrase, the other noun phrases and the direction
and relation flags. It imports nothing of the measured program.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Tuple

RELATION_WORDS = {
    "left", "west",
    "right", "east",
    "above", "north", "top", "back", "behind",
    "below", "south", "under", "front",
    "bigger", "larger",
    "closer", "smaller", "tinier", "further",
    "inside", "within", "contained",
    "who", "what", "which",
    "middle",
}

NULL_KEYWORDS = {"part", "image", "side", "picture", "half", "region", "section", "photo"}
LEFT_KEYWORDS = {"left", "west"}
RIGHT_KEYWORDS = {"right", "east"}
UP_KEYWORDS = {"above", "north", "top", "back", "behind"}
DOWN_KEYWORDS = {"below", "south", "under", "front"}
BIG_KEYWORDS = {"bigger", "larger", "closer"}
SMALL_KEYWORDS = {"smaller", "tinier", "further", "smallest"}
WITHIN_KEYWORDS = {"inside", "within", "contained"}

DIR_LEFT = {"left"}
DIR_RIGHT = {"right"}
DIR_MIDDLE = {"middle", "between"}
DIR_UP = {"up", "top", "above"}
DIR_DOWN = {"down", "under", "bottom", "low"}


@dataclass
class ParsedExpression:
    """Everything the scoring pipeline needs from one referring expression."""

    sentence: str  # whitespace-normalised sentence
    noun_phrase: str  # head noun phrase (falls back to the sentence)
    head_noun: str
    other_noun_phrases: List[str] = field(default_factory=list)
    nouns: List[str] = field(default_factory=list)  # roots of other NPs
    dir_flag: str = "none"  # DIR_FLAGS name
    rela_flag: str = "none"  # RELA_FLAGS name

    @property
    def has_other_nouns(self) -> bool:
        return len(self.nouns) > 0


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
            while (s, e) and tokens[e - 1] in RELATION_WORDS and len(chunks) > 1:
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
            if root in RELATION_WORDS or root in NON_NOUN:
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
            ("left", DIR_LEFT),
            ("right", DIR_RIGHT),
            ("middle", DIR_MIDDLE),
            ("up", DIR_UP),
            ("down", DIR_DOWN),
        ]
        for t in tokens:
            for name, words in table:
                if t in words:
                    return name
        return "none"

    def _rela_flag(self, tokens, nouns):
        if set(nouns) & NULL_KEYWORDS:
            return "none"
        right_words = set() if self.rela_right_bug else RIGHT_KEYWORDS
        table = [
            ("left", LEFT_KEYWORDS),
            ("right", right_words),
            ("up", UP_KEYWORDS),
            ("down", DOWN_KEYWORDS),
            ("big", BIG_KEYWORDS),
            ("small", SMALL_KEYWORDS),
            ("within", WITHIN_KEYWORDS),
        ]
        for t in tokens:
            for name, words in table:
                if t in words:
                    return name
        return "none"
