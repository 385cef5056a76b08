"""The port's own copy of ``hybridgl_tpu/lang/base.py``, kept verbatim apart from its
imports and build paths, so that the port imports nothing of the JAX package.

Expression-analysis contract shared by the spaCy and heuristic parsers.

Keyword sets mirror the reference (reference: utils.py:72-80, 198-205).
The parser output feeds the device pipeline as small integers (see
pipeline/guidance.py enums) plus the text strings to tokenize.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Protocol

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


class ExpressionParser(Protocol):
    def parse(self, sentence: str) -> ParsedExpression: ...
