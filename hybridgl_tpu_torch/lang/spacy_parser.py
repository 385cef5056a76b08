"""The port's own copy of ``hybridgl_tpu/lang/spacy_parser.py``, kept verbatim apart from its
imports and build paths, so that the port imports nothing of the JAX package.

spaCy-backed expression parser (behaviour-parity with the reference).

Reproduces the dependency-parse semantics of the reference's utilities
(reference: utils.py:31-133, 207-237), including — behind
``rela_right_bug`` — the reference's comparison of a token against the
*set* ``RIGHT_KEYWORDS`` (utils.py:219), which makes the "right" relation
flag unreachable.

spaCy is an optional dependency; use ``lang.get_parser()`` to fall back to
the heuristic parser automatically.
"""

from __future__ import annotations

from . import base
from .base import ParsedExpression


class SpacyParser:
    def __init__(self, model: str = "en_core_web_lg", rela_right_bug: bool = True):
        import spacy  # deferred; optional dependency

        self.nlp = spacy.load(model)
        self.rela_right_bug = rela_right_bug

    # -- reference: utils.py:31-70 -----------------------------------------
    def _noun_phrase(self, doc):
        chunks, chunks_index = {}, {}
        for chunk in doc.noun_chunks:
            for i in range(chunk.start, chunk.end):
                chunks[i] = chunk
                chunks_index[i] = (chunk.start, chunk.end)
        head = None
        for token in doc:
            if token.head.i == token.i:
                head = token.head
        if head is None or head.i not in chunks:
            children = list(head.children) if head is not None else []
            if children and children[0].i in chunks:
                head = children[0]
            else:
                return doc.text, doc.text
        head_noun = head.text
        return chunks[head.i].text, head_noun

    # -- reference: utils.py:82-100 ----------------------------------------
    def _other_nouns(self, doc, head_phrase):
        phrases, nouns = [], []
        for chunk in doc.noun_chunks:
            if chunk.text == head_phrase or chunk.root.text in base.RELATION_WORDS:
                continue
            phrases.append(chunk.text)
            nouns.append(chunk.root.text)
        return phrases, nouns

    # -- reference: utils.py:102-133 ----------------------------------------
    def _dir_flag(self, doc):
        dirflag, deep = "none", 999
        table = [
            ("left", base.DIR_LEFT),
            ("right", base.DIR_RIGHT),
            ("middle", base.DIR_MIDDLE),
            ("up", base.DIR_UP),
            ("down", base.DIR_DOWN),
        ]
        for token in doc:
            for name, words in table:
                if token.text in words and token.head.i < deep:
                    dirflag, deep = name, token.head.i
                    break
        return dirflag

    # -- reference: utils.py:207-237 ----------------------------------------
    def _rela_flag(self, doc, nouns):
        if set(nouns) & base.NULL_KEYWORDS:
            return "none"
        relaflag, deep = "none", 999
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
        for token in doc:
            for name, words in table:
                if token.text in words and token.head.i < deep:
                    relaflag, deep = name, token.head.i
                    break
        return relaflag

    def parse(self, sentence: str) -> ParsedExpression:
        sentence = sentence.lower()
        doc = self.nlp(sentence)
        # whitespace-token scrub (reference: Hybridgl_main.py:135-142)
        clean = " ".join(t.text for t in doc if t.text != " ")
        doc = self.nlp(clean)
        noun_phrase, head_noun = self._noun_phrase(doc)
        other_phrases, nouns = self._other_nouns(doc, noun_phrase)
        return ParsedExpression(
            sentence=clean,
            noun_phrase=noun_phrase,
            head_noun=head_noun,
            other_noun_phrases=other_phrases,
            nouns=nouns,
            dir_flag=self._dir_flag(doc),
            rela_flag=self._rela_flag(doc, nouns),
        )
