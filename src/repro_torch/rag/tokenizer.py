"""Deterministic hash tokenizer — a self-contained stand-in for the models'
BPE vocabularies (no external assets in this container).

Word-level with stable hashing into the configured vocab; reserves ids for
special tokens.  Round-trip fidelity is not needed by any experiment (RAG
quality is not the evaluated metric — latency is); what matters is stable,
length-preserving tokenization so workload sizes are realistic.
"""
from __future__ import annotations

import hashlib
import re
from typing import List

PAD, BOS, EOS, SEP = 0, 1, 2, 3
_SPECIALS = 4
_WORD_RE = re.compile(r"\w+|[^\w\s]")


class HashTokenizer:
    def __init__(self, vocab_size: int = 32000):
        assert vocab_size > _SPECIALS
        self.vocab_size = vocab_size

    def _tok(self, w: str) -> int:
        h = int.from_bytes(hashlib.blake2s(w.encode(), digest_size=4).digest(),
                           "little")
        return _SPECIALS + h % (self.vocab_size - _SPECIALS)

    def encode(self, text: str, *, bos: bool = False,
               eos: bool = False) -> List[int]:
        ids = [self._tok(w) for w in _WORD_RE.findall(text)]
        if bos:
            ids = [BOS] + ids
        if eos:
            ids = ids + [EOS]
        return ids

    def count(self, text: str) -> int:
        return len(_WORD_RE.findall(text))
