"""Deterministic hash tokenizer (copy of radzero_tpu/data/tokenizer.py:
WhitespaceHashTokenizer), so the serving path needs no radzero_tpu import.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class WhitespaceHashTokenizer:
    """<s> tok* </s> padded with pad=1; each word is FNV-1a hashed into
    the vocabulary above the three special ids."""

    bos, pad, eos = 0, 1, 2

    def __init__(self, vocab_size: int = 30527, max_length: int = 64):
        self.vocab_size = vocab_size
        self.max_length = max_length

    def _tok(self, word: str) -> int:
        h = 2166136261
        for ch in word.encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return 3 + (h % (self.vocab_size - 3))

    def __call__(self, texts: List[str], max_length: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
        L = max_length or self.max_length
        ids = np.full((len(texts), L), self.pad, np.int32)
        mask = np.zeros((len(texts), L), np.int32)
        for i, t in enumerate(texts):
            toks = [self.bos] + [self._tok(w) for w in t.lower().split()][: L - 2] + [self.eos]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask
