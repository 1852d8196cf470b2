"""Deterministic hashing tokenizer (counterpart of
``pathway_tpu/models/tokenizer.py`` ``HashTokenizer``).

Words and punctuation hash into a fixed id space with XXH3-64 (seed 0).
The ids equal the reference's for every input: its C++ batch scanner is
bit-identical to its Python path on ASCII text, and this port follows
the Python path, with the hash from ``_xxh3`` so that no ``xxhash``
package is needed.  Word ids are memoised in a bounded dict, since a
serve batch of 64 queries tokenizes thousands of words.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ._xxh3 import xxh3_64

__all__ = ["HashTokenizer"]

_WORD_RE = re.compile(r"[\w']+|[^\w\s]")


class HashTokenizer:
    PAD = 0
    CLS = 1
    SEP = 2
    UNK = 3
    _RESERVED = 8
    _MEMO_MAX = 1 << 20

    def __init__(self, vocab_size: int = 32768, max_length: int = 128):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self._memo: Dict[str, int] = {}

    def _word_id(self, word: str) -> int:
        wid = self._memo.get(word)
        if wid is None:
            h = xxh3_64(word.lower().encode())
            wid = self._RESERVED + (h % (self.vocab_size - self._RESERVED))
            if len(self._memo) >= self._MEMO_MAX:
                self._memo.clear()
            self._memo[word] = wid
        return wid

    def tokenize(self, text: str) -> List[int]:
        return [self._word_id(w) for w in _WORD_RE.findall(str(text))]

    def count_tokens(self, text: str) -> int:
        return len(_WORD_RE.findall(str(text)))

    def encode(
        self, text: str, pair: str | None = None, max_length: int | None = None
    ) -> List[int]:
        max_length = max_length or self.max_length
        if pair is None:
            ids = [self.CLS] + self.tokenize(text)
            return ids[: max_length - 1] + [self.SEP]
        # sentence pairs truncate longest-first, so both segments keep
        # tokens
        a = self.tokenize(text)
        b = self.tokenize(pair)
        budget = max(max_length - 3, 2)
        while len(a) + len(b) > budget:
            if len(a) >= len(b) and len(a) > 1:
                a.pop()
            elif len(b) > 1:
                b.pop()
            else:
                break
        return [self.CLS] + a + [self.SEP] + b + [self.SEP]

    def encode_batch(
        self,
        texts: Sequence[str],
        pairs: Sequence[str] | None = None,
        max_length: int | None = None,
        pad_to: int | None = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (ids [B, L], mask [B, L]) int32, padded to a shared
        length: ``pad_to``, else the longest row rounded up to a multiple
        of 16 and capped at ``max_length``.

        Single texts are framed as the reference frames them.  An ASCII
        batch goes the way of its batch scanner: at most ``L - 2`` word ids
        between CLS and SEP, so a row cut by a short ``pad_to`` still ends
        in SEP.  A batch with any non-ASCII text goes the way of its
        Python path: ``encode`` per text, then the row is cut at ``L``,
        SEP and all."""
        max_length = max_length or self.max_length
        if pairs is None and len(texts) and "".join(map(str, texts)).isascii():
            words = [self.tokenize(t)[: max_length - 2] for t in texts]
            longest = max(len(w) for w in words) + 2
            L = pad_to or min(max_length, ((longest + 15) // 16) * 16)
            ids = np.full((len(words), L), self.PAD, dtype=np.int32)
            mask = np.zeros((len(words), L), dtype=np.int32)
            for i, w in enumerate(words):
                w = w[: L - 2]
                ids[i, 0] = self.CLS
                ids[i, 1 : len(w) + 1] = w
                ids[i, len(w) + 1] = self.SEP
                mask[i, : len(w) + 2] = 1
            return ids, mask
        encoded = [
            self.encode(t, pairs[i] if pairs is not None else None, max_length)
            for i, t in enumerate(texts)
        ]
        longest = max((len(e) for e in encoded), default=1)
        L = pad_to or min(max_length, ((longest + 15) // 16) * 16)
        ids = np.full((len(encoded), L), self.PAD, dtype=np.int32)
        mask = np.zeros((len(encoded), L), dtype=np.int32)
        for i, e in enumerate(encoded):
            e = e[:L]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return ids, mask
