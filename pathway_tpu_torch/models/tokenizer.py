"""Deterministic hashing tokenizer (counterpart of
``pathway_tpu/models/tokenizer.py`` ``HashTokenizer``).

Words and punctuation hash into a fixed id space with XXH3-64 (seed 0).
The ids equal the reference's for every input.  As in the reference, a
non-empty all-ASCII batch without ``pairs`` is tokenized by one native
call (the port's own ``csrc/host/tokenize_hash.cc``, built with ``g++``
at first use by ``kernels/build.py`` and loaded with ``ctypes``; it
carries its own XXH3-64) and framed by vectorised numpy; every other
batch takes the Python path, with the hash from ``_xxh3`` so that no
``xxhash`` package is needed.  A failed build or load raises: it never
falls back to the Python path.  ``_encode_batch_ascii`` is the Python
version of the native path, which the tests hold it against.  Word ids
of the Python path are memoised in a bounded dict.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import config
from .. import native
from ..kernels.host import native_xxh3_64
from ._xxh3 import xxh3_64

__all__ = ["HashTokenizer", "native_xxh3_64"]

_WORD_RE = re.compile(r"[\w']+|[^\w\s]")

def _tokenize_native(texts: Sequence[str], vocab_size: int, reserved: int) -> Tuple[np.ndarray, np.ndarray]:
    """Word ids of an ASCII batch, flat, and each text's ``[start, end)``
    in them (``offsets [n + 1]``), by ``native.tokenize_hash``."""
    n = len(texts)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, texts), dtype=np.int64, count=n), out=offsets[1:])
    return native.tokenize_hash("".join(texts).encode("ascii"), offsets, vocab_size, reserved)


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
        if pairs is None and len(texts):
            texts_s = [t if isinstance(t, str) else str(t) for t in texts]
            # PATHWAY_TPU_DISABLE_NATIVE keeps to the Python path, as the
            # reference does when its native library is disabled
            if "".join(texts_s).isascii() and not config.get("native.disable"):
                return self._encode_batch_native(texts_s, max_length, pad_to)
        return self._encode_batch_python(texts, pairs, max_length, pad_to)

    def _encode_batch_native(
        self, texts: Sequence[str], max_length: int, pad_to: Optional[int]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """An ASCII batch by one native call, framed as the reference's
        ``_encode_batch_native``: at most ``L - 2`` word ids between CLS
        and SEP."""
        n = len(texts)
        tok_ids, tok_off = _tokenize_native(texts, self.vocab_size, self._RESERVED)
        trunc = np.minimum(np.diff(tok_off), max_length - 2)
        longest = int(trunc.max()) + 2
        L = pad_to or min(max_length, ((longest + 15) // 16) * 16)
        trunc = np.minimum(trunc, L - 2)
        ids = np.full((n, L), self.PAD, dtype=np.int32)
        total = int(trunc.sum())
        if total:
            starts = np.cumsum(trunc) - trunc
            pos = np.arange(total, dtype=np.int64) - np.repeat(starts, trunc)
            src = np.repeat(tok_off[:-1], trunc) + pos
            ids[np.repeat(np.arange(n), trunc), pos + 1] = tok_ids[src]
        ids[:, 0] = self.CLS
        ids[np.arange(n), trunc + 1] = self.SEP
        mask = (np.arange(L, dtype=np.int64)[None, :] < (trunc + 2)[:, None]).astype(np.int32)
        return ids, mask

    def _encode_batch_ascii(
        self, texts: Sequence[str], max_length: Optional[int] = None, pad_to: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The Python version of ``_encode_batch_native`` (the tests hold
        the native path against it)."""
        max_length = max_length or self.max_length
        if len(texts):
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
        return self._encode_batch_python(texts, None, max_length, pad_to)

    def _encode_batch_python(self, texts, pairs, max_length: int, pad_to: Optional[int]):
        """``encode`` per text, each row cut at ``L``, SEP and all."""
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
