"""WordPiece tokenizer over a BERT ``vocab.txt`` (counterpart of
``pathway_tpu/models/wordpiece.py``: ``WordPieceTokenizer`` with
``_clean``, ``_basic_tokenize``, ``_is_punctuation`` and ``_is_cjk``; the
port keeps its own copy, since it imports nothing of the JAX package).

BERT basic tokenization (control characters dropped, CJK ideographs
isolated, punctuation split, optional lowercasing with accents stripped),
then greedy longest-match-first WordPiece with the ``##`` continuation
prefix.  Token ids equal ``transformers.BertTokenizer``'s on the same
vocab.  Points where a result could drift:

- ids are line numbers; a blank line keeps its number but maps no token,
  and ``vocab_size`` is the largest id + 1;
- a word longer than ``max_chars_per_word``, or with no matching piece,
  becomes one ``[UNK]``;
- a pair truncates longest-first to ``max_length - 3`` tokens;
- ``encode_batch`` pads to ``min(max_length, 16 * ceil(longest / 16))``.
"""

from __future__ import annotations

import os
import unicodedata
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["WordPieceTokenizer"]


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    """CJK unified ideograph ranges (BERT tokenizes these per character)."""
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


def _clean(text: str) -> str:
    """BERT text cleanup: tab/newline/CR become spaces, other control chars
    and NUL are dropped, CJK chars get space-isolated so they tokenize per
    character (mirrors BertTokenizer's _clean_text + CJK handling)."""
    out = []
    for ch in text:
        cp = ord(ch)
        if ch in ("\t", "\n", "\r"):
            out.append(" ")
            continue
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C"):
            continue
        if _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    return "".join(out)


def _basic_tokenize(text: str, lowercase: bool) -> List[str]:
    """BERT basic tokenizer: control-char cleanup + CJK isolation,
    whitespace split, punctuation isolation, optional lowercasing with
    accent stripping."""
    out: List[str] = []
    for word in _clean(text).strip().split():
        if lowercase:
            word = word.lower()
            word = unicodedata.normalize("NFD", word)
            word = "".join(c for c in word if unicodedata.category(c) != "Mn")
        current = ""
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    out.append(current)
                    current = ""
                out.append(ch)
            else:
                current += ch
        if current:
            out.append(current)
    return out


class WordPieceTokenizer:
    def __init__(
        self,
        vocab_file: str,
        max_length: int = 128,
        lowercase: bool = True,
        unk_token: str = "[UNK]",
        pad_token: str = "[PAD]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        max_chars_per_word: int = 100,
    ):
        if not os.path.exists(vocab_file):
            raise FileNotFoundError(vocab_file)
        self.vocab: dict = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                token = line.rstrip("\n")
                if token:
                    self.vocab[token] = i
        self.max_length = max_length
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        self.UNK = self.vocab[unk_token]
        self.PAD = self.vocab[pad_token]
        self.CLS = self.vocab[cls_token]
        self.SEP = self.vocab[sep_token]
        self.vocab_size = max(self.vocab.values()) + 1

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars_per_word:
            return [self.UNK]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    piece_id = self.vocab[piece]
                    break
                end -= 1
            if piece_id is None:
                return [self.UNK]  # whole word becomes UNK, as in BERT
            ids.append(piece_id)
            start = end
        return ids

    def tokenize(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in _basic_tokenize(str(text), self.lowercase):
            ids.extend(self._wordpiece(word))
        return ids

    def count_tokens(self, text: str) -> int:
        return len(self.tokenize(text))

    def encode(
        self, text: str, pair: str | None = None, max_length: int | None = None
    ) -> List[int]:
        max_length = max_length or self.max_length
        if pair is None:
            ids = [self.CLS] + self.tokenize(text)
            return ids[: max_length - 1] + [self.SEP]
        # sentence pairs truncate longest-first (HF semantics): both segments
        # keep tokens, so an over-long query can't silently evict the whole
        # document and collapse every pair to the same score
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
        """Returns (ids [B, L], mask [B, L]) padded to a shared length —
        same contract as HashTokenizer.encode_batch (length rounded to a
        multiple of 16 to bound the shape variants)."""
        max_length = max_length or self.max_length
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
