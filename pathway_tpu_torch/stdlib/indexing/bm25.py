"""Full-text BM25 index of the port (counterpart of
``pathway_tpu/stdlib/indexing/bm25.py``; reference:
stdlib/indexing/bm25.py:41 TantivyBM25 over the native tantivy index,
src/external_integration/tantivy_integration.rs:16).

Host-side incremental inverted index with Okapi BM25 scoring; retrieval is
candidate-set-bounded (union of query-term postings), so live updates stay
cheap.  The Tantivy* names are kept for config compatibility.

The index keeps the reference's dicts (``add`` / ``remove`` are the
reference's).  A query is scored with numpy over per-term posting arrays
built once after the index changes: each document's score is summed over
the query's terms in the reference's order with the reference's
operations, so the scores are the reference's bit for bit, and the
ranking is its ``(-score, key)`` order."""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .filters import compile_filter
from .nearest_neighbors import InnerIndexImpl

__all__ = ["BM25Index", "TantivyBM25", "TantivyBM25Factory"]

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def _tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(str(text).lower())


class BM25Index(InnerIndexImpl):
    def __init__(self, k1: float = 1.2, b: float = 0.75, ram_budget: Optional[int] = None):
        self.k1 = k1
        self.b = b
        self.postings: Dict[str, Dict[int, int]] = {}
        self.doc_tokens: Dict[int, Counter] = {}
        self.doc_len: Dict[int, int] = {}
        self.metadata: Dict[int, Any] = {}
        self.total_len = 0
        self._arrays = None  # (keys, position of key, doc lengths); None after a change
        self._term_arrays: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def add(self, keys, values, metadatas) -> None:
        self._arrays = None
        for key, text, md in zip(keys, values, metadatas):
            key = int(key)
            if key in self.doc_tokens:
                self.remove([key])
            counts = Counter(_tokenize(text))
            self.doc_tokens[key] = counts
            n = sum(counts.values())
            self.doc_len[key] = n
            self.total_len += n
            for tok, tf in counts.items():
                self.postings.setdefault(tok, {})[key] = tf
            if md is not None:
                self.metadata[key] = md

    def remove(self, keys) -> None:
        self._arrays = None
        for key in keys:
            key = int(key)
            counts = self.doc_tokens.pop(key, None)
            if counts is None:
                continue
            self.total_len -= self.doc_len.pop(key, 0)
            for tok in counts:
                plist = self.postings.get(tok)
                if plist is not None:
                    plist.pop(key, None)
                    if not plist:
                        del self.postings[tok]
            self.metadata.pop(key, None)

    def _doc_arrays(self):
        """(keys uint64, key -> position, doc lengths f64), rebuilt after a
        change; the per-term posting arrays are rebuilt on first use."""
        if self._arrays is None:
            keys = list(self.doc_tokens)
            self._arrays = (
                np.array(keys, dtype=np.uint64),
                {key: i for i, key in enumerate(keys)},
                np.array([self.doc_len[key] for key in keys], dtype=np.float64),
            )
            self._term_arrays = {}
        return self._arrays

    def _postings(self, tok: str, pos: Dict[int, int]) -> Tuple[np.ndarray, np.ndarray]:
        arrays = self._term_arrays.get(tok)
        if arrays is None:
            plist = self.postings[tok]
            arrays = self._term_arrays[tok] = (
                np.fromiter((pos[doc] for doc in plist), np.int64, len(plist)),
                np.fromiter(plist.values(), np.float64, len(plist)),
            )
        return arrays

    def _score_query(self, text: str, k: int, accept=None) -> Tuple[Tuple[int, float], ...]:
        n_docs = len(self.doc_tokens)
        if n_docs == 0:
            return ()
        avg_len = self.total_len / n_docs
        keys, pos, doc_len = self._doc_arrays()
        scores = np.zeros(n_docs, dtype=np.float64)
        touched = np.zeros(n_docs, dtype=bool)
        for tok in set(_tokenize(text)):
            plist = self.postings.get(tok)
            if not plist:
                continue
            idf = math.log(1 + (n_docs - len(plist) + 0.5) / (len(plist) + 0.5))
            idx, tf = self._postings(tok, pos)
            denom = tf + self.k1 * (1 - self.b + self.b * doc_len[idx] / avg_len)
            scores[idx] += idf * tf * (self.k1 + 1) / denom
            touched[idx] = True
        cand = np.flatnonzero(touched)
        if accept is None and len(cand) > k:
            # every candidate scoring at least the k-th best, ties included
            kth = -np.partition(-scores[cand], k - 1)[k - 1]
            cand = cand[scores[cand] >= kth]
        ranked = cand[np.lexsort((keys[cand], -scores[cand]))]
        out = []
        for j in ranked:
            doc = int(keys[j])
            if accept is not None and not accept(self.metadata.get(doc, {})):
                continue
            out.append((doc, float(scores[j])))
            if len(out) >= k:
                break
        return tuple(out)

    def search(self, values, k, filters):
        out = []
        for text, fexpr in zip(values, filters):
            accept = compile_filter(str(fexpr)) if fexpr is not None else None
            out.append(self._score_query(text, k, accept))
        return out


class TantivyBM25Factory:
    """(reference: TantivyBM25 factory, bm25.py:41)"""

    def __init__(self, ram_budget: Optional[int] = None, in_memory_index: bool = True, **kwargs):
        self.ram_budget = ram_budget

    def build_inner_index(self, dimension: Optional[int] = None) -> BM25Index:
        return BM25Index(ram_budget=self.ram_budget)


TantivyBM25 = TantivyBM25Factory
