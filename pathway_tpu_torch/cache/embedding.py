"""Tier 1: the query-embedding cache, keyed on token ids (counterpart of
``pathway_tpu/cache/embedding.py``).

An embedding depends on the tokenizer and the encoder's weights, not on
the index, so it survives every generation bump: a known query skips the
stage-1 trunk forward even after an absorb invalidated its result-cache
entry.  Entries are ``[d]`` f32 rows on the encoder's device; the serve
path stacks cached rows with one bucketed encode of the misses
(``ops/serving.py`` ``_cached_embeddings``).  A row is charged its
``nbytes`` (``d * 4``, the reference's count for its ``[d]`` f32 row), so
eviction order matches the reference's.  The tier is per encoder.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np

from .. import config
from .keys import token_ids_key
from .store import CacheTier, cache_enabled

__all__ = ["EmbeddingCache", "embedding_cache_from_env"]


class EmbeddingCache:
    """Device ``[d]`` rows behind one ``CacheTier`` (no fingerprint:
    checksumming a device row would be a host sync)."""

    def __init__(self, max_bytes: Optional[int] = None, ttl_s: Optional[float] = None,
                 max_entries: Optional[int] = None):
        if max_bytes is None:
            max_bytes = config.get("cache.embed_bytes")
        if ttl_s is None:
            ttl = config.get("cache.embed_ttl_s")
            ttl_s = ttl if ttl > 0 else None
        self._tier = CacheTier("embedding", max_bytes=max_bytes, ttl_s=ttl_s, max_entries=max_entries)

    @property
    def stats(self):
        return self._tier.stats

    def row_key(self, ids_row: np.ndarray, mask_row: np.ndarray, space: str = "") -> bytes:
        """``space`` names the producer's value space, so rows of two
        producers never alias."""
        return space.encode() + b"\x00" + token_ids_key(ids_row, mask_row)

    def lookup_rows(
        self, ids: np.ndarray, mask: np.ndarray, n_real: int, deadline=None, space: str = ""
    ) -> Tuple[List[Any], List[int], List[bytes]]:
        """``(rows, miss_indices, keys)`` for the real rows of a batch:
        ``rows[i]`` a device row or None."""
        rows: List[Any] = []
        misses: List[int] = []
        keys: List[bytes] = []
        for i in range(n_real):
            key = self.row_key(ids[i], mask[i], space)
            keys.append(key)
            row = self._tier.get(key, deadline=deadline)
            rows.append(row)
            if row is None:
                misses.append(i)
        return rows, misses, keys

    def put_row(self, key: bytes, row: Any, deadline=None) -> bool:
        return self._tier.put(key, row, nbytes=getattr(row, "nbytes", 64), deadline=deadline)


def embedding_cache_from_env() -> Optional[EmbeddingCache]:
    """Opt-in via ``PATHWAY_CACHE_EMBED=1`` (under ``PATHWAY_CACHE``)."""
    if cache_enabled() and config.get("cache.embed"):
        return EmbeddingCache()
    return None
