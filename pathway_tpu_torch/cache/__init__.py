"""Serve cache tiers of the port (counterpart of ``pathway_tpu/cache``)
behind one bounded, thread-safe store (``store.py``):

========================  ===================================  =============================
tier                      keyed on                             invalidation
========================  ===================================  =============================
result (``result.py``)    (query text, index generation, k)    generation bump + TTL + LRU
embedding                 token ids digest                     LRU/bytes (+ optional TTL)
(``embedding.py``)
========================  ===================================  =============================

The reference's generator prefix/KV tier waits for the port's generator.
"""

from .embedding import EmbeddingCache, embedding_cache_from_env
from .keys import normalize_generation, query_key, result_key, token_ids_key
from .result import ResultCache, result_cache_from_env
from .store import CacheTier, cache_enabled, live_tiers

__all__ = [
    "CacheTier",
    "EmbeddingCache",
    "ResultCache",
    "cache_enabled",
    "embedding_cache_from_env",
    "live_tiers",
    "normalize_generation",
    "query_key",
    "result_cache_from_env",
    "result_key",
    "token_ids_key",
]
