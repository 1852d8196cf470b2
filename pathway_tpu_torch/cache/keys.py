"""The one place serve-cache keys are derived (counterpart of
``pathway_tpu/cache/keys.py``).

- ``query_key(text, generation)``: the scheduler's in-window dedup item
  and the result-cache key prefix, so the two can never drift;
- ``result_key(text, generation, k)``: the cross-window result-cache
  key; an index mutation bumps the generation, so a stale entry can
  never be asked for again;
- ``token_ids_key(ids, mask)``: the embedding-cache key, a digest of one
  query's real token ids, independent of padding and of the index.
"""

from __future__ import annotations

import hashlib
from typing import Any, Tuple

import numpy as np

__all__ = ["normalize_generation", "query_key", "result_key", "token_ids_key"]


def normalize_generation(generation: Any):
    """Hashable spelling of an index generation: an ``int``, or a tuple
    of ints for a generation vector."""
    if isinstance(generation, (list, tuple)):
        return tuple(int(g) for g in generation)
    return int(generation)


def query_key(text: Any, generation: Any) -> Tuple[str, Any]:
    """``(text, index generation)``."""
    return (str(text), normalize_generation(generation))


def result_key(text: Any, generation: Any, k: int) -> Tuple[str, Any, int]:
    """``query_key`` plus the requested ``k``."""
    return query_key(text, generation) + (int(k),)


def token_ids_key(ids_row: np.ndarray, mask_row: np.ndarray) -> bytes:
    """Digest of one query's real token ids (the masked prefix): the
    same query in a longer padded batch gives the same key."""
    real = np.ascontiguousarray(np.ascontiguousarray(ids_row)[np.asarray(mask_row) > 0])
    h = hashlib.blake2b(digest_size=16)
    h.update(str(real.dtype).encode())
    h.update(np.int64(real.size).tobytes())
    h.update(real.tobytes())
    return h.digest()
