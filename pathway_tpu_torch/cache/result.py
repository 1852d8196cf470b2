"""Tier 0: the cross-window serve-result cache (counterpart of
``pathway_tpu/cache/result.py``).

The scheduler looks a request's rows up before admission under
``(text, index generation, k)``; a full hit is a zero-dispatch serve,
bit-identical to the serve that stored the rows.  An index mutation
bumps the generation, so every older entry becomes unreachable; the TTL
bounds everything else.  Only clean results are stored, and only when
their dispatch-time generation equals the admission generation (the
scheduler checks ``meta["index_generation"]``).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

from .. import config
from .keys import result_key
from .store import CacheTier, cache_enabled

__all__ = ["ResultCache", "result_cache_from_env"]


def _rows_fingerprint(row: Any) -> int:
    return hash(tuple((int(k), float(s)) for k, s in row))


class ResultCache:
    """The serve-result tier over one ``CacheTier``.  ``get_rows`` is
    all-or-nothing over a request's texts: a partial hit dispatches the
    whole request, so batch composition stays what it would be uncached."""

    def __init__(self, max_bytes: Optional[int] = None, ttl_s: Optional[float] = None,
                 max_entries: Optional[int] = None):
        if max_bytes is None:
            max_bytes = config.get("cache.result_bytes")
        if ttl_s is None:
            ttl = config.get("cache.result_ttl_s")
            ttl_s = ttl if ttl > 0 else None
        self._tier = CacheTier("result", max_bytes=max_bytes, ttl_s=ttl_s,
                               max_entries=max_entries, fingerprint=_rows_fingerprint)

    @property
    def stats(self):
        return self._tier.stats

    def __len__(self) -> int:
        return len(self._tier)

    def clear(self) -> None:
        self._tier.clear()

    def get_rows(self, items: Sequence[Tuple[str, int]], k: int, deadline=None) -> Optional[List[list]]:
        """Rows for a request's ``(text, generation)`` items at ``k``, or
        None unless every text hits."""
        rows: List[list] = []
        for text, gen in items:
            row = self._tier.get(result_key(text, gen, k), deadline=deadline)
            if row is None:
                return None
            rows.append(list(row))
        return rows

    def put_row(self, text: str, generation: int, k: int, row: Sequence[Tuple[int, float]], deadline=None) -> bool:
        try:
            row = [(int(key), float(s)) for key, s in row]
        except (TypeError, ValueError):
            self._tier._count("failures")
            return False
        # ~32 B per (key, score) pair + entry overhead
        return self._tier.put(result_key(text, generation, k), row, nbytes=64 + 32 * len(row), deadline=deadline)

    def warm_state(self) -> dict:
        """Picklable snapshot of the live rows (host lists already)."""
        return {"kind": "result_cache", "entries": self._tier.warm_entries()}

    def load_warm_state(self, state: dict) -> int:
        if state.get("kind") != "result_cache":
            raise ValueError(f"not a result-cache warm state: {state.get('kind')!r}")
        return self._tier.load_warm_entries(state["entries"])


def result_cache_from_env() -> Optional[ResultCache]:
    """The scheduler's default tier 0: on unless ``PATHWAY_CACHE=0`` or
    ``PATHWAY_CACHE_RESULT=0``."""
    if not cache_enabled() or not config.get("cache.result"):
        return None
    return ResultCache()
