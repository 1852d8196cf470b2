"""The bounded, thread-safe cache store every serve-cache tier uses
(counterpart of ``pathway_tpu/cache/store.py``).

A ``CacheTier`` is an LRU dict bounded by a byte budget (entry count a
secondary cap), with an optional TTL and integrity fingerprint, and the
``cache.get`` / ``cache.put`` fault sites.  Every failure on the lookup
path (fault, expired, corrupt) is a miss, every failure on the store
path drops the entry: a broken cache looks like a cold one, never like a
wrong serve.  The tier lock guards dict and integer work only; the fault
sites fire before it.  Each tier renders
``pathway_cache_{hits,misses,evictions,insertions,expirations,corrupt,failures}_total``
and ``pathway_cache_{bytes,entries,max_bytes}`` labeled ``tier`` and ``id``.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

from .. import config, observe
from ..observe import trace
from ..robust import inject, log_once

__all__ = ["CacheTier", "cache_enabled", "live_tiers"]

_LIVE_TIERS: "weakref.WeakSet[CacheTier]" = weakref.WeakSet()


def live_tiers() -> "List[CacheTier]":
    """Every live ``CacheTier``."""
    return list(_LIVE_TIERS)


def cache_enabled() -> bool:
    """Global switch: ``PATHWAY_CACHE=0`` disables every tier."""
    return config.get("cache.enabled")


def _default_nbytes(value: Any) -> int:
    """Byte estimate: arrays and tensors report ``nbytes`` (metadata, no
    sync); containers recurse one level; anything else a flat 64."""
    nbytes = getattr(value, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    if isinstance(value, (tuple, list)):
        return 64 + sum(_default_nbytes(v) for v in value)
    if isinstance(value, (bytes, str)):
        return 64 + len(value)
    return 64


class _Entry:
    __slots__ = ("value", "nbytes", "expires_at", "fingerprint")

    def __init__(self, value, nbytes, expires_at, fingerprint):
        self.value = value
        self.nbytes = nbytes
        self.expires_at = expires_at
        self.fingerprint = fingerprint


class CacheTier:
    """One LRU + byte-budget tier.  ``fingerprint`` (host values only) is
    recomputed at every hit; a mismatch drops the entry as a miss."""

    def __init__(
        self,
        tier: str,
        max_bytes: int,
        ttl_s: Optional[float] = None,
        max_entries: Optional[int] = None,
        fingerprint: Optional[Callable[[Any], Any]] = None,
    ):
        self.tier = str(tier)
        self.max_bytes = int(max_bytes)
        self.ttl_s = float(ttl_s) if ttl_s else None
        self.max_entries = int(max_entries) if max_entries else None
        self._fingerprint = fingerprint
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Any, _Entry]" = OrderedDict()
        self._bytes = 0
        self.stats: Dict[str, int] = {
            "hits": 0,
            "misses": 0,
            "insertions": 0,
            "evictions": 0,
            "expirations": 0,
            "corrupt": 0,
            "failures": 0,
        }
        self.labels = {"tier": self.tier, "id": str(observe.next_id())}
        observe.register_provider(self)
        _LIVE_TIERS.add(self)

    def _trace_note(self, op: str, outcome: str) -> None:
        t = trace.current()
        if t is not None:
            t.add_event("cache." + op, tier=self.tier, outcome=outcome)

    def get(self, key: Any, deadline=None) -> Optional[Any]:
        """The cached value, or None on any miss or failure."""
        try:
            inject.fire("cache.get", deadline=deadline)
        except Exception as exc:  # noqa: BLE001 - a faulted lookup is a miss
            self._count("failures")
            self._count("misses")
            log_once(f"cache.get:{type(exc).__name__}",
                     "cache get failed on tier %s (%r); degrading to recompute", self.tier, exc)
            self._trace_note("get", "error")
            return None
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.stats["misses"] += 1
                state = "miss"
            elif entry.expires_at is not None and now >= entry.expires_at:
                self._drop_locked(key, entry)
                self.stats["expirations"] += 1
                self.stats["misses"] += 1
                state = "expired"
            else:
                self._entries.move_to_end(key)
                value, fp = entry.value, entry.fingerprint
                state = "hit"
        if state != "hit":
            self._trace_note("get", state)
            return None
        if fp is not None:
            try:
                ok = self._fingerprint(value) == fp
            except Exception:  # noqa: BLE001 - an unreadable entry is corrupt
                ok = False
            if not ok:
                self.discard(key)
                self._count("corrupt")
                self._count("misses")
                log_once(f"cache.corrupt:{self.tier}",
                         "corrupt cache entry on tier %s; dropped and recomputing", self.tier)
                self._trace_note("get", "corrupt")
                return None
        self._count("hits")
        self._trace_note("get", "hit")
        return value

    def put(self, key: Any, value: Any, nbytes: Optional[int] = None, deadline=None) -> bool:
        """Insert (last writer wins); a failure drops the entry.  A value
        larger than the whole budget, or a budget <= 0, stores nothing."""
        try:
            inject.fire("cache.put", deadline=deadline)
            size = int(nbytes) if nbytes is not None else _default_nbytes(value)
            fp = self._fingerprint(value) if self._fingerprint else None
        except Exception as exc:  # noqa: BLE001 - a faulted store drops the entry
            self._count("failures")
            log_once(f"cache.put:{type(exc).__name__}",
                     "cache put failed on tier %s (%r); entry dropped", self.tier, exc)
            self._trace_note("put", "dropped")
            return False
        if self.max_bytes <= 0 or size > self.max_bytes:
            return False
        expires = time.monotonic() + self.ttl_s if self.ttl_s is not None else None
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = _Entry(value, size, expires, fp)
            self._bytes += size
            self.stats["insertions"] += 1
            while self._entries and (
                self._bytes > self.max_bytes
                or (self.max_entries and len(self._entries) > self.max_entries)
            ):
                _k, e = self._entries.popitem(last=False)
                self._bytes -= e.nbytes
                self.stats["evictions"] += 1
        return True

    def __contains__(self, key: Any) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def bytes(self) -> int:
        return self._bytes

    def discard(self, key: Any) -> None:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._bytes -= entry.nbytes

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def warm_entries(self) -> List[Any]:
        """``(key, value, nbytes)`` of the live, unexpired entries in LRU
        order, oldest first, so a replay keeps the eviction order.
        Values by reference: an owner whose values are device tensors
        converts them for the snapshot."""
        now = time.monotonic()
        with self._lock:
            return [
                (k, e.value, e.nbytes)
                for k, e in self._entries.items()
                if e.expires_at is None or now < e.expires_at
            ]

    def load_warm_entries(self, entries: List[Any]) -> int:
        """Replay ``warm_entries()`` through ``put``: fingerprints are
        recomputed and TTL clocks restart.  Returns the entries accepted
        (a failed put is a cold key, never an error)."""
        return sum(1 for k, v, nbytes in entries if self.put(k, v, nbytes=nbytes))

    def _drop_locked(self, key: Any, entry: _Entry) -> None:
        self._entries.pop(key, None)
        self._bytes -= entry.nbytes

    def _count(self, stat: str) -> None:
        with self._lock:
            self.stats[stat] += 1

    def observe_metrics(self):
        for stat in ("hits", "misses", "evictions", "insertions", "expirations", "corrupt", "failures"):
            yield ("counter", f"pathway_cache_{stat}_total", self.labels, self.stats[stat])
        yield ("gauge", "pathway_cache_bytes", self.labels, self._bytes)
        yield ("gauge", "pathway_cache_entries", self.labels, len(self._entries))
        yield ("gauge", "pathway_cache_max_bytes", self.labels, self.max_bytes)
