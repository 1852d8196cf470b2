"""Cached object storage — blob cache for re-computable artifacts
(counterpart of ``pathway_tpu/persistence/object_cache.py``).

The reference caches re-downloadable objects (fetched files, parse results)
in persistent storage so restarts skip the re-download/re-parse
(src/persistence/cached_object_storage.rs:377).  Here the cache is a thin
keyed-blob layer over any ``PersistenceBackend`` (file/S3/memory) with
version-aware keys: ``get_or_compute`` recomputes only when the (key,
version) pair is unseen — e.g. a document parser keyed by (path, mtime)
re-parses a file only when it actually changed across restarts.
"""

from __future__ import annotations

import hashlib
import pickle
import threading
from typing import Any, Callable, Optional

from .backends import PersistenceBackend
from .host_pickle import dumps

__all__ = ["CachedObjectStorage"]


def _digest(key: Any, version: Any) -> str:
    raw = pickle.dumps((key, version))
    return hashlib.sha256(raw).hexdigest()


class CachedObjectStorage:
    def __init__(self, backend: PersistenceBackend, namespace: str = "objects"):
        self.backend = backend
        self.namespace = namespace
        self._lock = threading.Lock()
        # in-flight computes keyed by blob key: dedups same-key work
        # without holding any lock across compute()/pickle (see
        # get_or_compute)
        self._inflight: dict = {}

    def _blob_key(self, key: Any, version: Any) -> str:
        return f"{self.namespace}/{_digest(key, version)}"

    def get(self, key: Any, version: Any = None) -> Optional[Any]:
        blob = self.backend.get(self._blob_key(key, version))
        return pickle.loads(blob) if blob is not None else None

    def contains(self, key: Any, version: Any = None) -> bool:
        return self.backend.get(self._blob_key(key, version)) is not None

    def put(self, key: Any, value: Any, version: Any = None) -> None:
        self.backend.put(self._blob_key(key, version), dumps(value))

    def invalidate(self, key: Any, version: Any = None) -> None:
        self.backend.delete(self._blob_key(key, version))

    def clear(self) -> None:
        for k in self.backend.list_keys(f"{self.namespace}/"):
            self.backend.delete(k)

    def get_or_compute(
        self, key: Any, compute: Callable[[], Any], version: Any = None
    ) -> Any:
        """Cached call: returns the stored value for (key, version), or runs
        ``compute`` once and stores its result.  Backends are
        last-writer-wins like the reference.

        Same-key in-process races dedup through a per-key in-flight event
        instead of one global critical section: no lock is held across
        ``compute()`` (arbitrary user code — a PDF parse, a model call) or
        the pickle of its result, so other threads' cache accesses never
        stall behind them.  The global lock only guards the in-flight dict
        (a couple of dict ops).  A torch tensor in the value is stored as
        a numpy array (``host_pickle.dumps``)."""
        bkey = self._blob_key(key, version)
        blob = self.backend.get(bkey)
        if blob is not None:
            return pickle.loads(blob)
        with self._lock:
            waiter = self._inflight.get(bkey)
            event = None
            if waiter is None:
                event = self._inflight[bkey] = threading.Event()
        if waiter is not None:
            # another thread owns this key's compute: wait, then re-read
            waiter.wait()
            blob = self.backend.get(bkey)
            if blob is not None:
                return pickle.loads(blob)
            # the owner failed; claim ownership for our own attempt (if a
            # third thread already re-claimed it, compute un-deduped —
            # correctness over dedup, and never wait twice)
            with self._lock:
                if self._inflight.get(bkey) is None:
                    event = self._inflight[bkey] = threading.Event()
        try:
            blob = self.backend.get(bkey)
            if blob is not None:
                return pickle.loads(blob)
            value = compute()
            self.backend.put(bkey, dumps(value))
            return value
        finally:
            # only the OWNER retires its own event: popping someone
            # else's entry would wake their waiters before the value lands
            if event is not None:
                with self._lock:
                    if self._inflight.get(bkey) is event:
                        del self._inflight[bkey]
                event.set()
