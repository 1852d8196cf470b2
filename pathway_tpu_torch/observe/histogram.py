"""Fixed-slot latency histogram + bounded event ring (counterpart of
``pathway_tpu/observe/histogram.py`` and ``observe/_state.py``).

Buckets are powers of two over nanoseconds, the reference's bounds:
bucket ``i`` holds durations in ``(2^(SHIFT+i-1), 2^(SHIFT+i)]`` ns with
``SHIFT = 10``; the last bucket is the +Inf overflow.  Recording is a few
integer operations under a lock held only for the increment.

``enabled`` is the recorder's global switch (``PATHWAY_OBSERVE``): every
record call of the package reads this module attribute first.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

from .. import config

__all__ = ["EventRing", "LatencyHistogram", "N_BUCKETS", "bucket_bounds_s"]

enabled = config.get("observe.enabled")

N_BUCKETS = 32
_SHIFT = 10  # first bucket upper bound: 2^10 ns = 1.024 us


def _bucket_index(ns: int) -> int:
    """Smallest ``i`` with ns <= 2^(SHIFT+i), clamped to the buckets."""
    if ns <= 0:
        return 0
    i = (int(ns) - 1).bit_length() - _SHIFT
    return min(max(i, 0), N_BUCKETS - 1)


def bucket_bounds_s() -> List[float]:
    """Upper bounds of the finite buckets in seconds (the ``le`` values)."""
    return [(1 << (_SHIFT + i)) * 1e-9 for i in range(N_BUCKETS - 1)]


class LatencyHistogram:
    """Power-of-two-bucket histogram over durations in ns, with one
    exemplar slot per bucket (a kept trace's id, stamped by the tail
    sampler)."""

    __slots__ = ("_counts", "_sum_ns", "_n", "_lock", "_exemplars")

    def __init__(self) -> None:
        self._counts = [0] * N_BUCKETS
        self._sum_ns = 0
        self._n = 0
        self._lock = threading.Lock()
        self._exemplars: Optional[List[Optional[Tuple[str, float, float]]]] = None

    def observe_ns(self, ns: int) -> None:
        if not enabled:
            return
        i = _bucket_index(ns)
        with self._lock:
            self._counts[i] += 1
            self._sum_ns += int(ns)
            self._n += 1

    def observe_s(self, seconds: float) -> None:
        self.observe_ns(int(seconds * 1e9))

    def snapshot(self) -> Tuple[Tuple[int, ...], int, int]:
        """(per-bucket counts, sum_ns, count): one consistent view."""
        with self._lock:
            return tuple(self._counts), self._sum_ns, self._n

    def set_exemplar(self, ns: int, trace_id: str) -> None:
        """Stamp ``trace_id`` on the bucket a duration of ``ns`` lands in."""
        i = _bucket_index(int(ns))
        with self._lock:
            if self._exemplars is None:
                self._exemplars = [None] * N_BUCKETS
            self._exemplars[i] = (str(trace_id), int(ns) * 1e-9, time.time())

    def exemplars(self) -> Optional[List[Optional[Tuple[str, float, float]]]]:
        with self._lock:
            return None if self._exemplars is None else list(self._exemplars)

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * N_BUCKETS
            self._sum_ns = 0
            self._n = 0
            self._exemplars = None

    def merge_from(self, other: "LatencyHistogram") -> None:
        """Add ``other``'s buckets, sum and count into this histogram
        (identical bucket bounds make the merge a vector add)."""
        counts, sum_ns, n = other.snapshot()
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._sum_ns += sum_ns
            self._n += n

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum_seconds(self) -> float:
        return self._sum_ns * 1e-9

    def quantile_s(self, q: float) -> Optional[float]:
        """Upper-bound estimate of the ``q`` quantile in seconds (the
        bucket bound where the cumulative count crosses ``q * n``); None
        when empty."""
        counts, _sum_ns, n = self.snapshot()
        if n == 0:
            return None
        bounds = bucket_bounds_s()
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= q * n:
                return bounds[min(i, N_BUCKETS - 2)]
        return bounds[-1]


class EventRing:
    """Bounded ring of recent events, newest wins; ``snapshot`` returns
    the retained events oldest first plus the total appended."""

    __slots__ = ("_slots", "_n", "_lock", "capacity")

    def __init__(self, capacity: int = 256) -> None:
        self.capacity = int(capacity)
        self._slots: List[Optional[tuple]] = [None] * self.capacity
        self._n = 0
        self._lock = threading.Lock()

    def append(self, event: tuple) -> None:
        if not enabled:
            return
        with self._lock:
            self._slots[self._n % self.capacity] = event
            self._n += 1

    def snapshot(self) -> Tuple[List[tuple], int]:
        with self._lock:
            n = self._n
            if n <= self.capacity:
                return list(self._slots[:n]), n
            head = n % self.capacity
            return [e for e in self._slots[head:] + self._slots[:head] if e is not None], n

    @property
    def dropped(self) -> int:
        with self._lock:
            return max(0, self._n - self.capacity)

    def reset(self) -> None:
        with self._lock:
            self._slots = [None] * self.capacity
            self._n = 0

    def __len__(self) -> int:
        with self._lock:
            return min(self._n, self.capacity)
