"""Serve result type, degradation rungs and deadlines of the port
(counterparts of ``pathway_tpu/robust/degrade.py`` ``ServeResult``, the
rung flags and ``record_degraded``, and of
``pathway_tpu/robust/deadline.py`` ``Deadline``).

``record_degraded`` counts into ``DEGRADED_COUNTS``, a plain dict: the
port registers no metric family.  Retry, circuit breakers and fault
injection are not ported yet."""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

__all__ = [
    "DEGRADED_COUNTS",
    "Deadline",
    "DeadlineExceeded",
    "LATE_INTERACTION_SKIPPED",
    "RERANK_SKIPPED",
    "RETRIEVAL_FAILED",
    "STAGE1_FRACTION",
    "ServeResult",
    "record_degraded",
]

# degradation-ladder rungs (the reference's flag strings)
RERANK_SKIPPED = "rerank_skipped"
LATE_INTERACTION_SKIPPED = "late_interaction_skipped"
RETRIEVAL_FAILED = "retrieval_failed"

# share of a serve deadline granted to stage 1 (the reference's
# ``serve.stage1_fraction`` default); stage 2 runs on what remains
STAGE1_FRACTION = 0.6

DEGRADED_COUNTS: Dict[str, int] = {}
_counts_lock = threading.Lock()


def record_degraded(reason: str, n: int = 1) -> None:
    """Count ``n`` degraded serves for rung ``reason``."""
    with _counts_lock:
        DEGRADED_COUNTS[reason] = DEGRADED_COUNTS.get(reason, 0) + int(n)


class DeadlineExceeded(TimeoutError):
    """A serve stage ran past its deadline; ``stage`` names the check
    site.  The pipeline turns it into a degraded response."""

    def __init__(self, stage: str, overshoot_s: float = 0.0):
        super().__init__(
            f"deadline exceeded at {stage!r}"
            + (f" (by {overshoot_s * 1e3:.1f} ms)" if overshoot_s > 0 else "")
        )
        self.stage = stage
        self.overshoot_s = overshoot_s


class Deadline:
    """An absolute monotonic-clock deadline; immutable, shared freely
    across threads.  ``Deadline(0.25)`` is a quarter second from now."""

    __slots__ = ("_at",)

    def __init__(self, budget_s: float, *, _at: Optional[float] = None):
        self._at = _at if _at is not None else time.monotonic() + float(budget_s)

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(float(ms) * 1e-3)

    def remaining_s(self) -> float:
        """Seconds left (negative once expired)."""
        return self._at - time.monotonic()

    def check(self, stage: str) -> None:
        """Raise ``DeadlineExceeded`` if the budget is spent."""
        over = time.monotonic() - self._at
        if over >= 0:
            raise DeadlineExceeded(stage, over)

    def sub_budget(self, fraction: float) -> "Deadline":
        """A stage deadline spending at most ``fraction`` of the time
        remaining now, never later than this one."""
        remaining = self.remaining_s()
        if remaining <= 0:
            return Deadline(0.0, _at=self._at)
        child_at = time.monotonic() + remaining * max(0.0, min(1.0, fraction))
        return Deadline(0.0, _at=min(child_at, self._at))

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining_s() * 1e3:.1f}ms)"


class ServeResult(list):
    """Serve rows plus ladder metadata.  Compares equal to a plain list
    of the same rows; carries ``degraded`` — the tuple of rung flags
    that applied to this serve, deduplicated in order — and ``meta``
    (e.g. ``index_generation``).  The full reason list is mirrored into
    ``meta["degraded_reasons"]`` for metadata-only consumers."""

    __slots__ = ("degraded", "meta")

    def __init__(
        self,
        rows: Iterable[Any] = (),
        degraded: Sequence[str] = (),
        meta: Optional[Dict[str, Any]] = None,
    ):
        super().__init__(rows)
        deduped: List[str] = []
        for flag in degraded:
            if flag not in deduped:
                deduped.append(flag)
        self.degraded = tuple(deduped)
        self.meta = dict(meta or {})
        if self.degraded and "degraded_reasons" not in self.meta:
            self.meta["degraded_reasons"] = list(self.degraded)

    @property
    def ok(self) -> bool:
        return not self.degraded
