"""Serve deadlines with per-stage sub-budgets (counterpart of
``pathway_tpu/robust/deadline.py``).

A ``Deadline`` is an absolute point on the monotonic clock, immutable
and shared freely across threads.  ``sub_budget`` carves a stage budget
out of the time remaining, never later than the parent.  Exceeding it
raises ``DeadlineExceeded`` inside the pipeline, which serves a degraded
result instead.  ``Deadline.from_env()`` is the default per-serve budget
(``serve.deadline_ms``) and ``stage1_fraction()`` stage 1's share of it
(``serve.stage1_fraction``).
"""

from __future__ import annotations

import time
from typing import Optional

from .. import config

__all__ = ["Deadline", "DeadlineExceeded", "stage1_fraction"]


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
    """An absolute monotonic-clock deadline.  ``Deadline(0.25)`` is a
    quarter second from now."""

    __slots__ = ("_at",)

    def __init__(self, budget_s: float, *, _at: Optional[float] = None):
        self._at = _at if _at is not None else time.monotonic() + float(budget_s)

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(float(ms) * 1e-3)

    @classmethod
    def from_env(cls) -> Optional["Deadline"]:
        """The default per-serve budget from ``serve.deadline_ms``; None
        (no deadline) when unset or <= 0."""
        ms = config.get("serve.deadline_ms")
        return cls.after_ms(ms) if ms > 0 else None

    def remaining_s(self) -> float:
        """Seconds left (negative once expired)."""
        return self._at - time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() >= self._at

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


def stage1_fraction() -> float:
    """Share of a serve budget granted to stage 1; stage 2 runs on what
    remains.  Clamped by the knob's declared bounds."""
    return config.get("serve.stage1_fraction")
