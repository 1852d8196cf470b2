"""Retry with exponential backoff and seeded jitter, and per-model
circuit breakers (counterpart of ``pathway_tpu/robust/retry.py``).

``retry_call(site, fn, ...)`` runs ``fn`` under the site's attempt
budget; before every attempt the breaker (if any) gates entry and the
fault site of the same name fires, so each retry site is testable with
``robust/inject.py``.  The backoff before attempt ``a`` is a point in
``[base/2, min(max, base * 2^a)]`` drawn from ``Random(f"{seed}:{site}:{a}")``:
a failure run replays identically.  ``DeadlineExceeded`` and
``CircuitOpen`` are never retried.

A ``CircuitBreaker`` opens after ``robust.breaker_threshold``
consecutive failures; calls then fail fast with ``CircuitOpen`` until
``robust.breaker_reset_s`` has passed, when ONE probe goes through: a
success closes it, a failure re-opens it.  ``breaker(name)`` is the
process-wide registry (one breaker per model).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Any, Callable, Dict, Optional, Set, Tuple, Type

from .. import config, observe
from . import inject
from .deadline import Deadline, DeadlineExceeded

__all__ = ["CircuitBreaker", "CircuitOpen", "RetryPolicy", "breaker", "log_once", "retry_call"]

_logger = logging.getLogger("pathway_tpu_torch.robust")
_logged_keys: Set[str] = set()
_logged_lock = threading.Lock()


def log_once(key: str, msg: str, *args: Any) -> None:
    """Log ``msg`` at WARNING the first time ``key`` is seen."""
    with _logged_lock:
        if key in _logged_keys:
            return
        _logged_keys.add(key)
    _logger.warning(msg, *args)


class CircuitOpen(RuntimeError):
    """The named breaker is open: callers degrade instead of queueing
    doomed work."""

    def __init__(self, name: str):
        super().__init__(f"circuit breaker {name!r} is open")
        self.name = name


class RetryPolicy:
    """Attempt budget + backoff schedule for one retry site."""

    __slots__ = ("attempts", "base_delay_s", "max_delay_s", "seed")

    def __init__(self, attempts: int = 3, base_delay_s: float = 0.005, max_delay_s: float = 0.2, seed: int = 0):
        self.attempts = max(1, int(attempts))
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.seed = int(seed)

    def delay_s(self, site: str, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        cap = min(self.max_delay_s, self.base_delay_s * (2.0 ** attempt))
        lo = min(self.base_delay_s * 0.5, cap)
        return lo + random.Random(f"{self.seed}:{site}:{attempt}").random() * max(0.0, cap - lo)

    @classmethod
    def from_env(cls, site: str) -> "RetryPolicy":
        """The ``robust.retry_*`` knobs, with the per-site attempt family
        ``PATHWAY_RETRY_ATTEMPTS_<SITE>``."""
        return cls(
            attempts=config.get_site("robust.retry_attempts", site),
            base_delay_s=config.get("robust.retry_base_ms") * 1e-3,
            max_delay_s=config.get("robust.retry_max_ms") * 1e-3,
            seed=config.get("robust.retry_seed"),
        )


_policies: Dict[str, RetryPolicy] = {}
_retry_counters: Dict[Tuple[str, bool], observe.Counter] = {}


def _count_retry(site: str, exhausted: bool) -> None:
    c = _retry_counters.get((site, exhausted))
    if c is None:
        name = "pathway_robust_retry_exhausted_total" if exhausted else "pathway_robust_retries_total"
        c = _retry_counters[(site, exhausted)] = observe.counter(name, site=site)
    c.inc()


def retry_call(
    site: str,
    fn: Callable[..., Any],
    *args: Any,
    deadline: Optional[Deadline] = None,
    policy: Optional[RetryPolicy] = None,
    retryable: Tuple[Type[BaseException], ...] = (Exception,),
    breaker: Optional["CircuitBreaker"] = None,
    **kwargs: Any,
) -> Any:
    """``fn(*args, **kwargs)`` under the site's retry budget (see the
    module docstring); the final failure re-raises the last error."""
    pol = policy or _policies.get(site)
    if pol is None:
        pol = _policies[site] = RetryPolicy.from_env(site)
    last: Optional[BaseException] = None
    for attempt in range(pol.attempts):
        if deadline is not None:
            deadline.check(site)
        if breaker is not None and not breaker.allow():
            raise CircuitOpen(breaker.name)
        try:
            inject.fire(site, deadline=deadline)
            result = fn(*args, **kwargs)
        except (DeadlineExceeded, CircuitOpen):
            # a policy outcome proves nothing about the model: release a
            # held half-open probe, or the breaker would wedge open
            if breaker is not None:
                breaker.abort_probe()
            raise
        except retryable as exc:
            if breaker is not None:
                breaker.record_failure()
            last = exc
            if attempt + 1 >= pol.attempts:
                break
            delay = pol.delay_s(site, attempt + 1)
            if deadline is not None:
                remaining = deadline.remaining_s()
                if remaining <= 0:
                    break  # budget spent: no retry happens, count none
                delay = min(delay, remaining)
            _count_retry(site, exhausted=False)
            time.sleep(delay)
            continue
        if breaker is not None:
            breaker.record_success()
        return result
    _count_retry(site, exhausted=True)
    raise last


class CircuitBreaker:
    """Consecutive-failure breaker with timed half-open probes: closed ->
    (threshold failures) -> open -> (reset_s) -> half-open, one probe ->
    success closes / failure re-opens.  Its state renders as
    ``pathway_robust_breaker_open{breaker}`` through the recorder's
    provider registry."""

    def __init__(self, name: str, failure_threshold: Optional[int] = None, reset_s: Optional[float] = None):
        self.name = name
        self.failure_threshold = int(
            failure_threshold if failure_threshold is not None else config.get("robust.breaker_threshold")
        )
        self.reset_s = float(reset_s if reset_s is not None else config.get("robust.breaker_reset_s"))
        self._lock = threading.Lock()
        self._failures = 0  # consecutive
        self._opened_at: Optional[float] = None
        self._probing = False
        self.stats = {"opens": 0, "fail_fast": 0}
        observe.register_provider(self)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._opened_at is None:
            return "closed"
        if time.monotonic() - self._opened_at >= self.reset_s:
            return "half_open"
        return "open"

    def allow(self) -> bool:
        """True when a call may proceed (closed, or the one half-open
        probe); False = fail fast."""
        with self._lock:
            state = self._state_locked()
            if state == "closed":
                return True
            if state == "half_open" and not self._probing:
                self._probing = True
                return True
            self.stats["fail_fast"] += 1
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def reset(self) -> None:
        """Close the breaker and clear its failure count."""
        self.record_success()

    def abort_probe(self) -> None:
        """Release the half-open probe slot without an outcome."""
        with self._lock:
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._probing or (self._opened_at is None and self._failures >= self.failure_threshold):
                self._opened_at = time.monotonic()
                self._probing = False
                self.stats["opens"] += 1

    def observe_metrics(self):
        labels = {"breaker": self.name}
        yield ("gauge", "pathway_robust_breaker_open", labels,
               {"closed": 0.0, "half_open": 0.5, "open": 1.0}[self.state])
        yield ("counter", "pathway_robust_breaker_opens_total", labels, self.stats["opens"])
        yield ("counter", "pathway_robust_breaker_fail_fast_total", labels, self.stats["fail_fast"])


_breakers: Dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker(name: str, **kwargs: Any) -> CircuitBreaker:
    """The process-wide breaker of ``name``, shared by every pipeline
    scoring through that model."""
    with _breakers_lock:
        b = _breakers.get(name)
        if b is None:
            b = _breakers[name] = CircuitBreaker(name, **kwargs)
        return b
