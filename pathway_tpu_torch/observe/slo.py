"""Declarative SLOs with multi-window burn-rate evaluation (counterpart
of ``pathway_tpu/observe/slo.py``), read from the port's recorder.

- ``kind="latency"``: the share of a histogram family's events at or
  under ``threshold_s`` (snapped up to the power-of-two bucket bound);
- ``kind="availability"``: 1 - bad / total, bad from a counter family
  summed over its label sets, total from a histogram family's count.

The burn rate of a window is its error ratio over the error budget
``1 - objective``; a spec fires when its fast AND slow windows both burn
past ``observe.slo_burn``.  Windows difference cumulative (good, total)
snapshots taken at each evaluation, throttled to one per
``observe.slo_tick_s``.  ``should_shed()`` is the scheduler's admission
probe: True while a ``shed=True`` spec fires.  A fault at the
``slo.evaluate`` site serves the last document marked stale.

The reference's decode-TTLT and ingest-freshness specs wait for the
port's generator and live-ingest slices.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import config
from . import recorder as _recorder
from .histogram import N_BUCKETS, bucket_bounds_s
from .recorder import counter, register_provider

__all__ = ["SloEngine", "SloSpec", "default_specs", "engine", "record_shed_advised", "reset", "should_shed"]

_C_EVALS = counter("pathway_slo_evaluations_total")
_C_DROPPED = counter("pathway_slo_evaluations_dropped_total")
_C_SHED_ADVISED = counter("pathway_slo_shed_advised_total")


def _evaluate_allowed() -> bool:
    from ..robust import inject  # robust imports this package
    from ..robust.deadline import Deadline

    if not inject.any_armed():
        return True
    try:
        before = inject.fired_count("slo.evaluate")
        inject.fire("slo.evaluate", deadline=Deadline.after_ms(0.0))
        return inject.fired_count("slo.evaluate") == before
    except Exception:  # noqa: BLE001 - a faulted evaluation serves the stale document
        return False


def _family_hist_counts(name: str) -> Tuple[List[int], int]:
    with _recorder._registry_lock:
        series = list(_recorder._hists.get(name, {}).values())
    counts = [0] * N_BUCKETS
    total = 0
    for h in series:
        c, _sum_ns, n = h.snapshot()
        for i, v in enumerate(c):
            counts[i] += v
        total += n
    return counts, total


def _family_counter_total(name: str) -> int:
    with _recorder._registry_lock:
        series = list(_recorder._counters.get(name, {}).values())
    return sum(c.value for c in series)


class SloSpec:
    """One objective: ``latency`` needs ``hist`` + ``threshold_s``;
    ``availability`` needs ``bad`` + ``total_hist``."""

    __slots__ = ("name", "kind", "objective", "hist", "threshold_s", "bad", "total_hist", "shed", "description")

    def __init__(
        self, name: str, kind: str, objective: float, hist: Optional[str] = None,
        threshold_s: Optional[float] = None, bad: Optional[str] = None,
        total_hist: Optional[str] = None, shed: bool = False, description: str = "",
    ):
        if kind not in ("latency", "availability"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if kind == "latency" and (hist is None or threshold_s is None):
            raise ValueError("latency spec needs hist + threshold_s")
        if kind == "availability" and (bad is None or total_hist is None):
            raise ValueError("availability spec needs bad + total_hist")
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1): {objective}")
        self.name = str(name)
        self.kind = kind
        self.objective = float(objective)
        self.hist = hist
        self.threshold_s = threshold_s
        self.bad = bad
        self.total_hist = total_hist
        self.shed = bool(shed)
        self.description = description

    def counts(self) -> Tuple[int, int, Optional[float]]:
        """Cumulative (good, total, effective threshold or None)."""
        if self.kind == "latency":
            bounds = bucket_bounds_s()
            cut = next((i for i, b in enumerate(bounds) if b >= float(self.threshold_s)), len(bounds) - 1)
            counts, total = _family_hist_counts(self.hist)
            return sum(counts[: cut + 1]), total, bounds[cut]
        total = _family_hist_counts(self.total_hist)[1]
        bad = min(_family_counter_total(self.bad), total)
        return total - bad, total, None


def default_specs() -> List[SloSpec]:
    """Serve latency and serve availability, both shed-enabled."""
    return [
        SloSpec(
            "serve_latency", "latency",
            objective=config.get("observe.slo_latency_objective"),
            hist="pathway_serve_request_seconds",
            threshold_s=config.get("observe.slo_latency_ms") * 1e-3,
            shed=True,
            description="serve requests at/under the latency threshold",
        ),
        SloSpec(
            "serve_availability", "availability",
            objective=config.get("observe.slo_availability"),
            bad="pathway_serve_degraded_total",
            total_hist="pathway_serve_request_seconds",
            shed=True,
            description="1 - degraded fraction (every ladder rung counts)",
        ),
    ]


class SloEngine:
    """Burn-rate evaluator over a spec list: each evaluation appends one
    cumulative (t, good, total) snapshot per spec to a bounded ring and
    differences against the oldest snapshot inside each window."""

    _RING = 512

    def __init__(self, specs: Optional[List[SloSpec]] = None):
        self.specs = list(specs) if specs is not None else default_specs()
        self.fast_window_s = config.get("observe.slo_fast_window_s")
        self.slow_window_s = max(self.fast_window_s, config.get("observe.slo_slow_window_s"))
        self.burn_threshold = config.get("observe.slo_burn")
        self.tick_s = config.get("observe.slo_tick_s")
        self._lock = threading.Lock()
        self._rings: Dict[str, List[Tuple[float, int, int]]] = {s.name: [] for s in self.specs}
        self._last_doc: Optional[Dict[str, Any]] = None
        self._last_eval_s = 0.0

    @staticmethod
    def _window_ratio(ring, now_s: float, window_s: float) -> Tuple[float, int]:
        """(error ratio, events) over the window ending now, from the
        oldest snapshot inside it."""
        if not ring:
            return 0.0, 0
        _t_now, good_now, total_now = ring[-1]
        base = next((snap for snap in ring if snap[0] >= now_s - window_s), ring[0])
        _t0, good0, total0 = base
        total_delta = total_now - total0
        if total_delta <= 0:
            return 0.0, 0
        bad_delta = max(0, (total_now - good_now) - (total0 - good0))
        return min(1.0, bad_delta / total_delta), total_delta

    def _evaluate_fresh(self, now_s: float) -> Dict[str, Any]:
        _C_EVALS.inc()
        slos: Dict[str, Any] = {}
        any_firing = shed = False
        for spec in self.specs:
            good, total, eff_threshold = spec.counts()
            ring = self._rings[spec.name]
            ring.append((now_s, good, total))
            del ring[: max(0, len(ring) - self._RING)]
            budget = 1.0 - spec.objective
            windows: Dict[str, Any] = {}
            burns: Dict[str, float] = {}
            for label, window_s in (("fast", self.fast_window_s), ("slow", self.slow_window_s)):
                ratio, events = self._window_ratio(ring, now_s, window_s)
                burns[label] = ratio / budget if budget > 0 else 0.0
                windows[label] = {
                    "window_s": window_s,
                    "error_ratio": round(ratio, 6),
                    "burn_rate": round(burns[label], 3),
                    "events": events,
                }
            firing = (
                windows["fast"]["events"] > 0
                and burns["fast"] >= self.burn_threshold
                and burns["slow"] >= self.burn_threshold
            )
            any_firing = any_firing or firing
            shed = shed or (firing and spec.shed)
            row = {
                "kind": spec.kind,
                "objective": spec.objective,
                "description": spec.description,
                "good": good,
                "total": total,
                "compliance": round(good / total, 6) if total else None,
                "windows": windows,
                "state": "firing" if firing else "ok",
                "shed": spec.shed,
            }
            if eff_threshold is not None:
                row["threshold_s"] = spec.threshold_s
                row["effective_threshold_s"] = eff_threshold
            slos[spec.name] = row
        return {
            "ts": time.time(),
            "stale": False,
            "burn_threshold": self.burn_threshold,
            "alerting": any_firing,
            "should_shed": shed,
            "slos": slos,
        }

    def evaluate(self, max_age_s: Optional[float] = None) -> Dict[str, Any]:
        """A fresh evaluation at most once per tick (``max_age_s``), the
        cached document otherwise."""
        age = self.tick_s if max_age_s is None else max_age_s
        now_s = time.monotonic()
        with self._lock:
            if self._last_doc is not None and now_s - self._last_eval_s < age:
                return self._last_doc
            if not _evaluate_allowed():
                _C_DROPPED.inc()
                if self._last_doc is not None:
                    return {**self._last_doc, "stale": True}
                return {
                    "ts": time.time(), "stale": True, "alerting": False, "should_shed": False,
                    "slos": {}, "burn_threshold": self.burn_threshold,
                }
            self._last_doc = self._evaluate_fresh(now_s)
            self._last_eval_s = now_s
            return self._last_doc

    def should_shed(self) -> bool:
        return bool(self.evaluate().get("should_shed"))

    def observe_metrics(self):
        for name, row in self.evaluate().get("slos", {}).items():
            labels = {"slo": name}
            yield ("gauge", "pathway_slo_objective", labels, row["objective"])
            yield ("gauge", "pathway_slo_alert", labels, 1.0 if row["state"] == "firing" else 0.0)
            for label, w in row["windows"].items():
                yield ("gauge", "pathway_slo_burn_rate", {**labels, "window": label}, w["burn_rate"])


_engine_lock = threading.Lock()
_engine: Optional[SloEngine] = None


def engine() -> SloEngine:
    """The process-wide engine, built lazily from the default specs."""
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = SloEngine()
            register_provider(_engine)
        return _engine


def should_shed() -> bool:
    """True while a shed-enabled objective fires; never raises, and off
    under ``observe.slo`` = 0."""
    if not config.get("observe.slo"):
        return False
    try:
        return engine().should_shed()
    except Exception:  # noqa: BLE001 - the probe may never fail an admission
        return False


def record_shed_advised() -> None:
    _C_SHED_ADVISED.inc()


def reset() -> None:
    """Drop the engine (the next probe rebuilds it from the knobs)."""
    global _engine
    with _engine_lock:
        _engine = None
