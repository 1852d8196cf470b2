"""Declarative SLOs with multi-window burn-rate evaluation (counterpart
of ``pathway_tpu/observe/slo.py``), read from the port's recorder.

- ``kind="latency"``: the share of a histogram family's events at or
  under ``threshold_s`` (snapped up to the power-of-two bucket bound);
- ``kind="availability"``: 1 - bad / total, bad from a counter family
  summed over its label sets, total from a histogram family's count;
- ``kind="freshness"``: latency-shaped over the ingest plane's
  ``pathway_freshness_seconds`` (arrival to retrievable), plus every
  document a live ingest runner still holds past the threshold, counted
  as a bad event now: the burn rises while a backlog ages, not only
  after it lands.

The burn rate of a window is its error ratio over the error budget
``1 - objective``; a spec fires when its fast AND slow windows both burn
past ``observe.slo_burn``.  Windows difference cumulative (good, total)
snapshots taken at each evaluation, throttled to one per
``observe.slo_tick_s``.  ``should_shed()`` is the scheduler's admission
probe: True while a ``shed=True`` spec fires; ``firing_specs()`` names
the firing objectives, so the ingest runner can tell a serve-latency
burn (yield absorb cadence) from a freshness burn.  ``observe.slo``
(read at import) and ``set_shed_advisory`` switch both probes.  A fault
at the ``slo.evaluate`` site serves the last document marked stale.

``default_specs`` holds serve latency, serve availability and ingest
freshness (all shed) and the observe-only ``decode_ttlt`` objective
over ``pathway_generator_ttlt_seconds`` (``observe.slo_ttlt_ms``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import config
from . import recorder as _recorder
from .histogram import N_BUCKETS, bucket_bounds_s
from .recorder import counter, register_provider

__all__ = [
    "SloEngine",
    "SloSpec",
    "default_specs",
    "engine",
    "evaluate",
    "firing_specs",
    "record_shed_advised",
    "reset",
    "set_engine",
    "set_shed_advisory",
    "shed_advisory_enabled",
    "should_shed",
]

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


def _good_under_threshold(name: str, threshold_s: float) -> Tuple[int, int, float]:
    """(good, total, effective threshold) of a latency objective: good =
    events whose bucket bound is at or under the threshold snapped up."""
    bounds = bucket_bounds_s()
    cut = next((i for i, b in enumerate(bounds) if b >= threshold_s), len(bounds) - 1)
    counts, total = _family_hist_counts(name)
    return sum(counts[: cut + 1]), total, bounds[cut]


def _overdue_pending(threshold_s: float) -> int:
    """Documents a live ingest runner has held longer than the freshness
    threshold: budget already spent that no histogram has seen yet."""
    from ..serve.ingest import ingest_runners  # serve/ingest.py imports this module

    n = 0
    for runner in ingest_runners():
        try:
            n += runner.overdue_pending(threshold_s)
        except Exception:  # noqa: BLE001 - a runner mid-teardown counts nothing
            continue
    return n


class SloSpec:
    """One objective: ``latency`` and ``freshness`` need ``hist`` +
    ``threshold_s``; ``availability`` needs ``bad`` + ``total_hist``."""

    __slots__ = ("name", "kind", "objective", "hist", "threshold_s", "bad", "total_hist", "shed", "description")

    def __init__(
        self, name: str, kind: str, objective: float, hist: Optional[str] = None,
        threshold_s: Optional[float] = None, bad: Optional[str] = None,
        total_hist: Optional[str] = None, shed: bool = False, description: str = "",
    ):
        if kind not in ("latency", "availability", "freshness"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if kind in ("latency", "freshness") and (hist is None or threshold_s is None):
            raise ValueError(f"{kind} spec needs hist + threshold_s")
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
            return _good_under_threshold(self.hist, float(self.threshold_s))
        if self.kind == "freshness":
            good, total, eff = _good_under_threshold(self.hist, float(self.threshold_s))
            # overdue residents add bad events to the total only; once
            # they land the histogram holds them (the windows difference
            # cumulative snapshots, so nothing counts twice)
            return good, total + _overdue_pending(float(self.threshold_s)), eff
        total = _family_hist_counts(self.total_hist)[1]
        bad = min(_family_counter_total(self.bad), total)
        return total - bad, total, None


def default_specs() -> List[SloSpec]:
    """Serve latency, serve availability and ingest freshness, all
    shed-enabled; decode TTLT, observe-only."""
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
        SloSpec(
            "decode_ttlt", "latency",
            objective=0.99,
            hist="pathway_generator_ttlt_seconds",
            threshold_s=config.get("observe.slo_ttlt_ms") * 1e-3,
            description="decode requests at/under the TTLT threshold",
        ),
        SloSpec(
            "freshness", "freshness",
            objective=config.get("observe.slo_freshness_objective"),
            hist="pathway_freshness_seconds",
            threshold_s=config.get("observe.slo_freshness_ms") * 1e-3,
            shed=True,
            description="documents retrievable within the freshness "
            "threshold (overdue pending docs count against it)",
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
_shed_on = config.get("observe.slo")


def engine() -> SloEngine:
    """The process-wide engine, built lazily from the default specs."""
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = SloEngine()
            register_provider(_engine)
        return _engine


def set_engine(specs: Optional[List[SloSpec]]) -> SloEngine:
    """Install a fresh engine over ``specs`` (None: the default specs,
    re-read from the knobs)."""
    global _engine
    with _engine_lock:
        _engine = SloEngine(specs)
        register_provider(_engine)
        return _engine


def evaluate(max_age_s: Optional[float] = None) -> Dict[str, Any]:
    """The process engine's burn-rate document (the ``GET /slo`` body)."""
    return engine().evaluate(max_age_s)


def shed_advisory_enabled() -> bool:
    return _shed_on


def set_shed_advisory(flag: bool) -> None:
    """Switch the shed and firing probes (``observe.slo`` at import)."""
    global _shed_on
    _shed_on = bool(flag)


def should_shed() -> bool:
    """True while a shed-enabled objective fires; never raises."""
    if not _shed_on:
        return False
    try:
        return engine().should_shed()
    except Exception:  # noqa: BLE001 - the probe may never fail an admission
        return False


def record_shed_advised() -> None:
    _C_SHED_ADVISED.inc()


def firing_specs() -> Tuple[str, ...]:
    """Names of the objectives firing in the throttled evaluation (the
    ingest runner's backpressure probe); empty while the probes are off."""
    if not _shed_on:
        return ()
    try:
        doc = engine().evaluate()
    except Exception:  # noqa: BLE001 - a failed probe reads as quiet
        return ()
    return tuple(name for name, row in doc.get("slos", {}).items() if row.get("state") == "firing")


def reset() -> None:
    """Drop the engine (the next probe rebuilds it from the knobs)."""
    global _engine
    with _engine_lock:
        _engine = None
