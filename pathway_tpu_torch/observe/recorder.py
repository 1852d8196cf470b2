"""The port's flight recorder (counterpart of
``pathway_tpu/observe/recorder.py``): a registry of histograms, counters
and gauges under the reference's family names, scrape-time providers,
and a bounded event ring.  The registry is the port's own: the
reference's ``observe`` registry never sees these series.

- histograms and counters are resolved once per (name, labels) and
  updated on the hot path with a few integer operations;
- providers (objects with ``observe_metrics()``) are held weakly and
  sampled only when someone renders or snapshots;
- ``render_prometheus`` gives the Prometheus text exposition, sorted
  by family and label set, one consistent snapshot per series; with
  ``openmetrics=True`` the kept traces' exemplars ride on the histogram
  bucket samples.
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from . import histogram as _hist_mod
from .histogram import EventRing, LatencyHistogram, bucket_bounds_s

__all__ = [
    "Counter",
    "Gauge",
    "count",
    "counter",
    "emit_span",
    "enabled",
    "gauge",
    "histogram",
    "next_id",
    "record_event",
    "record_occupancy",
    "register_provider",
    "render_prometheus",
    "reset",
    "set_enabled",
    "snapshot",
]

_LabelKey = Tuple[Tuple[str, str], ...]


def enabled() -> bool:
    return _hist_mod.enabled


def set_enabled(flag: bool) -> None:
    """Switch every record call of the port on or off (recorded data
    stays and keeps rendering)."""
    _hist_mod.enabled = bool(flag)


class Counter:
    """Monotone counter."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        if not _hist_mod.enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Last-write-wins gauge."""

    __slots__ = ("_value",)

    def __init__(self) -> None:
        self._value = 0.0

    def set(self, value: float) -> None:
        if _hist_mod.enabled:
            self._value = float(value)

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = 0.0


_registry_lock = threading.Lock()
_hists: Dict[str, Dict[_LabelKey, LatencyHistogram]] = {}
_counters: Dict[str, Dict[_LabelKey, Counter]] = {}
_gauges: Dict[str, Dict[_LabelKey, Gauge]] = {}
_providers: "weakref.WeakSet" = weakref.WeakSet()
_ring = EventRing(capacity=512)
_ids = itertools.count()


def next_id() -> int:
    """Process-unique integer for ``id`` labels of per-instance series."""
    return next(_ids)


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series(table: Dict[str, Dict[_LabelKey, Any]], make, name: str, labels: Dict[str, Any]):
    key = _label_key(labels)
    with _registry_lock:
        series = table.setdefault(name, {})
        obj = series.get(key)
        if obj is None:
            obj = series[key] = make()
        return obj


def histogram(name: str, **labels: Any) -> LatencyHistogram:
    """The (name, labels) histogram, created on first use."""
    return _series(_hists, LatencyHistogram, name, labels)


def counter(name: str, **labels: Any) -> Counter:
    return _series(_counters, Counter, name, labels)


def gauge(name: str, **labels: Any) -> Gauge:
    return _series(_gauges, Gauge, name, labels)


def count(name: str, n: int = 1, **labels: Any) -> None:
    """Counter increment with labels resolved per call, for sites whose
    label values vary at runtime (one registry lookup)."""
    if _hist_mod.enabled:
        counter(name, **labels).inc(n)


_occ_cache: Dict[Tuple[str, int], Tuple[Counter, Counter, Counter]] = {}


def record_occupancy(site: str, real: int, padded: int) -> None:
    """Batch occupancy of one dispatch: ``real`` rows of work inside
    ``padded`` bucketed rows, plus a counter on the bucket chosen."""
    if not _hist_mod.enabled:
        return
    key = (site, int(padded))
    trio = _occ_cache.get(key)
    if trio is None:
        trio = _occ_cache[key] = (
            counter("pathway_serve_pack_rows_total", site=site, kind="real"),
            counter("pathway_serve_pack_rows_total", site=site, kind="padded"),
            counter("pathway_serve_batch_bucket_total", site=site, bucket=str(padded)),
        )
    trio[0].inc(int(real))
    trio[1].inc(int(padded))
    trio[2].inc()


def record_event(kind: str, tag: str, dur_ns: int = 0, **extra: Any) -> None:
    """Append one serve-path event to the bounded ring."""
    if _hist_mod.enabled:
        _ring.append((time.time(), kind, tag, int(dur_ns), extra or None))


_telemetry = None
_spans_on: Optional[bool] = None


def emit_span(name: str, **attributes: Any) -> None:
    """A zero-duration span on the active trace (``observe/trace.py``)
    and, when a monitoring endpoint is configured
    (``PATHWAY_MONITORING_SERVER``) and ``opentelemetry`` is installed, an
    OTLP span through ``internals/telemetry.py`` carrying the same
    attributes.  The endpoint is read at the first call.  Gated on the
    same switch as every other record call: ``PATHWAY_OBSERVE=0``
    silences the export too."""
    global _telemetry, _spans_on
    if not _hist_mod.enabled:
        return
    from . import trace as _trace  # trace.py imports this module

    t = _trace.current()
    if t is not None:
        t.add_event(name, **attributes)
    if _spans_on is False:
        return
    if _spans_on is None:
        try:
            from ..internals.telemetry import NoopTelemetry, maybe_telemetry

            _telemetry = maybe_telemetry()
            _spans_on = not isinstance(_telemetry, NoopTelemetry)
        except Exception:  # noqa: BLE001 - telemetry never fails a serve
            _spans_on = False
        if not _spans_on:
            return
    try:
        with _telemetry.span(name, **attributes):
            pass
    except Exception:  # noqa: BLE001 - an exporter fault never fails a serve
        pass


def register_provider(obj: Any) -> None:
    """Weakly register an object whose ``observe_metrics()`` yields
    ``(kind, name, labels, value)`` with kind "gauge" or "counter"."""
    _providers.add(obj)


def _provider_samples() -> List[Tuple[str, str, _LabelKey, float]]:
    samples: List[Tuple[str, str, _LabelKey, float]] = []
    for obj in list(_providers):
        try:
            for kind, name, labels, value in obj.observe_metrics():
                samples.append((kind, name, _label_key(labels), float(value)))
        except Exception:  # noqa: BLE001 - a torn-down provider must not fail the scrape
            continue
    samples.sort(key=lambda s: (s[1], s[2]))
    return samples


def _escape(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key: _LabelKey, extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = list(key) + list(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in pairs) + "}"


def _fmt_exemplar(exemplars, i: int) -> str:
    """The OpenMetrics exemplar suffix of bucket ``i`` ('' when none)."""
    if exemplars is None or exemplars[i] is None:
        return ""
    trace_id, value_s, ts = exemplars[i]
    return f' # {{trace_id="{_escape(trace_id)}"}} {repr(value_s)} {ts:.3f}'


def _fmt_value(value: float) -> str:
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def _ring_health() -> List[Tuple[str, int, int]]:
    """(ring, capacity, dropped) for the event ring, the trace stores
    and an installed dispatch counter."""
    rows: List[Tuple[str, int, int]] = [("serve_events", _ring.capacity, _ring.dropped)]
    from . import trace as _trace
    from ..ops import dispatch_counter as _dc

    rows.extend(_trace.ring_stats())
    active = _dc._active
    if active is not None:
        rows.append(("dispatch_counter", active.max_events, active.events_dropped))
    return rows


def _copy_tables():
    with _registry_lock:
        return (
            {n: dict(s) for n, s in _hists.items()},
            {n: dict(s) for n, s in _counters.items()},
            {n: dict(s) for n, s in _gauges.items()},
        )


def render_prometheus(openmetrics: bool = False) -> List[str]:
    """Every series in the Prometheus text exposition format, families
    sorted by name and label set.  ``openmetrics=True`` appends each
    histogram bucket's exemplar (a kept trace's id, its duration and
    stamp: ``# {trace_id="..."} value ts``); that syntax is legal only in
    the OpenMetrics exposition, and a classic ``version=0.0.4`` parser
    fails the whole scrape on it, so the classic form carries none."""
    lines: List[str] = []
    bounds = bucket_bounds_s()
    hist_items, counter_items, gauge_items = _copy_tables()
    for name in sorted(hist_items):
        series = hist_items[name]
        if not series:
            continue
        lines.append(f"# TYPE {name} histogram")
        for key in sorted(series):
            counts, sum_ns, n = series[key].snapshot()
            exemplars = series[key].exemplars() if openmetrics else None
            cum = 0
            for i, bound in enumerate(bounds):
                cum += counts[i]
                lines.append(
                    f"{name}_bucket{_fmt_labels(key, (('le', repr(bound)),))} {cum}" + _fmt_exemplar(exemplars, i)
                )
            lines.append(
                f"{name}_bucket{_fmt_labels(key, (('le', '+Inf'),))} {n}" + _fmt_exemplar(exemplars, len(bounds))
            )
            lines.append(f"{name}_sum{_fmt_labels(key)} {sum_ns * 1e-9:.9f}")
            lines.append(f"{name}_count{_fmt_labels(key)} {n}")
    prov: Dict[str, Dict[str, List[Tuple[_LabelKey, float]]]] = {"counter": {}, "gauge": {}}
    for kind, name, key, value in _provider_samples():
        prov["counter" if kind == "counter" else "gauge"].setdefault(name, []).append((key, value))
    for kind, items in (("counter", counter_items), ("gauge", gauge_items)):
        for name in sorted(set(items) | set(prov[kind])):
            rows = [(key, float(s.value)) for key, s in items.get(name, {}).items()] + prov[kind].get(name, [])
            if not rows:
                continue
            lines.append(f"# TYPE {name} {kind}")
            for key, value in sorted(rows):
                lines.append(f"{name}{_fmt_labels(key)} {_fmt_value(value)}")
    rings = _ring_health()
    lines.append("# TYPE pathway_observe_events_dropped_total counter")
    lines.extend(f'pathway_observe_events_dropped_total{{ring="{r}"}} {d}' for r, _c, d in rings)
    lines.append("# TYPE pathway_observe_ring_capacity gauge")
    lines.extend(f'pathway_observe_ring_capacity{{ring="{r}"}} {c}' for r, c, _d in rings)
    return lines


def snapshot() -> Dict[str, Any]:
    """JSON-able view: histogram summaries (count, sum, p50/p95/p99
    bucket bounds), counters, gauges (provider samples included), a
    per-shard column (samples labeled ``shard``), a per-tier cache
    column (``tier``), a per-engine ``generators`` column (``generator``:
    the continuous decoders' slots, tokens and requests) and a per-runner
    ingest column (``ingest``), the other labels staying on the key; the
    profiler's per-callable ``profile`` column, the ledger's ``hbm``
    column, the SLO engine's burn-rate document (``slo``), ring health
    and the recent event ring."""
    hist_items, counter_items, gauge_items = _copy_tables()
    hists = {}
    for name, series in hist_items.items():
        for key, h in series.items():
            _counts, sum_ns, n = h.snapshot()
            hists[name + _fmt_labels(key)] = {
                "count": n,
                "sum_s": sum_ns * 1e-9,
                "p50_s": h.quantile_s(0.50),
                "p95_s": h.quantile_s(0.95),
                "p99_s": h.quantile_s(0.99),
            }
    counters = {n + _fmt_labels(k): c.value for n, s in counter_items.items() for k, c in s.items()}
    gauges = {n + _fmt_labels(k): g.value for n, s in gauge_items.items() for k, g in s.items()}
    # provider samples labeled shard=..., tier=... (cache tiers),
    # generator=... (decode engines) and ingest=... (live-ingest runners)
    # also land in a column per shard / tier / engine / runner
    shards: Dict[str, Dict[str, float]] = {}
    caches: Dict[str, Dict[str, float]] = {}
    generators: Dict[str, Dict[str, float]] = {}
    ingests: Dict[str, Dict[str, float]] = {}
    for kind, name, key, value in _provider_samples():
        (counters if kind == "counter" else gauges)[name + _fmt_labels(key)] = value
        labels = dict(key)
        for label, column in (("shard", shards), ("tier", caches), ("generator", generators), ("ingest", ingests)):
            owner = labels.get(label)
            if owner is not None:
                rest = tuple((lk, lv) for lk, lv in key if lk != label)
                column.setdefault(owner, {})[name + _fmt_labels(rest)] = value
    events, total = _ring.snapshot()
    # device-time attribution, the device-memory ledger and the burn-rate
    # document ride along, so one read answers who owns device time, who
    # owns its memory and whether the objectives are in budget
    from . import hbm as _hbm
    from . import profile as _profile
    from . import slo as _slo

    return {
        "enabled": _hist_mod.enabled,
        "rings": {r: {"capacity": c, "dropped": d} for r, c, d in _ring_health()},
        "histograms": hists,
        "counters": counters,
        "gauges": gauges,
        "shards": {k: shards[k] for k in sorted(shards, key=lambda sh: (0, int(sh)) if sh.isdigit() else (1, sh))},
        "caches": {k: caches[k] for k in sorted(caches)},
        "generators": {k: generators[k] for k in sorted(generators)},
        "ingest": {k: ingests[k] for k in sorted(ingests)},
        "profile": _profile.profile_stats(),
        "hbm": _hbm.ledger_stats(),
        "slo": _slo.evaluate(),
        "events": [
            {"ts": e[0], "kind": e[1], "tag": e[2], "dur_ns": e[3], **(e[4] or {})} for e in events
        ],
        "events_total": total,
    }


def reset() -> None:
    """Zero every series and the event ring, keeping the series objects
    (instrumentation sites hold references to them)."""
    with _registry_lock:
        for table in (_hists, _counters, _gauges):
            for series in table.values():
                for s in series.values():
                    s.reset()
    _ring.reset()
