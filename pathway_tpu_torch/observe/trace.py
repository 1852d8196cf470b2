"""Per-request span trees with tail-based sampling (counterpart of
``pathway_tpu/observe/trace.py``), under the reference's span names.

A ``TraceContext`` is created at ``ServeScheduler.submit`` admission and
carried on the request; the scheduler activates it (``use``) around the
hops that run on other threads, so every site reaches it with one
``current()`` call.  Requests sharing a coalesced batch each hold a
``batch`` link span to ONE batch trace that records the shared work
(``stage1.dispatch`` / ``stage1.fetch`` / ``stage1.postprocess``, the
cascade's ``stage.<name>`` spans, ``stage2.pack_dispatch`` /
``stage2.rtt``).  Spans carry explicit timestamps: the serve path reuses
the clock reads it takes for its histograms.

The keep decision runs at ``finish``: forced, degraded, deadline
expired, slow (the ``observe.trace_slow_pct`` quantile, once it holds 64
observations, of ``pathway_serve_request_seconds`` for request traces
and of ``pathway_freshness_seconds`` for the ingest runner's
``kind="ingest"`` batch traces), or linked from a kept rider.  Kept
traces land in a bounded LRU store (``snapshot_traces`` /
``get_trace``); the rest wait in a bounded pending ring.  The
``trace.record`` / ``trace.export`` fault sites drop spans or exports
(counted), never a serve.
"""

from __future__ import annotations

import itertools
import random
import threading
import time
from collections import OrderedDict
from contextvars import ContextVar
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import config
from . import histogram as _hist_mod
from .recorder import counter, histogram, register_provider

__all__ = [
    "TraceContext",
    "current",
    "finish",
    "get_trace",
    "reset",
    "ring_stats",
    "sample_rate",
    "set_sample",
    "snapshot_traces",
    "start_trace",
    "stats",
    "use",
]

_KEEP_CAPACITY = config.get("observe.trace_keep")
_PENDING_CAPACITY = config.get("observe.trace_pending")
_MAX_SPANS = config.get("observe.trace_max_spans")
_SLOW_PCT = config.get("observe.trace_slow_pct")
_SLOW_MIN_COUNT = 64
_sample = config.get("observe.trace_sample")

# request latency: the tail sampler's "slow" source and the exemplar family
_H_REQUEST = histogram("pathway_serve_request_seconds")
# arrival to retrievable, observed per document by serve/ingest.py: the
# "slow" source of kind="ingest" traces
_H_INGEST = histogram("pathway_freshness_seconds")
_SLOW_HISTS = {"request": _H_REQUEST, "ingest": _H_INGEST}
_C_SPANS_DROPPED = counter("pathway_trace_spans_dropped_total")
_C_SAMPLED_OUT = counter("pathway_trace_sampled_out_total")
_C_EXPORT_FAILURES = counter("pathway_trace_export_failures_total")
_kept_counters: Dict[str, Any] = {}

_NONCE = f"{random.SystemRandom().getrandbits(32):08x}"
_ids = itertools.count(1)
_rng = random.Random(0x7A3CE)  # head-sampling draws, seeded

_CURRENT: "ContextVar[Optional[TraceContext]]" = ContextVar("pathway_tpu_torch_trace", default=None)

_store_lock = threading.Lock()
_kept: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
_pending: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
_kept_evicted = 0
_pending_evicted = 0
_started = 0


def _kept_counter(reason: str):
    c = _kept_counters.get(reason)
    if c is None:
        c = _kept_counters[reason] = counter("pathway_trace_kept_total", reason=reason)
    return c


def _record_allowed(site: str) -> bool:
    """Fault gate of the tracing path: any armed fault at ``site``
    (fired under an already-spent deadline, so a hang releases at once)
    drops the span or export."""
    from ..robust import inject  # robust imports this package
    from ..robust.deadline import Deadline

    if not inject.any_armed():
        return True
    try:
        before = inject.fired_count(site)
        inject.fire(site, deadline=Deadline.after_ms(0.0))
        return inject.fired_count(site) == before
    except Exception:  # noqa: BLE001 - a faulted tracing path drops, never fails
        return False


class TraceContext:
    """One trace: root span (id 1) plus a bounded span buffer.  Span
    tuples are ``(span_id, parent_id, name, t0_ns, dur_ns, status,
    attrs|None, exemplar_hist|None)``."""

    __slots__ = (
        "trace_id", "name", "kind", "t0_ns", "deadline", "spans", "statuses",
        "links", "attrs", "dispatches", "fetches", "physical_dispatches",
        "dropped", "finished", "force_keep", "_lock", "_next_sid",
    )

    def __init__(self, name: str, kind: str, deadline=None):
        self.trace_id = f"{_NONCE}{next(_ids):08x}"
        self.name = str(name)
        self.kind = str(kind)
        self.t0_ns = time.perf_counter_ns()
        self.deadline = deadline
        self.spans: List[tuple] = []
        self.statuses: List[str] = []
        self.links: List[str] = []
        self.attrs: Dict[str, Any] = {}
        self.dispatches = 0
        self.fetches = 0
        self.physical_dispatches = 0
        self.dropped = 0
        self.finished = False
        self.force_keep = False
        self._lock = threading.Lock()
        self._next_sid = 2

    def add_span(
        self, name: str, t0_ns: int, t1_ns: int, status: str = "ok",
        parent: int = 1, exemplar=None, **attrs: Any,
    ) -> int:
        """Record one finished span; ``exemplar`` is the histogram the
        duration was also observed into.  Returns the span id, 0 when
        dropped (trace full or finished, or the fault site armed)."""
        if not _record_allowed("trace.record"):
            with self._lock:
                self.dropped += 1
            _C_SPANS_DROPPED.inc()
            return 0
        with self._lock:
            if self.finished or len(self.spans) >= _MAX_SPANS:
                self.dropped += 1
                _C_SPANS_DROPPED.inc()
                return 0
            sid = self._next_sid
            self._next_sid += 1
            self.spans.append((
                sid, int(parent), str(name), int(t0_ns), max(0, int(t1_ns) - int(t0_ns)),
                str(status), attrs or None, exemplar,
            ))
        return sid

    def add_event(self, name: str, status: str = "ok", **attrs: Any) -> int:
        """A zero-duration span stamped now."""
        t = time.perf_counter_ns()
        return self.add_span(name, t, t, status=status, **attrs)

    def annotate(self, **attrs: Any) -> None:
        with self._lock:
            self.attrs.update(attrs)

    def set_status(self, reason: str) -> None:
        """Record one degradation rung (deduplicated)."""
        with self._lock:
            if str(reason) not in self.statuses:
                self.statuses.append(str(reason))

    def add_link(self, trace_id: str) -> None:
        with self._lock:
            if trace_id not in self.links:
                self.links.append(trace_id)

    def note_dispatch(self, tag: str, shards: int = 1) -> None:
        self.dispatches += 1
        self.physical_dispatches += max(1, int(shards))

    def note_fetch(self, tag: str, shards: int = 1) -> None:
        self.fetches += 1


class _Activation:
    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx

    def __enter__(self) -> Optional[TraceContext]:
        self._token = _CURRENT.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc) -> None:
        _CURRENT.reset(self._token)


def use(ctx: Optional[TraceContext]) -> _Activation:
    """Install ``ctx`` as this thread's current trace for a ``with``."""
    return _Activation(ctx)


def current() -> Optional[TraceContext]:
    return _CURRENT.get()


def start_trace(
    name: str, deadline=None, kind: str = "request", sample: bool = True
) -> Optional[TraceContext]:
    """A new trace, or None when the recorder is off or head sampling
    passes; ``sample=False`` skips the draw (batch traces)."""
    global _started
    if not _hist_mod.enabled:
        return None
    if sample:
        if _sample <= 0.0 or (_sample < 1.0 and _rng.random() >= _sample):
            return None
    _started += 1
    return TraceContext(name, kind, deadline)


def set_sample(p: float) -> None:
    """Head-sampling probability (also ``PATHWAY_TRACE_SAMPLE``): 1.0
    traces every request, 0.0 none."""
    global _sample
    _sample = min(1.0, max(0.0, float(p)))


def sample_rate() -> float:
    return _sample


def _keep_reason(ctx: TraceContext, dur_ns: int) -> Optional[str]:
    if ctx.force_keep:
        return "forced"
    if ctx.statuses:
        return "degraded"
    if ctx.deadline is not None and ctx.deadline.expired():
        return "deadline"
    h = _SLOW_HISTS.get(ctx.kind)
    if h is not None and h.count >= _SLOW_MIN_COUNT:
        q = h.quantile_s(_SLOW_PCT)
        if q is not None and dur_ns * 1e-9 >= q:
            return "slow"
    return None


def _keep(record: Dict[str, Any], reason: str) -> None:
    global _kept_evicted
    record["keep_reason"] = reason
    tid = record["trace_id"]
    for span in record["_spans"]:
        if span[7] is not None:
            span[7].set_exemplar(span[4], tid)
    if record["kind"] == "request":
        _H_REQUEST.set_exemplar(record["_dur_ns"], tid)
    with _store_lock:
        _pending.pop(tid, None)
        _kept[tid] = record
        while len(_kept) > _KEEP_CAPACITY:
            _kept.popitem(last=False)
            _kept_evicted += 1
    _kept_counter(reason).inc()


def finish(
    ctx: Optional[TraceContext], statuses: Sequence[str] = (), force_keep: bool = False
) -> Optional[str]:
    """End a trace and run the tail sampler (idempotent).  Returns the
    keep reason, or None when parked in the pending ring."""
    global _pending_evicted
    if ctx is None:
        return None
    for s in statuses:
        ctx.set_status(s)
    if force_keep:
        ctx.force_keep = True
    with ctx._lock:
        if ctx.finished:
            return None
        ctx.finished = True
        spans = list(ctx.spans)
        links = list(ctx.links)
    dur_ns = time.perf_counter_ns() - ctx.t0_ns
    if ctx.kind == "request":
        _H_REQUEST.observe_ns(dur_ns)
    record: Dict[str, Any] = {
        "trace_id": ctx.trace_id,
        "name": ctx.name,
        "kind": ctx.kind,
        "ts": time.time(),
        "duration_ms": dur_ns * 1e-6,
        "statuses": list(ctx.statuses),
        "dispatches": ctx.dispatches,
        "physical_dispatches": ctx.physical_dispatches,
        "fetches": ctx.fetches,
        "spans_dropped": ctx.dropped,
        "attrs": dict(ctx.attrs),
        "links": links,
        "keep_reason": None,
        "_t0_ns": ctx.t0_ns,
        "_dur_ns": dur_ns,
        "_spans": spans,
    }
    reason = _keep_reason(ctx, dur_ns)
    if reason is None:
        with _store_lock:
            _pending[ctx.trace_id] = record
            while len(_pending) > _PENDING_CAPACITY:
                _pending.popitem(last=False)
                _pending_evicted += 1
        _C_SAMPLED_OUT.inc()
        return None
    _keep(record, reason)
    for lid in links:
        with _store_lock:
            linked = _pending.pop(lid, None)
        if linked is not None:
            _keep(linked, "linked")
    return reason


def _tree(record: Dict[str, Any], index: Dict[str, Dict[str, Any]], inline: bool = True) -> Dict[str, Any]:
    """One kept trace as a JSON span tree; a link span whose batch trace
    is also kept carries that tree under ``linked`` (one level deep)."""
    root: Dict[str, Any] = {
        "span_id": 1,
        "parent_id": 0,
        "name": record["name"],
        "start_ms": 0.0,
        "duration_ms": record["duration_ms"],
        "status": "degraded" if record["statuses"] else "ok",
        "children": [],
    }
    nodes: Dict[int, Dict[str, Any]] = {1: root}
    for sid, parent, name, t0, dur, status, attrs, _ex in sorted(record["_spans"], key=lambda s: (s[3], s[0])):
        d: Dict[str, Any] = {
            "span_id": sid,
            "parent_id": parent,
            "name": name,
            "start_ms": (t0 - record["_t0_ns"]) * 1e-6,
            "duration_ms": dur * 1e-6,
            "status": status,
            "children": [],
        }
        if attrs:
            d["attrs"] = dict(attrs)
            linked = index.get(attrs.get("linked_trace")) if inline else None
            if linked is not None:
                d["linked"] = _tree(linked, index, inline=False)
        nodes[sid] = d
        nodes.get(parent, root)["children"].append(d)
    out = {k: v for k, v in record.items() if not k.startswith("_")}
    out["root"] = root
    return out


def snapshot_traces(limit: Optional[int] = None) -> Dict[str, Any]:
    """Kept traces, newest first, as span trees, plus sampler counters;
    a faulted export (``trace.export``) gives an empty flagged payload."""
    base: Dict[str, Any] = {
        "enabled": _hist_mod.enabled,
        "sample": _sample,
        "capacity": _KEEP_CAPACITY,
        "started_total": _started,
        "sampled_out_total": _C_SAMPLED_OUT.value,
        "spans_dropped_total": _C_SPANS_DROPPED.value,
    }
    if not _record_allowed("trace.export"):
        _C_EXPORT_FAILURES.inc()
        return {**base, "traces": [], "export_failed": True}
    with _store_lock:
        records = list(_kept.values())
    index = {r["trace_id"]: r for r in records}
    if limit is not None and limit > 0:
        records = records[-int(limit):]
    return {**base, "traces": [_tree(r, index) for r in reversed(records)], "export_failed": False}


def get_trace(trace_id: str) -> Optional[Dict[str, Any]]:
    """One kept trace's span tree by id, or None."""
    with _store_lock:
        record = _kept.get(trace_id)
        index = dict(_kept)
    return None if record is None else _tree(record, index)


def stats() -> Dict[str, int]:
    with _store_lock:
        kept, pending = len(_kept), len(_pending)
    return {
        "started": _started,
        "kept": kept,
        "pending": pending,
        "kept_evicted": _kept_evicted,
        "pending_evicted": _pending_evicted,
        "spans_dropped": _C_SPANS_DROPPED.value,
        "sampled_out": _C_SAMPLED_OUT.value,
    }


def ring_stats() -> List[Tuple[str, int, int]]:
    return [
        ("trace_kept", _KEEP_CAPACITY, _kept_evicted),
        ("trace_pending", _PENDING_CAPACITY, _pending_evicted),
    ]


def reset() -> None:
    """Drop every kept and pending trace."""
    global _kept_evicted, _pending_evicted, _started
    with _store_lock:
        _kept.clear()
        _pending.clear()
        _kept_evicted = 0
        _pending_evicted = 0
    _started = 0


class _TraceProvider:
    def observe_metrics(self):
        with _store_lock:
            kept, pending = len(_kept), len(_pending)
        yield ("gauge", "pathway_trace_store_entries", {"store": "kept"}, kept)
        yield ("gauge", "pathway_trace_store_entries", {"store": "pending"}, pending)


_provider = _TraceProvider()
register_provider(_provider)
