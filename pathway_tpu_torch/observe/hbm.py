"""The device-memory ledger (counterpart of ``pathway_tpu/observe/hbm.py``):
which subsystem owns the card's memory, and when a bounded resource
runs out.

Every long-lived structure on the device registers here: the IVF slabs
and the cached exact tail, the exact index, the forward index's row
buckets, the continuous decoder's slot pool, the embedding and prefix
cache tiers, the parameters and buffers of the encoder, cross-encoder
and generator modules.  The ledger is pull-based: registration stores a
weak reference and a byte-reporting callback, and bytes are read only
when someone samples (scrape, ``observe.snapshot()``, a check), never
on the serve path.  A tensor's byte count is metadata, so a sample
never waits for the device.

A sample gives per-structure ``pathway_hbm_bytes{subsystem,component}``
(summed across instances), ``pathway_hbm_total_bytes`` and its
high-water mark ``pathway_hbm_watermark_bytes``, the allocator's own
count ``pathway_hbm_device_bytes``, and for registered capacity-bounded
resources (decode slots, forward-index rows, cache byte budgets)
``pathway_hbm_resource_used`` / ``_capacity`` and
``pathway_hbm_exhaustion_eta_seconds{resource}`` from an EWMA of the
observed growth (-1 when not growing).

``device_bytes()`` differs from the reference's: it is
``torch.cuda.memory_allocated()`` on the card, which also counts the
cuBLAS workspace and transient tensors no registrant owns, so the
cross-check against the ledger is a DELTA around building the tracked
structures after warm-up; on the CPU it is ``None`` (the port has no
counterpart of ``jax.live_arrays()``).

Degrade, never fail: the ``hbm.ledger`` fault site fires on the sample
path under a spent deadline, and an armed fault returns the last sample
marked stale, counted on ``pathway_hbm_samples_dropped_total``; a
registrant whose callback raises is skipped.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .recorder import counter, register_provider

__all__ = [
    "device_bytes", "ledger_stats", "reset", "sample", "track", "track_params", "track_resource", "tree_nbytes",
]

_lock = threading.Lock()
# (subsystem, weakref(obj), fn) with fn(obj) -> {component: bytes}
_tracked: List[Tuple[str, "weakref.ref", Callable[[Any], Dict[str, int]]]] = []
# (name, weakref(obj), used_fn, cap_fn)
_resources: List[Tuple[str, "weakref.ref", Callable[[Any], float], Callable[[Any], float]]] = []
# name -> (t_s, used, EWMA growth rate per s) of the last growth observation
_growth: Dict[str, Tuple[float, float, float]] = {}

_watermark = 0
_last_sample: Optional[Dict[str, Any]] = None
_last_sample_t = 0.0
_registered = False

_EWMA_ALPHA = 0.5  # recent growth dominates: exhaustion is a question about now
# observations closer together than this keep the previous point and
# rate: back-to-back samples would otherwise halve the rate with zeros
_MIN_GROWTH_DT_S = 0.05


class _Provider:
    """The ledger as gauges on the one scrape surface."""

    def observe_metrics(self):
        doc = sample()
        for subsystem, parts in doc["subsystems"].items():
            for component, nbytes in parts.items():
                yield ("gauge", "pathway_hbm_bytes", {"subsystem": subsystem, "component": component}, nbytes)
        yield ("gauge", "pathway_hbm_total_bytes", {}, doc["total_bytes"])
        yield ("gauge", "pathway_hbm_watermark_bytes", {}, doc["watermark_bytes"])
        if doc["device_bytes"] is not None:
            yield ("gauge", "pathway_hbm_device_bytes", {}, doc["device_bytes"])
        for name, row in doc["resources"].items():
            labels = {"resource": name}
            yield ("gauge", "pathway_hbm_resource_used", labels, row["used"])
            yield ("gauge", "pathway_hbm_resource_capacity", labels, row["capacity"])
            yield ("gauge", "pathway_hbm_exhaustion_eta_seconds", labels, row["exhaustion_eta_s"])


_provider = _Provider()


def _register() -> None:
    """Register the provider at the first registrant (never at import)."""
    global _registered
    if not _registered:
        _registered = True
        register_provider(_provider)


def _sample_allowed() -> bool:
    """Fault gate (site ``hbm.ledger``), fired under a spent deadline:
    any firing serves the stale sample."""
    from ..robust import inject
    from ..robust.deadline import Deadline

    if not inject.any_armed():
        return True
    try:
        before = inject.fired_count("hbm.ledger")
        inject.fire("hbm.ledger", deadline=Deadline.after_ms(0.0))
        return inject.fired_count("hbm.ledger") == before
    except Exception:  # noqa: BLE001 - any armed fault serves the stale sample
        return False


def tree_nbytes(tree: Any) -> int:
    """Total ``.nbytes`` over nested dicts, tuples and lists of tensors
    or arrays (metadata only, no sync)."""
    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        nb = getattr(x, "nbytes", None)
        if nb is not None and not isinstance(x, (str, bytes)):
            total += int(nb)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
    return total


def _module_nbytes(module: torch.nn.Module) -> int:
    """Bytes of a module's parameters and buffers (shared ones once)."""
    total = sum(p.numel() * p.element_size() for p in module.parameters())
    return total + sum(b.numel() * b.element_size() for b in module.buffers())


def track(subsystem: str, obj: Any, fn: Optional[Callable[[Any], Dict[str, int]]] = None) -> None:
    """Register ``obj`` as an owner of device memory under ``subsystem``.
    ``fn(obj)`` returns ``{component: bytes}``; the default reads
    ``obj.hbm_bytes()`` (an int is one ``total`` component).  Weakly
    held: a collected structure leaves the ledger by itself."""
    if fn is None:
        def fn(o):  # noqa: E306 - default byte reader
            got = o.hbm_bytes()
            return got if isinstance(got, dict) else {"total": int(got)}

    with _lock:
        _tracked.append((str(subsystem), weakref.ref(obj), fn))
    _register()


def track_params(name: str, model: Any) -> None:
    """Register a model's parameters and buffers (``model.module``)
    under ``params/<name>``."""
    track("params", model, lambda m, _n=str(name): {_n: _module_nbytes(m.module)})


def track_resource(name: str, obj: Any, used_fn: Callable[[Any], float], cap_fn: Callable[[Any], float]) -> None:
    """Register a capacity-bounded resource for the exhaustion ETA; the
    rate comes from successive samples, as observed."""
    with _lock:
        _resources.append((str(name), weakref.ref(obj), used_fn, cap_fn))
    _register()


def device_bytes() -> Optional[int]:
    """The allocator's own count: ``torch.cuda.memory_allocated()`` on
    the card, ``None`` without one."""
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.memory_allocated())


def _sample_resources(now_s: float) -> Dict[str, Dict[str, float]]:
    # used / capacity summed across registrants sharing a name first, so
    # growth comes from one total per resource
    totals: Dict[str, Tuple[float, float]] = {}
    with _lock:
        live = [r for r in _resources if r[1]() is not None]
        _resources[:] = live
    for name, ref, used_fn, cap_fn in live:
        obj = ref()
        if obj is None:
            continue
        try:
            used = float(used_fn(obj))
            cap = float(cap_fn(obj))
        except Exception:  # noqa: BLE001 - one bad registrant never poisons the sample
            continue
        u0, c0 = totals.get(name, (0.0, 0.0))
        totals[name] = (u0 + used, c0 + cap)
    out: Dict[str, Dict[str, float]] = {}
    for name, (used, cap) in totals.items():
        prev = _growth.get(name)
        rate = 0.0
        if prev is None:
            _growth[name] = (now_s, used, rate)
        else:
            t_prev, used_prev, rate_prev = prev
            dt = now_s - t_prev
            if dt < _MIN_GROWTH_DT_S:
                rate = rate_prev  # too soon to say anything about growth
            else:
                inst = max(0.0, (used - used_prev) / dt)  # growth only
                rate = _EWMA_ALPHA * inst + (1 - _EWMA_ALPHA) * rate_prev
                _growth[name] = (now_s, used, rate)
        headroom = max(0.0, cap - used)
        out[name] = {
            "used": used,
            "capacity": cap,
            "growth_per_s": rate,
            "exhaustion_eta_s": headroom / rate if rate > 1e-9 else -1.0,
        }
    return out


def sample(max_age_s: float = 0.0) -> Dict[str, Any]:
    """Read every registrant into one ledger sample (kept as the stale
    fallback).  ``max_age_s > 0`` reuses a sample that fresh."""
    global _watermark, _last_sample, _last_sample_t
    if max_age_s > 0.0 and _last_sample is not None and time.monotonic() - _last_sample_t < max_age_s:
        return _last_sample
    if not _sample_allowed():
        counter("pathway_hbm_samples_dropped_total").inc()
        if _last_sample is not None:
            return {**_last_sample, "stale": True}
        return {"stale": True, "subsystems": {}, "total_bytes": 0, "watermark_bytes": _watermark,
                "device_bytes": None, "resources": {}}
    now_s = time.monotonic()
    with _lock:
        live = [r for r in _tracked if r[1]() is not None]
        _tracked[:] = live
    by_key: Dict[Tuple[str, str], int] = {}
    for subsystem, ref, fn in live:
        obj = ref()
        if obj is None:
            continue
        try:
            parts = fn(obj)
        except Exception:  # noqa: BLE001 - a half-torn-down registrant is skipped
            continue
        for component, nbytes in parts.items():
            key = (subsystem, str(component))
            by_key[key] = by_key.get(key, 0) + int(nbytes)
    total = sum(by_key.values())
    _watermark = max(_watermark, total)
    subsystems: Dict[str, Dict[str, int]] = {}
    for (subsystem, component), nbytes in sorted(by_key.items()):
        subsystems.setdefault(subsystem, {})[component] = nbytes
    doc = {
        "stale": False,
        "subsystems": subsystems,
        "total_bytes": total,
        "watermark_bytes": _watermark,
        "device_bytes": device_bytes(),
        "resources": _sample_resources(now_s),
    }
    _last_sample = doc
    _last_sample_t = time.monotonic()
    return doc


def ledger_stats() -> Dict[str, Any]:
    """The ``hbm`` column of ``observe.snapshot()``: a sample at most a
    quarter second old."""
    return sample(max_age_s=0.25)


def reset() -> None:
    """Drop every registration, the growth history and the watermark."""
    global _watermark, _last_sample, _last_sample_t
    with _lock:
        _tracked.clear()
        _resources.clear()
    _growth.clear()
    _watermark = 0
    _last_sample = None
    _last_sample_t = 0.0
