"""Per-callable device-time attribution (counterpart of
``pathway_tpu/observe/profile.py``): which callable of the serve and
decode stack owns the card's time.

- **Sampling at the wrapper.**  Each instrumented callable is stored as
  ``profile.wrap(site, fn)``, which calls ``fn`` and returns its result
  untouched.  Sampling is a deterministic 1-in-N stride from
  ``observe.profile_sample`` (``set_sample`` moves it); off or sampled
  out, a call costs a flag check and a modulo.
- **Timing at the event.**  A sampled call stamps the host submit time
  and, when its first tensor output lies on the card, records a
  ``torch.cuda.Event`` on the current stream of that tensor's device:
  the stream the callable launched on, side streams included, as long
  as the call runs inside that stream's context.  A background completer
  thread waits on the event and books submit -> ready seconds (device
  queue plus execution), so the calling thread never synchronizes and
  the 2 dispatches + 2 fetches budget is untouched.  Events are pooled
  per site.  A CPU output is ready at return and is booked at once.
- **Degrade, never fail.**  The ``profile.sample`` fault site fires on
  the sampling path under a spent deadline: an armed fault drops the
  sample (``pathway_profile_samples_dropped_total``) and the call
  proceeds.  A full pending queue, an output with no tensor, or a failed
  wait drop the sample the same way.

Rendered as ``pathway_profile_device_seconds{callable}`` (histograms
whose sum is the attributed device seconds), ``pathway_profile_samples_total``
and the share-of-wall gauges ``pathway_profile_device_share`` (corrected
for the stride in effect at each sample); ``observe.snapshot()`` carries
the same rows as its ``profile`` column.  Series and the provider are
created on first use, never at import.
"""

# pathway: serve-path  (hidden-sync lint applies: ``profiled`` runs inside every serve dispatch)
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import torch

from .. import config
from . import histogram as _hist_mod
from .recorder import counter, histogram, register_provider

__all__ = ["drain", "profile_stats", "reset", "sample_stride", "set_sample", "wrap"]


def _stride_of(fraction: float) -> int:
    """Sampled fraction -> deterministic 1-in-N stride (0 = off)."""
    if fraction <= 0.0:
        return 0
    if fraction >= 1.0:
        return 1
    return max(1, int(round(1.0 / fraction)))


_stride = _stride_of(config.get("observe.profile_sample"))

# pending samples awaiting the completer; past the cap a sample is
# dropped (counted) rather than queued without bound
_PENDING_CAP = 64
_pending: Deque[Tuple["_Site", int, Any, int]] = deque()
_pending_cv = threading.Condition()
_inflight = 0  # popped by the completer, not yet booked (drain() waits)
_completer: Optional[threading.Thread] = None

_wall_t0_ns = time.perf_counter_ns()

_sites_lock = threading.Lock()
_sites: Dict[str, "_Site"] = {}


class _Provider:
    """Scrape-time share-of-wall and call-count gauges."""

    def observe_metrics(self):
        for name, row in profile_stats().items():
            labels = {"callable": name}
            yield ("gauge", "pathway_profile_device_share", labels, row["share_of_wall"])
            yield ("gauge", "pathway_profile_calls", labels, row["calls"])


_provider = _Provider()  # module-global: the registry holds providers weakly


def _dropped() -> None:
    counter("pathway_profile_samples_dropped_total").inc()


_gate: Optional[Tuple[Any, Any]] = None  # (robust.inject, Deadline)


def _resolve_gate() -> Tuple[Any, Any]:
    """The fault gate's modules, imported once by ``wrap`` (``robust``
    imports ``observe``, so not at this module's import).  A first import
    of ``robust`` inside the first sampled call cost that call 14-20 ms on
    the host of an NVIDIA H100 machine; ``wrap`` runs where the
    instrumented module is imported, off every call path."""
    global _gate
    if _gate is None:
        from ..robust import inject
        from ..robust.deadline import Deadline

        _gate = (inject, Deadline)
    return _gate


def _sample_allowed() -> bool:
    """Fault gate of the sampling path (site ``profile.sample``), fired
    under a spent deadline so an armed hang releases at once."""
    inject, Deadline = _gate or _resolve_gate()
    if not inject.any_armed():
        return True
    try:
        before = inject.fired_count("profile.sample")
        inject.fire("profile.sample", deadline=Deadline.after_ms(0.0))
        return inject.fired_count("profile.sample") == before
    except Exception:  # noqa: BLE001 - any armed fault drops the sample
        return False


class _Site:
    """Per-callable record; its series are made at its first sample."""

    __slots__ = ("name", "calls", "device_ns", "weighted_ns", "_hist", "_sampled", "_events", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.device_ns = 0  # submit -> ready ns of the sampled calls
        self.weighted_ns = 0  # each sample times the stride it was taken at
        self._hist = None
        self._sampled = None
        self._events: List[Any] = []  # pooled CUDA events
        self._lock = threading.Lock()

    @property
    def hist(self):
        if self._hist is None:
            self._hist = histogram("pathway_profile_device_seconds", callable=self.name)
        return self._hist

    def book(self, dt_ns: int, stride: int) -> None:
        if self._sampled is None:
            self._sampled = counter("pathway_profile_samples_total", callable=self.name)
        self.hist.observe_ns(dt_ns)
        self.device_ns += dt_ns
        self.weighted_ns += dt_ns * max(1, stride)
        self._sampled.inc()

    def take_event(self):
        with self._lock:
            if self._events:
                return self._events.pop()
        return torch.cuda.Event()

    def give_event(self, ev) -> None:
        with self._lock:
            if len(self._events) < _PENDING_CAP:
                self._events.append(ev)


def _site(name: str) -> _Site:
    with _sites_lock:
        st = _sites.get(name)
        if st is None:
            if not _sites:
                register_provider(_provider)
            st = _sites[name] = _Site(name)
        return st


def _first_tensor(out: Any) -> Optional[torch.Tensor]:
    """First tensor of a call's output (one output of a launch sequence
    on one stream is ready once the whole sequence is)."""
    seen = 0
    stack = [out]
    while stack and seen < 16:
        x = stack.pop()
        seen += 1
        if isinstance(x, torch.Tensor):
            return x
        if isinstance(x, (tuple, list)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return None


def _completer_loop() -> None:
    global _inflight
    while True:
        with _pending_cv:
            while not _pending:
                _pending_cv.wait()
            st, t0_ns, ev, stride = _pending.popleft()
            _inflight += 1
        try:
            try:
                ev.synchronize()  # pathway: allow(hidden-sync): the completer thread's one wait per sampled call — off every serve thread by design, it is the attribution itself (the calling thread never synchronizes)
            except Exception:  # noqa: BLE001 - a failed wait drops the sample, never the serve
                _dropped()
                continue
            st.book(time.perf_counter_ns() - t0_ns, stride)
            st.give_event(ev)
        finally:
            with _pending_cv:
                _inflight -= 1
                _pending_cv.notify_all()


def _enqueue(st: _Site, t0_ns: int, out: Any, stride: int) -> None:
    """Book one sampled call; every failure drops the sample (counted)
    and returns: the caller's result is already in hand."""
    global _completer
    try:
        if not _sample_allowed():
            _dropped()
            return
        leaf = _first_tensor(out)
        if leaf is None:
            _dropped()
            return
        if leaf.device.type != "cuda":
            st.book(time.perf_counter_ns() - t0_ns, stride)
            return
        ev = st.take_event()
        ev.record(torch.cuda.current_stream(leaf.device))
        with _pending_cv:
            if len(_pending) >= _PENDING_CAP:
                _dropped()
                return
            if _completer is None or not _completer.is_alive():
                _completer = threading.Thread(target=_completer_loop, daemon=True, name="pw-profile")
                _completer.start()
            _pending.append((st, t0_ns, ev, stride))
            _pending_cv.notify()
    except Exception:  # noqa: BLE001 - the profiler never fails the profiled call
        _dropped()


def wrap(site: str, fn: Callable) -> Callable:
    """Instrument one callable for device-time attribution under the
    reference's label ``site``; the wrapper is transparent (same
    arguments, same result).  The site's record is resolved at the first
    call that runs with sampling on, so wrapping registers nothing."""
    _resolve_gate()
    cell: List[_Site] = []

    def profiled(*args: Any, **kwargs: Any):
        stride = _stride  # one read: a concurrent set_sample(0) must not reach the modulo
        if not _hist_mod.enabled or stride == 0:
            return fn(*args, **kwargs)
        if not cell:
            cell.append(_site(site))
        st = cell[0]
        st.calls += 1
        if st.calls % stride:
            return fn(*args, **kwargs)
        t0 = time.perf_counter_ns()
        out = fn(*args, **kwargs)
        _enqueue(st, t0, out, stride)
        return out

    profiled.__wrapped__ = fn
    profiled.profile_site = site
    return profiled


def set_sample(fraction: float) -> None:
    """Sampled fraction of calls: 1.0 every call, 0.0 off."""
    global _stride
    _stride = _stride_of(min(1.0, max(0.0, float(fraction))))


def sample_stride() -> int:
    """The current 1-in-N stride (0 = off)."""
    return _stride


def drain(timeout_s: float = 2.0) -> bool:
    """Wait until every queued sample is booked."""
    deadline = time.monotonic() + timeout_s
    with _pending_cv:
        while _pending or _inflight:
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            _pending_cv.wait(timeout=min(left, 0.05))
    return True


def profile_stats() -> Dict[str, Dict[str, float]]:
    """Per-callable rows: calls, samples, attributed device seconds,
    share of wall (stride-corrected), p50 / p99 bucket bounds."""
    wall_s = max((time.perf_counter_ns() - _wall_t0_ns) * 1e-9, 1e-9)
    with _sites_lock:
        sites = list(_sites.values())
    out: Dict[str, Dict[str, float]] = {}
    for st in sites:
        hist = st._hist
        out[st.name] = {
            "calls": st.calls,
            "samples": 0 if hist is None else hist.count,
            "device_s": st.device_ns * 1e-9,
            "share_of_wall": min(1.0, st.weighted_ns * 1e-9 / wall_s),
            "p50_s": (hist.quantile_s(0.50) if hist is not None else None) or 0.0,
            "p99_s": (hist.quantile_s(0.99) if hist is not None else None) or 0.0,
        }
    return out


def reset() -> None:
    """Zero the attribution window: per-site accumulators and the wall
    anchor (the series stay; ``observe.reset()`` zeroes those)."""
    global _wall_t0_ns
    with _sites_lock:
        for st in _sites.values():
            st.device_ns = 0
            st.weighted_ns = 0
            st.calls = 0
    _wall_t0_ns = time.perf_counter_ns()
