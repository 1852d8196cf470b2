"""Dispatch/fetch accounting of the serve path (counterpart of
``pathway_tpu/ops/dispatch_counter.py``).

Serve sites report every device launch group (``record_dispatch``) and
every device-to-host result copy (``record_fetch``) with a tag.  Each
report goes to three places: the port's recorder counters
``pathway_serve_{dispatches,fetches}_total{tag}`` (always on), the
active trace's dispatch and fetch counts, and an installed
``DispatchCounter`` (a test or ``chip_smoke.py`` asserts the budget with
one: a retrieve-rerank serve is 2 dispatches + 2 fetches).  The sites
are the reference's: stage-1 submit / completion (``serve_exact``,
``serve_ivf``), the MaxSim gather (``rerank_maxsim``) and the packed
cross-encoder stage 2 (``rerank_stage2``).

``shards=N`` books one logical report that covers N physical launches
(the embedding-cache path encodes its misses and then searches: one
logical dispatch of two launches; a sharded serve encodes, searches
every shard and merges: one logical dispatch of ``shards + 2``);
``physical_dispatches`` / ``physical_fetches`` keep the launch counts,
the recorder exports them on ``pathway_serve_shard_{dispatches,fetches}_total``
when N > 1, and ``DispatchCounter(mode="physical")`` makes the headline
``dispatches`` / ``fetches`` the physical counts.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from .. import observe
from ..observe import trace as _trace

__all__ = ["DispatchCounter", "install", "record_dispatch", "record_fetch", "uninstall"]

_install_lock = threading.Lock()
_active: Optional["DispatchCounter"] = None
_obs_counters: Dict[Tuple[str, str, bool], observe.Counter] = {}


def _obs_counter(kind: str, tag: str, shard: bool = False) -> observe.Counter:
    c = _obs_counters.get((kind, tag, shard))
    if c is None:
        name = f"pathway_serve_shard_{kind}es_total" if shard else f"pathway_serve_{kind}es_total"
        c = _obs_counters[(kind, tag, shard)] = observe.counter(name, tag=tag)
    return c


class DispatchCounter:
    """Counts dispatches and fetches while installed (``with
    DispatchCounter() as c:``): logical ones by default, physical ones as
    the headline counts with ``mode="physical"``;
    ``physical_dispatches`` / ``physical_fetches`` always count
    launches and copies; ``events`` keeps the first ``max_events``
    ``(kind, tag)`` pairs and ``events_dropped`` the rest."""

    def __init__(self, max_events: int = 4096, mode: str = "logical") -> None:
        if mode not in ("logical", "physical"):
            raise ValueError(f"unknown accounting mode {mode!r}")
        self.max_events = int(max_events)
        self.mode = mode
        self.dispatches = 0
        self.fetches = 0
        self.physical_dispatches = 0
        self.physical_fetches = 0
        self.events: List[Tuple[str, str]] = []
        self.events_dropped = 0
        self._lock = threading.Lock()

    def _record(self, kind: str, tag: str, shards: int) -> None:
        physical = max(1, int(shards))
        headline = physical if self.mode == "physical" else 1
        with self._lock:
            if kind == "dispatch":
                self.dispatches += headline
                self.physical_dispatches += physical
            else:
                self.fetches += headline
                self.physical_fetches += physical
            if len(self.events) < self.max_events:
                self.events.append((kind, tag))
            else:
                self.events_dropped += 1

    def reset(self) -> None:
        with self._lock:
            self.dispatches = 0
            self.fetches = 0
            self.physical_dispatches = 0
            self.physical_fetches = 0
            self.events = []
            self.events_dropped = 0

    def snapshot(self) -> Tuple[int, int]:
        """``(dispatches, fetches)`` read together."""
        with self._lock:
            return self.dispatches, self.fetches

    def __enter__(self) -> "DispatchCounter":
        install(self)
        return self

    def __exit__(self, *exc) -> None:
        uninstall()


def install(counter: Optional[DispatchCounter] = None) -> DispatchCounter:
    global _active
    with _install_lock:
        _active = counter or DispatchCounter()
        return _active


def uninstall() -> None:
    global _active
    with _install_lock:
        _active = None


def _report(kind: str, tag: str, shards: int) -> None:
    _obs_counter(kind, tag).inc()
    if shards > 1:
        _obs_counter(kind, tag, shard=True).inc(shards)
    t = _trace.current()
    if t is not None:
        (t.note_dispatch if kind == "dispatch" else t.note_fetch)(tag, shards)
    c = _active
    if c is not None:
        c._record(kind, tag, shards)


def record_dispatch(tag: str, shards: int = 1) -> None:
    """One logical launch group of ``shards`` physical launches."""
    _report("dispatch", tag, shards)


def record_fetch(tag: str, shards: int = 1) -> None:
    _report("fetch", tag, shards)
