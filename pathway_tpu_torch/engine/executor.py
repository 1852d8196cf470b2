"""The engine run loop of the port (counterpart of
``pathway_tpu/engine/executor.py``; one process: the multi-process tick
protocol over an exchange plane is a later slice, see ``internals/run.py``).

The reference's per-worker hot loop is ``probers → flushers → pollers →
worker.step_or_park`` (src/engine/dataflow.rs:5596-5650).  Here one host
drives the whole graph: each iteration polls every source session, stamps a
new commit tick (even unix-ms, matching the reference's alt-neu even-time
convention, src/engine/time.rs:22-28), propagates the resulting deltas in
topological order, and fires tick-end hooks.  In batch mode (all sources
static/finished) the loop drains and returns; in streaming mode it parks for
``commit_duration`` between ticks until terminated.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Callable, List, Optional, Tuple

from .delta import Delta
from .graph import EngineGraph, EngineOperator

__all__ = ["Executor", "Timestamp", "next_timestamp"]

Timestamp = int

_last_ts_lock = threading.Lock()
_last_ts = 0


def next_timestamp() -> Timestamp:
    """Monotone even-millisecond timestamps (reference Timestamp::new_from_current_time,
    src/engine/time.rs:20-28)."""
    global _last_ts
    with _last_ts_lock:
        ts = int(_time.time() * 1000)
        ts += ts % 2  # round up to even
        if ts <= _last_ts:
            ts = _last_ts + 2
        _last_ts = ts
        return ts


class Executor:
    def __init__(
        self,
        graph: EngineGraph,
        commit_duration_ms: int = 100,
        on_tick: Optional[Callable[[Timestamp], None]] = None,
    ):
        self.graph = graph
        self.commit_duration_ms = commit_duration_ms
        self.on_tick = on_tick
        self._terminate = threading.Event()
        self.current_ts: Timestamp = 0

    def terminate(self) -> None:
        self._terminate.set()

    def step(self, ts: Optional[Timestamp] = None) -> bool:
        """Poll all sources once and propagate; returns True if any data moved."""
        ts = ts if ts is not None else next_timestamp()
        self.current_ts = ts
        initial: List[Tuple[EngineOperator, int, Delta]] = []
        for src in self.graph.sources:
            delta = src.poll(ts)
            if delta is not None and delta.n > 0:
                delta = delta.consolidated()
                src.output.store.apply(delta)
                for consumer, port in src.output.consumers:
                    initial.append((consumer, port, delta))
        moved = bool(initial)
        if initial:
            self.graph.propagate(initial, ts)
        self.graph.tick_end(ts)
        if self.on_tick is not None:
            self.on_tick(ts)
        return moved

    def run(self, bootstrap=None) -> None:
        """Run until all sources are finished (and drained) or terminated.

        ``bootstrap``: (operator, port, delta) triples to inject at the first
        tick (used by incremental re-runs for operators added after a
        previous run)."""
        self.graph.finalize()
        if bootstrap:
            ts = next_timestamp()
            self.current_ts = ts
            self.graph.propagate(list(bootstrap), ts)
        while True:
            if self._terminate.is_set():
                break
            moved = self.step()
            if self._sources_finished() and not moved:
                # final flush for buffered/time-based operators
                ts = next_timestamp()
                self.current_ts = ts
                self.graph.flush_end(ts)
                break
            if not moved:
                self._terminate.wait(self.commit_duration_ms / 1000.0)

    def _sources_finished(self) -> bool:
        """Batch-run completion: every source is finished, where a
        loop-back source (AsyncTransformer results) counts as finished when
        QUIESCED — session drained and its quiesce_check reports no queued
        or in-flight work.  Its upstream feeders are ordinary sources in
        this same conjunction, so pending upstream data keeps the loop
        alive."""
        for src in self.graph.sources:
            if src.finished:
                continue
            check = getattr(src, "quiesce_check", None)
            # order matters (TOCTOU): confirm no queued/in-flight work FIRST
            # — once both are zero no new insert can start (feeding more work
            # requires a live upstream source, which fails this conjunction
            # on its own) — and only then require the session drained.  The
            # reverse order could observe an empty session, lose the race to
            # a completing invocation, and terminate with its row undrained.
            if check is not None and check() and not src.session.has_pending:
                continue
            return False
        return True
