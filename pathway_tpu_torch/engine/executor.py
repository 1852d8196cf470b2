"""The engine run loop of the port (counterpart of
``pathway_tpu/engine/executor.py``).

The reference's per-worker hot loop is ``probers → flushers → pollers →
worker.step_or_park`` (src/engine/dataflow.rs:5596-5650).  Here one host
drives the whole graph: each iteration polls every source session, stamps a
new commit tick (even unix-ms, matching the reference's alt-neu even-time
convention, src/engine/time.rs:22-28), propagates the resulting deltas in
topological order, and fires tick-end hooks.  In batch mode (all sources
static/finished) the loop drains and returns; in streaming mode it parks for
``commit_duration`` between ticks until terminated.  Under a process
cluster (``PATHWAY_PROCESSES`` > 1, joined by ``pw.run``) each tick is the
distributed protocol of ``_step_dist`` over the exchange plane.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Callable, List, Optional, Tuple

from .delta import Delta
from .graph import EngineGraph, EngineOperator
from .operators.io import SourceOperator
from .operators.io import _COLUMNAR

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


def bump_timestamp(ts: Timestamp) -> None:
    """Advance the local clock to an externally-agreed commit timestamp
    (distributed runs: the cluster's tick timestamp is the max over all
    ranks' proposals, so each rank's later local timestamps stay above it)."""
    global _last_ts
    with _last_ts_lock:
        if ts > _last_ts:
            _last_ts = ts


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
        self._ctrl_seq = 0  # distributed control-plane BSP round counter

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
        plane = None
        from ..parallel import distributed

        if distributed.is_distributed():
            from ..parallel.exchange import get_plane

            plane = get_plane()
            self.graph.plane = plane
        self.graph.finalize()
        if bootstrap:
            ts = next_timestamp()
            self.current_ts = ts
            self.graph.propagate(list(bootstrap), ts)
        while True:
            if plane is not None:
                # termination is part of the tick protocol: a local
                # terminate() request only takes effect once every rank has
                # seen it in the status exchange, so no rank blocks in a
                # collective against an exited peer
                moved, finished, stop = self._step_dist(plane)
                if stop:
                    break
            else:
                if self._terminate.is_set():
                    break
                moved = self.step()
                finished = self._sources_finished()
            if finished and not moved:
                # final flush for buffered/time-based operators
                if plane is not None:
                    ts = self.current_ts + 2  # agreed: same current_ts on all ranks
                    bump_timestamp(ts)
                else:
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

    # -- distributed tick protocol ------------------------------------------
    def _step_dist(self, plane) -> Tuple[bool, bool, bool]:
        """One coordinated commit tick across the process cluster.

        Replaces the reference's timely progress protocol at commit
        boundaries (workers agree a timestamp is closed before results flow
        downstream — docs/.../10.worker-architecture.md:46-49): every rank
        polls its own sources, the ranks exchange (proposed_ts, moved,
        finished) in one small all-to-all, and everyone deterministically
        adopts ``max(proposals)`` as the tick timestamp, so commit
        timestamps AGREE across replicas without a distinguished
        coordinator round-trip.  Source rows are then placed by ownership
        (filter / all-to-all / broadcast, per source mode) and propagation
        runs the BSP exchange sweep."""
        from ..internals.keys import shard_of, shards_of
        from .delta import empty_delta

        rnd = self._ctrl_seq
        self._ctrl_seq += 1
        polled = []
        local_moved = False
        for src in self.graph.sources:
            mode = getattr(src, "dist_mode", "replicated")
            if mode == "partitioned":
                # defer event->delta resolution until after the exchange:
                # upsert/delete-by-key events must resolve against the KEY
                # OWNER's store, and this rank may have read another owner's
                # rows (disjoint file splits)
                events = src.session.drain()
                if events:
                    local_moved = True
                polled.append(events)
            else:
                delta = src.poll(0)
                if delta is not None and delta.n:
                    local_moved = True
                polled.append(delta)
        finished_local = self._sources_finished()
        proposal = (
            next_timestamp(),
            local_moved,
            finished_local,
            self._terminate.is_set(),
        )
        status = plane.all_to_all("tick", rnd, [proposal] * plane.nproc)
        ts = max(s[0] for s in status)
        ts = max(ts, self.current_ts + 2)
        ts += ts % 2
        bump_timestamp(ts)
        self.current_ts = ts
        moved_any = any(s[1] for s in status)
        finished_all = all(s[2] for s in status)
        stop_any = any(s[3] for s in status)

        initial: List[Tuple[EngineOperator, int, Delta]] = []
        for src, polled_item in zip(self.graph.sources, polled):
            mode = getattr(src, "dist_mode", "replicated")
            names = src.output.column_names
            if mode == "partitioned":
                # each rank read a disjoint split (fs parallel readers,
                # reference parallel_readers dataflow.rs:3317): route RAW
                # events to their key owner, then resolve upsert/delete
                # chains there with the owner's store in view
                events = polled_item or []
                parts: List[list] = [[] for _ in range(plane.nproc)]
                for ev in events:
                    if ev[0] == _COLUMNAR:
                        # split one columnar batch into per-owner columnar
                        # sub-batches (vectorized; stays tuple-free)
                        keys, cols = ev[2]
                        owners = shards_of(keys, plane.nproc)
                        for peer in range(plane.nproc):
                            mask = owners == peer
                            m = int(mask.sum())
                            if m:
                                parts[peer].append(
                                    (
                                        _COLUMNAR,
                                        m,
                                        (
                                            keys[mask],
                                            {c: v[mask] for c, v in cols.items()},
                                        ),
                                    )
                                )
                        continue
                    parts[shard_of(ev[1], plane.nproc)].append(ev)
                got = plane.all_to_all(f"src{src.id}", rnd, parts)
                merged = [ev for part in got for ev in part]
                d = src.events_to_delta(merged) or empty_delta(names)
            elif mode == "replicated":
                # every rank polls the identical event stream (script-local /
                # static sources): keep the owned-key slice, drop the rest
                d = polled_item if polled_item is not None else empty_delta(names)
                if d.n:
                    d = d.select_rows(shards_of(d.keys, plane.nproc) == plane.rank)
            elif mode == "broadcast":
                # one rank reads (e.g. a REST frontend); every rank gets the
                # full stream (feeds replicated/SPMD pipelines)
                d = polled_item if polled_item is not None else empty_delta(names)
                got = plane.all_to_all(f"src{src.id}", rnd, [d] * plane.nproc)
                d = Delta.concat([x for x in got if x.n], names)
            else:  # pragma: no cover - unknown mode
                raise ValueError(f"unknown source dist_mode {mode!r}")
            if d.n:
                d = d.consolidated()
                src.output.store.apply(d)
                for consumer, port in src.output.consumers:
                    initial.append((consumer, port, d))
        self.graph.propagate(initial, ts)  # always: BSP exchange alignment
        self.graph.tick_end(ts)
        if self.on_tick is not None:
            self.on_tick(ts)
        return moved_any, finished_all, stop_any
