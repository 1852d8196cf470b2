"""Source and sink operators.

Sources mirror the reference's connector sessions: a *native* session is a
stream of explicit insert/remove events, an *upsert* session keys rows and
derives retractions from the previous row for the key (reference:
src/connectors/adaptors.rs:23-80).  Connector threads push events into an
``InputSession`` buffer; the scheduler drains it once per commit tick.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...internals import dtype as dt
from ...internals.keys import KEY_DTYPE
from ..delta import Delta, as_column, empty_delta
from ..graph import EngineOperator, EngineTable, OutputCallbacks

__all__ = ["InputSession", "SourceOperator", "SubscribeOperator", "StaticSourceOperator"]

_INSERT = 0
_REMOVE = 1
_UPSERT = 2
_DELETE_BY_KEY = 3
_BATCH_MARK = 4
# one event carrying a whole COLUMNAR insert batch: (kind, n_rows,
# (keys uint64[n], {col: np.ndarray[n]})) — the bulk-ingest hot path skips
# per-row python tuples entirely (reference: connectors hand the engine
# parsed batches, not rows)
_COLUMNAR = 5


class InputSession:
    """Thread-safe buffer of input events pushed by connector threads.

    ``mark_batch()`` seals the events pushed so far into an atomic batch:
    each drain returns at most one sealed batch, so marked batches land at
    distinct commit ticks REGARDLESS of thread/scheduler timing (the
    structural analog of the reference's per-commit timestamp advancement,
    src/connectors/mod.rs commit_duration ticks)."""

    def __init__(self, upsert: bool = False, atomic_batches: bool = False):
        self._lock = threading.Lock()
        self._events: List[Tuple[int, int, Optional[Tuple[Any, ...]]]] = []
        self._since_mark = 0
        self.upsert = upsert
        # atomic mode: unsealed rows are invisible to drains until
        # mark_batch() (or close) — a mid-batch poll can never split a batch
        self.atomic_batches = atomic_batches
        self.finished = False
        self._error: Optional[BaseException] = None
        # persistence hook: called with each raw event as it is appended
        # (persistence/engine_state.py SourcePersistence.record); replayed
        # events injected via push_raw are deliberately not re-recorded
        self.recorder = None

    def insert(self, key: int, row: Tuple[Any, ...]) -> None:
        event = (_UPSERT if self.upsert else _INSERT, key, row)
        with self._lock:
            self._events.append(event)
            self._since_mark += 1
            # record under the lock: with concurrent producers the persisted
            # event order must match the in-memory order, or upsert replay
            # could resolve a key to a different last-writer
            if self.recorder is not None:
                self.recorder(event)

    def insert_batch(self, keys, rows) -> None:
        """Bulk insert: one lock acquisition and one list extend for the whole
        batch (connector readers hand over rows thousands at a time; per-row
        ``insert`` calls would serialize on the lock)."""
        kind = _UPSERT if self.upsert else _INSERT
        events = [(kind, int(k), tuple(r)) for k, r in zip(keys, rows)]
        with self._lock:
            self._events.extend(events)
            self._since_mark += len(events)
            # record under the lock: with concurrent producers the persisted
            # event order must match the in-memory order, or upsert replay
            # could resolve a key to a different last-writer
            if self.recorder is not None:
                for event in events:
                    self.recorder(event)

    def insert_columnar(self, keys, columns: Dict[str, Any]) -> None:
        """Bulk insert of a whole columnar batch as ONE event (no per-row
        tuples anywhere on the path; drains into a Delta directly).  Only
        for plain-insert streams — upsert sessions need per-row chain
        resolution."""
        if self.upsert:
            raise ValueError("insert_columnar requires a non-upsert session")
        keys = np.asarray(keys, dtype=np.uint64)
        event = (_COLUMNAR, len(keys), (keys, columns))
        with self._lock:
            self._events.append(event)
            self._since_mark += len(keys)
            if self.recorder is not None:
                self.recorder(event)

    def remove(self, key: int, row: Optional[Tuple[Any, ...]] = None) -> None:
        event = (_DELETE_BY_KEY if row is None else _REMOVE, key, row)
        with self._lock:
            self._events.append(event)
            self._since_mark += 1
            if self.recorder is not None:
                self.recorder(event)

    def mark_batch(self) -> None:
        """Seal events pushed since the previous marker into one batch."""
        event = (_BATCH_MARK, 0, None)
        with self._lock:
            if not self._since_mark:
                return
            self._events.append(event)
            self._since_mark = 0
            # markers persist with the event log so replayed atomic sources
            # reproduce their batch boundaries (and drain at all — an atomic
            # session never releases unsealed rows)
            if self.recorder is not None:
                self.recorder(event)

    def close(self) -> None:
        with self._lock:
            self.finished = True

    def fail(self, exc: BaseException) -> None:
        """A connector runner crashed: surface the exception at the next
        engine drain instead of letting the daemon thread's death read as a
        clean end-of-stream (the reference's reader-thread errors likewise
        fail the run, src/connectors/mod.rs error channel)."""
        with self._lock:
            self._error = exc
            self.finished = True

    def drain(self) -> List[Tuple[int, int, Optional[Tuple[Any, ...]]]]:
        """Take the next sealed batch, or (non-atomic / finished) the
        unsealed tail."""
        with self._lock:
            if self._error is not None:
                raise self._error
            for i, (kind, _k, _r) in enumerate(self._events):
                if kind == _BATCH_MARK:
                    events = self._events[:i]
                    self._events = self._events[i + 1 :]
                    return events
            if self.atomic_batches and not self.finished:
                return []
            events, self._events = self._events, []
            self._since_mark = 0
            return events

    def push_raw(self, events: List[Tuple[int, int, Optional[Tuple[Any, ...]]]]) -> None:
        """Inject raw events verbatim (persistence replay path)."""
        with self._lock:
            self._events.extend(events)
            # count the unsealed tail so a later mark_batch() can seal it
            self._since_mark = 0
            for kind, _k, _r in self._events:
                if kind == _BATCH_MARK:
                    self._since_mark = 0
                else:
                    self._since_mark += 1

    @property
    def has_pending(self) -> bool:
        with self._lock:
            if self._error is not None:
                return True  # force a drain so the failure surfaces
            if self.atomic_batches and not self.finished:
                return any(kind == _BATCH_MARK for kind, _k, _r in self._events)
            return bool(self._events)


class SourceOperator(EngineOperator):
    """Drains an InputSession into deltas once per tick."""

    def __init__(
        self,
        output: EngineTable,
        session: InputSession,
        dtypes: Optional[Dict[str, dt.DType]] = None,
        name: str = "source",
    ):
        super().__init__([], output, name)
        self.session = session
        self.dtypes = dtypes or {}

    @property
    def finished(self) -> bool:
        return self.session.finished and not self.session.has_pending

    def poll(self, ts: int) -> Optional[Delta]:
        return self.events_to_delta(self.session.drain())

    def events_to_delta(self, events) -> Optional[Delta]:
        """Resolve a raw event batch into a keyed delta against this
        operator's current output store (upsert chains, delete-by-key).  The
        distributed executor calls this AFTER routing raw events to their
        key owner, so resolution always sees the owner's store."""
        if not events:
            return None
        names = self.output.column_names
        store = self.output.store
        if any(e[0] == _COLUMNAR for e in events):
            if all(e[0] in (_INSERT, _COLUMNAR) for e in events):
                # pure inserts: columnar batches become Deltas verbatim, row
                # inserts batch separately; order is immaterial for +1 rows
                deltas = []
                rows_ev = [e for e in events if e[0] == _INSERT]
                if rows_ev:
                    deltas.append(self.events_to_delta(rows_ev))
                for kind, n, (keys, cols) in (
                    e for e in events if e[0] == _COLUMNAR
                ):
                    deltas.append(
                        Delta(
                            keys=np.asarray(keys, dtype=KEY_DTYPE),
                            diffs=np.ones(n, dtype=np.int64),
                            columns={
                                name: as_column(cols[name], self.dtypes.get(name))
                                for name in names
                            },
                        )
                    )
                return Delta.concat([d for d in deltas if d is not None], names)
            # mixed with upserts/removals: decompose to row events (rare)
            flat = []
            for e in events:
                if e[0] != _COLUMNAR:
                    flat.append(e)
                    continue
                _kind, n, (keys, cols) = e
                col_list = [cols[name] for name in names]
                for i in range(n):
                    flat.append(
                        (_INSERT, int(keys[i]), tuple(c[i] for c in col_list))
                    )
            events = flat
        if all(e[0] == _INSERT for e in events):
            # pure-insert batch (the bulk-ingest shape): no upsert chains to
            # resolve — build the delta columnar without the per-event loop
            columns = {}
            if names:
                transposed = list(zip(*(e[2] for e in events)))
                for ci, name in enumerate(names):
                    columns[name] = as_column(
                        list(transposed[ci]), self.dtypes.get(name)
                    )
            return Delta(
                keys=np.fromiter(
                    (e[1] for e in events), dtype=KEY_DTYPE, count=len(events)
                ),
                diffs=np.ones(len(events), dtype=np.int64),
                columns=columns,
            )
        keys: List[int] = []
        diffs: List[int] = []
        rows: List[Tuple[Any, ...]] = []
        # pending view of this batch so same-tick upsert chains resolve
        pending: Dict[int, Optional[Tuple[Any, ...]]] = {}

        def current(key: int) -> Optional[Tuple[Any, ...]]:
            if key in pending:
                return pending[key]
            return store.get(key)

        for kind, key, row in events:
            if kind == _INSERT:
                keys.append(key)
                diffs.append(1)
                rows.append(row)
                pending[key] = row
            elif kind == _REMOVE:
                keys.append(key)
                diffs.append(-1)
                rows.append(row)
                pending[key] = None
            elif kind == _UPSERT:
                old = current(key)
                if old is not None:
                    keys.append(key)
                    diffs.append(-1)
                    rows.append(old)
                keys.append(key)
                diffs.append(1)
                rows.append(row)
                pending[key] = row
            elif kind == _DELETE_BY_KEY:
                old = current(key)
                if old is not None:
                    keys.append(key)
                    diffs.append(-1)
                    rows.append(old)
                    pending[key] = None
        if not keys:
            return None
        columns = {}
        for ci, name in enumerate(names):
            columns[name] = as_column([r[ci] for r in rows], self.dtypes.get(name))
        return Delta(
            keys=np.array(keys, dtype=KEY_DTYPE),
            diffs=np.array(diffs, dtype=np.int64),
            columns=columns,
        )

    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        # sources are driven by poll(), not by upstream deltas
        return delta


class StaticSourceOperator(SourceOperator):
    """A source pre-loaded with static rows, emitted once at the first tick
    (reference static_table, graph.rs:688)."""

    def __init__(
        self,
        output: EngineTable,
        keys: np.ndarray,
        columns: Dict[str, np.ndarray],
        dtypes: Optional[Dict[str, dt.DType]] = None,
        name: str = "static",
    ):
        session = InputSession()
        super().__init__(output, session, dtypes, name)
        names = output.column_names
        for i in range(len(keys)):
            session.insert(int(keys[i]), tuple(columns[c][i] for c in names))
        session.close()


class SubscribeOperator(EngineOperator):
    """Sink delivering per-row change callbacks (pw.io.subscribe;
    reference Graph::subscribe_table, graph.rs:700)."""

    def __init__(
        self,
        input_table: EngineTable,
        callbacks: OutputCallbacks,
        name: str = "subscribe",
    ):
        super().__init__([input_table], None, name)
        self.callbacks = callbacks
        self._seen_any = False

    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        if self.callbacks.on_change is not None:
            names = self.inputs[0].column_names
            cols = [delta.columns[c] for c in names]
            for i in range(delta.n):
                self.callbacks.on_change(
                    int(delta.keys[i]),
                    tuple(c[i] for c in cols),
                    ts,
                    int(delta.diffs[i]),
                )
        self._seen_any = self._seen_any or delta.n > 0
        return None

    def on_tick_end(self, ts: int) -> Optional[Delta]:
        if self.callbacks.on_time_end is not None:
            self.callbacks.on_time_end(ts)
        return None

    def on_end(self) -> Optional[Delta]:
        if self.callbacks.on_end is not None:
            self.callbacks.on_end()
        return None
