"""Shared connector runtime.

Reference: src/connectors/mod.rs:91-427 — one reader thread per connector
feeding parsed entries into an input session, committed on autocommit ticks.
Here the thread pushes rows into an ``InputSession``; the executor drains it
once per tick.  Static mode reads everything during the pre-run hook and
closes the session (batch semantics).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Type

import numpy as np

from ..engine.operators.io import InputSession, SourceOperator
from ..internals import dtype as dt
from ..internals.keys import ref_scalar, sequential_keys
from ..internals.parse_graph import G
from ..internals.schema import Schema
from ..internals.table import Table
from ..internals.universe import Universe

__all__ = ["SessionWriter", "register_source", "coerce_row_types", "jsonable"]


def jsonable(v):
    """Coerce engine values to JSON-encodable ones (shared by all writers)."""
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, bytes):
        return v.decode(errors="replace")
    return v


class SessionWriter:
    """Pushes keyed rows into an InputSession, deriving keys from primary-key
    columns (or a sequence counter) — the host analog of the reference's
    parser→session path (src/connectors/adaptors.rs)."""

    def __init__(
        self,
        session: InputSession,
        column_names: Sequence[str],
        primary_key: Optional[Sequence[str]],
        dtypes: Mapping[str, dt.DType],
        salt: int = 0,
        track_value_deletions: bool = False,
        name: str = "source",
    ):
        self.session = session
        self.column_names = list(column_names)
        self.primary_key = list(primary_key) if primary_key else None
        self.dtypes = dict(dtypes)
        self._counter = 0
        self._salt = salt
        self._lock = threading.Lock()
        # Without a primary key, deletions identify rows BY VALUE.  Keys are
        # DERIVED as hash(row-value-hash, occurrence-index), so matching a
        # deletion to its insert needs only a per-value LIVE COUNT — memory
        # is bounded by live distinct values (which the engine stores
        # anyway), not by ingest history, and keys are deterministic across
        # replays.  remove() cancels the most recent occurrence (LIFO).
        self.track_value_deletions = bool(track_value_deletions) and not self.primary_key
        self._live_counts: Dict[int, int] = {}
        # set by the PersistenceManager when a persistence config is active
        # (persistence/engine_state.py SourcePersistence)
        self.persistence = None
        # per-connector lag/offset stats, scraped by /metrics (io/_offsets.py)
        from ._offsets import ConnectorMonitor

        self.monitor = ConnectorMonitor(name)

    def key_of(self, values: Mapping[str, Any]) -> int:
        if self.primary_key:
            return self._pk_key(values)
        with self._lock:
            i = self._counter
            self._counter += 1
        return int(sequential_keys(i, 1, salt=self._salt)[0])

    def _pk_key(self, values: Mapping[str, Any]) -> int:
        return int(ref_scalar(*(values[c] for c in self.primary_key)))

    def _tracked_key(self, row: tuple) -> int:
        """Key for value-tracked rows: hash(value-hash, occurrence-index)."""
        vid = self._value_id(row)
        with self._lock:
            n = self._live_counts.get(vid, 0)
            self._live_counts[vid] = n + 1
        return int(ref_scalar(np.uint64(vid), n))

    def _value_id(self, row: tuple) -> int:
        return int(ref_scalar(*row))

    def insert(self, values: Mapping[str, Any], key: Optional[int] = None) -> None:
        values = coerce_row_types(values, self.dtypes)
        row = tuple(values.get(c) for c in self.column_names)
        if key is None:
            if self.track_value_deletions:
                key = self._tracked_key(row)
            else:
                key = self.key_of(values)
        self.session.insert(key, row)
        self.monitor.on_insert()

    def insert_rows(self, rows_values: Sequence[Mapping[str, Any]]) -> None:
        """Bulk insert: coerce + key a whole chunk, then hand it to the
        session in ONE ``insert_batch`` call — one session-lock acquisition
        per chunk instead of per row (the fs/csv readers parse thousands of
        rows per file; see InputSession.insert_batch)."""
        keys: List[Optional[int]] = []
        rows: List[tuple] = []
        for values in rows_values:
            values = coerce_row_types(values, self.dtypes)
            row = tuple(values.get(c) for c in self.column_names)
            if self.track_value_deletions:
                key: Optional[int] = self._tracked_key(row)
            elif self.primary_key:
                key = self._pk_key(values)
            else:
                key = None  # sequential, assigned in one counter bump below
            keys.append(key)
            rows.append(row)
        n_auto = sum(1 for k in keys if k is None)
        if n_auto:
            with self._lock:
                start = self._counter
                self._counter += n_auto
            auto = iter(sequential_keys(start, n_auto, salt=self._salt))
            keys = [int(next(auto)) if k is None else k for k in keys]
        self.session.insert_batch(keys, rows)
        self.monitor.on_insert(len(rows))

    def insert_columns(self, columns: Mapping[str, Any], n: Optional[int] = None) -> None:
        """Columnar bulk insert: whole columns (lists/arrays of equal
        length) go through vectorized coercion and ONE keying pass, then
        land in the session as a single columnar event — no per-row python
        tuples anywhere (the wordcount-shape hot path).  Falls back to
        insert_rows for sessions that need per-row treatment."""
        cols = {c: columns.get(c) for c in self.column_names}
        if n is None:
            present = [v for v in cols.values() if v is not None]
            if not present:
                raise ValueError(
                    "insert_columns: no schema column present and no n given"
                )
            n = len(present[0])
        if n == 0:
            return
        if self.track_value_deletions or self.session.upsert:
            # per-row semantics needed (upsert chains / value-tracked
            # deletions — primary-key schemas always open upsert sessions,
            # so PK keying happens in insert_rows)
            rows = [
                {c: (cols[c][i] if cols[c] is not None else None) for c in cols}
                for i in range(n)
            ]
            self.insert_rows(rows)
            return
        coerced = {
            c: _coerce_column(cols[c], self.dtypes.get(c), n)
            for c in self.column_names
        }
        with self._lock:
            start = self._counter
            self._counter += n
        keys = sequential_keys(start, n, salt=self._salt)
        self.session.insert_columnar(keys, coerced)
        self.monitor.on_insert(n)

    def remove(self, values: Mapping[str, Any], key: Optional[int] = None) -> None:
        values = coerce_row_types(values, self.dtypes)
        if key is None:
            if self.primary_key:
                key = self.key_of(values)
            elif self.track_value_deletions:
                row = tuple(values.get(c) for c in self.column_names)
                vid = self._value_id(row)
                with self._lock:
                    n = self._live_counts.get(vid, 0)
                    if n == 0:
                        raise KeyError(
                            f"remove: no live row matches {values!r} "
                            "(schema has no primary key; deletions match "
                            "previously inserted values)"
                        )
                    if n == 1:
                        del self._live_counts[vid]
                    else:
                        self._live_counts[vid] = n - 1
                key = int(ref_scalar(np.uint64(vid), n - 1))
            else:
                raise KeyError(
                    "remove: source does not track value deletions and the "
                    "schema has no primary key"
                )
        self.session.remove(key)
        self.monitor.on_delete()

    def commit_offsets(self, offsets: Mapping[Any, Any]):
        """Record committed per-partition read positions: persisted when a
        persistence config is active, and always folded into the connector
        monitor's offset antichain for lag/partition stats.  Returns the
        monitor's merged antichain — the same contract
        ``serve/ingest.py``'s ``IngestConnector.commit`` mirrors, so code
        bridging engine sources into the live indexes reads committed
        positions back from either."""
        from ._offsets import OffsetAntichain

        if self.persistence is not None:
            self.persistence.save_offsets(dict(offsets))
        self.monitor.on_commit(OffsetAntichain(dict(offsets)))
        return self.monitor.offsets

    def close(self) -> None:
        self.monitor.on_finish()
        self.session.close()


def _coerce_column(col, t: Optional[dt.DType], n: int) -> np.ndarray:
    """Vectorized flavor of coerce_row_types for one whole column."""
    if col is None:
        out = np.empty(n, dtype=object)
        return out
    t = dt.unoptionalize(t) if t is not None else None
    try:
        if t is dt.INT:
            arr = np.asarray(col)
            if np.issubdtype(arr.dtype, np.integer):
                return arr.astype(np.int64, copy=False)
            return arr.astype(np.int64)
        if t is dt.FLOAT:
            return np.asarray(col).astype(np.float64)
        if t is dt.STR:
            arr = np.asarray(col, dtype=object)
            # one full type scan — a first-element sample would let mixed
            # columns skip str() and hash/group differently than the row path
            if arr.size and not all(type(v) is str for v in arr.flat):
                return np.array(
                    [v if type(v) is str else str(v) for v in col],
                    dtype=object,
                )
            return arr
    except (ValueError, TypeError, OverflowError):
        # mixed/unparseable (numpy raises OverflowError for out-of-int64
        # values the row path keeps as python big ints): per-value below
        pass
    arr = np.empty(n, dtype=object)
    for i, v in enumerate(col):
        arr[i] = v
    dtypes = {"c": t} if t is not None else {}
    if t is not None:
        for i in range(n):
            arr[i] = coerce_row_types({"c": arr[i]}, dtypes)["c"]
    return arr


def coerce_row_types(
    values: Mapping[str, Any], dtypes: Mapping[str, dt.DType]
) -> Dict[str, Any]:
    out = dict(values)
    for c, t in dtypes.items():
        v = out.get(c)
        if v is None:
            continue
        t = dt.unoptionalize(t)
        try:
            if t is dt.INT and not isinstance(v, (int, np.integer)):
                out[c] = int(v)
            elif t is dt.FLOAT and not isinstance(v, (float, np.floating)):
                out[c] = float(v)
            elif t is dt.BOOL and not isinstance(v, (bool, np.bool_)):
                out[c] = str(v).lower() in ("1", "true", "yes", "on")
            elif t is dt.STR and not isinstance(v, str):
                out[c] = str(v)
        except (ValueError, TypeError):
            pass
    return out


_source_counter = [0]


def register_source(
    schema: Type[Schema],
    runner: Callable[[SessionWriter], None],
    *,
    mode: str = "streaming",
    upsert: bool = False,
    name: str = "source",
    persistent_id: Optional[str] = None,
    track_value_deletions: bool = False,
    atomic_batches: bool = False,
    dist_mode: str = "replicated",
    quiesce_check=None,
) -> Table:
    """Create the engine source + api table and schedule ``runner`` to feed it.

    ``mode="static"``: runner executes synchronously at run start, session
    closes after (batch).  ``mode="streaming"``: runner executes on a daemon
    thread; session closes when it returns.

    ``dist_mode`` (multi-process runs; reference ``parallel_readers``,
    src/engine/dataflow.rs:3317): "replicated" — every rank runs the runner
    and ingests identical events, the executor keeps each rank's owned-key
    slice; "partitioned" — ranks read DISJOINT splits (the runner consults
    ``parallel.distributed.process_id()``), rows are exchanged to their key
    owner; "broadcast" — one rank reads, every rank receives the full
    stream."""
    column_names = list(schema.columns().keys())
    dtypes = schema.typehints()
    _source_counter[0] += 1
    salt = _source_counter[0]
    # the env topology: graph build happens before pw.run() joins the
    # cluster, so the rank comes from the environment, not the store
    from ..parallel.distributed import topology_from_env

    processes, pid, _addr = topology_from_env()
    if processes > 1:
        # collision-free distributed salt scheme: every source stretches its
        # counter by (processes+1); partitioned sources additionally fold in
        # the rank (disjoint splits both starting their row counter at 0
        # must never mint the same key), offset by +1 so a partitioned
        # source's rank-salts can never equal ANY source's stretched counter
        salt = salt * (processes + 1)
        if dist_mode == "partitioned":
            salt += pid + 1
    session = InputSession(
        upsert=upsert or schema.primary_key_columns() is not None,
        atomic_batches=atomic_batches,
    )
    writer = SessionWriter(
        session,
        column_names,
        schema.primary_key_columns(),
        dtypes,
        salt=salt,
        track_value_deletions=track_value_deletions,
        name=name,
    )
    et = G.engine_graph.add_table(column_names, name)
    op = G.engine_graph.add_operator(
        SourceOperator(et, session, dtypes, name=name)
    )
    op.persistent_id = persistent_id
    op.writer = writer
    op.dist_mode = dist_mode
    # loop-back sources (AsyncTransformer results re-entering the graph)
    # never close their session themselves; they count as drained for
    # batch-run termination when this callable reports no queued/in-flight
    # work (the feeding sources' liveness is checked separately by the
    # executor)
    op.quiesce_check = quiesce_check

    if mode == "static":

        def hook():
            try:
                runner(writer)
            finally:
                writer.close()

    else:

        def hook():
            def target():
                try:
                    runner(writer)
                except BaseException as exc:  # noqa: BLE001
                    # re-raised on the engine thread at the next drain —
                    # a crashed reader must fail the run, not end the stream
                    session.fail(exc)
                finally:
                    writer.close()

            thread = threading.Thread(target=target, daemon=True, name=f"connector-{name}")
            thread.start()

    G.pre_run_hooks.append(hook)
    return Table(et, dtypes, Universe(), short_name=name)
