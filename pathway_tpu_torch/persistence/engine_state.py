"""Snapshot record/replay engine state (counterpart of
``pathway_tpu/persistence/engine_state.py``; same on-disk layout, key for
key, so a store written by either package restores in the other for a
pipeline of plain types).

Reference model (src/persistence/): two snapshot kinds through a pluggable
backend —
  * input snapshots: raw connector events + source offsets per persistent_id
    (input_snapshot.rs; connectors replay the log then *seek* the source past
    already-ingested data);
  * operator snapshots: stateful-operator state at a committed frontier
    (operator_snapshot.rs), enabled by PersistenceMode.OPERATOR_PERSISTING.

Chunk layout under the backend:
  sources/{pid}/chunk-{seq:08d}   pickled list of raw session events
  sources/{pid}/METADATA          {"chunks": n, "offsets": obj, "frontier": ts}
  operators/{stable_id}           pickled operator state at last commit
  tables/{i:05d}                  pickled row store of table i (with operators)
  COMMIT                          {"frontier": ts, "ops": bool} — written last

Every pickle goes through ``host_pickle.dumps``: a torch tensor in an
event or an operator's state is written as a numpy array, so no snapshot
holds device memory.

Under OPERATOR_PERSISTING, ``attach`` refuses a graph that holds an
operator whose state the snapshot does not carry (an external index, the
update-rows / update-cells and restrict / difference operators): the
reference restores such an operator empty and answers wrongly without an
error; PERSISTING (input replay) rebuilds it.
"""

from __future__ import annotations

import logging
import pickle
import threading
from typing import Any, Dict, List, Optional, Tuple

from . import Config, PersistenceMode, SnapshotAccess
from .backends import PersistenceBackend
from .framing import frame, scan
from .host_pickle import dumps

logger = logging.getLogger(__name__)

__all__ = ["SourcePersistence", "PersistenceManager"]

Event = Tuple[int, int, Optional[tuple]]


class SourcePersistence:
    """Per-connector recorder + restored state handed to the connector runner
    (via ``SessionWriter.persistence``)."""

    def __init__(
        self,
        backend: PersistenceBackend,
        persistent_id: str,
        record: bool = True,
    ):
        self.backend = backend
        self.pid = persistent_id
        self.record_enabled = record
        self._lock = threading.Lock()
        self._buffer: List[Event] = []
        self._offsets: Any = None
        meta = backend.get(f"sources/{self.pid}/METADATA")
        self._meta = pickle.loads(meta) if meta else {"chunks": 0, "offsets": None}
        self._offsets = self._meta.get("offsets")

    # -- runner-facing API -------------------------------------------------
    def offsets(self) -> Any:
        """Last committed source position (connector-defined shape)."""
        return self._offsets

    def save_offsets(self, offsets: Any) -> None:
        with self._lock:
            self._offsets = offsets

    # -- engine-facing API -------------------------------------------------
    def record(self, event: Event) -> None:
        if not self.record_enabled:
            return
        with self._lock:
            self._buffer.append(event)

    #: chunk format marker; bump when the framing/payload encoding changes so
    #: old snapshots are recognized instead of being misread as corruption
    CHUNK_MAGIC = b"PWC1"

    def replay_events(self) -> List[Event]:
        """Replay recorded events; each chunk is a CRC-framed record log, so a
        torn/corrupt tail truncates replay at the last intact record rather
        than failing (the reference's rewind-to-common-frontier behavior,
        docs/.../10.worker-architecture.md:58-61).

        On a corrupt tail the log is REWRITTEN at the truncation point: the
        torn chunk is replaced by its intact prefix and later chunks are
        deleted, so subsequent flushes append consistently — otherwise every
        future replay would re-hit the torn chunk and silently drop
        everything recorded after the first recovery."""
        events: List[Event] = []
        n_chunks = self._meta.get("chunks", 0)
        for seq in range(n_chunks):
            key = f"sources/{self.pid}/chunk-{seq:08d}"
            blob = self.backend.get(key)
            if not blob:
                continue
            if blob.startswith(self.CHUNK_MAGIC):
                blob = blob[len(self.CHUNK_MAGIC):]
            payloads, intact = scan(blob)
            for p in payloads:
                events.append(pickle.loads(p))
            if not intact:
                logger.warning(
                    "snapshot chunk %s/%08d has a corrupt tail; replay "
                    "truncated at the last intact record%s",
                    self.pid,
                    seq,
                    " and the log rewound to this point"
                    if self.record_enabled
                    else "",
                )
                if self.record_enabled:
                    # about to append new events: rewind the on-disk log so
                    # future flushes stay reachable.  In replay-only mode
                    # (SnapshotAccess.REPLAY) never mutate the backend —
                    # truncation is in-memory and the data stays recoverable.
                    self._truncate_log_at(seq, payloads)
                break
        return events

    def _truncate_log_at(self, seq: int, intact_payloads: List[bytes]) -> None:
        """Rewrite chunk ``seq`` with its intact prefix, drop later chunks,
        rewind the chunk counter AND the saved source offsets so the next run
        re-reads from before the tear (at-least-once: later chunks' events
        come back from the source instead of being lost — the committed
        frontier/offsets would otherwise seek past data that no longer
        exists on disk)."""
        key = f"sources/{self.pid}/chunk-{seq:08d}"
        if intact_payloads:
            self.backend.put(
                key,
                self.CHUNK_MAGIC + b"".join(frame(p) for p in intact_payloads),
            )
            self._meta["chunks"] = seq + 1
        else:
            self.backend.delete(key)
            self._meta["chunks"] = seq
        # sweep every chunk file at/after the new counter (incl. torn runs)
        for k in self.backend.list_keys(f"sources/{self.pid}/"):
            name = k.rsplit("/", 1)[-1]
            if name.startswith("chunk-"):
                try:
                    s = int(name[len("chunk-"):])
                except ValueError:
                    continue
                if s >= self._meta["chunks"]:
                    self.backend.delete(f"sources/{self.pid}/chunk-{s:08d}")
        # rewind offsets to the snapshot taken at the last surviving chunk;
        # keyed by seq (not list position) so truncation never desynchronizes
        # the mapping.  chunk seq's own snapshot also covers its lost tail,
        # so the chunk BEFORE the tear is the newest trustworthy position;
        # a missing entry (legacy metadata) degrades to None = re-read all.
        chunk_offsets = dict(self._meta.get("chunk_offsets") or {})
        rewind_to = seq - 1
        self._offsets = chunk_offsets.get(rewind_to)
        self._meta["offsets"] = self._offsets
        self._meta["chunk_offsets"] = {
            s: o for s, o in chunk_offsets.items() if s <= rewind_to
        }
        self._meta["sealed"] = min(
            self._meta.get("sealed", 0), self._meta["chunks"]
        )
        self.backend.put(f"sources/{self.pid}/METADATA", dumps(self._meta))

    #: merge the chunk log once it exceeds this many files (reference:
    #: ConcreteSnapshotMerger background compaction, operator_snapshot.rs:337)
    COMPACT_AFTER = 64

    def flush(self, frontier: int) -> None:
        with self._lock:
            buffer, self._buffer = self._buffer, []
            offsets = self._offsets
        if buffer:
            seq = self._meta["chunks"]
            chunk = self.CHUNK_MAGIC + b"".join(
                frame(dumps(event)) for event in buffer
            )
            self.backend.put(f"sources/{self.pid}/chunk-{seq:08d}", chunk)
            self._meta["chunks"] = seq + 1
            # per-chunk offsets snapshot (keyed by seq): lets corrupt-tail
            # recovery rewind the source position together with the log
            chunk_offsets = self._meta.get("chunk_offsets")
            if not isinstance(chunk_offsets, dict):
                chunk_offsets = {}
                self._meta["chunk_offsets"] = chunk_offsets
            chunk_offsets[seq] = offsets
            if (
                self._meta["chunks"] - self._meta.get("sealed", 0)
                > self.COMPACT_AFTER
            ):
                self._compact()
        self._meta["offsets"] = offsets
        self._meta["frontier"] = frontier
        self.backend.put(f"sources/{self.pid}/METADATA", dumps(self._meta))

    def _merge_range(self, start: int, end: int) -> None:
        """Merge chunks [start, end) into one chunk at ``start``."""
        merged: List[bytes] = []
        last_intact = start - 1
        for seq in range(start, end):
            key = f"sources/{self.pid}/chunk-{seq:08d}"
            blob = self.backend.get(key)
            if not blob:
                continue
            if blob.startswith(self.CHUNK_MAGIC):
                blob = blob[len(self.CHUNK_MAGIC):]
            payloads, intact = scan(blob)
            merged.extend(payloads)
            last_intact = seq
            if not intact:
                break
        self.backend.put(
            f"sources/{self.pid}/chunk-{start:08d}",
            self.CHUNK_MAGIC + b"".join(frame(p) for p in merged),
        )
        for seq in range(start + 1, end):
            self.backend.delete(f"sources/{self.pid}/chunk-{seq:08d}")
        chunk_offsets = dict(self._meta.get("chunk_offsets") or {})
        kept = {s: o for s, o in chunk_offsets.items() if s < start}
        kept[start] = chunk_offsets.get(last_intact)
        self._meta["chunks"] = start + 1
        self._meta["chunk_offsets"] = kept

    def _compact(self) -> None:
        """Tiered merge: seal the newest COMPACT_AFTER chunks into one
        segment; when sealed segments pile up, merge them too.  Each event is
        rewritten O(1) times per tier (amortized O(n log n) backend I/O over
        a job's lifetime — a full-log rewrite every 64 flushes would be
        quadratic).  File count stays <= 2*COMPACT_AFTER; byte growth is
        inherent to an input log (OPERATOR_PERSISTING truncates bytes via
        drop_log)."""
        sealed = self._meta.get("sealed", 0)  # chunks below this are sealed
        self._merge_range(sealed, self._meta["chunks"])
        self._meta["sealed"] = sealed + 1
        if self._meta["sealed"] > self.COMPACT_AFTER:
            self._merge_range(0, self._meta["chunks"])
            self._meta["sealed"] = 1

    def drop_log(self) -> None:
        """Delete every recorded chunk (OPERATOR_PERSISTING: once operator
        snapshots cover the frontier, the input log before it is dead
        weight — restores come from operator state, not replay)."""
        for seq in range(self._meta["chunks"]):
            self.backend.delete(f"sources/{self.pid}/chunk-{seq:08d}")
        self._meta["chunks"] = 0
        self._meta["sealed"] = 0
        self._meta["chunk_offsets"] = {}
        self.backend.put(f"sources/{self.pid}/METADATA", dumps(self._meta))


# Operator/table snapshots embed derived row keys (join output keys, group
# keys); bump this whenever key derivation changes so stale snapshots are
# rejected loudly and the run falls back to input-event replay (which
# re-derives every key) instead of silently mixing key formats.
SNAPSHOT_FORMAT = 2


class PersistenceManager:
    """Wires a Config into a built engine graph: replays input snapshots
    before the run, records new events, and (in OPERATOR_PERSISTING mode)
    checkpoints/restores stateful-operator state."""

    def __init__(self, config: Config):
        if config.backend is None:
            raise ValueError("persistence Config.backend is required")
        self.config = config
        self.backend: PersistenceBackend = config.backend.make_store()
        self.interval_ms = max(int(config.snapshot_interval_ms), 1)
        self._sources: List[Tuple[Any, SourcePersistence]] = []
        self._graph = None
        self._last_flush_ts = 0
        commit = self.backend.get("COMMIT")
        self._commit = pickle.loads(commit) if commit else None

    @property
    def operator_mode(self) -> bool:
        return self.config.persistence_mode == PersistenceMode.OPERATOR_PERSISTING

    def _refuse_unsnapshotted(self, graph) -> None:
        """OPERATOR_PERSISTING restores operators from their snapshots and
        drops the input log; an operator whose state no snapshot carries
        would come back empty and answer wrongly without an error.  The walk
        goes into nested graphs (a ``pw.iterate`` body), whose operators ride
        in their outer operator's snapshot."""
        from ..engine.operators.external_index import ExternalIndexOperator
        from ..engine.operators.rowwise import RestrictOperator, UpdateCellsOperator, UpdateRowsOperator

        stateful = (ExternalIndexOperator, UpdateRowsOperator, UpdateCellsOperator, RestrictOperator)
        for op in graph.operators:
            if isinstance(op, stateful):
                raise ValueError(
                    f"PersistenceMode.OPERATOR_PERSISTING cannot snapshot {type(op).__name__} "
                    f"({op.name}#{op.id}): its state would be restored empty; use "
                    "PersistenceMode.PERSISTING, whose input replay rebuilds it"
                )
            nested = getattr(op, "nested_graph", None)
            if nested is not None:
                self._refuse_unsnapshotted(nested)

    # -- wiring ------------------------------------------------------------
    def attach(self, graph) -> None:
        """Replay snapshots into source sessions and start recording.
        Must run after graph build, before connector hooks start."""
        if self.operator_mode:
            self._refuse_unsnapshotted(graph)
        self._graph = graph
        access = self.config.snapshot_access
        record = access in (SnapshotAccess.RECORD, SnapshotAccess.FULL)
        replay = access in (SnapshotAccess.REPLAY, SnapshotAccess.FULL)
        restored_ops = self.operator_mode and self._restore_operators()
        # operator-mode commits truncate the input log (drop_log); if the
        # operator snapshot then can't be used (format bump, mode switched
        # back to input replay), the only safe recovery is a FULL re-ingest:
        # reset source offsets so connectors re-read from the beginning
        # instead of seeking past data whose log no longer exists
        logs_dropped = bool(self._commit and self._commit.get("ops"))
        reset_offsets = logs_dropped and not restored_ops
        if reset_offsets:
            logger.warning(
                "operator snapshots unusable but the input log was truncated "
                "by OPERATOR_PERSISTING commits — resetting source offsets "
                "for a full re-ingest (at-least-once recovery)"
            )
        for src in graph.sources:
            pid = getattr(src, "persistent_id", None)
            writer = getattr(src, "writer", None)
            if not pid:
                continue
            sp = SourcePersistence(self.backend, pid, record=record)
            if reset_offsets:
                sp.save_offsets(None)
            if writer is not None:
                writer.persistence = sp
            if record:
                src.session.recorder = sp.record
            if replay and not restored_ops:
                events = sp.replay_events()
                if events:
                    src.session.push_raw(events)
            self._sources.append((src, sp))

    def _stable_ids(self):
        """Deterministic operator keys: construction order + class name (the
        same user script rebuilds the same graph in the same order)."""
        out = []
        for i, op in enumerate(self._graph.operators):
            out.append((f"{i:05d}-{type(op).__name__}", op))
        return out

    def _restore_operators(self) -> bool:
        if not self._commit or not self._commit.get("ops"):
            return False
        if self._commit.get("format") != SNAPSHOT_FORMAT:
            logger.warning(
                "operator snapshot format %s != current %s; ignoring operator "
                "snapshots and replaying input events instead",
                self._commit.get("format"),
                SNAPSHOT_FORMAT,
            )
            return False
        restored = 0
        for stable_id, op in self._stable_ids():
            blob = self.backend.get(f"operators/{stable_id}")
            if blob is None:
                continue
            state = pickle.loads(blob)
            try:
                op.restore_state(state)
                restored += 1
            except NotImplementedError:
                pass
        # table row stores (retraction-lookup state — the analog of restored
        # differential arrangements)
        for i, table in enumerate(self._graph.tables):
            blob = self.backend.get(f"tables/{i:05d}")
            if blob is not None:
                table.store._rows = pickle.loads(blob)
                restored += 1
        return restored > 0

    def _snapshot_operators(self) -> bool:
        any_saved = False
        for stable_id, op in self._stable_ids():
            try:
                state = op.snapshot_state()
            except NotImplementedError:
                continue
            if state is None:
                continue
            self.backend.put(f"operators/{stable_id}", dumps(state))
            any_saved = True
        if any_saved:
            for i, table in enumerate(self._graph.tables):
                self.backend.put(f"tables/{i:05d}", dumps(table.store._rows))
        return any_saved

    # -- runtime -----------------------------------------------------------
    def on_tick(self, ts: int) -> None:
        if ts - self._last_flush_ts >= self.interval_ms:
            self.commit(ts)

    def commit(self, ts: int) -> None:
        self._last_flush_ts = ts
        for _src, sp in self._sources:
            sp.flush(ts)
        ops_saved = self.operator_mode and self._snapshot_operators()
        self.backend.put(
            "COMMIT",
            dumps(
                {
                    "frontier": ts,
                    "ops": bool(ops_saved),
                    "format": SNAPSHOT_FORMAT,
                }
            ),
        )
        if ops_saved:
            # the operator snapshot covers everything flushed above; the
            # input log is no longer needed for recovery (this is what keeps
            # OPERATOR_PERSISTING byte-bounded on long-running jobs)
            for _src, sp in self._sources:
                sp.drop_log()

    def finalize(self, ts: int) -> None:
        self.commit(ts)
