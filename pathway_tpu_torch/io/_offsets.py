"""Per-partition committed offsets and connector lag (counterpart of
``pathway_tpu/io/_offsets.py``; standard library only).

An ``OffsetAntichain`` maps each partition (file path, kafka partition,
shard) to its highest committed offset: total order within a partition,
none across, merged by the per-partition max.  A ``ConnectorMonitor``
keeps one connector's row and commit counters, its last-activity clock
(the lag the ingest runner's provider samples) and its antichain.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Dict, Optional

__all__ = ["ConnectorMonitor", "OffsetAntichain", "connector_monitors"]


class OffsetAntichain:
    """Committed read positions, one per partition.  Offsets only
    advance; merging takes the per-partition max."""

    def __init__(self, positions: Optional[Dict[Any, Any]] = None):
        self._positions: Dict[Any, Any] = dict(positions or {})

    def advance(self, partition: Any, offset: Any) -> None:
        cur = self._positions.get(partition)
        if cur is None or offset > cur:
            self._positions[partition] = offset

    def merge(self, other: "OffsetAntichain") -> "OffsetAntichain":
        merged = OffsetAntichain(self._positions)
        for partition, offset in other._positions.items():
            merged.advance(partition, offset)
        return merged

    def as_dict(self) -> Dict[Any, Any]:
        return dict(self._positions)

    def __len__(self) -> int:
        return len(self._positions)

    def __eq__(self, other) -> bool:
        return isinstance(other, OffsetAntichain) and self._positions == other._positions

    def __repr__(self) -> str:  # pragma: no cover
        return f"OffsetAntichain({self._positions!r})"


_monitors: "weakref.WeakSet[ConnectorMonitor]" = weakref.WeakSet()


def connector_monitors():
    """Live connector monitors (scraped by the metrics server)."""
    return list(_monitors)


class ConnectorMonitor:
    """Per-connector ingestion stats: row and commit counters, the
    last-activity clock for lag, and the committed offset antichain."""

    _ids = 0

    def __init__(self, name: str):
        self.name = name
        ConnectorMonitor._ids += 1
        self.id = ConnectorMonitor._ids  # uniquifies metric labels
        self._lock = threading.Lock()
        self.rows_inserted = 0
        self.rows_deleted = 0
        self.commits = 0
        self.last_row_at: Optional[float] = None
        self.last_commit_at: Optional[float] = None
        self.offsets = OffsetAntichain()
        self.finished = False
        _monitors.add(self)

    def on_insert(self, n: int = 1) -> None:
        with self._lock:
            self.rows_inserted += n
            self.last_row_at = time.time()

    def on_delete(self, n: int = 1) -> None:
        with self._lock:
            self.rows_deleted += n
            self.last_row_at = time.time()

    def on_commit(self, offsets: Optional[OffsetAntichain] = None) -> None:
        with self._lock:
            self.commits += 1
            self.last_commit_at = time.time()
            if offsets is not None:
                self.offsets = self.offsets.merge(offsets)

    def on_finish(self) -> None:
        self.finished = True

    def lag_seconds(self) -> Optional[float]:
        """Seconds since the connector last produced a row (None before
        the first row)."""
        if self.last_row_at is None:
            return None
        return max(0.0, time.time() - self.last_row_at)

    def stats(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "rows_inserted": self.rows_inserted,
            "rows_deleted": self.rows_deleted,
            "commits": self.commits,
            "lag_seconds": self.lag_seconds(),
            "last_commit_at": self.last_commit_at,
            "partitions": len(self.offsets),
            "offsets": self.offsets.as_dict(),
            "finished": self.finished,
        }
