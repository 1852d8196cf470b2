"""Export/import tables across graphs, in the port (counterpart of
``pathway_tpu/internals/export_import.py``)
(reference: ``trait ExportedTable`` — frontier + subscribe handle for graph
composition, src/engine/graph.rs:629-662, wired through Scope.export_table /
import_table, src/python_api.rs).

``pw.export_table(t)`` captures the table's update stream (with keys) into a
buffer that OUTLIVES the graph; ``pw.import_table(handle)`` replays it —
history first, then live — as a source in whatever graph is current at the
time.  Two builds of the global graph (pw.reset between them) can thus hand
a table across, as the reference's two scopes do."""

from __future__ import annotations

import threading
import time as _time
from typing import Any, Dict, List, Tuple

from ..engine.graph import OutputCallbacks
from ..engine.operators.io import SubscribeOperator
from .parse_graph import G
from .schema import schema_from_dict
from .table import Table

__all__ = ["ExportedTable", "export_table", "import_table", "close_all_exports"]

# open handles, closed defensively by pw.reset(): once the exporting graph
# is discarded, no more data can ever arrive, and a consumer blocked on an
# open handle would wait forever
_open_handles: List["ExportedTable"] = []
_handles_lock = threading.Lock()


def close_all_exports() -> None:
    with _handles_lock:
        handles, _open_handles[:] = list(_open_handles), []
    for h in handles:
        h._on_end()


class ExportedTable:
    """Buffered update stream + frontier of an exported table (reference
    ExportedTable: failed/frontier/data/subscribe, graph.rs:629-646)."""

    def __init__(self, column_names: List[str], dtypes: Dict[str, Any]):
        self.column_names = list(column_names)
        self.dtypes = dict(dtypes)
        self._lock = threading.Lock()
        self._events: List[Tuple[int, Tuple[Any, ...], int, int]] = []
        self.frontier: int = 0
        self.closed = False

    # -- producer side (SubscribeOperator callbacks) -----------------------
    def _on_change(self, key: int, row: Tuple[Any, ...], ts: int, diff: int) -> None:
        with self._lock:
            self._events.append((key, row, ts, diff))

    def _on_time_end(self, ts: int) -> None:
        with self._lock:
            self.frontier = max(self.frontier, ts)

    def _on_end(self) -> None:
        with self._lock:
            self.closed = True
        with _handles_lock:
            if self in _open_handles:
                _open_handles.remove(self)

    # -- consumer side ------------------------------------------------------
    def events_since(self, start: int) -> Tuple[List[Tuple], bool, int]:
        """(events[start:], closed, next_start)."""
        with self._lock:
            chunk = self._events[start:]
            return chunk, self.closed, start + len(chunk)

    def snapshot(self) -> List[Tuple[int, Tuple[Any, ...]]]:
        """Current rows (insertions minus retractions), keyed."""
        live: Dict[int, Tuple[Any, ...]] = {}
        with self._lock:
            for key, row, _ts, diff in self._events:
                if diff > 0:
                    live[key] = row
                else:
                    live.pop(key, None)
        return list(live.items())


def export_table(table: Table) -> ExportedTable:
    """Capture ``table``'s update stream for use by a later/other graph."""
    engine_table = table._engine_table
    names = table.column_names
    engine_names = [table._column_mapping[n] for n in names]
    col_idx = [engine_table.column_names.index(e) for e in engine_names]
    handle = ExportedTable(names, dict(table._dtypes))

    def on_change(key, row_tuple, ts, diff):
        handle._on_change(
            int(key), tuple(row_tuple[i] for i in col_idx), ts, int(diff)
        )

    G.engine_graph.add_operator(
        SubscribeOperator(
            engine_table,
            OutputCallbacks(
                on_change=on_change,
                on_time_end=handle._on_time_end,
                on_end=handle._on_end,
            ),
            name="export",
        )
    )
    handle._graph = G.engine_graph  # same-graph import guard
    with _handles_lock:
        _open_handles.append(handle)
    return handle


def import_table(
    handle: ExportedTable, poll_interval_s: float = 0.05
) -> Table:
    """Materialize an exported stream as a source table in the CURRENT
    graph: recorded history replays first, then live updates follow until
    the exporting graph closes (reference Scope.import_table)."""
    from ..io._connector import register_source

    schema = schema_from_dict(
        {n: handle.dtypes.get(n, Any) for n in handle.column_names},
        name="Imported",
    )

    if getattr(handle, "_graph", None) is G.engine_graph:
        # same-graph import would deadlock: the import source waits for the
        # handle to close, which happens only when THIS run ends
        raise ValueError(
            "import_table: the handle was exported from the CURRENT graph; "
            "run the exporting graph first (or pw.reset() to start the "
            "importing graph), as with the reference's separate scopes"
        )

    def runner(writer) -> None:
        pos = 0
        while True:
            events, closed, pos = handle.events_since(pos)
            for key, row, _ts, diff in events:
                values = dict(zip(handle.column_names, row))
                if diff > 0:
                    writer.insert(values, key=key)
                else:
                    writer.remove(values, key=key)
            if closed and not events:
                return
            if not events:
                _time.sleep(poll_interval_s)

    return register_source(
        schema, runner, mode="streaming", name="import_table"
    )
