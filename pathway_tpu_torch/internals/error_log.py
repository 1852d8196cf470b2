"""Global error log — per-run record of row-level errors.

The reference routes operator errors into a dedicated error-log table a user
can subscribe to (src/engine/error.rs:337 DataError + error-log routing;
``pw.global_error_log()``).  Here row-level failures become ``Error`` cells
(internals/error_value.py) that keep flowing — and every creation site also
appends an entry here, so users and tests can inspect *what* failed and
*where* without fishing cells out of downstream tables.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from .trace import Trace

__all__ = [
    "ErrorLogEntry",
    "log_error",
    "global_error_log",
    "local_error_log",
    "clear_error_log",
]

logger = logging.getLogger("pathway_tpu_torch.errors")

_MAX_ENTRIES = 10_000
_lock = threading.Lock()
_entries: deque = deque(maxlen=_MAX_ENTRIES)
_local_sinks: list = []

# the engine operator currently executing on this thread (set by
# EngineGraph around op.process) — lets local_error_log() attribute row
# errors to the operator that raised them, like the reference's per-operator
# error-log routing (src/engine/error.rs:337)
_tls = threading.local()


def set_current_operator(op) -> None:
    _tls.op = op


def current_operator_id() -> Optional[int]:
    op = getattr(_tls, "op", None)
    return None if op is None else op.id


@dataclass(frozen=True)
class ErrorLogEntry:
    message: str
    operator: Optional[str] = None
    trace: Optional[Trace] = None
    extra: dict = field(default_factory=dict)

    def __str__(self) -> str:
        loc = f" at {self.trace}" if self.trace else ""
        src = f" [{self.operator}]" if self.operator else ""
        return f"{self.message}{src}{loc}"


def log_error(
    message: str,
    *,
    operator: Optional[str] = None,
    trace: Optional[Trace] = None,
    op_id: Optional[int] = None,
    **extra,
) -> ErrorLogEntry:
    # explicit op_id wins: executor threads (async UDFs, pool workers) have
    # no engine-thread-local operator, so dispatch sites capture identity
    # up front and pass it through (ADVICE r4 low #5)
    if op_id is None:
        op_id = current_operator_id()
    if op_id is not None:
        extra = {**extra, "op_id": op_id}
    entry = ErrorLogEntry(message, operator, trace, extra)
    with _lock:
        _entries.append(entry)
        for sink in _local_sinks:
            if sink.accepts(entry):
                sink.append(entry)
    logger.debug("row error: %s", entry)
    return entry


class LocalErrorLog(list):
    """Errors belonging to a ``local_error_log()`` context: raised while it
    was open, or raised at ANY later point by an operator *built* inside it
    (reference semantics, internals/errors.py:13)."""

    def __init__(self):
        super().__init__()
        self._open = True
        self._op_ids: Optional[frozenset] = None

    def accepts(self, entry: ErrorLogEntry) -> bool:
        if self._open:
            return True
        if self._op_ids is None:
            return False
        op_id = entry.extra.get("op_id")
        return op_id is not None and op_id in self._op_ids


def local_error_log():
    """Context manager yielding a log that captures errors of this context:
    entries raised while it is open, plus entries raised later by operators
    BUILT inside it (the reference's scoping, internals/errors.py:13 — build
    the pipeline in the ``with`` block, run afterwards, read the log).
    Entries also remain visible in the global log."""
    import contextlib

    @contextlib.contextmanager
    def _cm():
        from .parse_graph import G

        captured = LocalErrorLog()
        n0 = len(G.engine_graph.operators)
        with _lock:
            _local_sinks.append(captured)
        try:
            yield captured
        finally:
            # stay registered: operators built inside keep routing their
            # errors here when the graph runs after the block exits.  Bound
            # the registry — a service opening many contexts must not leak
            # sink scans/memory without limit; oldest closed sinks retire.
            # The EXACT id set (not an id range) scopes the capture; graph
            # building is assumed single-threaded (as in the reference —
            # the ParseGraph is a process-global built by the user script),
            # so ops[n0:] are precisely the ones built inside the block.
            ops = G.engine_graph.operators
            captured._op_ids = frozenset(op.id for op in ops[n0:])
            captured._open = False
            if not captured._op_ids:
                # nothing built inside: nothing can route here later
                with _lock:
                    if captured in _local_sinks:
                        _local_sinks.remove(captured)
            _prune_sinks()

    return _cm()


_MAX_CLOSED_SINKS = 256


def _prune_sinks() -> None:
    with _lock:
        closed = [s for s in _local_sinks if not s._open]
        for s in closed[:-_MAX_CLOSED_SINKS]:
            _local_sinks.remove(s)


def reset_local_sinks() -> None:
    """Drop every registered local sink (pw.reset(): the operators they
    scope are gone with the graph)."""
    with _lock:
        _local_sinks.clear()


def global_error_log() -> list:
    """Entries logged so far this process (most recent last)."""
    with _lock:
        return list(_entries)


def clear_error_log() -> None:
    with _lock:
        _entries.clear()
