"""Interactive (REPL/notebook) mode of the port — live table snapshots
(counterpart of ``pathway_tpu/internals/interactive.py``).

Reference: python/pathway/internals/interactive.py — ``enable_interactive_mode``
starts the computation on a background thread and ``LiveTable`` objects render
the *current* state of a table whenever displayed.  Here the eager engine
already keeps each table's accumulated state in its engine store, so a
LiveTable is a display handle: it (re)drives the executor on a daemon thread
(streaming sources keep ticking) and snapshots the store on render.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

__all__ = ["LiveTable", "enable_interactive_mode", "is_interactive_mode_enabled"]

_controller: Optional["InteractiveModeController"] = None


class InteractiveModeController:
    """Owns the background run thread started by ``enable_interactive_mode``."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def ensure_running(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return

            def _drive():
                from . import run as run_mod

                try:
                    run_mod.run(monitoring_level=None)
                except Exception:  # surfaced via the error log, not the REPL
                    import logging

                    logging.getLogger("pathway_tpu_torch.interactive").exception(
                        "interactive run failed"
                    )

            self._thread = threading.Thread(
                target=_drive, name="pathway-interactive", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        from . import run as run_mod

        run_mod.terminate()
        with self._lock:
            if self._thread is not None:
                self._thread.join(timeout=5.0)
                self._thread = None


def enable_interactive_mode() -> InteractiveModeController:
    """Turn on interactive mode (reference internals/interactive.py:203).
    After this, ``LiveTable.create(t)`` / ``t.live()`` return live views."""
    global _controller
    if _controller is None:
        _controller = InteractiveModeController()
    return _controller


def is_interactive_mode_enabled() -> bool:
    return _controller is not None


class LiveTable:
    """A live, displayable view of a table (reference ``pw.LiveTable``,
    internals/interactive.py:130).  ``str()`` / ``_repr_html_`` show the
    current snapshot; the backing computation runs on a daemon thread."""

    def __init__(self, table, *, settle_ms: int = 0):
        if _controller is None:
            raise RuntimeError(
                "interactive mode is not enabled; call pw.enable_interactive_mode()"
            )
        self._table = table
        _controller.ensure_running()
        if settle_ms:
            time.sleep(settle_ms / 1000.0)

    @classmethod
    def create(cls, table) -> "LiveTable":
        return cls(table)

    def snapshot(self):
        """(keys, {column: values}) of the current accumulated state."""
        return self._table._materialize()

    def to_pandas(self):
        import pandas as pd

        from .keys import Pointer

        keys, columns = self.snapshot()
        df = pd.DataFrame({name: list(col) for name, col in columns.items()})
        df.index = [Pointer(k) for k in keys]
        return df

    def __str__(self) -> str:
        keys, columns = self.snapshot()
        names = list(columns.keys())
        header = ["id"] + names
        rows = [
            [f"^{int(k) % 0xFFFFFF:X}"] + [str(columns[c][i]) for c in names]
            for i, k in enumerate(keys)
        ]
        widths = [
            max(len(header[c]), *(len(r[c]) for r in rows)) if rows else len(header[c])
            for c in range(len(header))
        ]
        out = [" | ".join(h.ljust(w) for h, w in zip(header, widths))]
        out += [" | ".join(v.ljust(w) for v, w in zip(r, widths)) for r in rows]
        return "\n".join(out)

    __repr__ = __str__

    def _repr_html_(self) -> str:
        return self.to_pandas()._repr_html_()
