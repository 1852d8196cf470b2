"""Dispatch/fetch accounting of the serve path (counterpart of
``pathway_tpu/ops/dispatch_counter.py``).

Serve sites report every device launch group (``record_dispatch``) and
every device-to-host result copy (``record_fetch``) with a tag; a test
or ``chip_smoke.py`` installs a ``DispatchCounter`` around a serve and
asserts the budget (a retrieve-rerank serve is 2 dispatches + 2
fetches).  With no counter installed a report is one global read.  The
sites are the reference's: stage-1 submit / completion (``serve_exact``,
``serve_ivf``), the MaxSim gather (``rerank_maxsim``) and the packed
cross-encoder stage 2 (``rerank_stage2``).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

__all__ = ["DispatchCounter", "install", "record_dispatch", "record_fetch", "uninstall"]

# (kind, tag) pairs a counter keeps
MAX_EVENTS = 4096

_install_lock = threading.Lock()
_active: Optional["DispatchCounter"] = None


class DispatchCounter:
    """Counts dispatches and fetches while installed (``with
    DispatchCounter() as c:``); ``events`` keeps the first
    ``MAX_EVENTS`` ``(kind, tag)`` pairs."""

    def __init__(self) -> None:
        self.dispatches = 0
        self.fetches = 0
        self.events: List[Tuple[str, str]] = []
        self._lock = threading.Lock()

    def _record(self, kind: str, tag: str) -> None:
        with self._lock:
            if kind == "dispatch":
                self.dispatches += 1
            else:
                self.fetches += 1
            if len(self.events) < MAX_EVENTS:
                self.events.append((kind, tag))

    def __enter__(self) -> "DispatchCounter":
        install(self)
        return self

    def __exit__(self, *exc) -> None:
        uninstall()


def install(counter: Optional[DispatchCounter] = None) -> DispatchCounter:
    global _active
    with _install_lock:
        _active = counter or DispatchCounter()
        return _active


def uninstall() -> None:
    global _active
    with _install_lock:
        _active = None


def record_dispatch(tag: str) -> None:
    c = _active
    if c is not None:
        c._record("dispatch", tag)


def record_fetch(tag: str) -> None:
    c = _active
    if c is not None:
        c._record("fetch", tag)
