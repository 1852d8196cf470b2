"""Serve result type of the port (counterpart of
``pathway_tpu/robust/degrade.py`` ``ServeResult``)."""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence

__all__ = ["ServeResult"]


class ServeResult(list):
    """Serve rows plus ladder metadata.  Compares equal to a plain list
    of the same rows; carries ``degraded`` — the tuple of rung flags
    that applied to this serve, deduplicated in order — and ``meta``
    (e.g. ``index_generation``).  The full reason list is mirrored into
    ``meta["degraded_reasons"]`` for metadata-only consumers."""

    __slots__ = ("degraded", "meta")

    def __init__(
        self,
        rows: Iterable[Any] = (),
        degraded: Sequence[str] = (),
        meta: Optional[Dict[str, Any]] = None,
    ):
        super().__init__(rows)
        deduped: List[str] = []
        for flag in degraded:
            if flag not in deduped:
                deduped.append(flag)
        self.degraded = tuple(deduped)
        self.meta = dict(meta or {})
        if self.degraded and "degraded_reasons" not in self.meta:
            self.meta["degraded_reasons"] = list(self.degraded)

    @property
    def ok(self) -> bool:
        return not self.degraded
