"""pw.io.null of the port — sink that discards output (counterpart of
``pathway_tpu/io/null``; reference: python/pathway/io/null)."""

from __future__ import annotations

from ...internals.table import Table
from .._subscribe import subscribe

__all__ = ["write"]


def write(table: Table, **kwargs) -> None:
    subscribe(table, on_change=lambda **kw: None)
