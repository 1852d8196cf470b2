"""pw.stateful of the port (counterpart of ``pathway_tpu/stdlib/stateful``;
reference: python/pathway/stdlib/stateful/deduplicate.py:9).  The
deduplicate operator's state is carried by OPERATOR_PERSISTING snapshots;
``persistent_id`` is accepted for the reference's signature."""

from __future__ import annotations

from typing import Any, Callable, Optional

from ...internals.table import Table

__all__ = ["deduplicate"]


def deduplicate(
    table: Table,
    *,
    value,
    instance=None,
    acceptor: Callable[[Any, Any], bool],
    persistent_id: Optional[str] = None,
    name: str = "deduplicate",
) -> Table:
    return table.deduplicate(
        value=value, instance=instance, acceptor=acceptor, name=name
    )
