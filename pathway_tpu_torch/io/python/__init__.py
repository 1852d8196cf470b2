"""pw.io.python — custom push sources
(reference: python/pathway/io/python/__init__.py:49 ConnectorSubject)."""

from __future__ import annotations

import json as _json
import queue
import threading
from typing import Any, Dict, Optional, Type

from ...internals.schema import Schema
from ...internals.table import Table
from .._connector import SessionWriter, register_source

__all__ = ["ConnectorSubject", "read"]


class ConnectorSubject:
    """Subclass and implement ``run()``; push rows with ``next(**kwargs)``
    (also next_json/next_str/next_bytes), delete with ``delete``."""

    _writer: Optional[SessionWriter] = None

    def __init__(self, datasource_name: str = "python"):
        self._datasource_name = datasource_name

    # -- to be implemented by user --------------------------------------
    def run(self) -> None:
        raise NotImplementedError

    def on_stop(self) -> None:
        pass

    # -- push API --------------------------------------------------------
    def next(self, **kwargs) -> None:
        assert self._writer is not None, "subject not started"
        self._writer.insert(kwargs)

    def next_json(self, message: Dict[str, Any]) -> None:
        self.next(**message)

    def next_str(self, message: str) -> None:
        self.next(data=message)

    def next_bytes(self, message: bytes) -> None:
        self.next(data=message)

    def delete(self, **kwargs) -> None:
        assert self._writer is not None
        self._writer.remove(kwargs)

    def commit(self) -> None:
        """Seal rows pushed so far into one atomic batch with its own commit
        tick (InputSession.mark_batch)."""
        if self._writer is not None:
            self._writer.session.mark_batch()

    def close(self) -> None:
        pass

    def start(self) -> None:
        try:
            self.run()
        finally:
            self.on_stop()


def read(
    subject: ConnectorSubject,
    *,
    schema: Type[Schema],
    autocommit_duration_ms: int = 100,
    name: str = "python",
    atomic_batches: bool = False,
    persistent_id: Optional[str] = None,
    **kwargs,
) -> Table:
    """``autocommit_duration_ms`` is accepted for reference parity; batch
    boundaries are structural here — ``subject.commit()`` seals a batch and
    the engine assigns it its own commit tick (InputSession.mark_batch).
    ``persistent_id`` records the subject's rows under a persistence
    config, so a restart replays them (the reference's ``read`` drops the
    argument; its tests set the source operator's ``persistent_id``)."""

    def runner(writer: SessionWriter):
        subject._writer = writer
        subject.start()

    return register_source(
        schema,
        runner,
        mode="streaming",
        name=name,
        track_value_deletions=True,
        atomic_batches=atomic_batches,
        persistent_id=persistent_id,
    )
