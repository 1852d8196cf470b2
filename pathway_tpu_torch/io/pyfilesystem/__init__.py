"""pw.io.pyfilesystem — read any PyFilesystem2 ``FS`` object as a table
(counterpart of ``pathway_tpu/io/pyfilesystem``; reference: python/pathway/io/pyfilesystem/__init__.py — snapshot-diff
polling over ``fs.walk``, upserting changed files and retracting deleted
ones, keyed by path).

Gated on the ``fs`` package; everything except the ``FS`` calls is local,
so the logic is fully testable with an in-memory fake
(tests/test_torch_connectors.py).  ``read`` passes ``persistent_id`` and
``autocommit_duration_ms`` on to ``pw.io.python.read``; any other keyword
argument (which the reference takes and never reads) raises.
"""

from __future__ import annotations

import time
from typing import Optional

from ...internals.schema import Schema, column_definition
from ...internals.table import Table
from .._connector import refuse_dropped
from ..python import ConnectorSubject, read as python_read

__all__ = ["read"]

STATIC_MODE_NAME = "static"


class _FileSchema(Schema):
    path: str = column_definition(primary_key=True)
    data: bytes
    _metadata: Optional[dict] = column_definition(default_value=None)


class _PyFilesystemSubject(ConnectorSubject):
    def __init__(self, source, *, path, mode, refresh_interval, with_metadata):
        super().__init__(datasource_name="pyfilesystem")
        self.source = source
        self.path = path
        self.mode = mode
        self.refresh_interval = refresh_interval
        self.with_metadata = with_metadata
        self._modify_times: dict = {}

    def run(self) -> None:
        while True:
            started = time.time()
            changed, deleted = self._snapshot_update()
            for p in changed:
                try:
                    data = self.source.readbytes(p)
                except Exception:  # noqa: BLE001 - deleted between walk and read
                    deleted.append(p)
                    continue
                row = {"path": p, "data": data}
                if self.with_metadata:
                    row["_metadata"] = self._metadata_for(p)
                self.next(**row)
            for p in deleted:
                self._modify_times.pop(p, None)
                self.delete(path=p, data=b"")
            self.commit()
            if self.mode == STATIC_MODE_NAME:
                return
            elapsed = time.time() - started
            if elapsed < self.refresh_interval:
                time.sleep(self.refresh_interval - elapsed)

    def _metadata_for(self, p: str) -> dict:
        try:
            info = self.source.getinfo(p, namespaces=["basic", "details"])
        except Exception:  # noqa: BLE001 - racing deletion
            return {"path": p, "seen_at": int(time.time())}

        def ts(dt):
            return None if dt is None else int(dt.timestamp())

        return {
            "created_at": ts(getattr(info, "created", None)),
            "modified_at": ts(getattr(info, "modified", None)),
            "accessed_at": ts(getattr(info, "accessed", None)),
            "seen_at": int(time.time()),
            "size": getattr(info, "size", None),
            "name": getattr(info, "name", p),
            "path": p,
        }

    def _snapshot_update(self):
        changed: list = []
        existing: set = set()
        for p in self.source.walk.files(path=self.path):
            existing.add(p)
            try:
                info = self.source.getinfo(p, namespaces=["details"])
                modified = getattr(info, "modified", None)
            except Exception:  # noqa: BLE001
                continue
            if self._modify_times.get(p) != modified:
                self._modify_times[p] = modified
                changed.append(p)
        deleted = [p for p in self._modify_times if p not in existing]
        return changed, deleted


def read(
    source,
    *,
    path: str = "",
    mode: str = "streaming",
    refresh_interval: float = 30.0,
    with_metadata: bool = False,
    name: str = "pyfilesystem",
    **kwargs,
) -> Table:
    """Read a PyFilesystem ``FS`` (reference signature: source FS + path +
    mode + refresh_interval + with_metadata; rows are keyed by path and
    upserted as files change, retracted when files disappear).

    ``source`` accepts any object with the ``FS`` surface used here
    (``walk.files``, ``readbytes``, ``getinfo``) — e.g.
    ``fs.open_fs("mem://")``, an S3FS, or a zip/tar FS."""
    subject = _PyFilesystemSubject(
        source,
        path=path,
        mode=mode,
        refresh_interval=refresh_interval,
        with_metadata=with_metadata,
    )
    extra = {k: kwargs.pop(k) for k in ("persistent_id", "autocommit_duration_ms") if k in kwargs}
    refuse_dropped("pw.io.pyfilesystem.read", kwargs)
    return python_read(subject, schema=_FileSchema, name=name, **extra)
