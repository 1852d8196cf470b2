"""pw.io.deltalake — Delta Lake connector (counterpart of
``pathway_tpu/io/deltalake``; reference: python/pathway/io/deltalake/__init__.py over DeltaTableReader /
DeltaBatchWriter, src/connectors/data_storage.rs).  Gated on the deltalake
package.  ``write`` commits at every engine tick: a ``min_commit_frequency``
other than the default, and keyword arguments the reference takes and
never reads, raise.
"""

from __future__ import annotations

import time
from typing import Optional, Type

from ...internals.schema import Schema
from ...internals.table import Table
from .._connector import SessionWriter, refuse_dropped, register_source
from .._gated import require
from .._subscribe import subscribe

__all__ = ["read", "write"]


def read(
    uri: str,
    *,
    schema: Type[Schema],
    mode: str = "streaming",
    poll_interval_s: float = 1.0,
    name: str = "deltalake",
    persistent_id: Optional[str] = None,
    **kwargs,
) -> Table:
    """Read a Delta table; streaming mode tails new versions (CDC-style)."""
    refuse_dropped("pw.io.deltalake.read", kwargs)
    require("deltalake", "deltalake")
    columns = list(schema.columns().keys())

    pkey = schema.primary_key_columns()

    def runner(writer: SessionWriter):
        from deltalake import DeltaTable  # type: ignore

        from ...internals.keys import ref_scalar

        pers = writer.persistence
        version = -1
        previous = {}
        while True:
            dt = DeltaTable(uri)
            current = dt.version()
            if current > version:
                # snapshot-diff against the previous version: upserts for
                # new/changed identities, retractions for removed ones.
                # Without a primary key, identity = row content + occurrence
                # number (stable across versions for unchanged rows).
                rows = {}
                occurrence: dict = {}
                for rec in dt.to_pyarrow_table().to_pylist():
                    projected = {c: rec.get(c) for c in columns}
                    if pkey:
                        ident = tuple(projected[c] for c in pkey)
                    else:
                        content = tuple(projected[c] for c in columns)
                        n = occurrence.get(content, 0)
                        occurrence[content] = n + 1
                        ident = (content, n)
                    rows[ident] = projected

                def engine_key(ident):
                    if pkey:
                        return None  # writer derives the key from pkey columns
                    content, n = ident
                    return int(ref_scalar("_delta_row", n, *map(str, content)))

                for ident, rec in rows.items():
                    if previous.get(ident) != rec:
                        writer.insert(rec, key=engine_key(ident))
                for ident, rec in previous.items():
                    if ident not in rows:
                        writer.remove(rec, key=engine_key(ident))
                previous = rows
                version = current
                if pers is not None:
                    pers.save_offsets(version)
            if mode == "static":
                return
            time.sleep(poll_interval_s)

    return register_source(
        schema,
        runner,
        mode=mode,
        name=name,
        upsert=schema.primary_key_columns() is not None,
        persistent_id=persistent_id,
    )


def write(table: Table, uri: str, *, min_commit_frequency=60_000, **kwargs) -> None:
    """Append the update stream (rows + time/diff) as Delta commits."""
    refuse_dropped("pw.io.deltalake.write", kwargs)
    if min_commit_frequency != 60_000:
        raise ValueError("pw.io.deltalake.write commits at every engine tick: min_commit_frequency is not supported "
                         "(the reference accepts and ignores it)")
    require("deltalake", "deltalake")
    import pyarrow as pa  # type: ignore
    from deltalake import write_deltalake  # type: ignore

    names = table.column_names
    buffer = []

    def on_change(key, row, time, is_addition):
        rec = {n: row[n] for n in names}
        rec["time"] = time
        rec["diff"] = 1 if is_addition else -1
        buffer.append(rec)

    def flush(ts=None):
        if not buffer:
            return
        batch = pa.Table.from_pylist(buffer)
        del buffer[:]
        write_deltalake(uri, batch, mode="append")

    subscribe(table, on_change=on_change, on_time_end=flush, on_end=flush)
