"""pw.io.sqlite of the port — SQLite connector over the standard
library's ``sqlite3`` (counterpart of ``pathway_tpu/io/sqlite``; reference: python/pathway/io/sqlite/__init__.py over SqliteReader,
src/connectors/data_storage.rs — snapshot reads of a table with rowid-based
change detection).

``read``: static mode loads the table once; streaming mode polls, treating
the table as an upsert stream keyed by the schema's primary key (or rowid) —
new/changed rows upsert, disappeared keys retract.
``write``: maintains a mirror table of the output stream.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from typing import Optional, Type

from ...internals.keys import ref_scalar
from ...internals.schema import Schema
from ...internals.table import Table
from .._connector import SessionWriter, register_source

__all__ = ["read", "write"]


def read(
    path: str,
    table_name: str,
    schema: Type[Schema],
    *,
    mode: str = "streaming",
    poll_interval_s: float = 0.2,
    name: str = "sqlite",
    persistent_id: Optional[str] = None,
) -> Table:
    columns = list(schema.columns().keys())
    pkey = schema.primary_key_columns()
    col_sql = ", ".join(columns)
    query = f"SELECT rowid, {col_sql} FROM {table_name}"  # noqa: S608 (local file db)

    def snapshot(conn):
        rows = {}
        for row in conn.execute(query):
            rowid, values = row[0], row[1:]
            rec = dict(zip(columns, values))
            if pkey:
                key = tuple(rec[c] for c in pkey)
            else:
                key = rowid
            rows[key] = rec
        return rows

    if mode == "static":

        def runner(writer: SessionWriter):
            conn = sqlite3.connect(path)
            try:
                for rec in snapshot(conn).values():
                    writer.insert(rec)
            finally:
                conn.close()

        return register_source(
            schema, runner, mode="static", name=name, upsert=bool(pkey),
            persistent_id=persistent_id,
        )

    def runner(writer: SessionWriter):
        conn = sqlite3.connect(path)
        previous = {}

        def engine_key(ident):
            # without a primary key, rowid is the stable row identity —
            # derive the engine key from it so updates retract the right row
            if pkey:
                return None  # writer derives the key from the pkey columns
            return int(ref_scalar("_sqlite_rowid", ident))

        try:
            while True:
                current = snapshot(conn)
                for ident, rec in current.items():
                    if previous.get(ident) != rec:
                        writer.insert(rec, key=engine_key(ident))
                for ident, rec in previous.items():
                    if ident not in current:
                        writer.remove(rec, key=engine_key(ident))
                previous = current
                time.sleep(poll_interval_s)
        finally:
            conn.close()

    return register_source(
        schema, runner, mode="streaming", name=name, upsert=True,
        persistent_id=persistent_id,
    )


def write(table: Table, path: str, table_name: str) -> None:
    """Mirror the table's update stream into a SQLite table (insert on +1,
    delete on -1; the mirror converges to the live table contents)."""
    from .._subscribe import subscribe

    names = table.column_names
    cols_sql = ", ".join(f'"{c}"' for c in names)
    qmarks = ", ".join("?" for _ in names)
    lock = threading.Lock()
    conn = sqlite3.connect(path, check_same_thread=False)
    conn.execute(
        f'CREATE TABLE IF NOT EXISTS "{table_name}" '
        f"({cols_sql}, _pw_key INTEGER)"
    )
    conn.commit()

    def on_change(key, row, time, is_addition):
        skey = int(key) - (1 << 63)  # sqlite INTEGER is signed 64-bit
        with lock:
            if is_addition:
                conn.execute(
                    f'INSERT INTO "{table_name}" ({cols_sql}, _pw_key) '
                    f"VALUES ({qmarks}, ?)",
                    [_sqlite_value(row[c]) for c in names] + [skey],
                )
            else:
                conn.execute(
                    f'DELETE FROM "{table_name}" WHERE _pw_key = ?', (skey,)
                )

    def on_time_end(ts):
        with lock:
            conn.commit()

    def on_end():
        with lock:
            conn.commit()
            conn.close()

    subscribe(table, on_change=on_change, on_time_end=on_time_end, on_end=on_end)


def _sqlite_value(v):
    import numpy as np

    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_, bool)):
        return int(v)
    if isinstance(v, np.ndarray):
        return v.tobytes()
    return v
