"""pw.io.postgres — PostgreSQL output connector (counterpart of
``pathway_tpu/io/postgres``; reference: python/pathway/io/postgres/__init__.py over PsqlWriter +
snapshot/updates formatters, src/connectors/data_format.rs PsqlUpdatesFormatter
/ PsqlSnapshotFormatter).  Gated on psycopg2/psycopg.  Keyword arguments the reference takes and never reads raise.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from ...internals.table import Table
from .._connector import refuse_dropped
from .._subscribe import subscribe

__all__ = ["write", "write_snapshot"]


def _connect(postgres_settings: Dict):
    try:
        import psycopg2  # type: ignore

        return psycopg2.connect(**postgres_settings)
    except ImportError:
        pass
    try:
        import psycopg  # type: ignore

        return psycopg.connect(**postgres_settings)
    except ImportError as e:
        raise ImportError(
            "pw.io.postgres requires psycopg2 or psycopg (not installed)"
        ) from e


def write(table: Table, postgres_settings: Dict, table_name: str, **kwargs) -> None:
    """Append the update stream: every change becomes an INSERT carrying
    time/diff columns (reference PsqlUpdatesFormatter)."""
    refuse_dropped("pw.io.postgres.write", kwargs)
    conn = _connect(postgres_settings)
    names = table.column_names
    cols = ", ".join(names + ["time", "diff"])
    ph = ", ".join(["%s"] * (len(names) + 2))
    cur = conn.cursor()

    def on_change(key, row, time, is_addition):
        cur.execute(
            f"INSERT INTO {table_name} ({cols}) VALUES ({ph})",  # noqa: S608
            [row[n] for n in names] + [time, 1 if is_addition else -1],
        )

    def on_time_end(ts):
        conn.commit()

    subscribe(table, on_change=on_change, on_time_end=on_time_end,
              on_end=lambda: (conn.commit(), conn.close()))


def write_snapshot(
    table: Table,
    postgres_settings: Dict,
    table_name: str,
    primary_key: Sequence[str],
    **kwargs,
) -> None:
    """Maintain a snapshot: upsert on insertion, delete on retraction
    (reference PsqlSnapshotFormatter)."""
    refuse_dropped("pw.io.postgres.write_snapshot", kwargs)
    conn = _connect(postgres_settings)
    names = table.column_names
    cols = ", ".join(names)
    ph = ", ".join(["%s"] * len(names))
    keycond = " AND ".join(f"{c} = %s" for c in primary_key)
    updates = ", ".join(f"{c} = EXCLUDED.{c}" for c in names if c not in primary_key)
    pk = ", ".join(primary_key)
    cur = conn.cursor()

    def on_change(key, row, time, is_addition):
        if is_addition:
            cur.execute(
                f"INSERT INTO {table_name} ({cols}) VALUES ({ph}) "  # noqa: S608
                f"ON CONFLICT ({pk}) DO UPDATE SET {updates}",
                [row[n] for n in names],
            )
        else:
            cur.execute(
                f"DELETE FROM {table_name} WHERE {keycond}",  # noqa: S608
                [row[c] for c in primary_key],
            )

    subscribe(table, on_change=on_change,
              on_time_end=lambda ts: conn.commit(),
              on_end=lambda: (conn.commit(), conn.close()))
