"""pw.io.mongodb — MongoDB output connector (counterpart of
``pathway_tpu/io/mongodb``; reference: python/pathway/io/mongodb/__init__.py over MongoWriter,
src/connectors/data_storage.rs).  Gated on pymongo.  Keyword arguments the reference takes and never reads raise.
"""

from __future__ import annotations

from ...internals.table import Table
from .._connector import refuse_dropped
from .._gated import require
from .._subscribe import subscribe

__all__ = ["write"]


def write(
    table: Table,
    connection_string: str,
    database: str,
    collection: str,
    *,
    max_batch_size: int = 1000,
    **kwargs,
) -> None:
    refuse_dropped("pw.io.mongodb.write", kwargs)
    pymongo = require("pymongo", "mongodb")
    client = pymongo.MongoClient(connection_string)
    coll = client[database][collection]
    names = table.column_names
    buffer = []

    def on_change(key, row, time, is_addition):
        doc = {n: row[n] for n in names}
        doc["_pw_key"] = str(int(key))
        doc["time"] = time
        doc["diff"] = 1 if is_addition else -1
        buffer.append(doc)
        if len(buffer) >= max_batch_size:
            coll.insert_many(buffer)
            del buffer[:]

    def flush(ts=None):
        if buffer:
            coll.insert_many(buffer)
            del buffer[:]

    subscribe(table, on_change=on_change, on_time_end=flush, on_end=flush)
