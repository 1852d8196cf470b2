"""pw.io.nats — NATS connector (counterpart of ``pathway_tpu/io/nats``;
reference: python/pathway/io/nats/__init__.py over NatsReader/NatsWriter,
src/connectors/data_storage.rs).  Gated on nats-py.  ``write(format=...)``
other than json and keyword arguments the reference takes and never
reads raise.
"""

from __future__ import annotations

import json
from typing import Optional, Type

from ...internals.schema import Schema, schema_from_types
from ...internals.table import Table
from .._connector import SessionWriter, refuse_dropped, register_source
from .._gated import require
from .._subscribe import subscribe

__all__ = ["read", "write"]


def read(
    uri: str,
    topic: str,
    *,
    schema: Optional[Type[Schema]] = None,
    format: str = "json",
    name: str = "nats",
    persistent_id: Optional[str] = None,
    **kwargs,
) -> Table:
    refuse_dropped("pw.io.nats.read", kwargs)
    require("nats", "nats")
    if format in ("plaintext", "raw"):
        schema = schema or schema_from_types(
            data=(str if format == "plaintext" else bytes)
        )
    elif schema is None:
        raise ValueError("schema is required for json format")
    columns = list(schema.columns().keys())

    def runner(writer: SessionWriter):
        import asyncio

        import nats  # type: ignore

        async def consume():
            nc = await nats.connect(uri)
            sub = await nc.subscribe(topic)
            async for msg in sub.messages:
                raw = msg.data
                if format == "raw":
                    writer.insert({"data": raw})
                elif format == "plaintext":
                    writer.insert({"data": raw.decode(errors="replace")})
                else:
                    try:
                        obj = json.loads(raw)
                    except ValueError:
                        continue
                    writer.insert({c: obj.get(c) for c in columns})

        asyncio.run(consume())

    return register_source(
        schema, runner, mode="streaming", name=name, persistent_id=persistent_id
    )


def write(table: Table, uri: str, topic: str, *, format: str = "json", **kwargs) -> None:
    refuse_dropped("pw.io.nats.write", kwargs)
    if format != "json":
        raise ValueError(f"pw.io.nats.write: format={format!r} is not supported (json only; the reference writes "
                         "json whatever the format)")
    require("nats", "nats")
    import asyncio
    import threading

    import nats  # type: ignore

    names = table.column_names
    loop = asyncio.new_event_loop()
    ready = threading.Event()
    state = {}

    def loop_main():
        asyncio.set_event_loop(loop)

        async def setup():
            state["nc"] = await nats.connect(uri)
            ready.set()

        loop.run_until_complete(setup())
        loop.run_forever()

    threading.Thread(target=loop_main, daemon=True).start()
    if not ready.wait(10):
        raise ConnectionError(f"could not connect to NATS at {uri!r} within 10s")

    def on_change(key, row, time, is_addition):
        obj = {n: _plain(row[n]) for n in names}
        obj["time"] = time
        obj["diff"] = 1 if is_addition else -1
        payload = json.dumps(obj).encode()
        asyncio.run_coroutine_threadsafe(
            state["nc"].publish(topic, payload), loop
        ).result()

    subscribe(table, on_change=on_change)


from .._connector import jsonable as _plain  # noqa: E402
