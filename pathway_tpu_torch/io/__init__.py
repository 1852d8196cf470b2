"""``pw.io`` of the port (counterpart of ``pathway_tpu/io``).

Ported: ``python`` (``ConnectorSubject``, ``read``) and ``subscribe``,
over the shared connector runtime (``_connector.py``); the file
connectors ``fs`` (csv / json lines / plaintext / plaintext by file /
binary, static or streaming) with ``csv``, ``jsonlines`` and
``plaintext`` over it; ``http``, the REST connector on the standard
library's HTTP server; ``sqlite`` over the standard library's
``sqlite3``; ``null``, a sink that discards; and the connector bookkeeping (``_offsets.py``:
committed offset antichains and per-connector monitors, read by the
live-ingest runner, ``serve/ingest.py``, and the metrics server).  The
message-queue, database and cloud connectors (``kafka`` and 18 more) are a
later slice: each is a stub module whose names raise
``NotImplementedError`` naming it (``ROADMAP.md``, framework slice 3c)."""

from ..internals.unported import LaterSliceModule as _StubModule
from . import csv, fs, http, jsonlines, null, plaintext, python, sqlite
from ._offsets import ConnectorMonitor, OffsetAntichain
from ._subscribe import subscribe

_GATED = (
    "airbyte", "bigquery", "debezium", "deltalake", "elasticsearch", "gdrive", "kafka", "logstash", "minio",
    "mongodb", "nats", "postgres", "pubsub", "pyfilesystem", "redpanda", "s3", "s3_csv", "sharepoint", "slack",
)
globals().update({name: _StubModule(f"io.{name}", "3c", f"io/{name}") for name in _GATED})

__all__ = [
    "ConnectorMonitor",
    "OffsetAntichain",
    "csv",
    "fs",
    "http",
    "jsonlines",
    "null",
    "plaintext",
    "python",
    "sqlite",
    "subscribe",
    *_GATED,
]
