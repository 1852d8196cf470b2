"""``pw.io`` of the port (counterpart of ``pathway_tpu/io``).

Over the shared connector runtime (``_connector.py``): ``python``
(``ConnectorSubject``, ``read``) and ``subscribe``; the file connectors
``fs`` (csv / json lines / plaintext / plaintext by file / binary, static
or streaming) with ``csv``, ``jsonlines`` and ``plaintext`` over it;
``http``, the REST connector on the standard library's HTTP server;
``sqlite`` over the standard library's ``sqlite3``; ``null``, a sink that
discards; and the connector bookkeeping (``_offsets.py``: committed offset
antichains and per-connector monitors, read by the live-ingest runner,
``serve/ingest.py``, and the metrics server).

The message-queue, database and cloud connectors parse and format locally
and need a client library only for the transport, imported when a
connector is called (``_gated.py``; without it the call raises
``ImportError`` naming the package): ``kafka`` with ``redpanda`` and
``debezium`` over it, ``s3`` with ``s3_csv`` and ``minio``, ``deltalake``,
``postgres``, ``mongodb``, ``bigquery``, ``nats``, ``pubsub``, ``gdrive``,
``sharepoint``, ``pyfilesystem``; ``elasticsearch``, ``logstash`` and
``slack`` over ``requests``; ``airbyte`` runs a source process and reads
the Airbyte protocol from its output."""

from . import (
    airbyte,
    bigquery,
    csv,
    debezium,
    deltalake,
    elasticsearch,
    fs,
    gdrive,
    http,
    jsonlines,
    kafka,
    logstash,
    minio,
    mongodb,
    nats,
    null,
    plaintext,
    postgres,
    pubsub,
    pyfilesystem,
    python,
    redpanda,
    s3,
    s3_csv,
    sharepoint,
    slack,
    sqlite,
)
from ._offsets import ConnectorMonitor, OffsetAntichain
from ._subscribe import subscribe

__all__ = [
    "ConnectorMonitor",
    "OffsetAntichain",
    "airbyte",
    "bigquery",
    "csv",
    "debezium",
    "deltalake",
    "elasticsearch",
    "fs",
    "gdrive",
    "http",
    "jsonlines",
    "kafka",
    "logstash",
    "minio",
    "mongodb",
    "nats",
    "null",
    "plaintext",
    "postgres",
    "pubsub",
    "pyfilesystem",
    "python",
    "redpanda",
    "s3",
    "s3_csv",
    "sharepoint",
    "slack",
    "sqlite",
    "subscribe",
]
