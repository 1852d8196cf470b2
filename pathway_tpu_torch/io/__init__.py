"""``pw.io`` of the port (counterpart of ``pathway_tpu/io``).

Ported: ``python`` (``ConnectorSubject``, ``read``) and ``subscribe``,
over the shared connector runtime (``_connector.py``); the file
connectors ``fs`` (csv / json lines / plaintext / plaintext by file /
binary, static or streaming) with ``csv``, ``jsonlines`` and
``plaintext`` over it; ``http``, the REST connector on the standard
library's HTTP server; and the connector bookkeeping (``_offsets.py``:
committed offset antichains and per-connector monitors, read by the
live-ingest runner, ``serve/ingest.py``, and the metrics server).  The
message-queue, database and cloud connectors need client packages the
card's machine does not have."""

from . import csv, fs, http, jsonlines, plaintext, python
from ._offsets import ConnectorMonitor, OffsetAntichain
from ._subscribe import subscribe

__all__ = [
    "ConnectorMonitor",
    "OffsetAntichain",
    "csv",
    "fs",
    "http",
    "jsonlines",
    "plaintext",
    "python",
    "subscribe",
]
