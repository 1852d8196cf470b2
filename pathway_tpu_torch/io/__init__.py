"""``pw.io`` of the port (counterpart of ``pathway_tpu/io``).

Ported: ``python`` (``ConnectorSubject``, ``read``) and ``subscribe``,
over the shared connector runtime (``_connector.py``), and the connector
bookkeeping (``_offsets.py``: committed offset antichains and
per-connector monitors, read by the live-ingest runner,
``serve/ingest.py``).  The file, csv and jsonlines connectors and the
REST connector are later slices (``ROADMAP.md``)."""

from . import python
from ._offsets import ConnectorMonitor, OffsetAntichain
from ._subscribe import subscribe

__all__ = ["ConnectorMonitor", "OffsetAntichain", "python", "subscribe"]
