"""Connector bookkeeping of the port (counterpart of the reference's
``pathway_tpu/io/_offsets.py``): committed offset antichains and
per-connector monitors, read by the live-ingest runner
(``serve/ingest.py``).  The reference's connectors are not ported."""

from ._offsets import ConnectorMonitor, OffsetAntichain

__all__ = ["ConnectorMonitor", "OffsetAntichain"]
