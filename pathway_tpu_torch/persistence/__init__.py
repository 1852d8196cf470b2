"""Durable snapshot storage of the port (counterpart of the reference's
``pathway_tpu/persistence`` framing and backends): CRC-framed chunks
(``framing.py``) in key -> blob stores (``backends.py``), written and
read by ``serve/warmstate.py``."""

from .backends import FileBackend, MemoryBackend, PersistenceBackend
from .framing import frame, frame_all, scan, scan_views

__all__ = ["FileBackend", "MemoryBackend", "PersistenceBackend", "frame", "frame_all", "scan", "scan_views"]
