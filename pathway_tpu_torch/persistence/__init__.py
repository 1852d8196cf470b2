"""Persistence of the port (counterpart of ``pathway_tpu/persistence``;
reference surface: python/pathway/persistence/__init__.py:13-88, the
Backend / Config classes over src/persistence/).

- ``Backend`` / ``Config`` / ``PersistenceMode`` / ``SnapshotAccess``:
  what ``pw.run(persistence_config=...)`` takes; the engine side is
  ``engine_state.py`` (input logs, source offsets, operator snapshots).
- ``CachedObjectStorage`` (``object_cache.py``): versioned blobs of
  re-computable objects.
- Storage: CRC-framed chunks (``framing.py``) in key -> blob stores
  (``backends.py``), also written and read by ``serve/warmstate.py``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

from .backends import FileBackend, MemoryBackend, PersistenceBackend, S3Backend
from .framing import frame, frame_all, scan, scan_views
from .object_cache import CachedObjectStorage

__all__ = [
    "Backend",
    "CachedObjectStorage",
    "Config",
    "FileBackend",
    "MemoryBackend",
    "PersistenceBackend",
    "PersistenceMode",
    "S3Backend",
    "SnapshotAccess",
    "frame",
    "frame_all",
    "scan",
    "scan_views",
]


class PersistenceMode(enum.Enum):
    """(reference: engine.pyi:777-787)"""

    BATCH = "batch"
    PERSISTING = "persisting"
    OPERATOR_PERSISTING = "operator_persisting"
    SPEEDRUN_REPLAY = "speedrun_replay"
    REALTIME_REPLAY = "realtime_replay"


class SnapshotAccess(enum.Enum):
    RECORD = "record"
    REPLAY = "replay"
    FULL = "full"
    OFFSETS_ONLY = "offsets_only"


@dataclass
class Backend:
    """Storage backend for snapshots (reference: persistence/__init__.py:13)."""

    kind: str
    path: Optional[str] = None
    bucket: Optional[str] = None

    @classmethod
    def filesystem(cls, path: str) -> "Backend":
        return cls(kind="filesystem", path=path)

    @classmethod
    def s3(cls, root_path: str, bucket_settings=None) -> "Backend":
        return cls(kind="s3", path=root_path)

    @classmethod
    def mock(cls) -> "Backend":
        return cls(kind="mock")

    _mock_instance = None

    def make_store(self) -> PersistenceBackend:
        if self.kind == "filesystem":
            return FileBackend(self.path)
        if self.kind == "mock":
            # one shared in-memory store per Backend object, so successive
            # runs against the same Backend see earlier snapshots (tests)
            if self._mock_instance is None:
                self._mock_instance = MemoryBackend()
            return self._mock_instance
        if self.kind == "s3":
            return S3Backend(bucket=self.bucket or "", root_path=self.path or "")
        raise ValueError(self.kind)


@dataclass
class Config:
    """(reference: persistence/__init__.py:88 Config.simple_config)"""

    backend: Optional[Backend] = None
    snapshot_interval_ms: int = 60000
    persistence_mode: PersistenceMode = PersistenceMode.PERSISTING
    snapshot_access: SnapshotAccess = SnapshotAccess.FULL
    continue_after_replay: bool = True

    @classmethod
    def simple_config(cls, backend: Backend, **kwargs) -> "Config":
        return cls(backend=backend, **kwargs)
