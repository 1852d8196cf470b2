"""Snapshot storage backends: key -> blob stores (counterpart of
``pathway_tpu/persistence/backends.py``).

Keys are slash-separated paths, values opaque bytes.  ``FileBackend``
writes a temporary file and renames it over the key, so a crash
mid-write never corrupts an earlier blob; ``MemoryBackend`` is the
in-process store the tests share between a writer and a replica.  The
reference's S3 backend (it needs ``boto3``) is not ported.
``get_view`` is the read a restore uses: ``FileBackend`` maps the file
read-only instead of copying it into a ``bytes``.
"""

from __future__ import annotations

import mmap
import os
import threading
from typing import Dict, List, Optional

__all__ = ["FileBackend", "MemoryBackend", "PersistenceBackend"]


class PersistenceBackend:
    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def get_view(self, key: str) -> Optional[memoryview]:
        """The blob at ``key`` as a read-only buffer, or None."""
        blob = self.get(key)
        return None if blob is None else memoryview(blob)

    def put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list_keys(self, prefix: str = "") -> List[str]:
        raise NotImplementedError


class FileBackend(PersistenceBackend):
    """Blobs as files under ``root``; a key may not escape it."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        path = os.path.normpath(os.path.join(self.root, key))
        if path != self.root and not path.startswith(self.root + os.sep):
            raise ValueError(f"key escapes storage root: {key!r}")
        return path

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def get_view(self, key: str) -> Optional[memoryview]:
        """The file mapped read-only: no copy of the blob (a put replaces
        the file by a rename, so the mapping keeps the blob it opened)."""
        try:
            with open(self._path(key), "rb") as f:
                if os.fstat(f.fileno()).st_size == 0:
                    return memoryview(b"")
                return memoryview(mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ))
        except FileNotFoundError:
            return None

    def put(self, key: str, value: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(value)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def list_keys(self, prefix: str = "") -> List[str]:
        out = []
        for root, _dirs, files in os.walk(self.root):
            for f in files:
                if f.endswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(root, f), self.root).replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)


class MemoryBackend(PersistenceBackend):
    """An in-process dict of blobs, shared by passing the instance."""

    def __init__(self):
        self._data: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._data.get(key)

    def put(self, key: str, value: bytes) -> None:
        with self._lock:
            self._data[key] = value

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def list_keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))
