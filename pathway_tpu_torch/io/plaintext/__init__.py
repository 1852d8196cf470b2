"""pw.io.plaintext of the port (counterpart of ``pathway_tpu/io/plaintext``;
reference: python/pathway/io/plaintext)."""

from __future__ import annotations

from ...internals.table import Table
from .. import fs as _fs

__all__ = ["read"]


def read(path: str, *, mode: str = "streaming", **kwargs) -> Table:
    return _fs.read(path, format="plaintext", mode=mode, **kwargs)
