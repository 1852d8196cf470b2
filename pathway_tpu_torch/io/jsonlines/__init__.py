"""pw.io.jsonlines of the port (counterpart of ``pathway_tpu/io/jsonlines``;
reference: python/pathway/io/jsonlines)."""

from __future__ import annotations

from typing import Optional, Type

from ...internals.schema import Schema
from ...internals.table import Table
from .. import fs as _fs

__all__ = ["read", "write"]


def read(
    path: str,
    *,
    schema: Optional[Type[Schema]] = None,
    mode: str = "streaming",
    **kwargs,
) -> Table:
    return _fs.read(path, format="jsonlines", schema=schema, mode=mode, **kwargs)


def write(table: Table, filename: str, **kwargs) -> None:
    _fs.write(table, filename, format="jsonlines", **kwargs)
