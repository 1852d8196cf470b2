"""pw.io.csv of the port (counterpart of ``pathway_tpu/io/csv``;
reference: python/pathway/io/csv/__init__.py → io/fs)."""

from __future__ import annotations

from typing import Optional, Type

from ...internals.schema import Schema
from ...internals.table import Table
from .. import fs as _fs

# re-export the DSV settings next to the reader, like the reference
from ..fs import CsvParserSettings  # noqa: F401

__all__ = ["read", "write", "CsvParserSettings"]


def read(
    path: str,
    *,
    schema: Optional[Type[Schema]] = None,
    mode: str = "streaming",
    **kwargs,
) -> Table:
    return _fs.read(path, format="csv", schema=schema, mode=mode, **kwargs)


def write(table: Table, filename: str, **kwargs) -> None:
    _fs.write(table, filename, format="csv", **kwargs)
