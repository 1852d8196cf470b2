"""pw.io.fs of the port — filesystem connector: csv / json(lines) /
plaintext / binary, static or streaming (directory watching)
(counterpart of ``pathway_tpu/io/fs``; reference: python/pathway/io/fs/
__init__.py:31-275, scanner src/connectors/scanner/filesystem.rs).

CSV is read with the standard library's ``csv`` module: the port's
native scanner (``native.csv_rows``) was slower than it on the card's
host in the whole smoke run (``PERF.md``, phase 27).  Offsets are
kept as the reference keeps them: ``{path: mtime}`` of fully ingested
files, committed through the session writer.  Under a persistence config
(``pw.run(persistence_config=...)`` or ``PATHWAY_PERSISTENT_STORAGE``)
they are the seek on restart: a file already ingested at the same mtime
is not read again (its rows come back from the input log), a new or
changed one is.

Under a process cluster each rank reads its own split of the files,
``crc32(basename) % processes`` (``_my_split``), and the engine routes
the rows to their key owners (source ``dist_mode="partitioned"``);
``write`` touches the file on rank 0 only."""

from __future__ import annotations

import csv as _csv
import glob as _glob
import io
import json as _json
import os
import time
from typing import Any, Dict, List, Optional, Type

from ...internals import dtype as dt
from ...internals.schema import Schema, schema_from_types
from ...internals.table import Table
from .._connector import SessionWriter, jsonable, register_source

__all__ = ["read", "write", "CsvParserSettings"]


class CsvParserSettings:
    """DSV parser settings (reference: io/_utils.py:125 CsvParserSettings —
    delimiter/quote/escape/comments for the general-DSV format)."""

    def __init__(
        self,
        delimiter: str = ",",
        quote: str = '"',
        escape: Optional[str] = None,
        enable_double_quote_escapes: bool = True,
        enable_quoting: bool = True,
        comment_character: Optional[str] = None,
    ):
        self.delimiter = delimiter
        self.quote = quote
        self.escape = escape
        self.enable_double_quote_escapes = enable_double_quote_escapes
        self.enable_quoting = enable_quoting
        self.comment_character = comment_character


def _expand(path: str) -> List[str]:
    if os.path.isdir(path):
        out = []
        for root, _dirs, files in os.walk(path):
            for f in sorted(files):
                out.append(os.path.join(root, f))
        return out
    return sorted(_glob.glob(path)) or ([path] if os.path.exists(path) else [])


def _my_split(files: List[str]) -> List[str]:
    """Multi-process runs: each rank owns a deterministic hash-split of the
    file set (the reference's parallel readers: only workers with index <
    parallel_readers read a connector, src/engine/dataflow.rs:3317; here
    EVERY rank reads ITS files and rows are exchanged to their key owner).

    Topology comes from the env: the graph is built, and its reader
    threads may start, before ``pw.run`` joins the cluster."""
    from ...parallel.distributed import topology_from_env

    nproc, rank, _addr = topology_from_env()
    if nproc <= 1:
        return files
    import zlib

    return [
        f
        for f in files
        if zlib.crc32(os.path.basename(f).encode()) % nproc == rank
    ]


def _parse_into(
    fpath: str,
    writer: SessionWriter,
    format: str,
    schema: Optional[Type[Schema]],
    with_metadata: bool = False,
    csv_settings=None,
) -> None:
    """Parse one local file into the session (shared by fs/s3/gdrive)."""
    columns = (
        [c for c in schema.columns().keys() if c != "_metadata"]
        if schema is not None
        else ["data"]
    )
    meta = None
    if with_metadata:
        st = os.stat(fpath)
        meta = {
            "path": fpath,
            "size": st.st_size,
            "modified_at": int(st.st_mtime),
            "created_at": int(st.st_ctime),
            "seen_at": int(time.time()),
        }

    # rows buffer into chunked bulk inserts (SessionWriter.insert_rows):
    # one session-lock acquisition per chunk, not per row
    _buf: List[Dict[str, Any]] = []

    def emit(values: Dict[str, Any]):
        if with_metadata:
            values = {**values, "_metadata": meta}
        _buf.append(values)
        if len(_buf) >= 8192:
            writer.insert_rows(_buf)
            _buf.clear()

    def flush():
        if _buf:
            writer.insert_rows(_buf)
            _buf.clear()

    emit_columns = None
    if not writer.track_value_deletions and not writer.session.upsert:
        if with_metadata:

            def emit_columns(cols, n):
                writer.insert_columns({**cols, "_metadata": [meta] * n}, n)

        else:

            def emit_columns(cols, n):
                writer.insert_columns(cols, n)

    try:
        _dispatch_format(
            fpath, format, columns, emit, csv_settings=csv_settings,
            emit_columns=emit_columns,
        )
    finally:
        # flush even when a malformed row raises mid-file, so every
        # successfully parsed row reaches the session (the pre-buffering
        # behavior); the exception still propagates to the caller
        flush()


def _dispatch_format(
    fpath, format, columns, emit, csv_settings=None, emit_columns=None
) -> None:

    if format == "csv" and csv_settings is not None:
        # general DSV: python csv module honouring the parser settings
        # (reference DsvParser, src/connectors/data_format.rs:500)
        with open(fpath, newline="") as f:
            reader = _csv.reader(
                f,
                delimiter=csv_settings.delimiter,
                quotechar=csv_settings.quote if csv_settings.enable_quoting else None,
                escapechar=csv_settings.escape,
                doublequote=csv_settings.enable_double_quote_escapes,
                quoting=_csv.QUOTE_MINIMAL
                if csv_settings.enable_quoting
                else _csv.QUOTE_NONE,
            )
            header = None
            comment = csv_settings.comment_character
            for row in reader:
                if not row or (comment and row[0].startswith(comment)):
                    continue
                if header is None:
                    header = row
                    idx = {
                        c: header.index(c) if c in header else None
                        for c in columns
                    }
                    continue
                emit(
                    {
                        c: (row[i] if i is not None and i < len(row) else None)
                        for c, i in idx.items()
                    }
                )
    elif format == "csv":
        with open(fpath, "rb") as f:
            text = f.read().decode("utf-8", errors="replace")
        rows = [row for row in _csv.reader(io.StringIO(text, newline="")) if row]
        if rows:
            header = rows[0]
            idx = {c: header.index(c) if c in header else None for c in columns}
            body = rows[1:]
            if emit_columns is not None and body:
                # columnar hand-off: whole columns to the session in one
                # event — no per-row dicts/tuples on the hot path
                emit_columns(
                    {
                        c: (
                            [
                                (row[i] if i < len(row) else None)
                                for row in body
                            ]
                            if i is not None
                            else [None] * len(body)
                        )
                        for c, i in idx.items()
                    },
                    len(body),
                )
            else:
                for row in body:
                    emit(
                        {
                            c: (row[i] if i is not None and i < len(row) else None)
                            for c, i in idx.items()
                        }
                    )
    elif format in ("json", "jsonlines"):
        with open(fpath) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = _json.loads(line)
                emit({c: obj.get(c) for c in columns})
    elif format in ("plaintext",):
        with open(fpath) as f:
            for line in f:
                emit({"data": line.rstrip("\n")})
    elif format == "plaintext_by_file":
        with open(fpath) as f:
            emit({"data": f.read()})
    elif format == "binary":
        with open(fpath, "rb") as f:
            emit({"data": f.read()})
    else:
        raise ValueError(f"unknown format {format!r}")


def _plaintext_schema():
    return schema_from_types(data=str)


def _binary_schema():
    return schema_from_types(data=bytes)


def read(
    path: str,
    *,
    format: str = "csv",
    schema: Optional[Type[Schema]] = None,
    mode: str = "streaming",
    csv_settings=None,
    json_field_paths=None,
    with_metadata: bool = False,
    autocommit_duration_ms: int = 100,
    name: str = "fs",
    poll_interval_s: float = 1.0,
    persistent_id: Optional[str] = None,
    **kwargs,
) -> Table:
    """Read files under ``path``.  ``mode="static"`` reads once;
    ``mode="streaming"`` keeps watching for new/modified files."""
    if format in ("plaintext", "plaintext_by_file"):
        schema = schema or _plaintext_schema()
    elif format == "binary":
        schema = schema or _binary_schema()
    elif schema is None:
        raise ValueError(f"schema is required for format={format!r}")
    if with_metadata:
        cols = dict(schema.columns())
        from ...internals.schema import ColumnSchema, _make_schema

        cols["_metadata"] = ColumnSchema(name="_metadata", dtype=dt.JSON)
        schema = _make_schema(schema.__name__ + "Meta", cols)

    columns = [c for c in schema.columns().keys() if c != "_metadata"]
    dtypes = schema.typehints()

    def parse_file(fpath: str, writer: SessionWriter):
        _parse_into(
            fpath,
            writer,
            format,
            schema,
            with_metadata=with_metadata,
            csv_settings=csv_settings,
        )

    # offsets for persistence = {path: mtime} of fully-ingested files; after
    # snapshot replay the runner seeks past them (reference seek semantics,
    # src/connectors/mod.rs ReadersQueryPurpose)
    if mode == "static":

        def runner(writer: SessionWriter):
            pers = writer.persistence
            seen: Dict[str, float] = dict((pers.offsets() or {}) if pers else {})
            for fpath in _my_split(_expand(path)):
                try:
                    mtime = os.path.getmtime(fpath)
                except OSError:
                    continue
                if seen.get(fpath) == mtime:
                    continue
                parse_file(fpath, writer)
                seen[fpath] = mtime
            writer.commit_offsets(seen)

        return register_source(
            schema,
            runner,
            mode="static",
            name=name,
            persistent_id=persistent_id,
            dist_mode="partitioned",
        )

    def runner(writer: SessionWriter):
        pers = writer.persistence
        seen: Dict[str, float] = dict((pers.offsets() or {}) if pers else {})
        while True:
            for fpath in _my_split(_expand(path)):
                try:
                    mtime = os.path.getmtime(fpath)
                except OSError:
                    continue
                if seen.get(fpath) == mtime:
                    continue
                # mark ingested only AFTER the parse completes, and hand the
                # persistence layer its own copy — a snapshot taken mid-parse
                # must not claim the file was fully read
                parse_file(fpath, writer)
                seen[fpath] = mtime
                writer.commit_offsets(seen)
            time.sleep(poll_interval_s)

    return register_source(
        schema,
        runner,
        mode="streaming",
        name=name,
        persistent_id=persistent_id,
        dist_mode="partitioned",
    )


def write(table: Table, filename: str, *, format: str = "csv", **kwargs) -> None:
    """Write the table's update stream to a file; csv/jsonlines rows carry
    ``time`` and ``diff`` columns (reference output format,
    src/connectors/data_format.rs DsvFormatter/JsonLinesFormatter).

    Multi-process runs: the sink's input edge gathers to rank 0, so ONLY
    rank 0 touches the file (exactly-once output); other ranks register the
    same operator (graph shapes must match across SPMD replicas) with no-op
    callbacks."""
    from ...parallel.distributed import topology_from_env
    from .._subscribe import subscribe

    processes, pid, _addr = topology_from_env()
    if processes > 1 and pid != 0:
        subscribe(table, on_change=None, on_time_end=None, on_end=None)
        return

    names = table.column_names
    f = open(filename, "w", newline="")
    state = {"writer": None}

    if format == "csv":
        w = _csv.writer(f)
        w.writerow(names + ["time", "diff"])

        def on_change(key, row, time, is_addition):
            w.writerow([row[n] for n in names] + [time, 1 if is_addition else -1])

    elif format in ("json", "jsonlines"):

        def on_change(key, row, time, is_addition):
            obj = {n: _jsonable(row[n]) for n in names}
            obj["time"] = time
            obj["diff"] = 1 if is_addition else -1
            f.write(_json.dumps(obj) + "\n")

    else:
        raise ValueError(f"unknown format {format!r}")

    def on_time_end(time):
        # flush once per commit tick: a crashed streaming job must not lose
        # rows of already-committed times to OS buffering (the recovery
        # contract, tests/test_recovery_e2e.py)
        f.flush()

    def on_end():
        f.flush()
        f.close()

    subscribe(table, on_change=on_change, on_time_end=on_time_end, on_end=on_end)


# shared JSON coercion lives in the connector runtime
_jsonable = jsonable
