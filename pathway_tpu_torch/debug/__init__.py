"""Debug helpers: static tables and synchronous computation
(reference: python/pathway/debug/__init__.py:207-496 — table_from_markdown /
table_from_pandas / compute_and_print / compute_and_print_update_stream)."""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Type

import numpy as np

from ..engine.graph import OutputCallbacks
from ..engine.operators.io import SubscribeOperator
from ..internals import dtype as dt
from ..internals.keys import Pointer, ref_scalar, sequential_keys
from ..internals.parse_graph import G
from ..internals.run import run as _run
from ..internals.schema import Schema, schema_from_types
from ..internals.table import Table

__all__ = [
    "table_from_rows",
    "table_from_markdown",
    "table_from_pandas",
    "table_to_pandas",
    "table_to_dicts",
    "compute_and_print",
    "compute_and_print_update_stream",
    "parse_to_table",
    "StreamGenerator",
]


def table_from_rows(
    schema: Type[Schema],
    rows: Sequence[Tuple],
    unsafe_trusted_ids: bool = False,
    is_stream: bool = False,
) -> Table:
    names = list(schema.columns().keys())
    dict_rows = [dict(zip(names, row)) for row in rows]
    return Table.from_rows(dict_rows, schema, name="debug_rows")


def _parse_value(text: str) -> Any:
    text = text.strip()
    if text in ("", "None"):
        return None
    if text in ("True", "true"):
        return True
    if text in ("False", "false"):
        return False
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    return text


def _parse_markdown_rows(txt: str) -> Tuple[List[Dict[str, Any]], Optional[List[int]]]:
    """Shared markdown grammar: returns (rows, explicit_keys_or_None).

    First unnamed column (before the first ``|``) is the row id if present."""
    lines = [l for l in txt.strip().splitlines() if l.strip()]
    header = lines[0]
    has_id = header.lstrip().startswith("|")
    col_names = [c.strip() for c in header.split("|") if c.strip()]
    rows: List[Dict[str, Any]] = []
    explicit_keys: List[int] = []
    for line in lines[1:]:
        if re.match(r"^[\s|:-]+$", line):
            continue
        parts = line.split("|")
        if has_id:
            id_part = parts[0].strip()
            values = parts[1:]
            if id_part:
                explicit_keys.append(int(ref_scalar(int(id_part))))
        else:
            values = parts
        vals = [_parse_value(v) for v in values[: len(col_names)]]
        while len(vals) < len(col_names):
            vals.append(None)
        rows.append(dict(zip(col_names, vals)))
    keys = explicit_keys if has_id and len(explicit_keys) == len(rows) else None
    return rows, keys


def table_from_markdown(
    txt: str,
    *,
    schema: Optional[Type[Schema]] = None,
    unsafe_trusted_ids: bool = False,
    **kwargs,
) -> Table:
    """Parse a markdown-ish table (reference: debug/__init__.py:429)."""
    rows, keys = _parse_markdown_rows(txt)
    return Table.from_rows(rows, schema, keys=keys, name="markdown")


# reference alias
parse_to_table = table_from_markdown


def table_from_pandas(
    df,
    *,
    schema: Optional[Type[Schema]] = None,
    unsafe_trusted_ids: bool = False,
    **kwargs,
) -> Table:
    rows = df.to_dict("records")
    keys = None
    try:
        if df.index.dtype.kind in "iu":
            keys = [int(ref_scalar(int(i))) for i in df.index]
    except Exception:
        keys = None
    return Table.from_rows(rows, schema, keys=keys, name="pandas")


def _ensure_ran():
    _run(monitoring_level=None)


def table_to_dicts(table: Table):
    _ensure_ran()
    keys, columns = table._materialize()
    return [Pointer(k) for k in keys], {
        name: {Pointer(k): col[i] for i, k in enumerate(keys)}
        for name, col in columns.items()
    }


def table_to_pandas(table: Table, include_id: bool = True):
    import pandas as pd

    _ensure_ran()
    keys, columns = table._materialize()
    df = pd.DataFrame({name: list(col) for name, col in columns.items()})
    if include_id:
        df.index = [Pointer(k) for k in keys]
    return df


def compute_and_print(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: Optional[int] = None,
    **kwargs,
) -> None:
    _ensure_ran()
    keys, columns = table._materialize()
    names = list(columns.keys())
    order = np.argsort(keys)
    header = (["id"] if include_id else []) + names
    rows = []
    for i in order[: n_rows if n_rows is not None else len(order)]:
        row = []
        if include_id:
            p = Pointer(int(keys[i]))
            row.append(f"^{int(p) % 0xFFFFFF:X}" if short_pointers else repr(p))
        row.extend(str(columns[c][i]) for c in names)
        rows.append(row)
    widths = [
        max(len(header[c]), *(len(r[c]) for r in rows)) if rows else len(header[c])
        for c in range(len(header))
    ]
    print(" | ".join(h.ljust(w) for h, w in zip(header, widths)))
    for r in rows:
        print(" | ".join(v.ljust(w) for v, w in zip(r, widths)))


class StreamGenerator:
    """Builds artificial streams with controlled batch boundaries for tests
    (reference: debug/__init__.py:496 StreamGenerator — snapshot-event
    replay per worker).  The port's engine runs in one process, so per-worker
    splits collapse into batch order; each batch is sealed atomically
    (``subject.commit()`` → InputSession.mark_batch) and gets its own commit
    tick structurally — no timing dependence."""

    def table_from_list_of_batches(
        self, batches: Sequence[Sequence[Mapping[str, Any]]], schema: Type[Schema]
    ) -> Table:
        from ..io.python import ConnectorSubject, read

        class _Gen(ConnectorSubject):
            def run(self) -> None:
                for batch in batches:
                    for row in batch:
                        self.next(**row)
                    self.commit()

        return read(
            _Gen(),
            schema=schema,
            name="debug.stream-generator",
            atomic_batches=True,
        )

    def table_from_list_of_batches_by_workers(
        self,
        batches: Sequence[Mapping[int, Sequence[Mapping[str, Any]]]],
        schema: Type[Schema],
    ) -> Table:
        flattened = [
            [row for worker in sorted(batch) for row in batch[worker]]
            for batch in batches
        ]
        return self.table_from_list_of_batches(flattened, schema)

    def table_from_pandas(
        self, df, *, schema: Optional[Type[Schema]] = None, **kwargs
    ) -> Table:
        """``_time`` column splits rows into batches; ``_diff`` of -1 emits a
        deletion; ``_worker`` is accepted and ignored (single-host)."""
        from ..io.python import ConnectorSubject, read

        records = df.to_dict("records")
        value_cols = [
            c for c in df.columns if c not in ("_time", "_diff", "_worker")
        ]
        if schema is None:
            sample = records[0] if records else {}
            schema = schema_from_types(
                **{c: type(sample.get(c, "")) for c in value_cols}
            )
        def time_of(rec) -> int:
            t = rec.get("_time", 2)
            try:
                import math

                if t is None or (isinstance(t, float) and math.isnan(t)):
                    return 2
            except TypeError:
                pass
            return int(t)

        by_time: Dict[int, List[Mapping[str, Any]]] = {}
        for rec in records:
            by_time.setdefault(time_of(rec), []).append(rec)

        class _Gen(ConnectorSubject):
            def run(self) -> None:
                for t in sorted(by_time):
                    for rec in by_time[t]:
                        values = {c: rec[c] for c in value_cols}
                        if int(rec.get("_diff", 1)) >= 0:
                            self.next(**values)
                        else:
                            self.delete(**values)
                    self.commit()

        return read(
            _Gen(),
            schema=schema,
            name="debug.stream-generator",
            atomic_batches=True,
        )

    def table_from_markdown(self, table: str, **kwargs) -> Table:
        """Markdown rows with optional ``_time``/``_diff`` columns become a
        stream with those batch boundaries (same grammar as the module-level
        ``table_from_markdown``)."""
        import pandas as pd

        rows, _keys = _parse_markdown_rows(table)
        return self.table_from_pandas(pd.DataFrame(rows), **kwargs)


def compute_and_print_update_stream(table: Table, **kwargs) -> None:
    events: List[Tuple[int, int, Tuple]] = []

    def on_change(key, row, time, diff):
        events.append((time, diff, row))

    op = SubscribeOperator(
        table._engine_table, OutputCallbacks(on_change=on_change), name="debug_stream"
    )
    G.engine_graph.add_operator(op)
    _ensure_ran()
    names = table.column_names
    print("time | diff | " + " | ".join(names))
    for time, diff, row in events:
        print(f"{time} | {diff:+d} | " + " | ".join(str(v) for v in row))
