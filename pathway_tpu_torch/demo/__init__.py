"""Synthetic demo streams of the port (counterpart of
``pathway_tpu/demo``; reference: python/pathway/demo/__init__.py:28-258 —
range_stream, noisy_linear_stream, generate_custom_stream,
replay_csv[_with_time]).  Each takes ``persistent_id``: under a
persistence config the stream's rows are recorded and replayed on a
restart, as a file connector's are."""

from __future__ import annotations

import csv as _csv
import threading
import time
from typing import Any, Callable, Dict, Mapping, Optional, Type

from ..internals import dtype as dt
from ..internals.schema import Schema, schema_from_types
from ..internals.table import Table

__all__ = [
    "generate_custom_stream",
    "range_stream",
    "noisy_linear_stream",
    "replay_csv",
    "replay_csv_with_time",
]


def generate_custom_stream(
    value_generators: Mapping[str, Callable[[int], Any]],
    *,
    schema: Type[Schema],
    nb_rows: Optional[int] = None,
    input_rate: float = 1.0,
    autocommit_duration_ms: int = 100,
    persistent_id: Optional[str] = None,
) -> Table:
    """Stream rows produced by per-column generators at ``input_rate`` rows/s
    (reference: demo/__init__.py:28)."""
    from ..io.python import ConnectorSubject, read

    class _GenSubject(ConnectorSubject):
        def run(self):
            i = 0
            while nb_rows is None or i < nb_rows:
                row = {name: gen(i) for name, gen in value_generators.items()}
                self.next(**row)
                i += 1
                if input_rate > 0:
                    time.sleep(1.0 / input_rate)

    return read(_GenSubject(), schema=schema, autocommit_duration_ms=autocommit_duration_ms,
                persistent_id=persistent_id)


def range_stream(
    nb_rows: Optional[int] = None,
    offset: int = 0,
    input_rate: float = 1.0,
    **kwargs,
) -> Table:
    return generate_custom_stream(
        {"value": lambda i: i + offset},
        schema=schema_from_types(value=int),
        nb_rows=nb_rows,
        input_rate=input_rate,
        **kwargs,
    )


def noisy_linear_stream(nb_rows: int = 10, input_rate: float = 1.0, **kwargs) -> Table:
    import random

    return generate_custom_stream(
        {"x": lambda i: float(i), "y": lambda i: float(i) + random.uniform(-1, 1)},
        schema=schema_from_types(x=float, y=float),
        nb_rows=nb_rows,
        input_rate=input_rate,
        **kwargs,
    )


def replay_csv(
    path: str,
    *,
    schema: Type[Schema],
    input_rate: float = 1.0,
    persistent_id: Optional[str] = None,
) -> Table:
    """Replay a CSV file as a stream (reference: demo/__init__.py:212)."""
    from ..io.python import ConnectorSubject, read

    columns = list(schema.columns().keys())
    dtypes = schema.typehints()

    class _ReplaySubject(ConnectorSubject):
        def run(self):
            with open(path, newline="") as f:
                for row in _csv.DictReader(f):
                    out = {}
                    for c in columns:
                        v = row.get(c)
                        t = dt.unoptionalize(dtypes.get(c, dt.ANY))
                        if v is not None:
                            if t is dt.INT:
                                v = int(v)
                            elif t is dt.FLOAT:
                                v = float(v)
                            elif t is dt.BOOL:
                                v = v.lower() in ("1", "true", "yes")

                        out[c] = v
                    self.next(**out)
                    if input_rate > 0:
                        time.sleep(1.0 / input_rate)

    return read(_ReplaySubject(), schema=schema, persistent_id=persistent_id)


def replay_csv_with_time(
    path: str,
    *,
    schema: Type[Schema],
    time_column: str,
    unit: str = "s",
    autocommit_ms: int = 100,
    speedup: float = 1,
    persistent_id: Optional[str] = None,
) -> Table:
    """Replay respecting inter-row gaps in ``time_column``
    (reference: demo/__init__.py:258)."""
    from ..io.python import ConnectorSubject, read

    columns = list(schema.columns().keys())
    dtypes = schema.typehints()
    mul = {"s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}[unit]

    class _ReplayTimeSubject(ConnectorSubject):
        def run(self):
            prev_t = None
            with open(path, newline="") as f:
                for row in _csv.DictReader(f):
                    out = {}
                    for c in columns:
                        v = row.get(c)
                        t = dt.unoptionalize(dtypes.get(c, dt.ANY))
                        if v is not None:
                            if t is dt.INT:
                                v = int(v)
                            elif t is dt.FLOAT:
                                v = float(v)

                        out[c] = v
                    t_now = float(out[time_column]) * mul
                    if prev_t is not None and t_now > prev_t:
                        time.sleep((t_now - prev_t) / speedup)
                    prev_t = t_now
                    self.next(**out)

    return read(_ReplayTimeSubject(), schema=schema, autocommit_duration_ms=autocommit_ms,
                persistent_id=persistent_id)
