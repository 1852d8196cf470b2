"""pw.io.debezium — Debezium CDC format (counterpart of
``pathway_tpu/io/debezium``; reference: python/pathway/io/debezium/__init__.py over the DebeziumDB parser,
src/connectors/data_format.rs — parses {payload: {op, before, after}} change
messages; op c/r=insert, u=update (retract before + insert after), d=delete).

The reference consumes Debezium through Kafka; here ``read`` accepts either a
Kafka topic (when the kafka backend is available) or any stream of raw JSON
message strings — e.g. a jsonlines file/directory (each line one Debezium
envelope), which is also how the tests drive it.  Both transports at once, a
``mode`` other than streaming over Kafka, and keyword arguments the
reference takes and never reads raise.
"""

from __future__ import annotations

import json
from typing import Optional, Type

from ...internals.schema import Schema
from ...internals.table import Table
from .._connector import SessionWriter, refuse_dropped, register_source

__all__ = ["read", "parse_message"]


def parse_message(raw, columns):
    """Decode one Debezium envelope -> (op, before_values, after_values)."""
    if isinstance(raw, (bytes, bytearray)):
        raw = raw.decode()
    msg = json.loads(raw) if isinstance(raw, str) else raw
    payload = msg.get("payload", msg)
    op = payload.get("op", "c")
    before = payload.get("before")
    after = payload.get("after")

    def project(obj):
        if obj is None:
            return None
        return {c: obj.get(c) for c in columns}

    return op, project(before), project(after)


def read(
    rdkafka_settings=None,
    topic_name: Optional[str] = None,
    *,
    schema: Type[Schema],
    input_dir: Optional[str] = None,
    mode: str = "streaming",
    autocommit_duration_ms: int = 100,
    name: str = "debezium",
    persistent_id: Optional[str] = None,
    **kwargs,
) -> Table:
    """Read a Debezium change stream.

    Exactly one transport: ``rdkafka_settings``+``topic_name`` (Kafka) or
    ``input_dir`` (directory of jsonlines files with one envelope per line).
    """
    refuse_dropped("pw.io.debezium.read", kwargs)
    if input_dir is not None and (rdkafka_settings is not None or topic_name is not None):
        raise ValueError("debezium.read: input_dir together with topic_name / rdkafka_settings is not supported "
                         "(one transport; the reference reads input_dir and ignores the Kafka settings)")
    if input_dir is None and mode != "streaming":
        raise ValueError(f"debezium.read over Kafka streams: mode={mode!r} is not supported")
    columns = list(schema.columns().keys())

    def apply_message(writer: SessionWriter, raw) -> None:
        try:
            op, before, after = parse_message(raw, columns)
        except (ValueError, KeyError):
            return
        if op in ("c", "r") and after is not None:
            writer.insert(after)
        elif op == "u":
            if before is not None:
                writer.remove(before)
            if after is not None:
                writer.insert(after)
        elif op == "d" and before is not None:
            writer.remove(before)

    if input_dir is not None:
        import os
        import time as _time

        def runner(writer: SessionWriter):
            pers = writer.persistence
            seen = dict((pers.offsets() or {}) if pers else {})

            def scan_once():
                changed = False
                try:
                    files = sorted(os.listdir(input_dir))
                except FileNotFoundError:
                    return False
                for fname in files:
                    fpath = os.path.join(input_dir, fname)
                    if not os.path.isfile(fpath):
                        continue
                    pos = seen.get(fpath, 0)
                    with open(fpath) as f:
                        f.seek(pos)
                        for line in f:
                            line = line.strip()
                            if line:
                                apply_message(writer, line)
                        newpos = f.tell()
                    if newpos != pos:
                        seen[fpath] = newpos
                        changed = True
                if changed and pers is not None:
                    pers.save_offsets(dict(seen))
                return changed

            if mode == "static":
                scan_once()
                return
            while True:
                scan_once()
                _time.sleep(0.2)

        return register_source(
            schema,
            runner,
            mode=mode,
            name=name,
            persistent_id=persistent_id,
            track_value_deletions=True,  # CDC update/delete envelopes
        )

    if topic_name is None:
        raise ValueError("debezium.read needs topic_name+rdkafka_settings or input_dir")

    from ..kafka import _consume_raw  # gated on a kafka client library

    def runner(writer: SessionWriter):
        for _partition, _offset, raw in _consume_raw(rdkafka_settings, topic_name):
            apply_message(writer, raw)

    return register_source(
        schema,
        runner,
        mode="streaming",
        name=name,
        persistent_id=persistent_id,
        track_value_deletions=True,  # CDC update/delete envelopes
    )
