"""pw.io.kafka — Kafka connector (counterpart of
``pathway_tpu/io/kafka``; reference: python/pathway/io/kafka/__init__.py
over KafkaReader / KafkaWriter, src/connectors/data_storage.rs).

Gated on a Python Kafka client (``kafka-python`` or ``confluent_kafka``);
all parsing and formatting is local, so only the transport needs the
client library.  ``autocommit_duration_ms`` is accepted as in
``pw.io.python.read``: batches follow the engine's commit tick.  Keyword
arguments the reference takes and never reads, and ``write(format=...)``
other than json, raise."""

from __future__ import annotations

import json
from typing import Dict, Iterable, Optional, Type

from ...internals.schema import Schema, schema_from_types
from ...internals.table import Table
from .._connector import SessionWriter, refuse_dropped, register_source

__all__ = ["read", "write", "simple_read"]


def _make_consumer(rdkafka_settings: Dict, topic: str):
    try:
        from kafka import KafkaConsumer  # type: ignore

        return KafkaConsumer(
            topic,
            bootstrap_servers=rdkafka_settings.get("bootstrap.servers"),
            group_id=rdkafka_settings.get("group.id"),
            auto_offset_reset=rdkafka_settings.get("auto.offset.reset", "earliest"),
        )
    except ImportError:
        pass
    try:
        from confluent_kafka import Consumer  # type: ignore

        consumer = Consumer(rdkafka_settings)
        consumer.subscribe([topic])
        return consumer
    except ImportError as e:
        raise ImportError(
            "pw.io.kafka requires a Kafka client library (kafka-python or "
            "confluent_kafka); neither is installed"
        ) from e


def _consume_raw(rdkafka_settings: Dict, topic: str):
    """Yield ``(partition, offset, payload)``; partition/offset are None
    only for clients that do not expose them (both real clients do)."""
    consumer = _make_consumer(rdkafka_settings or {}, topic)
    if hasattr(consumer, "poll") and not hasattr(consumer, "subscription"):
        # confluent_kafka style
        while True:
            msg = consumer.poll(0.2)
            if msg is None or msg.error():
                continue
            yield msg.partition(), msg.offset(), msg.value()
    else:  # kafka-python style iterator
        for msg in consumer:
            yield (
                getattr(msg, "partition", None),
                getattr(msg, "offset", None),
                msg.value,
            )


def read(
    rdkafka_settings: Dict,
    topic: Optional[str] = None,
    *,
    schema: Optional[Type[Schema]] = None,
    format: str = "json",
    autocommit_duration_ms: int = 100,
    name: str = "kafka",
    persistent_id: Optional[str] = None,
    **kwargs,
) -> Table:
    """Consume a topic as a stream of rows (json / plaintext / raw)."""
    refuse_dropped("pw.io.kafka.read", kwargs)
    if format in ("plaintext", "raw"):
        schema = schema or schema_from_types(data=(str if format == "plaintext" else bytes))
    elif schema is None:
        raise ValueError(f"schema is required for format={format!r}")
    columns = list(schema.columns().keys())
    has_pk = schema.primary_key_columns() is not None

    # distributed placement depends on the consumer-group config: WITH a
    # group.id, brokers hand each rank a DISJOINT partition subset —
    # partitioned, true parallel consumption.  WITHOUT one, every rank's
    # consumer reads ALL partitions (identical streams) — replicated, the
    # engine keeps each rank's owned-key slice.  Replicated mode only works
    # if every rank mints the SAME key for the same record, but brokers
    # interleave partitions nondeterministically, so per-rank sequential
    # keys would diverge — keys for non-PK rows are instead derived from
    # (topic, partition, offset), which is order-independent (the analog of
    # the reference's offset-based snapshot identity, src/connectors/offset.rs).
    has_group = bool((rdkafka_settings or {}).get("group.id"))

    from ...internals.keys import ref_scalar
    from ...parallel.distributed import topology_from_env

    nproc, _rank, _addr = topology_from_env()
    replicated_multiproc = (not has_group) and nproc > 1
    # per-read() ordinal, identical across ranks (same script, same build
    # order): folded into the derived key so two no-PK reads of the SAME
    # topic stay key-disjoint (concat-safe), like the per-source salt does
    # for sequential keys.  Scoped to the graph, not the module, so a
    # rank that happens to have built an earlier graph in-process does not
    # drift from fresh ranks.
    from ...internals.parse_graph import G

    ordinal = G.claim_io_ordinal("kafka")

    def runner(writer: SessionWriter):
        for partition, offset, raw in _consume_raw(rdkafka_settings, topic):
            key = None
            if not has_pk and partition is not None and offset is not None:
                key = int(
                    ref_scalar(
                        "kafka", ordinal, topic or "", int(partition), int(offset)
                    )
                )
            elif key is None and not has_pk and replicated_multiproc:
                raise ValueError(
                    "pw.io.kafka: replicated (group-id-less) consumption in a "
                    "multi-process run needs deterministic record identity, "
                    "but this client exposes no partition/offset — set a "
                    "group.id (partitioned mode) or add a primary key"
                )
            if format == "raw":
                writer.insert({"data": raw}, key=key)
            elif format == "plaintext":
                writer.insert({"data": raw.decode(errors="replace")}, key=key)
            else:
                try:
                    obj = json.loads(raw)
                except ValueError:
                    continue
                writer.insert({c: obj.get(c) for c in columns}, key=key)
    return register_source(
        schema,
        runner,
        mode="streaming",
        name=name,
        persistent_id=persistent_id,
        dist_mode="partitioned" if has_group else "replicated",
    )


def simple_read(server: str, topic: str, *, format: str = "raw", **kwargs) -> Table:
    return read(
        {"bootstrap.servers": server, "group.id": f"pathway-{topic}"},
        topic,
        format=format,
        **kwargs,
    )


def write(
    table: Table,
    rdkafka_settings: Dict,
    topic_name: str,
    *,
    format: str = "json",
    **kwargs,
) -> None:
    """Produce the table's update stream to a topic (json rows with
    time/diff fields, matching the reference's output format)."""
    refuse_dropped("pw.io.kafka.write", kwargs)
    if format != "json":
        raise ValueError(f"pw.io.kafka.write: format={format!r} is not supported (json only; the reference writes "
                         "json whatever the format)")
    try:
        from kafka import KafkaProducer  # type: ignore

        producer = KafkaProducer(
            bootstrap_servers=rdkafka_settings.get("bootstrap.servers")
        )

        def send(payload: bytes):
            producer.send(topic_name, payload)

        def flush():
            producer.flush()

    except ImportError:
        try:
            from confluent_kafka import Producer  # type: ignore

            producer = Producer(rdkafka_settings)

            def send(payload: bytes):
                producer.produce(topic_name, payload)

            def flush():
                producer.flush()

        except ImportError as e:
            raise ImportError(
                "pw.io.kafka requires a Kafka client library (kafka-python or "
                "confluent_kafka); neither is installed"
            ) from e

    from .._connector import jsonable as _jsonable
    from .._subscribe import subscribe

    names = table.column_names

    def on_change(key, row, time, is_addition):
        obj = {n: _jsonable(row[n]) for n in names}
        obj["time"] = time
        obj["diff"] = 1 if is_addition else -1
        send(json.dumps(obj).encode())

    subscribe(table, on_change=on_change, on_time_end=lambda ts: flush())
