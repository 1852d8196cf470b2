"""The port's client-gated connectors (``pathway_tpu_torch/io``: kafka,
redpanda, debezium, s3, s3_csv, minio, deltalake, postgres, mongodb,
bigquery, elasticsearch, nats, pubsub, logstash, slack, gdrive,
sharepoint, pyfilesystem, airbyte) against the reference's, on the CPU.

Every scenario of ``tests/test_transport_fakes.py`` and
``tests/test_airbyte_sharepoint.py``, and the gated cases of
``tests/test_connectors.py``, runs through both packages over the same
fake client (injected into ``sys.modules`` or monkeypatched onto a real
module): the same rows, produced messages and issued statements, and the
same ``ImportError`` text without a client.  Then the Kafka ETL template
(``templates/kafka_etl.py``) built on the port's ``pw``, Kafka over two
CPU ranks (``tests/torch_dist_worker.py``) in both ``dist_mode``s against
one process, and the options the reference accepts and drops, which the
port refuses.

Sources fed by a thread (a subject that sleeps, a streaming poll) split
into ticks by thread timing in both packages: their update streams are
compared as multisets of events, the rest event for event."""

from __future__ import annotations

import datetime
import importlib
import json
import os
import stat
import sys
import threading
import time
import types
from collections import Counter
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.io import _connector as ref_connector
from pathway_tpu_torch.io import _connector as port_connector

from .test_airbyte_sharepoint import FAKE_SOURCE
from .test_torch_cluster import _spawn
from .torch_dist_worker import KAFKA_SETTINGS, fake_kafka_module, kafka_pipeline
from .utils import REPO_ROOT

PACKAGES = (pathway_tpu, pathway_tpu_torch)


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setattr(ref_connector, "_source_counter", [0])
    monkeypatch.setattr(port_connector, "_source_counter", [0])
    for pw in PACKAGES:
        pw.reset()
    yield
    for pw in PACKAGES:
        pw.reset()


def _both(fn):
    """``fn(pw)`` for the reference then the port, each on a fresh graph
    and source counter; ``(reference's result, port's result)``."""
    out = []
    for pw in PACKAGES:
        pw.reset()
        pw.io._connector._source_counter[0] = 0
        out.append(fn(pw))
    return tuple(out)


def _run(pw):
    pw.run(monitoring_level=None, commit_duration_ms=50)


def _module(name: str, **attrs) -> types.ModuleType:
    mod = types.ModuleType(name)
    for k, v in attrs.items():
        setattr(mod, k, v)
    return mod


def _schema_kv(pw):
    class KV(pw.Schema):
        k: str = pw.column_definition(primary_key=True)
        v: int

    return KV


def _events(pw, table):
    """The table's update stream as ``(key, row tuple, time, diff)``."""
    events = []

    def on_change(key, row, time, is_addition):
        events.append((int(key), tuple(row[c] for c in table.column_names), int(time), 1 if is_addition else -1))

    pw.io.subscribe(table, on_change=on_change)
    return events


def _final(events):
    """The rows an update stream leaves, with their keys."""
    alive = Counter()
    for key, row, _time, diff in events:
        alive[(key, row)] += diff
    assert all(n >= 0 for n in alive.values())
    return sorted(k for k, n in alive.items() for _ in range(n))


def _same(ref, port):
    assert port == ref
    return port


def _ticked(obj):
    """``obj`` with the ``"time"`` of every dict in it (the engine's time,
    wall-clock milliseconds that differ from run to run) replaced by the
    index of its tick among the run's ticks."""
    times = set()

    def collect(o):
        if isinstance(o, dict):
            if "time" in o:
                times.add(o["time"])
            o = o.values()
        if isinstance(o, (list, tuple, type({}.values()))):
            for v in o:
                collect(v)

    def rebuild(o):
        if isinstance(o, dict):
            return {k: order[v] if k == "time" else rebuild(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(rebuild(v) for v in o)
        return o

    collect(obj)
    order = {t: i for i, t in enumerate(sorted(times, key=float))}
    return rebuild(obj)


# ---------------------------------------------------------------- kafka


class _Msg:
    def __init__(self, value, partition=None, offset=None):
        self.value = value
        if partition is not None:
            self.partition, self.offset = partition, offset


def test_kafka_read_json(monkeypatch):
    class FakeConsumer:
        def __init__(self, topic, **kw):
            assert topic == "events" and kw["bootstrap_servers"] == "broker:9092"
            self._msgs = [_Msg(json.dumps({"k": "a", "v": 1}).encode()), _Msg(b"not json"),
                          _Msg(json.dumps({"k": "b", "v": 2}).encode())]

        def __iter__(self):
            return iter(self._msgs)

    monkeypatch.setitem(sys.modules, "kafka", _module("kafka", KafkaConsumer=FakeConsumer))

    def scenario(pw):
        t = pw.io.kafka.read({"bootstrap.servers": "broker:9092", "group.id": "g"}, "events", schema=_schema_kv(pw),
                             format="json")
        rows, counts = _events(pw, t), _events(pw, t.groupby().reduce(total=pw.reducers.sum(t.v)))
        _run(pw)
        return _final(rows), [r for _k, r in _final(counts)]

    ref, port = _both(scenario)
    assert _same(ref, port)[1] == [(3,)]


def test_kafka_replicated_keys_are_partition_order_independent(monkeypatch):
    """Group-id-less consumption keys rows by (topic, partition, offset):
    two interleavings give the same keys, and the port's keys are the
    reference's."""
    msgs = [_Msg(json.dumps({"k": f"p{p}o{o}", "v": p * 10 + o}).encode(), p, o) for p in (0, 1) for o in (0, 1, 2)]

    def keys_for(pw, ordering):
        class FakeConsumer:
            def __init__(self, topic, **kw):
                assert kw.get("group_id") is None
                self._msgs = ordering

            def __iter__(self):
                return iter(self._msgs)

        monkeypatch.setitem(sys.modules, "kafka", _module("kafka", KafkaConsumer=FakeConsumer))
        pw.reset()

        class NoPK(pw.Schema):
            k: str
            v: int

        t = pw.io.kafka.read({"bootstrap.servers": "broker:9092"}, "events", schema=NoPK)
        seen = {}
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: seen.__setitem__(row["k"], int(key)))
        _run(pw)
        return seen

    other = [msgs[3], msgs[0], msgs[4], msgs[1], msgs[5], msgs[2]]
    ref, port = _both(lambda pw: (keys_for(pw, msgs), keys_for(pw, other)))
    assert port[0] == port[1] and len(set(port[0].values())) == 6
    _same(ref, port)


def _fake_producer(sent):
    class FakeProducer:
        def __init__(self, **kw):
            assert kw["bootstrap_servers"] == "broker:9092"

        def send(self, topic, payload):
            sent.append((topic, json.loads(payload)))

        def flush(self):
            sent.append(("flush", None))

    return FakeProducer


def test_kafka_write_produces_update_stream(monkeypatch):
    def scenario(pw):
        sent = []
        monkeypatch.setitem(sys.modules, "kafka", _module("kafka", KafkaProducer=_fake_producer(sent)))
        t = pw.debug.table_from_rows(_schema_kv(pw), [("a", 1), ("b", 2)])
        pw.io.kafka.write(t, {"bootstrap.servers": "broker:9092"}, topic_name="out")
        _run(pw)
        return _ticked(sent)

    ref, port = _both(scenario)
    _same(ref, port)
    payloads = [p for topic, p in port if topic == "out"]
    assert sorted((p["k"], p["v"], p["diff"]) for p in payloads) == [("a", 1, 1), ("b", 2, 1)]
    assert ("flush", None) in port


def _envelopes():
    return [
        {"payload": {"op": "c", "after": {"k": "a", "v": 1}}},
        {"payload": {"op": "c", "after": {"k": "b", "v": 2}}},
        {"payload": {"op": "u", "before": {"k": "a", "v": 1}, "after": {"k": "a", "v": 9}}},
        {"payload": {"op": "d", "before": {"k": "b", "v": 2}}},
    ]


def test_debezium_over_fake_kafka(monkeypatch):
    class FakeConsumer:
        def __init__(self, topic, **kw):
            self._msgs = [_Msg(json.dumps(e).encode()) for e in _envelopes()]

        def __iter__(self):
            return iter(self._msgs)

    monkeypatch.setitem(sys.modules, "kafka", _module("kafka", KafkaConsumer=FakeConsumer))

    def scenario(pw):
        class Row(pw.Schema):
            k: str
            v: int

        rows = _events(pw, pw.io.debezium.read({"bootstrap.servers": "b:9092"}, "cdc", schema=Row))
        _run(pw)
        return _final(rows)

    ref, port = _both(scenario)
    assert [r for _k, r in _same(ref, port)] == [("a", 9)]


# ---------------------------------------------------------------- s3


def _fake_boto3(bodies, downloads, bucket="bkt", prefix="data/"):
    class FakePaginator:
        def paginate(self, Bucket, Prefix):
            assert Bucket == bucket and Prefix == prefix
            return [{"Contents": [{"Key": key, "ETag": f"e{i}"} for i, key in enumerate(sorted(bodies))]}]

    class FakeClient:
        def get_paginator(self, op):
            assert op == "list_objects_v2"
            return FakePaginator()

        def download_file(self, bkt, key, local):
            downloads.append(key)
            with open(local, "w") as f:
                f.write(bodies[key])

    return _module("boto3", client=lambda svc, **kw: FakeClient())


def test_s3_read_csv_with_etag_offsets(monkeypatch):
    def scenario(pw):
        downloads = []
        monkeypatch.setitem(sys.modules, "boto3", _fake_boto3(
            {"data/part0.csv": "k,v\na,1\n", "data/part1.csv": "k,v\nb,2\n"}, downloads))
        rows = _events(pw, pw.io.s3.read("s3://bkt/data/", format="csv", schema=_schema_kv(pw), mode="static"))
        _run(pw)
        return _final(rows), sorted(downloads)

    ref, port = _both(scenario)
    rows, downloads = _same(ref, port)
    assert sorted(r for _k, r in rows) == [("a", 1), ("b", 2)]
    assert downloads == ["data/part0.csv", "data/part1.csv"]


def test_s3_csv_wrapper_reads_csv(monkeypatch):
    def scenario(pw):
        monkeypatch.setitem(sys.modules, "boto3", _fake_boto3({"d/a.csv": "k,v\nq,7\n"}, [], prefix="d/"))
        rows = _events(pw, pw.io.s3_csv.read("s3://bkt/d/", schema=_schema_kv(pw), mode="static"))
        _run(pw)
        return _final(rows)

    ref, port = _both(scenario)
    assert [r for _k, r in _same(ref, port)] == [("q", 7)]


def test_minio_reads_through_s3_with_its_endpoint(monkeypatch):
    """``pw.io.minio`` hands the s3 reader its endpoint and keys; the
    client gets the same keywords in both packages."""
    made = []

    def scenario(pw):
        fake = _fake_boto3({"data/m.csv": "k,v\nm,3\n"}, [])
        real_client = fake.client
        fake.client = lambda svc, **kw: made.append((svc, kw)) or real_client(svc, **kw)
        monkeypatch.setitem(sys.modules, "boto3", fake)
        settings = pw.io.minio.MinIOSettings("minio.local:9000", "bkt", "AK", "SK")
        rows = _events(pw, pw.io.minio.read("data/", settings, schema=_schema_kv(pw), mode="static"))
        _run(pw)
        return _final(rows), made.pop()

    ref, port = _both(scenario)
    rows, client = _same(ref, port)
    assert sorted(r for _k, r in rows) == [("m", 3)]
    assert client == ("s3", {"aws_access_key_id": "AK", "aws_secret_access_key": "SK",
                             "endpoint_url": "https://minio.local:9000"})


# ---------------------------------------------------------------- deltalake


def test_deltalake_read_and_write(monkeypatch):
    pytest.importorskip("pyarrow")

    class FakeDeltaTable:
        def __init__(self, uri):
            assert uri == "dl://tbl"

        def version(self):
            return 0

        def to_pyarrow_table(self):
            return types.SimpleNamespace(to_pylist=lambda: [{"k": "a", "v": 1}, {"k": "b", "v": 2}])

    def scenario(pw):
        written = []
        monkeypatch.setitem(sys.modules, "deltalake", _module(
            "deltalake", DeltaTable=FakeDeltaTable,
            write_deltalake=lambda uri, batch, mode: written.append((uri, mode, batch.to_pylist()))))
        t = pw.io.deltalake.read("dl://tbl", schema=_schema_kv(pw), mode="static")
        pw.io.deltalake.write(t, "dl://out")
        rows = _events(pw, t)
        _run(pw)
        return _final(rows), _ticked(written)

    ref, port = _both(scenario)
    rows, written = _same(ref, port)
    assert sorted(r for _k, r in rows) == [("a", 1), ("b", 2)]
    assert sorted((r["k"], r["v"], r["diff"]) for _u, mode, batch in written for r in batch) == [
        ("a", 1, 1), ("b", 2, 1)]


# ---------------------------------------------------------------- bigquery


def test_bigquery_write_batches(monkeypatch):
    bq = pytest.importorskip("google.cloud.bigquery")

    def scenario(pw):
        inserted = []

        class FakeClient:
            project = "proj"

            def insert_rows_json(self, table_ref, batch):
                inserted.append((table_ref, list(batch)))
                return []

        monkeypatch.setattr(bq, "Client", lambda: FakeClient())
        pw.io.bigquery.write(pw.debug.table_from_rows(_schema_kv(pw), [("a", 1), ("b", 2)]), "ds", "tbl")
        _run(pw)
        return _ticked(inserted)

    ref, port = _both(scenario)
    _same(ref, port)
    assert port[0][0] == "proj.ds.tbl"
    assert sorted((r["k"], r["v"], r["diff"]) for _ref, batch in port for r in batch) == [("a", 1, 1), ("b", 2, 1)]


# ---------------------------------------------------------------- postgres


class _FakePgConn:
    def __init__(self, log):
        self.log = log

    def cursor(self):
        log = self.log
        return types.SimpleNamespace(execute=lambda sql, params: log.append((" ".join(sql.split()), list(params))))

    def commit(self):
        self.log.append(("COMMIT", []))

    def close(self):
        self.log.append(("CLOSE", []))


def test_postgres_write_updates(monkeypatch):
    def scenario(pw):
        log = []

        def connect(**settings):
            assert settings == {"host": "h", "dbname": "d"}
            return _FakePgConn(log)

        monkeypatch.setitem(sys.modules, "psycopg2", _module("psycopg2", connect=connect))
        pw.io.postgres.write(pw.debug.table_from_rows(_schema_kv(pw), [("a", 1)]), {"host": "h", "dbname": "d"},
                             "events")
        _run(pw)
        return _ticked([(sql, {"values": p[:-2], "time": p[-2], "diff": p[-1]}) if sql.startswith("INSERT")
                        else (sql, p) for sql, p in log])

    ref, port = _both(scenario)
    _same(ref, port)
    inserts = [(sql, p) for sql, p in port if sql.startswith("INSERT")]
    assert len(inserts) == 1 and "INSERT INTO events (k, v, time, diff)" in inserts[0][0]
    assert inserts[0][1] == {"values": ["a", 1], "time": 0, "diff": 1} and ("COMMIT", []) in port


def test_postgres_write_snapshot_upsert_delete(monkeypatch):
    def scenario(pw):
        log = []
        monkeypatch.setitem(sys.modules, "psycopg2", _module("psycopg2", connect=lambda **s: _FakePgConn(log)))

        class Subj(pw.io.python.ConnectorSubject):
            def run(self):
                self.next(k="a", v=1)
                time.sleep(0.3)
                self.next(k="a", v=2)  # upsert: retract + insert

        pw.io.postgres.write_snapshot(pw.io.python.read(Subj(), schema=_schema_kv(pw)), {}, "snap", primary_key=["k"])
        _run(pw)
        return sorted((sql, tuple(p)) for sql, p in log if sql not in ("COMMIT", "CLOSE"))

    ref, port = _both(scenario)
    statements = _same(ref, port)
    assert sum("ON CONFLICT (k) DO UPDATE" in s for s, _p in statements) == 2
    assert [p for s, p in statements if s.startswith("DELETE FROM snap WHERE k = ")] == [("a",)]


# ---------------------------------------------------------------- mongodb


def test_mongodb_write(monkeypatch):
    def scenario(pw):
        inserted = []

        class FakeMongoClient:
            def __init__(self, conn_str):
                assert conn_str == "mongodb://h"

            def __getitem__(self, name):
                assert name == "db"
                return {"coll": types.SimpleNamespace(insert_many=inserted.extend)}

        monkeypatch.setitem(sys.modules, "pymongo", _module("pymongo", MongoClient=FakeMongoClient))
        pw.io.mongodb.write(pw.debug.table_from_rows(_schema_kv(pw), [("a", 1), ("b", 2)]), "mongodb://h", "db",
                            "coll")
        _run(pw)
        return _ticked(inserted)

    ref, port = _both(scenario)
    _same(ref, port)
    assert sorted((d["k"], d["v"], d["diff"]) for d in port) == [("a", 1, 1), ("b", 2, 1)]
    assert all(d["_pw_key"] for d in port)


# ---------------------------------------------------------------- nats


def test_nats_read_and_write(monkeypatch):
    def scenario(pw):
        published = []

        class FakeSub:
            def __init__(self, msgs):
                self._msgs = msgs

            @property
            def messages(self):
                msgs = list(self._msgs)

                class _It:
                    def __aiter__(self):
                        return self

                    async def __anext__(self):
                        if not msgs:
                            raise StopAsyncIteration
                        return msgs.pop(0)

                return _It()

        class FakeNc:
            async def subscribe(self, topic):
                assert topic == "events"
                return FakeSub([types.SimpleNamespace(data=json.dumps({"k": k, "v": v}).encode())
                                for k, v in (("a", 1), ("b", 2))])

            async def publish(self, topic, payload):
                published.append((topic, json.loads(payload)))

        async def fake_connect(uri):
            assert uri == "nats://h:4222"
            return FakeNc()

        monkeypatch.setitem(sys.modules, "nats", _module("nats", connect=fake_connect))
        t = pw.io.nats.read("nats://h:4222", "events", schema=_schema_kv(pw))
        pw.io.nats.write(t, "nats://h:4222", "out")
        rows = _events(pw, t)
        _run(pw)
        return _final(rows), sorted((topic, p["k"], p["v"], p["diff"]) for topic, p in published)

    ref, port = _both(scenario)
    rows, published = _same(ref, port)
    assert sorted(r for _k, r in rows) == [("a", 1), ("b", 2)]
    assert published == [("out", "a", 1, 1), ("out", "b", 2, 1)]


# ---------------------------------------------------------------- pubsub


def test_pubsub_write_with_injected_publisher():
    def scenario(pw):
        published = []

        class FakePublisher:
            def topic_path(self, project, topic):
                return f"projects/{project}/topics/{topic}"

            def publish(self, path, payload, **attrs):
                published.append((path, json.loads(payload), attrs))
                return types.SimpleNamespace(result=lambda: "msgid")

        pw.io.pubsub.write(pw.debug.table_from_rows(_schema_kv(pw), [("a", 1)]), FakePublisher(), "proj", "topic")
        _run(pw)
        return _ticked(published)

    ref, port = _both(scenario)
    _same(ref, port)
    assert port[0][:2] == ("projects/proj/topics/topic", {"k": "a", "v": 1}) and port[0][2]["diff"] == "1"


# ---------------------------------------------------------------- gdrive


def test_gdrive_read(monkeypatch, tmp_path):
    class FakeFiles:
        def list(self, q, fields):
            assert "'folder123' in parents" in q
            return types.SimpleNamespace(execute=lambda: {"files": [
                {"id": "f1", "name": "a.txt", "modifiedTime": "t1"},
                {"id": "f2", "name": "b.txt", "modifiedTime": "t2"}]})

        def get_media(self, fileId):
            return types.SimpleNamespace(execute=lambda: f"contents of {fileId}".encode())

    class FakeCreds:
        @classmethod
        def from_service_account_file(cls, path, scopes):
            return cls()

    creds_file = tmp_path / "creds.json"
    creds_file.write_text("{}")
    monkeypatch.setitem(sys.modules, "googleapiclient", _module("googleapiclient"))
    monkeypatch.setitem(sys.modules, "googleapiclient.discovery", _module(
        "googleapiclient.discovery", build=lambda api, ver, credentials: types.SimpleNamespace(files=FakeFiles)))
    monkeypatch.setitem(sys.modules, "google.oauth2.service_account",
                        _module("google.oauth2.service_account", Credentials=FakeCreds))

    def scenario(pw):
        rows = _events(pw, pw.io.gdrive.read("folder123", mode="static",
                                             service_user_credentials_file=str(creds_file)))
        _run(pw)
        return _final(rows)

    ref, port = _both(scenario)
    assert sorted(r for _k, r in _same(ref, port)) == [(b"contents of f1",), (b"contents of f2",)]


# ---------------------------------------------------------------- requests-based writers


def _alerts(pw):
    class Alert(pw.Schema):
        message: str

    return pw.debug.table_from_rows(Alert, [("disk full",)])


def test_slack_send_alerts(monkeypatch):
    import requests

    def scenario(pw):
        posted = []
        monkeypatch.setattr(requests, "post", lambda url, json=None, headers=None: posted.append(
            (url, json, headers)) or types.SimpleNamespace(raise_for_status=lambda: None))
        pw.io.slack.send_alerts(_alerts(pw), "C0CHAN", "xoxb-token")
        _run(pw)
        return posted

    ref, port = _both(scenario)
    assert _same(ref, port) == [("https://slack.com/api/chat.postMessage", {"channel": "C0CHAN", "text": "disk full"},
                                 {"Authorization": "Bearer xoxb-token"})]


def test_logstash_write(monkeypatch):
    import requests

    def scenario(pw):
        posted = []

        class FakeSession:
            def post(self, endpoint, data=None, headers=None):
                posted.append((endpoint, json.loads(data), headers))
                return types.SimpleNamespace(raise_for_status=lambda: None)

        monkeypatch.setattr(requests, "Session", FakeSession)
        pw.io.logstash.write(pw.debug.table_from_rows(_schema_kv(pw), [("a", 1)]), "http://ls:8080")
        _run(pw)
        return _ticked(posted)

    ref, port = _both(scenario)
    _same(ref, port)
    assert port[0][0] == "http://ls:8080" and port[0][1]["k"] == "a" and port[0][1]["diff"] == 1


def test_elasticsearch_write_bulk(monkeypatch):
    import requests

    def scenario(pw):
        bulks = []

        class FakeSession:
            def __init__(self):
                self.headers = {}

            def post(self, url, data=None, headers=None):
                bulks.append((url, [json.loads(line) for line in data.strip().splitlines()], headers))
                return types.SimpleNamespace(raise_for_status=lambda: None, json=lambda: {"errors": False, "items": []})

        monkeypatch.setattr(requests, "Session", FakeSession)
        pw.io.elasticsearch.write(pw.debug.table_from_rows(_schema_kv(pw), [("a", 1), ("b", 2)]), "http://es:9200",
                                  index_name="idx")
        _run(pw)
        return bulks

    ref, port = _both(scenario)
    _same(ref, port)
    assert port[0][0] == "http://es:9200/_bulk"
    ops = [line for line in port[0][1] if "index" in line]
    assert len(ops) == 2 and all(op["index"]["_index"] == "idx" for op in ops)
    assert sorted((d["k"], d["v"]) for d in port[0][1] if "k" in d) == [("a", 1), ("b", 2)]


# ---------------------------------------------------------------- pyfilesystem


class _FakeFS:
    """The FS surface pw.io.pyfilesystem uses (walk.files / readbytes /
    getinfo), as ``tests/test_transport_fakes.py`` fakes it."""

    def __init__(self, files):
        self.files = dict(files)  # path -> (mtime, bytes)
        self.walk = types.SimpleNamespace(files=lambda path="": [p for p in sorted(self.files) if p.startswith(path)])

    def readbytes(self, p):
        return self.files[p][1]

    def getinfo(self, p, namespaces=()):
        mtime, data = self.files[p]
        return types.SimpleNamespace(modified=datetime.datetime.fromtimestamp(mtime, datetime.timezone.utc),
                                     created=None, accessed=None, size=len(data), name=p.rsplit("/", 1)[-1])


def test_pyfilesystem_static_read_with_metadata():
    def scenario(pw):
        src = _FakeFS({"/docs/a.txt": (100, b"alpha"), "/docs/b.txt": (200, b"beta")})
        t = pw.io.pyfilesystem.read(src, path="/docs", mode="static", with_metadata=True)
        rows = []
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: rows.append(
            (int(key), row["path"], bytes(row["data"]), {k: v for k, v in row["_metadata"].items() if k != "seen_at"},
             is_addition)))
        _run(pw)
        return sorted(rows, key=lambda r: r[1])

    ref, port = _both(scenario)
    rows = _same(ref, port)
    assert [(p, d) for _k, p, d, _m, add in rows if add] == [("/docs/a.txt", b"alpha"), ("/docs/b.txt", b"beta")]
    assert rows[0][3] == {"created_at": None, "modified_at": 100, "accessed_at": None, "size": 5, "name": "a.txt",
                          "path": "/docs/a.txt"}


def test_pyfilesystem_streaming_upserts_and_deletes():
    """Changed files upsert (the old content retracted), deleted files
    retract: the same events in both packages (ticks by thread timing, so
    compared as multisets)."""

    def scenario(pw):
        src = _FakeFS({"/a.txt": (1, b"v1")})
        t = pw.io.pyfilesystem.read(src, mode="streaming", refresh_interval=0.05)
        events, done = [], threading.Event()

        def on_change(key, row, time, is_addition):
            events.append((int(key), row["path"], bytes(row["data"]), is_addition))
            if (row["path"], is_addition) == ("/b.txt", False):
                done.set()

        pw.io.subscribe(t, on_change=on_change)

        def mutate():
            time.sleep(0.4)
            src.files["/a.txt"] = (2, b"v2")
            src.files["/b.txt"] = (3, b"fresh")
            time.sleep(0.4)
            del src.files["/b.txt"]
            done.wait(timeout=20)
            importlib.import_module(f"{pw.__name__}.internals.run").terminate()

        mut = threading.Thread(target=mutate, daemon=True)
        mut.start()
        _run(pw)
        mut.join(timeout=5)
        return sorted(events, key=repr)

    ref, port = _both(scenario)
    events = _same(ref, port)
    for want in (("/a.txt", b"v1", True), ("/a.txt", b"v1", False), ("/a.txt", b"v2", True),
                 ("/b.txt", b"fresh", True), ("/b.txt", b"fresh", False)):
        assert want in [e[1:] for e in events], want


# ---------------------------------------------------------------- airbyte, sharepoint


@pytest.fixture
def fake_source(tmp_path):
    path = tmp_path / "fake-source"
    path.write_text(FAKE_SOURCE.format(python=sys.executable))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _airbyte_rows(pw, fake_source, **kw):
    t = pw.io.airbyte.read(config=kw.pop("config", {"token": "x"}), streams=["issues"], exec_command=fake_source,
                           mode="static", **kw)
    rows = []
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: rows.append(
        (int(key), row["stream"], json.dumps(row["data"], sort_keys=True), is_addition)))
    return rows


def test_airbyte_reads_records_from_protocol_stream(fake_source):
    def scenario(pw):
        rows = _airbyte_rows(pw, fake_source)
        pw.run(monitoring_level=None)
        return rows

    ref, port = _both(scenario)
    assert [json.loads(d)["id"] for _k, s, d, _a in _same(ref, port) if s == "issues"] == [0, 1, 2]


def test_airbyte_state_resumes_incremental_sync(fake_source, tmp_path):
    def scenario(pw):
        root = str(tmp_path / f"snap-{pw.__name__}")
        cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(root))
        runs = []
        for _ in range(2):
            pw.reset()
            pw.io._connector._source_counter[0] = 0
            rows = _airbyte_rows(pw, fake_source, config={}, persistent_id="ab")
            pw.run(monitoring_level=None, persistence_config=cfg)
            runs.append(sorted(json.loads(d)["id"] for _k, _s, d, _a in rows))
        return runs

    ref, port = _both(scenario)
    runs = _same(ref, port)
    assert runs[0][-3:] == [0, 1, 2] and runs[1][-3:] == [3, 4, 5]


def test_airbyte_requires_streams_and_runner():
    for pw in PACKAGES:
        pw.reset()
        with pytest.raises(ValueError, match="streams"):
            pw.io.airbyte.read(config={}, streams=None, exec_command="x")
        pw.io.airbyte.read(config={}, streams=["s"], mode="static")
        with pytest.raises(Exception, match="image|exec_command") as err:
            pw.run(monitoring_level=None)
        assert str(err.value) == "pw.io.airbyte needs `image` or `exec_command`"


def test_sharepoint_gated_clearly(monkeypatch):
    monkeypatch.setitem(sys.modules, "office365", None)
    texts = []
    for pw in PACKAGES:
        with pytest.raises(ImportError, match="sharepoint") as err:
            pw.io.sharepoint.read("https://org.sharepoint.com/sites/x", root_path="Shared Documents",
                                  client_id="id", client_secret="secret")
        texts.append(str(err.value))
    _same(*texts)


def test_operator_latency_probe_in_metrics():
    def scenario(pw):
        t = pw.debug.table_from_markdown(
            """
            a
            1
            """
        )
        t.select(b=pw.this.a + 1)
        pw.run(monitoring_level=None)
        metrics = importlib.import_module(f"{pw.__name__}.internals.metrics")
        text = metrics.render_metrics(importlib.import_module(f"{pw.__name__}.internals.parse_graph").G.engine_graph)
        return sorted({line.split("{")[0].split(" ")[0] for line in text.splitlines()
                       if line.startswith("pathway_operator_last_tick_seconds")})

    ref, port = _both(scenario)
    assert _same(ref, port) == ["pathway_operator_last_tick_seconds"]


# ---------------------------------------------------------------- tests/test_connectors.py, gated cases


def test_debezium_file_transport(tmp_path):
    d = tmp_path / "cdc"
    d.mkdir()
    with open(d / "000.jsonl", "w") as f:
        for m in _envelopes():
            f.write(json.dumps(m) + "\n")

    def scenario(pw):
        t = pw.io.debezium.read(input_dir=str(d), schema=_schema_kv(pw), mode="static")
        rows, counts = _events(pw, t), _events(pw, t.groupby().reduce(total=pw.reducers.sum(pw.this.v)))
        pw.run()
        return _final(rows), [(r, diff) for _k, r, _t, diff in counts]

    ref, port = _both(scenario)
    rows, counts = _same(ref, port)
    assert [r for _k, r in rows] == [("a", 9)] and counts[-1] == ((9,), 1)


def test_elasticsearch_bulk_writer_over_http():
    received = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            received.append(self.rfile.read(n).decode())
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(b'{"errors": false}')

        def log_message(self, *args):
            pass

    server = HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def scenario(pw):
        received.clear()
        t = pw.debug.table_from_markdown(
            """
            k | v
            a | 1
            """
        )
        pw.io.elasticsearch.write(t, f"http://127.0.0.1:{server.server_address[1]}", index_name="idx")
        pw.run()
        return [[json.loads(line) for line in body.strip().split("\n")] for body in received]

    try:
        ref, port = _both(scenario)
    finally:
        server.shutdown()
    bodies = _same(ref, port)
    assert bodies[0][0]["index"]["_index"] == "idx" and bodies[0][1] == {"k": "a", "v": 1}


@pytest.mark.parametrize("client,call", [
    ("kafka", lambda pw, t: pw.io.kafka.write(t, {}, "topic")),
    ("psycopg2", lambda pw, t: pw.io.postgres.write(t, {}, "tbl")),
    ("pymongo", lambda pw, t: pw.io.mongodb.write(t, "mongodb://x", "db", "coll")),
    ("office365", lambda pw, t: pw.io.sharepoint.read("https://x.sharepoint.com/sites/s", root_path="Docs",
                                                      client_id="i", client_secret="s")),
    ("boto3", lambda pw, t: pw.io.s3.read("s3://b/p", format="csv", schema=t.schema)),
    ("nats", lambda pw, t: pw.io.nats.write(t, "nats://h", "out")),
    ("deltalake", lambda pw, t: pw.io.deltalake.write(t, "dl://x")),
    ("googleapiclient", lambda pw, t: pw.io.gdrive.read("f", service_user_credentials_file="c")),
])
def test_gated_connectors_raise_the_same_import_error(monkeypatch, client, call):
    """Without the client library each call raises the reference's
    ``ImportError`` text, word for word."""
    for name in (client, "confluent_kafka", "psycopg"):
        monkeypatch.setitem(sys.modules, name, None)
    texts = []
    for pw in PACKAGES:
        pw.reset()
        t = pw.debug.table_from_markdown(
            """
            x
            1
            """
        )
        with pytest.raises(ImportError) as err:
            call(pw, t)
        texts.append(str(err.value))
    assert _same(*texts).startswith("pw.io.")


# ---------------------------------------------------------------- the Kafka ETL template


def _kafka_etl_module(pw):
    """``templates/kafka_etl.py`` with its ``import pathway_tpu as pw``
    bound to ``pw``."""
    path = os.path.join(REPO_ROOT, "templates", "kafka_etl.py")
    with open(path) as f:
        source = f.read()
    line = "import pathway_tpu as pw\n"
    assert source.count(line) == 1
    mod = types.ModuleType("kafka_etl")
    mod.__file__ = path
    exec(compile(source.replace(line, f"import {pw.__name__} as pw\n"), path, "exec"), mod.__dict__)
    return mod


def test_kafka_etl_template_on_the_port_equals_the_reference(monkeypatch):
    """The reference's kafka-etl test (``tests/test_templates.py``): two
    topics in different time zones unify into one epoch-stamped stream,
    loaded back to kafka, over the fake client; the port's messages are
    the reference's, tick for tick.

    Each topic is read on a thread of its own, so which tick a message
    lands in is thread timing: under load one package put both messages
    in one tick and the other in two.  The feed is made deterministic:
    the engine's first tick waits until both consumers have delivered
    (a pre-run hook after the sources' own), so both messages land in
    the first tick in both packages."""
    fed = threading.Semaphore(0)
    topics = {
        "timezone1": [_Msg(json.dumps({"date": "2024-02-05 10:01:52.884548 -0500", "message": "NYC event"}).encode(),
                           0, 0)],
        "timezone2": [_Msg(json.dumps({"date": "2024-02-05 16:01:52.884548 +0100",
                                       "message": "Paris event"}).encode(), 0, 0)],
    }

    class FakeConsumer:
        def __init__(self, topic, **kw):
            self._msgs = topics[topic]

        def __iter__(self):
            yield from self._msgs
            fed.release()  # resumed after the reader inserted the last message

    def all_fed():
        for _topic in topics:
            assert fed.acquire(timeout=60), "a fake consumer did not deliver"

    def scenario(pw):
        sent = []

        class FakeProducer:
            def __init__(self, **kw):
                pass

            def send(self, topic, payload):
                sent.append((topic, json.loads(payload)))

            def flush(self):
                pass

        monkeypatch.setitem(sys.modules, "kafka", _module("kafka", KafkaConsumer=FakeConsumer,
                                                          KafkaProducer=FakeProducer))
        _kafka_etl_module(pw).build({"bootstrap.servers": "broker:9092", "group.id": "g"}, "timezone1", "timezone2",
                                    "unified")
        importlib.import_module(pw.__name__ + ".internals.parse_graph").G.pre_run_hooks.append(all_fed)
        pw.run(monitoring_level=None, commit_duration_ms=50)
        return sorted(((t, sorted(p.items())) for t, p in _ticked(sent)), key=repr)

    ref, port = _both(scenario)
    out = [dict(p) for t, p in _same(ref, port) if t == "unified"]
    assert len(out) == 2 and all(p["timestamp"] == pytest.approx(1707145312884.548) for p in out)
    assert {p["message"] for p in out} == {"NYC event", "Paris event"}


# ---------------------------------------------------------------- kafka over two ranks


@pytest.mark.parametrize("mode", ["partitioned", "replicated"])
def test_kafka_over_two_ranks_equals_one_process(monkeypatch, mode):
    """``pw.io.kafka.read`` over two CPU ranks: with a ``group.id`` each
    rank's consumer gets its own partitions (``partitioned``), without
    one both read every partition and each keeps its owned keys
    (``replicated``).  The rows, their keys and the per-word reduce
    gathered from the ranks equal one process of the port and of the
    reference over the same messages."""
    monkeypatch.setitem(sys.modules, "kafka", fake_kafka_module())

    def scenario(pw):
        events, counts = kafka_pipeline(pw, KAFKA_SETTINGS[mode])
        rows, totals = _events(pw, events), _events(pw, counts)
        _run(pw)
        return ([[k, *r] for k, r in _final(rows)], sorted(list(r) for _k, r in _final(totals)))

    ref, port = _both(scenario)
    rows, totals = _same(ref, port)
    assert len(rows) == 48
    ranks = _spawn(f"kafka_{mode}")
    for r, got in enumerate(ranks):
        assert got["proc"] == r and got["dist_mode"] == mode
        assert got["rows"] == rows and got["totals"] == totals
    assert sum(got["local_rows"] for got in ranks) == 48 and all(got["local_rows"] < 48 for got in ranks)


# ---------------------------------------------------------------- refused options


_TABLE_MD = """
    k | v
    a | 1
    """


class Anything:
    """An inert client object: every attribute, call, item and iteration
    answers another (or nothing)."""

    def __init__(self, *a, **k):
        pass

    def __getattr__(self, name):
        return Anything()

    def __call__(self, *a, **k):
        return Anything()

    def __getitem__(self, key):
        return Anything()

    def __iter__(self):
        return iter(())


def _fake_clients(monkeypatch):
    """Every client a refused call could reach, as an inert fake: the
    reference's call then succeeds, so the port's raise is the only
    difference."""

    async def connect(*a, **k):
        return Anything()

    for name in ("kafka", "boto3", "deltalake", "psycopg2", "pymongo", "googleapiclient", "office365"):
        monkeypatch.setitem(sys.modules, name, _module(name, KafkaConsumer=Anything, KafkaProducer=Anything,
                                                       client=Anything, connect=Anything, MongoClient=Anything,
                                                       DeltaTable=Anything, write_deltalake=Anything))
    monkeypatch.setitem(sys.modules, "nats", _module("nats", connect=connect))
    monkeypatch.setitem(sys.modules, "pyarrow", _module("pyarrow", Table=Anything))


_REFUSED = {
    "kafka.read(**kwargs)": lambda pw, t, S: pw.io.kafka.read({}, "t", schema=S, start_from_timestamp_ms=5),
    "kafka.write(format=raw)": lambda pw, t, S: pw.io.kafka.write(t, {}, "t", format="raw"),
    "kafka.write(**kwargs)": lambda pw, t, S: pw.io.kafka.write(t, {}, "t", key=t.k),
    "debezium.read(**kwargs)": lambda pw, t, S: pw.io.debezium.read({}, "t", schema=S, db_type="mongodb"),
    "debezium.read(two transports)": lambda pw, t, S: pw.io.debezium.read({}, "t", schema=S, input_dir="/nonexistent"),
    "debezium.read(kafka, static)": lambda pw, t, S: pw.io.debezium.read({}, "t", schema=S, mode="static"),
    "s3.read(**kwargs)": lambda pw, t, S: pw.io.s3.read("s3://b/p", schema=S, with_metadata=True),
    "deltalake.read(**kwargs)": lambda pw, t, S: pw.io.deltalake.read("dl://x", schema=S, start_from_timestamp_ms=1),
    "deltalake.write(min_commit_frequency)": lambda pw, t, S: pw.io.deltalake.write(t, "dl://x",
                                                                                     min_commit_frequency=1000),
    "postgres.write(**kwargs)": lambda pw, t, S: pw.io.postgres.write(t, {}, "tbl", max_batch_size=10),
    "postgres.write_snapshot(**kwargs)": lambda pw, t, S: pw.io.postgres.write_snapshot(t, {}, "tbl", ["k"],
                                                                                       init_mode="create_if_not_exists"),
    "mongodb.write(**kwargs)": lambda pw, t, S: pw.io.mongodb.write(t, "mongodb://x", "db", "c", name="m"),
    "elasticsearch.write(**kwargs)": lambda pw, t, S: pw.io.elasticsearch.write(t, "http://es", index_name="i",
                                                                                name="e"),
    "elasticsearch auth kind": lambda pw, t, S: pw.io.elasticsearch.ElasticSearchAuth("bearer", token="x"),
    "nats.read(**kwargs)": lambda pw, t, S: pw.io.nats.read("nats://h", "t", schema=S, autocommit_duration_ms=5),
    "nats.write(format=plaintext)": lambda pw, t, S: pw.io.nats.write(t, "nats://h", "t", format="plaintext"),
    "pubsub.write(**kwargs)": lambda pw, t, S: pw.io.pubsub.write(t, Anything(), "p", "t", name="ps"),
    "logstash.write(**kwargs)": lambda pw, t, S: pw.io.logstash.write(t, "http://ls", retry_policy=None),
    "gdrive.read(with_metadata)": lambda pw, t, S: pw.io.gdrive.read("f", service_user_credentials_file="c",
                                                                     with_metadata=True),
    "sharepoint.read(**kwargs)": lambda pw, t, S: pw.io.sharepoint.read("https://x", root_path="d", client_id="i",
                                                                        client_secret="s", object_size_limit=5),
    "pyfilesystem.read(**kwargs)": lambda pw, t, S: pw.io.pyfilesystem.read(_FakeFS({}), mode="static",
                                                                            max_backlog_size=5),
    "airbyte.read(env_vars with exec_command)": lambda pw, t, S: pw.io.airbyte.read(
        config={}, streams=["s"], exec_command="x", env_vars={"A": "1"}),
    "airbyte.read(**kwargs)": lambda pw, t, S: pw.io.airbyte.read(config={}, streams=["s"], exec_command="x",
                                                                  enforce_method="venv"),
}


@pytest.mark.parametrize("what", sorted(_REFUSED))
def test_options_the_reference_drops_are_refused(monkeypatch, what):
    """The reference accepts the option and does nothing with it; the port
    raises naming it (``ROADMAP.md``, Reference caveats)."""
    _fake_clients(monkeypatch)
    outcomes = []
    for pw in PACKAGES:
        pw.reset()
        t = pw.debug.table_from_markdown(_TABLE_MD)
        try:
            _REFUSED[what](pw, t, t.schema)
            outcomes.append(None)
        except (TypeError, ValueError) as exc:
            outcomes.append(str(exc))
    ref, port = outcomes
    assert ref is None, ref
    assert port is not None and ("not supported" in port or "unexpected keyword" in port), port


# ---------------------------------------------------------------- the card run's phase, on the CPU


def test_chip_smoke_connectors_phase_on_the_cpu():
    """``chip_smoke.py`` phase 25 (a CDC feed into a live vector index over
    the fake bucket, broker, database and tracer) at 1,024 documents with a
    small f32 embedder on the CPU: the phase raises on any failed check
    (answers against an exact search over the alive documents, no deleted
    document, the index's rows after each commit, Kafka and Postgres
    against a plain loop, the ``pathway.run`` span), and restores
    ``sys.modules`` and the monitoring endpoint after."""
    import importlib.util

    import torch

    from pathway_tpu_torch.xpacks.llm.embedders import TpuEmbedder

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO_ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    before = {name: sys.modules.get(name) for name in ("kafka", "boto3", "psycopg2", "opentelemetry")}
    endpoint = pathway_tpu_torch.get_config().monitoring_server
    emb = TpuEmbedder(dimension=64, n_layers=1, n_heads=4, max_length=64, vocab_size=32768, seed=0,
                      dtype=torch.float32, device="cpu")
    launches, shape = chip_smoke.connectors_phase("[cpu]", dev=torch.device("cpu"), emb=emb,
                                                  docs=chip_smoke.corpus(1024))
    assert (launches, shape) == (0, None)  # the rescore's plain version on the CPU
    assert {name: sys.modules.get(name) for name in before} == before
    assert pathway_tpu_torch.get_config().monitoring_server == endpoint
