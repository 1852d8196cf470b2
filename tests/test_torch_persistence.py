"""Engine persistence of the port (``pathway_tpu_torch/persistence``,
``pw.run(persistence_config=...)``) against the reference's, on the same
files under ``tmp_path``: the counterparts of ``tests/test_persistence.py``
run in both packages and must give the same update streams, the same
final states and the same store keys; a store written by either package
restores in the other for a pipeline of plain types (str / int / float /
tuple), key for key; no snapshot holds a torch tensor.
"""

import gc
import io
import logging
import os
import pickle

import numpy as np
import pytest
import torch

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.io import _connector as ref_connector
from pathway_tpu_torch.io import _connector as port_connector

PKGS = {"ref": pathway_tpu, "port": pathway_tpu_torch}


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setattr(ref_connector, "_source_counter", [0])
    monkeypatch.setattr(port_connector, "_source_counter", [0])
    pathway_tpu.reset()
    pathway_tpu_torch.reset()
    yield
    pathway_tpu.reset()
    pathway_tpu_torch.reset()
    # the connector monitor registries are WeakSets whose members sit in
    # reference cycles: collect them, so a later test reads only its own
    gc.collect()


def _write_csv(path, rows, header="k,v"):
    with open(path, "w") as f:
        f.write(header + "\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")


def _kv(pw):
    class KV(pw.Schema):
        k: str
        v: int

    return KV


def _config(pw, backend, mode=None, interval=1):
    extra = {} if mode is None else {"persistence_mode": getattr(pw.persistence.PersistenceMode, mode)}
    return pw.persistence.Config.simple_config(backend, snapshot_interval_ms=interval, **extra)


def _collect(pw, table):
    events = []
    names = list(table.column_names)

    def on_change(key, row, time, is_addition):
        events.append((int(key), tuple(_plain(row[c]) for c in names), 1 if is_addition else -1))

    pw.io.subscribe(table, on_change=on_change)
    return events


def _plain(v):
    return v.item() if isinstance(v, np.generic) else v


def _final(events):
    state = {}
    for key, row, diff in events:
        if diff > 0:
            state[key] = row
        elif state.get(key) == row:
            del state[key]
    return state


def _wordcount(pw, path, pid, backend, mode=None):
    t = pw.io.csv.read(path, schema=_kv(pw), mode="static", persistent_id=pid)
    counts = t.groupby(pw.this.k).reduce(k=pw.this.k, total=pw.reducers.sum(pw.this.v))
    events = _collect(pw, counts)
    pw.run(persistence_config=_config(pw, backend, mode))
    return events


def _both(fn):
    """``fn(side, pw)`` in each package, fresh graphs between; returns
    {side: result}."""
    out = {}
    for side, pw in PKGS.items():
        pw.reset()
        out[side] = fn(side, pw)
        pw.reset()
    return out


def test_input_snapshot_replay_survives_source_loss(tmp_path):
    """After a recorded run the pipeline reproduces its output although the
    source file is gone: the input log replays, in both packages alike."""

    def go(side, pw):
        backend = pw.persistence.Backend.filesystem(str(tmp_path / side / "snap"))
        src = tmp_path / side / "data.csv"
        src.parent.mkdir()
        _write_csv(src, [("a", 1), ("b", 2), ("a", 3)])
        out1 = _wordcount(pw, str(src), "wc", backend)
        os.remove(src)
        pw.reset()
        out2 = _wordcount(pw, str(src), "wc", backend)
        return _final(out1), _final(out2)

    got = _both(go)
    assert got["port"] == got["ref"]
    first, second = got["port"]
    assert first == second
    assert sorted(first.values()) == [("a", 4), ("b", 2)]


def test_resume_skips_ingested_files_and_reads_new(tmp_path):
    """The second run replays run 1's input, seeks past the file it read and
    ingests only the new file: each row once."""

    def go(side, pw):
        backend = pw.persistence.Backend.filesystem(str(tmp_path / side / "snap"))
        d = tmp_path / side / "in"
        d.mkdir(parents=True)
        _write_csv(d / "one.csv", [("a", 1), ("b", 2)])
        out1 = _wordcount(pw, str(d), "wc2", backend)
        pw.reset()
        _write_csv(d / "two.csv", [("a", 10)])
        out2 = _wordcount(pw, str(d), "wc2", backend)
        return out1, out2

    got = _both(go)
    assert got["port"] == got["ref"]
    out1, out2 = got["port"]
    assert sorted(_final(out1).values()) == [("a", 1), ("b", 2)]
    assert sorted(_final(out2).values()) == [("a", 11), ("b", 2)]


def _op_pipeline(pw, kind, d):
    KV = _kv(pw)
    t = pw.io.csv.read(str(d / "left"), schema=KV, mode="static", persistent_id="left")
    if kind == "groupby":
        return t.groupby(pw.this.k).reduce(k=pw.this.k, total=pw.reducers.sum(pw.this.v))
    if kind == "join":
        r = pw.io.csv.read(str(d / "right"), schema=KV, mode="static", persistent_id="right")
        return t.join(r, pw.left.k == pw.right.k).select(k=pw.left.k, lv=pw.left.v, rv=pw.right.v)
    if kind == "dedupe":
        return t.deduplicate(value=pw.this.v, instance=pw.this.k, acceptor=lambda new, old: new > old)
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["groupby", "join", "dedupe"])
def test_operator_persisting_mode(tmp_path, kind):
    """OPERATOR_PERSISTING restores the operator's state (reducers, join
    sides, the deduplicate's kept values) and the table stores instead of
    replaying the input; a new file folds into the restored state, in both
    packages alike, and the input log is dropped after each commit."""

    def go(side, pw):
        root = tmp_path / side
        for sub in ("left", "right"):
            (root / sub).mkdir(parents=True)
        _write_csv(root / "left" / "one.csv", [("a", 1), ("b", 2)])
        _write_csv(root / "right" / "one.csv", [("a", 7), ("b", 8)])
        backend = pw.persistence.Backend.filesystem(str(root / "snap"))
        runs = []
        for extra in (None, [("b", 5), ("c", 3)]):
            pw.reset()
            if extra is not None:
                _write_csv(root / "left" / "two.csv", extra)
                _write_csv(root / "right" / "two.csv", [("c", 9)])
            out = _op_pipeline(pw, kind, root)
            events = _collect(pw, out)
            pw.run(persistence_config=_config(pw, backend, "OPERATOR_PERSISTING"))
            runs.append(events)
        chunks = [k for k in backend.make_store().list_keys() if "/chunk-" in k]
        return runs, chunks

    got = _both(go)
    assert got["port"] == got["ref"]
    (run1, run2), chunks = got["port"]
    assert chunks == []  # the operator snapshots cover the frontier: the log is dropped
    state = _final(run1)
    assert state
    for key, row, diff in run2:  # the restored state is not emitted again
        assert (key, row) not in state.items() or diff < 0
    state.update(_final([e for e in run2 if e[2] > 0]))
    if kind == "groupby":
        assert sorted(state.values()) == [("a", 1), ("b", 7), ("c", 3)]
    elif kind == "join":
        assert sorted(state.values()) == [("a", 1, 7), ("b", 2, 8), ("b", 5, 8), ("c", 3, 9)]
    else:
        assert sorted(state.values()) == [("a", 1), ("b", 5), ("c", 3)]


def test_memory_backend_roundtrip():
    from pathway_tpu_torch.persistence.backends import MemoryBackend

    b = MemoryBackend()
    b.put("sources/x/chunk-00000000", b"abc")
    b.put("sources/x/METADATA", b"meta")
    assert b.get("sources/x/chunk-00000000") == b"abc"
    assert b.list_keys("sources/x/") == ["sources/x/METADATA", "sources/x/chunk-00000000"]
    b.delete("sources/x/METADATA")
    assert b.get("sources/x/METADATA") is None


def _source_persistence(side):
    if side == "ref":
        from pathway_tpu.persistence.backends import MemoryBackend
        from pathway_tpu.persistence.engine_state import SourcePersistence
    else:
        from pathway_tpu_torch.persistence.backends import MemoryBackend
        from pathway_tpu_torch.persistence.engine_state import SourcePersistence
    return MemoryBackend, SourcePersistence


def _store(backend):
    return {k: backend.get(k) for k in backend.list_keys()}


def test_corrupt_chunk_rewinds_log_for_future_flushes():
    """A torn chunk truncates replay and rewinds the log (and the offsets),
    so chunks flushed after the recovery stay reachable; both packages
    leave the same bytes under the same keys."""
    stores = {}
    for side in PKGS:
        MemoryBackend, SourcePersistence = _source_persistence(side)
        backend = MemoryBackend()
        sp = SourcePersistence(backend, "pid")
        sp.record((1, 1, ("a",)))
        sp.save_offsets({"f": 1.0})
        sp.flush(2)
        sp.record((2, 1, ("b",)))
        sp.save_offsets({"f": 2.0})
        sp.flush(4)
        key = "sources/pid/chunk-00000001"
        blob = backend.get(key)
        backend.put(key, blob[: len(blob) - 3])
        sp2 = SourcePersistence(backend, "pid")
        assert sp2.replay_events() == [(1, 1, ("a",))]
        assert sp2.offsets() == {"f": 1.0}  # rewound with the log
        sp2.record((3, 1, ("c",)))
        sp2.flush(6)
        sp3 = SourcePersistence(backend, "pid")
        assert sp3.replay_events() == [(1, 1, ("a",)), (3, 1, ("c",))]
        stores[side] = _store(backend)
    assert stores["port"] == stores["ref"]


def test_atomic_batch_source_replays_with_markers():
    """Batch markers persist with the event log, so an atomic source replays
    with its batch boundaries (the same ticks' groupings in both packages)
    instead of never draining."""

    def go(side, pw):
        S = pw.schema_from_types(v=int)
        backend = pw.persistence.Backend.mock()
        runs = []
        for send in (True, False):  # the restart's subject sends nothing
            pw.reset()

            class Subj(pw.io.python.ConnectorSubject):
                def run(self):
                    if send:
                        self.next(v=1)
                        self.next(v=2)
                        self.commit()
                        self.next(v=3)
                        self.commit()

            t = pw.io.python.read(Subj(), schema=S, atomic_batches=True)
            for op in pw.G.engine_graph.operators:
                if getattr(op, "writer", None) is not None:
                    op.persistent_id = "atomic1"
            events = []
            pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: events.append((time, row["v"])))
            pw.run(persistence_config=_config(pw, backend))
            batches = {}
            for time_, v in events:
                batches.setdefault(time_, []).append(int(v))
            runs.append(sorted(sorted(b) for b in batches.values()))
        return runs

    got = _both(go)
    assert got["port"] == got["ref"] == [[[1, 2], [3]], [[1, 2], [3]]]


def test_chunk_log_compaction_bounds_file_count():
    """Many flushes keep the chunk-file count bounded (tiered compaction),
    replay yields every event in order, and both packages compact to the
    same keys and bytes."""
    stores = {}
    for side in PKGS:
        MemoryBackend, SourcePersistence = _source_persistence(side)
        backend = MemoryBackend()
        sp = SourcePersistence(backend, "src")
        n_flushes = SourcePersistence.COMPACT_AFTER + 20
        for i in range(n_flushes):
            sp.record(("insert", i))
            sp.save_offsets({"pos": i})
            sp.flush(frontier=i * 2)
        chunk_files = [k for k in backend.list_keys("sources/src/") if "chunk-" in k]
        assert len(chunk_files) <= SourcePersistence.COMPACT_AFTER + 1
        sp2 = SourcePersistence(backend, "src")
        assert sp2.replay_events() == [("insert", i) for i in range(n_flushes)]
        assert sp2.offsets() == {"pos": n_flushes - 1}
        stores[side] = _store(backend)
    assert stores["port"] == stores["ref"]


def test_drop_log_removes_chunks():
    for side in PKGS:
        MemoryBackend, SourcePersistence = _source_persistence(side)
        backend = MemoryBackend()
        sp = SourcePersistence(backend, "src")
        for i in range(5):
            sp.record(("insert", i))
            sp.flush(frontier=i)
        sp.drop_log()
        assert not [k for k in backend.list_keys("sources/src/") if "chunk-" in k]
        assert SourcePersistence(backend, "src").replay_events() == []


def test_cached_object_storage_roundtrip_and_versioning():
    """Versioned get-or-compute: a second lookup hits, a new version
    recomputes; the blob keys are the reference's (same digests), and a
    torch value is stored as a numpy array."""
    from pathway_tpu.persistence.backends import MemoryBackend as RefMemoryBackend
    from pathway_tpu.persistence.object_cache import CachedObjectStorage as RefCache
    from pathway_tpu_torch.persistence import CachedObjectStorage
    from pathway_tpu_torch.persistence.backends import MemoryBackend

    backend = MemoryBackend()
    cache = CachedObjectStorage(backend)
    calls = []

    def compute():
        calls.append(1)
        return {"parsed": [1, 2, 3]}

    v1 = cache.get_or_compute(("a.pdf",), compute, version=100)
    v2 = cache.get_or_compute(("a.pdf",), compute, version=100)
    assert v1 == v2 == {"parsed": [1, 2, 3]}
    assert len(calls) == 1, "second lookup must hit the cache"
    cache.get_or_compute(("a.pdf",), compute, version=200)
    assert len(calls) == 2
    ref_backend = RefMemoryBackend()
    ref = RefCache(ref_backend)
    ref.get_or_compute(("a.pdf",), compute, version=100)
    ref.get_or_compute(("a.pdf",), compute, version=200)
    assert _store(backend) == _store(ref_backend)
    assert cache.contains(("a.pdf",), version=100)
    cache.invalidate(("a.pdf",), version=100)
    assert not cache.contains(("a.pdf",), version=100)
    cache.put("emb", torch.arange(3, dtype=torch.float32))
    stored = cache.get("emb")
    assert isinstance(stored, np.ndarray) and stored.tolist() == [0.0, 1.0, 2.0]
    cache.clear()
    assert not cache.contains(("a.pdf",), version=200)


def test_operator_persisting_drops_input_log(tmp_path):
    """After an operator snapshot covers the frontier, the input log is
    truncated: OPERATOR_PERSISTING stays byte-bounded on long jobs."""
    pw = pathway_tpu_torch
    from pathway_tpu_torch.engine.executor import Executor
    from pathway_tpu_torch.engine.operators.io import InputSession, SourceOperator
    from pathway_tpu_torch.internals import dtype as dt
    from pathway_tpu_torch.internals.keys import ref_scalar
    from pathway_tpu_torch.internals.table import Table
    from pathway_tpu_torch.internals.universe import Universe
    from pathway_tpu_torch.persistence.backends import MemoryBackend
    from pathway_tpu_torch.persistence.engine_state import PersistenceManager

    backend = MemoryBackend()
    session = InputSession(upsert=True)
    et = pw.G.engine_graph.add_table(["word"], "s")
    src = SourceOperator(et, session, {"word": dt.wrap(str)}, name="s")
    src.persistent_id = "s"
    pw.G.engine_graph.add_operator(src)
    t = Table(et, {"word": dt.wrap(str)}, Universe(), short_name="s")
    t.groupby(pw.this.word).reduce(word=pw.this.word, c=pw.reducers.count())
    cfg = pw.persistence.Config.simple_config(
        pw.persistence.Backend.filesystem(str(tmp_path)),
        persistence_mode=pw.persistence.PersistenceMode.OPERATOR_PERSISTING,
    )
    manager = PersistenceManager(cfg)
    manager.backend = backend
    manager.attach(pw.G.engine_graph)
    ex = Executor(pw.G.engine_graph)
    pw.G.engine_graph.finalize()
    session.insert(int(ref_scalar(1)), ("alpha",))
    ex.step()
    manager.commit(ts=1000)
    assert not [k for k in backend.list_keys("sources/s/") if "chunk-" in k]
    assert pickle.loads(backend.get("COMMIT")) == {"frontier": 1000, "ops": True, "format": 2}


@pytest.mark.parametrize("mode", ["PERSISTING", "OPERATOR_PERSISTING"])
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")], ids=["ref_to_port", "port_to_ref"])
def test_snapshots_restore_across_packages(tmp_path, mode, writer, reader):
    """A store written by one package restores in the other: run 1 in the
    writer, run 2 (a new file added) in the reader over the same store,
    gives what two runs of one package give, key for key.  The pipeline is
    of plain types: str, int, float and a tuple column."""

    def pipeline(pw, d):
        t = pw.io.csv.read(str(d), schema=_kv(pw), mode="static", persistent_id="x")
        g = t.groupby(pw.this.k).reduce(k=pw.this.k, total=pw.reducers.sum(pw.this.v),
                                        vs=pw.reducers.sorted_tuple(pw.this.v))
        return g.select(pw.this.k, pw.this.total, pw.this.vs, half=pw.this.total / 2.0)

    def two_runs(sides, root):
        d = root / "in"
        d.mkdir(parents=True)
        _write_csv(d / "one.csv", [("a", 1), ("b", 2), ("a", 4)])
        backend_path = str(root / "snap")
        runs = []
        for i, side in enumerate(sides):
            pw = PKGS[side]
            pw.reset()
            if i == 1:
                _write_csv(d / "two.csv", [("b", 10), ("c", 3)])
            out = pipeline(pw, d)
            events = _collect(pw, out)
            pw.run(persistence_config=_config(pw, pw.persistence.Backend.filesystem(backend_path), mode))
            pw.reset()
            runs.append(events)
        return runs, sorted(os.path.relpath(os.path.join(p, f), backend_path)
                            for p, _d, fs in os.walk(backend_path) for f in fs)

    crossed, crossed_keys = two_runs((writer, reader), tmp_path / "crossed")
    alone, alone_keys = two_runs((reader, reader), tmp_path / "alone")
    assert crossed == alone
    assert crossed_keys == alone_keys
    state = _final(crossed[0])
    state.update(_final([e for e in crossed[1] if e[2] > 0]))
    assert sorted(state.values()) == [("a", 5, (1, 4), 2.5), ("b", 12, (2, 10), 6.0), ("c", 3, (3,), 1.5)]


def _persistence_manager(side):
    if side == "ref":
        from pathway_tpu.persistence import engine_state
    else:
        from pathway_tpu_torch.persistence import engine_state
    return engine_state


@pytest.mark.parametrize("side", list(PKGS))
def test_snapshot_format_mismatch_falls_back_to_input_replay(tmp_path, side, caplog):
    """An operator snapshot of another format is ignored and logged; its
    commits dropped the input log, so the offsets are reset (logged too)
    and the source is re-ingested in full: the same answer as run 1."""
    pw = PKGS[side]
    d = tmp_path / "in"
    d.mkdir()
    _write_csv(d / "one.csv", [("a", 1), ("b", 2)])
    backend = pw.persistence.Backend.filesystem(str(tmp_path / "snap"))
    _wordcount(pw, str(d), "wc", backend, mode="OPERATOR_PERSISTING")
    store = backend.make_store()
    commit = pickle.loads(store.get("COMMIT"))
    assert commit["ops"] and not [k for k in store.list_keys() if "/chunk-" in k]
    store.put("COMMIT", pickle.dumps({**commit, "format": 1}))
    pw.reset()
    with caplog.at_level(logging.WARNING):
        out = _wordcount(pw, str(d), "wc", backend, mode="OPERATOR_PERSISTING")
    assert "operator snapshot format 1 != current 2" in caplog.text
    assert "resetting source offsets" in caplog.text
    assert sorted(_final(out).values()) == [("a", 1), ("b", 2)]


@pytest.mark.parametrize("side", list(PKGS))
def test_dropped_log_without_operator_snapshots_reingests(tmp_path, side, caplog):
    """OPERATOR_PERSISTING commits drop the input log; a restart that cannot
    use the operator snapshots (here: the mode switched back to PERSISTING)
    resets the offsets, logged, and re-ingests the source in full."""
    pw = PKGS[side]
    d = tmp_path / "in"
    d.mkdir()
    _write_csv(d / "one.csv", [("a", 1), ("b", 2)])
    backend = pw.persistence.Backend.filesystem(str(tmp_path / "snap"))
    _wordcount(pw, str(d), "wc", backend, mode="OPERATOR_PERSISTING")
    pw.reset()
    with caplog.at_level(logging.WARNING):
        out = _wordcount(pw, str(d), "wc", backend)
    assert "resetting source offsets for a full re-ingest" in caplog.text
    assert sorted(_final(out).values()) == [("a", 1), ("b", 2)]


def test_persistence_config_from_env():
    """``PATHWAY_PERSISTENT_STORAGE`` / ``PATHWAY_PERSISTENCE_MODE`` /
    ``PATHWAY_SNAPSHOT_INTERVAL_MS`` (the process config) give the same
    config in both packages; an empty storage gives none."""
    from pathway_tpu.internals import run as ref_run
    from pathway_tpu.internals.config import local_config as ref_local
    from pathway_tpu_torch.internals import run as port_run
    from pathway_tpu_torch.internals.config import local_config as port_local

    for raw in ("", "speedrun", "OPERATOR_PERSISTING", "batch", "bogus"):
        got = []
        for run_mod, local in ((ref_run, ref_local), (port_run, port_local)):
            with local(persistent_storage="/state", persistence_mode=raw, snapshot_interval_ms=250):
                cfg = run_mod._persistence_config_from_env()
            got.append((cfg.backend.kind, cfg.backend.path, cfg.persistence_mode.name, cfg.snapshot_interval_ms))
        assert got[0] == got[1], raw
    for run_mod, local in ((ref_run, ref_local), (port_run, port_local)):
        with local(persistent_storage=None):
            assert run_mod._persistence_config_from_env() is None


class _FakeS3:
    """A dict-backed stand-in for boto3's S3 client: the calls S3Backend
    makes, with ``NoSuchKey`` on a missing object and two-key pages."""

    class exceptions:
        class NoSuchKey(Exception):
            pass

    def __init__(self):
        self.objects = {}
        self.fail_puts = 0

    def get_object(self, Bucket, Key):
        if (Bucket, Key) not in self.objects:
            raise self.exceptions.NoSuchKey(Key)
        return {"Body": io.BytesIO(self.objects[(Bucket, Key)])}

    def put_object(self, Bucket, Key, Body):
        if self.fail_puts:
            self.fail_puts -= 1
            raise ConnectionError("transient")
        self.objects[(Bucket, Key)] = bytes(Body)

    def delete_object(self, Bucket, Key):
        self.objects.pop((Bucket, Key), None)

    def get_paginator(self, name):
        assert name == "list_objects_v2"
        store = self

        class Paginator:
            def paginate(self, Bucket, Prefix):
                keys = sorted(k for b, k in store.objects if b == Bucket and k.startswith(Prefix))
                for i in range(0, len(keys), 2):
                    yield {"Contents": [{"Key": k} for k in keys[i : i + 2]]}

        return Paginator()


def test_s3_backend_over_a_fake_client(monkeypatch):
    """``S3Backend`` with an injected client: get / put / delete / list under
    the root path, a transient put retried; the source log through it
    replays.  Without a client it raises the reference's ``ImportError``
    (boto3 is not installed)."""
    from pathway_tpu_torch.persistence import S3Backend
    from pathway_tpu_torch.persistence.engine_state import SourcePersistence

    monkeypatch.setenv("PATHWAY_RETRY_BASE_MS", "0")
    client = _FakeS3()
    b = S3Backend(bucket="bkt", root_path="/jobs/1/", client=client)
    assert b.get("missing") is None
    client.fail_puts = 1
    b.put("sources/x/METADATA", b"meta")
    b.put("sources/x/chunk-00000000", b"abc")
    b.put("COMMIT", b"c")
    assert client.objects[("bkt", "jobs/1/COMMIT")] == b"c"
    assert b.list_keys("sources/") == ["sources/x/METADATA", "sources/x/chunk-00000000"]
    assert b.list_keys() == ["COMMIT", "sources/x/METADATA", "sources/x/chunk-00000000"]
    b.delete("COMMIT")
    assert b.get("COMMIT") is None
    sp = SourcePersistence(b, "y")
    sp.record((1, 1, ("a",)))
    sp.flush(5)
    assert SourcePersistence(b, "y").replay_events() == [(1, 1, ("a",))]
    with pytest.raises(ImportError, match="boto3"):
        S3Backend(bucket="bkt")


def test_snapshots_hold_no_torch_tensor(tmp_path):
    """Rows that carry torch tensors (a UDF's output) are snapshotted as
    numpy arrays: no pickle of the store names torch, and a restart
    restores from it."""
    pw = pathway_tpu_torch
    d = tmp_path / "in"
    d.mkdir()
    _write_csv(d / "one.csv", [("a", 1), ("b", 2), ("a", 3)])
    backend = pw.persistence.Backend.filesystem(str(tmp_path / "snap"))

    rows = []

    def run():
        pw.reset()
        t = pw.io.csv.read(str(d), schema=_kv(pw), mode="static", persistent_id="t")
        vec = t.select(pw.this.k, pw.this.v, emb=pw.apply(lambda v: torch.full((3,), float(v)), pw.this.v))
        counts = vec.groupby(pw.this.k).reduce(k=pw.this.k, n=pw.reducers.count(), total=pw.reducers.sum(pw.this.v))
        events = _collect(pw, counts)
        pw.io.subscribe(vec, on_change=lambda key, row, time, is_addition: rows.append(row["emb"]))
        pw.run(persistence_config=_config(pw, backend, "OPERATOR_PERSISTING"))
        return events

    run()
    store = backend.make_store()
    blobs = [store.get(k) for k in store.list_keys() if k.startswith(("operators/", "tables/"))]
    assert blobs and not [b for b in blobs if b"torch" in b]
    tensors = [v for b in blobs for v in _arrays(pickle.loads(b))]
    assert tensors and all(isinstance(v, np.ndarray) for v in tensors)
    assert all(isinstance(e, torch.Tensor) for e in rows)  # the run itself computed tensors
    _write_csv(d / "two.csv", [("b", 5)])
    out = run()
    (b_row,) = [row for _k, row, diff in out if diff > 0 and row[0] == "b"]
    assert b_row == ("b", 2, 7)


def _arrays(obj):
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _arrays(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _arrays(v)
