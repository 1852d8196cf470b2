"""``pw.export_table`` / ``pw.import_table`` of the port against the
reference.

The cases of ``tests/test_export_import.py`` (an aggregate handed from one
graph to a fresh one; an upsert whose retraction the importer replays) run
through both packages with equal results.  A seeded case drives an upsert
stream by hand, one executor step per commit, so every tick is
deterministic: the exported update streams of both packages (keys, rows,
diffs, tick by tick) must be equal, retractions included, and importing
each package's handle into a fresh graph of that package must end at the
same rows, which are the handle's snapshot.  Every value is an int or a
string, compared exactly.
"""

import importlib
import time

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.io import _connector as ref_connector
from pathway_tpu_torch.io import _connector as port_connector

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


def _keyed(table):
    keys, cols = table._materialize()
    return sorted((int(k), tuple(cols[n][i] for n in table.column_names)) for i, k in enumerate(keys))


def test_two_graphs_exchange_a_table_as_the_reference():
    got = []
    for pw in PACKAGES:
        t = pw.debug.table_from_markdown("""
        k | v
        a | 1
        a | 2
        b | 5
        """)
        agg = t.groupby(t.k).reduce(k=t.k, s=pw.reducers.sum(t.v))
        handle = pw.export_table(agg)
        pw.run(monitoring_level=None)
        assert handle.frontier > 0 and handle.closed
        snapshot = sorted(handle.snapshot())
        pw.reset()  # graph 2: a fresh graph imports the stream and keeps computing
        imported = pw.import_table(handle)
        doubled = imported.select(k=pw.this.k, d=pw.this.s * 2)
        pw.run(monitoring_level=None)
        got.append((snapshot, _keyed(doubled)))
    assert got[1] == got[0]
    snapshot, doubled = got[1]
    assert sorted(row for _key, row in snapshot) == [("a", 3), ("b", 5)]
    assert sorted(row for _key, row in doubled) == [("a", 6), ("b", 10)]
    assert [key for key, _row in doubled] == [key for key, _row in snapshot]


def test_import_replays_retractions_as_the_reference():
    got = []
    for pw in PACKAGES:

        class Row(pw.Schema):
            k: str = pw.column_definition(primary_key=True)
            v: int

        class Subj(pw.io.python.ConnectorSubject):
            def run(self):
                self.next(k="x", v=1)
                time.sleep(0.3)
                self.next(k="x", v=7)  # upsert: retract v=1, insert v=7

        src = pw.io.python.read(Subj(), schema=Row)
        handle = pw.export_table(src)
        pw.run(monitoring_level=None, commit_duration_ms=100)
        pw.reset()
        imported = pw.import_table(handle)
        pw.run(monitoring_level=None, commit_duration_ms=50)
        # the ticks follow thread timing: the snapshot and the final rows only
        got.append((sorted(handle.snapshot()), _keyed(imported)))
    assert got[1] == got[0]
    snapshot, imported = got[1]
    assert imported == snapshot
    assert [row for _key, row in imported] == [("x", 7)]


def _seeded_commits(n_commits=8, n_keys=6, seed=3):
    """Per commit, a list of (op, key, value): upserts and deletes."""
    rng = np.random.default_rng(seed)
    alive, commits = set(), []
    for _ in range(n_commits):
        ops = []
        for key in rng.choice(n_keys, size=3, replace=False):
            key = int(key)
            if key in alive and rng.random() < 0.3:
                ops.append(("delete", key, None))
                alive.discard(key)
            else:
                ops.append(("upsert", key, int(rng.integers(0, 100))))
                alive.add(key)
        commits.append(ops)
    return commits


def _exported_by_hand(pw, commits):
    """An upsert stream stepped once per commit into a per-parity sum;
    both are exported.  Returns the two handles."""
    base = pw.__name__
    Executor = importlib.import_module(f"{base}.engine.executor").Executor
    io = importlib.import_module(f"{base}.engine.operators.io")
    dt = importlib.import_module(f"{base}.internals.dtype")
    Table = importlib.import_module(f"{base}.internals.table").Table
    Universe = importlib.import_module(f"{base}.internals.universe").Universe
    ref_scalar = importlib.import_module(f"{base}.internals.keys").ref_scalar

    dtypes = {"k": dt.wrap(int), "v": dt.wrap(int)}
    session = io.InputSession(upsert=True)
    et = pw.G.engine_graph.add_table(["k", "v"], "stream")
    pw.G.engine_graph.add_operator(io.SourceOperator(et, session, dtypes, name="stream"))
    stream = Table(et, dtypes, Universe(), short_name="stream")
    with_parity = stream.select(pw.this.v, parity=pw.this.k % 2)
    sums = with_parity.groupby(pw.this.parity).reduce(pw.this.parity, s=pw.reducers.sum(pw.this.v))
    handles = (pw.export_table(stream), pw.export_table(sums))
    ex = Executor(pw.G.engine_graph)
    pw.G.engine_graph.finalize()
    for ops in commits:
        for op, key, value in ops:
            if op == "upsert":
                session.insert(int(ref_scalar(key)), (key, value))
            else:
                session.remove(int(ref_scalar(key)))
        ex.step()
    session.close()
    ex.run()  # the end of the run closes the handles
    return handles


def _ticks(handle):
    """The exported stream as one sorted list of (key, row, diff) per tick."""
    by_ts = {}
    for key, row, ts, diff in handle.events_since(0)[0]:
        by_ts.setdefault(ts, []).append((key, row, diff))
    return [sorted(by_ts[ts]) for ts in sorted(by_ts)]


def test_seeded_stream_exports_and_replays_the_reference_retractions():
    commits = _seeded_commits()
    got = []
    for pw in PACKAGES:
        handles = _exported_by_hand(pw, commits)
        assert all(h.closed for h in handles)
        exported = [_ticks(h) for h in handles]
        pw.reset()
        imported = [pw.import_table(h) for h in handles]
        pw.run(monitoring_level=None)
        got.append((exported, [_keyed(t) for t in imported], [sorted(h.snapshot()) for h in handles]))
    assert got[1] == got[0]
    exported, imported, snapshots = got[1]
    assert imported == snapshots
    # retractions rode the stream: deletes and upserts of live keys
    assert any(diff < 0 for tick in exported[0] for _k, _r, diff in tick)
    assert any(diff < 0 for tick in exported[1] for _k, _r, diff in tick)
    # a plain replay of the commits gives the final rows
    alive = {}
    for ops in commits:
        for op, key, value in ops:
            if op == "upsert":
                alive[key] = value
            else:
                alive.pop(key, None)
    assert sorted(row for _key, row in imported[0]) == sorted(alive.items())
    sums = {}
    for key, value in alive.items():
        sums[key % 2] = sums.get(key % 2, 0) + value
    assert sorted(row for _key, row in imported[1]) == sorted(sums.items())


def test_import_into_the_exporting_graph_raises_as_the_reference():
    for pw in PACKAGES:
        t = pw.debug.table_from_markdown("""
        k | v
        a | 1
        """)
        handle = pw.export_table(t)
        with pytest.raises(ValueError, match="CURRENT graph"):
            pw.import_table(handle)
        pw.reset()
        assert handle.closed  # reset closes every open handle
