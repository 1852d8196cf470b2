"""The rest of the port's stdlib retrieval against the reference, on the
same seeded inputs: BM25 (``stdlib/indexing/bm25.py``), the hybrid index
(``hybrid_index.py``, reciprocal rank fusion), the LSH index
(``stdlib/ml/_knn_lsh.py``), ``KNNIndex`` and ``knn_classifier``
(``stdlib/ml``), and a ``DataIndex`` under engine persistence restarted
in both packages.  The port's device indexes run on the CPU here
(``device="cpu"``), in f32 as the reference's.
"""

import gc

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.io import _connector as ref_connector
from pathway_tpu_torch.io import _connector as port_connector

PKGS = {"ref": pathway_tpu, "port": pathway_tpu_torch}
D = 12
TOL = 1e-5
WORDS = "cat dog bird fish lion tiger bear wolf fox deer owl hawk crow swan duck goose".split()


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setattr(ref_connector, "_source_counter", [0])
    monkeypatch.setattr(port_connector, "_source_counter", [0])
    pathway_tpu.reset()
    pathway_tpu_torch.reset()
    yield
    pathway_tpu.reset()
    pathway_tpu_torch.reset()
    gc.collect()  # connector monitors sit in reference cycles (see test_torch_io_fs.py)


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(3, 9)))) for _ in range(n)]


def _vectors(n, seed):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def _cpu(pw):
    return {"device": "cpu"} if pw is pathway_tpu_torch else {}


# -- BM25 --------------------------------------------------------------------------------


def test_bm25_scores_and_ranks_equal_the_reference():
    """Okapi BM25 over the same documents (with removals and a re-add):
    the same keys in the same order, scores equal to 1e-12 (in fact bit
    for bit), filters honoured alike."""
    from pathway_tpu.stdlib.indexing.bm25 import BM25Index as RefBM25
    from pathway_tpu_torch.stdlib.indexing.bm25 import BM25Index

    docs = _texts(120, 0)
    metas = [{"path": f"d{i % 3}/{i}.txt"} for i in range(len(docs))]
    queries = _texts(20, 1)
    filters = [None if i % 4 else "globmatch('d1/*', path)" for i in range(len(queries))]
    got = []
    for cls in (RefBM25, BM25Index):
        index = cls()
        index.add(list(range(len(docs))), docs, metas)
        index.remove([3, 7, 11])
        index.add([7], ["swan swan goose duck"], [{"path": "d1/7.txt"}])
        got.append(index.search(queries, 10, filters))
    for ref, port in zip(*got):
        assert [k for k, _ in port] == [k for k, _ in ref]
        np.testing.assert_allclose([s for _, s in port], [s for _, s in ref], rtol=0, atol=1e-12)
    assert got[1] == got[0]  # bit for bit: the reference's operations in the reference's order
    assert all(len(r) == 10 for r in got[1])


# -- hybrid ------------------------------------------------------------------------------


def _rrf(per_index, k, k_constant=60.0):
    fused = {}
    for rows in per_index:
        for rank, (key, _score) in enumerate(rows):
            fused[key] = fused.get(key, 0.0) + 1.0 / (k_constant + rank + 1)
    return sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:k]


@pytest.mark.parametrize("dense", ["brute", "ivf"])
def test_hybrid_fused_ranks_equal_the_reference(dense):
    """A hybrid of a dense index (exact, or IVF at full probe) and BM25 over
    ``(vector, text)`` rows: the fused lists equal the reference's, and each
    equals an RRF recomputed from the two sub-indexes' own searches at 2k."""
    docs, texts = _vectors(150, 2), _texts(150, 3)
    queries, qtexts = _vectors(16, 4), _texts(16, 5)
    got = {}
    for side, pw in PKGS.items():
        mod = pw.stdlib.indexing
        if dense == "brute":
            vec = mod.BruteForceKnnFactory(dimension=D, **_cpu(pw))
        else:
            vec = mod.IvfKnnFactory(dimension=D, n_clusters=4, n_probe=4, **_cpu(pw))
        hybrid = mod.HybridIndexFactory([vec, mod.TantivyBM25Factory()]).build_inner_index()
        keys = list(range(1000, 1150))
        hybrid.add(keys, list(zip(docs, texts)), [None] * len(keys))
        values = list(zip(queries, qtexts))
        fused = hybrid.search(values, 5, [None] * len(values))
        for i, row in enumerate(fused):
            subs = [index.search([v[j] for v in values[i : i + 1]], 10, [None])[0]
                    for j, index in enumerate(hybrid.indexes)]
            want = _rrf(subs, 5)
            assert [k for k, _ in row] == [k for k, _ in want]
            np.testing.assert_allclose([s for _, s in row], [s for _, s in want], atol=1e-12)
        got[side] = fused
    for ref, port in zip(got["ref"], got["port"]):
        assert [k for k, _ in port] == [k for k, _ in ref]
        np.testing.assert_allclose([s for _, s in port], [s for _, s in ref], atol=1e-12)


def test_hybrid_data_index_over_a_tuple_column_equals_the_reference():
    """Through the engine: a DataIndex whose data column is
    ``make_tuple(vector, text)`` over ``HybridIndexFactory``, queried by
    ``(vector, text)`` tuples, answers as the reference's."""
    docs, texts = _vectors(80, 6), _texts(80, 7)
    queries, qtexts = _vectors(10, 8), _texts(10, 9)
    got = {}
    for side, pw in PKGS.items():
        pw.reset()
        data = pw.debug.table_from_rows(pw.schema_from_types(name=str, vec=np.ndarray, text=str),
                                        [(f"n{i}", docs[i], texts[i]) for i in range(len(docs))])
        qs = pw.debug.table_from_rows(pw.schema_from_types(qv=np.ndarray, qt=str),
                                      [(queries[i], qtexts[i]) for i in range(len(queries))])
        data = data.with_columns(both=pw.make_tuple(pw.this.vec, pw.this.text))
        qs = qs.with_columns(both=pw.make_tuple(pw.this.qv, pw.this.qt))
        mod = pw.stdlib.indexing
        factory = mod.HybridIndexFactory([mod.BruteForceKnnFactory(dimension=D, **_cpu(pw)), mod.TantivyBM25Factory()])
        index = mod.DataIndex(data, mod.InnerIndex(data_column=data.both, factory=factory, dimension=D))
        res = index.query(qs.both, number_of_matches=4)
        out = res.select(qt=qs.qt, names=data.name, scores=res.score)
        pw.run(monitoring_level=None)
        keys, cols = out._materialize()
        got[side] = sorted((cols["qt"][i], tuple(cols["names"][i]), tuple(cols["scores"][i])) for i in range(len(keys)))
    assert len(got["port"]) == 10
    for (qt1, n1, s1), (qt2, n2, s2) in zip(got["ref"], got["port"]):
        assert (qt1, n1) == (qt2, n2)
        np.testing.assert_allclose(s2, s1, atol=1e-12)


# -- LSH, KNNIndex, knn_classifier ---------------------------------------------------------


@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_lsh_buckets_equal_the_reference_bit_for_bit(metric):
    """Same seed, same hyperplanes and shifts, the same bucket sets after
    adds and removes; searches (and filtered searches) give the same keys,
    scores within 1e-5."""
    from pathway_tpu.stdlib.ml._knn_lsh import LshKnnIndex as RefLsh
    from pathway_tpu_torch.stdlib.ml._knn_lsh import LshKnnIndex

    vecs, queries = _vectors(300, 10), _vectors(12, 11)
    ref = RefLsh(D, metric=metric, n_or=6, n_and=3, bucket_length=2.0, seed=7)
    port = LshKnnIndex(D, metric=metric, n_or=6, n_and=3, bucket_length=2.0, seed=7, device="cpu")
    for index in (ref, port):
        index.add(list(range(300)), vecs)
        index.remove([5, 50, 150])
        index.add([50], vecs[:1] * 0.5)
    assert port._planes.tobytes() == ref._planes.tobytes()
    assert port._shifts.tobytes() == ref._shifts.tobytes()
    assert port._buckets == ref._buckets
    assert sorted(port._rows) == sorted(ref._rows)
    accept = lambda key: key % 3 == 0  # noqa: E731
    for want, have in ((ref.search(queries, 7), port.search(queries, 7)),
                       (ref.search_oversampled(queries, 4, accept), port.search_oversampled(queries, 4, accept))):
        for w, h in zip(want, have):
            assert [k for k, _ in h] == [k for k, _ in w]
            np.testing.assert_allclose([s for _, s in h], [s for _, s in w], atol=TOL)


def _knn_tables(pw):
    vecs, queries = _vectors(60, 12), _vectors(9, 13)
    data = pw.debug.table_from_rows(pw.schema_from_types(name=str, vec=np.ndarray, label=str),
                                    [(f"n{i}", vecs[i], f"L{i % 3}") for i in range(len(vecs))])
    qs = pw.debug.table_from_rows(pw.schema_from_types(qv=np.ndarray, tag=int), [(q, i) for i, q in enumerate(queries)])
    return data, qs


@pytest.mark.parametrize("distance_type", ["euclidean", "cosine"])
def test_knn_index_answers_equal_the_reference(distance_type):
    """``KNNIndex.get_nearest_items`` (with distances) and
    ``get_nearest_items_asof_now``: the same neighbours per query, the
    distances within 1e-4."""
    got = {}
    for side, pw in PKGS.items():
        pw.reset()
        data, qs = _knn_tables(pw)
        index = pw.ml.KNNIndex(data.vec, data, n_dimensions=D, distance_type=distance_type, **_cpu(pw))
        near = index.get_nearest_items(qs.qv, k=4, with_distances=True).select(tag=qs.tag, name=pw.this.name,
                                                                                  dist=pw.this.dist)
        asof = index.get_nearest_items_asof_now(qs.qv, k=2).select(tag=qs.tag, name=pw.this.name)
        pw.run(monitoring_level=None)
        rows = []
        for table in (near, asof):
            keys, cols = table._materialize()
            rows.append(sorted((cols["tag"][i], tuple(cols["name"][i]), tuple(cols.get("dist", [()] * len(keys))[i]))
                               for i in range(len(keys))))
        got[side] = rows
    for ref_rows, port_rows in zip(got["ref"], got["port"]):
        assert len(port_rows) == 9
        for (t1, n1, d1), (t2, n2, d2) in zip(ref_rows, port_rows):
            assert (t1, n1) == (t2, n2)
            np.testing.assert_allclose(d2, d1, atol=1e-4)


def test_knn_classifier_equals_the_reference():
    got = {}
    for side, pw in PKGS.items():
        pw.reset()
        data, qs = _knn_tables(pw)
        pred = pw.ml.classifiers.knn_classifier(data.vec, data, data.label, qs.qv, n_dimensions=D, k=5, **_cpu(pw))
        out = pred.select(tag=qs.tag, label=pw.this.predicted_label)
        pw.run(monitoring_level=None)
        keys, cols = out._materialize()
        got[side] = sorted(zip(cols["tag"], cols["label"]))
    assert got["port"] == got["ref"] and len(got["port"]) == 9


# -- persistence ---------------------------------------------------------------------------


def _write_docs(path, rows):
    with open(path, "w") as f:
        f.write("name,vec\n")
        for name, vec in rows:
            f.write(f"{name},{' '.join(repr(float(x)) for x in vec)}\n")


def _write_queries(path, rows):
    with open(path, "w") as f:
        f.write("q,qvec\n")
        for name, vec in rows:
            f.write(f"{name},{' '.join(repr(float(x)) for x in vec)}\n")


def _parse(s):
    return np.array([float(x) for x in s.split()], dtype=np.float32)


def _persisted_index(pw, root, kind, mode):
    mod = pw.stdlib.indexing
    docs = pw.io.csv.read(str(root / "docs"), schema=pw.schema_from_types(name=str, vec=str), mode="static",
                          persistent_id="docs")
    qs = pw.io.csv.read(str(root / "queries"), schema=pw.schema_from_types(q=str, qvec=str), mode="static",
                        persistent_id="queries")
    docs = docs.select(pw.this.name, v=pw.apply(_parse, pw.this.vec))
    qs = qs.select(pw.this.q, qv=pw.apply(_parse, pw.this.qvec))
    if kind == "exact":
        factory = mod.BruteForceKnnFactory(dimension=D, **_cpu(pw))
    else:
        factory = mod.IvfKnnFactory(dimension=D, n_clusters=3, n_probe=3, **_cpu(pw))
    index = mod.DataIndex(docs, mod.InnerIndex(data_column=docs.v, factory=factory, dimension=D))
    res = index.query(qs.qv, number_of_matches=3)
    out = res.select(q=qs.q, n=docs.name, s=res.score)
    events = []
    pw.io.subscribe(out, on_change=lambda key, row, time, is_addition: events.append(
        (row["q"], tuple(row["n"]), tuple(float(x) for x in row["s"]), 1 if is_addition else -1)))
    config = pw.persistence.Config.simple_config(
        pw.persistence.Backend.filesystem(str(root / "snap")), snapshot_interval_ms=1,
        persistence_mode=getattr(pw.persistence.PersistenceMode, mode),
    )
    pw.run(monitoring_level=None, persistence_config=config)
    return events


def _two_runs(pw, root, kind, mode, new_docs=True):
    (root / "docs").mkdir(parents=True)
    (root / "queries").mkdir()
    vecs = _vectors(40, 14)
    _write_docs(root / "docs" / "a.csv", [(f"a{i}", vecs[i]) for i in range(30)])
    _write_queries(root / "queries" / "a.csv", [(f"q{i}", vecs[i * 3] + 0.01) for i in range(5)])
    runs = []
    for run in (1, 2):
        pw.reset()
        if run == 2:
            if new_docs:
                _write_docs(root / "docs" / "b.csv", [(f"b{i}", vecs[i]) for i in range(30, 40)])
            _write_queries(root / "queries" / "b.csv", [("late", vecs[33 if new_docs else 4] + 0.01)])
        runs.append(_persisted_index(pw, root, kind, mode))
    return runs


def _same_events(ref, port):
    assert len(ref) == len(port)
    for (q1, n1, s1, d1), (q2, n2, s2, d2) in zip(sorted(ref), sorted(port)):
        assert (q1, n1, d1) == (q2, n2, d2)
        np.testing.assert_allclose(s2, s1, atol=TOL)


@pytest.mark.parametrize("kind", ["exact", "ivf"])
def test_persisted_data_index_restarts_alike(tmp_path, kind):
    """A DataIndex behind persisted CSV sources, restarted with a new
    document file and a new query file under PERSISTING: both packages
    replay the log and answer alike in both runs, the replayed queries'
    re-emission included; the late query finds its late document."""
    got = {side: _two_runs(pw, tmp_path / side, kind, "PERSISTING") for side, pw in PKGS.items()}
    for ref, port in zip(got["ref"], got["port"]):
        _same_events(ref, port)
    run1, run2 = got["port"]
    assert {q for q, *_ in run1} == {f"q{i}" for i in range(5)}
    assert {q for q, *_ in run2} == {f"q{i}" for i in range(5)} | {"late"}  # replayed queries answered again
    (late,) = [n for q, n, _s, d in run2 if q == "late" and d > 0]
    assert late[0] == "b33"


def test_operator_persisting_refuses_an_index_the_reference_restores_empty(tmp_path):
    """The reference's ``ExternalIndexOperator`` has no snapshot: under
    OPERATOR_PERSISTING, a restart with a new query file answers ``()``
    (the index comes back empty, without an error).  The port refuses such
    a graph, naming the operator and PERSISTING, before it records
    anything; under PERSISTING both packages answer alike (the new query
    finds its document)."""
    ref_runs = _two_runs(pathway_tpu, tmp_path / "ref-op", "exact", "OPERATOR_PERSISTING", new_docs=False)
    (late,) = [n for q, n, _s, d in ref_runs[1] if q == "late" and d > 0]
    assert late == ()  # the reference caveat: an empty answer after the restart
    with pytest.raises(ValueError, match=r"ExternalIndexOperator.*PersistenceMode\.PERSISTING"):
        _two_runs(pathway_tpu_torch, tmp_path / "port-op", "exact", "OPERATOR_PERSISTING", new_docs=False)
    assert not (tmp_path / "port-op" / "snap" / "COMMIT").exists()
    got = {side: _two_runs(pw, tmp_path / f"{side}-p", "exact", "PERSISTING", new_docs=False)
           for side, pw in PKGS.items()}
    for ref, port in zip(got["ref"], got["port"]):
        _same_events(ref, port)
    (late,) = [n for q, n, _s, d in got["port"][1] if q == "late" and d > 0]
    assert late[0] == "a4"


@pytest.mark.parametrize("op", ["update_rows", "intersect", "difference"])
def test_operator_persisting_refuses_unsnapshotted_row_operators(tmp_path, op):
    """``update_rows``, ``intersect`` and ``difference`` keep state that no
    snapshot carries: after an OPERATOR_PERSISTING restart the reference
    answers differently from an input replay; the port refuses the graph."""

    def run_twice(pw, root, mode):
        (root / "a").mkdir(parents=True)
        (root / "b").mkdir()
        _write_kv(root / "a" / "1.csv", [("x", 1), ("y", 2)])
        _write_kv(root / "b" / "1.csv", [("z", 9)])
        state = {}
        for run in (1, 2):
            pw.reset()
            if run == 2:
                _write_kv(root / "a" / "2.csv", [("z", 5)])
                _write_kv(root / "b" / "2.csv", [("x", 7)])

            class KV(pw.Schema):
                k: str = pw.column_definition(primary_key=True)
                v: int

            a = pw.io.csv.read(str(root / "a"), schema=KV, mode="static", persistent_id="a")
            b = pw.io.csv.read(str(root / "b"), schema=KV, mode="static", persistent_id="b")
            out = {"update_rows": lambda: a.update_rows(b), "intersect": lambda: a.intersect(b),
                   "difference": lambda: a.difference(b)}[op]()
            a.groupby(pw.this.k).reduce(k=pw.this.k, n=pw.reducers.count())  # a snapshotted operator
            pw.io.subscribe(out, on_change=lambda key, row, time, is_addition: state.__setitem__(
                row["k"], int(row["v"])) if is_addition else state.pop(row["k"], None))
            pw.run(monitoring_level=None, persistence_config=pw.persistence.Config.simple_config(
                pw.persistence.Backend.filesystem(str(root / "snap")), snapshot_interval_ms=1,
                persistence_mode=getattr(pw.persistence.PersistenceMode, mode)))
        return state

    replayed = run_twice(pathway_tpu, tmp_path / "ref-p", "PERSISTING")
    restored = run_twice(pathway_tpu, tmp_path / "ref-op", "OPERATOR_PERSISTING")
    assert restored != replayed  # the reference's wrong answer
    assert run_twice(pathway_tpu_torch, tmp_path / "port-p", "PERSISTING") == replayed
    with pytest.raises(ValueError, match="OPERATOR_PERSISTING cannot snapshot"):
        run_twice(pathway_tpu_torch, tmp_path / "port-op", "OPERATOR_PERSISTING")


def _write_kv(path, rows):
    with open(path, "w") as f:
        f.write("k,v\n")
        for k, v in rows:
            f.write(f"{k},{v}\n")
