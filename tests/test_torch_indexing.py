"""The port's DataIndex over its KNN factories against the reference.

The same seeded vectors go through ``DataIndex`` built on
``BruteForceKnnFactory``, ``IvfKnnFactory`` (full probe) and
``TpuKnnFactory`` in both packages: the keys must be equal and the scores
within 1e-5 (f32 on both sides).  The port's indexes run on the CPU here
(``device="cpu"``); its IVF rescore takes the kernel's plain version there.
Streams are driven by one atomic ``ConnectorSubject`` so every commit is a
tick of its own in both packages.
"""

import numpy as np
import pytest
import torch

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.io import _connector as ref_connector
from pathway_tpu_torch.io import _connector as port_connector

D = 16
N_DOCS = 200
TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setattr(ref_connector, "_source_counter", [0])
    monkeypatch.setattr(port_connector, "_source_counter", [0])
    pathway_tpu.reset()
    pathway_tpu_torch.reset()
    yield
    pathway_tpu.reset()
    pathway_tpu_torch.reset()


def _factory(pw, kind, **kw):
    mod = pw.stdlib.indexing
    extra = {"device": "cpu"} if pw is pathway_tpu_torch else {}
    if kind == "brute":
        return mod.BruteForceKnnFactory(dimension=D, **extra, **kw)
    if kind == "ivf":
        return mod.IvfKnnFactory(dimension=D, n_clusters=4, n_probe=4, **extra, **kw)
    if kind == "tpu":
        return mod.TpuKnnFactory(dimension=D, **extra, **kw)
    if kind == "lsh":
        return mod.LshKnnFactory(dimension=D, n_or=8, n_and=4, **extra, **kw)
    raise AssertionError(kind)


def _vectors(n, seed):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def _docs(pw):
    vecs = _vectors(N_DOCS, 0)
    return pw.debug.table_from_rows(
        pw.schema_from_types(name=str, vec=np.ndarray, meta=dict),
        [(f"d{i}", vecs[i], {"path": f"dir{i % 4}/f{i}.txt", "rank": i}) for i in range(N_DOCS)],
    )


def _queries(pw, n=24):
    q = _vectors(n, 1)
    return pw.debug.table_from_rows(
        pw.schema_from_types(qv=np.ndarray, k=int, flt=str),
        [(q[i], 3 + i % 5, None if i % 3 else "globmatch('dir1/*', path)") for i in range(n)],
    )


def _materialized(table):
    keys, cols = table._materialize()
    return {int(k): {c: cols[c][i] for c in cols} for i, k in enumerate(keys)}


def _same_answers(ref, port):
    assert sorted(ref) == sorted(port)
    for qk in ref:
        assert tuple(port[qk]["names"]) == tuple(ref[qk]["names"])
        np.testing.assert_allclose(np.asarray(port[qk]["scores"]), np.asarray(ref[qk]["scores"]), atol=TOL)


KINDS = ["brute", "ivf", "tpu"]


def _static_query(pw, kind, with_filter, per_query_k):
    docs = _docs(pw)
    queries = _queries(pw)
    index = pw.stdlib.indexing.DataIndex(
        docs,
        pw.stdlib.indexing.InnerIndex(
            data_column=docs.vec, metadata_column=docs.meta, factory=_factory(pw, kind), dimension=D
        ),
    )
    result = index.query_as_of_now(
        queries.qv,
        number_of_matches=queries.k if per_query_k else 5,
        metadata_filter=queries.flt if with_filter else None,
    )
    out = result.select(names=docs.name, scores=result.score)
    pw.run(monitoring_level=None)
    return _materialized(out)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_filter", [False, True], ids=["nofilter", "filter"])
@pytest.mark.parametrize("per_query_k", [False, True], ids=["k5", "kcol"])
def test_query_as_of_now_equals_reference(kind, with_filter, per_query_k):
    ref = _static_query(pathway_tpu, kind, with_filter, per_query_k)
    pathway_tpu.reset()
    port = _static_query(pathway_tpu_torch, kind, with_filter, per_query_k)
    _same_answers(ref, port)
    assert all(len(r["names"]) > 0 for r in port.values())
    if with_filter:
        filtered = [r for r in port.values() if all(int(n[1:]) % 4 == 1 for n in r["names"])]
        assert len(filtered) >= 8  # every filtered query kept dir1/* only


@pytest.mark.parametrize("kind", KINDS)
def test_uncollapsed_rows_equal_reference(kind):
    def run(pw):
        docs = _docs(pw)
        queries = _queries(pw, n=6)
        index = pw.stdlib.indexing.DataIndex(
            docs, pw.stdlib.indexing.InnerIndex(data_column=docs.vec, factory=_factory(pw, kind), dimension=D)
        )
        result = index.query_as_of_now(queries.qv, number_of_matches=4, collapse_rows=False)
        out = result.select(name=docs.name, score=result.score)
        pw.run(monitoring_level=None)
        keys, cols = out._materialize()
        return sorted((int(k), cols["name"][i], float(cols["score"][i])) for i, k in enumerate(keys))

    ref = run(pathway_tpu)
    pathway_tpu.reset()
    port = run(pathway_tpu_torch)
    assert [(k, n) for k, n, _ in port] == [(k, n) for k, n, _ in ref]
    np.testing.assert_allclose([s for *_, s in port], [s for *_, s in ref], atol=TOL)


def _stream(pw, kind, asof_now):
    """One atomic subject: commit 1 the documents, commit 2 the queries,
    commit 3 a planted document equal to query 0, commit 4 its removal."""
    docs_v = _vectors(40, 2)
    q_v = _vectors(4, 3)

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(40):
                self.next(kind="doc", name=f"d{i}", vec=docs_v[i])
            self.commit()
            for i in range(4):
                self.next(kind="query", name=f"q{i}", vec=q_v[i])
            self.commit()
            self.next(kind="doc", name="planted", vec=q_v[0] * 2.0)
            self.commit()
            self.delete(kind="doc", name="planted", vec=q_v[0] * 2.0)
            self.commit()

    rows = pw.io.python.read(
        Subject(), schema=pw.schema_from_types(kind=str, name=str, vec=np.ndarray), atomic_batches=True
    )
    docs = rows.filter(pw.this.kind == "doc")
    queries = rows.filter(pw.this.kind == "query")
    index = pw.stdlib.indexing.DataIndex(
        docs, pw.stdlib.indexing.InnerIndex(data_column=docs.vec, factory=_factory(pw, kind), dimension=D)
    )
    query = index.query_as_of_now if asof_now else index.query
    result = query(queries.vec, number_of_matches=3)
    out = result.select(names=docs.name, scores=result.score)
    events = []
    pw.io.subscribe(
        out,
        on_change=lambda key, row, time, is_addition: events.append(
            (time, int(key), tuple(row["names"]), tuple(row["scores"]), 1 if is_addition else -1)
        ),
    )
    pw.run(monitoring_level=None)
    ticks = {}
    for time, key, names, scores, diff in events:
        ticks.setdefault(time, []).append((key, names, diff, scores))
    return [sorted(ticks[t]) for t in sorted(ticks)]


def _same_stream(ref, port):
    assert len(port) == len(ref)
    for ref_tick, port_tick in zip(ref, port):
        assert [(k, n, d) for k, n, d, _ in port_tick] == [(k, n, d) for k, n, d, _ in ref_tick]
        for (*_, ps), (*_, rs) in zip(port_tick, ref_tick):
            np.testing.assert_allclose(ps, rs, atol=TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_retracting_query_re_emits_like_reference(kind):
    ref = _stream(pathway_tpu, kind, asof_now=False)
    pathway_tpu.reset()
    port = _stream(pathway_tpu_torch, kind, asof_now=False)
    _same_stream(ref, port)
    # the planted document lands: query 0's answer is retracted and
    # re-emitted with it first; its removal retracts that answer again
    planted = [tick for tick in port if any(d < 0 for _k, _n, d, _s in tick)]
    assert len(planted) == 2
    first = [n for _k, n, d, _s in planted[0] if d > 0]
    assert any(names[0] == "planted" for names in first)
    second = [n for _k, n, d, _s in planted[1] if d < 0]
    assert any(names[0] == "planted" for names in second)


@pytest.mark.parametrize("kind", KINDS)
def test_as_of_now_never_retracts_like_reference(kind):
    ref = _stream(pathway_tpu, kind, asof_now=True)
    pathway_tpu.reset()
    port = _stream(pathway_tpu_torch, kind, asof_now=True)
    _same_stream(ref, port)
    assert len(port) == 1  # answered once, at the queries' commit
    assert all(d > 0 for tick in port for _k, _n, d, _s in tick)
    assert all("planted" not in n for tick in port for _k, n, _d, _s in tick)


def test_factory_device_reaches_the_index():
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory, IvfKnnFactory, TpuKnnFactory

    for factory in (BruteForceKnnFactory, IvfKnnFactory, TpuKnnFactory):
        inner = factory(dimension=D, device="cpu").build_inner_index()
        assert inner.index.device == torch.device("cpu")


def test_factories_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory, IvfKnnFactory, TpuKnnFactory
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import DeviceIvfKnn, DeviceKnn

    for make in (
        lambda: BruteForceKnnFactory(dimension=D).build_inner_index(),
        lambda: IvfKnnFactory(dimension=D).build_inner_index(),
        lambda: TpuKnnFactory(dimension=D).build_inner_index(),
        lambda: DeviceKnn(D),
        lambda: DeviceIvfKnn(D),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_lsh_factory_names_its_slice():
    """``LshKnnFactory`` builds the LSH index: on the CPU only when asked
    (without ``device`` it wants the card, and raises here), and there a
    DataIndex over it answers as the reference's, filtered queries and
    per-query k included."""
    from pathway_tpu_torch.stdlib.indexing import LshKnnFactory

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LshKnnFactory(dimension=D).build_inner_index()
    ref = _static_query(pathway_tpu, "lsh", True, True)
    pathway_tpu.reset()
    port = _static_query(pathway_tpu_torch, "lsh", True, True)
    _same_answers(ref, port)
    assert sum(len(r["names"]) for r in port.values()) > 0
