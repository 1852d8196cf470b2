"""The port's ``pw.iterate``, graph stdlib and sorting against the
reference, and ``pw.iterate`` under operator persistence.

Batch cases (those of ``tests/test_iterate.py``, ``tests/test_graphs.py``
and ``tests/test_sorting.py``) run one builder through both packages with
``pw.run`` and compare keyed rows and the update stream tick by tick.
Streaming cases drive input sessions by hand, one executor step per
commit, and compare the rows after every step and the update stream; the
seeded random sort is also held against a full recompute after every
step.
"""

import math

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.io import _connector as ref_connector
from pathway_tpu_torch.io import _connector as port_connector

from .test_torch_indexing import D, _docs, _factory
from .test_torch_table import _run
from .test_torch_temporal import END, _drive

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


def _both(build):
    ref, port = (_run(pw, build) for pw in PACKAGES)
    assert port == ref
    return port


def _both_driven(scenario):
    ref, port = (_drive(pw, scenario) for pw in PACKAGES)
    assert port == ref
    return port


# -- tests/test_iterate.py -----------------------------------------------------------


def build_iterate_collatz(pw):
    t = pw.debug.table_from_markdown("""
        n
        1
        3
        5
        7
        27
        """)

    def body(t):
        return t.select(n=pw.if_else(t.n == 1, t.n, pw.if_else(t.n % 2 == 0, t.n // 2, 3 * t.n + 1)))

    return pw.iterate(body, t=t)


def build_iterate_limit(pw):
    t = pw.debug.table_from_markdown("""
        x
        0
        10
        """)
    return pw.iterate(lambda t: t.select(x=t.x + 1), iteration_limit=5, t=t)


def build_iterate_streaming_updates(pw):
    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            self.next(n=6)
            self.commit()
            self.next(n=24)
            self.next(n=40)
            self.commit()

    t = pw.io.python.read(Subject(), schema=pw.schema_from_types(n=int), atomic_batches=True)
    return pw.iterate(lambda t: t.select(n=pw.if_else(t.n % 2 == 0, t.n // 2, t.n)), t=t)


def build_iterate_tuple_and_universe(pw):
    """Two iterated tables returned as a tuple, one of them through
    ``iterate_universe`` (its key set shrinks: a row reaching 4 drops out)."""
    a = pw.debug.table_from_markdown("""
        x
        5
        9
        """)
    b = pw.debug.table_from_markdown("""
        y
        3
        12
        7
        """)

    def body(a, b):
        return (
            a.select(x=pw.if_else(a.x > 2, a.x - 2, a.x)),
            b.filter(b.y != 4).select(y=pw.if_else(b.y > 5, b.y - 3, b.y)),
        )

    return pw.iterate(body, a=a, b=pw.iterate_universe(b))


# -- tests/test_graphs.py ------------------------------------------------------------


def _vertices(pw, names, **extra):
    return pw.Table.from_rows([{"name": n, **{k: v[i] for k, v in extra.items()}} for i, n in enumerate(names)]).with_id_from(
        pw.this.name
    )


def _edge_table(pw, vertices, pairs, weights=None):
    if weights is None:
        raw = pw.Table.from_rows([{"a": a, "b": b} for a, b in pairs])
        return raw.select(u=vertices.pointer_from(raw.a), v=vertices.pointer_from(raw.b))
    raw = pw.Table.from_rows([{"a": a, "b": b, "w": w} for (a, b), w in zip(pairs, weights)])
    return raw.select(u=vertices.pointer_from(raw.a), v=vertices.pointer_from(raw.b), weight=raw.w + 0.0)


def build_pagerank_star(pw):
    vs = _vertices(pw, ["a", "b", "c", "d"])
    return pw.graphs.pagerank(_edge_table(pw, vs, [("b", "a"), ("c", "a"), ("d", "a")]), steps=10)


def build_pagerank_cycle_uniform(pw):
    vs = _vertices(pw, ["a", "b", "c"])
    return pw.graphs.pagerank(_edge_table(pw, vs, [("a", "b"), ("b", "c"), ("c", "a")]), steps=30)


def build_pagerank_incremental_update(pw):
    """Edges streamed in two commits: the ranks move when the second lands."""
    vs = _vertices(pw, ["a", "b", "c"])

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for a, b in (("a", "b"), ("b", "a")):
                self.next(a=a, b=b)
            self.commit()
            self.next(a="c", b="a")
            self.commit()

    raw = pw.io.python.read(Subject(), schema=pw.schema_from_types(a=str, b=str), atomic_batches=True)
    edges = raw.select(u=vs.pointer_from(raw.a), v=vs.pointer_from(raw.b))
    return pw.graphs.pagerank(edges, steps=5), pw.graphs.degrees(edges), pw.graphs.in_degrees(edges), pw.graphs.out_degrees(edges)


def build_bellman_ford_line(pw):
    vs = pw.Table.from_rows(
        [{"name": n, "is_source": n == "s"} for n in ("s", "m", "t", "x")]
    ).with_id_from(pw.this.name)
    raw = pw.Table.from_rows([{"a": "s", "b": "m", "d": 2.0}, {"a": "m", "b": "t", "d": 3.0}, {"a": "s", "b": "t", "d": 10.0}])
    edges = raw.select(u=vs.pointer_from(raw.a), v=vs.pointer_from(raw.b), dist=raw.d)
    return pw.graphs.bellman_ford(vs, edges)


_CLIQUES = [("a1", "a2"), ("a2", "a3"), ("a1", "a3"), ("b1", "b2"), ("b2", "b3"), ("b1", "b3")]


def build_louvain_two_cliques(pw):
    vs = _vertices(pw, ["a1", "a2", "a3", "b1", "b2", "b3"])
    edges = _edge_table(pw, vs, _CLIQUES + [("a1", "b1")], weights=[1.0] * 6 + [0.1])
    return pw.graphs.louvain_communities.louvain_level_fixed_iterations(pw.graphs.WeightedGraph(vs, edges), 5)


def build_louvain_two_levels(pw):
    vs = _vertices(pw, ["a1", "a2", "a3", "b1", "b2", "b3"])
    edges = _edge_table(pw, vs, _CLIQUES + [("a3", "b1")], weights=[1.0] * 7)
    return pw.graphs.louvain_communities.louvain_communities_fixed_iterations(
        pw.graphs.WeightedGraph(vs, edges), levels=2, iterations_per_level=3
    )


def build_graph_contraction(pw):
    keys = pw.internals.keys if pw is pathway_tpu else pathway_tpu_torch.internals.keys
    vs = _vertices(pw, ["a", "b", "c", "d"])
    G = pw.graphs.WeightedGraph(vs, _edge_table(pw, vs, [("a", "b"), ("c", "d"), ("a", "c")], weights=[1.0, 2.0, 5.0]))
    key_a, key_c = (int(keys.ref_scalars_batch([[n]])[0]) for n in ("a", "c"))
    clustering = vs.select(c=pw.apply(lambda n: np.uint64(key_a if n in ("a", "b") else key_c), pw.this.name))
    weighted = G.contracted_to_weighted_simple_graph(clustering)
    plain = pw.graphs.Graph(vs, G.E).without_self_loops()
    simple = plain.contracted_to_unweighted_simple_graph(clustering)
    multi = plain.contracted_to_multi_graph(clustering)
    return weighted.E, weighted.V, simple.E, multi.E, multi.V


# -- tests/test_sorting.py (batch) ------------------------------------------------------


def build_sort_basic_prev_next(pw):
    base = pw.debug.table_from_markdown("""
        name    | age
        alice   | 25
        bob     | 20
        charlie | 30
        """)
    return base.sort(key=base.age), pw.stdlib.indexing.sorting.sort_from_index(base, base.age)


def build_sort_with_instance(pw):
    base = pw.debug.table_from_markdown("""
        name    | age | score
        alice   | 25  | 80
        bob     | 20  | 90
        charlie | 30  | 80
        david   | 35  | 90
        eve     | 15  | 80
        """)
    return base.sort(key=base.age, instance=base.score)


def build_retrieve_prev_next_values(pw):
    base = pw.debug.table_from_markdown("""
        name | t  | v
        a    | 1  | 10
        b    | 2  |
        c    | 3  |
        d    | 4  | 40
        e    | 5  |
        f    | 0  |
        """)
    ordered = base.sort(key=base.t)
    joined = base.select(prev=ordered.prev, next=ordered.next, value=base.v)
    return pw.stdlib.indexing.sorting.retrieve_prev_next_values(joined)


BATCH = [
    build_iterate_collatz, build_iterate_limit, build_iterate_streaming_updates, build_iterate_tuple_and_universe,
    build_pagerank_star, build_pagerank_cycle_uniform, build_pagerank_incremental_update, build_bellman_ford_line,
    build_louvain_two_cliques, build_louvain_two_levels, build_graph_contraction, build_sort_basic_prev_next,
    build_sort_with_instance, build_retrieve_prev_next_values,
]


@pytest.mark.parametrize("build", BATCH, ids=lambda f: f.__name__[len("build_"):])
def test_batch_equals_reference(build):
    streams = _both(build)
    assert all(rows for _stream, rows in streams)


def test_graph_answers_are_right():
    """The ported answers themselves: Bellman-Ford's distances, a star's
    ranks, the cliques' two communities, the modularity of two triangles."""
    pw = pathway_tpu_torch
    dists = build_bellman_ford_line(pw)
    ranks = build_pagerank_star(pw)
    clustering = build_louvain_two_cliques(pw)
    pw.run(monitoring_level=None)
    _k, cols = dists._materialize()
    got = sorted(cols["dist_from_source"].tolist())
    assert got[:3] == [0.0, 2.0, 5.0] and math.isinf(got[3])
    _k, cols = ranks._materialize()
    assert sorted(cols["rank"].tolist())[:3] == pytest.approx([0.15, 0.15, 0.15], abs=1e-12)
    _k, cols = clustering._materialize()
    assert len(set(int(c) for c in cols["c"])) == 2
    pw.reset()
    vs = _vertices(pw, ["a1", "a2", "a3", "b1", "b2", "b3"])
    G = pw.graphs.WeightedGraph(vs, _edge_table(pw, vs, _CLIQUES + [("a3", "b1")], weights=[1.0] * 7))
    q = pw.graphs.louvain_communities.exact_modularity(G, pw.graphs.louvain_communities.louvain_level_fixed_iterations(G, 5))
    pathway_tpu.reset()
    rvs = _vertices(pathway_tpu, ["a1", "a2", "a3", "b1", "b2", "b3"])
    RG = pathway_tpu.stdlib.graphs.WeightedGraph(rvs, _edge_table(pathway_tpu, rvs, _CLIQUES + [("a3", "b1")], weights=[1.0] * 7))
    rq = pathway_tpu.stdlib.graphs.louvain_communities.exact_modularity(
        RG, pathway_tpu.stdlib.graphs.louvain_communities.louvain_level_fixed_iterations(RG, 5)
    )
    assert q == rq and q > 0.3


# -- streaming sorts: one executor step per commit ------------------------------------------


def scenario_sort_incremental_insert_and_delete(e):
    t, s = e.stream(name=str, age=float)
    out = t.sort(key=t.age)
    ka, kb, kc = (int(e.key(i)) for i in (1, 2, 3))
    steps = [
        lambda: (s.insert(ka, ("alice", 25.0)), s.insert(kb, ("bob", 20.0))),
        lambda: s.insert(kc, ("carol", 22.0)),
        lambda: s.remove(kc),
    ]
    return (out,), steps, None


def scenario_retrieve_prev_next_values_streamed(e):
    """Values walked over a sorted table as rows come and go: the nested
    iterate re-walks only what a commit changed."""
    t, s = e.stream(t=float, v=object)
    ordered = t.sort(key=t.t)
    joined = t.select(prev=ordered.prev, next=ordered.next, value=t.v)
    out = e.pw.stdlib.indexing.sorting.retrieve_prev_next_values(joined)
    rows = [(1.0, 10), (2.0, None), (3.0, None), (4.0, 40), (5.0, None), (0.5, None)]
    steps = [
        lambda: [s.insert(int(e.key(i)), r) for i, r in enumerate(rows[:4])],
        lambda: [s.insert(int(e.key(i)), r) for i, r in enumerate(rows) if i >= 4],
        lambda: s.remove(int(e.key(3))),  # the only value at the right end goes
        lambda: s.insert(int(e.key(9)), (2.5, 25)),
        lambda: s.remove(int(e.key(0))),
    ]
    return (out,), steps, None


@pytest.mark.parametrize(
    "scenario", [scenario_sort_incremental_insert_and_delete, scenario_retrieve_prev_next_values_streamed],
    ids=lambda f: f.__name__[len("scenario_"):],
)
def test_streamed_sorting_equals_reference(scenario):
    seen, ticks = _both_driven(scenario)
    assert all(rows for (rows,), _probe in seen) and any(ticks)


def _sort_oracle(live):
    order = sorted(live.items(), key=lambda kv: (kv[1], kv[0]))
    want = {}
    for i, (k, _age) in enumerate(order):
        want[k] = (order[i - 1][0] if i > 0 else None, order[i + 1][0] if i < len(order) - 1 else None)
    return want


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_seeded_random_sort_equals_reference_and_full_recompute(seed):
    """Random inserts and deletes over 14 commits: after every step the
    port's prev / next pointers equal a sort from scratch, and every step's
    rows and the update stream equal the reference's."""
    rng = np.random.default_rng(seed)
    plan, live, next_key = [], {}, 1
    for _tick in range(14):
        ops = []
        for _ in range(int(rng.integers(1, 7))):
            if live and rng.random() < 0.4:
                k = list(live)[int(rng.integers(0, len(live)))]
                ops.append(("remove", k, None))
                del live[k]
            else:
                age = float(np.round(rng.uniform(0, 50), 1))
                ops.append(("insert", next_key, age))
                live[next_key] = age
                next_key += 1
        plan.append((ops, dict(live)))

    def scenario(e):
        t, s = e.stream(age=float)
        out = t.sort(key=t.age)

        def step(ops):
            for op, k, age in ops:
                if op == "remove":
                    s.remove(int(e.key(k)))
                else:
                    s.insert(int(e.key(k)), (age,))

        return (out,), [lambda ops=ops: step(ops) for ops, _live in plan], None

    seen, _ticks = _both_driven(scenario)
    keyed = {int(pathway_tpu_torch.internals.keys.ref_scalar(k)): k for k in range(1, next_key)}
    for ((rows,), _probe), (_ops, live_after) in zip(seen, plan):
        got = {
            keyed[key]: tuple(None if dict(row)[c] is None else keyed[int(dict(row)[c])] for c in ("prev", "next"))
            for key, row in rows
        }
        assert got == _sort_oracle(live_after)


# -- pw.iterate under OPERATOR_PERSISTING ----------------------------------------------------

_COMMITS = [[(1.0, 6), (3.0, 24), (12.0, 7)], [(14.0, 40), (2.0, 10)], [(25.0, 96), (15.0, 3)], [(27.0, 64), (31.0, 12)]]


def _windowed_iterate(pw, commits, backend=None, mode=None):
    """An iterate whose body holds a windowed groupby: each row's value
    halves until odd, and the window sums are read off the fixed point."""

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for rows in commits:
                for t, v in rows:
                    self.next(t=t, v=v)
                self.commit()

    src = pw.io.python.read(Subject(), schema=pw.schema_from_types(t=float, v=int), persistent_id="events")

    def body(rows):
        halved = rows.select(t=rows.t, v=pw.if_else(rows.v % 2 == 0, rows.v // 2, rows.v))
        sums = pw.temporal.windowby(
            rows, rows.t, window=pw.temporal.tumbling(duration=10.0),
            behavior=pw.temporal.common_behavior(cutoff=100.0),
        ).reduce(start=pw.this._pw_window_start, s=pw.reducers.sum(pw.this.v), n=pw.reducers.count())
        return {"rows": halved, "sums": sums}

    out = pw.iterate(body, rows=src)
    config = None
    if backend is not None:
        config = pw.persistence.Config.simple_config(
            backend, persistence_mode=getattr(pw.PersistenceMode, mode), snapshot_interval_ms=1
        )
    pw.run(monitoring_level=None, persistence_config=config)
    keys, cols = out["sums"]._materialize()
    return sorted((int(k), float(cols["start"][i]), int(cols["s"][i]), int(cols["n"][i])) for i, k in enumerate(keys))


def test_iterate_over_a_windowed_groupby_restores_from_a_snapshot():
    """Under OPERATOR_PERSISTING the nested graph's tables, its groupby and
    its time gate ride in the iterate operator's snapshot: a run of two
    commits, then a restart that sends two more, ends where one
    uninterrupted run of four ends (and where the reference's run ends)."""
    pw = pathway_tpu_torch
    backend = pw.persistence.Backend.mock()
    _windowed_iterate(pw, _COMMITS[:2], backend, "OPERATOR_PERSISTING")
    store = backend.make_store()
    assert [k for k in store.list_keys() if k.startswith("operators/") and "IterateOperator" in k]
    pw.reset()
    restored = _windowed_iterate(pw, _COMMITS[2:], backend, "OPERATOR_PERSISTING")
    pw.reset()
    uninterrupted = _windowed_iterate(pw, _COMMITS)
    assert restored == uninterrupted
    assert uninterrupted == _windowed_iterate(pathway_tpu, _COMMITS)
    # the fixed point's odd values summed per window of 10
    assert sorted((start, s) for _k, start, s, _n in uninterrupted) == [(0.0, 11), (10.0, 15), (20.0, 4), (30.0, 3)]


def _refused_body(kind):
    pw = pathway_tpu_torch
    t = pw.debug.table_from_rows(pw.schema_from_types(k=int, v=int), [(i % 3, i) for i in range(6)])
    if kind == "update_rows":
        def body(t):
            return t.update_rows(t.filter(t.v > 3).select(k=t.k, v=t.v - 1))

        return pw.iterate(body, t=t)
    docs = _docs(pw)
    queries = docs.select(qv=docs.vec)

    def body(queries, docs):
        index = pw.stdlib.indexing.DataIndex(
            docs, pw.stdlib.indexing.InnerIndex(data_column=docs.vec, metadata_column=docs.meta,
                                               factory=_factory(pw, "brute"), dimension=D),
        )
        answers = index.query_as_of_now(queries.qv, number_of_matches=3)
        return {"queries": queries, "answers": answers.select(n=docs.name)}

    return pw.iterate(body, queries=queries, docs=docs)


@pytest.mark.parametrize("kind", ["update_rows", "index"])
def test_operator_persisting_refuses_an_unsnapshotted_operator_inside_iterate(kind):
    """An update-rows or index operator inside an iterate body keeps state
    no snapshot carries: the refusal walks into the nested graph and
    raises ``ValueError`` naming it before anything is recorded;
    PERSISTING (input replay) runs the same graph."""
    pw = pathway_tpu_torch
    _refused_body(kind)
    backend = pw.persistence.Backend.mock()
    mode = pw.persistence.Config.simple_config(backend, persistence_mode=pw.PersistenceMode.OPERATOR_PERSISTING)
    name = "UpdateRowsOperator" if kind == "update_rows" else "ExternalIndexOperator"
    with pytest.raises(ValueError, match=rf"{name}.*PersistenceMode\.PERSISTING"):
        pw.run(monitoring_level=None, persistence_config=mode)
    assert not backend.make_store().get("COMMIT")
    pw.reset()
    out = _refused_body(kind)
    pw.run(monitoring_level=None, persistence_config=pw.persistence.Config.simple_config(pw.persistence.Backend.mock()))
    result = out if kind == "update_rows" else out["answers"]
    assert len(result._materialize()[0])


def test_nested_executor_stays_out_of_the_run():
    """The nested executor is stepped by its operator only: ``pw.run``'s
    executor is the outer one, and the nested sources record no input log."""
    from pathway_tpu_torch.internals import run as run_mod

    pw = pathway_tpu_torch
    seen = []
    orig = run_mod.Executor

    class Spy(orig):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    run_mod.Executor = Spy
    try:
        out = build_iterate_collatz(pw)
        backend = pw.persistence.Backend.mock()
        pw.run(monitoring_level=None, persistence_config=pw.persistence.Config.simple_config(backend))
    finally:
        run_mod.Executor = orig
    assert len(seen) == 1 and seen[0].graph is pw.G.engine_graph
    nested = [o for o in pw.G.engine_graph.operators if getattr(o, "nested_graph", None) is not None]
    assert len(nested) == 1 and nested[0].nested_exec is not seen[0]
    assert all(src.session.recorder is None for src in nested[0].nested_graph.sources)
    assert len(out._materialize()[0]) == 5
