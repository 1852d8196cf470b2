"""The port's table API and incremental engine against the reference.

The same pipeline is built with ``pathway_tpu`` and with
``pathway_tpu_torch`` on the same seeded rows; both must give identical
keyed rows and identical ``(key, row, diff)`` update streams through
``pw.io.subscribe``, tick by tick (wall-clock times are not compared).
"""

import numpy as np
import pytest
import torch

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.io import _connector as ref_connector
from pathway_tpu_torch.io import _connector as port_connector

@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    # connector salts come from a module counter: start both at zero
    monkeypatch.setattr(ref_connector, "_source_counter", [0])
    monkeypatch.setattr(port_connector, "_source_counter", [0])
    pathway_tpu.reset()
    pathway_tpu_torch.reset()
    yield
    pathway_tpu.reset()
    pathway_tpu_torch.reset()


def _plain(value):
    """A comparable form of a cell: arrays and tensors become lists."""
    if isinstance(value, torch.Tensor):
        value = value.numpy()
    if isinstance(value, np.ndarray):
        return ("array", str(value.dtype), value.tolist())
    if isinstance(value, (list, tuple)):
        return type(value).__name__, tuple(_plain(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((k, _plain(v)) for k, v in value.items()))
    if isinstance(value, (np.integer, np.floating, np.bool_)):
        return value.item()
    if type(value).__name__ == "Error":  # each package has its own Error class
        return ("Error", value.message)
    return value


def _run(pw, build):
    """Build the pipeline, subscribe to its outputs, run; returns the
    update stream per output (one sorted list of (key, row, diff) per tick,
    ticks in order) and the final keyed rows."""
    outputs = build(pw)
    if not isinstance(outputs, tuple):
        outputs = (outputs,)
    streams = []
    for table in outputs:
        events = []

        def on_change(key, row, time, is_addition, events=events):
            events.append((time, int(key), tuple((k, _plain(v)) for k, v in sorted(row.items())), 1 if is_addition else -1))

        pw.io.subscribe(table, on_change=on_change)
        streams.append(events)
    pw.run(monitoring_level=None)
    result = []
    for table, events in zip(outputs, streams):
        ticks = {}
        for time, key, row, diff in events:
            ticks.setdefault(time, []).append((key, row, diff))
        stream = [sorted(ticks[t]) for t in sorted(ticks)]
        keys, cols = table._materialize()
        rows = sorted(
            (int(k), tuple((c, _plain(cols[c][i])) for c in sorted(cols))) for i, k in enumerate(keys)
        )
        result.append((stream, rows))
    return result


def _rows(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return [
        (int(rng.integers(0, 5)), float(np.round(rng.standard_normal(), 3)), f"w{int(rng.integers(100))} x{i}")
        for i in range(n)
    ]


def _base(pw):
    return pw.debug.table_from_rows(pw.schema_from_types(k=int, v=float, s=str), _rows())


def build_select_filter_with_columns(pw):
    t = _base(pw)
    return t.filter(pw.this.v > -0.5).with_columns(w=pw.this.v * 2 + 1, up=pw.this.s.str.upper()).select(
        pw.this.k, pw.this.w, pw.this.up, neg=-pw.this.v
    )


def build_expressions(pw):
    t = _base(pw)
    return t.select(
        big=pw.if_else(pw.this.v > 0, pw.this.k * 10, pw.this.k),
        n=pw.apply(lambda s: len(s), pw.this.s),
        tup=pw.make_tuple(pw.this.k, pw.this.s),
        c=pw.coalesce(None, pw.this.k),
        flo=pw.this.v // 1,
    )


def build_flatten(pw):
    t = _base(pw).select(pw.this.k, words=pw.apply(lambda s: tuple(s.split()), pw.this.s))
    return t.flatten(pw.this.words)


def build_flatten_stream(pw):
    """Flatten over streamed deltas of many parents, empty and None lists
    and a retraction among them: every child key of a delta comes from one
    batched host call, and must equal the reference's key bit for bit."""

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(40):
                self.next(k=i, words=tuple(f"w{i}_{j}" for j in range(i % 7)) if i % 11 else None)
            self.commit()
            self.delete(k=3, words=tuple(f"w3_{j}" for j in range(3)))
            self.next(k=100, words=("a", "b", "a", "c"))
            self.commit()

    t = pw.io.python.read(Subject(), schema=pw.schema_from_types(k=int, words=tuple), atomic_batches=True)
    return t.flatten(pw.this.words)


def build_groupby_reduce(pw):
    return build_groupby_reduce_over(pw, _base(pw))


def build_groupby_reduce_over(pw, t):
    return t.groupby(pw.this.k).reduce(
        pw.this.k,
        total=pw.reducers.sum(pw.this.v),
        n=pw.reducers.count(),
        lo=pw.reducers.min(pw.this.v),
        hi=pw.reducers.max(pw.this.v),
        words=pw.reducers.sorted_tuple(pw.this.s),
    )


def build_join(pw):
    t = _base(pw)
    names = pw.debug.table_from_rows(pw.schema_from_types(k=int, name=str), [(i, f"group{i}") for i in range(0, 5, 2)])
    inner = t.join(names, pw.left.k == pw.right.k).select(pw.left.s, pw.right.name, pw.left.v)
    left = t.join_left(names, pw.left.k == pw.right.k).select(pw.left.s, name=pw.right.name)
    return inner, left


def build_deduplicate(pw):
    t = _base(pw)
    return t.deduplicate(value=pw.this.v, instance=pw.this.k, acceptor=lambda new, old: new > old)


def build_concat_and_update(pw):
    a = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(i,) for i in range(5)])
    b = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(i * 10,) for i in range(5)])
    return a.concat_reindex(b).select(y=pw.this.x + 1)


def _numpy_udf(pw):
    @pw.udf(batched=True)
    def scale(v):
        return np.asarray(v, dtype=np.float64) * 3.0

    return scale


def build_batched_udf_numpy(pw):
    t = _base(pw)
    return t.select(pw.this.k, scaled=_numpy_udf(pw)(pw.this.v))


def build_batched_udf_vectors(pw):
    """A batched UDF returning [B, d] rows: each cell is one row."""

    if pw is pathway_tpu_torch:

        @pw.udf(batched=True)
        def embed(s):
            n = len(s)
            base = torch.arange(n * 4, dtype=torch.float32).reshape(n, 4)
            return base / 7.0

    else:

        @pw.udf(batched=True)
        def embed(s):
            n = len(s)
            return np.arange(n * 4, dtype=np.float32).reshape(n, 4) / np.float32(7.0)

    t = _base(pw)
    return t.select(pw.this.k, vec=embed(pw.this.s))


def build_batched_udf_torch_scalar(pw):
    """A batched UDF of the port returning a 1-D torch tensor equals the
    reference's numpy UDF."""
    if pw is pathway_tpu_torch:

        @pw.udf(batched=True)
        def scale(v):
            return torch.as_tensor(np.asarray(v, dtype=np.float64)) * 3.0

    else:
        scale = _numpy_udf(pw)
    t = _base(pw)
    return t.select(pw.this.k, scaled=scale(pw.this.v))


def build_upsert_subject(pw):
    class S(pw.Schema):
        doc: int = pw.column_definition(primary_key=True)
        text: str

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(6):
                self.next(doc=i, text=f"v0-{i}")
            self.commit()
            for i in range(0, 6, 2):
                self.next(doc=i, text=f"v1-{i}")  # same key: an upsert
            self.commit()
            self.next(doc=1, text="v2-1")
            self.commit()

    # atomic batches: a poll never splits a commit, so ticks are structural
    t = pw.io.python.read(Subject(), schema=S, atomic_batches=True)
    gens = t.with_columns(gen=pw.this.text.str.slice(0, 2))
    counts = gens.groupby(pw.this.gen).reduce(pw.this.gen, n=pw.reducers.count())
    return t.select(pw.this.doc, pw.this.text), counts


def build_stream_with_deletes(pw):
    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(5):
                self.next(word=f"w{i % 3}", n=i)
            self.commit()
            self.delete(word="w1", n=1)
            self.commit()
            self.next(word="w9", n=9)
            self.commit()

    t = pw.io.python.read(Subject(), schema=pw.schema_from_types(word=str, n=int), atomic_batches=True)
    return t, t.groupby(pw.this.word).reduce(pw.this.word, total=pw.reducers.sum(pw.this.n))


def build_more_reducers(pw):
    t = _base(pw)
    return t.groupby(pw.this.k).reduce(
        pw.this.k,
        mean=pw.reducers.avg(pw.this.v),
        arg=pw.reducers.argmax(pw.this.v),
        tup=pw.reducers.sorted_tuple(pw.this.v),
        first=pw.reducers.earliest(pw.this.s),
        last=pw.reducers.latest(pw.this.s),
        anyk=pw.reducers.any(pw.this.k),
    )


def build_markdown_and_sort(pw):
    t = pw.debug.table_from_markdown(
        """
        name  | score | team
        alice | 7     | red
        bob   | 3     | blue
        carol | 9     | red
        dave  | 5     | blue
        erin  | 1     | red
        """
    )
    ranked = t.sort(key=pw.this.score)
    return t.with_columns(prev=ranked.prev, next=ranked.next)


def build_ix_and_pointers(pw):
    teams = pw.debug.table_from_rows(pw.schema_from_types(team=str, city=str), [("red", "oslo"), ("blue", "rome")])
    teams = teams.with_id_from(pw.this.team)
    people = pw.debug.table_from_rows(
        pw.schema_from_types(name=str, team=str), [(f"p{i}", "red" if i % 3 else "blue") for i in range(9)]
    )
    return people.select(pw.this.name, city=teams.ix(teams.pointer_from(people.team)).city)


def build_set_operations(pw):
    class S(pw.Schema):
        k: int = pw.column_definition(primary_key=True)
        v: int

    a = pw.debug.table_from_rows(S, [(i, i * i) for i in range(10)])
    b = pw.debug.table_from_rows(S, [(i, -i) for i in range(0, 10, 3)])
    return a.intersect(b), a.difference(b), a.update_rows(b), a.having(b.id)


def build_rename_cast_without(pw):
    t = _base(pw)
    return t.rename(score=pw.this.v).without(pw.this.s).cast_to_types(k=float)


def build_join_outer_and_right(pw):
    left = pw.debug.table_from_rows(pw.schema_from_types(k=int, a=str), [(i, f"a{i}") for i in range(6)])
    right = pw.debug.table_from_rows(pw.schema_from_types(k=int, b=str), [(i, f"b{i}") for i in range(3, 9)])
    outer = left.join_outer(right, pw.left.k == pw.right.k).select(a=pw.left.a, b=pw.right.b)
    rjoin = left.join_right(right, pw.left.k == pw.right.k).select(a=pw.left.a, b=pw.right.b)
    return outer, rjoin


def build_string_and_numeric_methods(pw):
    t = _base(pw)
    return t.select(
        low=pw.this.s.str.lower(),
        n=pw.this.s.str.len(),
        starts=pw.this.s.str.startswith("w1"),
        rounded=pw.this.v.num.round(1),
        absolute=pw.this.v.num.abs(),
        isnone=pw.this.s.is_none(),
    )


def build_streamed_join_groupby(pw):
    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for step in range(4):
                for i in range(6):
                    self.next(user=f"u{i % 3}", amount=step * 10 + i)
                self.commit()
            self.delete(user="u0", amount=0)
            self.commit()

    events = pw.io.python.read(
        Subject(), schema=pw.schema_from_types(user=str, amount=int), atomic_batches=True
    )
    names = pw.debug.table_from_rows(pw.schema_from_types(user=str, label=str), [("u0", "zero"), ("u1", "one")])
    totals = events.groupby(pw.this.user).reduce(pw.this.user, total=pw.reducers.sum(pw.this.amount))
    return totals.join(names, pw.left.user == pw.right.user).select(pw.right.label, pw.left.total)


def build_error_cells(pw):
    """Failing cells become Error values; filters drop them; fill_error
    replaces them (reference: error_value.py)."""
    t = pw.debug.table_from_rows(pw.schema_from_types(a=int, b=int), [(i, i % 3) for i in range(9)])
    withc = t.with_columns(c=pw.apply_with_type(lambda a, b: int(a) // int(b), int, pw.this.a, pw.this.b))
    return withc, withc.filter(pw.this.c > 0), withc.with_columns(c=pw.fill_error(pw.this.c, -1))


def build_async_udf(pw):
    @pw.udf_async
    async def inverse(x: int) -> float:
        return 12.0 / x

    t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(i,) for i in range(1, 7)])
    return t.select(pw.this.x, inv=inverse(pw.this.x))


def build_asof_now_join_stream(pw):
    """Queries answered against the prices as of their arrival; later
    price commits do not update earlier answers."""

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for item in ("a", "b"):
                self.next(kind="price", item=item, value=1)
            self.commit()
            self.next(kind="query", item="a", value=0)
            self.commit()
            self.next(kind="price", item="a", value=2)
            self.commit()
            self.next(kind="query", item="a", value=1)
            self.commit()

    rows = pw.io.python.read(
        Subject(), schema=pw.schema_from_types(kind=str, item=str, value=int), atomic_batches=True
    )
    prices = rows.filter(pw.this.kind == "price").groupby(pw.this.item).reduce(
        pw.this.item, price=pw.reducers.max(pw.this.value)
    )
    queries = rows.filter(pw.this.kind == "query")
    return queries.asof_now_join(prices, pw.left.item == pw.right.item).select(
        q=pw.left.value, price=pw.right.price
    )


def build_concat_disjoint(pw):
    a = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(i,) for i in range(4)])
    b = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(i,) for i in range(10, 14)]).with_id_from(pw.this.x)
    pw.universes.promise_are_pairwise_disjoint(a, b)
    return a.concat(b).select(y=pw.this.x * 2)


BUILDERS = [
    build_select_filter_with_columns,
    build_expressions,
    build_flatten,
    build_flatten_stream,
    build_groupby_reduce,
    build_join,
    build_deduplicate,
    build_concat_and_update,
    build_batched_udf_numpy,
    build_batched_udf_vectors,
    build_batched_udf_torch_scalar,
    build_upsert_subject,
    build_stream_with_deletes,
    build_more_reducers,
    build_markdown_and_sort,
    build_ix_and_pointers,
    build_set_operations,
    build_rename_cast_without,
    build_join_outer_and_right,
    build_string_and_numeric_methods,
    build_streamed_join_groupby,
    build_error_cells,
    build_async_udf,
    build_asof_now_join_stream,
    build_concat_disjoint,
]


@pytest.mark.parametrize("build", BUILDERS, ids=[b.__name__[len("build_"):] for b in BUILDERS])
def test_pipeline_rows_and_update_stream_equal_reference(build):
    ref = _run(pathway_tpu, build)
    pathway_tpu.reset()
    port = _run(pathway_tpu_torch, build)
    assert len(port) == len(ref)
    for (ref_stream, ref_rows), (port_stream, port_rows) in zip(ref, port):
        assert port_rows == ref_rows
        assert port_stream == ref_stream
        assert ref_rows  # the pipeline produced rows


def test_upsert_stream_retracts_the_old_row():
    (stream, rows), _counts = _run(pathway_tpu_torch, build_upsert_subject)
    assert len(stream) == 3  # one tick per commit
    second = stream[1]
    assert sum(1 for _k, _r, d in second if d < 0) == 3  # three upserts retract
    assert len(rows) == 6


def test_batched_udf_cuda_tensor_comes_to_host():
    """The expression layer brings a UDF's tensor to host with
    ``.cpu().numpy()`` (``np.asarray`` of a CUDA tensor fails); on the CPU
    the same path takes a CPU tensor."""
    pw = pathway_tpu_torch

    @pw.udf(batched=True)
    def vec(v):
        return torch.ones(len(v), 3, dtype=torch.float32)

    t = _base(pw).select(out=vec(pw.this.v))
    _keys, cols = t._materialize()
    pw.run(monitoring_level=None)
    _keys, cols = t._materialize()
    assert all(isinstance(c, np.ndarray) and c.tolist() == [1.0, 1.0, 1.0] for c in cols["out"])


def test_dtype_of_a_tensor_is_an_array():
    from pathway_tpu_torch.internals import dtype as dt

    t = torch.zeros(2, 3)
    assert dt.dtype_of_value(t) == dt.Array(n_dim=2, wrapped=dt.FLOAT)
    assert dt.Array(n_dim=2).is_value_compatible(t)
    assert not dt.Array(n_dim=1).is_value_compatible(t)


@pytest.mark.parametrize(
    "name", ["io.kafka.read", "io.postgres.write", "io.s3.read", "io.nats.read", "io.mongodb.write",
             "io.elasticsearch.write", "io.debezium.read"]
)
def test_unported_names_raise_and_name_their_slice(name):
    target = pathway_tpu_torch
    for part in name.split("."):
        target = getattr(target, part)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, framework slice"):
        target()


def test_run_refuses_a_cluster_and_persistence(monkeypatch):
    """``pw.run`` joins the cluster first (it no longer refuses one): under
    ``PATHWAY_PROCESSES=2`` it calls ``distributed.maybe_initialize``
    before anything else, and the run goes on over what it answers (here
    a stand-in that stays one process; two real ranks are
    ``tests/test_torch_cluster.py``).  Under OPERATOR_PERSISTING it
    refuses a graph with an operator whose state no snapshot carries (here
    ``update_rows``), naming it; a persistence config it can honour
    records the run, and a restart replays it."""
    from pathway_tpu_torch.parallel import distributed

    pw = pathway_tpu_torch
    t = _base(pw)
    joined = []
    with monkeypatch.context() as m:
        m.setattr(distributed, "maybe_initialize", lambda: joined.append(distributed.topology_from_env()))
        m.setenv("PATHWAY_PROCESSES", "2")
        pw.run()
    assert [j[0] for j in joined] == [2]
    assert len(t._materialize()[0]) == len(_rows())
    pw.reset()
    t = _base(pw)
    t.update_rows(t.filter(pw.this.k > 2))
    operator_mode = pw.persistence.Config.simple_config(
        pw.persistence.Backend.mock(), persistence_mode=pw.PersistenceMode.OPERATOR_PERSISTING
    )
    with pytest.raises(ValueError, match="UpdateRowsOperator.*PersistenceMode.PERSISTING"):
        pw.run(persistence_config=operator_mode)
    backend = pw.persistence.Backend.mock()
    runs = []
    for rows in (_rows(), []):  # the restart's subject sends nothing: its rows replay from the log
        pw.reset()

        class Subject(pw.io.python.ConnectorSubject):
            def run(self, rows=rows):
                for k, v, s_ in rows:
                    self.next(k=k, v=v, s=s_)

        src = pw.io.python.read(Subject(), schema=pw.schema_from_types(k=int, v=float, s=str), persistent_id="base")
        out = build_groupby_reduce_over(pw, src)
        pw.run(persistence_config=pw.persistence.Config.simple_config(backend, snapshot_interval_ms=1))
        keys, cols = out._materialize()
        runs.append(sorted((int(key), *(cols[c][i] for c in sorted(cols))) for i, key in enumerate(keys)))
    assert runs[0] == runs[1] and runs[0]
    assert [k for k in backend.make_store().list_keys() if k.startswith("sources/base/chunk-")]


@pytest.mark.parametrize("stream", [False, True], ids=["snapshot", "update_stream"])
def test_debug_printing_equals_reference(capsys, stream):
    """``pw.debug.compute_and_print`` (and its update-stream flavour) print
    the same text in both packages: same ids, same rows, same order (the
    update stream's wall-clock ``time`` column aside)."""
    outputs = []
    for pw in (pathway_tpu, pathway_tpu_torch):
        pw.reset()
        t = build_groupby_reduce(pw)
        if stream:
            pw.debug.compute_and_print_update_stream(t)
        else:
            pw.debug.compute_and_print(t)
        out = capsys.readouterr().out
        if stream:
            out = "\n".join(line.split("|", 1)[-1] for line in out.splitlines())
        outputs.append(out)
    assert outputs[0] == outputs[1]
    assert outputs[1].count("\n") >= 5
