"""``pw.sql`` of the port against the reference.

Each case of ``tests/test_sql.py`` is built through ``pathway_tpu`` and
through ``pathway_tpu_torch`` on the same rows: the keyed rows and the
``(key, row, diff)`` update stream, tick by tick, must be equal, and the
rows must be the reference test's expected rows.  The streaming case
(rows entering and leaving a ``LIMIT`` window) aligns ticks by thread
timing, so it compares final rows only.  A seeded case runs a query over
random rows through both packages and holds it against a plain Python
computation.  Every value is an int or a string, compared exactly, except
``AVG``, compared within 1e-12.
"""

import time

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.io import _connector as ref_connector
from pathway_tpu_torch.io import _connector as port_connector

from .test_torch_table import _run

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


def _md(pw, text):
    return pw.debug.table_from_markdown(text)


def _kv(pw):
    return _md(pw, """
    k | v
    a | 3
    b | 1
    a | 2
    """)


def build_select_where_projection(pw):
    return pw.sql("SELECT k, v + 1 AS w FROM t WHERE v > 1", t=_kv(pw))


def build_group_by_having(pw):
    t = _md(pw, """
    k | v
    a | 3
    b | 1
    a | 2
    b | 9
    c | 1
    """)
    return pw.sql("SELECT k, SUM(v) AS s, COUNT(*) AS n FROM t GROUP BY k HAVING SUM(v) > 2", t=t)


def build_join_on(pw):
    a = _md(pw, """
    k | x
    1 | 10
    2 | 20
    """)
    b = _md(pw, """
    k | y
    1 | 7
    3 | 9
    """)
    return pw.sql("SELECT x, y FROM a JOIN b ON a.k = b.k", a=a, b=b)


def build_order_by_limit(pw):
    t = _md(pw, """
    k | v
    a | 3
    b | 1
    a | 2
    c | 5
    b | 4
    """)
    return pw.sql("SELECT k, v FROM t ORDER BY v DESC LIMIT 2", t=t)


def build_order_by_multi_key_asc_desc(pw):
    t = _md(pw, """
    k | v
    a | 2
    b | 2
    a | 1
    """)
    return pw.sql("SELECT k, v FROM t ORDER BY v DESC, k ASC LIMIT 2", t=t)


def build_subquery_in_from(pw):
    return pw.sql("SELECT k, s FROM (SELECT k, SUM(v) AS s FROM t GROUP BY k) sub WHERE s > 2", t=_kv(pw))


def build_with_cte(pw):
    t = _md(pw, """
    k | v
    a | 3
    b | 1
    """)
    return pw.sql("WITH big AS (SELECT k, v FROM t WHERE v > 2), named AS (SELECT k FROM big) SELECT k FROM named", t=t)


def build_scalar_aggregate_subquery(pw):
    t = _md(pw, """
    k | v
    a | 3
    b | 1
    c | 5
    """)
    return pw.sql("SELECT k, v FROM t WHERE v > (SELECT AVG(v) FROM t)", t=t)


def build_union_intersect_except(pw):
    def tables():
        a = _md(pw, """
        x
        1
        2
        2
        """)
        b = _md(pw, """
        x
        2
        3
        """)
        return {"a": a, "b": b}

    return tuple(
        pw.sql(f"SELECT x FROM a {op} SELECT x FROM b", **tables())
        for op in ("UNION", "UNION ALL", "INTERSECT", "EXCEPT")
    )


def build_case_when(pw):
    t = _md(pw, """
    v
    1
    5
    """)
    return pw.sql("SELECT CASE WHEN v > 3 THEN 'big' ELSE 'small' END AS size FROM t", t=t)


# each case with the rows ``tests/test_sql.py`` expects, per output
CASES = {
    build_select_where_projection: [[{"k": "a", "w": 4}, {"k": "a", "w": 3}]],
    build_group_by_having: [[{"k": "a", "s": 5, "n": 2}, {"k": "b", "s": 10, "n": 2}]],
    build_join_on: [[{"x": 10, "y": 7}]],
    build_order_by_limit: [[{"k": "c", "v": 5}, {"k": "b", "v": 4}]],
    build_order_by_multi_key_asc_desc: [[{"k": "a", "v": 2}, {"k": "b", "v": 2}]],
    build_subquery_in_from: [[{"k": "a", "s": 5}]],
    build_with_cte: [[{"k": "a"}]],
    build_scalar_aggregate_subquery: [[{"k": "c", "v": 5}]],
    build_union_intersect_except: [
        [{"x": 1}, {"x": 2}, {"x": 3}],
        [{"x": 1}, {"x": 2}, {"x": 2}, {"x": 2}, {"x": 3}],
        [{"x": 2}],
        [{"x": 1}],
    ],
    build_case_when: [[{"size": "small"}, {"size": "big"}]],
}


def _values(rows):
    """Final keyed rows as sorted tuples of values in column-name order."""
    return sorted(tuple(v for _c, v in row) for _key, row in rows)


def _expected(dicts):
    return sorted(tuple(d[c] for c in sorted(d)) for d in dicts)


@pytest.mark.parametrize("build", list(CASES), ids=lambda b: b.__name__[len("build_"):])
def test_sql_equals_reference(build):
    ref, port = (_run(pw, build) for pw in PACKAGES)
    assert port == ref
    assert [_values(rows) for _stream, rows in port] == [_expected(e) for e in CASES[build]]


def test_limit_window_tracks_streaming_updates_as_the_reference():
    """Rows entering and leaving the ``LIMIT`` window under live updates:
    both packages end at the same rows, the top two."""
    got = []
    for pw in PACKAGES:
        pw.reset()

        class Row(pw.Schema):
            k: str = pw.column_definition(primary_key=True)
            v: int

        class Subj(pw.io.python.ConnectorSubject):
            def run(self):
                self.next(k="a", v=3)
                self.next(k="b", v=1)
                time.sleep(0.4)
                self.next(k="c", v=9)  # evicts b from the top 2

        src = pw.io.python.read(Subj(), schema=Row)
        top2 = pw.sql("SELECT k, v FROM src ORDER BY v DESC LIMIT 2", src=src)
        pw.run(monitoring_level=None, commit_duration_ms=100)
        keys, cols = top2._materialize()
        got.append(sorted((int(k), cols["k"][i], int(cols["v"][i])) for i, k in enumerate(keys)))
    assert got[1] == got[0]
    assert [(k, v) for _key, k, v in got[1]] == [("a", 3), ("c", 9)]


def test_union_of_mismatched_columns_raises_as_the_reference():
    for pw in PACKAGES:
        a = _md(pw, """
        x
        1
        """)
        b = _md(pw, """
        y
        2
        """)
        with pytest.raises(ValueError, match="matching column names"):
            pw.sql("SELECT x FROM a UNION SELECT y FROM b", a=a, b=b)


def _seeded_rows(n=60, seed=7):
    rng = np.random.default_rng(seed)
    return [(f"g{int(rng.integers(0, 6))}", int(rng.integers(-5, 20)), int(rng.integers(0, 3))) for _ in range(n)]


def test_seeded_query_equals_reference_and_a_plain_computation():
    """A ``WHERE`` / ``GROUP BY`` / ``HAVING`` query with ``AVG``, a join,
    and an ``ORDER BY ... LIMIT`` over 60 seeded rows."""
    rows = _seeded_rows()

    def build(pw):
        t = pw.debug.table_from_rows(pw.schema_from_types(k=str, v=int, c=int), rows)
        names = pw.debug.table_from_rows(pw.schema_from_types(c=int, label=str), [(0, "zero"), (1, "one"), (2, "two")])
        grouped = pw.sql(
            "SELECT k, SUM(v) AS s, COUNT(*) AS n, MAX(v) AS m, AVG(v) AS a FROM t WHERE v > 2 GROUP BY k "
            "HAVING COUNT(*) > 3", t=t,
        )
        joined = pw.sql("SELECT k, v, label FROM t JOIN names ON t.c = names.c WHERE v < 0", t=t, names=names)
        top = pw.sql("SELECT k, v FROM t ORDER BY v DESC, k ASC LIMIT 5", t=t)
        return grouped, joined, top

    ref, port = (_run(pw, build) for pw in PACKAGES)
    assert port == ref
    (_s1, grouped), (_s2, joined), (_s3, top) = port
    groups = {}
    for k, v, _c in rows:
        if v > 2:
            groups.setdefault(k, []).append(v)
    want = {k: (sum(vs), len(vs), max(vs), sum(vs) / len(vs)) for k, vs in groups.items() if len(vs) > 3}
    got = {dict(r)["k"]: (dict(r)["s"], dict(r)["n"], dict(r)["m"], dict(r)["a"]) for _key, r in grouped}
    assert sorted(got) == sorted(want)
    for k, (s, n_, m, a) in want.items():
        assert got[k][:3] == (s, n_, m)
        assert abs(got[k][3] - a) <= 1e-12
    label = {0: "zero", 1: "one", 2: "two"}
    assert _values(joined) == sorted((k, label[c], v) for k, v, c in rows if v < 0)
    assert _values(top) == sorted(sorted(((k, v) for k, v, _c in rows), key=lambda r: (-r[1], r[0]))[:5])
