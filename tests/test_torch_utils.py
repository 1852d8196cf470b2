"""``pw.utils`` of the port against the reference: ``AsyncTransformer``,
the column utilities (``col.py``), ``pandas_transformer`` and the
deprecated ``asynchronous`` module.

Each case runs through both packages on the same rows; the keyed rows
must be equal.  ``AsyncTransformer`` results arrive by thread timing, so
its cases compare final rows only.  Every value is an int or a string,
compared exactly, except the pandas case's floats, compared within 1e-12.
"""

import importlib
import logging
import sys
import warnings

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


def _keyed(table):
    keys, cols = table._materialize()
    return sorted(
        (int(k), tuple(v.item() if isinstance(v, np.generic) else v for v in (cols[n][i] for n in table.column_names)))
        for i, k in enumerate(keys)
    )


_WORDS = """
word  | cnt
alpha | 1
beta  | 2
gamma | 3
delta | 4
"""


def _doubler(pw, fail_on=None):
    class Out(pw.Schema):
        word: str
        doubled: int

    class Doubler(pw.AsyncTransformer):
        output_schema = Out

        async def invoke(self, word, cnt):
            import asyncio

            await asyncio.sleep(0.01)
            if word == fail_on:
                raise RuntimeError(f"the service refused {word}")
            return {"word": word, "doubled": cnt * 2}

    return Doubler


# -- AsyncTransformer -------------------------------------------------------------------


def test_async_transformer_batch_run_quiesces_as_the_reference():
    """``tests/test_udf.py``'s case: a batch run returns once every
    invocation has landed, with every row, in both packages."""
    got = []
    for pw in PACKAGES:
        table = pw.debug.table_from_markdown(_WORDS)
        result = _doubler(pw)(input_table=table).successful
        pw.run(monitoring_level=None, commit_duration_ms=50)
        got.append(_keyed(result))
    assert got[1] == got[0]
    assert sorted(row for _key, row in got[1]) == [("alpha", 2), ("beta", 4), ("delta", 8), ("gamma", 6)]


def test_async_transformer_over_a_stream_equals_the_reference():
    """Rows committed over time through ``pw.io.python``; the call form
    ``Transformer()(table)``; results keyed by their input rows."""
    got = []
    rows = [(f"w{i}", int(v)) for i, v in enumerate(np.random.default_rng(4).integers(0, 50, 24))]
    for pw in PACKAGES:

        class In(pw.Schema):
            word: str = pw.column_definition(primary_key=True)
            cnt: int

        class Subj(pw.io.python.ConnectorSubject):
            def run(self):
                for i, (word, cnt) in enumerate(rows):
                    self.next(word=word, cnt=cnt)
                    if i % 8 == 7:
                        self.commit()

        table = pw.io.python.read(Subj(), schema=In)
        result = _doubler(pw)()(table).output_table
        pw.run(monitoring_level=None, commit_duration_ms=20)
        got.append(_keyed(result))
    assert got[1] == got[0]
    assert sorted(row for _key, row in got[1]) == sorted((w, 2 * c) for w, c in rows)


def test_async_transformer_drops_and_logs_a_failed_invocation_as_the_reference(caplog):
    got = []
    for pw in PACKAGES:
        caplog.clear()
        table = pw.debug.table_from_markdown(_WORDS)
        with caplog.at_level(logging.ERROR):
            result = _doubler(pw, fail_on="beta")(input_table=table).successful
            pw.run(monitoring_level=None, commit_duration_ms=50)
        logged = [r for r in caplog.records if r.getMessage() == "AsyncTransformer.invoke failed"]
        assert len(logged) == 1 and "the service refused beta" in str(logged[0].exc_info[1])
        got.append(_keyed(result))
    assert got[1] == got[0]
    assert sorted(row for _key, row in got[1]) == [("alpha", 2), ("delta", 8), ("gamma", 6)]


@pytest.mark.parametrize("options", [{"capacity": 4}, {"timeout": 1.0}, {"retry_strategy": None, "capacity": 2}])
def test_with_options_refuses_what_the_reference_drops(options):
    """The reference's ``with_options`` returns the transformer whatever it
    is given (the options do nothing); the port returns it for no option
    and raises for any option, naming it."""
    ref, port = (_doubler(pw)() for pw in PACKAGES)
    assert ref.with_options(**options) is ref
    assert port.with_options() is port
    with pytest.raises(NotImplementedError, match=sorted(options)[0]):
        port.with_options(**options)


def test_async_transformer_refuses_the_options_the_reference_drops():
    """The reference keeps ``AsyncTransformer(table, **kwargs)``'s options
    and uses none of them; the port raises, naming them."""
    ref_table, port_table = (pw.debug.table_from_markdown(_WORDS) for pw in PACKAGES)
    assert _doubler(pathway_tpu)(input_table=ref_table, instance=1).successful is not None
    with pytest.raises(NotImplementedError, match="autocommit_duration_ms, instance"):
        _doubler(pathway_tpu_torch)(input_table=port_table, instance=1, autocommit_duration_ms=50)


# -- col.py -------------------------------------------------------------------------------


def _pairs(pw):
    rng = np.random.default_rng(11)
    rows = [(int(a), int(b), f"s{int(a) % 3}") for a, b in rng.integers(0, 20, (12, 2))]
    return pw.debug.table_from_rows(pw.schema_from_types(a=int, b=int, s=str), rows)


def build_unpack_col(pw):
    from_pkg = importlib.import_module(f"{pw.__name__}.stdlib.utils.col")
    t = _pairs(pw).select(tup=pw.make_tuple(pw.this.a, pw.this.s, pw.this.b))
    by_names = from_pkg.unpack_col(t.tup, "x", "y", "z")
    by_schema = pw.utils.unpack_col(t.tup, schema=pw.schema_from_types(p=int, q=str, r=int))
    return by_names, by_schema


def build_apply_all_rows(pw):
    t = _pairs(pw)

    def ranks(a, b):
        order = sorted(range(len(a)), key=lambda i: (a[i] + b[i], i))
        out = [0] * len(a)
        for r, i in enumerate(order):
            out[i] = r
        return out

    return (
        pw.utils.apply_all_rows(t.a, t.b, fun=ranks, result_col_name="rank"),
        pw.utils.multiapply_all_rows(t.a, fun=lambda a: [x - min(a) for x in a], result_col_name="off"),
    )


def build_flatten_column(pw):
    t = _pairs(pw).select(pw.this.a, parts=pw.apply(lambda s, b: tuple(s * (b % 3)), pw.this.s, pw.this.b))
    return pw.utils.flatten_column(t.parts)


@pytest.mark.parametrize("build", [build_unpack_col, build_apply_all_rows, build_flatten_column],
                         ids=lambda b: b.__name__[len("build_"):])
def test_col_utilities_equal_reference(build):
    ref, port = (_run(pw, build) for pw in PACKAGES)
    assert port == ref
    assert all(rows for _stream, rows in port)


def test_flatten_column_refuses_the_origin_id_the_reference_drops():
    """The reference's ``flatten_column(col, origin_id=...)`` gives rows
    without an origin column; the port raises."""
    ref, port = (_pairs(pw).select(pw.this.a, parts=pw.make_tuple(pw.this.a, pw.this.b)) for pw in PACKAGES)
    assert "origin" not in pathway_tpu.utils.flatten_column(ref.parts, origin_id="origin").column_names
    with pytest.raises(NotImplementedError, match="origin_id='origin'"):
        pathway_tpu_torch.utils.flatten_column(port.parts, origin_id="origin")


# -- pandas_transformer ---------------------------------------------------------------


def test_pandas_transformer_single_input_equals_the_reference():
    """``tests/test_api_parity.py``'s case: the output keeps the input's
    universe (``output_universe=0``)."""
    import pandas as pd

    def build(pw):
        class OutSchema(pw.Schema):
            doubled: int

        @pw.pandas_transformer(output_schema=OutSchema, output_universe=0)
        def double(df: pd.DataFrame) -> pd.DataFrame:
            return pd.DataFrame({"doubled": df["a"] * 2}, index=df.index)

        t = pw.debug.table_from_markdown("""
          | a
        1 | 3
        2 | 5
        """)
        return double(t), t

    ref, port = (_run(pw, build) for pw in PACKAGES)
    assert port == ref
    (_s, out), (_s2, inp) = port
    assert sorted(dict(r)["doubled"] for _k, r in out) == [6, 10]
    assert [k for k, _r in out] == [k for k, _r in inp]


def test_pandas_transformer_no_input_and_two_inputs_equal_the_reference():
    import pandas as pd

    def build(pw):
        class V(pw.Schema):
            v: int

        class Joined(pw.Schema):
            name: str
            total: float

        @pw.pandas_transformer(output_schema=V)
        def make() -> pd.DataFrame:
            return pd.DataFrame({"v": [1, 2, 3]})

        @pw.pandas_transformer(output_schema=Joined)
        def per_name(left: pd.DataFrame, right: pd.DataFrame) -> pd.DataFrame:
            merged = left.merge(right, on="k")
            out = merged.groupby("name", as_index=False)["x"].sum()
            return pd.DataFrame({"name": out["name"], "total": out["x"] * 0.5}).set_index("name", drop=False)

        rng = np.random.default_rng(5)
        left = pw.debug.table_from_rows(pw.schema_from_types(k=int, x=float),
                                        [(int(k), float(x)) for k, x in zip(rng.integers(0, 4, 10), rng.random(10))])
        right = pw.debug.table_from_rows(pw.schema_from_types(k=int, name=str), [(i, f"n{i % 2}") for i in range(4)])
        return make(), per_name(left, right)

    ref, port = (_run(pw, build) for pw in PACKAGES)
    assert [rows for _s, rows in port][0] == [rows for _s, rows in ref][0]
    assert sorted(dict(r)["v"] for _k, r in port[0][1]) == [1, 2, 3]
    ref_totals, port_totals = ({dict(r)["name"]: dict(r)["total"] for _k, r in side[1][1]} for side in (ref, port))
    assert sorted(port_totals) == sorted(ref_totals) == ["n0", "n1"]
    assert all(abs(port_totals[n] - ref_totals[n]) <= 1e-12 for n in ref_totals)
    assert [k for k, _r in port[1][1]] == [k for k, _r in ref[1][1]]


def test_pandas_transformer_refuses_a_wrong_universe_as_the_reference():
    for pw in PACKAGES:
        with pytest.raises(ValueError, match="No argument of name"):
            pw.pandas_transformer(output_schema=pw.schema_from_types(v=int), output_universe="nope")(lambda df: df)


def test_pandas_transformer_imports_pandas_on_call_only(monkeypatch):
    """Without pandas (the card's machine has none) decorating works and
    the call raises ``ImportError``, as the reference's does."""
    monkeypatch.setitem(sys.modules, "pandas", None)
    for pw in PACKAGES:
        wrapped = pw.pandas_transformer(output_schema=pw.schema_from_types(v=int))(lambda: None)
        with pytest.raises(ImportError):
            wrapped()


# -- asynchronous -------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["pathway_tpu", "pathway_tpu_torch"])
def test_asynchronous_warns_and_reexports_udfs(pkg, monkeypatch):
    monkeypatch.delitem(sys.modules, f"{pkg}.asynchronous", raising=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mod = importlib.import_module(f"{pkg}.asynchronous")
    assert [w.category for w in caught if "asynchronous is deprecated" in str(w.message)] == [DeprecationWarning]
    udfs = importlib.import_module(f"{pkg}.internals.udfs")
    for name in ("AsyncRetryStrategy", "CacheStrategy", "DefaultCache", "DiskCache", "ExponentialBackoffRetryStrategy",
                 "FixedDelayRetryStrategy", "InMemoryCache", "NoRetryStrategy", "async_options", "coerce_async",
                 "with_capacity", "with_timeout"):
        assert getattr(mod, name) is getattr(udfs, name)
