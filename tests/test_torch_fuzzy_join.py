"""The fuzzy joins (``pw.ml.smart_table_ops``), the HMM reducer
(``pw.ml.hmm``) and the other cases of ``tests/test_fuzzy_join.py``, in
the port against the reference.

Each case runs through both packages on the same rows: keyed rows and
update streams, tick by tick, must be equal, and the port's rows must pass
the reference test's own checks.  Match weights are sums of the same
feature weights, compared exactly; a seeded case adds random names with
typos.
"""

import math

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


def _both(build):
    ref, port = (_run(pw, build) for pw in PACKAGES)
    assert port == ref
    return port


def _by_key(rows):
    return {key: dict(row) for key, row in rows}


def _pairs(port, left_rows, right_rows, lcol, rcol, match=0):
    """(left value, right value) of each match row."""
    left, right = _by_key(left_rows), _by_key(right_rows)
    return {(left[int(m["left"])][lcol], right[int(m["right"])][rcol]) for m in _by_key(port[match][1]).values()}


def build_fuzzy_match_tables(pw):
    left = pw.Table.from_rows(
        [{"name": "John Smith", "city": "Warsaw"}, {"name": "Alice Jones", "city": "Paris"},
         {"name": "Bob Unmatched Entirely", "city": "Xyzzy"}], name="left",
    )
    right = pw.Table.from_rows(
        [{"fullname": "Smith John", "town": "Warsaw"}, {"fullname": "Jones Alice", "town": "Paris"}], name="right"
    )
    return pw.ml.fuzzy_match_tables(left, right), left, right


def test_fuzzy_match_tables_equals_reference():
    port = _both(build_fuzzy_match_tables)
    got = _pairs(port, port[1][1], port[2][1], "name", "fullname")
    assert {("John Smith", "Smith John"), ("Alice Jones", "Jones Alice")} <= got
    lefts = [m["left"] for m in _by_key(port[0][1]).values()]
    assert len(lefts) == len(set(lefts))


def build_letters(pw):
    left = pw.Table.from_rows([{"v": "kitten"}, {"v": "zzzzz"}], name="l")
    right = pw.Table.from_rows([{"v": "sitting"}, {"v": "qqqqq"}], name="r")
    m = pw.ml.smart_fuzzy_match(left.v, right.v, feature_generation=pw.ml.FuzzyJoinFeatureGeneration.LETTERS)
    return m, left, right


def test_smart_fuzzy_match_letters_equals_reference():
    port = _both(build_letters)
    got = _pairs(port, port[1][1], port[2][1], "v", "v")
    assert ("kitten", "sitting") in got and ("zzzzz", "qqqqq") not in got


def build_self_match(pw):
    t = pw.Table.from_rows(
        [{"v": "the quick brown fox"}, {"v": "the quick brown foxes"}, {"v": "completely different words here"}],
        name="t",
    )
    return pw.ml.fuzzy_self_match(t.v), t


def test_fuzzy_self_match_equals_reference():
    port = _both(build_self_match)
    got = _pairs(port, port[1][1], port[1][1], "v", "v")
    pair = ("the quick brown fox", "the quick brown foxes")
    assert pair in got or tuple(reversed(pair)) in got
    assert all(a != b for a, b in got)


def build_one_match(pw):
    left = pw.Table.from_rows([{"name": "aaa bbb"}], name="l2")
    right = pw.Table.from_rows([{"name": "aaa bbb"}, {"name": "ccc ddd"}], name="r2")
    return pw.ml.fuzzy_match_tables(left, right)


def test_fuzzy_match_one_row_equals_reference():
    port = _both(build_one_match)
    assert len(port[0][1]) == 1


@pytest.mark.parametrize("normalization", ["WEIGHT", "LOGWEIGHT", "NONE"])
def test_seeded_names_with_typos_equal_reference(normalization):
    """40 seeded two-word names against copies with one letter changed,
    in another order, with each normalisation and a projection of the
    columns into buckets; ``fuzzy_match`` is ``smart_fuzzy_match``."""
    rng = np.random.default_rng(9)
    letters = "abcdefghij"
    names = [" ".join("".join(rng.choice(list(letters), 5)) for _ in range(2)) for _ in range(40)]
    typos = []
    for name in names:
        i = int(rng.integers(0, len(name)))
        typos.append(name[:i] + ("x" if name[i] != " " else " ") + name[i + 1:])
    order = rng.permutation(len(names))

    def build(pw):
        left = pw.Table.from_rows([{"name": n, "tag": f"t{i % 3}"} for i, n in enumerate(names)], name="names")
        right = pw.Table.from_rows([{"name": typos[i], "tag": f"t{i % 3}"} for i in order], name="typos")
        norm = getattr(pw.ml.FuzzyJoinNormalization, normalization)
        return (
            pw.ml.fuzzy_match(left.name, right.name, normalization=norm,
                              feature_generation=pw.ml.FuzzyJoinFeatureGeneration.LETTERS),
            pw.ml.fuzzy_match_tables(left, right, normalization=norm, left_projection={"name": "n", "tag": "t"},
                                     right_projection={"name": "n", "tag": "t"}),
        )

    port = _both(build)
    assert len(port[0][1]) > 0 and len(port[1][1]) > 0


def build_hmm(pw):
    import networkx as nx

    def emission(state):
        def calc(obs):
            return math.log(0.9 if obs == state else 0.1)

        return calc

    g = nx.DiGraph()
    for s in ("rain", "sun"):
        g.add_node(s, calc_emission_log_ppb=emission(s))
    for a in ("rain", "sun"):
        for b in ("rain", "sun"):
            g.add_edge(a, b, log_transition_ppb=math.log(0.8 if a == b else 0.2))
    g.graph["start_nodes"] = ["rain", "sun"]
    hmm = pw.ml.create_hmm_reducer(g)
    rng = np.random.default_rng(2)
    seeded = ["rain" if x < 0.5 else "sun" for x in rng.random(12)]
    t = pw.Table.from_rows(
        [{"g": 1, "obs": o} for o in ["rain", "rain", "sun", "sun"]] + [{"g": 2, "obs": o} for o in seeded],
        name="obs",
    )
    beam = pw.ml.hmm.create_hmm_reducer(g, beam_size=1, num_results_kept=3)
    return t.groupby(pw.this.g).reduce(pw.this.g, path=hmm(pw.this.obs), tail=beam(pw.this.obs))


def test_hmm_reducer_viterbi_equals_reference():
    port = _both(build_hmm)
    paths = {r["g"]: r for r in _by_key(port[0][1]).values()}
    assert paths[1]["path"] == ("tuple", ("rain", "rain", "sun", "sun"))
    assert len(paths[2]["path"][1]) == 12 and len(paths[2]["tail"][1]) == 3


def test_viz_show_and_snapshot_equal_reference(capsys):
    got = []
    for pw in PACKAGES:
        t = pw.Table.from_rows([{"a": 1, "b": "x"}, {"a": 2, "b": "y"}], name="vz")
        pw.run(monitoring_level=None)
        snap = pw.viz.table_snapshot(t)
        pw.viz.show(t, include_id=False)
        got.append((sorted(tuple(sorted(r.items())) for r in snap), capsys.readouterr().out))
    assert got[1] == got[0]
    assert {dict(r)["a"] for r in got[1][0]} == {1, 2}
    assert "a" in got[1][1] and "x" in got[1][1]


def build_stateful_order(pw):
    @pw.reducers.stateful_many
    def record_order(state, rows):
        return tuple(r[0] for r in rows)

    t = pw.Table.from_rows([{"g": 1, "v": v} for v in ["sun", "rain", "sun", "fog", "rain"]], name="obs_order")
    return t.groupby(pw.this.g).reduce(seq=record_order(pw.this.v))


def test_stateful_reducer_order_equals_reference():
    port = _both(build_stateful_order)
    (row,) = _by_key(port[0][1]).values()
    assert row["seq"] == ("tuple", ("sun", "rain", "sun", "fog", "rain"))
