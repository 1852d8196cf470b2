"""Row transformers (``pw.transformer``, ``pw.ClassArg`` and the attribute
decorators) of the port against the reference.

The cases of ``tests/test_row_transformer.py`` (a linked list's lengths by
recursion, a method and a pointer chase across two argument tables, an
upsert re-evaluated) and a seeded linked list in shuffled order run through
both packages: the keyed rows must be equal (methods by their row and
name), and equal to a plain Python loop.  Every value is an int, compared
exactly.
"""

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


def _cell(value):
    if callable(value):  # a materialised @pw.method: its row and name
        return ("method", value._key, value._name)
    if isinstance(value, np.generic):
        return value.item()
    return value


def _by_key(table):
    keys, cols = table._materialize()
    return {int(k): {n: _cell(cols[n][i]) for n in table.column_names} for i, k in enumerate(keys)}


def _lengths(pw, order):
    """A linked list whose node ``p`` points at node ``p + 1``, its rows
    inserted in ``order``; returns (nodes, lengths by recursion)."""
    n = len(order)

    @pw.transformer
    class linked_list_transformer:
        class linked_list(pw.ClassArg):
            next = pw.input_attribute()

            @pw.output_attribute
            def len(self) -> float:
                if self.next is None:
                    return 1
                return 1 + self.transformer.linked_list[self.next].len

    nodes = pw.Table.from_rows([{"pos": int(p)} for p in order]).with_id_from(pw.this.pos)
    nxt = nodes.select(next=pw.apply(lambda p: None if p == n - 1 else pw.ref_scalar(p + 1), pw.this.pos))
    return nodes, linked_list_transformer(nxt).linked_list


def _both(run):
    """``run(pw)`` through both packages; the port's result equals the
    reference's and is returned."""
    ref, port = (run(pw) for pw in PACKAGES)
    assert port == ref
    return port


def test_linked_list_length_equals_reference():
    def run(pw):
        nodes, result = _lengths(pw, range(5))
        pw.run(monitoring_level=None)
        pos = {k: v["pos"] for k, v in _by_key(nodes).items()}
        return {k: (pos[k], v["len"]) for k, v in _by_key(result).items()}

    got = _both(run)
    assert sorted(got.values()) == [(0, 5), (1, 4), (2, 3), (3, 2), (4, 1)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_linked_list_equals_reference_and_a_plain_loop(seed):
    """Nodes inserted in a seeded random order: each node's length is the
    count of nodes from it to the tail, by recursion through pointers."""
    n = 40 + 10 * seed
    order = np.random.default_rng(seed).permutation(n)

    def run(pw):
        nodes, result = _lengths(pw, order)
        pw.run(monitoring_level=None)
        pos = {k: v["pos"] for k, v in _by_key(nodes).items()}
        return {k: (pos[k], v["len"]) for k, v in _by_key(result).items()}

    got = _both(run)
    plain = {}
    for p in reversed(range(n)):  # a plain loop from the tail
        plain[p] = 1 if p == n - 1 else 1 + plain[p + 1]
    assert dict(got.values()) == plain


def test_method_and_two_tables_equal_reference():
    def run(pw):
        @pw.transformer
        class deref:
            class data(pw.ClassArg):
                val = pw.input_attribute()

                @pw.output_attribute
                def doubled(self):
                    return self.val * 2

                @pw.method
                def plus(self, x):
                    return self.val + x

            class queries(pw.ClassArg):
                ptr = pw.input_attribute()

                @pw.output_attribute
                def looked_up(self):
                    return self.transformer.data[self.ptr].doubled

        data = pw.Table.from_rows([{"k": "a", "val": 10}, {"k": "b", "val": 20}]).with_id_from(pw.this.k)
        queries = pw.Table.from_rows([{"q": 1, "tgt": "a"}, {"q": 2, "tgt": "b"}])
        result = deref(data.select(val=pw.this.val), queries.select(ptr=data.pointer_from(pw.this.tgt)))
        pw.run(monitoring_level=None)
        d_keys, d_cols = result.data._materialize()
        # a method cell is bound to its row and reads the current state when called
        called = sorted(d_cols["plus"][i](5) for i in range(len(d_keys)))
        return _by_key(result.data), _by_key(result.queries), called

    data, queries, called = _both(run)
    assert sorted(v["doubled"] for v in data.values()) == [20, 40]
    assert all(v["plus"][0] == "method" and v["plus"][1] == k for k, v in data.items())
    assert sorted(v["looked_up"] for v in queries.values()) == [20, 40]
    assert called == [15, 25]


def test_transformer_updates_incrementally_as_the_reference():
    """An upsert re-evaluates the output: both packages end at the new
    value (the ticks follow thread timing, so final rows only)."""

    def run(pw):
        class KV(pw.Schema):
            k: str = pw.column_definition(primary_key=True)
            v: int

        class Subj(pw.io.python.ConnectorSubject):
            def run(self):
                self.next(k="x", v=1)
                time.sleep(0.25)
                self.next(k="x", v=7)  # the upsert changes the transformed output

        t = pw.io.python.read(Subj(), schema=KV)

        @pw.transformer
        class double:
            class data(pw.ClassArg):
                v = pw.input_attribute()

                @pw.output_attribute
                def twice(self):
                    return self.v * 2

        out = double(t.select(v=pw.this.v)).data
        pw.run(monitoring_level=None)
        return _by_key(out)

    got = _both(run)
    assert [r["twice"] for r in got.values()] == [14]
