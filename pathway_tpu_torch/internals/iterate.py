"""pw.iterate of the port — fixed-point iteration (counterpart of
``pathway_tpu/internals/iterate.py``).

Reference: pw.iterate (python/pathway/internals/common.py:39) backed by nested
iterative scopes in the engine (src/engine/graph.rs:941 Graph::iterate,
src/engine/dataflow.rs:3737 — timely nested scopes with iteration_limit).

Design: the iteration body is built ONCE as a nested engine
subgraph with its own sources; at each outer commit tick the operator pushes
the outer input delta into the nested sources, then repeatedly steps the
nested *incremental* executor, feeding the difference between the body's
output and its input back into the sources until the difference is empty
(fixed point) or ``iteration_limit`` is hit.  Because the nested engine is
itself incremental, iteration k only recomputes what changed in iteration
k-1 — the same work profile as the reference's differential nested scopes.

The nested ``Executor`` is stepped by the outer operator only: it is never
the run's executor (``internals/run.py``), its sources keep no input log,
and it takes no part in persistence of its own.  Under
``OPERATOR_PERSISTING`` its tables and operators ride in the outer
operator's snapshot (``snapshot_state`` / ``restore_state``), and the
refusal of unsnapshotted operators walks into it
(``persistence/engine_state.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..engine.delta import Delta
from ..engine.executor import Executor, next_timestamp
from ..engine.graph import EngineGraph, EngineOperator, EngineTable
from ..engine.operators.io import InputSession, SourceOperator
from .parse_graph import G
from .universe import Universe

__all__ = ["iterate", "iterate_universe"]


def iterate_universe(table):
    """Marks an iterate argument whose key set may change between iterations
    (reference: pw.iterate_universe, internals/common.py).  This engine's
    iterate always allows the key set to evolve, so this is identity —
    kept for API parity."""
    return table


class _IterateOperator(EngineOperator):
    """Outer operator owning the nested subgraph (multi-output: emits via
    on_tick_end returning [(table, delta), ...])."""

    def __init__(
        self,
        inputs: List[EngineTable],
        input_names: List[str],
        input_mappings: List[Dict[str, str]],  # api col -> outer engine col
        sessions: Dict[str, InputSession],
        nested_graph: EngineGraph,
        nested_inputs: Dict[str, EngineTable],
        nested_outputs: Dict[str, Tuple[EngineTable, Dict[str, str]]],
        outer_outputs: Dict[str, EngineTable],
        feedback_names: List[str],
        iteration_limit: Optional[int],
        name: str = "iterate",
    ):
        super().__init__(inputs, None, name)
        self.input_names = input_names
        self.input_mappings = input_mappings
        self.sessions = sessions
        self.nested_graph = nested_graph
        self.nested_inputs = nested_inputs
        self.nested_outputs = nested_outputs
        self.outer_outputs = outer_outputs
        self.feedback_names = feedback_names
        self.iteration_limit = iteration_limit
        self.nested_graph.finalize()
        self.nested_exec = Executor(self.nested_graph)
        self._buffered: List[Tuple[int, Delta]] = []

    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        if delta.n:
            self._buffered.append((port, delta))
        return None

    def snapshot_state(self):
        """Nested-subgraph state for OPERATOR_PERSISTING: all nested table
        stores plus nested stateful-operator state (recursing through any
        inner iterates via the same hooks)."""
        op_states = {}
        for i, op in enumerate(self.nested_graph.operators):
            try:
                op_states[i] = op.snapshot_state()
            except NotImplementedError:
                pass
        return {
            "tables": [dict(t.store._rows) for t in self.nested_graph.tables],
            "ops": op_states,
        }

    def restore_state(self, state) -> None:
        for table, rows in zip(self.nested_graph.tables, state["tables"]):
            table.store._rows = dict(rows)
        for i, op_state in state["ops"].items():
            self.nested_graph.operators[i].restore_state(op_state)

    # -- helpers -----------------------------------------------------------
    def _push_outer_delta(self, port: int, delta: Delta) -> None:
        name = self.input_names[port]
        session = self.sessions[name]
        mapping = self.input_mappings[port]
        api_cols = list(self.nested_inputs[name].column_names)
        cols = [delta.columns[mapping[c]] for c in api_cols]
        for i in range(delta.n):
            row = tuple(c[i] for c in cols)
            if delta.diffs[i] > 0:
                session.insert(int(delta.keys[i]), row)
            else:
                session.remove(int(delta.keys[i]), row)

    def _feedback(self) -> bool:
        """Push (output - input) into the nested sources; False at fixpoint."""
        changed = False
        for name in self.feedback_names:
            out_table, out_mapping = self.nested_outputs[name]
            in_table = self.nested_inputs[name]
            session = self.sessions[name]
            api_cols = list(in_table.column_names)
            idx = [out_table.column_names.index(out_mapping[c]) for c in api_cols]
            target: Dict[int, tuple] = {}
            for key, row in out_table.store.items():
                target[key] = tuple(row[i] for i in idx)
            current = {key: tuple(row) for key, row in in_table.store.items()}
            for key, row in current.items():
                if key not in target:
                    session.remove(key, row)
                    changed = True
            for key, row in target.items():
                old = current.get(key)
                if old is None:
                    session.insert(key, row)
                    changed = True
                elif not _tuples_equal(old, row):
                    session.remove(key, old)
                    session.insert(key, row)
                    changed = True
        return changed

    def on_tick_end(self, ts: int) -> Optional[list]:
        if not self._buffered:
            return None
        buffered, self._buffered = self._buffered, []
        for port, delta in buffered:
            self._push_outer_delta(port, delta)
        limit = self.iteration_limit or 2**31
        for _ in range(limit):
            self.nested_exec.step(next_timestamp())
            if not self._feedback():
                break
        else:
            # push the last feedback through so outputs reflect the final
            # allowed iteration
            self.nested_exec.step(next_timestamp())
        # emit diffs of each nested output vs the outer output tables
        emissions = []
        for name, (out_table, out_mapping) in self.nested_outputs.items():
            outer = self.outer_outputs[name]
            api_cols = list(outer.column_names)
            idx = [out_table.column_names.index(out_mapping[c]) for c in api_cols]
            target = {
                key: tuple(row[i] for i in idx)
                for key, row in out_table.store.items()
            }
            current = {key: tuple(row) for key, row in outer.store.items()}
            rows: List[Tuple[int, int, tuple]] = []
            for key, row in current.items():
                if key not in target or not _tuples_equal(target[key], row):
                    rows.append((key, -1, row))
            for key, row in target.items():
                old = current.get(key)
                if old is None or not _tuples_equal(old, row):
                    rows.append((key, 1, row))
            if rows:
                emissions.append((outer, Delta.from_rows(api_cols, rows)))
        return emissions or None


def _tuples_equal(a: tuple, b: tuple) -> bool:
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x is y:
            continue
        try:
            if x != y:
                return False
        except Exception:
            return False
    return True


def iterate(func, iteration_limit: Optional[int] = None, **kwargs):
    """Iterate ``func`` to fixed point.

    ``kwargs`` are passed to ``func``; Table arguments iterate.  ``func``
    must return a Table, a tuple of Tables, or a dict of Tables; returned
    tables whose names match input kwargs feed back into the next iteration.
    A single-table return with a single table input always feeds back.
    """
    from .table import Table

    table_inputs = {k: v for k, v in kwargs.items() if isinstance(v, Table)}
    if not table_inputs:
        raise ValueError("pw.iterate needs at least one Table argument")

    # build the iteration body against a fresh nested graph
    outer_graph = G.engine_graph
    nested_graph = EngineGraph()
    G.engine_graph = nested_graph
    try:
        placeholders: Dict[str, Any] = dict(kwargs)
        sessions: Dict[str, InputSession] = {}
        nested_inputs: Dict[str, EngineTable] = {}
        for name, t in table_inputs.items():
            api_cols = t.column_names
            et = nested_graph.add_table(api_cols, f"iter_in_{name}")
            session = InputSession()
            nested_graph.add_operator(
                SourceOperator(et, session, t._dtypes, name=f"iter_src_{name}")
            )
            sessions[name] = session
            nested_inputs[name] = et
            placeholders[name] = Table(
                et, t._dtypes, Universe(), short_name=f"iter_{name}"
            )
        result = func(**placeholders)
    finally:
        G.engine_graph = outer_graph

    # normalize the returned structure
    single = isinstance(result, Table)
    if single:
        only_name = next(iter(table_inputs))
        result_dict: Dict[str, Table] = {only_name: result}
    elif isinstance(result, dict):
        result_dict = dict(result)
    elif isinstance(result, tuple):
        result_dict = {
            name: res for name, res in zip(table_inputs.keys(), result)
        }
    else:
        raise TypeError(
            f"pw.iterate body must return Table/tuple/dict, got {type(result)}"
        )
    for name, res in result_dict.items():
        if not isinstance(res, Table):
            raise TypeError(f"iterate output {name!r} is not a Table")

    nested_outputs = {
        name: (res._engine_table, dict(res._column_mapping))
        for name, res in result_dict.items()
    }
    feedback_names = [n for n in result_dict if n in table_inputs]

    input_names = list(table_inputs.keys())
    outer_inputs = [table_inputs[n]._engine_table for n in input_names]
    input_mappings = [dict(table_inputs[n]._column_mapping) for n in input_names]
    outer_outputs: Dict[str, EngineTable] = {}
    out_tables: Dict[str, Table] = {}
    for name, res in result_dict.items():
        et = outer_graph.add_table(res.column_names, f"iterate_{name}")
        outer_outputs[name] = et
        out_tables[name] = Table(et, res._dtypes, Universe(), short_name=f"iterate_{name}")

    outer_graph.add_operator(
        _IterateOperator(
            outer_inputs,
            input_names,
            input_mappings,
            sessions,
            nested_graph,
            nested_inputs,
            nested_outputs,
            outer_outputs,
            feedback_names,
            iteration_limit,
        )
    )

    if single:
        return out_tables[next(iter(table_inputs))]
    if isinstance(result, tuple):
        return tuple(out_tables[n] for n in result_dict)
    return out_tables
