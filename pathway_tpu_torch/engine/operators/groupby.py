"""Incremental group-by/reduce operator
(reference: Graph::group_by_table, src/engine/graph.rs:885; differential
reduce per shard, src/engine/dataflow.rs).

Group key = hash of grouping values (so groups land on deterministic mesh
shards); per-group reducer state updates under insertions and retractions;
each affected group re-emits retraction of its previous output row + the new
aggregate row.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ...internals.expression import ColumnExpression
from ...internals.keys import KEY_DTYPE, ref_scalars_batch
from ..delta import Delta, rows_equal
from ..graph import EngineOperator, EngineTable
from ..reducers import Reducer
from .rowwise import build_eval_context

__all__ = ["GroupByOperator", "ReducerSpec"]


class ReducerSpec:
    def __init__(
        self,
        out_name: str,
        reducer: Reducer,
        arg_expressions: Sequence[ColumnExpression],
        include_key: bool = False,
    ):
        self.out_name = out_name
        self.reducer = reducer
        self.arg_expressions = list(arg_expressions)
        self.include_key = include_key


class GroupByOperator(EngineOperator):
    def __init__(
        self,
        input_table: EngineTable,
        output: EngineTable,
        grouping_expressions: Mapping[str, ColumnExpression],  # out col -> expr
        reducer_specs: Sequence[ReducerSpec],
        ctx_cols: Mapping[Tuple[int, str], str],
        key_expression: Optional[ColumnExpression] = None,
        name: str = "groupby",
    ):
        super().__init__([input_table], output, name)
        self.grouping_expressions = dict(grouping_expressions)
        self.reducer_specs = list(reducer_specs)
        self.ctx_cols = dict(ctx_cols)
        # groupby(id=...): group key taken directly from this pointer column
        self.key_expression = key_expression
        # group_key -> [row_count, grouping_values_tuple, [reducer states]]
        self._groups: Dict[int, List[Any]] = {}

    def dist_routing(self, port: int):
        # distributed: route input rows to the owner of their GROUP key, so
        # each rank reduces a disjoint set of groups (reference: exchange on
        # the grouping key before differential reduce, dataflow.rs
        # group_by_table)
        return self._group_keys

    def _group_keys(self, delta: Delta) -> np.ndarray:
        ctx = build_eval_context(delta, self.ctx_cols)
        if self.key_expression is not None:
            return np.asarray(self.key_expression._eval(ctx)).astype(KEY_DTYPE)
        gvals = [
            np.asarray(e._eval(ctx)) for e in self.grouping_expressions.values()
        ]
        if gvals:
            return ref_scalars_batch(gvals)
        return np.zeros(delta.n, dtype=KEY_DTYPE)

    def snapshot_state(self):
        return self._groups

    def restore_state(self, state) -> None:
        self._groups = state

    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        if delta.n == 0:
            return None
        delta = delta.consolidated()
        ctx = build_eval_context(delta, self.ctx_cols)
        group_names = list(self.grouping_expressions.keys())
        gvals = [np.asarray(self.grouping_expressions[g]._eval(ctx)) for g in group_names]
        if self.key_expression is not None:
            gkeys = np.asarray(self.key_expression._eval(ctx)).astype(KEY_DTYPE)
        elif gvals:
            gkeys = ref_scalars_batch(gvals)
        else:
            gkeys = np.zeros(delta.n, dtype=KEY_DTYPE)
        arg_arrays: List[List[np.ndarray]] = []
        for spec in self.reducer_specs:
            arg_arrays.append([np.asarray(e._eval(ctx)) for e in spec.arg_expressions])

        touched = self._update_groups_batch(delta, gkeys, gvals, arg_arrays)
        if touched is None:
            touched = self._update_groups_rowwise(
                delta, gkeys, gvals, arg_arrays, ts
            )
        return self._emit(touched, group_names)

    def _update_groups_batch(self, delta, gkeys, gvals, arg_arrays):
        """Vectorised state update: collapse the delta to one contribution
        per (group, reducer) via the additive-reducer batch interface, then
        visit only the touched groups in Python — rows never enter a Python
        loop.  Returns None when any reducer/dtype can't vectorise."""
        for spec in self.reducer_specs:
            if spec.include_key:
                return None
        uniq, first_idx, inv = np.unique(
            gkeys, return_index=True, return_inverse=True
        )
        n_groups = len(uniq)
        contribs: List[Any] = []
        for spec, args in zip(self.reducer_specs, arg_arrays):
            c = spec.reducer.batch_contribs(args, delta.diffs, inv, n_groups)
            if c is None:
                return None
            contribs.append(c)
        count_delta = np.bincount(
            inv, weights=delta.diffs, minlength=n_groups
        ).astype(np.int64)
        touched: Dict[int, None] = {}
        uniq_list = uniq.tolist()
        for j, gk in enumerate(uniq_list):
            entry = self._groups.get(gk)
            if entry is None:
                i = int(first_idx[j])
                entry = [
                    0,
                    tuple(gv[i] for gv in gvals),
                    [spec.reducer.init_state() for spec in self.reducer_specs],
                ]
                self._groups[gk] = entry
            entry[0] += int(count_delta[j])
            states = entry[2]
            for si, spec in enumerate(self.reducer_specs):
                states[si] = spec.reducer.merge_contrib(states[si], contribs[si][j])
            touched[gk] = None
        return touched

    def _update_groups_rowwise(self, delta, gkeys, gvals, arg_arrays, ts):
        touched: Dict[int, None] = {}
        for i in range(delta.n):
            gk = int(gkeys[i])
            diff = int(delta.diffs[i])
            rkey = int(delta.keys[i])
            entry = self._groups.get(gk)
            if entry is None:
                entry = [
                    0,
                    tuple(gv[i] for gv in gvals),
                    [spec.reducer.init_state() for spec in self.reducer_specs],
                ]
                self._groups[gk] = entry
            entry[0] += diff
            for si, spec in enumerate(self.reducer_specs):
                args = arg_arrays[si]
                if spec.reducer.n_args == 0:
                    value: Any = None
                elif len(args) == 1 and spec.reducer.n_args == 1:
                    value = args[0][i]
                else:
                    value = tuple(a[i] for a in args)
                if spec.include_key:
                    value = (value, rkey) if not isinstance(value, tuple) else value
                entry[2][si] = spec.reducer.update(entry[2][si], value, diff, rkey, ts)
            touched[gk] = None
        return touched

    def _emit(self, touched, group_names) -> Optional[Delta]:
        out_names = self.output.column_names
        out_rows: List[Tuple[int, int, Tuple[Any, ...]]] = []
        for gk in touched:
            entry = self._groups.get(gk)
            old = self.output.store.get(gk)
            if entry is None or entry[0] <= 0:
                self._groups.pop(gk, None)
                new_row = None
            else:
                values: Dict[str, Any] = {}
                for gi, gname in enumerate(group_names):
                    values[gname] = entry[1][gi]
                for si, spec in enumerate(self.reducer_specs):
                    values[spec.out_name] = spec.reducer.result(entry[2][si])
                new_row = tuple(values[c] for c in out_names)
            if old is not None and not rows_equal(old, new_row):
                out_rows.append((gk, -1, old))
            if new_row is not None and not rows_equal(old, new_row):
                out_rows.append((gk, 1, new_row))
        if not out_rows:
            return None
        return Delta.from_rows(out_names, out_rows)
