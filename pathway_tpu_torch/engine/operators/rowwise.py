"""Stateless-ish per-row operators: select, filter, reindex, concat,
update_rows/cells, flatten, restrict/difference.

Retraction discipline: for an incoming retraction of key ``k`` the operator
re-emits the row it previously produced for ``k`` by looking it up in its
output table's RowStore (which the scheduler updates only *after* process
returns) — this keeps non-deterministic UDF outputs consistent, matching the
reference's arrangement-backed retraction semantics.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ...internals import dtype as dt
from ...internals.expression import ColumnExpression, EvalContext
from ...internals.keys import KEY_DTYPE, ref_scalars_batch
from ..delta import Delta, as_column, empty_delta, rows_equal
from ..graph import EngineOperator, EngineTable

__all__ = [
    "RowwiseOperator",
    "FilterOperator",
    "ReindexOperator",
    "ConcatOperator",
    "UpdateRowsOperator",
    "UpdateCellsOperator",
    "FlattenOperator",
    "RestrictOperator",
    "DifferenceOperator",
    "build_eval_context",
]


def build_eval_context(
    delta: Delta,
    ctx_cols: Mapping[Tuple[int, str], str],
) -> EvalContext:
    """Map API-level column references to this delta's engine columns."""
    columns = {api_ref: delta.columns[engine_col] for api_ref, engine_col in ctx_cols.items()}
    return EvalContext(columns, delta.keys)


class RowwiseOperator(EngineOperator):
    """select / with_columns: output columns are expressions over input rows
    (reference: expression_table, src/engine/graph.rs:708)."""

    def dist_routing(self, port: int):
        return None  # row-local: output key = input key, no cross-row state

    def __init__(
        self,
        input_table: EngineTable,
        output: EngineTable,
        expressions: Dict[str, ColumnExpression],
        ctx_cols: Mapping[Tuple[int, str], str],
        dtypes: Optional[Dict[str, dt.DType]] = None,
        name: str = "select",
    ):
        super().__init__([input_table], output, name)
        self.expressions = expressions
        self.ctx_cols = dict(ctx_cols)
        self.dtypes = dtypes or {}

    def _eval_insertions(self, ins: Delta) -> Delta:
        ctx = build_eval_context(ins, self.ctx_cols)
        out_columns = {}
        for out_name, expr in self.expressions.items():
            arr = expr._eval(ctx)
            out_columns[out_name] = (
                arr if isinstance(arr, np.ndarray) else as_column(arr, self.dtypes.get(out_name))
            )
        return Delta(keys=ins.keys, diffs=ins.diffs, columns=out_columns)

    def _eval_row(self, delta: Delta, i: int) -> Tuple[Any, ...]:
        one = self._eval_insertions(delta.select_rows(np.array([i])))
        return tuple(one.columns[c][0] for c in self.output.column_names)

    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        if delta.n == 0:
            return None
        diffs = delta.diffs
        if np.all(diffs > 0):
            return self._eval_insertions(delta)
        rets = delta.retractions()
        ins = delta.insertions()
        if (
            len(np.unique(rets.keys)) == rets.n
            and len(np.unique(ins.keys)) == ins.n
        ):
            # the dominant shape: each key at most once per polarity
            # (retract-old + insert-new); deltas arrive consolidated
            # (retractions first), so store lookups pair correctly
            out_ret = self.output.store.lookup_delta(rets.keys) if rets.n else None
            out_ins = self._eval_insertions(ins) if ins.n else None
            parts = [p for p in (out_ret, out_ins) if p is not None and p.n > 0]
            if not parts:
                return None
            return Delta.concat(parts, self.output.column_names)
        # A key occurs multiple times (within-tick transient: retract+insert
        # chains).  Walk rows in order with a local view of the output so each
        # retraction pairs with exactly one prior emission — a store lookup
        # per retraction would re-emit the same stored row for every
        # occurrence and corrupt downstream aggregates.
        names = self.output.column_names
        ins_out = self._eval_insertions(ins) if ins.n else None
        ins_cols = [ins_out.columns[c] for c in names] if ins_out is not None else []
        out_rows: List[Tuple[int, int, Tuple[Any, ...]]] = []
        local: Dict[int, Optional[Tuple[Any, ...]]] = {}
        ins_ptr = 0
        for i in range(delta.n):
            key = int(delta.keys[i])
            if diffs[i] > 0:
                row = tuple(c[ins_ptr] for c in ins_cols)
                ins_ptr += 1
                out_rows.append((key, 1, row))
                local[key] = row
            else:
                if key in local:
                    prev = local[key]
                    if prev is not None:
                        out_rows.append((key, -1, prev))
                        local[key] = None
                    else:
                        out_rows.append((key, -1, self._eval_row(delta, i)))
                else:
                    stored = self.output.store.get(key)
                    if stored is not None:
                        out_rows.append((key, -1, stored))
                    else:
                        # never materialised: retract the value this row
                        # would have produced (cancels its in-flight insert)
                        out_rows.append((key, -1, self._eval_row(delta, i)))
                    local[key] = None
        if not out_rows:
            return None
        return Delta.from_rows(names, out_rows)


class FilterOperator(EngineOperator):
    """filter rows by a boolean expression (graph.rs: filter_table)."""

    def dist_routing(self, port: int):
        return None  # row-local: output key = input key, no cross-row state

    def __init__(
        self,
        input_table: EngineTable,
        output: EngineTable,
        expression: ColumnExpression,
        ctx_cols: Mapping[Tuple[int, str], str],
        name: str = "filter",
    ):
        super().__init__([input_table], output, name)
        self.expression = expression
        self.ctx_cols = dict(ctx_cols)

    def _eval_mask(self, part: Delta) -> np.ndarray:
        ctx = build_eval_context(part, self.ctx_cols)
        mask = np.asarray(self.expression._eval(ctx))
        if mask.dtype == object:
            mask = np.array([bool(m) for m in mask], dtype=bool)
        return mask.astype(bool)

    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        if delta.n == 0:
            return None
        rets = delta.retractions()
        ins = delta.insertions()
        if rets.n == 0 or (
            len(np.unique(rets.keys)) == rets.n
            and len(np.unique(ins.keys)) == ins.n
        ):
            parts = []
            if rets.n:
                # retract only rows that previously passed the filter
                parts.append(self.output.store.lookup_delta(rets.keys))
            if ins.n:
                passed = ins.select_rows(self._eval_mask(ins))
                if passed.n:
                    parts.append(
                        Delta(
                            keys=passed.keys,
                            diffs=passed.diffs,
                            columns={c: passed.columns[c] for c in self.output.column_names},
                        )
                    )
            parts = [p for p in parts if p.n > 0]
            if not parts:
                return None
            return Delta.concat(parts, self.output.column_names)
        # repeated keys within one delta — order-preserving walk (see
        # RowwiseOperator.process) so transient retract/insert chains pair up
        names = self.output.column_names
        ins_mask = self._eval_mask(ins) if ins.n else np.empty(0, dtype=bool)
        ins_cols = [ins.columns[c] for c in names]
        out_rows: List[Tuple[int, int, Tuple[Any, ...]]] = []
        local: Dict[int, Optional[Tuple[Any, ...]]] = {}
        cols = [delta.columns[c] for c in names]
        ins_ptr = 0
        for i in range(delta.n):
            key = int(delta.keys[i])
            if delta.diffs[i] > 0:
                if ins_mask[ins_ptr]:
                    row = tuple(c[ins_ptr] for c in ins_cols)
                    out_rows.append((key, 1, row))
                    local[key] = row
                else:
                    local[key] = None
                ins_ptr += 1
            else:
                def cancel_in_flight(idx: int, k: int) -> None:
                    # no prior emission to pair with (second retraction of a
                    # delete-after-update chain, or never-materialised row):
                    # cancel the in-flight insert if the row passes the filter
                    if self._eval_mask(delta.select_rows(np.array([idx])))[0]:
                        out_rows.append((k, -1, tuple(c[idx] for c in cols)))

                if key in local:
                    prev = local[key]
                    if prev is not None:
                        out_rows.append((key, -1, prev))
                        local[key] = None
                    else:
                        cancel_in_flight(i, key)
                else:
                    stored = self.output.store.get(key)
                    if stored is not None:
                        out_rows.append((key, -1, stored))
                    else:
                        cancel_in_flight(i, key)
                    local[key] = None
        if not out_rows:
            return None
        return Delta.from_rows(names, out_rows)


class ReindexOperator(EngineOperator):
    """Rekey rows by an expression (with_id_from / reindex;
    graph.rs: reindex_table).  The new key is recomputed from row values, so
    retractions rekey consistently."""

    def dist_routing(self, port: int):
        # row-local: the new key is a pure function of the row, so insert and
        # retraction rekey identically wherever they are processed
        return None

    def __init__(
        self,
        input_table: EngineTable,
        output: EngineTable,
        key_expression: ColumnExpression,
        ctx_cols: Mapping[Tuple[int, str], str],
        name: str = "reindex",
    ):
        super().__init__([input_table], output, name)
        self.key_expression = key_expression
        self.ctx_cols = dict(ctx_cols)

    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        if delta.n == 0:
            return None
        ctx = build_eval_context(delta, self.ctx_cols)
        new_keys = np.asarray(self.key_expression._eval(ctx)).astype(KEY_DTYPE)
        return Delta(
            keys=new_keys,
            diffs=delta.diffs,
            columns={c: delta.columns[c] for c in self.output.column_names},
        )


class ConcatOperator(EngineOperator):
    """Disjoint union of N same-schema inputs (graph.rs: concat).

    ``checked=True`` (the default without a disjointness promise) tracks
    which input each live key came from and raises on a cross-input
    collision — a silent collision would overwrite rows in the output store
    (the reference proves disjointness statically with its universe solver,
    internals/universe_solver.py; ``pw.universes.
    promise_are_pairwise_disjoint`` elides this runtime check)."""

    def dist_routing(self, port: int):
        return "key"  # co-locate ports by row key (owner = key shard)

    def __init__(
        self,
        inputs: Sequence[EngineTable],
        output: EngineTable,
        column_maps: Sequence[Mapping[str, str]],
        checked: bool = True,
        name: str = "concat",
    ):
        super().__init__(inputs, output, name)
        self.column_maps = [dict(m) for m in column_maps]
        self.checked = checked
        # per-port live-key SET + a tiny pending-retraction side dict (a
        # retraction can precede its matching insertion across deltas within
        # one tick); collision suspects are verified at tick end, because a
        # key may legitimately migrate between inputs within a tick.  All
        # bulk state updates are C-level set ops — no per-row Python loop on
        # the hot path.
        self._live: List[set] = [set() for _ in inputs]
        self._pending_neg: List[Dict[int, int]] = [{} for _ in inputs]
        self._suspects: set = set()

    def snapshot_state(self):
        return {"live": self._live, "pending": self._pending_neg}

    def restore_state(self, state) -> None:
        self._live = state["live"]
        self._pending_neg = state["pending"]

    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        if self.checked:
            pos = delta.diffs > 0
            inserted = set(delta.keys[pos].tolist())
            removed = set(delta.keys[~pos].tolist())
            live = self._live[port]
            pending = self._pending_neg[port]
            for key in removed - live:  # early retraction: usually empty
                pending[key] = pending.get(key, 0) + 1
            live -= removed
            if pending:
                cancelled = inserted & pending.keys()
                for key in cancelled:
                    if pending[key] == 1:
                        del pending[key]
                    else:
                        pending[key] -= 1
                inserted -= cancelled
            live |= inserted
            for other_port, other in enumerate(self._live):
                if other_port != port:
                    self._suspects |= inserted & other
        cmap = self.column_maps[port]
        return Delta(
            keys=delta.keys,
            diffs=delta.diffs,
            columns={out: delta.columns[src] for out, src in cmap.items()},
        )

    def on_tick_end(self, ts: int):
        if self._suspects:
            for key in self._suspects:
                owners = [p for p, live in enumerate(self._live) if key in live]
                if len(owners) > 1:
                    raise ValueError(
                        f"concat inputs are not disjoint: key {key:#x} is "
                        f"live in inputs {owners}; use concat_reindex, "
                        "or promise disjointness with "
                        "pw.universes.promise_are_pairwise_disjoint"
                    )
            self._suspects.clear()
        return None


class UpdateRowsOperator(EngineOperator):
    """``left.update_rows(right)``: right rows shadow left rows on key clash
    (reference: update_rows_table, graph.rs:726)."""

    def dist_routing(self, port: int):
        return "key"  # co-locate ports by row key (owner = key shard)

    def __init__(
        self,
        left: EngineTable,
        right: EngineTable,
        output: EngineTable,
        right_column_map: Mapping[str, str],
        name: str = "update_rows",
    ):
        super().__init__([left, right], output, name)
        self.right_column_map = dict(right_column_map)  # output name -> right name
        self._left: Dict[int, Tuple[Any, ...]] = {}
        self._right: Dict[int, Tuple[Any, ...]] = {}

    def _emit(self, key: int, row: Optional[Tuple[Any, ...]], out) -> None:
        old = self.output.store.get(key)
        # collect (key, diff, row) triples
        if old is not None and not rows_equal(old, row):
            out.append((key, -1, old))
        if row is not None and not rows_equal(old, row):
            out.append((key, 1, row))

    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        names = self.output.column_names
        if port == 0:
            in_names = names
        else:
            in_names = [self.right_column_map[c] for c in names]
        side = self._left if port == 0 else self._right
        changed: List[Tuple[int, int, Tuple[Any, ...]]] = []
        cols = [delta.columns[c] for c in in_names]
        touched: Dict[int, None] = {}
        for i in range(delta.n):
            key = int(delta.keys[i])
            row = tuple(c[i] for c in cols)
            if delta.diffs[i] > 0:
                side[key] = row
            else:
                side.pop(key, None)
            touched[key] = None
        out: List[Tuple[int, int, Tuple[Any, ...]]] = []
        for key in touched:
            effective = self._right.get(key, self._left.get(key))
            self._emit(key, effective, out)
        if not out:
            return None
        return Delta.from_rows(names, out)


class UpdateCellsOperator(EngineOperator):
    """``left.update_cells(right)``: right overrides a subset of columns for
    keys it contains (reference: update_cells_table, graph.rs:717)."""

    def dist_routing(self, port: int):
        return "key"  # co-locate ports by row key (owner = key shard)

    def __init__(
        self,
        left: EngineTable,
        right: EngineTable,
        output: EngineTable,
        updated_columns: Mapping[str, str],  # output/left name -> right name
        name: str = "update_cells",
    ):
        super().__init__([left, right], output, name)
        self.updated_columns = dict(updated_columns)
        self._left: Dict[int, Tuple[Any, ...]] = {}
        self._right: Dict[int, Tuple[Any, ...]] = {}

    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        names = self.output.column_names
        touched: Dict[int, None] = {}
        if port == 0:
            cols = [delta.columns[c] for c in names]
            for i in range(delta.n):
                key = int(delta.keys[i])
                row = tuple(c[i] for c in cols)
                if delta.diffs[i] > 0:
                    self._left[key] = row
                else:
                    self._left.pop(key, None)
                touched[key] = None
        else:
            rnames = list(self.updated_columns.values())
            cols = [delta.columns[c] for c in rnames]
            for i in range(delta.n):
                key = int(delta.keys[i])
                row = tuple(c[i] for c in cols)
                if delta.diffs[i] > 0:
                    self._right[key] = row
                else:
                    self._right.pop(key, None)
                touched[key] = None
        out: List[Tuple[int, int, Tuple[Any, ...]]] = []
        upd_idx = {
            left_name: ri for ri, left_name in enumerate(self.updated_columns.keys())
        }
        for key in touched:
            base = self._left.get(key)
            patch = self._right.get(key)
            if base is None:
                effective = None
            elif patch is None:
                effective = base
            else:
                effective = tuple(
                    patch[upd_idx[name]] if name in upd_idx else base[ci]
                    for ci, name in enumerate(names)
                )
            old = self.output.store.get(key)
            if old is not None and not rows_equal(old, effective):
                out.append((key, -1, old))
            if effective is not None and not rows_equal(old, effective):
                out.append((key, 1, effective))
        if not out:
            return None
        return Delta.from_rows(names, out)


class FlattenOperator(EngineOperator):
    """Explode an iterable column into one row per element; new key =
    hash(parent key, position) (reference: flatten_table, graph.rs:820)."""

    def dist_routing(self, port: int):
        return None  # row-local: output key = input key, no cross-row state

    def __init__(
        self,
        input_table: EngineTable,
        output: EngineTable,
        flatten_column: str,
        name: str = "flatten",
    ):
        super().__init__([input_table], output, name)
        self.flatten_column = flatten_column

    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        if delta.n == 0:
            return None
        names = self.output.column_names
        src_cols = delta.columns
        seqs = [[] if seq is None else list(seq) for seq in src_cols[self.flatten_column]]
        lens = np.fromiter((len(seq) for seq in seqs), dtype=np.int64, count=len(seqs))
        total = int(lens.sum())
        if total == 0:
            return None
        # column by column: row i's j-th element becomes child row (i, j),
        # each other column's value repeated, every column an object column
        # of the same values a row-by-row build would hold
        parent_rows = np.repeat(np.arange(delta.n), lens)
        positions = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
        items = [item for seq in seqs for item in seq]
        columns = {
            c: as_column(items) if c == self.flatten_column else as_column(list(src_cols[c][parent_rows]))
            for c in names
        }
        # every child key of the delta in one host-library call: the same
        # (parent key, position) rows hash to the same keys as one by one
        child_keys = ref_scalars_batch([delta.keys[parent_rows].tolist(), positions.tolist()])
        return Delta(
            keys=np.asarray(child_keys, dtype=KEY_DTYPE), diffs=delta.diffs[parent_rows], columns=columns
        )


class RestrictOperator(EngineOperator):
    """Keep rows of ``data`` whose key is present in ``keyset``
    (restrict / intersect / having; graph.rs: restrict_or_override_table)."""

    def dist_routing(self, port: int):
        return "key"  # co-locate ports by row key (owner = key shard)

    def __init__(
        self,
        data: EngineTable,
        keyset: EngineTable,
        output: EngineTable,
        invert: bool = False,
        name: str = "restrict",
    ):
        super().__init__([data, keyset], output, name)
        self.invert = invert
        self._data: Dict[int, Tuple[Any, ...]] = {}
        self._keys: Dict[int, int] = {}

    def _present(self, key: int) -> bool:
        present = key in self._keys
        return (not present) if self.invert else present

    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        names = self.output.column_names
        out: List[Tuple[int, int, Tuple[Any, ...]]] = []
        if port == 0:
            cols = [delta.columns[c] for c in names]
            for i in range(delta.n):
                key = int(delta.keys[i])
                row = tuple(c[i] for c in cols)
                if delta.diffs[i] > 0:
                    self._data[key] = row
                    if self._present(key):
                        out.append((key, 1, row))
                else:
                    self._data.pop(key, None)
                    if self._present(key):
                        out.append((key, -1, row))
        else:
            for i in range(delta.n):
                key = int(delta.keys[i])
                if delta.diffs[i] > 0:
                    was = self._present(key)
                    self._keys[key] = self._keys.get(key, 0) + 1
                    now = self._present(key)
                else:
                    was = self._present(key)
                    cnt = self._keys.get(key, 0) - 1
                    if cnt <= 0:
                        self._keys.pop(key, None)
                    else:
                        self._keys[key] = cnt
                    now = self._present(key)
                if was != now and key in self._data:
                    out.append((key, 1 if now else -1, self._data[key]))
        if not out:
            return None
        return Delta.from_rows(names, out)


class DifferenceOperator(RestrictOperator):
    """data minus keys of other (t.difference)."""

    def __init__(self, data, keyset, output, name: str = "difference"):
        super().__init__(data, keyset, output, invert=True, name=name)
