"""The user-facing Table API.

Mirrors the reference's relational surface (python/pathway/internals/table.py:
126-2565 — select/filter/groupby+reduce/join/concat/update_*/flatten/
deduplicate/ix/…) but lowers *eagerly* onto the columnar micro-batch engine
(engine/graph.py) instead of building a ParseGraph first: every method wires
an engine operator and returns a new Table wrapping its output EngineTable.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Type

import numpy as np

from ..engine.graph import EngineTable
from ..engine.operators.dedupe import DeduplicateOperator
from ..engine.operators.groupby import GroupByOperator, ReducerSpec
from ..engine.operators.io import StaticSourceOperator
from ..engine.operators.join import AsofNowJoinOperator, JoinKind, JoinOperator
from ..engine.operators.rowwise import (
    ConcatOperator,
    DifferenceOperator,
    FilterOperator,
    FlattenOperator,
    ReindexOperator,
    RestrictOperator,
    RowwiseOperator,
    UpdateCellsOperator,
    UpdateRowsOperator,
)
from ..engine.reducers import Reducer
from . import dtype as dt
from .expression import (
    ColumnExpression,
    ColumnReference,
    IdExpression,
    PointerExpression,
    ReducerExpression,
    collect_reducers,
    smart_coerce,
)
from .expression import expr_equal
from .expression import substitute as expr_substitute
from .keys import KEY_DTYPE, ref_scalars_batch, sequential_keys
from .parse_graph import G
from .schema import Schema, schema_from_dict
from .thisclass import left as left_placeholder
from .thisclass import right as right_placeholder
from .thisclass import this as this_placeholder
from .type_interpreter import infer_dtype
from .universe import Universe

__all__ = [
    "Table",
    "TableLike",
    "Joinable",
    "GroupedTable",
    "GroupedJoinResult",
    "JoinResult",
    "JoinMode",
]


class JoinMode:
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    OUTER = "outer"


class TableLike:
    """Common superclass of everything with a universe
    (reference internals/table_like.py:15)."""


class Joinable(TableLike):
    """Things that can participate in joins: Table and JoinResult
    (reference internals/joins.py:46)."""


def _add_op(op):
    return G.engine_graph.add_operator(op)


def _new_engine_table(columns: Sequence[str], name: str = "") -> EngineTable:
    return G.engine_graph.add_table(columns, name)


class Table(Joinable):
    """A (possibly streaming) table of keyed rows."""

    _counter = itertools.count()

    def __init__(
        self,
        engine_table: EngineTable,
        dtypes: Mapping[str, dt.DType],
        universe: Optional[Universe] = None,
        column_mapping: Optional[Mapping[str, str]] = None,
        short_name: str = "",
    ):
        self._engine_table = engine_table
        self._dtypes = dict(dtypes)
        self._universe = universe if universe is not None else Universe()
        # api column name -> engine column name
        self._column_mapping = (
            dict(column_mapping)
            if column_mapping is not None
            else {c: c for c in dtypes}
        )
        self._short_name = short_name or f"table{next(Table._counter)}"

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def column_names(self) -> List[str]:
        return list(self._dtypes.keys())

    def keys(self) -> List[str]:
        return self.column_names

    @property
    def schema(self) -> Type[Schema]:
        return schema_from_dict(self._dtypes, name=self._short_name)

    def typehints(self) -> Dict[str, dt.DType]:
        return dict(self._dtypes)

    @property
    def id(self) -> IdExpression:
        return IdExpression(self)

    def __getattr__(self, name: str) -> ColumnReference:
        try:
            dtypes = object.__getattribute__(self, "_dtypes")
        except AttributeError:
            raise AttributeError(name)
        # underscore-prefixed names resolve as columns too (internal _pw_*
        # helper columns used by the temporal stdlib)
        if name not in dtypes:
            raise AttributeError(
                f"Table has no column {name!r}; columns: {list(dtypes)}"
            )
        return ColumnReference(self, name)

    def __getitem__(self, arg):
        if isinstance(arg, (list, tuple)):
            refs = [self[a] for a in arg]
            return TableSlice(self, refs)
        if isinstance(arg, ColumnReference):
            return ColumnReference(self, arg.name)
        if isinstance(arg, str):
            if arg == "id":
                return self.id
            if arg not in self._dtypes:
                raise KeyError(arg)
            return ColumnReference(self, arg)
        raise TypeError(f"cannot index Table with {arg!r}")

    def __iter__(self):
        raise TypeError("Table is not iterable; use pw.debug helpers")

    def __repr__(self):  # pragma: no cover
        cols = ", ".join(f"{n}" for n in self._dtypes)
        return f"<Table {self._short_name}({cols})>"

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    @staticmethod
    def from_rows(
        rows: Sequence[Mapping[str, Any]],
        schema: Optional[Type[Schema]] = None,
        *,
        keys: Optional[Sequence[int]] = None,
        name: str = "static",
    ) -> "Table":
        """Build a static table (reference: static_table / pw.debug.table_from_rows)."""
        if schema is not None:
            col_names = list(schema.columns().keys())
            dtypes = schema.typehints()
            pk = schema.primary_key_columns()
        else:
            col_names = list(rows[0].keys()) if rows else []
            dtypes = {c: dt.ANY for c in col_names}
            pk = None
        if keys is None:
            if pk:
                keys_arr = ref_scalars_batch(
                    [[row[c] for row in rows] for c in pk]
                ) if rows else np.empty(0, dtype=KEY_DTYPE)
            else:
                keys_arr = sequential_keys(0, len(rows))
        else:
            keys_arr = np.asarray(keys, dtype=KEY_DTYPE)
        columns: Dict[str, np.ndarray] = {}
        for c in col_names:
            vals = [row.get(c) for row in rows]
            from ..engine.delta import as_column

            columns[c] = as_column(vals, dtypes.get(c))
        et = _new_engine_table(col_names, name)
        _add_op(StaticSourceOperator(et, keys_arr, columns, dtypes, name=name))
        # refine ANY dtypes from data
        out_dtypes = dict(dtypes)
        for c in col_names:
            if out_dtypes[c] is dt.ANY and rows:
                val = rows[0].get(c)
                if val is not None:
                    out_dtypes[c] = dt.dtype_of_value(val)
        return Table(et, out_dtypes, Universe(), short_name=name)

    def _ctx_cols(
        self, *, placeholders: Sequence[Any] = ()
    ) -> Dict[Tuple[int, str], str]:
        out: Dict[Tuple[int, str], str] = {}
        for api_name, engine_name in self._column_mapping.items():
            out[(id(self), api_name)] = engine_name
            for ph in placeholders:
                out[(id(ph), api_name)] = engine_name
        return out

    def _dtype_env(self) -> Dict[int, Mapping[str, dt.DType]]:
        return {
            id(self): self._dtypes,
            id(this_placeholder): self._dtypes,
        }

    def _resolve_expressions(
        self, args: Sequence[Any], kwargs: Mapping[str, Any]
    ) -> Dict[str, ColumnExpression]:
        """Positional ColumnReferences keep their name; kwargs rename."""
        out: Dict[str, ColumnExpression] = {}
        for arg in args:
            if isinstance(arg, TableSlice):
                for ref in arg._refs:
                    out[ref.name] = ref
                continue
            if isinstance(arg, str):
                arg = self[arg]
            if not isinstance(arg, ColumnReference):
                raise ValueError(
                    f"positional select argument must be a column reference, got {arg!r}"
                )
            out[arg.name] = arg
        for name, value in kwargs.items():
            out[name] = smart_coerce(value)
        return out

    def _gather_foreign_tables(
        self, expressions: Iterable[ColumnExpression]
    ) -> List["Table"]:
        tables: List[Table] = []
        for expr in expressions:
            if not isinstance(expr, ColumnExpression):
                continue
            for ref in expr._column_refs():
                t = ref.table
                if isinstance(t, Table) and t is not self and t not in tables:
                    tables.append(t)
        return tables

    def _with_siblings(
        self, expressions: Iterable[ColumnExpression]
    ) -> Tuple[EngineTable, Dict[Tuple[int, str], str], Dict[int, Mapping[str, dt.DType]]]:
        """Input engine table + ctx for expressions that may reference other
        same-universe tables (zip-by-id via key-preserving inner joins)."""
        foreign = self._gather_foreign_tables(expressions)
        ctx = self._ctx_cols(placeholders=[this_placeholder])
        env = self._dtype_env()
        if not foreign:
            return self._engine_table, ctx, env
        current = self._engine_table
        cur_map = dict(self._column_mapping)  # api name -> engine col of current
        table_maps: Dict[int, Dict[str, str]] = {id(self): dict(cur_map)}
        table_list: List[Table] = [self]
        for other in foreign:
            if not other._universe.is_equal_to(self._universe) and not (
                self._universe.is_subset_of(other._universe)
            ):
                raise ValueError(
                    f"column of table {other._short_name} used in context of "
                    f"{self._short_name} but universes differ; use <table>.ix / "
                    "with_universe_of first"
                )
            out_cols = [f"_l_{c}" for c in current.column_names] + [
                f"_r_{c}" for c in other._engine_table.column_names
            ]
            joined = _new_engine_table(out_cols, "zip")
            op = JoinOperator(
                current,
                other._engine_table,
                joined,
                left_key_exprs=[_EngineIdExpr()],
                right_key_exprs=[_EngineIdExpr()],
                left_ctx_cols={},
                right_ctx_cols={},
                kind=JoinKind.LEFT
                if self._universe.is_subset_of(other._universe)
                and not other._universe.is_subset_of(self._universe)
                else JoinKind.INNER,
                assign_id_from="left",
                pointer_keys=True,
                name="zip_same_universe",
            )
            _add_op(op)
            # rebase previous maps onto the joined table's _l_ prefix
            for tmap in table_maps.values():
                for k in tmap:
                    tmap[k] = f"_l_{tmap[k]}"
            table_maps[id(other)] = {
                api: f"_r_{eng}" for api, eng in other._column_mapping.items()
            }
            table_list.append(other)
            current = joined
        ctx = {}
        for t in table_list:
            tmap = table_maps[id(t)]
            for api_name, engine_name in tmap.items():
                ctx[(id(t), api_name)] = engine_name
                if t is self:
                    ctx[(id(this_placeholder), api_name)] = engine_name
            env[id(t)] = t._dtypes
        return current, ctx, env

    # ------------------------------------------------------------------
    # core relational ops
    # ------------------------------------------------------------------
    def select(self, *args, **kwargs) -> "Table":
        expressions = self._resolve_expressions(args, kwargs)
        input_table, ctx, env = self._with_siblings(expressions.values())
        out_dtypes = {
            name: infer_dtype(expr, env) for name, expr in expressions.items()
        }
        et = _new_engine_table(list(expressions.keys()), "select")
        _add_op(
            RowwiseOperator(
                input_table, et, dict(expressions), ctx, out_dtypes, name="select"
            )
        )
        return Table(et, out_dtypes, self._universe)

    def filter(self, expression: ColumnExpression) -> "Table":
        input_table, ctx, env = self._with_siblings([expression])
        et = _new_engine_table(input_table.column_names, "filter")
        _add_op(FilterOperator(input_table, et, expression, ctx, name="filter"))
        # keep only own columns visible
        mapping = {
            api: eng
            for (tid, api), eng in ctx.items()
            if tid == id(self)
        }
        return Table(
            et, dict(self._dtypes), self._universe.subuniverse(), column_mapping=mapping
        )

    def _time_gate(
        self,
        time_expr: ColumnExpression,
        release_expr: Optional[ColumnExpression] = None,
        expire_expr: Optional[ColumnExpression] = None,
        clock=None,
    ) -> Tuple["Table", Any]:
        """Route this table through a TimeGateOperator (delay buffering /
        late-data cutoff, reference time_column.rs:380,677); returns the
        gated table and the operator (for sweep-hook registration by the
        temporal layer).  Not public API — pw.temporal wires it from
        behaviors."""
        from ..engine.operators.time_gate import TimeGateOperator

        exprs = [
            e for e in (time_expr, release_expr, expire_expr) if e is not None
        ]
        input_table, ctx, env = self._with_siblings(exprs)
        et = _new_engine_table(input_table.column_names, "time_gate")
        op = TimeGateOperator(
            input_table,
            et,
            time_expr,
            release_expr,
            expire_expr,
            ctx,
            clock=clock,
            name="time_gate",
        )
        _add_op(op)
        mapping = {
            api: eng for (tid, api), eng in ctx.items() if tid == id(self)
        }
        return (
            Table(
                et,
                dict(self._dtypes),
                self._universe.subuniverse(),
                column_mapping=mapping,
            ),
            op,
        )

    def with_columns(self, *args, **kwargs) -> "Table":
        expressions = self._resolve_expressions(args, kwargs)
        all_exprs: Dict[str, ColumnExpression] = {
            name: ColumnReference(self, name) for name in self._dtypes
        }
        all_exprs.update(expressions)
        return self.select(**all_exprs)

    def without(self, *columns) -> "Table":
        names = {c.name if isinstance(c, ColumnReference) else c for c in columns}
        keep = {n: ColumnReference(self, n) for n in self._dtypes if n not in names}
        return self.select(**keep)

    def rename(self, names_mapping: Optional[Mapping] = None, **kwargs) -> "Table":
        if names_mapping:
            mapping = {
                (k.name if isinstance(k, ColumnReference) else k): (
                    v.name if isinstance(v, ColumnReference) else v
                )
                for k, v in names_mapping.items()
            }
        else:
            # kwargs: new_name=old_ref
            mapping = {
                (v.name if isinstance(v, ColumnReference) else v): k
                for k, v in kwargs.items()
            }
        exprs = {}
        for n in self._dtypes:
            exprs[mapping.get(n, n)] = ColumnReference(self, n)
        return self.select(**exprs)

    rename_columns = rename

    def rename_by_dict(self, names_mapping: Mapping) -> "Table":
        return self.rename(names_mapping)

    def copy(self) -> "Table":
        return self.select(
            **{n: ColumnReference(self, n) for n in self._dtypes}
        )

    def cast_to_types(self, **kwargs) -> "Table":
        exprs: Dict[str, ColumnExpression] = {}
        for n in self._dtypes:
            if n in kwargs:
                from .expression import CastExpression

                exprs[n] = CastExpression(ColumnReference(self, n), kwargs[n])
            else:
                exprs[n] = ColumnReference(self, n)
        return self.select(**exprs)

    def update_types(self, **kwargs) -> "Table":
        out = self.copy()
        for n, t in kwargs.items():
            out._dtypes[n] = dt.wrap(t)
        return out

    # ------------------------------------------------------------------
    # groupby / reduce
    # ------------------------------------------------------------------
    def groupby(
        self,
        *args,
        id: Optional[Any] = None,
        instance: Optional[ColumnExpression] = None,
        sort_by: Optional[Any] = None,
        **kwargs,
    ) -> "GroupedTable":
        refs: List[ColumnExpression] = []
        for a in args:
            if isinstance(a, str):
                a = self[a]
            refs.append(a)
        if instance is not None:
            refs.append(instance)
        return GroupedTable(self, refs, key_expression=id, sort_by=sort_by)

    def reduce(self, *args, **kwargs) -> "Table":
        return GroupedTable(self, []).reduce(*args, **kwargs)

    def deduplicate(
        self,
        *,
        value: ColumnExpression,
        instance: Optional[ColumnExpression] = None,
        acceptor: Callable[[Any, Any], bool],
        name: str = "deduplicate",
    ) -> "Table":
        """Keep at most one row per instance, updated only when ``acceptor``
        approves the new value (reference: stdlib/stateful/deduplicate.py:9)."""
        exprs = [value] + ([instance] if instance is not None else [])
        input_table, ctx, env = self._with_siblings(exprs)
        et = _new_engine_table(input_table.column_names, name)
        _add_op(
            DeduplicateOperator(
                input_table, et, smart_coerce(value), instance, acceptor, ctx, name=name
            )
        )
        mapping = {api: eng for (tid, api), eng in ctx.items() if tid == id(self)}
        return Table(et, dict(self._dtypes), Universe(), column_mapping=mapping)

    # ------------------------------------------------------------------
    # joins
    # ------------------------------------------------------------------
    def join(
        self, other: "Table", *on, id: Optional[Any] = None, how: str = JoinMode.INNER
    ) -> "JoinResult":
        return JoinResult(self, other, on, how, id_expr=id)

    def join_inner(self, other, *on, id=None) -> "JoinResult":
        return JoinResult(self, other, on, JoinMode.INNER, id_expr=id)

    def join_left(self, other, *on, id=None) -> "JoinResult":
        return JoinResult(self, other, on, JoinMode.LEFT, id_expr=id)

    def join_right(self, other, *on, id=None) -> "JoinResult":
        return JoinResult(self, other, on, JoinMode.RIGHT, id_expr=id)

    def join_outer(self, other, *on, id=None) -> "JoinResult":
        return JoinResult(self, other, on, JoinMode.OUTER, id_expr=id)

    def asof_now_join(
        self, other: "Table", *on, how: str = JoinMode.INNER, id=None
    ) -> "JoinResult":
        """Join where self rows are queries answered against the current state
        of ``other``; results don't update when ``other`` changes afterwards
        (reference: asof_now joins, stdlib/temporal/_asof_join.py +
        data_index.py:364-441)."""
        return JoinResult(self, other, on, how, id_expr=id, asof_now=True)

    asof_now_join_inner = asof_now_join

    def asof_now_join_left(self, other, *on, id=None) -> "JoinResult":
        return JoinResult(self, other, on, JoinMode.LEFT, id_expr=id, asof_now=True)

    # ------------------------------------------------------------------
    # keys / universes
    # ------------------------------------------------------------------
    def pointer_from(self, *args, optional: bool = False, instance=None):
        return PointerExpression(self, *args, optional=optional, instance=instance)

    def with_id_from(self, *args, instance=None) -> "Table":
        key_expr = PointerExpression(self, *args, instance=instance)
        return self._reindex(key_expr)

    def with_id(self, new_id: ColumnExpression) -> "Table":
        return self._reindex(new_id)

    def _reindex(self, key_expr: ColumnExpression) -> "Table":
        input_table, ctx, env = self._with_siblings([key_expr])
        et = _new_engine_table(input_table.column_names, "reindex")
        _add_op(ReindexOperator(input_table, et, key_expr, ctx, name="reindex"))
        mapping = {api: eng for (tid, api), eng in ctx.items() if tid == id(self)}
        return Table(et, dict(self._dtypes), Universe(), column_mapping=mapping)

    def ix(
        self, expression: ColumnExpression, *, optional: bool = False, context=None
    ) -> "Table":
        """Reindex-by-foreign-key: row i gets the row of ``self`` pointed to by
        ``expression`` (evaluated in the expression's own table context)
        (reference: table.ix, internals/table.py)."""
        # determine source table of the expression
        src_tables = [
            ref.table
            for ref in smart_coerce(expression)._column_refs()
            if isinstance(ref.table, Table)
        ]
        src = src_tables[0] if src_tables else context
        if src is None:
            raise ValueError("ix requires an expression referencing a table")
        return src._ix_into(self, expression, optional=optional)

    def _ix_into(
        self, target: "Table", key_expr: ColumnExpression, *, optional: bool
    ) -> "Table":
        """self rows look up target rows by key_expr; result keyed by self.id."""
        out_cols = [f"_l_{c}" for c in self._engine_table.column_names] + [
            f"_r_{c}" for c in target._engine_table.column_names
        ]
        et = _new_engine_table(out_cols, "ix")
        op = JoinOperator(
            self._engine_table,
            target._engine_table,
            et,
            left_key_exprs=[smart_coerce(key_expr)],
            right_key_exprs=[_EngineIdExpr()],
            left_ctx_cols=self._ctx_cols(placeholders=[this_placeholder]),
            right_ctx_cols={},
            kind=JoinKind.LEFT if optional else JoinKind.INNER,
            assign_id_from="left",
            warn_unmatched_left=not optional,
            pointer_keys=True,
            name="ix",
        )
        _add_op(op)
        mapping = {
            api: f"_r_{eng}" for api, eng in target._column_mapping.items()
        }
        # Non-optional ix promises every pointer resolves (the reference raises
        # at runtime on a missing key, internals/table.py ix); we keep the
        # indexer's universe so the result composes with it in select contexts
        # (unresolved pointers drop rows instead of erroring).
        return Table(
            et,
            dict(target._dtypes),
            self._universe,
            column_mapping=mapping,
        )

    def ix_ref(self, *args, optional: bool = False, context=None, instance=None):
        raise NotImplementedError(
            "ix_ref: use table.ix(table.pointer_from(...)) for now"
        )

    def sort(self, key: ColumnExpression, instance=None) -> "Table":
        """Sorted prev/next pointer columns (reference Table.sort,
        internals/table.py:2157; engine op prev_next.rs → operators/sort.py).

        Returns a table with the same keys as ``self`` and two columns
        ``prev``/``next`` pointing at the neighbouring rows in ``key`` order
        (within ``instance`` when given; None at the ends)."""
        from ..engine.operators.sort import SortOperator

        aug = self.select(
            _pw_sort_key=smart_coerce(key),
            _pw_instance=smart_coerce(instance)
            if instance is not None
            else smart_coerce(0),
        )
        et = _new_engine_table(["prev", "next"], "sort")
        _add_op(SortOperator(aug._engine_table, et, name="sort"))
        from .keys import Pointer

        ptr_opt = dt.wrap(Optional[Pointer])
        return Table(
            et,
            {"prev": ptr_opt, "next": ptr_opt},
            self._universe,
            column_mapping={"prev": "prev", "next": "next"},
        )

    def with_universe_of(self, other: "Table") -> "Table":
        """Promise/enforce same key set as other, restoring universe equality
        (reference: with_universe_of, internals/table.py)."""
        out = self.copy()
        out._universe = other._universe
        return out

    def promise_universes_are_equal(self, other: "Table") -> "Table":
        self._universe.promise_equal(other._universe)
        return self

    def promise_universe_is_equal_to(self, other: "Table") -> "Table":
        self._universe.promise_equal(other._universe)
        return self

    def promise_universe_is_subset_of(self, other: "Table") -> "Table":
        out = self.copy()
        out._universe = other._universe.subuniverse()
        return out

    def restrict(self, other: "Table") -> "Table":
        et = _new_engine_table(self._engine_table.column_names, "restrict")
        _add_op(
            RestrictOperator(
                self._engine_table, other._engine_table, et, name="restrict"
            )
        )
        return Table(
            et,
            dict(self._dtypes),
            other._universe,
            column_mapping=dict(self._column_mapping),
        )

    def intersect(self, *others: "Table") -> "Table":
        out = self
        for other in others:
            out = out.restrict(other)
        return out

    def difference(self, other: "Table") -> "Table":
        et = _new_engine_table(self._engine_table.column_names, "difference")
        _add_op(
            DifferenceOperator(self._engine_table, other._engine_table, et)
        )
        return Table(
            et,
            dict(self._dtypes),
            self._universe.subuniverse(),
            column_mapping=dict(self._column_mapping),
        )

    def having(self, *indexers: ColumnExpression) -> "Table":
        """Keep rows whose pointer expressions resolve in their target tables
        (reference: table.having, internals/table.py)."""
        out = self
        for indexer in indexers:
            target = getattr(indexer, "_table", None)
            if not isinstance(target, Table):
                raise ValueError("having() indexer must be table.pointer_from(...)")
            looked = out._ix_into(target, indexer, optional=False)
            out = out.restrict(looked)
        return out

    # ------------------------------------------------------------------
    # set-like ops
    # ------------------------------------------------------------------
    def concat(self, *others: "Table") -> "Table":
        tables = [self, *others]
        names = self.column_names
        for t in tables[1:]:
            if set(t.column_names) != set(names):
                raise ValueError("concat requires same columns")
        et = _new_engine_table(names, "concat")
        promised = all(
            a._universe.is_promised_disjoint(b._universe)
            for i, a in enumerate(tables)
            for b in tables[i + 1 :]
        )
        _add_op(
            ConcatOperator(
                [t._engine_table for t in tables],
                et,
                [
                    {n: t._column_mapping[n] for n in names}
                    for t in tables
                ],
                checked=not promised,
            )
        )
        dtypes = dict(self._dtypes)
        for t in tables[1:]:
            for n in names:
                dtypes[n] = dt.types_lca(dtypes[n], t._dtypes[n])
        return Table(et, dtypes, Universe())

    def concat_reindex(self, *others: "Table") -> "Table":
        tables = [self, *others]
        reindexed = [
            t._reindex(
                PointerExpression(t, IdExpression(t), i)
            )
            for i, t in enumerate(tables)
        ]
        # keys hash (old_id, i) with distinct i per input — disjoint by
        # construction, so the concat skips its runtime collision check
        for i, a in enumerate(reindexed):
            for b in reindexed[i + 1 :]:
                a._universe.promise_disjoint(b._universe)
        return reindexed[0].concat(*reindexed[1:])

    def update_rows(self, other: "Table") -> "Table":
        names = self.column_names
        et = _new_engine_table(names, "update_rows")
        _add_op(
            UpdateRowsOperator(
                self._engine_table,
                other._engine_table,
                et,
                {n: other._column_mapping[n] for n in names},
            )
        )
        dtypes = {
            n: dt.types_lca(self._dtypes[n], other._dtypes[n]) for n in names
        }
        return Table(et, dtypes, Universe())

    def update_cells(self, other: "Table") -> "Table":
        # build-time universe proof (reference table.py:1509 raises via the
        # SAT solver; here internals/universe_solver.py transitive closure):
        # a provably-unrelated key set fails at CONSTRUCTION, not tick time
        if not other._universe.is_subset_of(self._universe):
            raise ValueError(
                "Universe of the argument of update_cells() needs to be a "
                "subset of the universe of the updated table.  Prove it with "
                "pw.universes.promise_is_subset_of(other, self) or align it "
                "with other.with_universe_of(self)."
            )
        names = self.column_names
        upd = {
            n: other._column_mapping[n]
            for n in other.column_names
            if n in self._dtypes
        }
        et = _new_engine_table(names, "update_cells")
        _add_op(
            UpdateCellsOperator(
                self._engine_table,
                other._engine_table,
                et,
                upd,
            )
        )
        dtypes = dict(self._dtypes)
        for n in upd:
            dtypes[n] = dt.types_lca(dtypes[n], other._dtypes[n])
        return Table(et, dtypes, self._universe)

    def __lshift__(self, other: "Table") -> "Table":
        return self.update_cells(other)

    def flatten(self, to_flatten: ColumnReference, **kwargs) -> "Table":
        name = to_flatten.name
        engine_col = self._column_mapping[name]
        et = _new_engine_table(self._engine_table.column_names, "flatten")
        _add_op(FlattenOperator(self._engine_table, et, engine_col))
        dtypes = dict(self._dtypes)
        inner = dtypes[name]
        dtypes[name] = dt.ANY
        out = Table(et, dtypes, Universe(), column_mapping=dict(self._column_mapping))
        if kwargs:
            extra = {k: ColumnReference(out, v.name if isinstance(v, ColumnReference) else v) for k, v in kwargs.items()}
            out = out.select(**{name: ColumnReference(out, name)}, **extra)
        return out

    # ------------------------------------------------------------------
    # misc
    # ------------------------------------------------------------------
    def apply_on_columns(self, fun: Callable, *cols, result_name: str = "result", **kw):
        from .expression import ApplyExpression

        return self.select(
            **{result_name: ApplyExpression(fun, None, args=cols)}
        )

    def _materialize(self) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Read the current store contents (after a run) as api-named columns."""
        keys, columns = self._engine_table.store.to_columns()
        api_columns = {
            api: columns[eng] for api, eng in self._column_mapping.items()
        }
        return keys, api_columns


class TableSlice:
    def __init__(self, table: Table, refs: List[ColumnReference]):
        self._table = table
        self._refs = refs


def _collect_column_refs(expr, stop_at_reducers: bool = False) -> List[ColumnReference]:
    """ColumnReference leaves of an expression tree; with
    ``stop_at_reducers`` the walk does not descend into ReducerExpression
    nodes (compound reduce outputs: refs OUTSIDE reducers must be grouping
    columns, refs inside belong to the reducer)."""
    found: List[ColumnReference] = []

    def walk(e):
        if stop_at_reducers and isinstance(e, ReducerExpression):
            return
        if isinstance(e, ColumnReference):
            found.append(e)
            return
        if isinstance(e, ColumnExpression):
            for d in e._deps:
                walk(d)

    walk(expr)
    return found


class GroupedTable:
    """Result of table.groupby(...) (reference: internals/groupbys.py:402)."""

    def __init__(
        self,
        table: Table,
        grouping: Sequence[ColumnExpression],
        key_expression: Optional[ColumnExpression] = None,
        sort_by: Optional[ColumnExpression] = None,
    ):
        self._table = table
        self._grouping = list(grouping)
        # groupby(id=...): result rows keyed by this pointer expression
        # (reference: groupbys.py id= parameter)
        self._key_expression = key_expression
        # sort_by: ordering for tuple/ndarray reducers instead of row key
        self._sort_by = sort_by

    def reduce(self, *args, **kwargs) -> Table:
        table = self._table
        out_exprs: Dict[str, Any] = {}
        for arg in args:
            if isinstance(arg, str):
                arg = table[arg]
            if not isinstance(arg, ColumnReference):
                raise ValueError("positional reduce args must be column references")
            out_exprs[arg.name] = arg
        out_exprs.update({k: smart_coerce(v) for k, v in kwargs.items()})

        grouping_names: Dict[int, str] = {}
        grouping_exprs: Dict[str, ColumnExpression] = {}
        for gi, gexpr in enumerate(self._grouping):
            if isinstance(gexpr, ColumnReference):
                gname = gexpr.name
            else:
                gname = f"_group_{gi}"
            grouping_exprs[gname] = gexpr
            grouping_names[gi] = gname

        reducer_specs: List[ReducerSpec] = []
        out_names: List[str] = []
        out_dtypes: Dict[str, dt.DType] = {}
        env = {id(table): table._dtypes, id(this_placeholder): table._dtypes}
        post_fns: Dict[str, Callable] = {}
        # compound outputs (expressions OVER reducers, e.g. sum(x)/count()):
        # each nested reducer computes into a hidden column, the surrounding
        # expression is re-applied on the reduced rows by a post-select
        compounds: Dict[str, ColumnExpression] = {}
        node_to_hidden: Dict[int, str] = {}

        def add_reducer_spec(name: str, expr: ReducerExpression) -> None:
            reducer = expr._reducer()
            args_exprs = list(expr._args)
            if getattr(expr, "_needs_key_order", False):
                order_expr = (
                    self._sort_by if self._sort_by is not None else IdExpression(None)
                )
                args_exprs = args_exprs + [order_expr]
            reducer_specs.append(ReducerSpec(name, reducer, args_exprs))
            if getattr(expr, "_post", None) is not None:
                post_fns[name] = expr._post
            out_dtypes[name] = _reducer_dtype(reducer, args_exprs, env)

        grouping_ref_names = {
            ge.name for ge in grouping_exprs.values() if isinstance(ge, ColumnReference)
        }

        for out_name, expr in out_exprs.items():
            out_names.append(out_name)
            if isinstance(expr, ReducerExpression):
                add_reducer_spec(out_name, expr)
            elif isinstance(expr, ColumnExpression):
                nested = collect_reducers(expr)
                if nested:
                    for node in nested:
                        if id(node) not in node_to_hidden:
                            hidden = f"_cr{len(node_to_hidden)}"
                            node_to_hidden[id(node)] = hidden
                            add_reducer_spec(hidden, node)
                    compounds[out_name] = expr
                    continue
                # plain output: must be (an expression of) grouping columns
                gname = None
                if isinstance(expr, ColumnReference):
                    for gn, ge in grouping_exprs.items():
                        if (
                            isinstance(ge, ColumnReference)
                            and ge.name == expr.name
                        ):
                            gname = gn
                            break
                if gname is None:
                    # re-stating a grouping EXPRESSION (groupby(t.a % 2)
                    # .reduce(parity=t.a % 2)) binds to it structurally
                    for gn, ge in grouping_exprs.items():
                        if expr_equal(ge, expr):
                            gname = gn
                            break
                if gname is None:
                    # expressions over grouping columns fold into the group
                    # key; anything touching a NON-grouping column must fail
                    # loudly (the reference raises; silently grouping finer
                    # would diverge results — round-3 advice)
                    refs = {
                        r.name
                        for r in _collect_column_refs(expr)
                        if not isinstance(r, IdExpression)
                    }
                    stray = refs - grouping_ref_names
                    if stray:
                        raise ValueError(
                            f"reduce output {out_name!r} uses non-grouping "
                            f"column(s) {sorted(stray)} outside a reducer; "
                            "wrap them in a reducer or add them to groupby()"
                        )
                    gname = f"_gexpr_{len(grouping_exprs)}"
                    grouping_exprs[gname] = expr
                if gname != out_name:
                    grouping_exprs[out_name] = grouping_exprs.pop(gname)
                out_dtypes[out_name] = infer_dtype(expr, env)
            else:
                raise ValueError(f"cannot reduce with {expr!r}")

        # grouping columns referenced inside compounds (outside reducers)
        # project through hidden grouping outputs
        compound_gref_hidden: Dict[str, str] = {}
        for expr in compounds.values():
            for ref in _collect_column_refs(expr, stop_at_reducers=True):
                if isinstance(ref, IdExpression):
                    continue
                if ref.name in grouping_ref_names:
                    compound_gref_hidden.setdefault(
                        ref.name, f"_cg_{ref.name}"
                    )
                elif ref.name not in grouping_ref_names:
                    raise ValueError(
                        f"compound reduce output uses non-grouping column "
                        f"{ref.name!r} outside a reducer"
                    )
        for gref_name, hidden in compound_gref_hidden.items():
            for gn, ge in list(grouping_exprs.items()):
                if isinstance(ge, ColumnReference) and ge.name == gref_name:
                    grouping_exprs[hidden] = ge
                    break

        all_grouping = dict(grouping_exprs)
        # engine output = requested non-compound outputs + hidden columns
        # feeding the compound post-select
        engine_out_names = [n for n in out_names if n not in compounds]
        engine_out_names += list(node_to_hidden.values())
        engine_out_names += list(compound_gref_hidden.values())
        ctx = table._ctx_cols(placeholders=[this_placeholder])
        input_table, ctx2, env2 = table._with_siblings(
            list(all_grouping.values())
            + [a for spec in reducer_specs for a in spec.arg_expressions]
        )
        et = _new_engine_table(engine_out_names, "groupby")
        visible_grouping = {
            n: e for n, e in all_grouping.items()
        }
        # wrap reducers with post fns
        for spec in reducer_specs:
            post = post_fns.get(spec.out_name)
            if post is not None:
                spec.reducer = _PostReducer(spec.reducer, post)
        _add_op(
            GroupByOperator(
                input_table,
                et,
                visible_grouping,
                reducer_specs,
                ctx2,
                key_expression=self._key_expression,
                name="groupby",
            )
        )
        # engine output table contains grouping cols too; restrict to out_names
        # GroupByOperator emits exactly output.column_names: set them correctly
        et.column_names = engine_out_names
        et.store.column_names = engine_out_names
        red = Table(
            et,
            {n: out_dtypes.get(n, dt.ANY) for n in engine_out_names},
            Universe(),
        )
        if not compounds:
            return red
        # post-select: re-apply each compound expression on the reduced rows
        # with reducer nodes -> hidden reducer columns and grouping refs ->
        # hidden grouping projections (key-preserving rowwise select)
        mapping: Dict[int, ColumnExpression] = {
            node_id: red[hidden] for node_id, hidden in node_to_hidden.items()
        }
        final_sel: Dict[str, Any] = {}
        for name in out_names:
            expr = compounds.get(name)
            if expr is None:
                final_sel[name] = red[name]
                continue
            ref_map = dict(mapping)
            for ref in _collect_column_refs(expr, stop_at_reducers=True):
                if not isinstance(ref, IdExpression):
                    ref_map[id(ref)] = red[compound_gref_hidden[ref.name]]
            final_sel[name] = expr_substitute(expr, ref_map)
        return red.select(**final_sel)


class _PostReducer(Reducer):
    def __init__(self, inner: Reducer, post: Callable):
        self.inner = inner
        self.post = post
        self.n_args = inner.n_args
        self.name = inner.name

    def init_state(self):
        return self.inner.init_state()

    def update(self, state, value, diff, key, ts):
        return self.inner.update(state, value, diff, key, ts)

    def result(self, state):
        return self.post(self.inner.result(state))


def _reducer_dtype(reducer, args_exprs, env) -> dt.DType:
    name = getattr(reducer, "name", "")
    if name == "count":
        return dt.INT
    if name == "avg":
        return dt.FLOAT
    if name in ("sum", "min", "max", "unique", "any", "earliest", "latest"):
        if args_exprs:
            return infer_dtype(args_exprs[0], env)
        return dt.ANY
    if name in ("sorted_tuple", "tuple"):
        return dt.Tuple_()
    return dt.ANY


def _expr_is_pointer(expr) -> bool:
    """Build-time pointer-ness of a join key expression (ids, or columns
    whose declared dtype is POINTER) — lets JoinOperator fix the key
    encoding once instead of per delta (engine/operators/join.py)."""
    from .expression import ColumnReference, IdExpression

    if isinstance(expr, (IdExpression, _EngineIdExpr)):
        return True
    if isinstance(expr, ColumnReference) and isinstance(expr.table, Table):
        declared = expr.table._dtypes.get(expr.name)
        if declared is not None:
            return dt.unoptionalize(declared) == dt.POINTER
    return False


class _EngineIdExpr(ColumnExpression):
    """Internal: evaluates to the row keys (used for id-joins at engine level)."""

    def _eval(self, ctx):
        return ctx.keys


class _ConstKeyExpr(ColumnExpression):
    """Internal: a constant join key for every row — ``join()`` with no
    conditions is a cross join (reference join semantics), so both sides
    land in one bucket."""

    def _eval(self, ctx):
        return np.zeros(len(ctx.keys), dtype=np.uint64)


class JoinResult(Joinable):
    """Result of table.join(...) pending a select
    (reference: internals/joins.py:1422)."""

    def __init__(
        self,
        left: Table,
        right: Table,
        on: Sequence[ColumnExpression],
        mode: str,
        id_expr: Optional[Any] = None,
        asof_now: bool = False,
    ):
        self._left = left
        self._right = right
        self._mode = mode
        self._asof_now = asof_now

        left_exprs: List[ColumnExpression] = []
        right_exprs: List[ColumnExpression] = []
        left_is_id = right_is_id = False
        for cond in on:
            import operator as _op_mod

            from .expression import ColumnBinaryOpExpression

            if (
                not isinstance(cond, ColumnBinaryOpExpression)
                or cond._op is not _op_mod.eq
            ):
                raise ValueError(
                    "join condition must be an equality: <left expr> == <right expr>"
                )
            l, r = cond._left, cond._right
            l_side = self._side_of(l)
            r_side = self._side_of(r)
            if l_side == "right" or r_side == "left":
                l, r = r, l
            left_exprs.append(self._rebind(l, "left"))
            right_exprs.append(self._rebind(r, "right"))
            if isinstance(l, IdExpression):
                left_is_id = True
            if isinstance(r, IdExpression):
                right_is_id = True

        assign_id_from = None
        if id_expr is not None:
            id_table = getattr(id_expr, "_table", None)
            if id_table is left or (
                isinstance(id_expr, IdExpression) and id_expr._table is left
            ):
                assign_id_from = "left"
            else:
                assign_id_from = "right"
        elif left_is_id and right_is_id:
            assign_id_from = "left"

        out_cols = (
            [f"_l_{c}" for c in left._engine_table.column_names]
            + [f"_r_{c}" for c in right._engine_table.column_names]
            # hidden side-id columns (must stay last: JoinOperator._assemble
            # maps left/right columns positionally before them)
            + ["_pw_lid", "_pw_rid"]
        )
        et = _new_engine_table(out_cols, "join")
        cls = AsofNowJoinOperator if asof_now else JoinOperator
        pointer_keys = (
            len(left_exprs) == 1
            and len(right_exprs) == 1
            and _expr_is_pointer(left_exprs[0])
            and _expr_is_pointer(right_exprs[0])
        ) or None
        op = cls(
            left._engine_table,
            right._engine_table,
            et,
            left_key_exprs=left_exprs or [_ConstKeyExpr()],
            right_key_exprs=right_exprs or [_ConstKeyExpr()],
            left_ctx_cols=left._ctx_cols(placeholders=[left_placeholder, this_placeholder]),
            right_ctx_cols=right._ctx_cols(placeholders=[right_placeholder]),
            kind=mode,
            assign_id_from=assign_id_from,
            pointer_keys=pointer_keys,
            name="asof_now_join" if asof_now else "join",
        )
        _add_op(op)
        self._engine_table = et
        self._universe = Universe()

    def _side_of(self, expr: ColumnExpression) -> Optional[str]:
        for ref in smart_coerce(expr)._column_refs():
            t = ref.table
            if t is self._left or t is left_placeholder:
                return "left"
            if t is self._right or t is right_placeholder:
                return "right"
        if isinstance(expr, IdExpression):
            t = expr._table
            if t is self._left or t is left_placeholder:
                return "left"
            if t is self._right or t is right_placeholder:
                return "right"
        return None

    def _rebind(self, expr: ColumnExpression, side: str) -> ColumnExpression:
        return expr

    def _ctx(self) -> Dict[Tuple[int, str], str]:
        ctx: Dict[Tuple[int, str], str] = {}
        for api, eng in self._left._column_mapping.items():
            ctx[(id(self._left), api)] = f"_l_{eng}"
            ctx[(id(left_placeholder), api)] = f"_l_{eng}"
            ctx[(id(this_placeholder), api)] = f"_l_{eng}"
        for api, eng in self._right._column_mapping.items():
            ctx[(id(self._right), api)] = f"_r_{eng}"
            ctx[(id(right_placeholder), api)] = f"_r_{eng}"
            if (id(this_placeholder), api) not in ctx:
                ctx[(id(this_placeholder), api)] = f"_r_{eng}"
        # side row ids: left.id / right.id resolve to the hidden id columns
        # (IdExpression checks the "__id__" pseudo-column for its table)
        ctx[(id(self._left), "__id__")] = "_pw_lid"
        ctx[(id(left_placeholder), "__id__")] = "_pw_lid"
        ctx[(id(self._right), "__id__")] = "_pw_rid"
        ctx[(id(right_placeholder), "__id__")] = "_pw_rid"
        return ctx

    def select(self, *args, **kwargs) -> Table:
        out_exprs: Dict[str, ColumnExpression] = {}
        for arg in args:
            if isinstance(arg, TableSlice):
                for ref in arg._refs:
                    out_exprs[ref.name] = ref
                continue
            if not isinstance(arg, ColumnReference):
                raise ValueError("positional join select args must be column refs")
            out_exprs[arg.name] = arg
        out_exprs.update({k: smart_coerce(v) for k, v in kwargs.items()})
        ctx = self._ctx()
        env = {
            id(self._left): self._left._dtypes,
            id(self._right): self._right._dtypes,
            id(left_placeholder): self._left._dtypes,
            id(right_placeholder): self._right._dtypes,
            id(this_placeholder): {**self._right._dtypes, **self._left._dtypes},
        }
        out_dtypes = {}
        for name, expr in out_exprs.items():
            d = infer_dtype(expr, env)
            # outer kinds pad the missing side with None -> widen to Optional
            side = self._side_of(expr)
            if (
                (self._mode in (JoinMode.LEFT, JoinMode.OUTER) and side == "right")
                or (self._mode in (JoinMode.RIGHT, JoinMode.OUTER) and side == "left")
            ) and not dt.is_optional(d):
                d = dt.Optional_(d)
            out_dtypes[name] = d
        et = _new_engine_table(list(out_exprs.keys()), "join_select")
        _add_op(
            RowwiseOperator(
                self._engine_table, et, out_exprs, ctx, out_dtypes, name="join_select"
            )
        )
        return Table(et, out_dtypes, self._universe)

    def reduce(self, *args, **kwargs) -> Table:
        full = self.select(
            **{
                f"_l_{n}": ColumnReference(self._left, n)
                for n in self._left.column_names
            },
            **{
                f"_r_{n}": ColumnReference(self._right, n)
                for n in self._right.column_names
            },
        )
        return full.reduce(*args, **kwargs)

    def filter(self, expression) -> "Table":
        full_cols = {}
        for n in self._left.column_names:
            full_cols[n] = ColumnReference(self._left, n)
        for n in self._right.column_names:
            if n not in full_cols:
                full_cols[n] = ColumnReference(self._right, n)
        return self.select(**full_cols).filter(expression)

    def groupby(
        self,
        *args,
        id: Optional[Any] = None,
        sort_by: Optional[Any] = None,
        instance: Optional[Any] = None,
    ) -> "GroupedJoinResult":
        """Group the join result (reference: internals/joins.py:748 →
        GroupedJoinResult, groupbys.py:272)."""
        return GroupedJoinResult(
            self, list(args), id_expr=id, sort_by=sort_by, instance=instance
        )


class GroupedJoinResult:
    """``join(...).groupby(...)`` pending a reduce
    (reference internals/groupbys.py:272).  The join is materialized into an
    intermediate table carrying the grouping, id/sort_by/instance, and
    reducer-input expressions — all evaluated in the join's context — then
    grouped there."""

    def __init__(
        self,
        join_result: "JoinResult",
        grouping: List[Any],
        id_expr=None,
        sort_by=None,
        instance=None,
    ):
        self._join = join_result
        self._grouping = grouping
        self._id = id_expr
        self._sort_by = sort_by
        self._instance = instance

    def reduce(self, *args, **kwargs) -> Table:
        import copy as _copy

        out_exprs: Dict[str, Any] = {}
        for arg in args:
            if not isinstance(arg, ColumnReference):
                raise ValueError("positional reduce args must be column references")
            out_exprs[arg.name] = arg
        out_exprs.update({k: smart_coerce(v) for k, v in kwargs.items()})

        sel: Dict[str, Any] = {
            f"_g{i}": g for i, g in enumerate(self._grouping)
        }
        if self._id is not None:
            sel["_gid"] = self._id
        if self._sort_by is not None:
            sel["_gsort"] = self._sort_by
        if self._instance is not None:
            sel["_ginst"] = self._instance
        # every reducer node's args (bare outputs AND reducers nested inside
        # compound expressions like sum(x)/count() — round-3 advice) become
        # _r inputs evaluated in the join context; the reducers are then
        # re-bound onto the intermediate table
        def grouping_index(ref) -> Optional[int]:
            if not isinstance(ref, ColumnReference):
                return None
            for i, g in enumerate(self._grouping):
                # table identity matters: the two joined sides may both have
                # a column of this name — matching by name alone would
                # silently substitute the grouping side's values
                if (
                    isinstance(g, ColumnReference)
                    and g.name == ref.name
                    and g._table is ref._table
                ):
                    return i
            return None

        node_rebind: Dict[int, List[str]] = {}
        n_inputs = 0
        for name, expr in out_exprs.items():
            nested = (
                [expr]
                if isinstance(expr, ReducerExpression)
                else collect_reducers(expr)
            )
            if nested:
                for node in nested:
                    if id(node) in node_rebind:
                        continue
                    cols = []
                    for a in node._args:
                        sel[f"_r{n_inputs}"] = a
                        cols.append(f"_r{n_inputs}")
                        n_inputs += 1
                    node_rebind[id(node)] = cols
            elif grouping_index(expr) is None:
                # plain non-grouping output: reject here with the join-level
                # name (the reference raises for non-grouping columns in
                # reduce — silently folding them would group finer and
                # silently diverge; round-3 advice)
                refs = _collect_column_refs(expr)
                stray = [
                    r.name for r in refs if grouping_index(r) is None
                ]
                if stray:
                    raise ValueError(
                        f"reduce output {name!r} uses non-grouping "
                        f"column(s) {sorted(set(stray))} outside a reducer; "
                        "wrap them in a reducer or add them to groupby()"
                    )
                # expression-of-grouping / constant outputs are
                # group-invariant: selected into the intermediate table and
                # added to the inner grouping (the fold GroupedTable.reduce
                # applies to expressions over grouping columns)
                sel[f"_o_{name}"] = expr
        inter = self._join.select(**sel)
        passthrough = [c for c in sel if c.startswith("_o_")]
        grouped = inter.groupby(
            *[inter[f"_g{i}"] for i in range(len(self._grouping))],
            *[inter[c] for c in passthrough],
            id=inter["_gid"] if self._id is not None else None,
            sort_by=inter["_gsort"] if self._sort_by is not None else None,
            instance=inter["_ginst"] if self._instance is not None else None,
        )

        def rebound(node: ReducerExpression) -> ReducerExpression:
            clone = _copy.copy(node)
            clone._args = tuple(inter[c] for c in node_rebind[id(node)])
            clone._deps = clone._args
            return clone

        red_kwargs: Dict[str, Any] = {}
        for name, expr in out_exprs.items():
            if isinstance(expr, ReducerExpression):
                red_kwargs[name] = rebound(expr)
            elif collect_reducers(expr):
                # compound: clone with every nested reducer re-bound; the
                # grouped reduce handles the surrounding expression
                mapping = {
                    id(node): rebound(node) for node in collect_reducers(expr)
                }
                for ref in _collect_column_refs(expr, stop_at_reducers=True):
                    gi = grouping_index(ref)
                    if gi is None:
                        raise ValueError(
                            f"compound reduce output {name!r} uses "
                            f"non-grouping column {ref.name!r} outside a "
                            "reducer"
                        )
                    mapping[id(ref)] = inter[f"_g{gi}"]
                red_kwargs[name] = expr_substitute(expr, mapping)
            else:
                gi = grouping_index(expr)
                red_kwargs[name] = (
                    inter[f"_g{gi}"] if gi is not None else inter[f"_o_{name}"]
                )
        return grouped.reduce(**red_kwargs)
