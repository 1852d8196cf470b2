"""DataIndex — query API over live retrieval indexes
(reference: stdlib/indexing/data_index.py:278 DataIndex, :206 InnerIndex;
``query()`` = fully consistent/retracting, ``query_as_of_now()`` =
non-retracting serving contract, data_index.py:364-441).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...engine.operators.external_index import ExternalIndexOperator
from ...internals import dtype as dt
from ...internals.expression import (
    ApplyExpression,
    ColumnExpression,
    ColumnReference,
    smart_coerce,
)
from ...internals.parse_graph import G
from ...internals.table import Table
from ...internals.thisclass import this
from ...internals.universe import Universe

__all__ = ["InnerIndex", "DataIndex", "IndexQueryResult"]


class InnerIndex:
    """Descriptor of an index over one column of a data table."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column: Optional[ColumnReference] = None,
        factory=None,
        dimension: Optional[int] = None,
    ):
        self.data_column = data_column
        self.metadata_column = metadata_column
        self.factory = factory
        self.dimension = dimension

    @property
    def data_table(self) -> Table:
        return self.data_column.table


class DataIndex:
    """(reference DataIndex, data_index.py:278)"""

    def __init__(
        self,
        data_table: Table,
        inner_index: InnerIndex,
    ):
        self.data_table = data_table
        self.inner_index = inner_index

    def _build(self, query_column, k, metadata_filter, asof_now: bool) -> Table:
        from ...internals.expression import ColumnExpression as _CE

        k_expr = None
        if isinstance(k, _CE):
            k_expr, k = k, 16
        query_expr = smart_coerce(query_column)
        refs = [r for r in query_expr._column_refs() if isinstance(r.table, Table)]
        if not refs:
            raise ValueError("query column must reference a query table")
        query_table = refs[0].table
        data_table = self.data_table
        index_impl = self.inner_index.factory.build_inner_index(
            self.inner_index.dimension
        )
        reply_et = G.engine_graph.add_table(["_pw_qkey", "_pw_reply"], "index_reply")
        filter_expr = smart_coerce(metadata_filter) if metadata_filter is not None else None
        op = ExternalIndexOperator(
            data_table._engine_table,
            query_table._engine_table,
            reply_et,
            index=index_impl,
            data_expr=smart_coerce(self.inner_index.data_column),
            data_ctx=data_table._ctx_cols(placeholders=[this]),
            query_expr=query_expr,
            query_ctx=query_table._ctx_cols(placeholders=[this]),
            k=k,
            k_expr=k_expr,
            metadata_expr=smart_coerce(self.inner_index.metadata_column)
            if self.inner_index.metadata_column is not None
            else None,
            filter_expr=filter_expr,
            asof_now=asof_now,
            name="external_index" + ("_asof_now" if asof_now else ""),
        )
        G.engine_graph.add_operator(op)
        reply_table = Table(
            reply_et,
            {"_pw_qkey": dt.POINTER, "_pw_reply": dt.ANY},
            query_table._universe,
            short_name="index_reply",
        )
        return query_table, reply_table, op

    def query_as_of_now(
        self,
        query_column,
        *,
        number_of_matches: int = 3,
        collapse_rows: bool = True,
        metadata_filter=None,
        **kwargs,
    ) -> "IndexQueryResult":
        query_table, reply, op = self._build(
            query_column, number_of_matches, metadata_filter, asof_now=True
        )
        return IndexQueryResult(self, query_table, reply, collapse_rows, op)

    def query(
        self,
        query_column,
        *,
        number_of_matches: int = 3,
        collapse_rows: bool = True,
        metadata_filter=None,
        **kwargs,
    ) -> "IndexQueryResult":
        query_table, reply, op = self._build(
            query_column, number_of_matches, metadata_filter, asof_now=False
        )
        return IndexQueryResult(self, query_table, reply, collapse_rows, op)


class _ScoreMarker:
    """Placeholder expression for the match score inside result.select()."""


SCORE = _ScoreMarker()


class IndexQueryResult:
    """Supports ``.select(...)`` with columns from the query table (scalar per
    query) and the data table (tuple per query when collapsed, scalar per
    match otherwise); ``result.score`` gives similarity scores."""

    def __init__(
        self,
        index: DataIndex,
        query_table: Table,
        reply_table: Table,
        collapse_rows: bool,
        operator: Optional[ExternalIndexOperator] = None,
    ):
        self._index = index
        self._query_table = query_table
        self._reply = reply_table
        self._collapse = collapse_rows
        self._operator = operator

    def _lookup(self, table: Table, api_col: str, port: int) -> Callable[[int], Any]:
        """``key -> value of api_col`` in ``table``'s rows: its store, or
        in a distributed run (where the store holds this rank's keys only)
        the index operator's mirror of that input (``port``)."""
        engine_col = table._column_mapping[api_col]
        store = table._engine_table.store
        idx = store.column_names.index(engine_col)
        op = self._operator

        def lookup(key: int):
            row = store.get(int(key))
            if row is None and op is not None and op.mirrors is not None:
                row = op.mirrors[port].get(int(key))
            return row[idx] if row is not None else None

        return lookup

    @property
    def score(self) -> _ScoreMarker:
        return SCORE

    # -- data lookup helpers ----------------------------------------------
    def _data_lookup_fn(self, api_col: str) -> Callable[[int], Any]:
        return self._lookup(self._index.data_table, api_col, 0)

    def _remap_collapsed(self, expr):
        """Data-table refs -> tuple-valued applies over the reply column."""
        if isinstance(expr, _ScoreMarker):
            return ApplyExpression(
                lambda reply: tuple(float(s) for _k, s in reply),
                dt.ANY,
                args=(self._reply._pw_reply,),
            )
        if isinstance(expr, ColumnReference) and expr.table is self._index.data_table:
            lookup = self._data_lookup_fn(expr.name)
            return ApplyExpression(
                lambda reply, _f=lookup: tuple(_f(k) for k, _s in reply),
                dt.ANY,
                args=(self._reply._pw_reply,),
            )
        if isinstance(expr, ColumnExpression):
            import copy

            new = copy.copy(expr)
            for attr, value in list(vars(new).items()):
                if isinstance(value, (ColumnExpression, _ScoreMarker)):
                    setattr(new, attr, self._remap_collapsed(value))
                elif isinstance(value, tuple) and any(
                    isinstance(v, (ColumnExpression, _ScoreMarker)) for v in value
                ):
                    setattr(
                        new,
                        attr,
                        tuple(
                            self._remap_collapsed(v)
                            if isinstance(v, (ColumnExpression, _ScoreMarker))
                            else v
                            for v in value
                        ),
                    )
            new._deps = tuple(
                self._remap_collapsed(d) if isinstance(d, (ColumnExpression, _ScoreMarker)) else d
                for d in getattr(new, "_deps", ())
            )
            return new
        return expr

    def select(self, *args, **kwargs) -> Table:
        exprs: Dict[str, Any] = {}
        for arg in args:
            if isinstance(arg, ColumnReference):
                exprs[arg.name] = arg
            else:
                raise ValueError("positional select args must be column references")
        exprs.update(kwargs)
        if self._collapse:
            out = {name: self._remap_collapsed(e) for name, e in exprs.items()}
            return self._query_table.select(**out)
        # non-collapsed: one row per (query, match)
        flat = self._reply.flatten(self._reply._pw_reply)
        enriched = flat.select(
            _pw_qkey=flat._pw_qkey,
            _pw_match_key=ApplyExpression(
                lambda m: int(m[0]), dt.POINTER, args=(this._pw_reply,)
            ),
            _pw_score=ApplyExpression(
                lambda m: float(m[1]), dt.FLOAT, args=(this._pw_reply,)
            ),
        )
        out_exprs: Dict[str, ColumnExpression] = {}
        for name, e in exprs.items():
            out_exprs[name] = self._remap_flat(e, enriched)
        return enriched.select(**out_exprs)

    def _remap_flat(self, expr, enriched: Table):
        if isinstance(expr, _ScoreMarker):
            return enriched._pw_score
        if isinstance(expr, ColumnReference) and expr.table is self._index.data_table:
            lookup = self._data_lookup_fn(expr.name)
            return ApplyExpression(
                lambda k, _f=lookup: _f(k), dt.ANY, args=(enriched._pw_match_key,)
            )
        if isinstance(expr, ColumnReference) and (
            expr.table is self._query_table or expr.table is this
        ):
            lookup = self._query_lookup_fn(expr.name)
            return ApplyExpression(
                lambda qk, _f=lookup: _f(qk), dt.ANY, args=(enriched._pw_qkey,)
            )
        if isinstance(expr, ColumnExpression):
            import copy

            new = copy.copy(expr)
            for attr, value in list(vars(new).items()):
                if isinstance(value, (ColumnExpression, _ScoreMarker)):
                    setattr(new, attr, self._remap_flat(value, enriched))
                elif isinstance(value, tuple) and any(
                    isinstance(v, (ColumnExpression, _ScoreMarker)) for v in value
                ):
                    setattr(
                        new,
                        attr,
                        tuple(
                            self._remap_flat(v, enriched)
                            if isinstance(v, (ColumnExpression, _ScoreMarker))
                            else v
                            for v in value
                        ),
                    )
            new._deps = tuple(
                self._remap_flat(d, enriched)
                if isinstance(d, (ColumnExpression, _ScoreMarker))
                else d
                for d in getattr(new, "_deps", ())
            )
            return new
        return expr

    def _query_lookup_fn(self, api_col: str) -> Callable[[int], Any]:
        return self._lookup(self._query_table, api_col, 1)
