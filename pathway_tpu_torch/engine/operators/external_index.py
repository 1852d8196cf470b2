"""External index operator of the port (counterpart of
``pathway_tpu/engine/operators/external_index.py``): incrementally
maintained retrieval index answering query rows (reference: Graph::use_external_index_as_of_now,
src/engine/graph.rs:915; custom timely operator
src/engine/dataflow/operators/external_index.rs; framework
src/external_integration/mod.rs:40-130).

Two flavors:
- as-of-now (serving): each query answered against the index state at
  arrival; answers never retract when the index changes (matches
  ``query_as_of_now``).
- consistent: query results are maintained — when the index changes, affected
  answers are retracted and re-emitted (matches ``query()``).  Recomputation
  is batched per tick (one device search for all live queries), which is the
  columnar analog of differential's per-record updates.

Under a process cluster both inputs are replicated to every rank (each
rank holds the whole index, and a mesh index's device calls stay SPMD),
and the operator keeps a mirror of each input's rows (``mirrors``) for
the result's column lookups, which the reference reads from the input
tables' stores, where a rank holds only its own keys.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ...internals.expression import ColumnExpression
from ...internals.keys import KEY_DTYPE
from ...parallel import distributed
from ..delta import Delta, RowStore, rows_equal
from ..graph import EngineOperator, EngineTable
from .rowwise import build_eval_context

__all__ = ["ExternalIndexOperator"]


class ExternalIndexOperator(EngineOperator):
    """Inputs: port 0 = data (indexed side), port 1 = queries.

    Output columns: ``_pw_qkey`` (query key copy), ``_pw_reply`` (tuple of
    (data_key, score) pairs, best first), keyed by query key."""

    def __init__(
        self,
        data_table: EngineTable,
        query_table: EngineTable,
        output: EngineTable,
        index,  # protocol: add(keys, values, metadatas), remove(keys), search(values, k, filters)
        data_expr: ColumnExpression,
        data_ctx: Mapping[Tuple[int, str], str],
        query_expr: ColumnExpression,
        query_ctx: Mapping[Tuple[int, str], str],
        k: int = 3,
        k_expr: Optional[ColumnExpression] = None,
        metadata_expr: Optional[ColumnExpression] = None,
        filter_expr: Optional[ColumnExpression] = None,
        asof_now: bool = True,
        name: str = "external_index",
    ):
        super().__init__([data_table, query_table], output, name)
        self.index = index
        self.data_expr = data_expr
        self.data_ctx = dict(data_ctx)
        self.query_expr = query_expr
        self.query_ctx = dict(query_ctx)
        self.k = k
        self.k_expr = k_expr  # optional per-query match count column
        self.metadata_expr = metadata_expr
        self.filter_expr = filter_expr
        self.asof_now = asof_now
        # consistent mode: live queries qkey -> (value, filter, k)
        self._queries: Dict[int, Tuple[Any, Any, int]] = {}
        self._dirty = False
        # distributed runs: this operator sees every row of both inputs (its
        # routing replicates them) while each input table's store holds the
        # rank's owned slice only, so the result's lookups of data and query
        # columns (stdlib/indexing/data_index.py) read these full mirrors
        self.mirrors: Optional[List[RowStore]] = None

    def dist_routing(self, port: int):
        # distributed: every rank maintains the FULL index and sees every
        # query.  The device plane shards under the hood (a DeviceKnnIndex
        # on a mesh across processes needs every process issuing the same
        # device calls — SPMD); rank-0-only processing would deadlock those
        # collectives, and key-sharding host-side would duplicate what the
        # mesh already does.
        return "replicate"

    # -- data side ---------------------------------------------------------
    def _process_data(self, delta: Delta) -> None:
        delta = delta.consolidated()
        rets = delta.retractions()
        ins = delta.insertions()
        if rets.n:
            self.index.remove([int(k) for k in rets.keys])
        if ins.n:
            ctx = build_eval_context(ins, self.data_ctx)
            values = self.data_expr._eval(ctx)
            metadatas = (
                list(self.metadata_expr._eval(ctx))
                if self.metadata_expr is not None
                else [None] * ins.n
            )
            self.index.add([int(k) for k in ins.keys], list(values), metadatas)
        self._dirty = self._dirty or delta.n > 0

    # -- query side --------------------------------------------------------
    def _answer(
        self,
        qkeys: Sequence[int],
        values: Sequence[Any],
        filters: Sequence[Any],
        ks: Optional[Sequence[int]] = None,
    ) -> List[Tuple[int, int, Tuple[Any, ...]]]:
        if ks is not None:
            ks = [int(kv) if kv is not None else self.k for kv in ks]
            k_max = max(ks) if ks else self.k
        else:
            k_max = self.k
        replies = self.index.search(list(values), k_max, list(filters))
        out = []
        for i, (qk, reply) in enumerate(zip(qkeys, replies)):
            k_i = ks[i] if ks is not None else self.k
            out.append((int(qk), 1, (np.uint64(qk), tuple(reply[:k_i]))))
        return out

    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        if distributed.is_distributed():
            if self.mirrors is None:
                self.mirrors = [RowStore(t.column_names) for t in self.inputs]
            self.mirrors[port].apply(delta.consolidated())
        out_names = self.output.column_names
        if port == 0:
            self._process_data(delta)
            if self.asof_now or not self._queries:
                return None
            # consistent mode: recompute all live queries, emit diffs
            qkeys = list(self._queries.keys())
            values = [self._queries[qk][0] for qk in qkeys]
            filters = [self._queries[qk][1] for qk in qkeys]
            ks = [self._queries[qk][2] for qk in qkeys]
            fresh = self._answer(qkeys, values, filters, ks)
            out: List[Tuple[int, int, Tuple[Any, ...]]] = []
            for qk, _diff, row in fresh:
                old = self.output.store.get(qk)
                if old is not None and not rows_equal(old, row):
                    out.append((qk, -1, old))
                if old is None or not rows_equal(old, row):
                    out.append((qk, 1, row))
            return Delta.from_rows(out_names, out) if out else None

        # port 1: queries
        delta = delta.consolidated()
        out: List[Tuple[int, int, Tuple[Any, ...]]] = []
        rets = delta.retractions()
        for qk in rets.keys:
            qk = int(qk)
            self._queries.pop(qk, None)
            old = self.output.store.get(qk)
            if old is not None:
                out.append((qk, -1, old))
        ins = delta.insertions()
        if ins.n:
            ctx = build_eval_context(ins, self.query_ctx)
            values = list(self.query_expr._eval(ctx))
            filters = (
                list(self.filter_expr._eval(ctx))
                if self.filter_expr is not None
                else [None] * ins.n
            )
            qkeys = [int(k) for k in ins.keys]
            ks = None
            if self.k_expr is not None:
                ks = [
                    int(kv) if kv is not None else self.k
                    for kv in self.k_expr._eval(ctx)
                ]
            if not self.asof_now:
                for i, (qk, v, f) in enumerate(zip(qkeys, values, filters)):
                    self._queries[qk] = (v, f, ks[i] if ks else self.k)
            out.extend(self._answer(qkeys, values, filters, ks))
        return Delta.from_rows(out_names, out) if out else None
