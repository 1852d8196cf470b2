"""Deduplicate: per-instance single accepted row chosen by a user acceptor
(reference: pw.stdlib.stateful.deduplicate, stdlib/stateful/deduplicate.py:9;
engine: deduplicate via stateful reduce, src/engine/dataflow/operators/
stateful_reduce.rs)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from ...internals.expression import ColumnExpression
from ...internals.keys import KEY_DTYPE, ref_scalars_batch
from ..delta import Delta, rows_equal
from ..graph import EngineOperator, EngineTable
from .rowwise import build_eval_context

__all__ = ["DeduplicateOperator"]


class DeduplicateOperator(EngineOperator):
    def __init__(
        self,
        input_table: EngineTable,
        output: EngineTable,
        value_expression: ColumnExpression,
        instance_expression: Optional[ColumnExpression],
        acceptor: Callable[[Any, Any], bool],
        ctx_cols: Mapping[Tuple[int, str], str],
        name: str = "deduplicate",
    ):
        super().__init__([input_table], output, name)
        self.value_expression = value_expression
        self.instance_expression = instance_expression
        self.acceptor = acceptor
        self.ctx_cols = dict(ctx_cols)
        # instance key -> (accepted value, row)
        self._state: Dict[int, Tuple[Any, Tuple[Any, ...]]] = {}

    def snapshot_state(self):
        return self._state

    def restore_state(self, state) -> None:
        self._state = state

    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        ins = delta.insertions()
        if ins.n == 0:
            return None
        ctx = build_eval_context(ins, self.ctx_cols)
        values = np.asarray(self.value_expression._eval(ctx))
        if self.instance_expression is not None:
            inst_vals = np.asarray(self.instance_expression._eval(ctx))
            inst_keys = ref_scalars_batch([inst_vals])
        else:
            inst_keys = np.zeros(ins.n, dtype=KEY_DTYPE)
        names = self.output.column_names
        cols = [ins.columns[c] for c in names]
        out: List[Tuple[int, int, Tuple[Any, ...]]] = []
        for i in range(ins.n):
            ik = int(inst_keys[i])
            value = values[i]
            row = tuple(c[i] for c in cols)
            prev = self._state.get(ik)
            prev_value = prev[0] if prev is not None else None
            if prev is None or self.acceptor(value, prev_value):
                if prev is not None and not rows_equal(prev[1], row):
                    out.append((ik, -1, prev[1]))
                    out.append((ik, 1, row))
                elif prev is None:
                    out.append((ik, 1, row))
                self._state[ik] = (value, row)
        if not out:
            return None
        return Delta.from_rows(names, out)
