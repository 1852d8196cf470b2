"""Time gate: buffering (delay), late-data drop (cutoff), state forgetting.

The engine analog of the reference's time-column operators — ``postpone_core``
(buffer rows until the stream clock passes their release threshold,
src/engine/dataflow/operators/time_column.rs:380), ``ignore_late`` (drop rows
whose expiry the clock already passed, :677) and ``Graph::forget/freeze``
(src/engine/graph.rs:776-812).  One operator covers all three in the
micro-batch model:

- The **clock** is the maximum time-column value seen so far (data time, not
  wall time), optionally shared between operators (interval joins share one
  clock across both inputs, like the reference's global frontier).
- **delay**: a row whose ``release`` threshold is above the clock is held in
  the buffer; buffered rows are released at tick end once the clock passes
  (and flushed unconditionally when the stream ends — reference behavior on
  input closure).
- **cutoff**: a row whose ``expire`` threshold is at or below the clock *as
  of the previous batches* is dropped (an atomic batch is never split by its
  own maximum).  Retractions targeting buffered rows cancel in place.
- **forgetting**: downstream operators register ``sweep_hooks``; each tick
  the gate calls them with a one-tick-lagged clock so a hook never forgets
  state for rows released in the same collection round.  Hooks drop expired
  group/join state (and, for keep_results=False, retract frozen results).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ...internals.expression import ColumnExpression
from ..delta import Delta, _object_array
from ..graph import EngineOperator, EngineTable
from .rowwise import build_eval_context

__all__ = ["TimeGateOperator", "SharedClock"]


class SharedClock:
    """Monotone max over every time value routed through the attached gates
    (the micro-batch analog of the reference's input frontier)."""

    def __init__(self) -> None:
        self.value: float = float("-inf")

    def advance(self, t: float) -> None:
        if t > self.value:
            self.value = t


# a sweep hook takes the lagged clock and returns (table, retraction delta)
# or None; it may mutate its owner's state (forget expired groups)
SweepHook = Callable[[float], Optional[Tuple[EngineTable, Delta]]]


class TimeGateOperator(EngineOperator):
    def __init__(
        self,
        input_table: EngineTable,
        output: EngineTable,
        time_expr: ColumnExpression,
        release_expr: Optional[ColumnExpression],
        expire_expr: Optional[ColumnExpression],
        ctx_cols,
        clock: Optional[SharedClock] = None,
        name: str = "time_gate",
    ):
        super().__init__([input_table], output, name)
        self.time_expr = time_expr
        self.release_expr = release_expr
        self.expire_expr = expire_expr
        self.ctx_cols = dict(ctx_cols)
        self.clock = clock or SharedClock()
        # key -> (row tuple, release threshold)
        self._buffer: Dict[int, Tuple[Tuple[Any, ...], float]] = {}
        self._swept_clock: float = float("-inf")
        self._prev_clock: float = float("-inf")
        self.sweep_hooks: List[SweepHook] = []

    # -- persistence -------------------------------------------------------
    def snapshot_state(self):
        return {
            "buffer": self._buffer,
            "clock": self.clock.value,
            "swept": self._swept_clock,
        }

    def restore_state(self, state) -> None:
        self._buffer = state["buffer"]
        self.clock.advance(state["clock"])
        self._swept_clock = state["swept"]
        self._prev_clock = state["clock"]

    # -- processing --------------------------------------------------------
    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        if delta.n == 0:
            return None
        delta = delta.consolidated()
        ctx = build_eval_context(delta, self.ctx_cols)
        times = np.asarray(self.time_expr._eval(ctx), dtype=np.float64)
        releases = (
            np.asarray(self.release_expr._eval(ctx), dtype=np.float64)
            if self.release_expr is not None
            else None
        )
        expires = (
            np.asarray(self.expire_expr._eval(ctx), dtype=np.float64)
            if self.expire_expr is not None
            else None
        )
        # the cutoff comparison uses the clock BEFORE this batch: one atomic
        # batch never drops its own rows however they are ordered inside it
        clock_before = self.clock.value
        names = self.output.column_names
        cols = [delta.columns[c] for c in names]

        out_keys: List[int] = []
        out_diffs: List[int] = []
        out_rows: List[Tuple[Any, ...]] = []
        row_iter = zip(*(list(c) for c in cols)) if cols else iter([()] * delta.n)
        for i, (key, diff, row) in enumerate(
            zip(delta.keys.tolist(), delta.diffs.tolist(), row_iter)
        ):
            if diff > 0:
                self.clock.advance(float(times[i]))
                if expires is not None and float(expires[i]) <= clock_before:
                    continue  # late: dropped (ignore_late)
                if releases is not None:
                    rel = float(releases[i])
                    if rel > self.clock.value:
                        self._buffer[key] = (row, rel)
                        continue
                out_keys.append(key)
                out_diffs.append(1)
                out_rows.append(row)
            else:
                held = self._buffer.pop(key, None)
                if held is not None:
                    continue  # cancelled while still buffered
                if expires is not None and float(expires[i]) <= clock_before:
                    continue  # retraction of an already-frozen row: blocked
                out_keys.append(key)
                out_diffs.append(-1)
                out_rows.append(row)
        if not out_keys:
            return None
        return self._delta_of(out_keys, out_diffs, out_rows)

    def _delta_of(self, keys, diffs, rows) -> Delta:
        names = self.output.column_names
        transposed = list(zip(*rows)) if rows else [()] * len(names)
        return Delta(
            keys=np.asarray(keys, dtype=np.uint64),
            diffs=np.asarray(diffs, dtype=np.int64),
            columns={
                name: _object_array(transposed[ci])
                for ci, name in enumerate(names)
            },
        )

    def _release_due(self, threshold: float) -> Optional[Delta]:
        due = [
            (key, row)
            for key, (row, rel) in self._buffer.items()
            if rel <= threshold
        ]
        if not due:
            return None
        for key, _row in due:
            del self._buffer[key]
        return self._delta_of(
            [k for k, _ in due], [1] * len(due), [r for _, r in due]
        )

    def on_tick_end(self, ts: int):
        outputs: List[Tuple[EngineTable, Delta]] = []
        released = self._release_due(self.clock.value)
        if released is not None:
            outputs.append((self.output, released))
        # sweeps lag one tick so hooks never forget state belonging to rows
        # released in this same collection round (the exactly-once shape has
        # release == expire)
        sweep_clock = self._prev_clock
        self._prev_clock = self.clock.value
        if sweep_clock > self._swept_clock:
            self._swept_clock = sweep_clock
            for hook in self.sweep_hooks:
                out = hook(sweep_clock)
                if out is not None:
                    outputs.append(out)
        return outputs or None

    def on_end(self):
        # input closed: flush every buffered row (reference postpone flushes
        # on stream end); no final sweep — results stand
        released = self._release_due(float("inf"))
        return [(self.output, released)] if released is not None else None
