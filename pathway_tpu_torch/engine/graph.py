"""Engine dataflow graph: tables, operators, scheduler (counterpart of
``pathway_tpu/engine/graph.py``).

A host-side operator DAG driven in topological order once per commit
tick; each operator transforms columnar ``Delta`` batches, and
device-heavy operators (batched ML UDFs, the KNN index) launch their CUDA
work inside their ``process``.  The port runs the graph in one process:
the reference's exchange plane between ranks (``dist_routing`` edges) is
a later slice, so ``dist_routing`` is only declared here.
"""

from __future__ import annotations

import heapq
import itertools
import time as _time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..internals.error_log import set_current_operator
from ..internals.trace import reraise_with_trace
from .delta import Delta, RowStore, empty_delta

__all__ = ["EngineTable", "EngineOperator", "EngineGraph", "OutputCallbacks"]


class EngineTable:
    """A node carrying rows: column names + materialised RowStore."""

    _ids = itertools.count()

    def __init__(self, column_names: Sequence[str], name: str = ""):
        self.id = next(EngineTable._ids)
        self.name = name or f"t{self.id}"
        self.column_names = list(column_names)
        self.store = RowStore(self.column_names)
        self.consumers: List[Tuple["EngineOperator", int]] = []
        self.producer: Optional["EngineOperator"] = None

    def empty_delta(self) -> Delta:
        return empty_delta(self.column_names)

    def __repr__(self):  # pragma: no cover
        return f"<EngineTable {self.name}({', '.join(self.column_names)})>"


class EngineOperator:
    """Base operator: consumes deltas on input ports, emits one output delta.

    Contract (incremental correctness): ``process`` is called sequentially in
    topological order within a tick; input table stores are already updated
    with the incoming delta, the operator's own output store is updated by
    the scheduler *after* ``process`` returns (so retraction lookups against
    ``self.output.store`` see the pre-update state).  Stateful operators keep
    their *own* per-port state and update it inside ``process`` (the
    bilinear-rule discipline: port-0 deltas join pre-update port-1 own state,
    and vice versa)."""

    _ids = itertools.count()

    def __init__(
        self,
        inputs: Sequence[EngineTable],
        output: Optional[EngineTable],
        name: str = "",
    ):
        self.id = next(EngineOperator._ids)
        self.name = name or type(self).__name__
        self.inputs = list(inputs)
        self.output = output
        self.topo_index: int = -1
        self.trace: Any = None  # user stack frame (internals/trace.py)
        # scrape-time observability (internals/metrics.py /metrics endpoint)
        self.rows_in: int = 0
        self.rows_out: int = 0
        self.process_ns: int = 0
        # per-tick latency probe (reference Prober/ProberStats,
        # src/engine/progress_reporter.rs): time spent in this operator
        # during the last completed tick
        self.last_tick_ns: int = 0
        self._tick_acc_ns: int = 0
        for port, table in enumerate(self.inputs):
            table.consumers.append((self, port))
        if output is not None:
            output.producer = self

    def process(self, port: int, delta: Delta, ts: int) -> Optional[Delta]:
        raise NotImplementedError

    def dist_routing(self, port: int):
        """How this input port's rows would be placed across cluster
        processes (reference: per-operator exchange pacts on timely
        collections — reshard by key shard, src/engine/dataflow/shard.rs:6).
        The port runs one process and reads it nowhere yet; operators keep
        their declarations for the multi-process slice.

        Returns one of:
          None        — row-local: any placement works (pure rowwise ops);
          "key"       — co-locate by the delta's row key (owner = key shard);
          callable    — computed routing keys: fn(delta) -> uint64[n]
                        (groupby routes by group key, join by join key);
          "gather"    — all rows to rank 0 (global operators: sort, sinks);
          "replicate" — every rank sees every row (device-mesh operators
                        whose device calls must stay SPMD across processes).
        The safe default for stateful operators is "gather"."""
        return "gather"

    def on_tick_end(self, ts: int) -> Optional[Delta]:
        """Called once per tick after all deltas settle (for time-based ops
        like buffers / forget)."""
        return None

    def on_end(self) -> Optional[Delta]:
        """Called when all sources are exhausted (flush buffers)."""
        return None

    def snapshot_state(self):
        """Serializable operator state for OPERATOR_PERSISTING checkpoints
        (reference operator_snapshot.rs); stateless operators raise."""
        raise NotImplementedError

    def restore_state(self, state) -> None:
        raise NotImplementedError

    def __repr__(self):  # pragma: no cover
        return f"<{self.name}#{self.id}>"


class OutputCallbacks:
    """Subscriber callbacks (reference SubscribeCallbacks, graph.rs:581)."""

    def __init__(
        self,
        on_change: Optional[Callable[[int, Tuple[Any, ...], int, int], None]] = None,
        on_time_end: Optional[Callable[[int], None]] = None,
        on_end: Optional[Callable[[], None]] = None,
    ):
        self.on_change = on_change
        self.on_time_end = on_time_end
        self.on_end = on_end


class EngineGraph:
    """Container for the lowered dataflow; assigns topological order."""

    def __init__(self):
        self.tables: List[EngineTable] = []
        self.operators: List[EngineOperator] = []
        self.sources: List["SourceOperator"] = []
        self.sinks: List[EngineOperator] = []
        self._topo_ops: List[EngineOperator] = []

    def add_table(self, column_names: Sequence[str], name: str = "") -> EngineTable:
        t = EngineTable(column_names, name)
        self.tables.append(t)
        return t

    def add_operator(self, op: EngineOperator) -> EngineOperator:
        self.operators.append(op)
        if op.trace is None:
            from ..internals.trace import trace_user_frame

            op.trace = trace_user_frame()
        from .operators.io import SourceOperator  # local import to avoid cycle

        if isinstance(op, SourceOperator):
            self.sources.append(op)
        return op

    def finalize(self) -> None:
        """Topologically order operators (graph is a DAG by construction)."""
        indegree: Dict[int, int] = {}
        ops_by_id = {op.id: op for op in self.operators}
        dependents: Dict[int, List[int]] = {op.id: [] for op in self.operators}
        for op in self.operators:
            deg = 0
            for t in op.inputs:
                if t.producer is not None:
                    deg += 1
                    dependents[t.producer.id].append(op.id)
            indegree[op.id] = deg
        ready = [op.id for op in self.operators if indegree[op.id] == 0]
        heapq.heapify(ready)
        order = 0
        while ready:
            oid = heapq.heappop(ready)
            ops_by_id[oid].topo_index = order
            order += 1
            for dep in dependents[oid]:
                indegree[dep] -= 1
                if indegree[dep] == 0:
                    heapq.heappush(ready, dep)
        if order != len(self.operators):
            raise RuntimeError("cycle detected in dataflow graph")
        self._topo_ops = sorted(self.operators, key=lambda o: o.topo_index)

    def propagate(self, initial: List[Tuple[EngineOperator, int, Delta]], ts: int) -> None:
        """Push deltas through the graph in topological order for one tick."""
        # priority queue keyed by (topo_index, seq) so operators fire in order
        seq = itertools.count()
        heap: List[Tuple[int, int, EngineOperator, int, Delta]] = []
        for op, port, delta in initial:
            heapq.heappush(heap, (op.topo_index, next(seq), op, port, delta))
        while heap:
            _, _, op, port, delta = heapq.heappop(heap)
            if delta.n == 0 and port >= 0:
                continue
            out = self._run_op(op, port, delta, ts)
            if out is not None and out.n > 0 and op.output is not None:
                out = out.consolidated()
                op.rows_out += out.n
                op.output.store.apply(out)
                for consumer, cport in op.output.consumers:
                    heapq.heappush(
                        heap, (consumer.topo_index, next(seq), consumer, cport, out)
                    )

    def _run_op(self, op: EngineOperator, port: int, delta: Delta, ts: int):
        """Execute one operator on one delta with error attribution + the
        per-operator latency/row probes."""
        t0 = _time.perf_counter_ns()
        set_current_operator(op)
        try:
            out = op.process(port, delta, ts)
        except Exception as exc:
            reraise_with_trace(op, exc)
        finally:
            set_current_operator(None)
        elapsed = _time.perf_counter_ns() - t0
        op.process_ns += elapsed
        op._tick_acc_ns += elapsed
        op.rows_in += delta.n
        return out

    def _collect(self, op, out, pending) -> None:
        """Queue an operator's tick-end/flush output; ``out`` is either a
        Delta for ``op.output`` or a list of (table, delta) for multi-output
        operators (iterate)."""
        if out is None:
            return
        if isinstance(out, list):
            for table, delta in out:
                if delta is None or delta.n == 0:
                    continue
                delta = delta.consolidated()
                table.store.apply(delta)
                for consumer, cport in table.consumers:
                    pending.append((consumer, cport, delta))
            return
        if out.n > 0 and op.output is not None:
            out = out.consolidated()
            op.output.store.apply(out)
            for consumer, cport in op.output.consumers:
                pending.append((consumer, cport, out))

    def tick_end(self, ts: int) -> None:
        """Run on_tick_end hooks (time-based operators may release buffers)."""
        pending: List[Tuple[EngineOperator, int, Delta]] = []
        for op in sorted(self.operators, key=lambda o: o.topo_index):
            set_current_operator(op)
            try:
                out = op.on_tick_end(ts)
            except Exception as exc:
                reraise_with_trace(op, exc)
            finally:
                set_current_operator(None)
            self._collect(op, out, pending)
        if pending:
            self.propagate(pending, ts)
        # roll the per-tick latency probes (progress_reporter.rs analog)
        for op in self.operators:
            op.last_tick_ns = op._tick_acc_ns
            op._tick_acc_ns = 0

    def flush_end(self, ts: int) -> None:
        pending: List[Tuple[EngineOperator, int, Delta]] = []
        for op in sorted(self.operators, key=lambda o: o.topo_index):
            set_current_operator(op)
            try:
                out = op.on_end()
            except Exception as exc:
                reraise_with_trace(op, exc)
            finally:
                set_current_operator(None)
            self._collect(op, out, pending)
        if pending:
            self.propagate(pending, ts)
