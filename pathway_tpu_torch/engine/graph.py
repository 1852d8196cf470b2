"""Engine dataflow graph: tables, operators, scheduler (counterpart of
``pathway_tpu/engine/graph.py``).

A host-side operator DAG driven in topological order once per commit
tick; each operator transforms columnar ``Delta`` batches, and
device-heavy operators (batched ML UDFs, the KNN index) launch their CUDA
work inside their ``process``.

Distribution is two-plane, as in the reference: device state shards over
a port ``Mesh`` *inside* the ops (``torch.distributed`` collectives,
``parallel/mesh.py``), while the host relational plane shards BY ROW KEY
across cluster processes — every rank runs this same DAG on its key
slice, and exchange edges (``dist_routing``) move rows between ranks over
``parallel/exchange.py`` exactly where the reference reshards timely
collections (src/engine/dataflow.rs:3314).
"""

from __future__ import annotations

import heapq
import itertools
import time as _time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..internals.keys import KEY_DTYPE
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
        """How this input port's rows are placed across cluster processes in
        distributed runs (reference: per-operator exchange pacts on timely
        collections — reshard by key shard, src/engine/dataflow/shard.rs:6).

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
        # distributed run state (set by the Executor when PATHWAY_PROCESSES>1):
        # the host exchange plane, a BSP round counter, and per-edge routing
        self.plane = None
        self._round = 0
        self._topo_ops: List[EngineOperator] = []
        self._edge_layout: Dict[Tuple[int, int], str] = {}

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
        if self.plane is not None:
            self._infer_layouts()

    def _infer_layouts(self) -> None:
        """Static placement analysis for distributed runs.  Each table is
        either "sharded" (the global stream is the disjoint union of the
        ranks' local streams) or "replicated" (every rank holds the full
        stream).  The distinction decides what an exchange edge does at
        runtime: routing a REPLICATED input by key must *filter* locally
        (every rank already has every row — a network exchange would
        duplicate rows N times), while routing a SHARDED input is a real
        all-to-all.  Mirrors the reference's static exchange placement on
        timely collections (src/engine/dataflow.rs:3314 reshard)."""
        layout: Dict[int, str] = {}
        for op in self._topo_ops:
            from .operators.io import SourceOperator

            if isinstance(op, SourceOperator):
                mode = getattr(op, "dist_mode", "replicated")
                layout[op.output.id] = (
                    "replicated" if mode == "broadcast" else "sharded"
                )
                continue
            effective = []
            for port, table in enumerate(op.inputs):
                routing = op.dist_routing(port)
                in_layout = layout.get(table.id, "sharded")
                if routing == "replicate":
                    eff = "replicated"
                elif routing is None:
                    eff = in_layout
                else:  # "key" / callable / "gather" all yield sharded placements
                    eff = "sharded"
                self._edge_layout[(op.id, port)] = in_layout
                effective.append(eff)
            if op.output is not None:
                layout[op.output.id] = (
                    "replicated"
                    if effective and all(e == "replicated" for e in effective)
                    else "sharded"
                )

    def _exchange(self, op: EngineOperator, port: int, delta: Delta, rnd: int) -> Delta:
        """Apply this edge's routing through the exchange plane (BSP: every
        rank calls this for every exchange edge every round, in the same
        order)."""
        from ..internals.keys import shards_of

        plane = self.plane
        routing = op.dist_routing(port)
        names = op.inputs[port].column_names
        in_layout = self._edge_layout.get((op.id, port), "sharded")
        edge = f"e{op.id}.{port}"
        if routing is None:
            return delta
        if routing == "replicate":
            if in_layout == "replicated":
                return delta
            parts = [delta] * plane.nproc
            got = plane.all_to_all(edge, rnd, parts)
            return Delta.concat([d for d in got if d.n], names)
        if routing == "gather":
            if in_layout == "replicated":
                return delta if plane.rank == 0 else empty_delta(names)
            got = plane.gather(edge, rnd, delta)
            if got is None:
                return empty_delta(names)
            return Delta.concat([d for d in got if d.n], names)
        # "key" or computed-key routing
        if routing == "key":
            route_keys = delta.keys
        else:
            try:
                route_keys = routing(delta) if delta.n else delta.keys
            except Exception as exc:
                reraise_with_trace(op, exc)
        owners = shards_of(np.asarray(route_keys, dtype=KEY_DTYPE), plane.nproc)
        if in_layout == "replicated":
            # every rank holds the full stream: keep the owned slice locally
            return delta.select_rows(owners == plane.rank)
        parts = [delta.select_rows(owners == p) for p in range(plane.nproc)]
        got = plane.all_to_all(edge, rnd, parts)
        return Delta.concat([d for d in got if d.n], names)

    def propagate(self, initial: List[Tuple[EngineOperator, int, Delta]], ts: int) -> None:
        """Push deltas through the graph in topological order for one tick."""
        if self.plane is not None:
            return self._propagate_dist(initial, ts)
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

    def _propagate_dist(self, initial: List[Tuple[EngineOperator, int, Delta]], ts: int) -> None:
        """Distributed tick propagation: a strict topological sweep in which
        every rank visits every exchange edge exactly once per round (BSP) —
        the deterministic global order is what makes the plane's collectives
        deadlock-free.  Exchange edges run even when the local delta is empty
        (a peer may be routing rows here); row-local edges behave exactly
        like the single-process heap path."""
        rnd = self._round
        self._round += 1
        pending: Dict[Tuple[int, int], List[Delta]] = {}
        for op, port, delta in initial:
            pending.setdefault((op.id, port), []).append(delta)
        from .operators.io import SourceOperator

        for op in self._topo_ops:
            if isinstance(op, SourceOperator):
                continue
            for port in range(len(op.inputs)):
                names = op.inputs[port].column_names
                deltas = pending.pop((op.id, port), None)
                merged = (
                    Delta.concat(deltas, names) if deltas else empty_delta(names)
                )
                if op.dist_routing(port) is not None:
                    merged = self._exchange(op, port, merged, rnd)
                if merged.n == 0:
                    continue
                merged = merged.consolidated()
                if merged.n == 0:
                    continue
                out = self._run_op(op, port, merged, ts)
                if out is not None and out.n > 0 and op.output is not None:
                    out = out.consolidated()
                    op.rows_out += out.n
                    op.output.store.apply(out)
                    for consumer, cport in op.output.consumers:
                        pending.setdefault((consumer.id, cport), []).append(out)

    def _run_op(self, op: EngineOperator, port: int, delta: Delta, ts: int):
        """Execute one operator on one delta with error attribution + the
        per-operator latency/row probes (shared by the single-process heap
        path and the distributed sweep)."""
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
        if pending or self.plane is not None:
            # distributed: ranks must run the SAME number of propagate rounds
            # per tick (every round walks every exchange edge), so tick-end
            # propagation happens even when locally empty
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
        if pending or self.plane is not None:
            self.propagate(pending, ts)
