"""Live ingest and the freshness plane (counterpart of
``pathway_tpu/serve/ingest.py``): connector commits become retrievable
documents while serve traffic runs.

An ``IngestConnector`` buffers keyed rows, stamps them at ``commit()``
(the arrival clock) and folds committed offsets into its
``ConnectorMonitor`` antichain.  One ``LiveIngestRunner`` thread polls the
pending queue in batches of ``ingest.batch_docs``, embeds each batch
(``encode_packed_to_device`` when the encoder has it), copies the
embeddings to the host OFF every index lock (the absorb plan), and
commits them into the IVF index and, when given, the forward index.  The
commit bumps the index generation: the scheduler's generation-keyed
result cache then serves the new documents without any invalidation.
Connector commits block once ``ingest.queue_cap`` documents wait.

The freshness plane attributes each document's journey:

- ``pathway_freshness_seconds``: arrival to retrievable, per document;
  ``pathway_freshness_stage_seconds{stage=queue_wait|embed|absorb_plan|
  commit}``: queue wait per document, the batch stages once per batch;
- one ``ingest.batch`` trace (``kind="ingest"``) per batch, rooted at the
  oldest rider's arrival, its four stage spans contiguous, so they sum
  to that document's freshness; a batch past the freshness threshold is
  force-kept;
- provider samples labeled ``ingest=<runner>`` (pending docs, oldest
  pending age, docs and backpressure counters, freshness p50/p99,
  per-connector lag), the recorder snapshot's ``ingest`` column;
- the ``freshness`` SLO (observe/slo.py) reads the histogram and
  ``overdue_pending()``, so an aging backlog burns budget before it lands.

While ``serve_latency`` fires and ``freshness`` does not, the loop yields
``ingest.backpressure_ms`` per pass (``pathway_ingest_backpressure_total``);
the reverse edge is the scheduler shedding shed-class requests while
freshness burns.  ``freshness_plane=False`` drops the histograms, traces
and provider (the overhead A/B arm); the absorb path is the same.

Fault sites, each fired under a spent deadline (an armed hang releases
at once): ``ingest.poll`` retries (the documents stay queued);
``ingest.embed`` and ``ingest.commit`` drop the batch, counted per
document on ``pathway_ingest_failures_total{stage}``.  A dropped batch
leaves the index as it was, so serves stay clean.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config, observe
from ..io._offsets import ConnectorMonitor, OffsetAntichain
from ..observe import slo as slo_mod
from ..observe import trace
from ..robust import Deadline, inject, log_once

__all__ = ["IngestConnector", "LiveIngestRunner", "ingest_runners"]

_STAGES = ("queue_wait", "embed", "absorb_plan", "commit")

# created at import, so the families render at 0 before the first document
_H_FRESH = observe.histogram("pathway_freshness_seconds")
_H_STAGE = {s: observe.histogram("pathway_freshness_stage_seconds", stage=s) for s in _STAGES}
_C_FAIL = {s: observe.counter("pathway_ingest_failures_total", stage=s) for s in ("poll", "embed", "commit")}

_runners: "weakref.WeakSet[LiveIngestRunner]" = weakref.WeakSet()


def ingest_runners() -> List["LiveIngestRunner"]:
    """Live runners (a weak registry), read by the freshness SLO."""
    return list(_runners)


def _stage_allowed(site: str) -> bool:
    """Fault gate: False when any armed fault at ``site`` fires (a
    raise, a delay clamped by the spent deadline, or a released hang)."""
    if not inject.any_armed():
        return True
    try:
        before = inject.fired_count(site)
        inject.fire(site, deadline=Deadline.after_ms(0.0))
        return inject.fired_count(site) == before
    except Exception:  # noqa: BLE001 - any fault at the site is a stage fault
        return False


class _Doc:
    __slots__ = ("key", "text", "t_arrival_ns", "connector")

    def __init__(self, key: int, text: str, t_arrival_ns: int, connector: str):
        self.key = int(key)
        self.text = str(text)
        self.t_arrival_ns = int(t_arrival_ns)
        self.connector = connector


def _host_rows(vecs) -> np.ndarray:
    """The absorb plan's device-to-host copy of a batch's embeddings."""
    if isinstance(vecs, torch.Tensor):
        return vecs.float().cpu().numpy()
    return np.asarray(vecs, np.float32)


class IngestConnector:
    """Buffers keyed rows; ``commit()`` stamps them (each document's
    freshness clock starts here), merges ``offsets`` into the monitor's
    antichain, hands the batch to the runner and returns the merged
    antichain."""

    def __init__(self, runner: "LiveIngestRunner", name: str):
        self._runner = runner
        self.name = str(name)
        self.monitor = ConnectorMonitor(self.name)
        self._buf: List[Tuple[int, str]] = []
        self._lock = threading.Lock()

    def insert(self, key: int, text: str) -> None:
        with self._lock:
            self._buf.append((int(key), str(text)))
        self.monitor.on_insert()

    def insert_rows(self, rows: Iterable[Tuple[int, str]]) -> None:
        rows = [(int(k), str(t)) for k, t in rows]
        with self._lock:
            self._buf.extend(rows)
        self.monitor.on_insert(len(rows))

    def commit(self, offsets: Optional[Mapping[Any, Any]] = None) -> OffsetAntichain:
        with self._lock:
            rows, self._buf = self._buf, []
        t = time.perf_counter_ns()
        docs = [_Doc(k, txt, t, self.name) for k, txt in rows]
        self.monitor.on_commit(OffsetAntichain(dict(offsets)) if offsets is not None else None)
        if docs:
            self._runner._enqueue(docs)
        return self.monitor.offsets

    def close(self) -> None:
        self.monitor.on_finish()


class LiveIngestRunner:
    """One maintenance thread absorbing committed documents into a live
    IVF index (``add(keys, host_rows)``) and an optional forward index
    (``add(keys, texts)``), with the freshness plane attached."""

    def __init__(
        self,
        encoder,
        index,
        forward=None,
        name: str = "live",
        autostart: bool = True,
        freshness_plane: bool = True,
    ):
        self.encoder = encoder
        self.index = index
        self.forward = forward
        self.name = str(name)
        self.freshness_plane = bool(freshness_plane)
        self._cv = threading.Condition()
        self._pending: "deque[_Doc]" = deque()
        self._inflight: List[_Doc] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._connectors: List[IngestConnector] = []
        self._docs_total = 0
        self._batches_total = 0
        self._backpressure_total = 0
        self._dropped_total = 0
        _runners.add(self)
        if self.freshness_plane:
            observe.register_provider(self)
        if autostart:
            self.start()

    # -- connector surface ---------------------------------------------------
    def connector(self, name: Optional[str] = None) -> IngestConnector:
        c = IngestConnector(self, name or f"{self.name}-connector")
        self._connectors.append(c)
        return c

    def ingest_routed(self, docs: Sequence[Tuple[int, str, int]], connector: str = "fleet") -> int:
        """Enqueue ``(key, text, t_arrival_ns)`` documents stamped at
        another host's connector commit, so freshness covers the routing
        hop too."""
        batch = [_Doc(int(k), str(t), int(ns), str(connector)) for k, t, ns in docs]
        if batch:
            self._enqueue(batch)
        return len(batch)

    def _enqueue(self, docs: Sequence[_Doc]) -> None:
        cap = config.get("ingest.queue_cap")
        with self._cv:
            for d in docs:
                # past the cap the producer blocks: pressure goes back to
                # the connector, never into unbounded memory
                while len(self._pending) >= cap and not self._stop.is_set():
                    self._cv.wait(0.05)
                self._pending.append(d)
            self._cv.notify_all()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True, name=f"ingest-{self.name}")
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def __enter__(self) -> "LiveIngestRunner":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until every queued document was absorbed or dropped."""
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            with self._cv:
                if not self._pending and not self._inflight:
                    return True
            time.sleep(0.002)
        return False

    # -- lag surface (SLO + provider) ----------------------------------------
    def pending_docs(self) -> int:
        with self._cv:
            return len(self._pending) + len(self._inflight)

    def oldest_pending_s(self) -> float:
        now = time.perf_counter_ns()
        with self._cv:
            stamps = [d.t_arrival_ns for d in self._inflight]
            if self._pending:
                stamps.append(self._pending[0].t_arrival_ns)
        return max(0.0, (now - min(stamps)) * 1e-9) if stamps else 0.0

    def overdue_pending(self, threshold_s: float) -> int:
        """Documents waiting longer than ``threshold_s``: the freshness
        SLO's bad events before they reach the histogram."""
        cut = time.perf_counter_ns() - int(threshold_s * 1e9)
        with self._cv:
            return sum(1 for d in self._pending if d.t_arrival_ns < cut) + sum(
                1 for d in self._inflight if d.t_arrival_ns < cut
            )

    @property
    def stats(self) -> Dict[str, Any]:
        return {
            "docs": self._docs_total,
            "batches": self._batches_total,
            "dropped": self._dropped_total,
            "backpressure": self._backpressure_total,
            "pending": self.pending_docs(),
        }

    def observe_metrics(self):
        labels = {"ingest": self.name}
        yield ("gauge", "pathway_ingest_pending_docs", labels, float(self.pending_docs()))
        yield ("gauge", "pathway_ingest_oldest_pending_seconds", labels, self.oldest_pending_s())
        yield ("counter", "pathway_ingest_docs_total", labels, self._docs_total)
        yield ("counter", "pathway_ingest_backpressure_total", labels, self._backpressure_total)
        for q in (0.5, 0.99):
            v = _H_FRESH.quantile_s(q)
            if v is not None:
                yield ("gauge", "pathway_freshness_quantile_seconds", {**labels, "q": str(q)}, v)
        for c in self._connectors:
            lag = c.monitor.lag_seconds()
            if lag is not None:
                yield ("gauge", "pathway_ingest_connector_lag_seconds", {**labels, "connector": c.name}, lag)

    # -- the maintenance loop ------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            # serve latency is the binding objective while it fires and
            # freshness does not: yield absorb cadence; the aging backlog
            # re-arms the freshness burn that wins it back
            firing = slo_mod.firing_specs()
            if "serve_latency" in firing and "freshness" not in firing:
                self._backpressure_total += 1
                self._stop.wait(config.get("ingest.backpressure_ms") * 1e-3)
            batch = self._poll()
            if not batch:
                self._stop.wait(config.get("ingest.poll_ms") * 1e-3)
                continue
            try:
                self._absorb(batch)
            finally:
                with self._cv:
                    self._inflight = []
                    self._cv.notify_all()

    def _poll(self) -> List[_Doc]:
        if not _stage_allowed("ingest.poll"):
            # retry: the documents never left the queue
            _C_FAIL["poll"].inc()
            self._stop.wait(config.get("ingest.poll_ms") * 1e-3)
            return []
        limit = config.get("ingest.batch_docs")
        with self._cv:
            batch: List[_Doc] = []
            while self._pending and len(batch) < limit:
                batch.append(self._pending.popleft())
            if batch:
                self._inflight = list(batch)
                self._cv.notify_all()
        return batch

    def _drop(self, stage: str, batch: List[_Doc], ctx) -> None:
        """A faulted embed or commit loses this batch's documents only."""
        _C_FAIL[stage].inc(len(batch))
        self._dropped_total += len(batch)
        log_once(
            f"ingest.{stage}:fault",
            "ingest %s stage faulted; dropped %d document(s), counted on "
            "pathway_ingest_failures_total{stage=%s}; serving continues", stage, len(batch), stage,
        )
        if ctx is not None:
            trace.finish(ctx, statuses=(f"ingest_{stage}_failed",))

    def _absorb(self, batch: List[_Doc]) -> None:
        t_dequeue = time.perf_counter_ns()
        t_oldest = min(d.t_arrival_ns for d in batch)
        ctx = None
        if self.freshness_plane:
            ctx = trace.start_trace("ingest.batch", kind="ingest")
            if ctx is not None:
                # the root starts at the oldest rider's arrival: its
                # duration is that document's freshness
                ctx.t0_ns = t_oldest
                ctx.annotate(docs=len(batch), connectors=sorted({d.connector for d in batch}))
        if not _stage_allowed("ingest.embed"):
            self._drop("embed", batch, ctx)
            return
        texts = [d.text for d in batch]
        keys = [d.key for d in batch]
        try:
            enc = getattr(self.encoder, "encode_packed_to_device", None) or self.encoder.encode_to_device
            vecs = enc(texts)
        except Exception as exc:  # noqa: BLE001 - a failed embed drops the batch
            log_once(f"ingest.embed:{type(exc).__name__}", "ingest embed failed (%r); dropping batch", exc)
            self._drop("embed", batch, ctx)
            return
        t_embed = time.perf_counter_ns()
        # the absorb plan: the device-to-host copy runs here, on this
        # thread and outside every index lock
        try:
            host = _host_rows(vecs)
        except Exception as exc:  # noqa: BLE001 - a failed copy drops the batch
            log_once(f"ingest.plan:{type(exc).__name__}", "ingest absorb plan failed (%r); dropping batch", exc)
            self._drop("embed", batch, ctx)
            return
        t_plan = time.perf_counter_ns()
        if not _stage_allowed("ingest.commit"):
            self._drop("commit", batch, ctx)
            return
        try:
            gen_before = getattr(self.index, "generation", None)
            self.index.add(keys, host)
            if self.forward is not None:
                # the forward index counts its own failures (late
                # interaction then skips those documents)
                self.forward.add(keys, texts)
        except Exception as exc:  # noqa: BLE001 - a failed commit drops the batch
            log_once(f"ingest.commit:{type(exc).__name__}", "ingest commit failed (%r); dropping batch", exc)
            self._drop("commit", batch, ctx)
            return
        t_commit = time.perf_counter_ns()
        # retrievable: the commit bumped the index generation
        self._docs_total += len(batch)
        self._batches_total += 1
        if self.freshness_plane:
            for d in batch:
                _H_FRESH.observe_ns(t_commit - d.t_arrival_ns)
                _H_STAGE["queue_wait"].observe_ns(t_dequeue - d.t_arrival_ns)
            _H_STAGE["embed"].observe_ns(t_embed - t_dequeue)
            _H_STAGE["absorb_plan"].observe_ns(t_plan - t_embed)
            _H_STAGE["commit"].observe_ns(t_commit - t_plan)
        if ctx is not None:
            ctx.add_span("ingest.queue_wait", t_oldest, t_dequeue, exemplar=_H_STAGE["queue_wait"])
            ctx.add_span("ingest.embed", t_dequeue, t_embed, exemplar=_H_STAGE["embed"])
            ctx.add_span("ingest.absorb_plan", t_embed, t_plan, exemplar=_H_STAGE["absorb_plan"])
            ctx.add_span("ingest.commit", t_plan, t_commit, exemplar=_H_STAGE["commit"])
            ctx.annotate(generation=getattr(self.index, "generation", None), generation_before=gen_before)
            threshold_s = config.get("observe.slo_freshness_ms") * 1e-3
            trace.finish(ctx, force_keep=(t_commit - t_oldest) * 1e-9 >= threshold_s)
