"""Continuous cross-request batching (counterpart of
``pathway_tpu/serve/scheduler.py``): a coalescing serve scheduler with
double-buffered stage pipelining over the port's serve targets.

One scheduler thread owns admission; the future-handoff contract keeps
every blocking wait off the queue lock:

    caller --submit()--> admission queue --window--> scheduler thread
                                                     | sorted-unique batch,
                                                     | ONE stage-1 dispatch
                                                     | (batch N), then
                                                     | advance(batch N-1)
    caller <--ticket()-- per-request demux <---------+
              (the WAITER performs the host fetch)

- **Window**: ``serve.coalesce_us``, anchored at the oldest queued
  request and never more than half of any rider's remaining deadline; a
  request whose deadline is within four windows serves solo at once.
- **Double buffering**: after dispatching batch N's stage 1 the
  scheduler ``advance()``s batch N-1 (its stage-1 fetch and stage-2
  launch), so stage 2 of N-1 overlaps stage 1 of N on the device; the
  dispatch budget is paid once per batch.
- **Dedup**: items are ``(text, index generation)``; duplicates in a
  window share one slot, and the batch is the SORTED unique list, so a
  composition gives the same device batch whatever the arrival order.
- **Tier-0 cache**: a request whose every row is cached under ``(text,
  generation, k)`` resolves before admission with zero dispatches.
- **Shedding**: while a shed-enabled SLO fires, shed-class priorities
  (``serve.shed_priorities``) get an empty ``load_shed`` result.
- **Degradation stays per request**: a failed batch flags and counts
  ``retrieval_failed`` for each of its riders; the next batch is clean.

CUDA streams: the scheduler thread dispatches, and waiters fetch, on the
device's current stream, which no thread of the port changes, so every
launch and every copy of a batch is ordered on one stream;
``device.to_host`` waits on an event recorded there after the copy.

``SharedBatcher`` is the same engine for flat scoring calls
(``CrossEncoderModel.submit``).
"""

# pathway: serve-path  (hidden-sync lint applies: no implicit host round trips)
from __future__ import annotations

import contextlib
import inspect
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import config, observe
from ..cache import normalize_generation, query_key, result_cache_from_env
from ..observe import slo as slo_mod
from ..observe import trace
from ..robust import LOAD_SHED, RETRIEVAL_FAILED, Deadline, ServeResult, log_once, record_degraded

__all__ = ["ServeScheduler", "SharedBatcher", "coalesce_window_s", "max_batch_queries"]


def coalesce_window_s() -> float:
    """The coalescing window from ``serve.coalesce_us``."""
    return config.get("serve.coalesce_us") * 1e-6


def max_batch_queries() -> int:
    """The per-batch cap on UNIQUE items from ``serve.max_batch``."""
    return config.get("serve.max_batch")


_H_QUEUE_WAIT = observe.histogram("pathway_serve_queue_wait_seconds")
_C_SHED = {p: observe.counter("pathway_serve_shed_total", priority=p) for p in ("high", "normal", "low")}
_NOOP_CM = contextlib.nullcontext()


def _shed_classes() -> frozenset:
    raw = str(config.get("serve.shed_priorities"))
    return frozenset(p.strip().lower() for p in raw.split(",") if p.strip())


class _Request:
    """One admitted call, resolved by the scheduler with the shared batch
    and this request's slots in it."""

    __slots__ = ("items", "k", "deadline", "t_enqueue_ns", "event", "batch", "slots", "cache_store", "trace")

    def __init__(self, items: Sequence[Any], k: Optional[int], deadline):
        self.items = list(items)
        self.k = k
        self.deadline = deadline
        self.t_enqueue_ns = time.perf_counter_ns()
        self.event = threading.Event()
        self.batch: Optional["_Batch"] = None
        self.slots: List[int] = []
        self.cache_store = False  # capture clean rows into tier 0 at demux
        self.trace = None


class _Batch:
    """The future-handoff point: the scheduler thread created the handle
    (dispatch); the first waiter performs the fetch.  ``result()`` is
    idempotent and thread-safe."""

    __slots__ = ("_handle", "_n_items", "_n_requests", "_degrade_empty", "_lock", "_done", "_result", "_error", "_trace")

    def __init__(self, handle, n_items: int, n_requests: int, degrade_empty: bool, trace_ctx=None):
        self._handle = handle
        self._n_items = n_items
        self._n_requests = n_requests
        self._degrade_empty = degrade_empty
        self._lock = threading.Lock()
        self._done = False
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._trace = trace_ctx  # the BATCH trace, re-activated on other threads

    def advance(self) -> None:
        """Complete stage 1 and dispatch stage 2 without the final fetch;
        a failure surfaces once, at ``result()``."""
        adv = getattr(self._handle, "advance", None)
        if adv is None:
            return
        try:
            with trace.use(self._trace) if self._trace is not None else _NOOP_CM:
                adv()
        except Exception:  # noqa: BLE001 - deferred to result()
            pass

    def result(self) -> Any:
        with self._lock:
            if not self._done:
                try:
                    with trace.use(self._trace) if self._trace is not None else _NOOP_CM:
                        self._result = self._handle()
                except Exception as exc:  # noqa: BLE001 - every rider resolves
                    if self._degrade_empty:
                        log_once(
                            f"scheduler.batch:{type(exc).__name__}",
                            "coalesced serve batch failed (%r); serving empty degraded results to its riders",
                            exc,
                        )
                        record_degraded(RETRIEVAL_FAILED, self._n_requests)
                        self._result = ServeResult([[] for _ in range(self._n_items)], degraded=(RETRIEVAL_FAILED,))
                    else:
                        self._error = exc
                self._done = True
                if self._trace is not None:
                    flags = tuple(getattr(self._result, "degraded", ()) or ())
                    trace.finish(self._trace, statuses=flags + (("error",) if self._error else ()))
        if self._error is not None:
            raise self._error
        return self._result


class _Ticket:
    """Per-request future: ``result(timeout)`` waits for the batch
    hand-off, then the caller performs the (shared, idempotent) fetch and
    demuxes its own rows."""

    __slots__ = ("_owner", "_request")

    def __init__(self, owner: "_CoalescerBase", request: _Request):
        self._owner = owner
        self._request = request

    def result(self, timeout: Optional[float] = None):
        req = self._request
        if not req.event.wait(timeout):
            raise TimeoutError("serve ticket not dispatched within timeout")
        return self._owner._demux(req, req.batch.result())

    def __call__(self):
        return self.result()


class _CoalescerBase:
    """Admission queue + window + one scheduler thread + double-buffered
    dispatch.  Subclasses define ``_launch`` and ``_demux``."""

    _degrade_empty = False
    _metric_prefix = "pathway_serve_queue"

    def __init__(
        self,
        name: Optional[str] = None,
        window_us: Optional[float] = None,
        max_batch: Optional[int] = None,
        autostart: bool = True,
    ):
        self.name = name or f"serve-{observe.next_id()}"
        # window_us=None re-reads serve.coalesce_us per window
        self._window_pinned = window_us is not None
        self._window_s = coalesce_window_s() if window_us is None else max(0.0, window_us) * 1e-6
        self._max_batch = max_batch or max_batch_queries()
        self._qlock = threading.Lock()
        self._cond = threading.Condition(self._qlock)
        self._queue: Deque[_Request] = deque()
        self._queued_items = 0
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self.stats: Dict[str, int] = {
            "requests": 0,  # admitted through the queue
            "solo": 0,  # deadline-preempted (or stopped) direct serves
            "batches": 0,  # shared dispatches
            "items": 0,  # items admitted (pre-dedup)
            "items_dispatched": 0,  # unique items dispatched
            "dedup_hits": 0,  # duplicate items served from a shared slot
        }
        observe.register_provider(self)
        if autostart:
            self.start()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        with self._cond:
            if self._running:
                return
            self._running = True
        self._thread = threading.Thread(target=self._run, name=f"{self.name}-scheduler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the scheduler thread after draining the queue (every
        admitted ticket resolves); later submits serve solo."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        while True:  # stragglers that raced the shutdown
            reqs = self._pop_batch()
            if not reqs:
                break
            self._dispatch_batch(reqs)

    close = stop

    def __enter__(self) -> "_CoalescerBase":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- admission ----------------------------------------------------------
    def _admit(self, items: Sequence[Any], k: Optional[int], deadline, trace_ctx=None) -> _Ticket:
        req = _Request(items, k, deadline)
        req.trace = trace_ctx  # before the queue sees the request
        if trace_ctx is not None:
            trace_ctx.add_span("admission", trace_ctx.t0_ns, req.t_enqueue_ns, items=len(req.items))
        if not req.items:
            req.batch = _Batch(lambda: ServeResult(), 0, 1, self._degrade_empty)
            req.event.set()
            return _Ticket(self, req)
        solo = deadline is not None and deadline.remaining_s() <= 4.0 * self._window_s
        with self._cond:
            self.stats["items"] += len(req.items)
            if solo or not self._running:
                self.stats["solo"] += 1
            else:
                self.stats["requests"] += 1
                self._queue.append(req)
                self._queued_items += len(req.items)
                self._cond.notify_all()
                return _Ticket(self, req)
        self._dispatch_batch([req], solo=True)
        return _Ticket(self, req)

    # -- scheduler thread ---------------------------------------------------
    def _run(self) -> None:
        prev: Optional[_Batch] = None
        while True:
            reqs: Optional[List[_Request]] = None
            try:
                reqs = self._collect()
                if reqs is None:
                    return
                if reqs:
                    batch = self._dispatch_batch(reqs)
                    if prev is not None:
                        # batch N's stage 1 is queued: finishing N-1's
                        # stage 1 and launching its stage 2 overlaps them
                        prev.advance()
                    prev = batch
            except Exception as exc:  # noqa: BLE001 - the thread outlives any batch
                log_once(
                    f"scheduler.run:{type(exc).__name__}",
                    "serve scheduler iteration failed (%r); failing the affected batch and continuing",
                    exc,
                )
                for r in reqs or []:
                    if not r.event.is_set():
                        self._resolve_with_error(r, exc)

    def _resolve_with_error(self, req: _Request, exc: BaseException) -> None:
        def handle(_exc: BaseException = exc):
            raise _exc

        if len(req.slots) != len(req.items):
            req.slots = [-1] * len(req.items)
        req.batch = _Batch(handle, len(req.items), 1, self._degrade_empty)
        req.event.set()
        if req.trace is not None:
            trace.finish(req.trace, statuses=("error",))

    def _collect(self) -> Optional[List[_Request]]:
        """Wait for work, hold the window open (anchored at the oldest
        request, capped by each rider's deadline slack and the unique-item
        cap), pop one batch; None when stopped and drained."""
        with self._cond:
            while self._running and not self._queue:
                self._cond.wait(0.1)
            if not self._queue:
                return None
            anchor_ns = self._queue[0].t_enqueue_ns
            while self._running and self._queued_unique_locked() < self._max_batch:
                if not self._window_pinned:
                    self._window_s = coalesce_window_s()
                end_s = (anchor_ns - time.perf_counter_ns()) * 1e-9 + self._window_s
                for r in self._queue:
                    if r.deadline is not None:
                        end_s = min(end_s, 0.5 * r.deadline.remaining_s())
                if end_s <= 0:
                    break
                self._cond.wait(end_s)
            return self._pop_batch_locked()

    def _pop_batch(self) -> List[_Request]:
        with self._cond:
            return self._pop_batch_locked()

    def _queued_unique_locked(self) -> int:
        try:
            return len({it for r in self._queue for it in r.items})
        except TypeError:
            return self._queued_items  # unhashable items cannot dedup

    def _pop_batch_locked(self) -> List[_Request]:
        # the cap bounds UNIQUE items: duplicates keep riding a full batch
        take: List[_Request] = []
        seen: set = set()
        while self._queue:
            r = self._queue[0]
            try:
                fresh = sum(1 for it in r.items if it not in seen)
            except TypeError:
                fresh = len(r.items)
            if take and len(seen) + fresh > self._max_batch:
                break
            take.append(self._queue.popleft())
            self._queued_items -= len(r.items)
            try:
                seen.update(r.items)
            except TypeError:
                pass  # the request still dispatches; its launch fails it
        return take

    # -- dispatch -----------------------------------------------------------
    def _dispatch_batch(self, reqs: List[_Request], solo: bool = False) -> _Batch:
        """Pack one shared batch (sorted-unique items), launch it, and hand
        it to every rider; every ticket resolves whatever the launch does.
        ``batches`` counts shared-window dispatches only."""
        items: List[Any] = []
        total = sum(len(r.items) for r in reqs)
        bctx = None
        if any(r.trace is not None for r in reqs):
            bctx = trace.start_trace("serve.batch", deadline=self._batch_deadline(reqs), kind="batch", sample=False)
            if bctx is not None:
                bctx.annotate(scheduler=self.name, riders=len(reqs), solo=bool(solo))
        try:
            index: Dict[Any, int] = {}
            for r in reqs:
                for it in r.items:
                    if it not in index:
                        index[it] = -1
                        items.append(it)
            items.sort()
            for i, it in enumerate(items):
                index[it] = i
            for r in reqs:
                r.slots = [index[it] for it in r.items]
            if bctx is not None:
                bctx.annotate(items=len(items), deduped=total - len(items))
            with trace.use(bctx) if bctx is not None else _NOOP_CM:
                handle = self._launch(items, reqs)
        except Exception as exc:  # noqa: BLE001 - the error lands in _Batch.result()
            for r in reqs:
                if len(r.slots) != len(r.items):
                    r.slots = [-1] * len(r.items)

            def handle(_exc: BaseException = exc):
                raise _exc

        batch = _Batch(handle, len(items), len(reqs), self._degrade_empty, trace_ctx=bctx)
        with self._qlock:
            if not solo:
                self.stats["batches"] += 1
            self.stats["items_dispatched"] += len(items)
            self.stats["dedup_hits"] += total - len(items)
        t_now = time.perf_counter_ns()
        for r in reqs:
            _H_QUEUE_WAIT.observe_ns(t_now - r.t_enqueue_ns)
            if r.trace is not None:
                # the rider's link span: its duration is the queue wait
                link = {"linked_trace": bctx.trace_id, "batch_items": len(items)} if bctx is not None else {}
                if bctx is not None:
                    r.trace.add_link(bctx.trace_id)
                r.trace.add_span(
                    "batch", r.t_enqueue_ns, t_now, exemplar=_H_QUEUE_WAIT,
                    riders=len(reqs), solo=bool(solo), **link,
                )
            r.batch = batch
            r.event.set()
        return batch

    @staticmethod
    def _batch_deadline(reqs: List[_Request]):
        """The most generous rider's deadline (None if any has none)."""
        deadline = None
        for r in reqs:
            if r.deadline is None:
                return None
            if deadline is None or r.deadline.remaining_s() > deadline.remaining_s():
                deadline = r.deadline
        return deadline

    def _launch(self, items: List[Any], reqs: List[_Request]):
        raise NotImplementedError

    def _demux(self, req: _Request, batch_result):
        raise NotImplementedError

    def observe_metrics(self):
        labels = {"scheduler": self.name}
        yield ("gauge", f"{self._metric_prefix}_depth", labels, len(self._queue))
        for mode, key in (("coalesced", "requests"), ("solo", "solo")):
            yield ("counter", f"{self._metric_prefix}_requests_total", {**labels, "mode": mode}, self.stats[key])
        yield ("counter", f"{self._metric_prefix}_batches_total", labels, self.stats["batches"])
        for kind, key in (("admitted", "items"), ("dispatched", "items_dispatched"), ("deduped", "dedup_hits")):
            yield ("counter", f"{self._metric_prefix}_queries_total", {**labels, "kind": kind}, self.stats[key])


class _ReplicaHandle:
    """Completion wrapper that releases its replica's in-flight slot
    exactly once, whether the batch completes or fails."""

    __slots__ = ("_handle", "_release", "_released", "_rlock")

    def __init__(self, handle, release):
        self._handle = handle
        self._release = release
        self._released = False
        self._rlock = threading.Lock()

    def advance(self) -> None:
        adv = getattr(self._handle, "advance", None)
        if adv is not None:
            adv()

    def _release_once(self) -> None:
        with self._rlock:
            if self._released:
                return
            self._released = True
        self._release()

    def __call__(self):
        try:
            return self._handle()
        finally:
            self._release_once()


class ServeScheduler(_CoalescerBase):
    """Coalescing front for ``RetrieveRerankPipeline`` or
    ``FusedEncodeSearch`` (anything with ``submit(texts, k,
    deadline=...) -> completion``).  Concurrent ``serve()`` / ``submit()``
    calls share one stage-1 batch; per-request ``k`` truncates the shared
    top-``max(k)`` rows, and results carry the batch's flags.

    ``replicas`` adds data-parallel targets behind the one queue: each
    batch goes to the least-loaded replica (in-flight batches, ties
    rotated).  ``result_cache`` is a ``ResultCache``, ``"auto"`` (from the
    ``cache.*`` knobs) or None."""

    _degrade_empty = True

    def __init__(
        self,
        target,
        k: Optional[int] = None,
        name: Optional[str] = None,
        window_us: Optional[float] = None,
        max_batch: Optional[int] = None,
        autostart: bool = True,
        replicas: Optional[Sequence[Any]] = None,
        result_cache: Any = "auto",
    ):
        self.target = target
        self.k = k or getattr(target, "k", 10)
        self._result_cache = result_cache_from_env() if result_cache == "auto" else result_cache
        self._replicas: List[Any] = [target] + list(replicas or ())
        self._inflight: List[int] = [0] * len(self._replicas)
        self._placed: List[int] = [0] * len(self._replicas)
        gen_fn = getattr(target, "index_generation", None)
        self._generation = gen_fn if callable(gen_fn) else None
        try:
            params = inspect.signature(target.submit).parameters
        except (TypeError, ValueError):
            params = {}
        self._submit_n_requests = "n_requests" in params
        self._submit_deadline = "deadline" in params
        super().__init__(name=name, window_us=window_us, max_batch=max_batch, autostart=autostart)
        self.stats["cache_hits"] = 0

    def _resolved(self, items, k, deadline, ctx, result: ServeResult) -> _Ticket:
        """A ticket resolved at admission (shed or cache hit)."""
        req = _Request(items, k, deadline)
        req.trace = ctx
        req.slots = list(range(len(items)))
        req.batch = _Batch(lambda: result, len(items), 1, self._degrade_empty)
        req.event.set()
        return _Ticket(self, req)

    def submit(
        self,
        texts: Sequence[str],
        k: Optional[int] = None,
        deadline: Optional[Deadline] = None,
        priority: Optional[str] = None,
    ) -> _Ticket:
        """Admit one request; the ticket resolves to its ``ServeResult``.
        ``deadline`` defaults to the target's policy; ``priority``
        (high/normal/low, default ``serve.default_priority``) is the
        load-shedding class."""
        if deadline is None:
            deadline = getattr(self.target, "_default_deadline", Deadline.from_env)()
        priority = str(priority or config.get("serve.default_priority")).lower()
        if slo_mod.should_shed():
            if config.get("serve.shed") and priority in _shed_classes():
                c = _C_SHED.get(priority) or observe.counter("pathway_serve_shed_total", priority=priority)
                c.inc()
                record_degraded(LOAD_SHED, 1)
                with self._qlock:
                    self.stats["shed"] = self.stats.get("shed", 0) + 1
                ctx = trace.start_trace("serve.request", deadline=deadline)
                if ctx is not None:
                    ctx.annotate(priority=priority, shed=True)
                shed = ServeResult(
                    [[] for _ in texts], degraded=(LOAD_SHED,), meta={"priority": priority, "shed": True}
                )
                return self._resolved(list(texts), k or self.k, deadline, ctx, shed)
            log_once(
                "serve.slo_shed",
                "SLO burn-rate alert firing: should_shed() advises load shedding "
                "(advisory only: serve.shed off or priority not shed-class)",
            )
            slo_mod.record_shed_advised()
        ctx = trace.start_trace("serve.request", deadline=deadline)
        gen = 0
        if self._generation is not None:
            try:
                gen = normalize_generation(self._generation())
            except Exception:  # noqa: BLE001 - a generation probe never fails admission
                gen = 0
        # dedup item = (text, generation at admission); the same helper
        # derives the result-cache key, so the two never drift
        items = [query_key(t, gen) for t in texts]
        k_eff = k or self.k
        cache = self._result_cache
        if cache is not None and items:
            t_c0 = time.perf_counter_ns()
            with trace.use(ctx) if ctx is not None else _NOOP_CM:
                rows = cache.get_rows(items, k_eff, deadline=deadline)
            if ctx is not None:
                ctx.add_span(
                    "cache.result", t_c0, time.perf_counter_ns(),
                    status="hit" if rows is not None else "miss", items=len(items),
                )
            if rows is not None:
                with self._qlock:
                    self.stats["cache_hits"] += 1
                    self.stats["items"] += len(items)
                if ctx is not None:
                    ctx.annotate(cache="hit")
                return self._resolved(items, k_eff, deadline, ctx, ServeResult(rows))
        ticket = self._admit(items, k_eff, deadline, trace_ctx=ctx)
        ticket._request.cache_store = cache is not None
        return ticket

    def serve(
        self,
        texts: Sequence[str],
        k: Optional[int] = None,
        deadline: Optional[Deadline] = None,
        priority: Optional[str] = None,
    ) -> ServeResult:
        return self.submit(texts, k, deadline=deadline, priority=priority)()

    __call__ = serve

    def _pick_replica(self) -> int:
        """Least-loaded replica, ties rotated by lifetime placements."""
        with self._qlock:
            r = min(range(len(self._replicas)), key=lambda i: (self._inflight[i], self._placed[i], i))
            self._inflight[r] += 1
            self._placed[r] += 1
            return r

    def _release_replica(self, r: int) -> None:
        with self._qlock:
            self._inflight[r] = max(0, self._inflight[r] - 1)

    def _launch(self, items: List[Tuple[str, int]], reqs: List[_Request]):
        k_batch = max((r.k or self.k) for r in reqs)
        kwargs: Dict[str, Any] = {}
        if self._submit_deadline:
            kwargs["deadline"] = self._batch_deadline(reqs)
        if self._submit_n_requests:
            kwargs["n_requests"] = len(reqs)
        # items are sorted-unique (text, generation) pairs: the text list
        # the target sees is sorted
        texts = [t for t, _gen in items]
        r = self._pick_replica()
        try:
            handle = self._replicas[r].submit(texts, k_batch, **kwargs)
        except BaseException:
            self._release_replica(r)
            raise
        return _ReplicaHandle(handle, lambda: self._release_replica(r))

    def _demux(self, req: _Request, batch_result) -> ServeResult:
        k = req.k or self.k
        rows = [list(batch_result[slot][:k]) if 0 <= slot < len(batch_result) else [] for slot in req.slots]
        result = ServeResult(
            rows,
            degraded=tuple(getattr(batch_result, "degraded", ())),
            meta=getattr(batch_result, "meta", None),
        )
        cache = self._result_cache
        if cache is not None and req.cache_store and not result.degraded:
            # tier-0 capture on the waiter's thread: clean rows only, and
            # only when the dispatch-time generation matches admission
            meta_gen = result.meta.get("index_generation")
            with trace.use(req.trace) if req.trace is not None else _NOOP_CM:
                for (text, gen), row in zip(req.items, rows):
                    if meta_gen is None or normalize_generation(meta_gen) == normalize_generation(gen):
                        cache.put_row(text, gen, k, row, deadline=req.deadline)
        if req.trace is not None:
            req.trace.annotate(k=k)
            trace.finish(req.trace, statuses=tuple(result.degraded))
        return result

    def observe_metrics(self):
        yield from super().observe_metrics()
        labels = {"scheduler": self.name}
        if self._result_cache is not None:
            yield ("counter", "pathway_serve_queue_requests_total", {**labels, "mode": "cached"},
                   self.stats.get("cache_hits", 0))
        for r in range(len(self._replicas)):
            rl = {**labels, "replica": str(r)}
            yield ("gauge", "pathway_serve_replica_depth", rl, self._inflight[r])
            yield ("counter", "pathway_serve_replica_batches_total", rl, self._placed[r])


class SharedBatcher(_CoalescerBase):
    """The same engine for flat scoring calls: concurrent ``score(items)``
    calls coalesce into ONE ``submit_fn(items, deadline=...)`` dispatch
    (e.g. ``CrossEncoderModel.submit`` over (query, doc) pairs); per-call
    scores demux, deduplicated, from the shared result.  A batch failure
    re-raises to every rider."""

    _degrade_empty = False

    def __init__(
        self,
        submit_fn,
        name: Optional[str] = None,
        window_us: Optional[float] = None,
        max_batch: Optional[int] = None,
        autostart: bool = True,
    ):
        self._submit_fn = submit_fn
        try:
            params = inspect.signature(submit_fn).parameters
        except (TypeError, ValueError):
            params = {}
        self._submit_deadline = "deadline" in params
        super().__init__(
            name=name or f"batch-{observe.next_id()}", window_us=window_us, max_batch=max_batch, autostart=autostart
        )

    def submit(self, items: Sequence[Any], deadline: Optional[Deadline] = None) -> _Ticket:
        return self._admit(list(items), None, deadline)

    def score(self, items: Sequence[Any], deadline: Optional[Deadline] = None) -> np.ndarray:
        return self.submit(items, deadline=deadline)()

    __call__ = score

    def _launch(self, items: List[Any], reqs: List[_Request]):
        if self._submit_deadline:
            return self._submit_fn(items, deadline=self._batch_deadline(reqs))
        return self._submit_fn(items)

    def _demux(self, req: _Request, batch_result) -> np.ndarray:
        flat = np.asarray(batch_result)
        return np.asarray([flat[slot] for slot in req.slots], dtype=flat.dtype)
