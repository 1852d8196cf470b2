"""Retrieve -> rerank serving pipeline (counterpart of
``pathway_tpu/ops/retrieve_rerank.py``): stage 1 is ``FusedEncodeSearch``;
a cascade of pluggable ``RerankStage`` objects re-scores its candidates.

- ``LateInteractionStage``: MaxSim over a ``ForwardIndex`` against the
  query token states stage 1 exports on the device (one launch group,
  one packed fetch); candidates with no forward rows are backfilled after
  the MaxSim-ranked rows in previous-stage order and reported in
  ``meta["forward_missing"]``;
- ``CrossEncoderStage``: the packed cross-encoder stage 2 (the
  reference's ``_compiled_stage2``): (query, doc) pairs packed into
  rows, one packed forward, pair scores scattered into a ``[Q, Kc]``
  ``-inf`` table (pad segments dropped), per-query top-k by a stable
  descending sort (``jax.lax.top_k``'s tie order), one packed int32
  result.  Keys without text score against "" and are reported in
  ``meta["missing_docs"]``.  An HF cross-encoder takes no segments: its
  stage 2 (``_submit_stage2_host``) scores the pairs unpacked through the
  model's own ``submit`` and sorts each query's candidates on the host
  (a stable sort, so tied candidates keep their stage-1 order), still one
  dispatch and one fetch, booked as ``rerank_stage2_host``.

A MaxSim-only serve is 2 dispatches + 2 fetches
(``ops/dispatch_counter.py``).  A serve's deadline defaults to
``deadline_ms``, else ``serve.deadline_ms``; stage 1 gets
``stage1_fraction()`` of it.  The stage-2 launch retries under
``rerank.dispatch`` (one attempt around an HF model's submit, which
retries inside under ``cross_encoder.dispatch``), gated by the
cross-encoder's circuit breaker
(``breaker("cross_encoder")`` unless ``rerank_breaker`` is given), which
every cross-encoder failure feeds; an open breaker fails fast to the
``rerank_skipped`` rung.  A stage that raises (no forward rows, a spent
deadline, an open breaker, a failed launch) flags its rung and the serve
continues with the best ranking so far; stage 1 failing serves empty
rows flagged ``retrieval_failed``.  Nothing raises out of a serve handle.
Stage timings land on ``pathway_serve_stage_seconds{stage}`` and the
active trace (``stage.<name>``, ``stage2.pack_dispatch``, ``stage2.rtt``).
"""

# pathway: serve-path  (hidden-sync lint applies: no implicit host round trips)
from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import observe
from ..device import to_host, upload
from ..models.encoder import _bucket
from ..observe import profile, trace
from ..robust import (
    LATE_INTERACTION_SKIPPED,
    RERANK_SKIPPED,
    RETRIEVAL_FAILED,
    CircuitBreaker,
    CircuitOpen,
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    ServeResult,
    inject,
    log_once,
    record_degraded,
    retry_call,
    stage1_fraction,
)
from ..robust import breaker as robust_breaker
from .dispatch_counter import record_dispatch, record_fetch
from .maxsim import pack_topk
from .recompile_guard import RecompileTripwire

__all__ = [
    "CrossEncoderStage",
    "LateInteractionStage",
    "RerankStage",
    "RetrieveRerankPipeline",
]

# the stage-2 launch retries briefly: its backoff delays the serve it
# belongs to and the next batch's stage 2
_STAGE2_RETRY = RetryPolicy(attempts=3, base_delay_s=0.002, max_delay_s=0.02)
# the HF host path wraps CrossEncoderModel.submit, whose own launch
# retries under "cross_encoder.dispatch": one outer attempt keeps the
# breaker gate and the fault site without multiplying the attempts
_OUTER_RETRY = RetryPolicy(attempts=1)

_H_S2PACK = observe.histogram("pathway_serve_stage_seconds", stage="stage2_pack")
_H_S2RTT = observe.histogram("pathway_serve_stage_seconds", stage="stage2_rtt")
_H_POST = observe.histogram("pathway_serve_stage_seconds", stage="postprocess")


class RerankStage:
    """One rung of the ranking cascade: ``name``, the ladder ``rung``
    flagged when it is skipped, ``over_fetch`` sizing its input pool as
    a factor of k (an explicit ``candidates`` count overrides it) and
    ``budget_fraction``, the share of the remaining deadline it may
    spend (None: whatever remains).  ``submit(pipeline, queries,
    cand_rows, keep, deadline, query_tokens, query_mask, pool_width)``
    returns a completion giving ``(rows, meta)``; a failure at submit or
    completion must raise."""

    name = "rerank"
    rung = RERANK_SKIPPED
    over_fetch: float = 4.0
    budget_fraction: Optional[float] = None
    needs_query_tokens = False

    def __init__(
        self,
        candidates: Optional[int] = None,
        over_fetch: Optional[float] = None,
        budget_fraction: Optional[float] = None,
    ):
        self.candidates = candidates
        if over_fetch is not None:
            self.over_fetch = float(over_fetch)
        if budget_fraction is not None:
            self.budget_fraction = float(budget_fraction)

    def width(self, k: int) -> int:
        """Input candidate-pool width for final top-``k`` serving."""
        if self.candidates is not None:
            return max(int(self.candidates), 1)
        return max(int(math.ceil(self.over_fetch * k)), k, 1)

    def sub_deadline(self, deadline: Optional[Deadline]) -> Optional[Deadline]:
        """This stage's share of ``deadline``, never later than it."""
        if deadline is not None and self.budget_fraction is not None:
            return deadline.sub_budget(self.budget_fraction)
        return deadline

    def submit(
        self, pipeline, queries, cand_rows, keep, deadline,
        query_tokens=None, query_mask=None, pool_width=None,
    ):
        raise NotImplementedError

    def note_failure(self, pipeline, exc: BaseException) -> None:
        """Failure bookkeeping beyond the ladder (a deadline or an open
        breaker is not a failure and never reaches here)."""


class CrossEncoderStage(RerankStage):
    """The packed cross-encoder rescore, sized to this stage's pool
    width (a cascade tail over the top few pays only its own table);
    its failures feed the pipeline's circuit breaker."""

    name = "cross_encoder"
    rung = RERANK_SKIPPED

    def submit(
        self, pipeline, queries, cand_rows, keep, deadline,
        query_tokens=None, query_mask=None, pool_width=None,
    ):
        cand_keys = [[key for key, _ in row] for row in cand_rows]
        return pipeline._submit_stage2(queries, cand_keys, keep, deadline=deadline, pool=pool_width)

    def note_failure(self, pipeline, exc: BaseException) -> None:
        pipeline._breaker.record_failure()


class LateInteractionStage(RerankStage):
    """MaxSim over a device-resident ``ForwardIndex``, scored against the
    stage-1 query token states."""

    name = "late_interaction"
    rung = LATE_INTERACTION_SKIPPED
    needs_query_tokens = True

    def __init__(
        self,
        forward_index,
        candidates: Optional[int] = None,
        over_fetch: Optional[float] = None,
        budget_fraction: Optional[float] = None,
    ):
        super().__init__(candidates=candidates, over_fetch=over_fetch, budget_fraction=budget_fraction)
        self.forward = forward_index

    def submit(
        self, pipeline, queries, cand_rows, keep, deadline,
        query_tokens=None, query_mask=None, pool_width=None,
    ):
        done, missing = self.forward.gather_submit(
            query_tokens,
            query_mask,
            [[key for key, _ in row] for row in cand_rows],
            keep,
            deadline=deadline,
            width=pool_width,
        )

        def complete():
            scores, perm = done()
            results: List[List[Tuple[int, float]]] = []
            missing_keys: List[int] = []
            for qi, row in enumerate(cand_rows):
                ranked: List[Tuple[int, float]] = []
                for j in range(perm.shape[1]):
                    s = float(scores[qi, j])
                    ci = int(perm[qi, j])
                    if not np.isfinite(s) or ci >= len(row):
                        continue
                    ranked.append((row[ci][0], s))
                # candidates with no forward rows backfill after the
                # MaxSim-ranked rows, in previous-stage order and score
                for j in missing[qi]:
                    if j < len(row):
                        missing_keys.append(row[j][0])
                        if len(ranked) < keep:
                            ranked.append(row[j])
                results.append(ranked[:keep])
            meta = {"forward_missing": tuple(missing_keys)} if missing_keys else None
            return results, meta

        return complete


class _PendingServe:
    """In-flight serve handle: ``advance()`` completes stage 1 and submits
    the rerank chain without waiting on it; calling the handle finishes
    the serve.  Both are idempotent under a per-handle lock.  Stage-1
    rows already on the host are never discarded for a rerank problem;
    stage 1 failing serves empty rows flagged ``retrieval_failed``.
    ``n_requests`` is how many scheduler riders share this serve: the
    ladder counters count each of them."""

    __slots__ = (
        "_pipeline", "_stage1", "_queries", "_k", "_stage2", "_result",
        "_done", "_hlock", "_deadline", "_stage1_rows", "_n_requests",
    )

    def __init__(self, pipeline, stage1, queries, k, deadline=None, n_requests: int = 1) -> None:
        self._pipeline = pipeline
        self._stage1 = stage1
        self._queries = queries
        self._k = k
        self._stage2: Any = None
        self._result: Any = None
        self._done = False
        self._hlock = threading.Lock()
        self._deadline: Optional[Deadline] = deadline
        self._stage1_rows: Any = None
        self._n_requests = max(1, int(n_requests))

    def advance(self) -> None:
        with self._hlock:
            self._advance_locked()

    def _advance_locked(self) -> None:
        if self._stage2 is not None:
            return
        try:
            hits = self._stage1()  # host fetch 1: the stage-1 packed result
        except Exception as exc:  # noqa: BLE001 - the ladder's bottom rung
            if not isinstance(exc, DeadlineExceeded):
                log_once(
                    f"stage1:{type(exc).__name__}",
                    "stage-1 retrieval failed (%r); serving empty degraded rows", exc,
                )
            record_degraded(RETRIEVAL_FAILED, self._n_requests)
            empty = ServeResult([[] for _ in self._queries], degraded=(RETRIEVAL_FAILED,))
            self._stage2 = lambda: empty
            return
        self._stage1_rows = hits
        try:
            if self._deadline is not None:
                self._deadline.check("stage2_submit")
            self._stage2 = self._pipeline._submit_chain(
                self._queries, hits, self._k,
                deadline=self._deadline,
                query_tokens=getattr(self._stage1, "query_tokens", None),
                query_mask=getattr(self._stage1, "query_mask", None),
                n_requests=self._n_requests,
            )
        except Exception as exc:  # noqa: BLE001 - degrade, never die
            if not isinstance(exc, DeadlineExceeded):
                log_once(f"stage2:{type(exc).__name__}", "rerank submit failed (%r); serving stage-1 rows", exc)
            self._stage2 = self._stage1_fallback_fn()

    def _stage1_fallback_fn(self):
        """The stage-1 ranking cut to ``k``, flagged with the FIRST rerank
        stage's rung (stage 1's own flags carried over)."""
        hits = self._stage1_rows
        if hits is None:
            hits = [[] for _ in self._queries]
        rung = self._pipeline.stages[0].rung
        result = ServeResult(
            [list(row[: self._k]) for row in hits],
            degraded=tuple(getattr(hits, "degraded", ())) + (rung,),
        )
        record_degraded(rung, self._n_requests)
        return lambda: result

    def __call__(self) -> List[List[Tuple[int, float]]]:
        with self._hlock:
            if not self._done:
                self._advance_locked()
                try:
                    self._result = self._stage2()
                except Exception as exc:  # noqa: BLE001 - last-resort net
                    if not isinstance(exc, DeadlineExceeded):
                        log_once(
                            f"stage2_fetch:{type(exc).__name__}",
                            "rerank completion failed (%r); serving stage-1 rows", exc,
                        )
                    self._result = self._stage1_fallback_fn()()
                self._done = True
            return self._result


class RetrieveRerankPipeline:
    """Chain ``FusedEncodeSearch`` (stage 1) with a rerank cascade.

    ``doc_text`` maps a stage-1 key to its document text (dict or
    callable).  Explicit ``stages`` win; else a ``forward_index`` builds
    the MaxSim stage over ``candidates`` (default ``max(4k, 16)``), with
    a cross-encoder tail over the top ``cascade`` rows when ``cascade``
    is set; else one cross-encoder stage.  ``deadline_ms`` bounds each
    serve (<= 0: no deadline; None: the ``serve.deadline_ms`` knob).
    ``rerank_breaker`` gates the cross-encoder (default: the shared
    ``breaker("cross_encoder")``)."""

    def __init__(
        self,
        retriever,
        cross_encoder=None,
        doc_text: Union[Mapping[int, str], Callable[[int], str], None] = None,
        k: int = 10,
        candidates: Optional[int] = None,
        deadline_ms: Optional[float] = None,
        rerank_breaker: Optional[CircuitBreaker] = None,
        forward_index=None,
        cascade: Optional[int] = None,
        stages: Optional[Sequence[RerankStage]] = None,
    ):
        self.retriever = retriever
        self.cross_encoder = cross_encoder
        self.doc_text = doc_text
        self.k = k
        self.deadline_ms = deadline_ms
        self._breaker = rerank_breaker or robust_breaker("cross_encoder")
        width = candidates or max(4 * k, 16)
        if stages is not None:
            self.stages: List[RerankStage] = list(stages)
        elif forward_index is not None:
            self.stages = [LateInteractionStage(forward_index, candidates=width)]
            if cascade:
                self.stages.append(CrossEncoderStage(candidates=max(int(cascade), k)))
        else:
            self.stages = [CrossEncoderStage(candidates=width)]
        if not self.stages:
            raise ValueError("RetrieveRerankPipeline needs at least one stage")
        if any(isinstance(s, CrossEncoderStage) for s in self.stages) and (
            cross_encoder is None or doc_text is None
        ):
            raise ValueError("a CrossEncoderStage needs cross_encoder= and doc_text=")
        # stage-1 over-fetch = the first rerank stage's candidate pool
        self.candidates = self.stages[0].width(k)
        if any(s.needs_query_tokens for s in self.stages):
            retriever.export_query_tokens = True
            exporting = getattr(retriever, "_exporting", None)
            if exporting is None or not exporting():
                raise ValueError(
                    "a late-interaction stage needs query token states, but this "
                    "retriever cannot export them (needs FusedEncodeSearch over a "
                    "mean-pooling TransformerEncoder trunk)"
                )
        self._lock = threading.Lock()
        self._tripwire = RecompileTripwire("RetrieveRerankPipeline.stage2")
        self.stats = {"serves": 0, "stage2_pairs": 0, "stage2_rows": 0}

    def _default_deadline(self) -> Optional[Deadline]:
        """``deadline_ms`` when given (<= 0: none), else the
        ``serve.deadline_ms`` knob."""
        if self.deadline_ms is not None:
            return Deadline.after_ms(self.deadline_ms) if self.deadline_ms > 0 else None
        return Deadline.from_env()

    def index_generation(self) -> int:
        gen_fn = getattr(self.retriever, "index_generation", None)
        if callable(gen_fn):
            return int(gen_fn())
        return int(getattr(getattr(self.retriever, "index", None), "generation", 0))

    # -- the stage chain ----------------------------------------------------
    def _submit_chain(
        self,
        queries: Sequence[str],
        hits,
        k: int,
        deadline: Optional[Deadline] = None,
        query_tokens=None,
        query_mask=None,
        n_requests: int = 1,
    ):
        """Submit the first stage now (it overlaps the next serve's stage
        1) and return a completion that walks the rest of the cascade.
        Each stage rescores the best ranking so far, cut to its width; a
        stage that fails flags its rung once (counted for each of the
        ``n_requests`` riders) and the chain goes on from the previous
        ranking.  The result carries stage 1's flags, every skipped rung
        and the merged stage metadata."""
        stages = self.stages
        flags: List[str] = list(getattr(hits, "degraded", ()))
        meta: Dict[str, Any] = dict(getattr(hits, "meta", {}) or {})
        meta.pop("degraded_reasons", None)  # regenerated from the final flags
        rows: List[List[Tuple[int, float]]] = [list(r) for r in hits]
        # how many rows stage i emits: the next stage's pool, or k
        keeps = [stages[i + 1].width(k) if i + 1 < len(stages) else k for i in range(len(stages))]
        # per-stage trace bookkeeping: submit time and the budget left then
        t_stage = [0] * len(stages)
        budget_ms: List[Optional[float]] = [None] * len(stages)

        def stage_span(i: int, status: str, **attrs) -> None:
            t = trace.current()
            if t is not None:
                t_end = time.perf_counter_ns()
                t.add_span(
                    "stage." + stages[i].name, t_stage[i] or t_end, t_end, status=status,
                    budget_ms=budget_ms[i], keep=keeps[i], **attrs,
                )

        def skip(i: int, exc: BaseException) -> None:
            stage = stages[i]
            if not isinstance(exc, (DeadlineExceeded, CircuitOpen)):
                stage.note_failure(self, exc)
                log_once(
                    f"stage:{stage.name}:{type(exc).__name__}",
                    "rerank stage %s failed (%r); flagged %s", stage.name, exc, stage.rung,
                )
            stage_span(i, stage.rung, error=type(exc).__name__)
            if stage.rung not in flags:
                flags.append(stage.rung)
                record_degraded(stage.rung, n_requests)

        def try_submit(i: int, cur_rows):
            stage = stages[i]
            if not any(cur_rows):
                return None  # nothing to rerank (empty retrieval): no rung
            if deadline is not None:
                deadline.check(f"{stage.name}_submit")
            width = stage.width(k)
            t_stage[i] = time.perf_counter_ns()
            sub = stage.sub_deadline(deadline)
            if sub is not None and trace.current() is not None:
                budget_ms[i] = round(sub.remaining_s() * 1e3, 3)
            return stage.submit(
                self, queries, [r[:width] for r in cur_rows], keeps[i], sub,
                query_tokens=query_tokens, query_mask=query_mask, pool_width=width,
            )

        pending = None
        try:
            pending = try_submit(0, rows)
        except Exception as exc:  # noqa: BLE001 - a stage failure is a rung
            skip(0, exc)

        def complete() -> ServeResult:
            nonlocal rows
            cur = pending
            for i in range(len(stages)):
                if i > 0:
                    cur = None
                    try:
                        cur = try_submit(i, rows)
                    except Exception as exc:  # noqa: BLE001
                        skip(i, exc)
                if cur is None:
                    continue
                try:
                    new_rows, stage_meta = cur()
                    rows = [list(r) for r in new_rows]
                    if stage_meta:
                        meta.update(stage_meta)
                    stage_span(i, "ok")
                except Exception as exc:  # noqa: BLE001
                    skip(i, exc)
            return ServeResult([list(r[:k]) for r in rows], degraded=flags, meta=meta or None)

        return complete

    # -- cross-encoder stage 2 ----------------------------------------------
    def _text_of(self, key: int, missing: Optional[List[int]] = None) -> str:
        """Text of a stage-1 winner; a key with no text (LookupError or
        absent) scores against "" and is reported in ``missing``."""
        src = self.doc_text
        try:
            if callable(src):
                text = src(key)
            else:
                if key not in src:
                    raise LookupError(key)
                text = src[key]
        except LookupError:
            if missing is not None:
                missing.append(key)
            return ""
        return str(text or "")

    def _compiled_stage2(self, R: int, L: int, S: int, Q: int, Kc: int, k_out: int):
        """The stage-2 step as one function of the packed rows: packed
        cross-encoder forward -> pair scores scattered into the ``[Q,
        Kc]`` ``-inf`` table (``pair_slot[r * S + s] = q * Kc + j`` for a
        real pair, ``Q * Kc`` for a pad segment: a dump cell cut off
        after the scatter) -> per-query top ``k_out`` -> ``[Q, 2 *
        k_out]`` int32 (score bits, then candidate indices).  The shape
        key goes through the ``RetrieveRerankPipeline.stage2`` tripwire
        and the step is attributed as ``rerank.stage2``."""
        self._tripwire.observe((R, L, S, Q, k_out, Kc))
        ce = self.cross_encoder

        def fused(ids, segments, positions, pair_slot):
            flat = ce.packed_forward(ids, segments, positions, S).reshape(-1).float()
            table = torch.full((Q * Kc + 1,), float("-inf"), device=flat.device)
            table.scatter_(0, pair_slot, flat)
            return pack_topk(table[: Q * Kc].view(Q, Kc), k_out)

        return profile.wrap("rerank.stage2", fused)

    @torch.no_grad()
    def _submit_stage2(
        self,
        queries: Sequence[str],
        cand_keys: List[List[int]],
        k: int,
        deadline: Optional[Deadline] = None,
        pool: Optional[int] = None,
    ):
        """Pack the (query, candidate) pairs and launch the stage-2 step
        (retried under ``rerank.dispatch``, gated by the breaker);
        returns a completion -> ``(rows, meta)`` with ``missing_docs`` in
        ``meta`` when a key had no text.  ``pool`` is the calling stage's
        candidate width."""
        t_pack = time.perf_counter_ns()
        ce = self.cross_encoder
        Kc = pool or self.candidates
        k_out = min(k, Kc)
        nq = len(queries)
        pairs: List[Tuple[str, str]] = []
        slot_ids: List[int] = []
        missing: List[int] = []
        for qi, row in enumerate(cand_keys):
            for j, key in enumerate(row[:Kc]):
                pairs.append((queries[qi], self._text_of(key, missing)))
                slot_ids.append(qi * Kc + j)
        meta = {"missing_docs": tuple(missing)} if missing else None
        if not pairs:
            return lambda: ([[] for _ in range(nq)], meta)
        if getattr(ce, "_hf", False):
            return self._submit_stage2_host(queries, cand_keys, pairs, k_out, Kc, deadline, meta)
        Qb = _bucket(nq)
        ids, segments, positions, S, flat_ix = ce.packed_inputs(pairs)
        Rb = ids.shape[0]
        pair_slot = np.full(Rb * S, Qb * Kc, np.int64)  # pad segments: the dump cell
        pair_slot[flat_ix] = slot_ids
        fn = self._compiled_stage2(Rb, ids.shape[1], S, Qb, Kc, k_out)
        pair_slot_dev = upload(pair_slot, ce.device)
        fetch = retry_call(
            "rerank.dispatch",
            lambda: to_host(fn(ids, segments, positions, pair_slot_dev)),
            deadline=deadline,
            policy=_STAGE2_RETRY,
            breaker=self._breaker,
        )
        record_dispatch("rerank_stage2")
        with self._lock:
            self.stats["stage2_pairs"] += len(pairs)
            self.stats["stage2_rows"] += Rb
        t_dispatch = time.perf_counter_ns()
        _H_S2PACK.observe_ns(t_dispatch - t_pack)
        observe.record_occupancy("stage2_pairs", len(pairs), Rb * S)
        t = trace.current()
        if t is not None:
            t.add_span("stage2.pack_dispatch", t_pack, t_dispatch, exemplar=_H_S2PACK, pairs=len(pairs), rows=Rb)

        def complete():
            inject.fire("cross_encoder.fetch", deadline=deadline)
            if deadline is not None:
                deadline.check("cross_encoder.fetch")
            arr = fetch()[:nq]
            record_fetch("rerank_stage2")
            t_fetch = time.perf_counter_ns()
            _H_S2RTT.observe_ns(t_fetch - t_dispatch)
            ct = trace.current()
            if ct is not None:
                ct.add_span("stage2.rtt", t_dispatch, t_fetch, exemplar=_H_S2RTT)
            scores = np.ascontiguousarray(arr[:, :k_out]).view(np.float32)
            perm = arr[:, k_out:]
            results: List[List[Tuple[int, float]]] = []
            for qi in range(nq):
                cands = cand_keys[qi]
                row = [
                    (cands[int(perm[qi, j])], float(scores[qi, j]))
                    for j in range(k_out)
                    if np.isfinite(scores[qi, j]) and int(perm[qi, j]) < len(cands)
                ]
                results.append(row[:k])
            t_done = time.perf_counter_ns()
            _H_POST.observe_ns(t_done - t_fetch)
            observe.record_event("serve", "rerank_stage2", t_done - t_pack, queries=nq, pairs=len(pairs), rows=Rb)
            observe.emit_span(
                "pathway.serve.rerank_stage2",
                queries=nq, pairs=len(pairs),
                pack_ms=(t_dispatch - t_pack) * 1e-6,
                rtt_ms=(t_fetch - t_dispatch) * 1e-6,
                postprocess_ms=(t_done - t_fetch) * 1e-6,
            )
            return results, meta

        return complete

    def _submit_stage2_host(self, queries, cand_keys, pairs, k_out: int, width: int, deadline, meta):
        """Stage 2 of an HF cross-encoder: one unpacked scoring launch
        (the model's ``submit``, retried under ``rerank.dispatch`` once,
        gated by the breaker), then each query's first ``width``
        candidates sorted by descending score on the host, cut to
        ``k_out``.  Returns a completion -> ``(rows, meta)``."""
        t_pack = time.perf_counter_ns()
        # the deadline goes to the model's submit through the lambda, so
        # its inner retries and its completion check are bounded by it
        score_done = retry_call(
            "rerank.dispatch",
            lambda: self.cross_encoder.submit(pairs, packed=False, deadline=deadline),
            deadline=deadline,
            policy=_OUTER_RETRY,
            breaker=self._breaker,
        )
        record_dispatch("rerank_stage2_host")
        rows = _bucket(len(pairs))  # one row per pair
        with self._lock:
            self.stats["stage2_pairs"] += len(pairs)
            self.stats["stage2_rows"] += rows
        t_dispatch = time.perf_counter_ns()
        _H_S2PACK.observe_ns(t_dispatch - t_pack)
        observe.record_occupancy("stage2", len(pairs), rows)

        def complete():
            inject.fire("cross_encoder.fetch", deadline=deadline)
            if deadline is not None:
                deadline.check("cross_encoder.fetch")
            flat = score_done()
            record_fetch("rerank_stage2_host")
            t_fetch = time.perf_counter_ns()
            _H_S2RTT.observe_ns(t_fetch - t_dispatch)
            ct = trace.current()
            if ct is not None:
                ct.add_span("stage2.rtt", t_dispatch, t_fetch, exemplar=_H_S2RTT, host=True)
            results: List[List[Tuple[int, float]]] = []
            pos = 0
            for qi in range(len(queries)):
                n_c = min(len(cand_keys[qi]), width)
                scored = list(zip(cand_keys[qi][:n_c], flat[pos : pos + n_c].tolist()))
                pos += n_c
                scored.sort(key=lambda kv: -kv[1])  # stable: ties keep stage-1 order
                results.append(scored[:k_out])
            t_done = time.perf_counter_ns()
            _H_POST.observe_ns(t_done - t_fetch)
            observe.record_event(
                "serve", "rerank_stage2_host", t_done - t_pack, queries=len(queries), pairs=len(pairs)
            )
            return results, meta

        return complete

    # -- serve --------------------------------------------------------------
    def submit(
        self,
        queries: Sequence[str],
        k: Optional[int] = None,
        deadline: Optional[Deadline] = None,
        n_requests: int = 1,
    ):
        """Launch stage 1 WITHOUT waiting; returns the serve handle
        (``advance()`` completes stage 1 and submits the cascade;
        calling it finishes the serve).  ``deadline`` defaults to
        ``_default_deadline()``; ``n_requests`` is the number of
        scheduler riders sharing this serve."""
        k = k or self.k
        queries = list(queries)
        if deadline is None:
            deadline = self._default_deadline()
        if not queries:
            done = _PendingServe(self, lambda: ServeResult(), [], k)
            done._stage2 = lambda: ServeResult()
            return done
        stage1_deadline = deadline.sub_budget(stage1_fraction()) if deadline else None
        try:
            # the kwarg only with a deadline: duck-typed retrievers with a
            # plain submit(texts, k) keep working without one
            if stage1_deadline is not None:
                stage1 = self.retriever.submit(queries, self.candidates, deadline=stage1_deadline)
            else:
                stage1 = self.retriever.submit(queries, self.candidates)
        except TypeError:
            raise  # a signature mismatch is a bug, not an outage
        except Exception as exc:  # noqa: BLE001 - re-raised at advance()

            def stage1(_exc: Exception = exc):
                raise _exc

        with self._lock:
            self.stats["serves"] += 1
        return _PendingServe(self, stage1, queries, k, deadline=deadline, n_requests=n_requests)

    def __call__(
        self, queries: Sequence[str], k: Optional[int] = None, deadline: Optional[Deadline] = None
    ) -> List[List[Tuple[int, float]]]:
        return self.submit(queries, k, deadline=deadline)()
