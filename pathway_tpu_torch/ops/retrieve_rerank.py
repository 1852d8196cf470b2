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
  ``meta["missing_docs"]``.

A MaxSim-only serve is 2 dispatches + 2 fetches
(``ops/dispatch_counter.py``).  A stage that raises (no forward rows, a
spent deadline, a failed launch) flags its rung and the serve continues
with the best ranking so far; stage 1 failing serves empty rows flagged
``retrieval_failed``.  Nothing raises out of a serve handle.  Retry,
circuit breakers and fault injection are not ported yet:
``note_failure`` only counts.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import to_host, upload
from ..models.encoder import _bucket
from ..robust import (
    LATE_INTERACTION_SKIPPED,
    RERANK_SKIPPED,
    RETRIEVAL_FAILED,
    STAGE1_FRACTION,
    Deadline,
    DeadlineExceeded,
    ServeResult,
    record_degraded,
)
from .dispatch_counter import record_dispatch, record_fetch
from .maxsim import pack_topk

__all__ = [
    "CrossEncoderStage",
    "LateInteractionStage",
    "RerankStage",
    "RetrieveRerankPipeline",
]

_log = logging.getLogger(__name__)

# a stage's candidate pool per final result when it names no count
OVER_FETCH = 4


class RerankStage:
    """One rung of the ranking cascade: ``name``, the ladder ``rung``
    flagged when it is skipped, and ``candidates`` sizing its input pool
    (``OVER_FETCH`` x k when unset).  ``submit(pipeline, queries,
    cand_rows, keep, deadline, query_tokens, query_mask, pool_width)``
    returns a completion giving ``(rows, meta)``; a failure at submit or
    completion must raise."""

    name = "rerank"
    rung = RERANK_SKIPPED
    needs_query_tokens = False

    def __init__(self, candidates: Optional[int] = None):
        self.candidates = candidates

    def width(self, k: int) -> int:
        """Input candidate-pool width for final top-``k`` serving."""
        if self.candidates is not None:
            return max(int(self.candidates), 1)
        return max(OVER_FETCH * k, 1)

    def submit(
        self, pipeline, queries, cand_rows, keep, deadline,
        query_tokens=None, query_mask=None, pool_width=None,
    ):
        raise NotImplementedError

    def note_failure(self, pipeline, exc: BaseException) -> None:
        """Failure bookkeeping beyond the ladder (a deadline is not a
        failure and never reaches here)."""


class CrossEncoderStage(RerankStage):
    """The packed cross-encoder rescore, sized to this stage's pool
    width (a cascade tail over the top few pays only its own table)."""

    name = "cross_encoder"
    rung = RERANK_SKIPPED

    def submit(
        self, pipeline, queries, cand_rows, keep, deadline,
        query_tokens=None, query_mask=None, pool_width=None,
    ):
        cand_keys = [[key for key, _ in row] for row in cand_rows]
        return pipeline._submit_stage2(queries, cand_keys, keep, deadline=deadline, pool=pool_width)

    def note_failure(self, pipeline, exc: BaseException) -> None:
        with pipeline._lock:
            pipeline.stats["rerank_failures"] += 1


class LateInteractionStage(RerankStage):
    """MaxSim over a device-resident ``ForwardIndex``, scored against the
    stage-1 query token states."""

    name = "late_interaction"
    rung = LATE_INTERACTION_SKIPPED
    needs_query_tokens = True

    def __init__(self, forward_index, candidates: Optional[int] = None):
        super().__init__(candidates=candidates)
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
    stage 1 failing serves empty rows flagged ``retrieval_failed``."""

    __slots__ = (
        "_pipeline", "_stage1", "_queries", "_k", "_stage2", "_result",
        "_done", "_hlock", "_deadline", "_stage1_rows",
    )

    def __init__(self, pipeline, stage1, queries, k, deadline=None) -> None:
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
                _log.warning("stage-1 retrieval failed (%r); serving empty degraded rows", exc)
            record_degraded(RETRIEVAL_FAILED)
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
            )
        except Exception as exc:  # noqa: BLE001 - degrade, never die
            if not isinstance(exc, DeadlineExceeded):
                _log.warning("rerank submit failed (%r); serving stage-1 rows", exc)
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
        record_degraded(rung)
        return lambda: result

    def __call__(self) -> List[List[Tuple[int, float]]]:
        with self._hlock:
            if not self._done:
                self._advance_locked()
                try:
                    self._result = self._stage2()
                except Exception as exc:  # noqa: BLE001 - last-resort net
                    if not isinstance(exc, DeadlineExceeded):
                        _log.warning("rerank completion failed (%r); serving stage-1 rows", exc)
                    self._result = self._stage1_fallback_fn()()
                self._done = True
            return self._result


class RetrieveRerankPipeline:
    """Chain ``FusedEncodeSearch`` (stage 1) with a rerank cascade.

    ``doc_text`` maps a stage-1 key to its document text (dict or
    callable).  Explicit ``stages`` win; else a ``forward_index`` builds
    the MaxSim stage over ``candidates`` (default ``max(4k, 16)``), with
    a cross-encoder tail over the top ``cascade`` rows when ``cascade``
    is set; else one cross-encoder stage.  ``deadline_ms`` (None or <= 0:
    no deadline) bounds each serve: stage 1 gets ``STAGE1_FRACTION`` of
    it, the cascade what remains."""

    def __init__(
        self,
        retriever,
        cross_encoder=None,
        doc_text: Union[Mapping[int, str], Callable[[int], str], None] = None,
        k: int = 10,
        candidates: Optional[int] = None,
        deadline_ms: Optional[float] = None,
        forward_index=None,
        cascade: Optional[int] = None,
        stages: Optional[Sequence[RerankStage]] = None,
    ):
        self.retriever = retriever
        self.cross_encoder = cross_encoder
        self.doc_text = doc_text
        self.k = k
        self.deadline_ms = deadline_ms
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
        self.stats = {"rerank_failures": 0}

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
    ):
        """Submit the first stage now (it overlaps the next serve's stage
        1) and return a completion that walks the rest of the cascade.
        Each stage rescores the best ranking so far, cut to its width; a
        stage that fails flags its rung once and the chain goes on from
        the previous ranking.  The result carries stage 1's flags, every
        skipped rung and the merged stage metadata."""
        stages = self.stages
        flags: List[str] = list(getattr(hits, "degraded", ()))
        meta: Dict[str, Any] = dict(getattr(hits, "meta", {}) or {})
        meta.pop("degraded_reasons", None)  # regenerated from the final flags
        rows: List[List[Tuple[int, float]]] = [list(r) for r in hits]
        # how many rows stage i emits: the next stage's pool, or k
        keeps = [stages[i + 1].width(k) if i + 1 < len(stages) else k for i in range(len(stages))]

        def skip(stage: RerankStage, exc: BaseException) -> None:
            if not isinstance(exc, DeadlineExceeded):
                stage.note_failure(self, exc)
                _log.warning("rerank stage %s failed (%r); flagged %s", stage.name, exc, stage.rung)
            if stage.rung not in flags:
                flags.append(stage.rung)
                record_degraded(stage.rung)

        def try_submit(i: int, cur_rows):
            stage = stages[i]
            if not any(cur_rows):
                return None  # nothing to rerank (empty retrieval): no rung
            if deadline is not None:
                deadline.check(f"{stage.name}_submit")
            width = stage.width(k)
            return stage.submit(
                self, queries, [r[:width] for r in cur_rows], keeps[i], deadline,
                query_tokens=query_tokens, query_mask=query_mask, pool_width=width,
            )

        pending = None
        try:
            pending = try_submit(0, rows)
        except Exception as exc:  # noqa: BLE001 - a stage failure is a rung
            skip(stages[0], exc)

        def complete() -> ServeResult:
            nonlocal rows
            cur = pending
            for i in range(len(stages)):
                if i > 0:
                    cur = None
                    try:
                        cur = try_submit(i, rows)
                    except Exception as exc:  # noqa: BLE001
                        skip(stages[i], exc)
                if cur is None:
                    continue
                try:
                    new_rows, stage_meta = cur()
                    rows = [list(r) for r in new_rows]
                    if stage_meta:
                        meta.update(stage_meta)
                except Exception as exc:  # noqa: BLE001
                    skip(stages[i], exc)
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

    def _compiled_stage2(self, S: int, Q: int, Kc: int, k_out: int):
        """The stage-2 step as one function of the packed rows: packed
        cross-encoder forward -> pair scores scattered into the ``[Q,
        Kc]`` ``-inf`` table (``pair_slot[r * S + s] = q * Kc + j`` for a
        real pair, ``Q * Kc`` for a pad segment: a dump cell cut off
        after the scatter) -> per-query top ``k_out`` -> ``[Q, 2 *
        k_out]`` int32 (score bits, then candidate indices)."""
        ce = self.cross_encoder

        def fused(ids, segments, positions, pair_slot):
            flat = ce.packed_forward(ids, segments, positions, S).reshape(-1).float()
            table = torch.full((Q * Kc + 1,), float("-inf"), device=flat.device)
            table.scatter_(0, pair_slot, flat)
            return pack_topk(table[: Q * Kc].view(Q, Kc), k_out)

        return fused

    @torch.no_grad()
    def _submit_stage2(
        self,
        queries: Sequence[str],
        cand_keys: List[List[int]],
        k: int,
        deadline: Optional[Deadline] = None,
        pool: Optional[int] = None,
    ):
        """Pack the (query, candidate) pairs and launch the stage-2 step;
        returns a completion -> ``(rows, meta)`` with ``missing_docs`` in
        ``meta`` when a key had no text.  ``pool`` is the calling stage's
        candidate width."""
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
        Qb = _bucket(nq)
        ids, segments, positions, S, flat_ix = ce.packed_inputs(pairs)
        Rb = ids.shape[0]
        pair_slot = np.full(Rb * S, Qb * Kc, np.int64)  # pad segments: the dump cell
        pair_slot[flat_ix] = slot_ids
        fn = self._compiled_stage2(S, Qb, Kc, k_out)
        fetch = to_host(fn(ids, segments, positions, upload(pair_slot, ce.device)))
        record_dispatch("rerank_stage2")

        def complete():
            if deadline is not None:
                deadline.check("cross_encoder.fetch")
            arr = fetch()[:nq]
            record_fetch("rerank_stage2")
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
            return results, meta

        return complete

    # -- serve --------------------------------------------------------------
    def submit(
        self,
        queries: Sequence[str],
        k: Optional[int] = None,
        deadline: Optional[Deadline] = None,
    ):
        """Launch stage 1 WITHOUT waiting; returns the serve handle
        (``advance()`` completes stage 1 and submits the cascade;
        calling it finishes the serve)."""
        k = k or self.k
        queries = list(queries)
        if deadline is None and self.deadline_ms is not None and self.deadline_ms > 0:
            deadline = Deadline.after_ms(self.deadline_ms)
        if not queries:
            done = _PendingServe(self, lambda: ServeResult(), [], k)
            done._stage2 = lambda: ServeResult()
            return done
        stage1_deadline = deadline.sub_budget(STAGE1_FRACTION) if deadline else None
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

        return _PendingServe(self, stage1, queries, k, deadline=deadline)

    def __call__(
        self, queries: Sequence[str], k: Optional[int] = None, deadline: Optional[Deadline] = None
    ) -> List[List[Tuple[int, float]]]:
        return self.submit(queries, k, deadline=deadline)()
