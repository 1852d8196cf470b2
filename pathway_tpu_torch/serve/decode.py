"""Continuous token-level batching of generator decode (counterpart of
``pathway_tpu/serve/decode.py``).

``ContinuousDecoder`` keeps a persistent slot pool on the generator's
device (K/V ``[slots, L, T, H, hd]`` plus one sampling key per slot):

- queued requests JOIN after a bucketed prefill (``_join_group``):
  cohorts are grouped by prefix split, their suffixes padded to 16 * 2^n
  tokens and their batch to a power of 4, one dispatch per group;
  shared-prefix prompts take ``PrefixKVCache`` blocks and prefill only
  their tails;
- every active slot advances together in ``decode.step_bucket``-step
  chunks (one dispatch and one fetch per chunk, whoever rides it);
- requests LEAVE at EOS or budget and free their slot mid-flight.

Token identity: a request's tokens equal ``generator.generate([prompt])``
at the same seed whatever its join order, batch-mates or slot: each
slot samples from its own chain (``models/prng.py``), masked attention
is width-invariant (slots past a row's frontier carry exactly zero
probability), a joining prefill rewrites every position its request
will attend, and inactive lanes' K/V are bit-frozen.

Speculative decode (``spec_k >= 2``): each round proposes ``k - 1``
tokens per lane, mined on the host from the lane's own prompt and
output, or from the cross-request suffix corpus of finished requests,
else from the reduced-layer trunk draft; one verify dispatch scores all
``k`` positions and each lane keeps its longest agreeing prefix.  The
verify replays the plain step's sampling, so spec-on == spec-off ==
solo at any temperature; a faulted draft or verify degrades that round
to the plain chunk and cools speculation down for 8 rounds.  A round is
at most 2 dispatches + 2 fetches (draft, verify), a plain chunk 1 + 1,
booked through ``ops/dispatch_counter.py``.

int8 pool (``kv_quant="int8"``): K/V stored int8 with per-(layer, head,
channel) scales, dequantized at every read (``ops/kv_quant.py``).

In place, unlike the reference's functional arrays: the pool is written
in place, so a prefix capture copies its blocks, a trunk draft rolls
forward on a copy, and the sampling keys and host slot state move only
after a dispatch succeeded (a retry starts from the state before the
failure; the K/V writes are write-before-read and repeat exactly).

Admission is the serve scheduler's ``_CoalescerBase``: a request too
tight for any queueing, one whose prompt + budget does not fit
``kv_width``, and the overflow past quarantined slots serve SOLO
through ``generate`` (counted in ``stats["solo"]``).  The
``generator.prefill`` / ``generator.step`` / ``generator.slot_free``
fault sites degrade the affected request only.  ``hbm_bytes`` /
``hbm_components`` count the pool's tensors; the reference's HBM ledger
is not ported yet.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config, observe
from ..device import to_host, upload
from ..models import prng
from ..observe import trace
from ..ops import dispatch_counter
from ..robust import EXTRACTIVE_ANSWER, Deadline, inject, log_once, record_degraded, retry_call
from .scheduler import _Batch, _CoalescerBase, _Ticket

__all__ = ["ContinuousDecoder", "DecodeResult", "decode_slots"]


def decode_slots() -> int:
    """Slot-pool size (``decode.slots``): the most requests one step
    dispatch decodes."""
    return config.get("decode.slots")


_H_QUEUE_WAIT = observe.histogram("pathway_generator_queue_wait_seconds")
_H_PREFILL = observe.histogram("pathway_generator_phase_seconds", phase="prefill")
_H_STEP = observe.histogram("pathway_generator_phase_seconds", phase="step")
# admission -> completion at the waiter, pool and solo paths alike
_H_TTLT = observe.histogram("pathway_generator_ttlt_seconds")
# tokens committed per lane per speculative round, on the seconds axis
# (1 token -> the (0.5, 1] s bucket, ...), so _sum/_count is the mean
_H_DRAFT_ACCEPT = observe.histogram("pathway_generator_draft_accepted_tokens")


class DecodeResult(str):
    """One request's generated text plus ladder metadata: a ``str`` with
    ``.degraded`` (rung flags, deduplicated) and ``.meta``."""

    def __new__(cls, text: str = "", degraded: Sequence[str] = (), meta: Optional[Dict[str, Any]] = None):
        self = super().__new__(cls, text)
        deduped: List[str] = []
        for flag in degraded:
            if flag not in deduped:
                deduped.append(flag)
        self.degraded = tuple(deduped)
        self.meta = dict(meta or {})
        if self.degraded and "degraded_reasons" not in self.meta:
            self.meta["degraded_reasons"] = list(self.degraded)
        return self

    @property
    def ok(self) -> bool:
        return not self.degraded


class _SlotState:
    """Host bookkeeping of one occupied slot."""

    __slots__ = ("req", "temperature", "eos", "tokens", "pos", "left", "t_join_ns", "prompt_ids")

    def __init__(self, req, temperature: float, eos: int):
        self.req = req
        self.temperature = temperature
        self.eos = eos
        self.tokens: List[int] = []
        self.pos = 0  # next K/V write position (= current length)
        self.left = 0  # decode-step tokens still allowed
        self.t_join_ns = time.perf_counter_ns()
        self.prompt_ids: List[int] = []  # the n-gram miner's corpus


def _spent_deadline() -> Deadline:
    """An expired deadline: an armed ``hang`` on a bookkeeping site
    releases at once instead of wedging the step loop."""
    return Deadline(0.0)


class ContinuousDecoder(_CoalescerBase):
    """Continuous-batching decode over one ``TextGenerator``.

    ``submit(prompt, max_new_tokens=, temperature=, seed=, deadline=,
    eos_id=)`` returns a ticket resolving to a :class:`DecodeResult` with
    the tokens of ``generator.generate([prompt], ...)``; ``generate`` is
    the blocking batch form.  One scheduler thread owns the pool."""

    _degrade_empty = False
    _metric_prefix = "pathway_generator_queue"

    def __init__(
        self,
        generator,
        slots: Optional[int] = None,
        step_bucket: Optional[int] = None,
        name: Optional[str] = None,
        window_us: Optional[float] = None,
        autostart: bool = True,
        eos_id: Any = "inherit",
        kv_width: Optional[int] = None,
        spec_k: Optional[int] = None,
        draft: Optional[str] = None,
        kv_quant: Optional[str] = None,
    ):
        from ..models.generator import (
            decode_draft_layers,
            decode_draft_source,
            decode_kv_quant,
            decode_spec_k,
            decode_step_bucket,
        )

        self.generator = generator
        cfg = generator.config
        self.slots = max(1, int(slots or decode_slots()))
        self.chunk = max(1, int(step_bucket or decode_step_bucket()))
        self.eos_id = generator.eos_id if eos_id == "inherit" else eos_id
        self.spec_k = decode_spec_k() if spec_k is None else max(0, min(int(spec_k), 16))
        self.draft_source = (
            decode_draft_source() if draft is None else (draft if draft in ("auto", "ngram", "trunk") else "auto")
        )
        self.kv_quant = decode_kv_quant() if kv_quant is None else ("int8" if kv_quant == "int8" else "bf16")
        self._quant = self.kv_quant == "int8"
        self._draft_layers = decode_draft_layers(cfg.n_layers)
        # rounds left without speculation after a draft / verify fault
        self._spec_hold = 0
        self._draft_sources = {"ngram": 0, "trunk": 0, "none": 0}
        # cross-request suffix corpus: n-gram -> the tokens after it in a
        # finished request's stream (scheduler thread only)
        self._suffix_idx: Dict[Tuple[int, ...], List[int]] = {}
        # pool width: the position table's bound unless kv_width narrows
        # it; a request whose prompt + budget does not fit serves solo
        if kv_width is None:
            kv_width = config.get("decode.kv_width")
        self._T = min(cfg.max_len, kv_width) if kv_width else cfg.max_len
        H = cfg.n_heads
        hd = cfg.d_model // H
        dev = generator.device
        if self._quant:
            self._kscale, self._vscale = generator.kv_pool_scales()
            pool_dtype = torch.int8
        else:
            self._kscale = self._vscale = None
            pool_dtype = cfg.dtype
        self._pk = torch.zeros((self.slots, cfg.n_layers, self._T, H, hd), dtype=pool_dtype, device=dev)
        self._pv = torch.zeros_like(self._pk)
        self._rngs = torch.zeros((self.slots, 2), dtype=torch.int64, device=dev)
        # slot allocation / free only; no dispatch ever holds it
        self._pool_lock = threading.Lock()
        self._free: List[int] = list(range(self.slots))
        self._active: Dict[int, _SlotState] = {}
        self.pool_stats: Dict[str, int] = {
            "tokens_prefill": 0,  # prompt tokens the prefill computed
            "tokens_decode": 0,  # tokens emitted (prefill sample + steps)
            "finished": 0,  # requests that left at EOS / budget
            "evicted": 0,  # requests resolved degraded (fault / deadline)
            "quarantined": 0,  # slots retired by slot_free faults
            "chunks": 0,  # step-chunk (and verify) dispatches
            "steps": 0,  # decode steps executed
            "occupancy_sum": 0,  # active slots summed over chunks
            "spec_rounds": 0,  # draft -> verify rounds
            "spec_fallbacks": 0,  # rounds degraded to the plain step
            "draft_offered": 0,  # draft tokens proposed (lanes x (k - 1))
            "draft_accepted": 0,  # draft tokens the verify accepted
        }
        super().__init__(
            name=name or f"decode-{observe.next_id()}", window_us=window_us, max_batch=self.slots, autostart=autostart
        )

    def hbm_bytes(self) -> int:
        """Device bytes of the slot pool: K + V buffers and the keys."""
        return sum(int(t.nbytes) for t in (self._pk, self._pv, self._rngs))

    def hbm_components(self) -> Dict[str, int]:
        """The pool's bytes, plus the int8 pool's dequant scales."""
        comp = {"kv_pool": self.hbm_bytes()}
        if self._quant:
            comp["kv_scales"] = sum(int(s.nbytes) for s in (self._kscale, self._vscale))
        return comp

    def _scales(self) -> tuple:
        return (self._kscale, self._vscale) if self._quant else ()

    # -- public surface ---------------------------------------------------------
    def submit(
        self,
        prompt: str,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        seed: int = 0,
        deadline: Optional[Deadline] = None,
        eos_id: Any = "inherit",
    ) -> _Ticket:
        if deadline is None:
            deadline = Deadline.from_env()
        eos = self.eos_id if eos_id == "inherit" else eos_id
        ctx = trace.start_trace("generate.request", deadline=deadline)
        item = (str(prompt), int(max_new_tokens), float(temperature), int(seed), -1 if eos is None else int(eos))
        return self._admit([item], None, deadline, trace_ctx=ctx)

    def generate(
        self,
        prompts: Sequence[str],
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        seed: int = 0,
        deadline: Optional[Deadline] = None,
    ) -> List[str]:
        tickets = [self.submit(p, max_new_tokens, temperature, seed, deadline=deadline) for p in prompts]
        return [t() for t in tickets]

    __call__ = generate

    # -- scheduler thread: the continuous step loop -------------------------------
    def _run(self) -> None:
        while True:
            reqs: Optional[List[Any]] = None
            try:
                reqs = self._collect_joins()
                if reqs is None:
                    return
                if reqs:
                    self._join_group(reqs)
                if self._active:
                    if self._spec_ready():
                        self._spec_round()
                    else:
                        self._step_chunk()
            except Exception as exc:  # noqa: BLE001 - the loop outlives any iteration
                log_once(
                    f"decode.run:{type(exc).__name__}",
                    "continuous decode iteration failed (%r); degrading in-flight requests and continuing",
                    exc,
                )
                self._evict_all(exc)
                for r in reqs or []:
                    if not r.event.is_set():
                        self._resolve_with_error(r, exc)

    def _collect_joins(self) -> Optional[List[Any]]:
        """Pop queued requests up to the free-slot count; block only when
        the pool is idle.  None when stopped and drained."""
        with self._cond:
            if not self._active:
                while self._running and not self._queue:
                    self._cond.wait(0.1)
            if not self._queue and not self._active and not self._running:
                return None
            free = len(self._free)
            # every slot quarantined and nothing in flight: serve the queue
            # solo so admitted tickets still resolve
            limit = free if (free or self._active) else len(self._queue)
            take: List[Any] = []
            while self._queue and len(take) < limit:
                r = self._queue.popleft()
                self._queued_items -= len(r.items)
                take.append(r)
            return take

    # -- join -----------------------------------------------------------------------
    def _resolve_degraded(self, req, meta: Dict[str, Any]) -> None:
        self.pool_stats["evicted"] += 1
        record_degraded(EXTRACTIVE_ANSWER)
        self._resolve(req, DecodeResult("", degraded=(EXTRACTIVE_ANSWER,), meta=meta))

    def _join_group(self, reqs: List[Any]) -> None:
        """Host prep per request (tokenize, prefix-cache walk), then one
        batched prefill per prefix split."""
        gen = self.generator
        cfg = gen.config
        ready: List[dict] = []
        for req in reqs:
            text, steps, temp, seed, eos = req.items[0]
            _H_QUEUE_WAIT.observe_ns(time.perf_counter_ns() - req.t_enqueue_ns)
            if req.deadline is not None and req.deadline.expired():
                self._resolve_degraded(req, {"reason": "deadline_before_join"})
                continue
            try:
                L_budget = cfg.max_len - steps
                if L_budget <= 0:
                    raise ValueError(f"max_new_tokens={steps} leaves no prompt budget (max_len={cfg.max_len})")
                ids, mask = gen.tokenizer.encode_batch([text], max_length=L_budget)
                n = int(mask.sum())
                if ids.shape[1] + steps > self._T:
                    # does not fit the narrowed pool: serve it solo
                    self._dispatch_batch([req], solo=True)
                    continue
                P, matches = 0, []
                if gen.kv_cache is not None:
                    P, matches = gen._cached_prefix(ids, np.asarray([n]), 1)
            except Exception as exc:  # noqa: BLE001 - one bad request resolves alone
                log_once(
                    f"decode.join:{type(exc).__name__}",
                    "continuous-decode join prep failed (%r); degrading the request to an empty flagged result",
                    exc,
                )
                self._resolve_degraded(req, {"error": repr(exc)})
                continue
            ready.append(dict(
                req=req, ids=ids, n=n, P=P, match=matches[0] if matches else None,
                L_sfx=ids.shape[1] - P, steps=steps, temp=temp, seed=seed, eos=eos,
            ))
        with self._pool_lock:
            free = len(self._free)
        if len(ready) > free:
            # more admitted than free slots (quarantine): the overflow
            # serves solo so every ticket resolves
            for rec in ready[free:]:
                self._dispatch_batch([rec["req"]], solo=True)
            ready = ready[:free]
        groups: Dict[int, List[dict]] = {}
        for rec in ready:
            groups.setdefault(rec["P"], []).append(rec)
        for P, grp in groups.items():
            # the cohort's suffix width rounded up to 16 * 2^n (capped at
            # the pool): pad positions are written before anything reads them
            L = max(r["L_sfx"] for r in grp)
            L_pad = 16
            while L_pad < L:
                L_pad *= 2
            self._prefill_group(grp, min(L_pad, self._T - P), P)

    def _prefill_group(self, grp: List[dict], L_sfx: int, P: int) -> None:
        gen = self.generator
        cfg = gen.config
        dev = gen.device
        n_real = len(grp)
        with self._pool_lock:
            slots_real = [self._free.pop() for _ in range(n_real)]
        B = 1  # the model's batch buckets: 1, 4, 16, ...
        while B < n_real:
            B *= 4
        try:
            suffix = np.zeros((B, L_sfx), np.int64)
            n_len = np.zeros(B, np.int64)
            temps = np.zeros(B, np.float32)
            keys = np.zeros((B, 2), np.int64)
            for j, rec in enumerate(grp):
                row = rec["ids"][0, P:]
                suffix[j, : row.shape[0]] = row
                n_len[j] = rec["n"]
                temps[j] = rec["temp"]
                keys[j] = prng.key(rec["seed"])
            prefix_k = prefix_v = None
            if P:
                prefix_k, prefix_v = gen._prefix_rows([rec["match"] for rec in grp], B, P)
            fn = gen._slot_prefill_fn(self.slots, self._T, B, L_sfx, P, self._quant)
            deadline = self._batch_deadline([rec["req"] for rec in grp])
            slot_idx = upload(np.asarray(slots_real, np.int64), dev)
            t0 = time.perf_counter_ns()
            dispatch_counter.record_dispatch("decode_prefill")
            toks, rngs_out = retry_call(
                "generator.prefill", fn,
                self._pk, self._pv, slot_idx, upload(suffix, dev), upload(n_len, dev),
                prefix_k, prefix_v, upload(keys, dev), upload(temps, dev), bool((temps <= 0).all()),
                *self._scales(), deadline=deadline,
            )
            dispatch_counter.record_fetch("decode_prefill")
            firsts = to_host(toks)()
            t1 = time.perf_counter_ns()
            _H_PREFILL.observe_ns(t1 - t0)
        except Exception as exc:  # noqa: BLE001 - the cohort degrades, the loop goes on
            for slot in slots_real:
                self._free_slot(slot)
            log_once(
                f"decode.prefill:{type(exc).__name__}",
                "continuous-decode prefill failed (%r); degrading the affected request(s) to empty flagged results",
                exc,
            )
            for rec in grp:
                self._resolve_degraded(rec["req"], {"error": repr(exc)})
            return
        self._rngs[slot_idx] = rngs_out[:n_real]
        for j, rec in enumerate(grp):
            req = rec["req"]
            slot = slots_real[j]
            first = int(firsts[j])
            if gen.kv_cache is not None:
                self._capture(rec, slot)
                gen.kv_cache.note_prefill(reused=P, computed=rec["n"] - P)
            self.pool_stats["tokens_prefill"] += rec["n"] - P
            self.pool_stats["tokens_decode"] += 1
            if req.trace is not None:
                req.trace.add_span(
                    "decode.prefill", t0, t1, slot=slot, prefix_tokens=P, suffix_tokens=L_sfx, join_batch=n_real
                )
            state = _SlotState(req, rec["temp"], rec["eos"])
            state.tokens = [first]
            state.pos = rec["n"]
            state.left = rec["steps"] - 1
            state.prompt_ids = [int(t) for t in rec["ids"][0, : rec["n"]]]
            self._active[slot] = state
            if (rec["eos"] >= 0 and first == rec["eos"]) or state.left <= 0:
                self._leave(slot, state)

    def _capture(self, rec: dict, slot: int) -> None:
        """Admit the prompt's uncached full blocks: COPIES of the pool's
        rows (the pool is written in place later), dequantized to the
        cache's compute dtype under int8 (a warm join re-quantizes them
        to the same bytes)."""
        from ..ops.kv_quant import dequantize_kv

        gen = self.generator
        blk = gen.kv_cache.block
        matched, _blocks, chain = rec["match"]

        def capture(jb: int):
            k = self._pk[slot, :, jb * blk : (jb + 1) * blk]
            v = self._pv[slot, :, jb * blk : (jb + 1) * blk]
            if self._quant:
                dt = gen.config.dtype
                return dequantize_kv(k, self._kscale, dt), dequantize_kv(v, self._vscale, dt)
            return k.clone(), v.clone()

        gen.kv_cache.admit(chain, matched // blk, capture)

    # -- plain step chunk -----------------------------------------------------------
    def _lane_arrays(self, width: int = 1):
        S = self.slots
        toks = np.zeros((S, width), np.int64)
        pos = np.zeros(S, np.int64)
        act = np.zeros(S, bool)
        left = np.zeros(S, np.int64)
        temps = np.zeros(S, np.float32)
        eos = np.full(S, -1, np.int64)
        for s, st in self._active.items():
            toks[s, 0] = st.tokens[-1]
            pos[s] = st.pos
            act[s] = True
            left[s] = st.left
            temps[s] = st.temperature
            eos[s] = st.eos
        return toks, pos, act, left, temps, eos

    def _batch_trace(self, deadline, **annotate):
        riders = [st for st in self._active.values() if st.req.trace is not None]
        bctx = None
        if riders:
            # one batch trace per dispatch, linked from every traced rider
            bctx = trace.start_trace("decode.batch", deadline=deadline, kind="batch", sample=False)
            if bctx is not None:
                bctx.annotate(engine=self.name, slots=len(self._active), **annotate)
        return riders, bctx

    def _link_riders(self, riders, bctx, t0: int, t1: int, **attrs) -> None:
        if bctx is None:
            return
        trace.finish(bctx)
        for st in riders:
            st.req.trace.add_link(bctx.trace_id)
            st.req.trace.add_span(
                "decode.step", t0, t1, linked_trace=bctx.trace_id, slots=len(self._active), **attrs
            )

    def _step_chunk(self) -> None:
        gen = self.generator
        dev = gen.device
        toks, pos, act, left, temps, eos = self._lane_arrays()
        fn = gen._slot_step_fn(self.slots, self._T, self.chunk, self._quant)
        deadline = self._batch_deadline([st.req for st in self._active.values()])
        riders, bctx = self._batch_trace(deadline, chunk=self.chunk)
        t0 = time.perf_counter_ns()
        try:
            args = (
                self._pk, self._pv, upload(toks[:, 0], dev), upload(pos, dev), upload(act, dev),
                upload(left, dev), self._rngs, upload(temps, dev), upload(eos, dev), bool((temps <= 0).all()),
                *self._scales(),
            )
            dispatch_counter.record_dispatch("decode_step")
            with trace.use(bctx) if bctx is not None else contextlib.nullcontext():
                rngs, em = retry_call("generator.step", fn, *args, deadline=deadline)
            dispatch_counter.record_fetch("decode_step")
            em = to_host(em)()  # [chunk, S]: the chunk's one fetch
        except Exception as exc:  # noqa: BLE001 - in-flight requests leave with their tokens
            if bctx is not None:
                trace.finish(bctx, statuses=("error",))
            log_once(
                f"decode.step:{type(exc).__name__}",
                "continuous-decode step chunk failed (%r); resolving in-flight requests with their tokens so far",
                exc,
            )
            self._evict_all(exc)
            return
        t1 = time.perf_counter_ns()
        _H_STEP.observe_ns(t1 - t0)
        self._rngs = rngs
        self.pool_stats["chunks"] += 1
        self.pool_stats["steps"] += self.chunk
        self.pool_stats["occupancy_sum"] += len(self._active)
        self._link_riders(riders, bctx, t0, t1)
        # replay the chunk per slot with the device's rules: a lane emits
        # until EOS or budget, then freezes
        leaves: List[Tuple[int, _SlotState, Tuple[str, ...]]] = []
        for s, st in list(self._active.items()):
            flags: Tuple[str, ...] = ()
            finished = False
            for i in range(self.chunk):
                t = int(em[i, s])
                st.tokens.append(t)
                st.pos += 1
                st.left -= 1
                self.pool_stats["tokens_decode"] += 1
                if (st.eos >= 0 and t == st.eos) or st.left <= 0:
                    finished = True
                    break
            if not finished and st.req.deadline is not None and st.req.deadline.expired():
                # mid-decode deadline: leave with the tokens so far, flagged
                finished = True
                flags = (EXTRACTIVE_ANSWER,)
            if finished:
                leaves.append((s, st, flags))
        for s, st, flags in leaves:
            self._leave(s, st, flags=flags)

    # -- speculative decode: draft -> verify -> accept ---------------------------------
    def _spec_ready(self) -> bool:
        """A speculative round needs ``spec_k >= 2``, no fault cooldown,
        and room for all ``k`` writes in every active lane (the window
        start clamps, so a lane with pos + k > T would overwrite valid
        rows: near the frontier the engine takes plain steps)."""
        k = self.spec_k
        if k < 2:
            return False
        if self._spec_hold > 0:
            self._spec_hold -= 1
            return False
        return all(st.pos + k <= self._T for st in self._active.values())

    @staticmethod
    def _mine_ngram(hist: List[int], want: int) -> List[int]:
        """Prompt-lookup drafts: the tokens after the rightmost earlier
        occurrence of the history's trailing n-gram (n = 3, 2, 1); []
        when there is none."""
        L = len(hist)
        for n in (3, 2, 1):
            if L < n + 1:
                continue
            pat = hist[-n:]
            for j in range(L - n - 1, -1, -1):
                if hist[j : j + n] == pat:
                    cont = hist[j + n : j + n + want]
                    if cont:
                        return cont
        return []

    def _remember(self, st: _SlotState) -> None:
        """Feed a finished request's stream (prompt + emitted) into the
        suffix index: every n-gram (n = 1..6) maps to the up to 16 tokens
        after its FIRST occurrence in the stream; across streams the most
        recent one wins.  Cleared past 100,000 entries."""
        seq = st.prompt_ids + st.tokens
        if len(seq) < 2:
            return
        idx = self._suffix_idx
        if len(idx) > 100_000:
            idx.clear()
        fresh: Dict[Tuple[int, ...], List[int]] = {}
        for n in range(1, 7):
            for i in range(len(seq) - n):
                fresh.setdefault(tuple(seq[i : i + n]), seq[i + n : i + n + 16])
        idx.update(fresh)

    def _mine_corpus(self, hist: List[int], want: int) -> List[int]:
        """The suffix index's continuation of the history's trailing
        n-gram, longest context first (n = 6 .. 1)."""
        for n in (6, 5, 4, 3, 2, 1):
            if len(hist) < n:
                continue
            cont = self._suffix_idx.get(tuple(hist[-n:]))
            if cont:
                return cont[:want]
        return []

    def _spec_round(self) -> None:
        """Propose ``k - 1`` tokens per lane, verify all ``k`` positions in
        one dispatch, commit each lane's longest agreeing prefix.  Any
        draft / verify fault runs the plain chunk instead (same tokens)
        and arms an 8-round cooldown."""
        gen = self.generator
        dev = gen.device
        k = self.spec_k
        toks, pos, act, left, temps, eos = self._lane_arrays(k)
        src_of: Dict[int, str] = {}
        need_trunk: List[int] = []
        for s, st in self._active.items():
            mined: List[int] = []
            if self.draft_source in ("auto", "ngram"):
                hist = st.prompt_ids + st.tokens
                mined = self._mine_ngram(hist, k - 1)
                pooled = self._mine_corpus(hist, k - 1)
                if len(pooled) > len(mined):
                    mined = pooled
            if mined:
                toks[s, 1 : 1 + len(mined)] = mined
                src_of[s] = "ngram"
            elif self.draft_source in ("auto", "trunk"):
                need_trunk.append(s)
                src_of[s] = "trunk"
            else:
                src_of[s] = "none"
        vfn = gen._slot_verify_fn(self.slots, self._T, k, self._quant)
        dfn = gen._slot_draft_fn(self.slots, self._T, k - 1, self._draft_layers, self._quant)
        deadline = self._batch_deadline([st.req for st in self._active.values()])
        riders, bctx = self._batch_trace(deadline, spec_k=k, spec=True)
        t0 = time.perf_counter_ns()
        try:
            pos_d, act_d = upload(pos, dev), upload(act, dev)
            if need_trunk:
                dispatch_counter.record_dispatch("decode_draft")
                dr = retry_call(
                    "generator.draft", dfn, self._pk, self._pv, upload(toks[:, 0], dev), pos_d, act_d,
                    *self._scales(), deadline=deadline,
                )
                dispatch_counter.record_fetch("decode_draft")
                dr = to_host(dr)()
                for s in need_trunk:
                    toks[s, 1:] = dr[s]
            else:
                # a pure n-gram round still fires the site, so a faulted
                # draft path degrades all speculation alike
                inject.fire("generator.draft", deadline=deadline)
            args = (
                self._pk, self._pv, upload(toks, dev), pos_d, act_d, upload(left, dev), self._rngs,
                upload(temps, dev), upload(eos, dev), bool((temps <= 0).all()), *self._scales(),
            )
            dispatch_counter.record_dispatch("decode_verify")
            with trace.use(bctx) if bctx is not None else contextlib.nullcontext():
                rngs, em = retry_call("generator.verify", vfn, *args, deadline=deadline)
            dispatch_counter.record_fetch("decode_verify")
            em = to_host(em)()  # [k, S]
        except Exception as exc:  # noqa: BLE001 - degrade to the plain chunk
            if bctx is not None:
                trace.finish(bctx, statuses=("speculation_disabled",))
            log_once(
                f"decode.spec:{type(exc).__name__}",
                "speculative round failed (%r); falling back to the plain step chunk (token-identical) "
                "and cooling down",
                exc,
            )
            self.pool_stats["spec_fallbacks"] += 1
            record_degraded("speculation_disabled")
            self._spec_hold = 8
            self._step_chunk()
            return
        t1 = time.perf_counter_ns()
        _H_STEP.observe_ns(t1 - t0)
        self._rngs = rngs
        self.pool_stats["chunks"] += 1
        self.pool_stats["steps"] += k
        self.pool_stats["spec_rounds"] += 1
        self.pool_stats["occupancy_sum"] += len(self._active)
        self._link_riders(riders, bctx, t0, t1, spec_k=k)
        # commit each lane's accepted prefix: -1 marks the first rejected
        # position; EOS inside the prefix truncates it and frees the slot
        leaves: List[Tuple[int, _SlotState, Tuple[str, ...]]] = []
        for s, st in list(self._active.items()):
            emitted = 0
            flags: Tuple[str, ...] = ()
            finished = False
            for i in range(k):
                t = int(em[i, s])
                if t < 0:
                    break
                st.tokens.append(t)
                st.pos += 1
                st.left -= 1
                emitted += 1
                self.pool_stats["tokens_decode"] += 1
                if (st.eos >= 0 and t == st.eos) or st.left <= 0:
                    finished = True
                    break
            _H_DRAFT_ACCEPT.observe_s(float(emitted))
            self.pool_stats["draft_offered"] += k - 1
            self.pool_stats["draft_accepted"] += max(0, emitted - 1)
            self._draft_sources[src_of.get(s, "none")] += 1
            if not finished and st.req.deadline is not None and st.req.deadline.expired():
                finished = True
                flags = (EXTRACTIVE_ANSWER,)
            if finished:
                leaves.append((s, st, flags))
        for s, st, flags in leaves:
            self._leave(s, st, flags=flags)

    # -- leave / resolve ---------------------------------------------------------------
    def _leave(self, slot: int, st: _SlotState, flags: Tuple[str, ...] = ()) -> None:
        meta: Dict[str, Any] = {"tokens": len(st.tokens), "slot": slot}
        if flags:
            self.pool_stats["evicted"] += 1
            meta["partial"] = True
            for f in flags:
                record_degraded(f)
        else:
            self.pool_stats["finished"] += 1
            if self.spec_k >= 2:
                self._remember(st)
        if st.req.trace is not None:
            st.req.trace.add_span("decode", st.t_join_ns, time.perf_counter_ns(), tokens=len(st.tokens), slot=slot)
        # free BEFORE resolving: the waiter may act the instant it fires
        self._active.pop(slot, None)
        self._free_slot(slot)
        self._resolve(st.req, DecodeResult(self.generator.render_tokens(st.tokens), degraded=flags, meta=meta))

    def _evict_all(self, exc: BaseException) -> None:
        """Every in-flight request resolves with its tokens so far,
        flagged; the loop keeps serving the queue."""
        for s, st in list(self._active.items()):
            self.pool_stats["evicted"] += 1
            record_degraded(EXTRACTIVE_ANSWER)
            self._active.pop(s, None)
            self._free_slot(s)
            self._resolve(
                st.req,
                DecodeResult(
                    self.generator.render_tokens(st.tokens),
                    degraded=(EXTRACTIVE_ANSWER,),
                    meta={"partial": True, "tokens": len(st.tokens), "error": repr(exc)},
                ),
            )

    def _free_slot(self, slot: int) -> None:
        """Return a slot to the free list; a ``generator.slot_free`` fault
        quarantines it instead (fired under a spent deadline, so an armed
        hang releases at once)."""
        try:
            inject.fire("generator.slot_free", deadline=_spent_deadline())
        except Exception as exc:  # noqa: BLE001 - quarantine, never a corrupt hand-off
            log_once(
                f"decode.slot_free:{type(exc).__name__}",
                "slot free failed (%r); quarantining slot instead of reusing it",
                exc,
            )
            self.pool_stats["quarantined"] += 1
            return
        with self._pool_lock:
            self._free.append(slot)

    def _resolve(self, req, result: DecodeResult) -> None:
        req.slots = [0]
        req.batch = _Batch(lambda _r=result: [_r], 1, 1, self._degrade_empty)
        req.event.set()
        if req.trace is not None:
            trace.finish(req.trace, statuses=tuple(result.degraded))

    # -- solo path (deadline preemption, stop-drain, kv_width, quarantine) ---------------
    def _launch(self, items: List[Any], reqs: List[Any]):
        gen = self.generator

        def run(_items=tuple(items)):
            out = []
            for text, steps, temp, seed, eos in _items:
                rows = gen.generate(
                    [text], max_new_tokens=steps, temperature=temp, seed=seed, eos_id=None if eos < 0 else eos
                )
                out.append(DecodeResult(rows[0]))
            return out

        return run

    def _demux(self, req, batch_result) -> DecodeResult:
        _H_TTLT.observe_ns(time.perf_counter_ns() - req.t_enqueue_ns)
        out = []
        for slot in req.slots:
            if 0 <= slot < len(batch_result):
                out.append(batch_result[slot])
            else:  # pragma: no cover - defensive
                out.append(DecodeResult("", degraded=(EXTRACTIVE_ANSWER,)))
        result = out[0]
        if req.trace is not None:
            # solo-path requests resolve here without passing _resolve
            trace.finish(req.trace, statuses=tuple(getattr(result, "degraded", ())))
        return result

    # -- flight-recorder provider -----------------------------------------------------
    def observe_metrics(self):
        yield from super().observe_metrics()
        labels = {"generator": self.name}
        yield ("gauge", "pathway_generator_slots", labels, self.slots)
        yield ("gauge", "pathway_generator_slots_active", labels, len(self._active))
        yield ("gauge", "pathway_generator_slots_quarantined", labels, self.pool_stats["quarantined"])
        for phase in ("prefill", "decode"):
            yield ("counter", "pathway_generator_tokens_total", {**labels, "phase": phase},
                   self.pool_stats[f"tokens_{phase}"])
        for outcome in ("finished", "evicted"):
            yield ("counter", "pathway_generator_requests_total", {**labels, "outcome": outcome},
                   self.pool_stats[outcome])
        yield ("counter", "pathway_generator_steps_total", labels, self.pool_stats["steps"])
        yield ("counter", "pathway_generator_chunks_total", labels, self.pool_stats["chunks"])
        offered = self.pool_stats["draft_offered"]
        yield ("gauge", "pathway_generator_draft_acceptance_rate", labels,
               (self.pool_stats["draft_accepted"] / offered) if offered else 0.0)
        for source in ("ngram", "trunk", "none"):
            yield ("counter", "pathway_generator_draft_source_total", {**labels, "source": source},
                   self._draft_sources[source])
