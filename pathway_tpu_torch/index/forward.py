"""Device-resident forward index (counterpart of
``pathway_tpu/index/forward.py`` ``ForwardIndex``, one device).

- **ingest** (``add``): the doc-side encoder exports per-token states
  (``SentenceEncoder.encode_token_states``); ``pool_token_states`` mean
  pools each document's real tokens in ``T'`` contiguous chunks (so the
  valid rows are exactly ``0 .. min(T', len) - 1``), L2-normalizes each
  row and quantizes per channel to symmetric int8 with absmax/127
  scales.  The plan (encode + pool + quantize) runs off the index lock;
  the commit takes it, drops keys whose version moved while the plan
  ran, and writes the rows in place (``index_copy_``) on the stream of
  the last gather, so a gather already queued reads the old rows;
- **storage**: row buckets ``tok [cap, T', d]`` int8 (f32 with
  ``quant="none"``), ``scales [cap, d]`` f32, ``nvalid [cap]`` int32, on
  the device; capacity doubles from ``initial_capacity`` into NEW
  tensors, so a gather already queued keeps the old ones;
- **serve** (``gather_submit``): the slot table of the candidates is
  built on the host, uploaded, and the gather + dequantize + MaxSim +
  top-k (``ops/maxsim.py``) launches under the lock, retried under the
  ``forward.gather`` site; one packed int32 result is copied to pinned
  host memory, and the completion fires ``forward.gather.fetch``.
  Nothing syncs the device;
- **knobs and faults**: ``tokens_per_doc`` / ``quant`` default to the
  ``forward.tokens`` / ``forward.quant`` knobs (a bad ``quant`` falls
  back to the knob, as in the reference); the plan fires
  ``forward.absorb`` and the commit ``forward.upload``.  A failed pass
  is logged once, counted on ``pathway_forward_absorb_failures_total``
  and leaves the documents out of the index (``add`` returns 0): the
  late-interaction stage degrades, serving goes on.  Every 8th absorb
  audits its int8 rows (``pathway_forward_quant_abs_err``); the
  ``pathway_forward_*`` families are scraped from ``observe_metrics``;
- **operator plane**: pool, audit and MaxSim are attributed by the
  profiler as ``forward.pool`` / ``forward.audit`` / ``forward.maxsim``,
  their shape keys go through the ``ForwardIndex`` tripwire, the row
  buckets are on the device-memory ledger (rows as a capacity resource,
  ``forward_rows``), and the commit's in-place writes are reported to
  the in-place-write tripwire, which checks that a warm state taken in
  is never written.

``ShardedForwardIndex`` shards the index by document over a
``ShardGroup`` (see its docstring); each shard is a ``ForwardIndex``
whose row buckets live on the shard's device.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import config, observe
from ..device import to_host, upload
from ..observe import hbm, profile
from ..ops import donation_guard
from ..ops.dispatch_counter import record_dispatch, record_fetch
from ..ops.maxsim import maxsim_table, maxsim_topk, merge_tables
from ..ops.recompile_guard import RecompileTripwire
from ..robust import RetryPolicy, inject, log_once, retry_call

__all__ = [
    "ForwardIndex", "ForwardUnavailable", "ShardedForwardIndex", "audit_quant_error", "forward_quant_mode",
    "forward_tokens_per_doc", "pool_token_states",
]

# every Nth absorb re-measures the quantization error on its batch
_AUDIT_EVERY = 8
# the gather launches under the index lock: its retry budget stays short
_GATHER_RETRY = RetryPolicy(attempts=3, base_delay_s=0.002, max_delay_s=0.02)

# absorb wall time (plan + commit) and the locked device-write part
_H_ABSORB = observe.histogram("pathway_forward_absorb_seconds")
_H_UPLOAD = observe.histogram("pathway_forward_upload_seconds")


def forward_tokens_per_doc(default: int = 16) -> int:
    """Pooled rows per document ``T'`` from ``forward.tokens``, else
    ``default``."""
    return config.get("forward.tokens", fallback=default)


def forward_quant_mode(default: str = "int8") -> str:
    """``forward.quant``: ``int8`` (per-channel scales) or ``none``
    (f32 rows), else ``default``."""
    return config.get("forward.quant", fallback=default)


class ForwardUnavailable(RuntimeError):
    """The forward index cannot serve this gather (empty, or no
    candidate resident): the late-interaction stage flags its rung."""


def pool_token_states(tokens: torch.Tensor, mask: torch.Tensor, T: int, quant: bool):
    """The reference's ``_pool_fn``: ``tokens [B, L, d]`` f32 and ``mask
    [B, L]`` -> ``(q [B, T, d] int8 or f32, scales [B, d] f32, nvalid [B]
    int32, pooled [B, T, d] f32)``.  Chunk ids are computed in f32 in the
    reference's op order; rounding is half to even, clipped to +-127."""
    m = mask.float()
    lens = m.sum(dim=1)  # [B]
    pos = torch.cumsum(m, dim=1) - 1.0
    denom = torch.clamp(lens, min=float(T))[:, None]
    seg = torch.floor(pos * T / denom)
    seg = torch.where(m > 0, seg, torch.full_like(seg, float(T)))  # pad -> out of range
    onehot = (seg[:, :, None] == torch.arange(T, device=tokens.device)[None, None, :]).float()
    summed = torch.einsum("blt,bld->btd", onehot, tokens)
    counts = onehot.sum(dim=1)  # [B, T]
    pooled = summed / torch.clamp(counts, min=1.0)[:, :, None]
    pooled = pooled / torch.clamp(torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-9)
    pooled = pooled * (counts > 0)[:, :, None]
    nvalid = torch.clamp(lens, max=float(T)).to(torch.int32)
    if quant:
        absmax = pooled.abs().amax(dim=1)  # [B, d]
        scales = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
        q = torch.clamp(torch.round(pooled / scales[:, None, :]), -127, 127).to(torch.int8)
    else:
        scales = torch.ones((pooled.shape[0], pooled.shape[2]), device=tokens.device)
        q = pooled
    return q, scales, nvalid, pooled


def audit_quant_error(pooled, q, scales, nvalid, quant: bool) -> torch.Tensor:
    """The reference's ``_audit_fn``: mean |MaxSim(float rows) -
    MaxSim(dequantized rows)| with the first docs' own pooled rows as
    probe queries (a 0-d f32 tensor)."""
    T = pooled.shape[1]
    nq = min(4, pooled.shape[0])
    deq = q.float() * scales[:, None, :] if quant else q.float()
    probe = pooled[:nq]
    t = torch.arange(T, device=pooled.device)
    pmask = (t[None, :] < nvalid[:nq, None]).float()  # [nq, T]
    tmask = (t[None, :] < nvalid[:, None])[None, :, None, :]

    def maxsim(docs):
        sim = torch.einsum("qld,ktd->qklt", probe, docs)
        sim = sim.masked_fill(~tmask, float("-inf"))
        best = sim.amax(dim=3)
        best = torch.where(pmask[:, None, :] > 0, best, torch.zeros_like(best))
        return best.sum(dim=2)

    sf, sq = maxsim(pooled), maxsim(deq)
    both = torch.isfinite(sf) & torch.isfinite(sq)
    diff = torch.where(both, (sf - sq).abs(), torch.zeros_like(sf))
    return diff.sum() / torch.clamp(both.sum(), min=1)


class ForwardIndex:
    """Forward index over a port ``SentenceEncoder``, on the encoder's
    device.  ``add(keys, texts)`` ingests; ``gather_submit`` is the serve
    entry of ``LateInteractionStage``.  ``tokens_per_doc`` and ``quant``
    default to the ``forward.tokens`` / ``forward.quant`` knobs."""

    def __init__(
        self,
        encoder,
        tokens_per_doc: Optional[int] = None,
        quant: Optional[str] = None,
        initial_capacity: int = 1024,
    ):
        self.encoder = encoder
        self.device = encoder.device
        self.tokens_per_doc = int(tokens_per_doc or forward_tokens_per_doc())
        self.quant = quant if quant in ("int8", "none") else forward_quant_mode()
        self.dimension = int(encoder.config.d_model)
        self._lock = threading.RLock()
        self._capacity = 0
        self._initial_capacity = max(64, int(initial_capacity))
        self._tok: Optional[torch.Tensor] = None
        self._scales: Optional[torch.Tensor] = None
        self._nvalid: Optional[torch.Tensor] = None
        # host bookkeeping: key <-> slot, freed slots, per-key versions
        # (an off-lock plan drops keys whose version moved before its
        # commit), per-slot real ingest token counts and valid rows
        self._slot_of_key: Dict[int, int] = {}
        self._free: List[int] = []
        self._next_slot = 0
        self._key_version: Dict[int, int] = {}
        self._ntok_by_slot: Optional[np.ndarray] = None
        self._nvalid_host: Optional[np.ndarray] = None
        self._tokens_stored = 0
        self._raw_tokens_live = 0
        # bumped whenever the row buckets change
        self.generation = 0
        # the stream of the last gather: commits write after it
        self._serve_stream = None
        self._quant_abs_err: Optional[float] = None
        self.stats = {
            "absorbs": 0,
            "docs_absorbed": 0,
            "absorb_failures": 0,
            "upload_failures": 0,
            "gathers": 0,
            "gather_candidates": 0,
            "gather_missing": 0,
        }
        self._observe_id = observe.next_id()
        observe.register_provider(self)
        self._tripwire = RecompileTripwire("ForwardIndex")
        hbm.track("forward", self, lambda ix: {"rows": ix.hbm_bytes()})
        hbm.track_resource(
            "forward_rows", self, lambda ix: len(ix), lambda ix: ix._tok.shape[0] if ix._tok is not None else 0
        )

    # -- introspection ------------------------------------------------------
    def __len__(self) -> int:
        return len(self._slot_of_key)

    def __contains__(self, key: int) -> bool:
        return int(key) in self._slot_of_key

    def hbm_bytes(self) -> int:
        """Device bytes of the row buckets (allocated capacity)."""
        return sum(
            t.numel() * t.element_size() for t in (self._tok, self._scales, self._nvalid) if t is not None
        )

    def compression_ratio(self) -> float:
        """Raw f32 token-state bytes of the live documents over their
        stored bytes."""
        n = len(self._slot_of_key)
        if n == 0:
            return 1.0
        raw = self._raw_tokens_live * self.dimension * 4
        itemsize = 1 if self.quant == "int8" else 4
        stored = n * (self.tokens_per_doc * self.dimension * itemsize + self.dimension * 4 + 4)
        return raw / max(stored, 1)

    # -- ingest -------------------------------------------------------------
    def add(self, keys: Sequence[int], texts: Sequence[str]) -> int:
        """Ingest documents (plan off the lock, commit under it); upserts
        overwrite in place.  Returns the number of documents committed:
        0 when the plan or the commit failed (logged once, counted, the
        documents stay out until a later ``add``)."""
        keys = [int(k) for k in keys]
        if not keys:
            return 0
        t0 = time.perf_counter_ns()
        with self._lock:
            versions = {k: self._key_version.get(k, 0) for k in keys}
        try:
            plan = self._plan_absorb(keys, texts)
            plan["versions"] = versions
        except Exception as exc:  # noqa: BLE001 - degrade, never die: counted and logged
            with self._lock:
                self.stats["absorb_failures"] += 1
            log_once(f"forward.absorb:{type(exc).__name__}",
                     "forward-index absorb plan failed (%r); documents stay out of the forward index", exc)
            return 0
        try:
            with self._lock:
                n = self._commit_absorb(plan)
        except Exception as exc:  # noqa: BLE001 - degrade, never die: counted and logged
            with self._lock:
                self.stats["upload_failures"] += 1
                self.stats["absorb_failures"] += 1
            log_once(f"forward.upload:{type(exc).__name__}",
                     "forward-index commit upload failed (%r); documents stay out of the forward index", exc)
            return 0
        _H_ABSORB.observe_ns(time.perf_counter_ns() - t0)
        if plan["audit"] is not None:
            self._quant_abs_err = float(plan["audit"])  # one scalar, off the lock
        return n

    @torch.no_grad()
    def _plan_absorb(self, keys: List[int], texts: Sequence[str]) -> Dict[str, Any]:
        """Encode + pool + quantize one ingest batch (lock-free)."""
        inject.fire("forward.absorb")  # fault site: the off-lock plan
        tokens, mask, n = self.encoder.encode_token_states(texts)
        quant = self.quant == "int8"
        T = self.tokens_per_doc
        self._tripwire.observe(("pool", tokens.shape[0], tokens.shape[1], T, quant))
        # pathway: allow(recompile-hazard): shapes bucketed upstream — encode_token_states pads the batch with _bucket and pins L to max_len, so the pool step sees one shape per batch bucket
        q, scales, nvalid, pooled = _POOL(tokens, upload(mask, tokens.device), T, quant)
        audit = None
        if self.stats["absorbs"] % _AUDIT_EVERY == 0:
            self._tripwire.observe(("audit", tokens.shape[0], T, quant))
            audit = _AUDIT(pooled, q, scales, nvalid, quant)
        lens = mask.sum(axis=1).astype(np.int64)
        return {
            "keys": keys,
            "n": n,
            "q": q,
            "scales": scales,
            "nvalid": nvalid,
            # the device nvalid, computed on the host from the same mask
            "nvalid_host": np.minimum(lens, self.tokens_per_doc)[:n],
            "ntok": lens[:n],
            "audit": audit,
        }

    def _commit_absorb(self, plan: Dict[str, Any]) -> int:
        """Install one plan (caller holds the lock): slot per row (upsert
        reuses, else the free list, else fresh), capacity growth, the
        in-place row writes, then the host bookkeeping."""
        keys, n, versions = plan["keys"], plan["n"], plan["versions"]
        slots = np.full(n, -1, np.int64)
        fresh_needed = 0
        popped: List[int] = []
        for i, key in enumerate(keys[:n]):
            if self._key_version.get(key, 0) != versions.get(key, 0):
                continue  # mutated while the plan ran: dropped
            slot = self._slot_of_key.get(key)
            if slot is None:
                if self._free:
                    slot = self._free.pop()
                    popped.append(slot)
                else:
                    slot = self._next_slot + fresh_needed
                    fresh_needed += 1
            slots[i] = slot
        live_rows = np.flatnonzero(slots >= 0)
        if live_rows.size == 0:
            self._free.extend(popped)
            return 0
        high = self._next_slot + fresh_needed
        try:
            self._grow_to(high)
            inject.fire("forward.upload")  # fault site: the locked device writes
            t0 = time.perf_counter_ns()
            rows = upload(live_rows, self.device)
            slots_dev = upload(slots[live_rows], self.device)
            on_stream = contextlib.nullcontext()
            if self.device.type == "cuda":
                stream = self._serve_stream or torch.cuda.current_stream(self.device)
                stream.wait_stream(torch.cuda.current_stream(self.device))  # the plan
                # the plan's tensors were allocated on the ingest stream:
                # keep the allocator from reusing them before these copies run
                for t in (plan["q"], plan["scales"], plan["nvalid"], rows, slots_dev):
                    t.record_stream(stream)
                on_stream = torch.cuda.stream(stream)
            with on_stream:
                self._tok.index_copy_(0, slots_dev, plan["q"].index_select(0, rows))
                self._scales.index_copy_(0, slots_dev, plan["scales"].index_select(0, rows))
                self._nvalid.index_copy_(0, slots_dev, plan["nvalid"].index_select(0, rows))
            donation_guard.note_write("forward.commit", self._tok, self._scales, self._nvalid)
        except BaseException:
            self._free.extend(popped)  # no leaked free slots on failure
            raise
        _H_UPLOAD.observe_ns(time.perf_counter_ns() - t0)
        nvalid_host = plan["nvalid_host"]
        for i in live_rows.tolist():
            key, slot = keys[i], int(slots[i])
            old = self._slot_of_key.get(key)
            if old is not None:
                if old == slot:  # in-place upsert: retire the old accounting
                    self._tokens_stored -= int(self._nvalid_host[slot])
                    self._raw_tokens_live -= int(self._ntok_by_slot[slot])
                else:  # a key twice in one batch: the earlier slot frees
                    self._release_slot(old)
            self._slot_of_key[key] = slot
            self._key_version[key] = self._key_version.get(key, 0) + 1
            self._ntok_by_slot[slot] = plan["ntok"][i]
            self._raw_tokens_live += int(plan["ntok"][i])
            self._tokens_stored += int(nvalid_host[i])
            self._nvalid_host[slot] = int(nvalid_host[i])
        self._next_slot = max(self._next_slot, high)
        self.generation += 1
        self.stats["absorbs"] += 1
        self.stats["docs_absorbed"] += int(live_rows.size)
        return int(live_rows.size)

    def _release_slot(self, slot: int) -> None:
        """Retire one live slot's accounting and free it (caller holds
        the lock)."""
        self._tokens_stored -= int(self._nvalid_host[slot])
        self._raw_tokens_live -= int(self._ntok_by_slot[slot])
        self._ntok_by_slot[slot] = 0
        self._nvalid_host[slot] = 0
        self._free.append(slot)

    def _grow_to(self, needed_slots: int) -> None:
        """Capacity for ``needed_slots`` rows (caller holds the lock),
        doubling from ``initial_capacity`` into new tensors."""
        if needed_slots <= self._capacity:
            return
        new_cap = self._initial_capacity
        while new_cap < needed_slots:
            new_cap *= 2
        extra = new_cap - self._capacity
        T, d, dev = self.tokens_per_doc, self.dimension, self.device
        tok_dtype = torch.int8 if self.quant == "int8" else torch.float32
        parts = {
            "_tok": torch.zeros((extra, T, d), dtype=tok_dtype, device=dev),
            "_scales": torch.ones((extra, d), device=dev),
            "_nvalid": torch.zeros((extra,), dtype=torch.int32, device=dev),
        }
        for name, zeros in parts.items():
            old = getattr(self, name)
            setattr(self, name, zeros if old is None else torch.cat([old, zeros]))
        host = {"_ntok_by_slot": np.int64, "_nvalid_host": np.int32}
        for name, dtype in host.items():
            old = getattr(self, name)
            zeros = np.zeros(extra, dtype)
            setattr(self, name, zeros if old is None else np.concatenate([old, zeros]))
        self._capacity = new_cap
        self.generation += 1

    def remove(self, keys: Sequence[int]) -> None:
        """Drop documents (host bookkeeping only: an unmapped slot is
        unreachable and is overwritten when reused)."""
        with self._lock:
            for k in keys:
                k = int(k)
                # bump even when absent: an in-flight plan must not
                # resurrect the key
                self._key_version[k] = self._key_version.get(k, 0) + 1
                slot = self._slot_of_key.pop(k, None)
                if slot is not None:
                    self._release_slot(slot)

    # -- warm state ---------------------------------------------------------
    def warm_state(self) -> Dict[str, Any]:
        """Snapshot in the reference's ``warm_state()`` format (numpy
        row buckets + host bookkeeping).  Commits write the buckets in
        place, so they are copied on the device under the lock (queued,
        not waited) and fetched off it."""
        with self._lock:
            tok, scales, nvalid = (
                None if t is None else t.clone() for t in (self._tok, self._scales, self._nvalid)
            )
            state: Dict[str, Any] = {
                "kind": "forward",
                "dimension": self.dimension,
                "tokens_per_doc": self.tokens_per_doc,
                "quant": self.quant,
                "capacity": self._capacity,
                "slot_of_key": dict(self._slot_of_key),
                "free": list(self._free),
                "next_slot": self._next_slot,
                "key_version": dict(self._key_version),
                "ntok_by_slot": None if self._ntok_by_slot is None else self._ntok_by_slot.copy(),
                "nvalid_host": None if self._nvalid_host is None else self._nvalid_host.copy(),
                "tokens_stored": self._tokens_stored,
                "raw_tokens_live": self._raw_tokens_live,
                "generation": self.generation,
            }
        for name, t in (("tok", tok), ("scales", scales), ("nvalid", nvalid)):
            state[name] = None if t is None else t.cpu().numpy()
        return state

    def load_warm_state(self, state: Dict[str, Any]) -> None:
        """Install a ``warm_state()`` snapshot of either package.  Raises
        ``ValueError`` on a geometry or quant mismatch."""
        if state.get("kind") != "forward":
            raise ValueError(f"not a forward warm state: {state.get('kind')!r}")
        for field in ("dimension", "tokens_per_doc"):
            if int(state[field]) != int(getattr(self, field)):
                raise ValueError(
                    f"{field} mismatch: snapshot {state[field]} vs index {getattr(self, field)}"
                )
        if state["quant"] != self.quant:
            raise ValueError(f"quant mismatch: snapshot {state['quant']!r} vs index {self.quant!r}")

        # the snapshot's arrays are the caller's: never written by this index
        arrays = [state[n] for n in ("tok", "scales", "nvalid") if isinstance(state[n], np.ndarray)]
        donation_guard.guard("forward.load_warm_state", *arrays)
        donation_guard.stamp("forward.load_warm_state", *arrays)

        def dev(name):
            # a copy: commits write in place (on a card the upload is that copy)
            a = state[name]
            if a is None:
                return None
            if self.device.type == "cpu" or not a.flags.writeable:
                a = np.array(a)
            return torch.from_numpy(a).to(self.device)

        tok, scales, nvalid = dev("tok"), dev("scales"), dev("nvalid")
        with self._lock:
            self._tok, self._scales, self._nvalid = tok, scales, nvalid
            self._capacity = int(state["capacity"])
            self._slot_of_key = {int(k): int(s) for k, s in state["slot_of_key"].items()}
            self._free = [int(s) for s in state["free"]]
            self._next_slot = int(state["next_slot"])
            self._key_version = {int(k): int(v) for k, v in state["key_version"].items()}
            for name in ("ntok_by_slot", "nvalid_host"):
                a = state[name]
                setattr(self, "_" + name, None if a is None else np.array(a))
            self._tokens_stored = int(state["tokens_stored"])
            self._raw_tokens_live = int(state["raw_tokens_live"])
            self.generation = int(state["generation"])

    # -- serve --------------------------------------------------------------
    @torch.no_grad()
    def gather_submit(
        self,
        query_tokens: Optional[torch.Tensor],
        query_mask: np.ndarray,
        cand_keys: List[List[int]],
        k_out: int,
        deadline=None,
        width: Optional[int] = None,
    ):
        """Launch gather + MaxSim + top-k for one serve batch; returns
        ``(complete, missing)``: ``complete() -> (scores [nq, k_out] f32,
        perm [nq, k_out] int32)`` (perm indexes each row of
        ``cand_keys``), ``missing[qi]`` the candidate positions with no
        rows here.  ``width`` pins the candidate grid to the stage's pool
        width.  Raises ``ForwardUnavailable`` when nothing is resident."""
        if query_tokens is None:
            raise ForwardUnavailable("no query token states from stage 1")
        B = int(query_tokens.shape[0])
        nq = len(cand_keys)
        longest = max((len(row) for row in cand_keys), default=0)
        Kc = max(int(width) if width else longest, longest, 1)
        k_out = min(int(k_out), Kc)
        if deadline is not None:
            deadline.check("forward.gather")
        if self._tok is None or not self._slot_of_key:
            raise ForwardUnavailable("forward index is empty")
        # the mask comes from the host tokenizer: pinned upload, no sync
        mask_dev = upload(np.asarray(query_mask, np.float32), self.device)
        with self._lock:
            if self._tok is None or not self._slot_of_key:
                raise ForwardUnavailable("forward index is empty")
            slots = np.full((B, Kc), -1, np.int32)
            missing: List[List[int]] = []
            n_missing = 0
            for qi, row in enumerate(cand_keys):
                miss: List[int] = []
                for j, key in enumerate(row[:Kc]):
                    slot = self._slot_of_key.get(int(key))
                    if slot is None:
                        miss.append(j)
                        n_missing += 1
                    else:
                        slots[qi, j] = slot
                missing.append(miss)
            n_cand = sum(len(row) for row in cand_keys)
            if n_missing >= n_cand:
                raise ForwardUnavailable("no candidate is resident")
            if self.device.type == "cuda":
                self._serve_stream = torch.cuda.current_stream(self.device)
            slots_dev = upload(slots, self.device)
            Lq = int(query_tokens.shape[1])
            self._tripwire.observe(("maxsim", B, Lq, Kc, k_out, self._capacity, self.tokens_per_doc))
            # the launch runs under the index lock: a short retry schedule
            fetch = retry_call(  # pathway: allow(lock-discipline): dispatch-only — a commit writes the row buckets in place, so the gather is enqueued before the lock drops; the fetch happens off-lock in the completion
                "forward.gather",
                lambda: to_host(_MAXSIM(
                    query_tokens, mask_dev, self._tok, self._scales, self._nvalid,
                    slots_dev, k_out, self.quant == "int8",
                )),
                deadline=deadline,
                policy=_GATHER_RETRY,
            )
            self.stats["gathers"] += 1
            self.stats["gather_candidates"] += n_cand
            self.stats["gather_missing"] += n_missing
        record_dispatch("rerank_maxsim")
        observe.record_occupancy("forward_gather", n_cand, B * Kc)

        def complete():
            inject.fire("forward.gather.fetch", deadline=deadline)
            if deadline is not None:
                deadline.check("forward.gather.fetch")
            arr = fetch()[:nq]
            record_fetch("rerank_maxsim")
            scores = np.ascontiguousarray(arr[:, :k_out]).view(np.float32)
            return scores, arr[:, k_out:]

        return complete, missing

    # -- flight-recorder provider ---------------------------------------------
    def observe_metrics(self):
        """Scrape-time ``pathway_forward_*`` samples: residency gauges
        from live state, ingest and gather counters from ``stats``
        (lock-free reads)."""
        labels = {"index": str(self._observe_id)}
        n = len(self._slot_of_key)
        yield ("gauge", "pathway_forward_docs", labels, n)
        yield ("gauge", "pathway_forward_rows_resident", labels, n * self.tokens_per_doc)
        yield ("gauge", "pathway_forward_tokens_stored", labels, self._tokens_stored)
        yield ("gauge", "pathway_forward_hbm_bytes", labels, self.hbm_bytes())
        yield ("gauge", "pathway_forward_compression_ratio", labels, self.compression_ratio())
        if self._quant_abs_err is not None:
            yield ("gauge", "pathway_forward_quant_abs_err", labels, self._quant_abs_err)
        for kind in ("absorbs", "docs_absorbed", "gathers"):
            yield ("counter", f"pathway_forward_{kind}_total", labels, self.stats[kind])
        for site in ("absorb", "upload"):
            yield ("counter", "pathway_forward_absorb_failures_total", {**labels, "site": site},
                   self.stats[f"{site}_failures"])
        for kind in ("candidates", "missing"):
            yield ("counter", "pathway_forward_gather_rows_total", {**labels, "kind": kind},
                   self.stats[f"gather_{kind}"])


class _ShardForward(ForwardIndex):
    """One shard-resident forward partition: the row buckets live on the
    shard's ``device``.  The absorb plan (encode + pool + quantize) runs
    on the encoder's device; only its compressed rows move to the shard,
    at commit."""

    def __init__(self, encoder, device, **kwargs: Any):
        super().__init__(encoder, **kwargs)
        self.device = torch.device(device)

    def _commit_absorb(self, plan: Dict[str, Any]) -> int:
        plan = dict(plan)
        for field in ("q", "scales", "nvalid"):
            plan[field] = plan[field].to(self.device)
        return super()._commit_absorb(plan)


class ShardedForwardIndex:
    """Document-sharded forward index over a ``ShardGroup`` (the sharded
    IVF index's, so a document's token rows live on the shard that owns
    its postings).  ``add`` routes each document to its owning shard;
    ``gather_submit`` keeps ``ForwardIndex``'s contract, so
    ``LateInteractionStage`` takes it unchanged: each shard scores only
    the candidates it owns into a ``[B, Kc]`` table (``-inf`` elsewhere,
    profiler label ``forward.table``), the tables move to the merge
    device, and one elementwise max + top-k (``forward.table_merge``)
    packs the result, bit-identical to one unsharded index holding every
    row.  One logical dispatch of ``shards + 1`` launches and one fetch.

    Faults: ``shard.absorb`` / ``shard.absorb.<s>`` drop one shard's
    documents from one ``add`` (counted on
    ``pathway_serve_shard_ingest_drops_total{tier="forward"}``); the
    table launches retry under ``forward.gather``, the merge under
    ``shard.merge``."""

    def __init__(
        self,
        encoder,
        group=None,
        n_shards: Optional[int] = None,
        devices: Optional[Sequence] = None,
        tokens_per_doc: Optional[int] = None,
        quant: Optional[str] = None,
        initial_capacity: int = 1024,
    ):
        from ..parallel.shards import ShardGroup

        self.group = group or ShardGroup(n_shards=n_shards, devices=devices)
        self.encoder = encoder
        self.tokens_per_doc = int(tokens_per_doc or forward_tokens_per_doc())
        self.quant = quant if quant in ("int8", "none") else forward_quant_mode()
        self.dimension = int(encoder.config.d_model)
        self._lock = threading.Lock()
        self._gen_base = 0
        self.shards: List[_ShardForward] = [
            _ShardForward(encoder, self.group.device(s), tokens_per_doc=self.tokens_per_doc, quant=self.quant,
                          initial_capacity=initial_capacity)
            for s in range(self.group.n_shards)
        ]
        self._tripwire = RecompileTripwire("ShardedForwardIndex")
        self.stats = {"route_drops": 0, "route_drop_docs": 0}
        self._observe_id = observe.next_id()
        observe.register_provider(self)

    def __len__(self) -> int:
        return sum(len(c) for c in self.shards)

    def __contains__(self, key: int) -> bool:
        return int(key) in self.shards[self.group.owner_of(key)]

    @property
    def generation(self) -> int:
        return self._gen_base + sum(c.generation for c in self.shards)

    def hbm_bytes(self) -> int:
        return sum(c.hbm_bytes() for c in self.shards)

    def add(self, keys: Sequence[int], texts: Sequence[str]) -> int:
        """Route each document to its owning shard; returns the number
        committed.  A faulted shard drops its documents from this call
        only; the others commit theirs."""
        keys = [int(k) for k in keys]
        committed = 0
        for s, rows in sorted(self.group.route(keys).items()):
            try:
                inject.fire(f"shard.absorb.{s}")
                inject.fire("shard.absorb")
                committed += self.shards[s].add([keys[i] for i in rows], [texts[i] for i in rows])
            except Exception as exc:  # noqa: BLE001 - degrade, never die: counted and logged
                with self._lock:
                    self.stats["route_drops"] += 1
                    self.stats["route_drop_docs"] += len(rows)
                    self._gen_base += 1
                log_once(f"shard.absorb.forward:{type(exc).__name__}",
                         "sharded forward ingest to shard %d failed (%r); its documents stay out of the "
                         "forward index only", s, exc)
        return committed

    def remove(self, keys: Sequence[int]) -> None:
        keys = [int(k) for k in keys]
        for s, rows in sorted(self.group.route(keys).items()):
            self.shards[s].remove([keys[i] for i in rows])

    @torch.no_grad()
    def gather_submit(
        self,
        query_tokens: Optional[torch.Tensor],
        query_mask: np.ndarray,
        cand_keys: List[List[int]],
        k_out: int,
        deadline=None,
        width: Optional[int] = None,
    ):
        """``ForwardIndex.gather_submit``'s contract over the shards: a
        candidate resident on no shard is ``missing`` (the caller backfills
        it from the previous stage).  Raises ``ForwardUnavailable`` when no
        candidate is resident anywhere."""
        if query_tokens is None:
            raise ForwardUnavailable("no query token states from stage 1")
        B, Lq = int(query_tokens.shape[0]), int(query_tokens.shape[1])
        nq = len(cand_keys)
        longest = max((len(row) for row in cand_keys), default=0)
        Kc = max(int(width) if width else longest, longest, 1)
        k_out = min(int(k_out), Kc)
        if deadline is not None:
            deadline.check("forward.gather")
        merge_dev = query_tokens.device
        mask_dev = upload(np.asarray(query_mask, np.float32), merge_dev)
        quant = self.quant == "int8"
        tables: List[torch.Tensor] = []
        owned = np.zeros((B, Kc), bool)
        n_cand = sum(len(row) for row in cand_keys)
        for child in self.shards:
            with child._lock:
                if child._tok is None or not child._slot_of_key:
                    continue
                slots = np.full((B, Kc), -1, np.int32)
                for qi, row in enumerate(cand_keys):
                    for j, key in enumerate(row[:Kc]):
                        slot = child._slot_of_key.get(int(key))
                        if slot is not None:
                            slots[qi, j] = slot
                            owned[qi, j] = True
                if not (slots >= 0).any():
                    continue
                dev = child.device
                if dev.type == "cuda":
                    child._serve_stream = torch.cuda.current_stream(dev)
                self._tripwire.observe(("table", B, Lq, Kc, child._capacity, self.tokens_per_doc))
                qtok_s, mask_s, slots_dev = query_tokens.to(dev), mask_dev.to(dev), upload(slots, dev)  # pathway: allow(lock-discipline): device→device scatter of the UNFETCHED stage-1 query token states — peer copies enqueued like a dispatch, not a host round trip
                # launched under the child's lock: a commit writes its rows in place
                out = retry_call(  # pathway: allow(lock-discipline): dispatch-only — the shard's commit writes its rows in place, so the launch is enqueued before the lock drops (fetch after the merge)
                    "forward.gather",
                    lambda: _TABLE(qtok_s, mask_s, child._tok, child._scales, child._nvalid, slots_dev, quant),
                    deadline=deadline,
                    policy=_GATHER_RETRY,
                )
                child.stats["gathers"] += 1
            tables.append(out)
        missing = [[j for j in range(len(row[:Kc])) if not owned[qi, j]] for qi, row in enumerate(cand_keys)]
        if not tables or sum(len(m) for m in missing) >= n_cand:
            raise ForwardUnavailable("no candidate is resident on any shard")
        moved = [t.to(merge_dev) for t in tables]
        self._tripwire.observe(("merge", len(moved), B, Kc, k_out))
        fetch = retry_call(
            "shard.merge", lambda: to_host(_TABLE_MERGE(moved, k_out)), deadline=deadline, policy=_GATHER_RETRY
        )
        record_dispatch("rerank_maxsim", shards=len(tables) + 1)
        observe.record_occupancy("forward_gather", n_cand, B * Kc)

        def complete():
            inject.fire("forward.gather.fetch", deadline=deadline)
            if deadline is not None:
                deadline.check("forward.gather.fetch")
            arr = fetch()[:nq]
            record_fetch("rerank_maxsim")
            scores = np.ascontiguousarray(arr[:, :k_out]).view(np.float32)
            return scores, arr[:, k_out:]

        return complete, missing

    def observe_metrics(self):
        labels = {"index": str(self._observe_id)}
        yield ("counter", "pathway_serve_shard_ingest_drops_total", {**labels, "tier": "forward"},
               self.stats["route_drops"])
        for s, child in enumerate(self.shards):
            yield ("gauge", "pathway_serve_shard_forward_docs", {**labels, "shard": str(s)}, len(child))


# the device steps under the reference's profiler labels
_POOL = profile.wrap("forward.pool", pool_token_states)
_AUDIT = profile.wrap("forward.audit", audit_quant_error)
_MAXSIM = profile.wrap("forward.maxsim", maxsim_topk)
_TABLE = profile.wrap("forward.table", maxsim_table)
_TABLE_MERGE = profile.wrap("forward.table_merge", merge_tables)
