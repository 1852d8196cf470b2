"""Fused serving path: text -> embedding -> top-k (counterpart of
``pathway_tpu/ops/serving.py`` ``FusedEncodeSearch``, single device).

``submit`` tokenizes on the host, runs the encoder trunk, normalizes,
runs stage 1 (exact: full matmul + top-k + on-device key gather; IVF:
centroid probe + slab rescore kernel + top-k + exact tail scan), packs
the winners into ONE int32 tensor, and starts a non-blocking copy of it
into pinned host memory followed by a CUDA event — it returns without
waiting for the device.  The handle it returns completes the batch: it
waits on the event and maps the packed columns to keys on the host.

Packed layouts (as in the reference, so the completion code is shared):

- exact: ``[s_bits | keys_hi | keys_lo]``, ``k`` columns each;
- IVF: ``[s_bits | slots | t_bits | t_idx]`` with ``k_main`` resident
  and ``k_tail`` tail columns; ``slots`` is -1 where the score is not
  finite, whatever order ``topk`` gave tied pad scores.

Tier-1 embedding cache (``embed_cache``, opt-in through
``PATHWAY_CACHE_EMBED``): cached ``[d]`` rows of known queries are
stacked with ONE bucketed encode of the misses (``_cached_embeddings``)
and the search runs from that ``z`` (the reference's ``from_z`` twins);
the group is booked as one logical dispatch of 2 launches (1 when every
row hit).  It is off while a late-interaction stage needs the query
token states.

Query token-state export (``export_query_tokens``, switched on by a
late-interaction rerank stage): the trunk runs once with its pool
skipped, the embedding is pooled from those hidden states with
the module's own masked mean pool (so it is bit-identical to the
non-export path), and the normalized per-token states ride the handle
as ``query_tokens`` on the device, never fetched here, beside
``query_mask`` on the host.

Each submit books one dispatch and each completion one fetch
(``ops/dispatch_counter.py``).  The launch retries under the site
``serve.dispatch`` (exact) or ``ivf.dispatch`` (IVF) with a short
schedule, because it runs under the index and serve locks; the
completion fires ``serve.fetch``.  An IVF serve whose exact-tail upload
failed past its retries (``IvfKnnIndex._tail_snapshot_device``) returns
the resident rows flagged ``tail_skipped``.  Stage timings land on
``pathway_serve_stage_seconds{stage}`` and, with the same clock reads, on
the active trace (``stage1.dispatch`` / ``stage1.fetch`` /
``stage1.postprocess``).  The device steps are attributed by the
profiler under the reference's labels (``serve.fused_exact`` /
``serve.exact_search``, ``serve.fused_ivf`` / ``serve.ivf_search`` for
the search-only twins, ``serve.encode`` for the cache misses' encode),
their shape keys go through the ``FusedEncodeSearch`` tripwire, and an
IVF serve's dispatch-time ``keys_by_slot`` is a snapshot the in-place
absorb must never write (``ops/donation_guard.py``).  The sharded path
and its ``serve.shard_*`` labels are not ported yet.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import observe
from ..cache import embedding_cache_from_env
from ..device import to_host, upload
from ..models.transformer import TransformerEncoder, masked_mean_pool, normalized_token_states
from ..observe import profile, trace
from ..robust import TAIL_SKIPPED, Deadline, RetryPolicy, ServeResult, inject, retry_call
from . import donation_guard
from .dispatch_counter import record_dispatch, record_fetch
from .ivf import merge_stage1_row
from .knn import _bucket
from .recompile_guard import RecompileTripwire

__all__ = ["FusedEncodeSearch"]

# the stage-1 launch runs under the index and serve locks: its backoff
# sleeps stall every concurrent add and serve, so the budget stays in
# the low milliseconds (the reference's IVF dispatch schedule)
_LOCKED_DISPATCH_RETRY = RetryPolicy(attempts=3, base_delay_s=0.002, max_delay_s=0.02)

_H_TOKENIZE = observe.histogram("pathway_serve_stage_seconds", stage="tokenize_pack")
_H_STAGE1 = observe.histogram("pathway_serve_stage_seconds", stage="stage1_rtt")
_H_POST = observe.histogram("pathway_serve_stage_seconds", stage="postprocess")


def _f32_bits(s: torch.Tensor) -> torch.Tensor:
    """Bitcast f32 scores into int32 lanes (``view`` needs a contiguous
    tensor)."""
    return s.contiguous().view(torch.int32)


class FusedEncodeSearch:
    """Callable serving path over a ``SentenceEncoder`` plus either a
    ``DeviceKnnIndex`` (exact) or an ``IvfKnnIndex`` (approximate).
    ``embed_cache``: an ``EmbeddingCache``, ``None``, or ``"env"`` (the
    ``cache.embed`` knob)."""

    def __init__(self, encoder, index, k: int = 10, export_query_tokens: bool = False, embed_cache: Any = "env"):
        self.encoder = encoder
        self.index = index
        self.k = k
        self.export_query_tokens = bool(export_query_tokens)
        self.embed_cache = embedding_cache_from_env() if embed_cache == "env" else embed_cache
        self._lock = threading.Lock()
        self._ivf = hasattr(index, "_centroids")
        self._tripwire = RecompileTripwire("FusedEncodeSearch")

    def _exporting(self) -> bool:
        """Query token states ride the handle only over the in-framework
        mean-pooling trunk: an HF module pools inside its forward."""
        module = self.encoder.module
        return self.export_query_tokens and isinstance(module, TransformerEncoder) and module.config.pool == "mean"

    def index_generation(self) -> int:
        return int(getattr(self.index, "generation", 0))

    def _embed(self, ids: np.ndarray, mask: np.ndarray):
        """Trunk forward + metric normalization of a padded batch:
        ``(z [B, d] f32, qtok [B, L, d] f32 or None)`` on the encoder's
        device; ``qtok`` only while exporting."""
        dev = self.encoder.device
        ids_t, mask_t = upload(ids, dev), upload(mask, dev)
        qtok = None
        if self._exporting():
            hidden = self.encoder.module(ids_t, mask_t, pool="none")
            z = masked_mean_pool(hidden, mask_t)
            qtok = normalized_token_states(hidden, mask_t)
        else:
            z = self.encoder.module(ids_t, mask_t)
        if self.index.metric == "cos":
            z = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True), min=1e-9)
        return z, qtok

    def _cached_embeddings(self, ids: np.ndarray, mask: np.ndarray, n_real: int, deadline=None):
        """Tier-1 lookup for a padded batch (``EmbeddingCache.encode_rows``
        in the ``serve:<metric>`` space, misses retried under
        ``serve.dispatch``), with zero pad rows up to ``[B, d]``.
        Returns ``(z, encoded)``."""
        B = ids.shape[0]
        z, misses = self.embed_cache.encode_rows(
            ids, mask, n_real, lambda i, m: _ENCODE(self, i, m)[0], _bucket, space=f"serve:{self.index.metric}",
            site="serve.dispatch", deadline=deadline,
        )
        if B > n_real:
            z = torch.cat([z, z.new_zeros((B - n_real, z.shape[1]))])
        return z, bool(misses)

    @torch.no_grad()
    def submit(self, texts: Sequence[str], k: Optional[int] = None, deadline: Optional[Deadline] = None):
        """Dispatch one serve batch WITHOUT waiting for the result; returns
        a zero-arg callable that completes it.  ``deadline`` bounds the
        dispatch and its retries (``DeadlineExceeded`` goes to the
        caller)."""
        k = k or self.k
        t_start = time.perf_counter_ns()
        if not texts:
            return lambda: ServeResult()
        # host prep off the locks: tokenize, then pad to the query bucket
        # with all-zero rows (fully masked: a finite uniform softmax)
        ids, mask = self.encoder.tokenizer.encode_batch(texts)
        n_real = ids.shape[0]
        b = _bucket(n_real)
        if b > n_real:
            pad = np.zeros((b - n_real, ids.shape[1]), ids.dtype)
            ids = np.concatenate([ids, pad])
            mask = np.concatenate([mask, pad])
        if deadline is not None:
            deadline.check("serve.dispatch")
        z, launches = None, 1
        if self.embed_cache is not None and not self._exporting():
            z, encoded = self._cached_embeddings(ids, mask, n_real, deadline)
            launches = 2 if encoded else 1
        submit = self._submit_ivf if self._ivf else self._submit_exact
        return submit(texts, ids, mask, n_real, k, t_start, deadline, z, launches)

    @staticmethod
    def _handle(complete, qtok, mask, n_real: int):
        """Attach the late-interaction inputs to a completion: the query
        token states stay on the device, the mask on the host."""
        complete.query_tokens = qtok
        complete.query_mask = mask
        complete.n_queries = n_real
        return complete

    @staticmethod
    def _note_dispatch(kind: str, t_start: int, n_real: int, batch: int, **attrs) -> int:
        t_dispatch = time.perf_counter_ns()
        _H_TOKENIZE.observe_ns(t_dispatch - t_start)
        observe.record_occupancy("stage1", n_real, batch)
        t = trace.current()
        if t is not None:
            t.add_span("stage1.dispatch", t_start, t_dispatch, exemplar=_H_TOKENIZE, kind=kind,
                       queries=n_real, batch=batch, **attrs)
        return t_dispatch

    @staticmethod
    def _fetch(fetch, tag: str, kind: str, n_real: int, t_dispatch: int, deadline):
        """Wait for the packed result (after the ``serve.fetch`` site);
        returns ``(arr, t_fetch, trace)``."""
        inject.fire("serve.fetch", deadline=deadline)
        arr = fetch()[:n_real]
        record_fetch(tag)
        t_fetch = time.perf_counter_ns()
        _H_STAGE1.observe_ns(t_fetch - t_dispatch)
        t = trace.current()
        if t is not None:
            t.add_span("stage1.fetch", t_dispatch, t_fetch, exemplar=_H_STAGE1, kind=kind)
        return arr, t_fetch, t

    @staticmethod
    def _note_post(t, t_fetch: int) -> None:
        t_post = time.perf_counter_ns()
        _H_POST.observe_ns(t_post - t_fetch)
        if t is not None:
            t.add_span("stage1.postprocess", t_fetch, t_post)

    def _submit_exact(self, texts, ids, mask, n_real: int, k: int, t_start: int, deadline, z, launches: int):
        index = self.index
        with index._lock, self._lock:
            n_items = len(index.key_to_slot)
            gen0 = self.index_generation()
            if n_items == 0:
                empty = ServeResult([[] for _ in texts], meta={"index_generation": gen0})
                return self._handle(lambda: empty, None, mask, n_real)
            k_eff = min(k, n_items)
            self._tripwire.observe((ids.shape[0], ids.shape[1], k, index.capacity, self._exporting(), z is not None))
            step = _FUSED_EXACT if z is None else _EXACT_SEARCH

            def launch():
                packed, qtok = step(self, z, ids, mask, k_eff)
                return to_host(packed), qtok

            fetch, qtok = retry_call(
                "serve.dispatch", launch, deadline=deadline, policy=_LOCKED_DISPATCH_RETRY
            )
        record_dispatch("serve_exact", shards=launches)
        t_dispatch = self._note_dispatch("exact", t_start, n_real, ids.shape[0])

        def complete() -> List[List[Tuple[int, float]]]:
            arr, t_fetch, t = self._fetch(fetch, "serve_exact", "exact", n_real, t_dispatch, deadline)
            scores = np.ascontiguousarray(arr[:, :k_eff]).view(np.float32)
            ints = np.ascontiguousarray(arr[:, k_eff:]).view(np.uint32)
            keys = (ints[:, :k_eff].astype(np.uint64) << np.uint64(32)) | ints[:, k_eff:].astype(np.uint64)
            results = [
                [(int(keys[qi, j]), float(scores[qi, j])) for j in range(k_eff) if np.isfinite(scores[qi, j])]
                for qi in range(len(texts))
            ]
            self._note_post(t, t_fetch)
            return ServeResult(results, meta={"index_generation": gen0})

        return self._handle(complete, qtok, mask, n_real)

    def _submit_ivf(self, texts, ids, mask, n_real: int, k: int, t_start: int, deadline, z, launches: int):
        index = self.index
        with index._lock, self._lock:
            gen0 = self.index_generation()
            if len(index) == 0:
                empty = ServeResult([[] for _ in texts], meta={"index_generation": gen0})
                return self._handle(lambda: empty, None, mask, n_real)
            if index._slabs is None:
                index.build()  # first build only: nothing to serve from yet
            else:
                index.maybe_retrain_async()
            k_eff = min(k, len(index))
            tail, tail_dev = index._tail_snapshot_device()
            # the ladder's tail rung: counted by the snapshot itself
            tail_skipped = index.tail_degraded
            p = index.probe_count()
            self._tripwire.observe((
                "ivf", ids.shape[0], ids.shape[1], k, p, index.tail_bucket(len(tail)), index._slabs.shape[0],
                index._centroids.shape[0], index._M_pad, self._exporting(), z is not None,
            ))
            step = _FUSED_IVF if z is None else _IVF_SEARCH

            def launch():
                packed, qtok, k_main, k_tail = step(self, z, ids, mask, k_eff, p, tail_dev)
                return to_host(packed), qtok, k_main, k_tail

            fetch, qtok, k_main, k_tail = retry_call(
                "ivf.dispatch", launch, deadline=deadline, policy=_LOCKED_DISPATCH_RETRY
            )
            keys_by_slot = index._keys_by_slot  # dispatch-time snapshot
            donation_guard.stamp("ivf.serve", keys_by_slot)
        record_dispatch("serve_ivf", shards=launches)
        t_dispatch = self._note_dispatch("ivf", t_start, n_real, ids.shape[0], tail=len(tail))

        def complete() -> List[List[Tuple[int, float]]]:
            arr, t_fetch, t = self._fetch(fetch, "serve_ivf", "ivf", n_real, t_dispatch, deadline)
            slot_keys = keys_by_slot
            if not donation_guard.guard("ivf.serve", slot_keys):
                slot_keys = np.array(slot_keys)  # production: no further write reaches this merge
            scores = np.ascontiguousarray(arr[:, :k_main]).view(np.float32)
            slot_cols = arr[:, k_main : 2 * k_main]
            t_scores = np.ascontiguousarray(arr[:, 2 * k_main : 2 * k_main + k_tail]).view(np.float32)
            t_idx = arr[:, 2 * k_main + k_tail :]
            results = [
                merge_stage1_row(scores[qi], slot_cols[qi], t_scores[qi], t_idx[qi], slot_keys, tail, k)
                for qi in range(len(texts))
            ]
            self._note_post(t, t_fetch)
            return ServeResult(
                results, degraded=(TAIL_SKIPPED,) if tail_skipped else (), meta={"index_generation": gen0}
            )

        return self._handle(complete, qtok, mask, n_real)

    def _exact_step(self, z, ids, mask, k_eff: int):
        """Exact stage 1 on the device: ``(packed [B, 3k] int32, qtok)``;
        the trunk runs here unless ``z`` (the search-only twin) is given."""
        index = self.index
        zz, qtok = (z, None) if z is not None else self._embed(ids, mask)
        s, i = index.score_topk(zz, k_eff)
        # winners' keys gathered on the device from the int32 planes:
        # completion needs no host slot -> key map
        packed = torch.cat([_f32_bits(s), index._keys_hi[i], index._keys_lo[i]], dim=1)
        return packed, qtok

    def _ivf_step(self, z, ids, mask, k_eff: int, p: int, tail_dev):
        """IVF stage 1 on the device: ``(packed, qtok, k_main, k_tail)``."""
        zz, qtok = (z, None) if z is not None else self._embed(ids, mask)
        s, slots, t_s, t_i = self.index._search_device(zz, k_eff, p, tail_dev, serve=True)
        packed = torch.cat([_f32_bits(s), slots, _f32_bits(t_s), t_i], dim=1)
        return packed, qtok, s.shape[1], t_s.shape[1]

    def __call__(
        self, texts: Sequence[str], k: Optional[int] = None, deadline: Optional[Deadline] = None
    ) -> List[List[Tuple[int, float]]]:
        return self.submit(texts, k, deadline=deadline)()


# the device steps under the reference's profiler labels
_FUSED_EXACT = profile.wrap("serve.fused_exact", lambda fes, *a: fes._exact_step(*a))
_EXACT_SEARCH = profile.wrap("serve.exact_search", lambda fes, *a: fes._exact_step(*a))
_FUSED_IVF = profile.wrap("serve.fused_ivf", lambda fes, *a: fes._ivf_step(*a))
_IVF_SEARCH = profile.wrap("serve.ivf_search", lambda fes, *a: fes._ivf_step(*a))
_ENCODE = profile.wrap("serve.encode", lambda fes, *a: fes._embed(*a))
