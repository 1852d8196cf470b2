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

Query token-state export (``export_query_tokens``, switched on by a
late-interaction rerank stage): the trunk runs once with its pool
skipped, the embedding is pooled from those hidden states with
the module's own masked mean pool (so it is bit-identical to the
non-export path), and the normalized per-token states ride the handle
as ``query_tokens`` on the device, never fetched here, beside
``query_mask`` on the host.  Each submit books one dispatch and each
completion one fetch (``ops/dispatch_counter.py``).

Not ported yet: the embedding cache, the sharded path, and the
observe/trace/retry layers.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import to_host, upload
from ..models.transformer import masked_mean_pool, normalized_token_states
from ..robust import Deadline, ServeResult
from .dispatch_counter import record_dispatch, record_fetch
from .ivf import merge_stage1_row
from .knn import _bucket

__all__ = ["FusedEncodeSearch"]


def _f32_bits(s: torch.Tensor) -> torch.Tensor:
    """Bitcast f32 scores into int32 lanes (``view`` needs a contiguous
    tensor)."""
    return s.contiguous().view(torch.int32)


class FusedEncodeSearch:
    """Callable serving path over a ``SentenceEncoder`` plus either a
    ``DeviceKnnIndex`` (exact) or an ``IvfKnnIndex`` (approximate)."""

    def __init__(self, encoder, index, k: int = 10, export_query_tokens: bool = False):
        self.encoder = encoder
        self.index = index
        self.k = k
        self.export_query_tokens = bool(export_query_tokens)
        self._lock = threading.Lock()
        self._ivf = hasattr(index, "_centroids")

    def _exporting(self) -> bool:
        module = self.encoder.module
        return self.export_query_tokens and module.config.pool == "mean"

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

    @torch.no_grad()
    def submit(
        self, texts: Sequence[str], k: Optional[int] = None, deadline: Optional[Deadline] = None
    ):
        """Dispatch one serve batch WITHOUT waiting for the result; returns
        a zero-arg callable that completes it.  ``deadline`` is checked
        before the dispatch (``DeadlineExceeded`` goes to the caller)."""
        k = k or self.k
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
        if self._ivf:
            return self._submit_ivf(texts, ids, mask, n_real, k)
        return self._submit_exact(texts, ids, mask, n_real, k)

    @staticmethod
    def _handle(complete, qtok, mask, n_real: int):
        """Attach the late-interaction inputs to a completion: the query
        token states stay on the device, the mask on the host."""
        complete.query_tokens = qtok
        complete.query_mask = mask
        complete.n_queries = n_real
        return complete

    def _submit_exact(self, texts, ids, mask, n_real: int, k: int):
        index = self.index
        with index._lock, self._lock:
            n_items = len(index.key_to_slot)
            gen0 = self.index_generation()
            if n_items == 0:
                empty = ServeResult([[] for _ in texts], meta={"index_generation": gen0})
                return self._handle(lambda: empty, None, mask, n_real)
            k_eff = min(k, n_items)
            z, qtok = self._embed(ids, mask)
            s, i = index.score_topk(z, k_eff)
            # winners' keys gathered on the device from the int32 planes:
            # completion needs no host slot -> key map
            hi = index._keys_hi[i]
            lo = index._keys_lo[i]
            fetch = to_host(torch.cat([_f32_bits(s), hi, lo], dim=1))
        record_dispatch("serve_exact")

        def complete() -> List[List[Tuple[int, float]]]:
            arr = fetch()[:n_real]
            record_fetch("serve_exact")
            scores = np.ascontiguousarray(arr[:, :k_eff]).view(np.float32)
            ints = np.ascontiguousarray(arr[:, k_eff:]).view(np.uint32)
            keys = (ints[:, :k_eff].astype(np.uint64) << np.uint64(32)) | ints[
                :, k_eff:
            ].astype(np.uint64)
            results = [
                [
                    (int(keys[qi, j]), float(scores[qi, j]))
                    for j in range(k_eff)
                    if np.isfinite(scores[qi, j])
                ]
                for qi in range(len(texts))
            ]
            return ServeResult(results, meta={"index_generation": gen0})

        return self._handle(complete, qtok, mask, n_real)

    def _submit_ivf(self, texts, ids, mask, n_real: int, k: int):
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
            z, qtok = self._embed(ids, mask)
            s, slots, t_s, t_i = index._search_device(
                z, k_eff, index.probe_count(), tail_dev, serve=True
            )
            k_main, k_tail = s.shape[1], t_s.shape[1]
            fetch = to_host(torch.cat([_f32_bits(s), slots, _f32_bits(t_s), t_i], dim=1))
            keys_by_slot = index._keys_by_slot  # dispatch-time snapshot
        record_dispatch("serve_ivf")

        def complete() -> List[List[Tuple[int, float]]]:
            arr = fetch()[:n_real]
            record_fetch("serve_ivf")
            scores = np.ascontiguousarray(arr[:, :k_main]).view(np.float32)
            slot_cols = arr[:, k_main : 2 * k_main]
            t_scores = np.ascontiguousarray(
                arr[:, 2 * k_main : 2 * k_main + k_tail]
            ).view(np.float32)
            t_idx = arr[:, 2 * k_main + k_tail :]
            results = [
                merge_stage1_row(
                    scores[qi], slot_cols[qi], t_scores[qi], t_idx[qi],
                    keys_by_slot, tail, k,
                )
                for qi in range(len(texts))
            ]
            return ServeResult(results, meta={"index_generation": gen0})

        return self._handle(complete, qtok, mask, n_real)

    def __call__(
        self, texts: Sequence[str], k: Optional[int] = None
    ) -> List[List[Tuple[int, float]]]:
        return self.submit(texts, k)()
