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

Not ported yet: the embedding cache, the sharded path, query
token-state export, and the observe/trace/retry layers.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..robust import ServeResult
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

    def __init__(self, encoder, index, k: int = 10):
        self.encoder = encoder
        self.index = index
        self.k = k
        self._lock = threading.Lock()
        self._ivf = hasattr(index, "_centroids")

    def index_generation(self) -> int:
        return int(getattr(self.index, "generation", 0))

    def _embed(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """Trunk forward + metric normalization of a padded batch:
        ``z [B, d]`` f32 on the index's device."""
        dev = self.encoder.device
        ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
        if dev.type == "cuda":
            # pinned sources: a pageable upload would wait for the batches
            # already queued on the stream, serializing pipelined submits
            ids_t, mask_t = ids_t.pin_memory(), mask_t.pin_memory()
        z = self.encoder.module(
            ids_t.to(dev, non_blocking=True), mask_t.to(dev, non_blocking=True)
        )
        if self.index.metric == "cos":
            z = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True), min=1e-9)
        return z

    @staticmethod
    def _to_host(packed: torch.Tensor):
        """Start the device -> pinned host copy; returns a zero-arg
        callable that waits for it and returns the numpy array."""
        if packed.device.type != "cuda":
            arr = packed.numpy()
            return lambda: arr
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

        def wait():
            done.synchronize()
            return host.numpy()

        return wait

    @torch.no_grad()
    def submit(self, texts: Sequence[str], k: Optional[int] = None):
        """Dispatch one serve batch WITHOUT waiting for the result; returns
        a zero-arg callable that completes it."""
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
        if self._ivf:
            return self._submit_ivf(texts, ids, mask, n_real, k)
        return self._submit_exact(texts, ids, mask, n_real, k)

    def _submit_exact(self, texts, ids, mask, n_real: int, k: int):
        index = self.index
        with index._lock, self._lock:
            n_items = len(index.key_to_slot)
            gen0 = self.index_generation()
            if n_items == 0:
                empty = ServeResult([[] for _ in texts], meta={"index_generation": gen0})
                return lambda: empty
            k_eff = min(k, n_items)
            z = self._embed(ids, mask)
            s, i = index.score_topk(z, k_eff)
            # winners' keys gathered on the device from the int32 planes:
            # completion needs no host slot -> key map
            hi = index._keys_hi[i]
            lo = index._keys_lo[i]
            fetch = self._to_host(torch.cat([_f32_bits(s), hi, lo], dim=1))

        def complete() -> List[List[Tuple[int, float]]]:
            arr = fetch()[:n_real]
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

        return complete

    def _submit_ivf(self, texts, ids, mask, n_real: int, k: int):
        index = self.index
        with index._lock, self._lock:
            gen0 = self.index_generation()
            if len(index) == 0:
                empty = ServeResult([[] for _ in texts], meta={"index_generation": gen0})
                return lambda: empty
            if index._slabs is None:
                index.build()  # first build only: nothing to serve from yet
            k_eff = min(k, len(index))
            tail, tail_dev = index._tail_snapshot_device()
            z = self._embed(ids, mask)
            s, slots, t_s, t_i = index._search_device(
                z, k_eff, index.probe_count(), tail_dev, serve=True
            )
            k_main, k_tail = s.shape[1], t_s.shape[1]
            fetch = self._to_host(
                torch.cat([_f32_bits(s), slots, _f32_bits(t_s), t_i], dim=1)
            )
            keys_by_slot = index._keys_by_slot  # dispatch-time snapshot

        def complete() -> List[List[Tuple[int, float]]]:
            arr = fetch()[:n_real]
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

        return complete

    def __call__(
        self, texts: Sequence[str], k: Optional[int] = None
    ) -> List[List[Tuple[int, float]]]:
        return self.submit(texts, k)()
