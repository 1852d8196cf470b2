"""Device-resident incremental KNN index, single device (counterpart of
``pathway_tpu/ops/knn.py``: ``normalize_metric``, the query buckets and
``DeviceKnnIndex`` without a mesh, with the filtered search surface:
``search_oversampled``, ``scores_to_distances`` and the shared
``oversampled_filtered_search`` loop).

The matrix lives on the device as ``[capacity, d]`` with a validity
plane and the slot -> key map as two int32 planes (``keys_hi``,
``keys_lo``), so the fused serve path gathers the winners' keys on the
device.  Add and remove are slot-allocator updates (free list, capacity
doubling) applied as in-place ``index_copy_`` scatters — the reference
rebuilds its arrays functionally; nothing here holds an old reference.
The index reports its bytes to the device-memory ledger (``hbm_bytes``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..observe import hbm

__all__ = ["DeviceKnnIndex", "normalize_metric", "oversampled_filtered_search"]


def normalize_metric(metric) -> str:
    """Accepts "cos"/"l2sq"/"dot", metric-kind enums, or any casing;
    anything unrecognised raises instead of silently mis-scoring."""
    value = getattr(metric, "value", metric)
    value = str(value).lower().replace("cosine", "cos")
    if value in ("ip", "inner_product"):
        value = "dot"
    if value not in ("cos", "l2sq", "dot"):
        raise ValueError(f"unknown KNN metric {metric!r}")
    return value


_QUERY_BUCKETS = (1, 4, 16, 64, 256, 1024)


def _bucket(n: int) -> int:
    for b in _QUERY_BUCKETS:
        if n <= b:
            return b
    return ((n + 1023) // 1024) * 1024


def _keys_to_planes(keys: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """uint64 keys -> (hi, lo) int32 bit planes."""
    keys64 = np.fromiter((int(k) for k in keys), dtype=np.uint64, count=len(keys))
    hi = (keys64 >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (keys64 & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return hi, lo


class DeviceKnnIndex:
    """Incrementally maintained dense KNN index on one device.

    metric: "cos" (vectors L2-normalised at insert; score = cosine sim),
    "l2sq" (score ranks as -squared distance) or "dot".
    """

    def __init__(
        self,
        dimension: int,
        metric: str = "cos",
        initial_capacity: int = 1024,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        self.dimension = dimension
        self.metric = normalize_metric(metric)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        cap = self._round_capacity(max(initial_capacity, 8))
        self.capacity = cap
        self._matrix = torch.zeros((cap, dimension), dtype=dtype, device=self.device)
        self._valid = torch.zeros(cap, dtype=torch.bool, device=self.device)
        self._keys_hi = torch.zeros(cap, dtype=torch.int32, device=self.device)
        self._keys_lo = torch.zeros(cap, dtype=torch.int32, device=self.device)
        self.key_to_slot: Dict[int, int] = {}
        self.slot_to_key = np.zeros(cap, dtype=np.uint64)
        self._free: List[int] = list(range(cap - 1, -1, -1))
        # result-visibility generation: bumped on every mutation that can
        # change what a serve returns
        self.generation = 0
        hbm.track("knn", self)

    def hbm_bytes(self) -> Dict[str, int]:
        """Device bytes: the allocated-capacity matrix and the slot
        planes (validity, key halves)."""
        planes = sum(t.numel() * t.element_size() for t in (self._valid, self._keys_hi, self._keys_lo))
        return {"matrix": self._matrix.numel() * self._matrix.element_size(), "planes": planes}

    @staticmethod
    def _round_capacity(cap: int) -> int:
        return ((cap + 7) // 8) * 8

    def __len__(self) -> int:
        return len(self.key_to_slot)

    # -- growth ------------------------------------------------------------
    def _grow(self, needed: int) -> None:
        old = self.capacity
        new = self._round_capacity(max(old * 2, old + needed))

        def grown(t: torch.Tensor) -> torch.Tensor:
            out = torch.zeros((new,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
            out[:old] = t
            return out

        self._matrix = grown(self._matrix)
        self._valid = grown(self._valid)
        self._keys_hi = grown(self._keys_hi)
        self._keys_lo = grown(self._keys_lo)
        self.slot_to_key = np.concatenate(
            [self.slot_to_key, np.zeros(new - old, dtype=np.uint64)]
        )
        self._free.extend(range(new - 1, old - 1, -1))
        self.capacity = new

    # -- mutation ----------------------------------------------------------
    def _claim_slots(self, keys: Sequence[int]) -> np.ndarray:
        """Upsert bookkeeping (caller holds the lock): frees existing keys,
        grows if needed, and binds each key to a fresh slot."""
        existing = [k for k in keys if int(k) in self.key_to_slot]
        if existing:
            self.remove(existing)
        if len(self._free) < len(keys):
            self._grow(len(keys) - len(self._free))
        slots = np.array([self._free.pop() for _ in keys], dtype=np.int64)
        for key, slot in zip(keys, slots):
            self.key_to_slot[int(key)] = int(slot)
            self.slot_to_key[slot] = int(key)
        return slots

    def add(self, keys: Sequence[int], vectors) -> None:
        """Add rows from the host (numpy or anything array-like)."""
        if len(keys) == 0:
            return
        vectors = np.asarray(vectors, dtype=np.float32).reshape(len(keys), self.dimension)
        self.add_from_device(keys, torch.from_numpy(vectors).to(self.device))

    def add_from_device(self, keys: Sequence[int], vectors: torch.Tensor) -> None:
        """Ingest rows that already live on the device (e.g. encoder
        output): normalisation happens on the device, nothing is fetched."""
        if len(keys) == 0:
            return
        vectors = vectors.reshape(len(keys), self.dimension).to(self.device)
        if self.metric == "cos":
            v = vectors.float()
            norms = torch.linalg.vector_norm(v, dim=1, keepdim=True)
            vectors = v / torch.where(norms == 0, torch.ones_like(norms), norms)
        with self._lock:
            slots = self._claim_slots(keys)
            hi, lo = _keys_to_planes(keys)
            self._scatter(slots, vectors, True, hi, lo)
            self.generation += 1

    def remove(self, keys: Sequence[int]) -> None:
        with self._lock:
            slots = []
            for key in keys:
                slot = self.key_to_slot.pop(int(key), None)
                if slot is not None:
                    slots.append(slot)
                    self._free.append(slot)
            if not slots:
                return
            rows = torch.zeros((len(slots), self.dimension), device=self.device)
            self._scatter(np.asarray(slots, np.int64), rows, False)
            self.generation += 1

    def _scatter(self, slots, vectors, valid: bool, hi=None, lo=None) -> None:
        """In-place row scatter; ``hi``/``lo`` (add path) also update the
        key planes — removals skip them, the cleared valid flag masks
        stale keys."""
        idx = torch.from_numpy(np.asarray(slots, np.int64)).to(self.device)
        self._matrix.index_copy_(0, idx, vectors.to(self.dtype))
        self._valid[idx] = valid
        if hi is not None:
            self._keys_hi.index_copy_(0, idx, torch.from_numpy(hi).to(self.device))
            self._keys_lo.index_copy_(0, idx, torch.from_numpy(lo).to(self.device))

    # -- search ------------------------------------------------------------
    def score_topk(self, q: torch.Tensor, k: int):
        """Dense scores of ``q [B, d]`` against the matrix + top-k:
        ``(scores [B, k] f32, slots [B, k] int64)``; invalid slots score
        ``-inf``.  "l2sq" ranks by 2 q.x - ||x||^2.  Products of a bf16
        matrix accumulate in f32, as the reference's
        ``preferred_element_type`` does (through an f32 copy of the
        matrix)."""
        m = self._matrix
        scores = q.to(m.dtype).float() @ m.float().t()
        if self.metric == "l2sq":
            scores = 2 * scores - (m.float() * m.float()).sum(dim=1)[None, :]
        scores = scores.masked_fill(~self._valid[None, :], float("-inf"))
        return torch.topk(scores, k, dim=1)

    def search(
        self, queries, k: int
    ) -> List[List[Tuple[int, float]]]:
        """Top-k per query from host queries; returns [(key, score), ...]
        per query row."""
        queries = np.asarray(queries, dtype=np.float32).reshape(-1, self.dimension)
        nq = queries.shape[0]
        with self._lock:
            if nq == 0 or not self.key_to_slot:
                return [[] for _ in range(nq)]
            if self.metric == "cos":
                norms = np.linalg.norm(queries, axis=1)
                queries = queries / np.where(norms == 0, 1.0, norms)[:, None]
            k_eff = min(k, len(self.key_to_slot))
            scores, idx = self.score_topk(torch.from_numpy(queries).to(self.device), k_eff)
            scores = scores.cpu().numpy()
            idx = idx.cpu().numpy()
            out: List[List[Tuple[int, float]]] = []
            for qi in range(nq):
                row: List[Tuple[int, float]] = []
                for j in range(k_eff):
                    s = float(scores[qi, j])
                    if np.isfinite(s):
                        row.append((int(self.slot_to_key[int(idx[qi, j])]), s))
                out.append(row)
            return out

    def search_oversampled(
        self, queries, k: int, accept: Callable[[int], bool], oversample: int = 4, max_rounds: int = 3
    ) -> List[List[Tuple[int, float]]]:
        """Filtered search by over-sampling: fetch ``oversample * k``, drop
        the keys ``accept`` rejects, widen until satisfied or the index is
        exhausted."""
        return oversampled_filtered_search(self, queries, k, accept, oversample=oversample, max_rounds=max_rounds)

    def scores_to_distances(self, scores: np.ndarray, query_norms: np.ndarray) -> np.ndarray:
        """Ranking scores -> distances: ``1 - s`` for "cos", ``||q||^2 - s``
        for "l2sq" (its score is ``2 q.x - ||x||^2``), ``-s`` for "dot"."""
        if self.metric == "cos":
            return 1.0 - scores
        if self.metric == "l2sq":
            return -(scores - query_norms[:, None] ** 2)
        return -scores


def oversampled_filtered_search(
    index, queries, k: int, accept: Callable[[int], bool], oversample: int = 4, max_rounds: int = 3
) -> List[List[Tuple[int, float]]]:
    """The filtered-search loop over any index with ``search(queries, k)``,
    ``__len__`` and ``dimension`` (``DeviceKnnIndex``, ``IvfKnnIndex``):
    fetch ``oversample * k``, keep the accepted keys, and while a full row
    came back short, search again 4x wider, at most ``max_rounds`` times
    or until the width covers the index."""
    nq = np.asarray(queries).reshape(-1, index.dimension).shape[0]
    results: List[List[Tuple[int, float]]] = [[] for _ in range(nq)]
    kk = k * oversample
    for _ in range(max_rounds):
        rows = index.search(queries, kk)
        done = True
        for qi, row in enumerate(rows):
            accepted = [(key, s) for key, s in row if accept(key)]
            results[qi] = accepted[:k]
            if len(accepted) < k and len(row) == kk and len(row) < len(index):
                done = False
        if done or kk >= max(len(index), 1):
            break
        kk *= 4
    return results
