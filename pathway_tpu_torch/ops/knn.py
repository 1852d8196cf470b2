"""Device-resident incremental KNN index (counterpart of
``pathway_tpu/ops/knn.py``: ``normalize_metric``, the query buckets and
``DeviceKnnIndex`` on one device or row-sharded over a port ``Mesh``,
with the filtered search surface: ``search_oversampled``,
``scores_to_distances`` and the shared ``oversampled_filtered_search``
loop).

The matrix lives on the device as ``[capacity, d]`` with a validity
plane and the slot -> key map as two int32 planes (``keys_hi``,
``keys_lo``), so the fused serve path gathers the winners' keys on the
device.  Add and remove are slot-allocator updates (free list, capacity
doubling) applied as in-place ``index_copy_`` scatters — the reference
rebuilds its arrays functionally; nothing here holds an old reference.
The index reports its bytes to the device-memory ledger (``hbm_bytes``).

Over a mesh across processes (``parallel/mesh.py``) every rank runs the
same ``add`` / ``remove`` / ``search`` calls with the same host data
(SPMD, as the reference's ``tests/dist_worker.py`` drives it): the slot
bookkeeping is replicated, each rank writes and scores only the blocks
it owns, a grow moves a block to the ranks that hold its rows by one
broadcast from its owner, a search's candidates cross ranks by one
``all_gather`` (``ops/topk.sharded_topk``), and the fused serve path's
winners' keys by one more (``keys_of``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..observe import hbm
from ..parallel import distributed
from ..parallel.mesh import global_zeros, is_multiprocess, local_shards
from .topk import sharded_topk

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
    """Incrementally maintained dense KNN index on one device, or row
    blocks over the data axis of a port ``Mesh``.

    metric: "cos" (vectors L2-normalised at insert; score = cosine sim),
    "l2sq" (score ranks as -squared distance) or "dot".

    With ``mesh``, capacity is a multiple of ``n_shards * 8`` (the
    reference's ``_round_capacity``, so slots match its mesh index) and
    slot ``g`` lives in block ``g // (capacity / n_shards)`` on that data
    shard's device; search scores each block on its device and merges the
    local top-k on the index's ``device`` (``ops/topk.sharded_topk``).  On
    a mesh across processes a block another rank owns is None here, and
    ``device`` is this rank's first data shard's.
    """

    def __init__(
        self,
        dimension: int,
        metric: str = "cos",
        initial_capacity: int = 1024,
        dtype: torch.dtype = torch.float32,
        device=None,
        mesh=None,
    ):
        self.dimension = dimension
        self.metric = normalize_metric(metric)
        self.dtype = dtype
        self.mesh = mesh
        self.n_shards = mesh.shape["data"] if mesh is not None else 1
        self._multiproc = mesh is not None and is_multiprocess(mesh)
        # the merge device of a mesh index: its first (local) data shard's
        if mesh is not None and device is None:
            device = mesh.data_device(local_shards(mesh)[0])
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        cap = self._round_capacity(max(initial_capacity, self.n_shards * 8))
        self.capacity = cap
        # one block per data shard (a single block without a mesh)
        self._mats = self._zeros((cap, dimension), dtype)
        self._valids = self._zeros((cap,), torch.bool)
        self._his = self._zeros((cap,), torch.int32)
        self._los = self._zeros((cap,), torch.int32)
        self.key_to_slot: Dict[int, int] = {}
        self.slot_to_key = np.zeros(cap, dtype=np.uint64)
        self._free: List[int] = list(range(cap - 1, -1, -1))
        # result-visibility generation: bumped on every mutation that can
        # change what a serve returns
        self.generation = 0
        hbm.track("knn", self)

    def _zeros(self, shape, dtype) -> List[torch.Tensor]:
        if self.mesh is None:
            return [torch.zeros(shape, dtype=dtype, device=self.device)]
        return global_zeros(shape, dtype, self.mesh)

    def _whole(self, blocks: List[torch.Tensor]) -> torch.Tensor:
        """A plane as one tensor: the block itself without a mesh, else a
        copy of the blocks on the merge device."""
        if len(blocks) == 1:
            return blocks[0]
        if self._multiproc:
            raise RuntimeError("the index's mesh spans processes: this rank holds only its own blocks")
        return torch.cat([b.to(self.device) for b in blocks])

    # the planes as whole tensors (read-only views for a mesh index)
    _matrix = property(lambda self: self._whole(self._mats))
    _valid = property(lambda self: self._whole(self._valids))
    _keys_hi = property(lambda self: self._whole(self._his))
    _keys_lo = property(lambda self: self._whole(self._los))

    def hbm_bytes(self) -> Dict[str, int]:
        """Device bytes: the allocated-capacity matrix and the slot
        planes (validity, key halves), over every block."""
        def nbytes(blocks):
            return sum(t.numel() * t.element_size() for t in blocks if t is not None)

        return {"matrix": nbytes(self._mats), "planes": nbytes(self._valids) + nbytes(self._his) + nbytes(self._los)}

    def _round_capacity(self, cap: int) -> int:
        unit = self.n_shards * 8
        return ((cap + unit - 1) // unit) * unit

    def __len__(self) -> int:
        return len(self.key_to_slot)

    # -- growth ------------------------------------------------------------
    def _grow(self, needed: int) -> None:
        """Capacity doubling into new blocks; global row ``g`` keeps its
        slot and moves to the block of the new layout that holds it.
        Across processes, an old block whose rows land in another rank's
        new block is broadcast by its owner first."""
        old = self.capacity
        new = self._round_capacity(max(old * 2, old + needed))
        old_rps, new_rps = old // self.n_shards, new // self.n_shards
        owners = self.mesh.owners if self.mesh is not None else [0]

        def grown(blocks: List[torch.Tensor]) -> List[torch.Tensor]:
            like = next(b for b in blocks if b is not None)
            out = self._zeros((new,) + tuple(like.shape[1:]), like.dtype)
            for s, blk in enumerate(blocks):
                g, g_end = s * old_rps, (s + 1) * old_rps
                targets = range(g // new_rps, (g_end - 1) // new_rps + 1)
                if self._multiproc and any(owners[t] != owners[s] for t in targets):
                    blk = distributed.broadcast(torch.empty_like(like) if blk is None else blk, src=owners[s])
                while g < g_end:
                    t = g // new_rps
                    end = min(g_end, (t + 1) * new_rps)
                    if out[t] is not None and blk is not None:
                        out[t][g - t * new_rps : end - t * new_rps] = blk[g - s * old_rps : end - s * old_rps]
                    g = end
            return out

        self._mats = grown(self._mats)
        self._valids = grown(self._valids)
        self._his = grown(self._his)
        self._los = grown(self._los)
        self.slot_to_key = np.concatenate([self.slot_to_key, np.zeros(new - old, dtype=np.uint64)])
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
        """In-place row scatter into the owning blocks; ``hi``/``lo`` (add
        path) also update the key planes — removals skip them, the
        cleared valid flag masks stale keys."""
        slots = np.asarray(slots, np.int64)
        rps = self.capacity // self.n_shards
        for t, blk in enumerate(self._mats):
            if blk is None:
                continue  # another process's block
            sel = np.flatnonzero(slots // rps == t) if self.n_shards > 1 else np.arange(len(slots))
            if sel.size == 0:
                continue
            dev = blk.device
            idx = torch.from_numpy(slots[sel] - t * rps).to(dev)
            rows = vectors if sel.size == len(slots) else vectors[torch.from_numpy(sel).to(vectors.device)]
            blk.index_copy_(0, idx, rows.to(dev, self.dtype))
            self._valids[t][idx] = valid
            if hi is not None:
                self._his[t].index_copy_(0, idx, torch.from_numpy(hi[sel]).to(dev))
                self._los[t].index_copy_(0, idx, torch.from_numpy(lo[sel]).to(dev))

    # -- search ------------------------------------------------------------
    def score_topk(self, q: torch.Tensor, k: int):
        """Dense scores of ``q [B, d]`` against the matrix + top-k:
        ``(scores [B, k] f32, slots [B, k] int64)``; invalid slots score
        ``-inf``.  "l2sq" ranks by 2 q.x - ||x||^2.  Products of a bf16
        matrix accumulate in f32, as the reference's
        ``preferred_element_type`` does (through an f32 copy of the
        matrix).  A mesh index goes through ``sharded_topk`` (ties in
        ``lax.top_k``'s order) and returns on ``q``'s device."""
        if self.mesh is not None:
            return sharded_topk(self.mesh, q, self._mats, self._valids, k, self.metric, merge_device=q.device)
        m = self._mats[0]
        scores = q.to(m.dtype).float() @ m.float().t()
        if self.metric == "l2sq":
            scores = 2 * scores - (m.float() * m.float()).sum(dim=1)[None, :]
        scores = scores.masked_fill(~self._valids[0][None, :], float("-inf"))
        return torch.topk(scores, k, dim=1)

    def keys_of(self, slots: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The int32 key planes ``(hi, lo)`` at ``slots`` (any shape),
        gathered on the device, on ``slots``' device.  On a mesh across
        processes each rank gathers the keys of the blocks it owns and one
        ``all_gather`` of the ``[2, *slots.shape]`` planes makes the
        answer whole on every rank, each slot's key taken from its
        block's owner."""
        if self.mesh is None:
            return self._his[0][slots], self._los[0][slots]
        rps = self.capacity // self.n_shards
        hi = torch.zeros(slots.shape, dtype=torch.int32, device=slots.device)
        lo = torch.zeros_like(hi)
        for t in range(self.n_shards):
            if self._his[t] is None:
                continue  # another process's block
            local = slots - t * rps
            mine = (local >= 0) & (local < rps)
            at = local.clamp(0, rps - 1).to(self._his[t].device)
            hi = torch.where(mine, self._his[t][at].to(slots.device), hi)
            lo = torch.where(mine, self._los[t][at].to(slots.device), lo)
        if not self._multiproc:
            return hi, lo
        planes = distributed.all_gather(torch.stack([hi, lo]))  # [ranks, 2, *slots.shape]
        owners = torch.tensor(self.mesh.owners, dtype=torch.int64, device=slots.device)
        owner = owners[(slots // rps).clamp(0, self.n_shards - 1)]
        whole = torch.gather(planes, 0, owner[None, None].expand(1, 2, *slots.shape))[0]
        return whole[0], whole[1]

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
            scores, idx = self.score_topk(torch.from_numpy(queries).to(self.device), k_eff)  # pathway: allow(lock-discipline): the reference host-search contract — the query upload, scoring and fetch run under the index lock that orders them against add's in-place scatter, as in the reference; the serve path goes through FusedEncodeSearch instead
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
