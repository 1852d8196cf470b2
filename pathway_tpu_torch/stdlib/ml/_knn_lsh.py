"""LSH KNN — random-projection bucketing with exact shortlist rescore
(counterpart of ``pathway_tpu/stdlib/ml/_knn_lsh.py``).

The reference's legacy pure-dataflow index (stdlib/ml/_knn_lsh.py:50-94):
``n_or`` repetitions of ``n_and`` random hyperplane bits (cosine) or
quantized line projections (euclidean) map each vector to buckets; queries
union their buckets' members and rescore exactly.  The buckets are host
dicts drawn from the same numpy generator as the reference's, so the same
seed gives the same hyperplanes, shifts and bucket sets bit for bit.  The
exact rescore of a query's candidates runs on ``device`` (the CUDA device
unless ``device="cpu"`` is passed): one f32 score per candidate, top-k
by ``torch.sort``; filtered search is ``ops/knn.py``'s
``oversampled_filtered_search`` over it, as for the other indexes.  It
conforms to the InnerIndexImpl protocol through ``DeviceLshKnn``
(``stdlib/indexing/nearest_neighbors.py``)."""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...ops.knn import normalize_metric, oversampled_filtered_search

__all__ = ["LshKnnIndex"]


class LshKnnIndex:
    """Same host API as DeviceKnnIndex: add / remove / search / len."""

    def __init__(
        self,
        dimension: int,
        metric: str = "cos",
        n_or: int = 20,
        n_and: int = 10,
        bucket_length: float = 10.0,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.dimension = dimension
        self.metric = normalize_metric(metric)
        self.n_or = n_or
        self.n_and = n_and
        self.bucket_length = bucket_length
        self._lock = threading.RLock()
        rng = np.random.default_rng(seed)
        # [n_or, n_and, d] hyperplanes / projection lines
        self._planes = rng.normal(size=(n_or, n_and, dimension)).astype(np.float32)
        self._shifts = rng.uniform(0, bucket_length, size=(n_or, n_and)).astype(np.float32)
        self._rows: Dict[int, np.ndarray] = {}
        # per repetition: bucket signature -> set of keys
        self._buckets: List[Dict[bytes, set]] = [{} for _ in range(n_or)]

    def __len__(self) -> int:
        return len(self._rows)

    def _signatures(self, vectors: np.ndarray) -> np.ndarray:
        """[B, n_or] bucket signatures (bytes) per repetition."""
        proj = np.einsum("okd,bd->bok", self._planes, vectors)
        if self.metric in ("cos", "dot"):
            bits = (proj > 0).astype(np.uint8)  # hyperplane side
        else:  # euclidean: quantized line projection
            bits = np.floor((proj + self._shifts[None]) / self.bucket_length).astype(np.int64)
        B = vectors.shape[0]
        out = np.empty((B, self.n_or), dtype=object)
        for b in range(B):
            for o in range(self.n_or):
                out[b, o] = bits[b, o].tobytes()
        return out

    def add(self, keys: Sequence[int], vectors) -> None:
        # coerce before the lock: a device-row batch syncs here, not while
        # holding the bucket lock
        vectors = _host_rows(vectors, len(keys), self.dimension)
        with self._lock:
            existing = [int(k) for k in keys if int(k) in self._rows]
            if existing:
                self.remove(existing)
            sigs = self._signatures(vectors)
            for i, key in enumerate(keys):
                key = int(key)
                self._rows[key] = vectors[i]
                for o in range(self.n_or):
                    self._buckets[o].setdefault(sigs[i, o], set()).add(key)

    def remove(self, keys: Sequence[int]) -> None:
        with self._lock:
            drop = [int(k) for k in keys if int(k) in self._rows]
            if not drop:
                return
            vectors = np.stack([self._rows[k] for k in drop])
            sigs = self._signatures(vectors)
            for i, key in enumerate(drop):
                del self._rows[key]
                for o in range(self.n_or):
                    bucket = self._buckets[o].get(sigs[i, o])
                    if bucket is not None:
                        bucket.discard(key)
                        if not bucket:
                            del self._buckets[o][sigs[i, o]]

    def _rescore(self, mat: np.ndarray, q: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact scores of the candidate rows ``mat`` against ``q`` on the
        device, as the reference scores them; (order of the best ``k``,
        scores)."""
        m = torch.from_numpy(mat).to(self.device)
        qt = torch.from_numpy(q).to(self.device)
        if self.metric == "cos":
            denom = torch.linalg.vector_norm(m, dim=1) * max(float(np.linalg.norm(q)), 1e-9)
            scores = (m @ qt) / torch.where(denom == 0, torch.ones_like(denom), denom)
        elif self.metric == "dot":
            scores = m @ qt
        else:  # l2sq ranking score: -squared distance
            scores = -torch.sum((m - qt[None, :]) ** 2, dim=1)
        order = torch.sort(scores, descending=True, stable=True).indices[:k]
        return order.cpu().numpy(), scores.cpu().numpy()

    def search(self, queries, k: int) -> List[List[Tuple[int, float]]]:
        # same off-lock coercion rule as add()
        queries = _host_rows(queries, -1, self.dimension)
        with self._lock:
            if queries.shape[0] == 0 or not self._rows:
                return [[] for _ in range(queries.shape[0])]
            sigs = self._signatures(queries)
            out: List[List[Tuple[int, float]]] = []
            for qi in range(queries.shape[0]):
                candidates: set = set()
                for o in range(self.n_or):
                    candidates |= self._buckets[o].get(sigs[qi, o], set())
                if not candidates:
                    out.append([])
                    continue
                cand = sorted(candidates)
                order, scores = self._rescore(np.stack([self._rows[c] for c in cand]), queries[qi], k)
                out.append([(cand[j], float(scores[j])) for j in order])
            return out

    def search_oversampled(self, queries, k, accept, oversample: int = 4, max_rounds: int = 3):
        return oversampled_filtered_search(self, queries, k, accept, oversample=oversample, max_rounds=max_rounds)


def _host_rows(vectors, n: int, dimension: int) -> np.ndarray:
    if isinstance(vectors, torch.Tensor):
        vectors = vectors.detach().float().cpu().numpy()
    return np.asarray(vectors, np.float32).reshape(n, dimension)
