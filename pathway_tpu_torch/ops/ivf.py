"""IVF approximate KNN on one device (counterpart of
``pathway_tpu/ops/ivf.py`` ``IvfKnnIndex``).

- **train**: k-means centroids fitted with a matmul + argmax assignment
  on the device and a host segment-mean (the reference's numpy RNG
  picks the same initial rows);
- **build**: rows go to their nearest centroid under a balance cap and
  are laid out CLUSTER-SORTED as padded slabs ``[C_pad, M_pad, d_pad]``
  with an additive bias plane (0 live, -inf pad/removed).  The layout is
  the reference's (``M_pad % 128``, ``d_pad % 128``, ``C_pad % 8``,
  ``slot = c * M_pad + j``), so slots and ``keys_by_slot`` compare
  integer for integer; the rescore kernel itself needs none of those
  multiples;
- **search**: one ``[B, d] x [d, C]`` matmul scores the centroids,
  ``topk`` picks ``n_probe`` clusters per query, and the probed slabs are
  rescored exactly by ``rescore_shortlist`` (the CUDA kernels on the
  card), plus an exact scan of the rows added since the build (the
  tail);
- **absorb**: once the tail reaches ``absorb_threshold`` rows, ``add``
  starts a background thread that places tail rows into free slab slots
  at their nearest centroid with room (the reference's plan, integer for
  integer) and commits them with in-place device writes to the slabs and
  the bias, on the stream of the last serve dispatch, so a batch already
  dispatched reads the old slab.  Absorbed rows are then found only when
  their cluster is probed;
- **background retrain**: once the host rows grow past
  ``rebuild_fraction`` of the build, ``add`` (and a serve) starts a
  thread that trains a fresh layout from a snapshot of the host rows off
  the lock and installs it under the lock, reconciling rows that changed
  meanwhile: a removed or upserted key (its stored vector is no longer
  the snapshot's object) is masked out with ``-inf`` bias and a cleared
  ``live_mask``, and keys the snapshot never saw stay in the exact tail.
  An index built by ``build_from_matrix`` keeps only the streamed rows on
  the host and never retrains.  Serving continues on the old layout
  until the install.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .ivf_rescore import rescore_shortlist
from .knn import normalize_metric

__all__ = ["IvfKnnIndex"]

_PREF_CHUNK = 131072
# failed background absorbs and retrains retry a bounded number of
# times with backoff
_MAINT_ATTEMPTS = 3
_MAINT_BASE_DELAY_S = 0.05
_log = logging.getLogger(__name__)


def _kmeans(
    sample: np.ndarray, n_clusters: int, iters: int, seed: int, device: torch.device
) -> np.ndarray:
    """k-means: the assignment is a matmul + argmax on the device; the
    centroid update is a host segment-mean (C x d is small)."""
    rng = np.random.default_rng(seed)
    n = sample.shape[0]
    n_clusters = min(n_clusters, n)
    centroids = sample[rng.choice(n, size=n_clusters, replace=False)].copy()
    sample_dev = torch.from_numpy(sample).to(device)
    for _ in range(iters):
        cents = torch.from_numpy(centroids).to(device)
        owner = torch.argmax(sample_dev @ cents.t(), dim=1).cpu().numpy()
        sums = np.zeros_like(centroids)
        np.add.at(sums, owner, sample)
        counts = np.bincount(owner, minlength=n_clusters).astype(np.float32)
        empty = counts == 0
        counts[empty] = 1.0
        centroids = sums / counts[:, None]
        # re-seed empty clusters from random rows
        if empty.any():
            centroids[empty] = sample[rng.choice(n, size=int(empty.sum()), replace=False)]
        norms = np.linalg.norm(centroids, axis=1, keepdims=True)
        centroids = centroids / np.where(norms == 0, 1.0, norms)
    return centroids.astype(np.float32)


def _balanced_assign(order: np.ndarray, C: int, cap: int):
    """Balanced nearest-centroid assignment under a per-cluster cap:
    rows competing for one cluster are ranked by sort position and the
    first (cap - fill) win; losers retry at their next preference.
    ``order`` is [N, n_pref] centroid preferences.  Returns
    (assignment [N], counts [C])."""
    n, n_pref = order.shape
    counts = np.zeros(C, np.int64)
    assignment = np.full(n, -1, np.int64)
    unassigned = np.arange(n)
    for r in range(n_pref):
        if unassigned.size == 0:
            break
        cand = order[unassigned, r]
        sort_ix = np.argsort(cand, kind="stable")
        cand_sorted = cand[sort_ix]
        starts = np.searchsorted(cand_sorted, cand_sorted, side="left")
        within = np.arange(cand_sorted.size) - starts
        accept = within < (cap - counts[cand_sorted])
        winners = unassigned[sort_ix[accept]]
        assignment[winners] = cand_sorted[accept]
        np.add.at(counts, cand_sorted[accept], 1)
        unassigned = unassigned[sort_ix[~accept]]
    for i in unassigned:  # rare: all preferred clusters full
        c = int(np.argmin(counts))
        assignment[i] = c
        counts[c] += 1
    return assignment, counts


def _unit_rows(rows: torch.Tensor) -> torch.Tensor:
    return rows / torch.clamp(torch.linalg.vector_norm(rows, dim=-1, keepdim=True), min=1e-9)


def _tail_prefs(rows: torch.Tensor, centroids: torch.Tensor, n_pref: int) -> torch.Tensor:
    """Per-row top-``n_pref`` centroid preferences for absorb placement:
    a matmul in the rows' dtype, then ``topk``."""
    return torch.topk(rows @ centroids.t().to(rows.dtype), n_pref, dim=1).indices


class IvfKnnIndex:
    """Approximate KNN with the host API of ``DeviceKnnIndex`` (add /
    remove / search / ``__len__``).  Rows added after a build are scored
    exactly in the tail until a background absorb moves them into free
    slab slots (or the next ``build``)."""

    def __init__(
        self,
        dimension: int,
        metric: str = "cos",
        n_clusters: Optional[int] = None,
        n_probe: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        train_sample: int = 32768,
        kmeans_iters: int = 8,
        rebuild_fraction: float = 0.25,
        absorb_threshold: int = 4096,
        seed: int = 0,
        device=None,
    ):
        self.dimension = dimension
        self.metric = normalize_metric(metric)
        if self.metric == "l2sq":
            raise NotImplementedError(
                "IvfKnnIndex supports cos/dot; use DeviceKnnIndex for l2sq"
            )
        self.dtype = dtype
        self.device = resolve_device(device)
        self.n_clusters = n_clusters
        self.n_probe = n_probe
        self.train_sample = train_sample
        self.kmeans_iters = kmeans_iters
        self.rebuild_fraction = rebuild_fraction
        self.absorb_threshold = absorb_threshold
        self.seed = seed
        self._lock = threading.RLock()
        # host-of-record row store (build source and exact tail)
        self._rows: Dict[int, np.ndarray] = {}
        # device structures: slabs [C_pad, M_pad, d_pad], bias [C_pad,
        # M_pad] (0 live, -inf pad/removed), centroids [C, d];
        # slot = c * M_pad + j
        self._slabs: Optional[torch.Tensor] = None
        self._bias: Optional[torch.Tensor] = None
        self._centroids: Optional[torch.Tensor] = None
        self._keys_by_slot: Optional[np.ndarray] = None  # uint64 [C_pad * M_pad]
        self._M_pad = 0
        self._d_pad = 0
        self._slot_of_key: Dict[int, int] = {}
        self._tail: Dict[int, None] = {}  # keys added since the last build
        self._built_n = 0
        # device upload of the tail, cached until the tail changes
        self._tail_cache: Optional[Tuple[List[int], torch.Tensor]] = None
        # host mirror of slot occupancy (True = live row), for absorb's
        # free-slot choice without a device fetch
        self._live_mask: Optional[np.ndarray] = None
        self._absorbing = False
        self._retraining = False
        # bumped by every layout install: an off-lock absorb plan made
        # against an older layout aborts at commit
        self._layout_gen = 0
        # tail size at which an absorb placed nothing (every preferred
        # cluster full): no new absorb until the tail grows another
        # threshold, a slot frees, or a new layout lands
        self._absorb_stuck_at: Optional[int] = None
        # the stream of the last serve dispatch: absorb's in-place writes
        # are ordered after it
        self._serve_stream = None
        self.stats = {
            "sync_builds": 0,
            "retrains": 0,
            "absorbs": 0,
            "absorb_failures": 0,
            "retrain_failures": 0,
        }
        # result-visibility generation: bumped on every mutation that can
        # change what a serve returns
        self.generation = 0

    def __len__(self) -> int:
        if self._slabs is None:
            return len(self._rows)
        return len(self._slot_of_key) + len(self._tail)

    # -- mutation ------------------------------------------------------------
    def add(self, keys: Sequence[int], vectors) -> int:
        vectors = np.asarray(vectors, np.float32).reshape(len(keys), self.dimension)
        if self.metric == "cos":
            norms = np.linalg.norm(vectors, axis=1, keepdims=True)
            vectors = vectors / np.where(norms == 0, 1.0, norms)
        with self._lock:
            existing = [
                int(k) for k in keys if int(k) in self._rows or int(k) in self._slot_of_key
            ]
            self._forget_built(existing)
            for key, vec in zip(keys, vectors):
                key = int(key)
                self._rows[key] = vec
                self._tail[key] = None
            self._tail_cache = None
            self.generation += 1
            if (
                self._slabs is not None
                and not self._absorbing
                and len(self._tail) >= self.absorb_threshold
                and (
                    self._absorb_stuck_at is None
                    or len(self._tail) >= self._absorb_stuck_at + self.absorb_threshold
                )
            ):
                # planning runs off the index lock; only the commit
                # takes it again
                self._absorbing = True
                try:
                    threading.Thread(target=self._absorb_bg, daemon=True, name="ivf-absorb").start()
                except RuntimeError:
                    self._absorbing = False  # a later add() retries
            self.maybe_retrain_async()
            return self.generation

    def remove(self, keys: Sequence[int]) -> None:
        with self._lock:
            dropped = []
            for k in keys:
                k = int(k)
                in_rows = self._rows.pop(k, None) is not None
                if in_rows or k in self._slot_of_key:
                    dropped.append(k)
            self._forget_built(dropped)
            if dropped:
                self.generation += 1

    def _forget_built(self, keys: Sequence[int]) -> None:
        """Mask built slots of ``keys`` with -inf bias (one in-place device
        write, ordered on the stream after any serve already launched) and
        drop the keys from the tail.  Caller holds the lock."""
        slots = []
        for key in keys:
            slot = self._slot_of_key.pop(key, None)
            if slot is not None:
                slots.append(slot)
            if key in self._tail:
                del self._tail[key]
                self._tail_cache = None
        if slots and self._bias is not None:
            arr = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
            self._bias[arr // self._M_pad, arr % self._M_pad] = float("-inf")
            if self._live_mask is not None:
                self._live_mask[np.asarray(slots, np.int64)] = False  # absorb may reuse
            self._absorb_stuck_at = None  # capacity changed: re-arm absorb

    # -- build ---------------------------------------------------------------
    def _needs_rebuild(self) -> bool:
        if self._slabs is None:
            return True
        grown = len(self._rows) - self._built_n
        return grown > max(64, self.rebuild_fraction * max(self._built_n, 1))

    def build(self) -> None:
        """Synchronous full train + install from the host row store (the
        explicit bulk path): snapshot under the lock, train off it,
        install under it."""
        with self._lock:
            if not self._rows:
                self._slabs = None
                self._tail = {}
                self._tail_cache = None
                self._layout_gen += 1
                self.generation += 1
                return
            snapshot = dict(self._rows)
            self.stats["sync_builds"] += 1
        built = self._train_layout(snapshot)
        with self._lock:
            self._install(built, snapshot)

    def maybe_retrain_async(self) -> None:
        """Start a background retrain once the host rows have grown past
        ``rebuild_fraction`` of the build; at most one runs at a time.
        Skipped while the host store holds only the streamed rows of a
        ``build_from_matrix`` index (a retrain would drop the bulk)."""
        with self._lock:
            if (
                self._slabs is None
                or self._retraining
                or not self._needs_rebuild()
                or len(self._rows) < len(self)
            ):
                return
            self._retraining = True
        try:
            threading.Thread(target=self._retrain_bg, daemon=True, name="ivf-retrain").start()
        except RuntimeError:
            self._retraining = False  # a later add() retries

    def _retrain_bg(self) -> None:
        """Background retrain: snapshot the host rows under the lock,
        train a layout off it, install under it.  A failed pass is logged
        once, counted in ``stats["retrain_failures"]`` and retried from a
        fresh snapshot a bounded number of times; serving stays on the
        old layout and a later ``add`` re-arms it."""
        try:
            for attempt in range(_MAINT_ATTEMPTS):
                try:
                    with self._lock:
                        snapshot = dict(self._rows)
                    if not snapshot:
                        return
                    built = self._train_layout(snapshot)
                    with self._lock:
                        self._install(built, snapshot)
                        self.stats["retrains"] += 1
                    return
                except Exception as exc:  # noqa: BLE001 - counted, logged, retried
                    with self._lock:
                        self.stats["retrain_failures"] += 1
                    if self.stats["retrain_failures"] == 1:
                        _log.warning("IVF background retrain failed (%r); retrying", exc)
                    if attempt + 1 < _MAINT_ATTEMPTS:
                        time.sleep(_MAINT_BASE_DELAY_S * 2**attempt)
        finally:
            self._retraining = False

    def _train_layout(self, rows: Dict[int, np.ndarray]) -> Dict[str, Any]:
        """k-means + balanced assignment + slab layout of a snapshot of
        host rows (lock-free: touches only its argument)."""
        keys = list(rows)
        data = np.stack([rows[k] for k in keys])
        return self._layout_from_data(keys, torch.from_numpy(data).to(self.device), from_matrix=False)

    def build_from_matrix(self, keys: Sequence[int], matrix: torch.Tensor) -> None:
        """Bulk build from a DEVICE-RESIDENT row matrix [n, d] (e.g. the
        exact ``DeviceKnnIndex``'s matrix): only the k-means sample and
        the [n, n_pref] preferences cross to the host; the slab layout is
        a device gather + scatter.  The host row store keeps only rows
        streamed in through ``add``."""
        keys = [int(k) for k in keys]
        if len(keys) != int(matrix.shape[0]):
            raise ValueError(f"{len(keys)} keys for {int(matrix.shape[0])} rows")
        built = self._layout_from_data(keys, matrix.to(self.device), from_matrix=True)
        with self._lock:
            self._install(built)
            self.stats["sync_builds"] += 1

    def _layout_from_data(
        self, keys: List[int], matrix: torch.Tensor, from_matrix: bool
    ) -> Dict[str, Any]:
        """k-means + balanced assignment + slab layout for rows
        ``matrix`` [n, d] on the device.  ``from_matrix`` follows the
        reference's ``build_from_matrix`` (sorted training sample; rows
        re-normalized for cos); otherwise its host-rows build (rows
        normalized at ``add``)."""
        n = len(keys)
        d = self.dimension
        C = self.n_clusters or int(np.clip(np.ceil(n / 120.0), 16, 65536))
        rng = np.random.default_rng(self.seed)
        sample_n = min(n, max(self.train_sample, 8 * C))
        C = min(C, n, sample_n)
        sample_idx = rng.choice(n, size=sample_n, replace=False)
        if from_matrix:
            sample_idx = np.sort(sample_idx)
        sample = matrix[torch.from_numpy(sample_idx).to(self.device)].float().cpu().numpy()
        renorm = from_matrix and self.metric == "cos"
        if renorm:
            norms = np.linalg.norm(sample, axis=1, keepdims=True)
            sample = sample / np.where(norms == 0, 1.0, norms)
        centroids = _kmeans(sample, C, self.kmeans_iters, self.seed, self.device)

        # balanced assignment: nearest centroid under a 2N/C cap; overflow
        # rows fall to their next preference.  Preferences are computed on
        # the device and fetched as [N, n_pref] indices only.
        cap = max(1, int(np.ceil(2.0 * n / C)))
        n_pref = min(8, C)
        cents_dev = torch.from_numpy(centroids).to(self.device)
        parts = []
        for start in range(0, n, _PREF_CHUNK):
            rows = matrix[start : start + _PREF_CHUNK].float()
            if renorm:
                rows = _unit_rows(rows)
            parts.append(torch.topk(rows @ cents_dev.t(), n_pref, dim=1).indices.cpu())
        order = torch.cat(parts).numpy()
        assignment, counts = _balanced_assign(order, C, cap)

        M = int(counts.max())
        M_pad = max(128, ((M + 127) // 128) * 128)
        d_pad = ((d + 127) // 128) * 128
        C_pad = ((C + 7) // 8) * 8
        order_by_cluster = np.argsort(assignment, kind="stable")
        sorted_cluster = assignment[order_by_cluster]
        starts = np.searchsorted(sorted_cluster, sorted_cluster, "left")
        slots = sorted_cluster * M_pad + (np.arange(n) - starts)

        rows = matrix[torch.from_numpy(order_by_cluster).to(self.device)].float()
        if renorm:
            rows = _unit_rows(rows)
        slabs = torch.zeros((C_pad * M_pad, d_pad), dtype=self.dtype, device=self.device)
        slabs[torch.from_numpy(slots).to(self.device), :d] = rows.to(self.dtype)
        bias = np.full(C_pad * M_pad, -np.inf, np.float32)
        bias[slots] = 0.0
        keys_by_slot = np.zeros(C_pad * M_pad, dtype=np.uint64)
        sorted_keys = np.asarray(keys, dtype=np.uint64)[order_by_cluster]
        keys_by_slot[slots] = sorted_keys
        live_mask = np.zeros(C_pad * M_pad, dtype=bool)
        live_mask[slots] = True
        return {
            "slabs": slabs.reshape(C_pad, M_pad, d_pad),
            "bias": torch.from_numpy(bias.reshape(C_pad, M_pad)).to(self.device),
            "centroids": cents_dev,
            "keys_by_slot": keys_by_slot,
            "live_mask": live_mask,
            "slot_of_key": dict(zip(sorted_keys.tolist(), slots.tolist())),
            "M_pad": M_pad,
            "d_pad": d_pad,
            "n": n,
        }

    def _install(
        self, built: Dict[str, Any], snapshot: Optional[Dict[int, np.ndarray]] = None
    ) -> None:
        """Swap freshly built structures in (caller holds the lock); rows
        of the host store the build did not cover stay in the tail.  With
        the ``snapshot`` the layout was trained from, keys removed or
        upserted since (``add`` binds a fresh array per key, so the
        stored object changes) are masked out of the new layout."""
        slot_of_key = built["slot_of_key"]
        if snapshot is not None:
            stale = [k for k in slot_of_key if self._rows.get(k) is not snapshot[k]]
            if stale:
                slots = np.asarray([slot_of_key.pop(k) for k in stale], np.int64)
                M_pad = built["M_pad"]
                idx = torch.from_numpy(slots).to(self.device)
                built["bias"][idx // M_pad, idx % M_pad] = float("-inf")
                built["live_mask"][slots] = False
        self._slabs = built["slabs"]
        self._bias = built["bias"]
        self._centroids = built["centroids"]
        self._keys_by_slot = built["keys_by_slot"]
        self._live_mask = built["live_mask"]
        self._slot_of_key = built["slot_of_key"]
        self._M_pad = built["M_pad"]
        self._d_pad = built["d_pad"]
        self._built_n = built["n"]
        self._tail = {k: None for k in self._rows if k not in self._slot_of_key}
        self._tail_cache = None
        self._absorb_stuck_at = None  # fresh layout: re-arm absorb
        self._layout_gen += 1  # in-flight absorb plans must abort
        self.generation += 1

    def warm_state(self) -> Dict[str, Any]:
        """Snapshot in the reference's ``warm_state()`` format: host rows,
        the layout as numpy (slabs as f32), slot bookkeeping, the tail and
        the generation.  Refs are taken under the lock, copied off it."""
        with self._lock:
            rows = dict(self._rows)
            slabs, bias, cents = self._slabs, self._bias, self._centroids
            keys_by_slot, live_mask = self._keys_by_slot, self._live_mask
            state: Dict[str, Any] = {
                "kind": "ivf",
                "dimension": int(self.dimension),
                "metric": self.metric,
                "M_pad": int(self._M_pad),
                "d_pad": int(self._d_pad),
                "slot_of_key": dict(self._slot_of_key),
                "tail": list(self._tail),
                "built_n": int(self._built_n),
                "generation": int(self.generation),
            }
            # absorb and remove write the slabs, bias and live mask in
            # place: copy them here (device copies are queued, not waited)
            slabs = None if slabs is None else slabs.clone()
            bias = None if bias is None else bias.clone()
            live_mask = None if live_mask is None else live_mask.copy()
        state["rows"] = rows
        for name, t in (("slabs", slabs), ("bias", bias), ("centroids", cents)):
            state[name] = None if t is None else t.float().cpu().numpy()
        state["keys_by_slot"] = None if keys_by_slot is None else np.array(keys_by_slot)
        state["live_mask"] = live_mask
        return state

    def load_warm_state(self, state: Dict[str, Any]) -> None:
        """Install a reference ``IvfKnnIndex.warm_state()`` snapshot (numpy
        slabs, bias, centroids, ``keys_by_slot``, ``live_mask``, slot maps,
        tail rows):
        the port then serves from the reference's exact layout.  Raises
        ``ValueError`` on a geometry mismatch."""
        if state.get("kind") != "ivf":
            raise ValueError(f"not an IVF warm state: {state.get('kind')!r}")
        if int(state["dimension"]) != int(self.dimension):
            raise ValueError(
                f"dimension mismatch: snapshot {state['dimension']} vs index {self.dimension}"
            )
        if state["metric"] != self.metric:
            raise ValueError(
                f"metric mismatch: snapshot {state['metric']!r} vs index {self.metric!r}"
            )

        def dev(a, dtype):
            if a is None:
                return None
            # a copy: the in-place bias writes must not reach the snapshot
            return torch.from_numpy(np.array(a, np.float32)).to(self.device, dtype)

        slabs = dev(state["slabs"], self.dtype)
        bias = dev(state["bias"], torch.float32)
        cents = dev(state["centroids"], torch.float32)
        rows = {int(k): np.asarray(v, np.float32) for k, v in state["rows"].items()}
        with self._lock:
            self._rows = rows
            self._slabs = slabs
            self._bias = bias
            self._centroids = cents
            self._keys_by_slot = state["keys_by_slot"]
            live = state.get("live_mask")
            # a copy: absorb and remove update the mask in place
            self._live_mask = None if live is None else np.array(live, dtype=bool)
            self._M_pad = int(state["M_pad"])
            self._d_pad = int(state["d_pad"])
            self._slot_of_key = {int(k): int(s) for k, s in state["slot_of_key"].items()}
            self._tail = {int(k): None for k in state["tail"]}
            self._built_n = int(state["built_n"])
            self._tail_cache = None
            self._absorb_stuck_at = None
            self._layout_gen += 1  # in-flight absorb plans must abort
            self.generation = int(state["generation"])

    # -- absorb --------------------------------------------------------------
    def _absorb_bg(self) -> None:
        """Background absorb: snapshot under the lock, plan off it (the
        preference matmul and its host fetch), commit under it.  A failed
        pass is logged once per exception type, counted in
        ``stats["absorb_failures"]`` and retried from a fresh snapshot a
        bounded number of times; the next ``add`` re-arms it after that."""
        try:
            for attempt in range(_MAINT_ATTEMPTS):
                try:
                    with self._lock:
                        snap = self._absorb_snapshot()
                    if snap is None:
                        return
                    plan = self._plan_absorb(snap)
                    with self._lock:
                        self._commit_absorb(snap, plan)
                    return
                except Exception as exc:  # noqa: BLE001 - counted, logged, retried
                    with self._lock:
                        self.stats["absorb_failures"] += 1
                    if self.stats["absorb_failures"] == 1:
                        _log.warning("IVF background absorb failed (%r); retrying", exc)
                    if attempt + 1 < _MAINT_ATTEMPTS:
                        time.sleep(_MAINT_BASE_DELAY_S * 2**attempt)
        finally:
            self._absorbing = False

    def _absorb_snapshot(self) -> Optional[Dict[str, Any]]:
        """The tail and slab occupancy for planning (caller holds the
        lock).  The stored vector objects double as a staleness check at
        commit: ``add`` binds a fresh array per key."""
        tail_keys = [k for k in self._tail if k in self._rows]
        if not tail_keys or self._slabs is None:
            return None
        vec_refs = [self._rows[k] for k in tail_keys]
        return {
            "tail_keys": tail_keys,
            "vec_refs": vec_refs,
            "data": np.stack(vec_refs),
            "live": self._live_mask.copy(),
            "centroids": self._centroids,
            "M_pad": self._M_pad,
            "C_pad": self._bias.shape[0],
            "d_pad": self._d_pad,
            "gen": self._layout_gen,
        }

    def _plan_absorb(self, snap: Dict[str, Any]) -> Dict[str, Any]:
        """Place tail rows in FREE slots of their nearest centroid with
        room (lock-free: reads only the snapshot).  Rows competing for a
        cluster are ranked by a stable sort, as the reference does, so
        the slots match it integer for integer.  The placed rows are
        uploaded here, off the lock, ready for the commit."""
        data = snap["data"]
        t = data.shape[0]
        M_pad, C_pad = snap["M_pad"], snap["C_pad"]
        C = snap["centroids"].shape[0]
        n_pref = min(4, C)
        prefs = _tail_prefs(torch.from_numpy(data).to(self.device), snap["centroids"], n_pref)
        prefs = prefs.cpu().numpy()
        live = snap["live"]
        free_count = M_pad - live.reshape(C_pad, M_pad).sum(axis=1, dtype=np.int64)
        target = np.full(t, -1, np.int64)
        fill = np.zeros(C_pad, np.int64)
        for r in range(n_pref):
            todo = target < 0
            if not todo.any():
                break
            cand = prefs[todo, r]
            room = free_count[cand] - fill[cand] > 0
            idxs = np.flatnonzero(todo)[room]
            cand = cand[room]
            order = np.argsort(cand, kind="stable")
            cs = cand[order]
            starts = np.searchsorted(cs, cs, "left")
            within = np.arange(cs.size) - starts
            ok = within < (free_count[cs] - fill[cs])
            target[idxs[order[ok]]] = cs[ok]
            np.add.at(fill, cs[ok], 1)
        placed = np.flatnonzero(target >= 0)
        if placed.size == 0:
            return {"placed": placed, "slots": np.empty(0, np.int64)}
        # the free slots of each cluster in order, rows in stable order
        slots = np.empty(placed.size, np.int64)
        pos = 0
        for c in np.unique(target[placed]):
            rows_c = placed[target[placed] == c]
            free_js = np.flatnonzero(~live[c * M_pad : (c + 1) * M_pad])
            slots[pos : pos + rows_c.size] = c * M_pad + free_js[: rows_c.size]
            pos += rows_c.size
        placed = placed[np.argsort(target[placed], kind="stable")]
        vecs = np.zeros((placed.size, snap["d_pad"]), np.float32)
        vecs[:, : self.dimension] = data[placed]
        return {
            "placed": placed,
            "slots": slots,
            "slots_dev": torch.from_numpy(slots).to(self.device),
            "vecs_dev": torch.from_numpy(vecs).to(self.device, self.dtype),
        }

    def _commit_absorb(self, snap: Dict[str, Any], plan: Dict[str, Any]) -> None:
        """Install an absorb plan (caller holds the lock).  A layout
        installed since the snapshot aborts the plan; rows removed or
        upserted since are dropped from it.  The device update writes the
        slabs and the bias in place, ordered after the last serve
        dispatch; ``keys_by_slot`` is replaced, not mutated, since an
        in-flight serve completes through the old one."""
        if snap["gen"] != self._layout_gen or self._slabs is None:
            return
        placed = plan["placed"]
        if placed.size == 0:
            # only if occupancy is unchanged: a remove() during the plan
            # freed capacity and re-armed absorb
            if np.array_equal(self._live_mask, snap["live"]):
                self._absorb_stuck_at = len(self._tail)
            return
        tail_keys, vec_refs = snap["tail_keys"], snap["vec_refs"]
        keep = np.asarray(
            [
                tail_keys[int(i)] in self._tail and self._rows.get(tail_keys[int(i)]) is vec_refs[int(i)]
                for i in placed
            ],
            bool,
        )
        if not keep.any():
            return
        slots_dev, vecs_dev = plan["slots_dev"], plan["vecs_dev"]
        if not keep.all():
            sel = torch.from_numpy(np.flatnonzero(keep)).to(self.device)
            slots_dev, vecs_dev = slots_dev[sel], vecs_dev[sel]
        placed, slots = placed[keep], plan["slots"][keep]
        self._absorb_stuck_at = None
        C_pad, M_pad, d_pad = self._slabs.shape
        on_stream = contextlib.nullcontext()
        if self.device.type == "cuda":
            stream = self._serve_stream or torch.cuda.current_stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))  # the plan's uploads
            # allocated on the absorb thread's stream: no reuse before the writes run
            slots_dev.record_stream(stream)
            vecs_dev.record_stream(stream)
            on_stream = torch.cuda.stream(stream)
        with on_stream:
            self._slabs.view(C_pad * M_pad, d_pad).index_copy_(0, slots_dev, vecs_dev)
            self._bias.view(-1).index_fill_(0, slots_dev, 0.0)
        self._live_mask[slots] = True
        keys_by_slot = self._keys_by_slot.copy()
        for row_i, slot in zip(placed.tolist(), slots.tolist()):
            key = tail_keys[row_i]
            keys_by_slot[slot] = key
            self._slot_of_key[key] = slot
            del self._tail[key]
        self._keys_by_slot = keys_by_slot
        self._tail_cache = None
        self.generation += 1
        self.stats["absorbs"] += 1

    def _default_probe(self) -> int:
        """Probe count bounding the rescore shortlist: up to 20% of
        clusters for small corpora, tapering so n_probe * M_pad stays
        ~16k rows per query at large N."""
        C = self._centroids.shape[0]
        n = max(self._built_n, 1)
        frac = min(0.2, 8192.0 / n)
        return max(1, min(C, int(np.ceil(C * frac))))

    def probe_count(self, n_probe: Optional[int] = None) -> int:
        return min(n_probe or self.n_probe or self._default_probe(), self._centroids.shape[0])

    # -- exact tail ----------------------------------------------------------
    def _tail_snapshot(self) -> Tuple[List[int], np.ndarray]:
        """The exact tail (caller holds the lock): ``(tail_keys,
        tail_mat [t, d])``."""
        tail = [key for key in self._tail if key in self._rows]
        if not tail:
            return tail, np.zeros((0, self.dimension), np.float32)
        return tail, np.stack([self._rows[key] for key in tail])

    def _tail_snapshot_device(self) -> Tuple[List[int], torch.Tensor]:
        """Device flavor of ``_tail_snapshot`` (caller holds the lock),
        cached until the tail changes: steady serving with an unchanged
        tail uploads nothing."""
        if self._tail_cache is None:
            tail, mat = self._tail_snapshot()
            self._tail_cache = (tail, torch.from_numpy(mat).to(self.device, self.dtype))
        return self._tail_cache

    # -- search --------------------------------------------------------------
    def _search_device(
        self, z: torch.Tensor, k: int, p: int, tail_mat: torch.Tensor, serve: bool
    ):
        """Stage 1 on the device for metric-normalized queries ``z [B, d]``
        f32 (caller holds the lock): centroid probe, slab rescore, top-k,
        and the exact tail scan.  Returns ``(s [B, k_main] f32, slots
        [B, k_main] int32 (-1 where s is not finite), t_s [B, k_tail] f32,
        t_i [B, k_tail] int32)``.  ``serve`` rounds the queries to the
        tail's dtype before the tail product, as the reference's fused
        serve does; its host search keeps them f32."""
        B = z.shape[0]
        M = self._M_pad
        d = self.dimension
        if z.device.type == "cuda":
            self._serve_stream = torch.cuda.current_stream(z.device)
        probe = torch.topk(z @ self._centroids.t(), p, dim=1).indices.to(torch.int32)
        zq = z
        if self._d_pad > d:
            zq = torch.cat([z, z.new_zeros((B, self._d_pad - d))], dim=1)
        scores = rescore_shortlist(probe, zq.contiguous(), self._slabs, self._bias)
        s, i = torch.topk(scores.reshape(B, p * M), min(k, p * M), dim=1)
        slots = torch.gather(probe, 1, (i // M).to(torch.int64)) * M + (i % M).to(torch.int32)
        slots = torch.where(torch.isfinite(s), slots, torch.full_like(slots, -1))
        k_tail = min(k, tail_mat.shape[0])
        if k_tail:
            zt = z.to(tail_mat.dtype).float() if serve else z
            ts = zt @ tail_mat.float().t()
            t_s, t_i = torch.topk(ts, k_tail, dim=1)
            t_i = t_i.to(torch.int32)
        else:
            t_s = z.new_zeros((B, 0))
            t_i = torch.zeros((B, 0), dtype=torch.int32, device=z.device)
        return s, slots, t_s, t_i

    def search(
        self, queries, k: int, n_probe: Optional[int] = None
    ) -> List[List[Tuple[int, float]]]:
        """Top-k per host query: [(key, score), ...] per row."""
        queries = np.asarray(queries, np.float32).reshape(-1, self.dimension)
        nq = queries.shape[0]
        with self._lock:
            if nq == 0 or len(self) == 0:
                return [[] for _ in range(nq)]
            if self._slabs is None:
                self.build()  # first build only
            else:
                self.maybe_retrain_async()
            if self.metric == "cos":
                norms = np.linalg.norm(queries, axis=1, keepdims=True)
                queries = queries / np.where(norms == 0, 1.0, norms)
            tail, tail_dev = self._tail_snapshot_device()
            z = torch.from_numpy(queries).to(self.device)
            out = self._search_device(z, k, self.probe_count(n_probe), tail_dev, serve=False)
            keys_by_slot = self._keys_by_slot  # dispatch-time snapshot
        scores, slots, t_scores, t_idx = (t.cpu().numpy() for t in out)
        return [
            merge_stage1_row(scores[qi], slots[qi], t_scores[qi], t_idx[qi], keys_by_slot, tail, k)
            for qi in range(nq)
        ]


def merge_stage1_row(
    scores, slots, t_scores, t_idx, keys_by_slot, tail: List[int], k: int
) -> List[Tuple[int, float]]:
    """Host completion of one query: resident winners (finite score,
    slot >= 0) mapped through the dispatch-time ``keys_by_slot``, tail
    winners through the tail key list, merged by score, deduplicated
    (an upsert can sit in both), cut to ``k``."""
    row: List[Tuple[int, float]] = []
    for s, slot in zip(scores.tolist(), slots.tolist()):
        if np.isfinite(s) and slot >= 0:
            row.append((int(keys_by_slot[slot]), s))
    for s, ti in zip(t_scores.tolist(), t_idx.tolist()):
        if np.isfinite(s) and ti < len(tail):
            row.append((tail[ti], s))
    row.sort(key=lambda kv: -kv[1])
    seen = set()
    dedup = []
    for key, s in row:
        if key not in seen:
            seen.add(key)
            dedup.append((key, s))
    return dedup[:k]
