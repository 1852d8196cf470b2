"""Tier 1: the query-embedding cache, keyed on token ids (counterpart of
``pathway_tpu/cache/embedding.py``).

An embedding depends on the tokenizer and the encoder's weights, not on
the index, so it survives every generation bump: a known query skips the
stage-1 trunk forward even after an absorb invalidated its result-cache
entry.  Entries are ``[d]`` f32 rows on the encoder's device;
``encode_rows`` stacks cached rows with one bucketed encode of the misses
for both producers, the serve path (``ops/serving.py``) and the plain
encode (``models/encoder.py``).  A row is charged its
``nbytes`` (``d * 4``, the reference's count for its ``[d]`` f32 row), so
eviction order matches the reference's.  The tier is per encoder.  Its
warm state carries the rows as host numpy arrays (the reference's
format); a restore uploads them to ``device``, else to the device of
the rows it last held, else the CUDA device.  The tier's bytes are on
the device-memory ledger (``embedding_rows``, with the budget as the
capacity resource ``embedding_cache_bytes``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import config
from ..device import resolve_device
from ..observe import hbm
from ..robust import retry_call
from .keys import token_ids_key
from .store import CacheTier, cache_enabled

__all__ = ["EmbeddingCache", "embedding_cache_from_env"]


class EmbeddingCache:
    """Device ``[d]`` rows behind one ``CacheTier`` (no fingerprint:
    checksumming a device row would be a host sync)."""

    def __init__(self, max_bytes: Optional[int] = None, ttl_s: Optional[float] = None,
                 max_entries: Optional[int] = None, device=None):
        self._device = None if device is None else resolve_device(device)
        if max_bytes is None:
            max_bytes = config.get("cache.embed_bytes")
        if ttl_s is None:
            ttl = config.get("cache.embed_ttl_s")
            ttl_s = ttl if ttl > 0 else None
        self._tier = CacheTier("embedding", max_bytes=max_bytes, ttl_s=ttl_s, max_entries=max_entries)
        # the rows are device tensors: the tier's bytes are device bytes,
        # and its budget is the ledger's capacity for the exhaustion ETA
        hbm.track("cache", self, lambda c: {"embedding_rows": c._tier.bytes})
        hbm.track_resource("embedding_cache_bytes", self, lambda c: c._tier.bytes, lambda c: c._tier.max_bytes)

    @property
    def stats(self):
        return self._tier.stats

    def __len__(self) -> int:
        return len(self._tier)

    def clear(self) -> None:
        self._tier.clear()

    def row_key(self, ids_row: np.ndarray, mask_row: np.ndarray, space: str = "") -> bytes:
        """``space`` names the producer's value space, so rows of two
        producers never alias."""
        return space.encode() + b"\x00" + token_ids_key(ids_row, mask_row)

    def lookup_rows(
        self, ids: np.ndarray, mask: np.ndarray, n_real: int, deadline=None, space: str = ""
    ) -> Tuple[List[Any], List[int], List[bytes]]:
        """``(rows, miss_indices, keys)`` for the real rows of a batch:
        ``rows[i]`` a device row or None."""
        rows: List[Any] = []
        misses: List[int] = []
        keys: List[bytes] = []
        for i in range(n_real):
            key = self.row_key(ids[i], mask[i], space)
            keys.append(key)
            row = self._tier.get(key, deadline=deadline)
            rows.append(row)
            if row is None:
                misses.append(i)
        return rows, misses, keys

    def encode_rows(
        self, ids: np.ndarray, mask: np.ndarray, n_real: int, embed: Callable, bucket: Callable[[int], int],
        space: str, site: str, deadline=None,
    ) -> Tuple[torch.Tensor, int]:
        """``[n_real, d]`` device rows of a tokenized batch: cached rows
        where the token ids are known, ONE ``embed(ids, mask)`` of the
        misses padded with zero rows to the producer's ``bucket`` (retried
        under ``site``), composed on the device.  Returns ``(rows, misses)``; fresh rows are stored
        as copies of their own (a view would keep the miss batch alive)."""
        rows, misses, keys = self.lookup_rows(ids, mask, n_real, deadline=deadline, space=space)
        fresh = {}
        if misses:
            n_pad = bucket(len(misses)) - len(misses)
            z = retry_call(
                site, embed,
                np.concatenate([ids[misses], np.zeros((n_pad, ids.shape[1]), ids.dtype)]),
                np.concatenate([mask[misses], np.zeros((n_pad, mask.shape[1]), mask.dtype)]),
                deadline=deadline,
            )
            for j, i in enumerate(misses):
                fresh[i] = z[j].clone()
                self.put_row(keys[i], fresh[i], deadline=deadline)
        return torch.stack([rows[i] if rows[i] is not None else fresh[i] for i in range(n_real)]), len(misses)

    def put_row(self, key: bytes, row: Any, deadline=None) -> bool:
        if self._device is None and isinstance(row, torch.Tensor):
            self._device = row.device
        return self._tier.put(key, row, nbytes=getattr(row, "nbytes", 64), deadline=deadline)

    def warm_state(self) -> dict:
        """Picklable snapshot: the rows fetched to host numpy arrays (on
        the snapshot cadence, never on a serve)."""
        entries = [
            (k, v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v), nbytes)
            for k, v, nbytes in self._tier.warm_entries()
        ]
        return {"kind": "embedding_cache", "entries": entries}

    def load_warm_state(self, state: dict) -> int:
        """Upload the snapshot's rows and replay them through ``put``;
        restored rows are bit-identical to the writer's."""
        if state.get("kind") != "embedding_cache":
            raise ValueError(f"not an embedding-cache warm state: {state.get('kind')!r}")
        dev = self._device or resolve_device(None)
        return self._tier.load_warm_entries(
            [(k, torch.from_numpy(np.array(v)).to(dev), nbytes) for k, v, nbytes in state["entries"]]
        )


def embedding_cache_from_env() -> Optional[EmbeddingCache]:
    """Opt-in via ``PATHWAY_CACHE_EMBED=1`` (under ``PATHWAY_CACHE``)."""
    if cache_enabled() and config.get("cache.embed"):
        return EmbeddingCache()
    return None
