"""Adapter indexing *text* through an embedder + vector index pair
(counterpart of ``pathway_tpu/stdlib/indexing/embedding_adapter.py``).

Handles every embedder flavor: batched sync (one device call per
micro-batch — the device fast path), plain sync per-item, and async API
embedders (gathered on a private event loop)."""

from __future__ import annotations

import asyncio
import inspect
from typing import Any, List, Sequence

import numpy as np

__all__ = ["EmbeddingIndexAdapter"]


class EmbeddingIndexAdapter:
    def __init__(self, inner, embedder):
        self.inner = inner
        self.embedder = embedder
        if hasattr(embedder, "encode"):
            # model-object embedder (SentenceEncoder & friends): batched
            # list-of-strings -> [B, d] on device
            self._mode = "encode"
        else:
            fn = embedder.func  # UDF-style embedder
            self._mode = (
                "async"
                if inspect.iscoroutinefunction(fn)
                else "batched"
                if getattr(embedder, "batched", False)
                else "per_item"
            )

    def _embed(self, values: Sequence[Any]) -> List[np.ndarray]:
        texts = ["" if v is None else str(v) for v in values]
        if self._mode == "encode":
            # the encoder returns host numpy rows (SentenceEncoder.encode)
            return list(np.asarray(self.embedder.encode(texts), np.float32))
        fn = self.embedder.func
        if self._mode == "async":

            async def run():
                return await asyncio.gather(*(fn(t) for t in texts))

            out = asyncio.run(run())
        elif self._mode == "batched":
            arr = np.empty(len(texts), dtype=object)
            arr[:] = texts
            out = fn(arr)
        else:
            out = [fn(t) for t in texts]
        return [np.asarray(v, dtype=np.float32) for v in out]

    def add(self, keys, values, metadatas):
        if len(keys) == 0:
            return
        self.inner.add(keys, self._embed(values), metadatas)

    def remove(self, keys):
        self.inner.remove(keys)

    def search(self, values, k, filters):
        if len(values) == 0:
            return []
        return self.inner.search(self._embed(values), k, filters)
