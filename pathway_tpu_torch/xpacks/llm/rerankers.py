"""Rerankers of the port (counterpart of
``pathway_tpu/xpacks/llm/rerankers.py``; reference: xpacks/llm/
rerankers.py:15-345 — rerank_topk_filter, LLMReranker,
CrossEncoderReranker, EncoderReranker, FlashRankReranker).

``CrossEncoderReranker`` scores over the port's ``CrossEncoderModel``
(packed by default), on the CUDA device unless ``device="cpu"`` is
passed; a local directory as ``model_name`` goes to
``sentence_transformers`` as in the reference, and ``FlashRankReranker``
needs ``flashrank``: each raises ``ImportError`` where its package is
not installed."""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from ...internals import dtype as dt
from ...internals.expression import ApplyExpression
from ...internals.udfs import UDF

__all__ = [
    "rerank_topk_filter",
    "LLMReranker",
    "CrossEncoderReranker",
    "EncoderReranker",
    "FlashRankReranker",
]


def rerank_topk_filter(docs, scores, k: int = 5):
    """Keep the k best docs by score (reference: rerankers.py:15) — expression
    over (docs tuple, scores tuple) columns."""

    def topk(doc_list, score_list):
        if doc_list is None:
            return ()
        pairs = sorted(
            zip(doc_list, score_list), key=lambda p: -float(p[1])
        )[:k]
        return tuple(d for d, _ in pairs), tuple(float(s) for _, s in pairs)

    return ApplyExpression(topk, dt.ANY, args=(docs, scores))


class CrossEncoderReranker(UDF):
    """Pair scoring with the on-device cross-encoder (reference:
    rerankers.py:186 uses sentence_transformers CrossEncoder per row; here the
    whole micro-batch of (query, doc) pairs is one forward).

    The in-framework model scores with SEQUENCE PACKING by default
    (models/cross_encoder.py): short (query, doc) pairs share rows under
    block-diagonal segment attention instead of each padding to
    ``max_length``, so a dataflow micro-batch of short pairs costs a
    fraction of the work.  For the fused two-dispatch serving path see
    ``ops.RetrieveRerankPipeline``, which chains retrieval and this model's
    packed rescoring with one round trip per stage.  ``device``/``dtype``
    reach the ``CrossEncoderModel`` built here (``None`` = the process
    default device, bf16)."""

    def __init__(
        self,
        model_name: str = "pathway-mini-cross",
        checkpoint_path: Optional[str] = None,
        cross_encoder=None,
        packed: Optional[bool] = None,
        device=None,
        dtype=None,
        **kwargs,
    ):
        import os

        if cross_encoder is not None:
            self._model = cross_encoder
        elif os.path.isdir(model_name):
            from sentence_transformers import CrossEncoder

            st = CrossEncoder(model_name)
            self._model = st
        else:
            from ...device import DEFAULT_DTYPE
            from ...models.cross_encoder import CrossEncoderModel

            self.model_name = model_name
            self._model = CrossEncoderModel(
                checkpoint_path=checkpoint_path,
                device=device,
                dtype=DEFAULT_DTYPE if dtype is None else dtype,
            )

        model = self._model
        # capability check ONCE at construction (a per-batch
        # except-TypeError probe would mask genuine TypeErrors from inside
        # the packed scoring path and silently rescore the batch)
        import inspect

        try:
            takes_packed = "packed" in inspect.signature(model.predict).parameters
        except (TypeError, ValueError):  # builtins / C-impl predict
            takes_packed = False
        # consumers that unwrap ._model and call predict themselves (e.g.
        # BaseRAGQuestionAnswerer(reranker=...)) must honor an explicit
        # packed= choice; None when the model's predict doesn't take it
        self._predict_packed = packed if takes_packed else None

        def score(docs, queries) -> np.ndarray:
            pairs = [(str(q), str(d)) for q, d in zip(queries, docs)]
            if takes_packed:
                scores = model.predict(pairs, packed=packed)
            else:  # sentence_transformers CrossEncoder
                scores = model.predict(pairs)
            return np.asarray(scores, dtype=np.float64)

        super().__init__(score, batched=True, **kwargs)


class EncoderReranker(UDF):
    """Embedding dot-product reranker (reference: rerankers.py:251)."""

    def __init__(self, embedder, **kwargs):
        self._embedder = embedder

        def score(docs, queries) -> np.ndarray:
            texts = [str(d) for d in docs] + [str(q) for q in queries]
            embs = embedder.func(np.array(texts, dtype=object))
            embs = np.asarray([np.asarray(e) for e in embs])
            n = len(docs)
            de, qe = embs[:n], embs[n:]
            de = de / np.maximum(np.linalg.norm(de, axis=1, keepdims=True), 1e-9)
            qe = qe / np.maximum(np.linalg.norm(qe, axis=1, keepdims=True), 1e-9)
            return np.sum(de * qe, axis=1).astype(np.float64)

        super().__init__(score, batched=True, **kwargs)


class LLMReranker(UDF):
    """LLM scores each (doc, query) 1-5 (reference: rerankers.py:58)."""

    def __init__(self, llm, *, retry_strategy=None, cache_strategy=None, **kwargs):
        self.llm = llm
        chat_fn = llm.func

        def score(doc: str, query: str) -> float:
            prompt = (
                "Given a query and a document snippet, rate on an integer "
                "scale of 1 to 5 how relevant the document is to the query. "
                "Answer with ONLY the number.\n"
                f"Query: {query}\nDocument: {doc}\nScore:"
            )
            import asyncio
            import inspect

            if inspect.iscoroutinefunction(chat_fn):
                answer = asyncio.run(chat_fn([{"role": "user", "content": prompt}]))
            else:
                result = chat_fn(np.array([[{"role": "user", "content": prompt}]], dtype=object))
                answer = result[0] if hasattr(result, "__getitem__") else result
            m = re.search(r"[1-5]", str(answer))
            return float(m.group(0)) if m else 1.0

        super().__init__(
            score, retry_strategy=retry_strategy, cache_strategy=cache_strategy, **kwargs
        )


class FlashRankReranker(UDF):
    """(reference: rerankers.py:319 — flashrank library; gated)"""

    def __init__(self, model: str = "ms-marco-TinyBERT-L-2-v2", **kwargs):
        try:
            from flashrank import Ranker, RerankRequest
        except ImportError as e:
            raise ImportError(
                "FlashRankReranker requires the `flashrank` package; use "
                "CrossEncoderReranker for the on-device equivalent"
            ) from e
        ranker = Ranker(model_name=model)

        def score(doc: str, query: str) -> float:
            from flashrank import RerankRequest

            req = RerankRequest(query=str(query), passages=[{"text": str(doc)}])
            return float(ranker.rerank(req)[0]["score"])

        super().__init__(score, **kwargs)
