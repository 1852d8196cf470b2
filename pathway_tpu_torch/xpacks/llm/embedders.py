"""Embedder UDFs of the port (counterpart of
``pathway_tpu/xpacks/llm/embedders.py``; reference: xpacks/llm/
embedders.py:85-330, dimension probed by embedding ".", vector_store.py:86).

Ported: ``BaseEmbedder`` and ``TpuEmbedder``, batched by construction —
one forward of the port's ``SentenceEncoder`` per engine micro-batch, on
the CUDA device unless ``device="cpu"`` is passed.  The local
sentence-transformers embedder, the hosted-API embedders and the CLIP
embedders come with the question-answering slice (``ROADMAP.md``); their
names raise ``NotImplementedError``."""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from ...device import DEFAULT_DTYPE
from ...internals.udfs import UDF

__all__ = [
    "BaseEmbedder",
    "TpuEmbedder",
    "SentenceTransformerEmbedder",
    "OpenAIEmbedder",
    "LiteLLMEmbedder",
    "GeminiEmbedder",
    "ClipTextEmbedder",
    "ClipImageEmbedder",
]


class BaseEmbedder(UDF):
    def get_embedding_dimension(self, **kwargs) -> int:
        """Probe output dimension by embedding "." (reference vector_store.py:86)."""
        result = self.func(np.array(["."], dtype=object), **kwargs)
        return int(np.asarray(result).shape[-1])


class TpuEmbedder(BaseEmbedder):
    """Batched on-device embedder over the port's ``SentenceEncoder``.

    ``device``/``dtype`` reach the encoder (``None`` = the card, bf16);
    ``params``: a Flax parameter tree of numpy arrays carried from the
    reference (``models/params.py`` ``params_from_flax``), else the port's
    seeded init from ``seed``.  The embedding of a batch comes back to the
    host as float32 rows."""

    def __init__(
        self,
        model: str = "pathway-mini",
        dimension: int = 384,
        n_layers: int = 6,
        n_heads: int = 6,
        max_length: int = 128,
        vocab_size: int = 32768,
        seed: int = 0,
        checkpoint_path: Optional[str] = None,
        mesh=None,
        call_kwargs: dict | None = None,
        packed: bool = True,
        device=None,
        dtype: torch.dtype = DEFAULT_DTYPE,
        params: Optional[Mapping[str, Any]] = None,
        **kwargs,
    ):
        from ...models.encoder import SentenceEncoder

        self.model_name = model
        self._encoder = SentenceEncoder(
            dimension=dimension,
            n_layers=n_layers,
            n_heads=n_heads,
            max_length=max_length,
            vocab_size=vocab_size,
            seed=seed,
            dtype=dtype,
            device=device,
            params=params,
            checkpoint_path=checkpoint_path,
            mesh=mesh,
        )
        encoder = self._encoder

        if packed and mesh is None:
            # sequence packing: short docs share rows under block-diagonal
            # attention (models/encoder.py) — the same embeddings with fewer
            # padded rows.  Packing reshapes rows, so the mesh path keeps
            # plain batches.
            def embed(texts) -> np.ndarray:
                out = encoder.encode_packed_to_device(list(texts))
                return out.float().cpu().numpy()

        else:

            def embed(texts) -> np.ndarray:
                return encoder.encode(list(texts))

        super().__init__(embed, batched=True, **kwargs)

    def get_embedding_dimension(self, **kwargs) -> int:
        return self._encoder.get_embedding_dimension()


def _next_slice(name: str):
    class _Unported(BaseEmbedder):
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"{name} is not ported yet: ROADMAP.md, framework slice 1 (question answering and chat)"
            )

    _Unported.__name__ = _Unported.__qualname__ = name
    return _Unported


SentenceTransformerEmbedder = _next_slice("SentenceTransformerEmbedder")
OpenAIEmbedder = _next_slice("OpenAIEmbedder")
LiteLLMEmbedder = _next_slice("LiteLLMEmbedder")
GeminiEmbedder = _next_slice("GeminiEmbedder")
ClipTextEmbedder = _next_slice("ClipTextEmbedder")
ClipImageEmbedder = _next_slice("ClipImageEmbedder")
