"""Embedder UDFs of the port (counterpart of
``pathway_tpu/xpacks/llm/embedders.py``; reference: xpacks/llm/
embedders.py:85-330, dimension probed by embedding ".", vector_store.py:86).

Local embedders are batched by construction — one forward per engine
micro-batch, on the CUDA device unless ``device="cpu"`` is passed (or the
process default is the CPU): ``TpuEmbedder`` over the port's
``SentenceEncoder``, ``SentenceTransformerEmbedder`` over an HF directory
through ``models/hf_import.py`` (or seeded, without one), and the CLIP
embedders over ``models/clip.py``.  A sentence-transformers directory
that is not an HF text checkpoint needs ``sentence_transformers``, and
the hosted-API embedders their client package, each imported as in the
reference and raising ``ImportError`` where it is not installed."""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

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
                return out.float().cpu().numpy()  # pathway: allow(value-flow): the embedder xpack's contract IS a host ndarray — a deliberate synchronous fetch on the ingest/UDF path, never inside a serve stage (mirrored in residency.DECLARED_TRANSFERS)

        else:

            def embed(texts) -> np.ndarray:
                return encoder.encode(list(texts))

        super().__init__(embed, batched=True, **kwargs)

    def get_embedding_dimension(self, **kwargs) -> int:
        return self._encoder.get_embedding_dimension()


class SentenceTransformerEmbedder(BaseEmbedder):
    """Local sentence embedder (reference: embedders.py:270).

    ``model`` (or ``checkpoint_path``) naming an HF text checkpoint
    directory (``config.json`` + ``model.safetensors`` + ``vocab.txt``)
    loads it through the port's ``models/hf_import.py``; another local
    directory goes to ``sentence_transformers`` as in the reference
    (batched ``model.encode`` on the whole micro-batch); a model name
    without a directory gets the port's seeded encoder of the given
    output dimension.  ``device``/``dtype`` reach the port's encoder."""

    def __init__(
        self,
        model: str = "pathway-mini",
        call_kwargs: dict | None = None,
        device=None,
        dimension: int = 384,
        checkpoint_path: Optional[str] = None,
        dtype: torch.dtype = DEFAULT_DTYPE,
        **init_kwargs,
    ):
        import os

        from ...models.encoder import SentenceEncoder
        from ...models.hf_import import is_hf_checkpoint

        self.model_name = model
        path = checkpoint_path or model
        call_kwargs = call_kwargs or {}
        if is_hf_checkpoint(path):
            encoder = SentenceEncoder(checkpoint_path=path, device=device, dtype=dtype)
        elif os.path.isdir(path):
            from sentence_transformers import SentenceTransformer

            st_model = SentenceTransformer(path, **init_kwargs)
            self._dimension = int(st_model.get_sentence_embedding_dimension())

            def embed(texts) -> np.ndarray:
                return np.asarray(st_model.encode(list(texts), **call_kwargs), dtype=np.float32)  # pathway: allow(value-flow): SentenceTransformer is a HOST-side model — its .encode matches the device-producer spelling but returns numpy rows; no device crossing (mirrored in residency.DECLARED_TRANSFERS)

            super().__init__(embed, batched=True)
            return
        else:
            encoder = SentenceEncoder(dimension=dimension, device=device, dtype=dtype)
        self._encoder = encoder
        self._dimension = encoder.get_embedding_dimension()

        def embed(texts) -> np.ndarray:
            return encoder.encode(list(texts))

        super().__init__(embed, batched=True)

    def get_embedding_dimension(self, **kwargs) -> int:
        return self._dimension


class _ApiEmbedder(BaseEmbedder):
    """Async API embedders (capacity/retry/cache via udfs.async_options)."""

    _import_error = "this embedder's client library is not installed"

    def __init__(
        self,
        capacity: Optional[int] = None,
        retry_strategy=None,
        cache_strategy=None,
        model: Optional[str] = None,
        **call_kwargs,
    ):
        self.model = model
        self.call_kwargs = call_kwargs
        embed = self._make_embed_fn()
        super().__init__(
            embed,
            executor="async",
            capacity=capacity,
            retry_strategy=retry_strategy,
            cache_strategy=cache_strategy,
        )

    def _make_embed_fn(self) -> Callable:
        raise NotImplementedError

    def get_embedding_dimension(self, **kwargs) -> int:
        import asyncio

        return int(
            np.asarray(asyncio.run(self.func(".", **kwargs))).shape[-1]
        )


class OpenAIEmbedder(_ApiEmbedder):
    """(reference: embedders.py:85 — async OpenAI embeddings API)"""

    def __init__(self, model: str = "text-embedding-3-small", **kwargs):
        super().__init__(model=model, **kwargs)

    def _make_embed_fn(self):
        model = self.model if hasattr(self, "model") else None
        call_kwargs = getattr(self, "call_kwargs", {})

        async def embed(text: str, **kw):
            try:
                import openai
            except ImportError as e:
                raise ImportError(
                    "OpenAIEmbedder requires the `openai` package"
                ) from e
            client = openai.AsyncOpenAI()
            response = await client.embeddings.create(
                input=[text or "."], model=self.model, **{**call_kwargs, **kw}
            )
            return np.array(response.data[0].embedding, dtype=np.float32)

        return embed


class LiteLLMEmbedder(_ApiEmbedder):
    """(reference: embedders.py:180)"""

    def __init__(self, model: str = "text-embedding-3-small", **kwargs):
        super().__init__(model=model, **kwargs)

    def _make_embed_fn(self):
        call_kwargs = getattr(self, "call_kwargs", {})

        async def embed(text: str, **kw):
            try:
                import litellm
            except ImportError as e:
                raise ImportError(
                    "LiteLLMEmbedder requires the `litellm` package"
                ) from e
            response = await litellm.aembedding(
                input=[text or "."], model=self.model, **{**call_kwargs, **kw}
            )
            return np.array(response.data[0]["embedding"], dtype=np.float32)

        return embed


class GeminiEmbedder(_ApiEmbedder):
    """(reference: embedders.py:330)"""

    def __init__(self, model: str = "models/embedding-001", **kwargs):
        super().__init__(model=model, **kwargs)

    def _make_embed_fn(self):
        async def embed(text: str, **kw):
            try:
                import google.generativeai as genai
            except ImportError as e:
                raise ImportError(
                    "GeminiEmbedder requires `google-generativeai`"
                ) from e
            result = genai.embed_content(model=self.model, content=text or ".")
            return np.array(result["embedding"], dtype=np.float32)

        return embed


class ClipTextEmbedder(BaseEmbedder):
    """Text side of the multimodal CLIP embedder over the port's
    ``ClipModel`` (``device`` reaches the model built here)."""

    def __init__(self, clip_model=None, device=None, **kwargs):
        from ...models.clip import ClipModel

        self._model = clip_model or ClipModel(device=device)
        model = self._model

        def embed(texts) -> np.ndarray:
            return model.encode_text(list(texts))

        super().__init__(embed, batched=True, **kwargs)

    def get_embedding_dimension(self, **kwargs) -> int:
        return self._model.get_embedding_dimension()


class ClipImageEmbedder(BaseEmbedder):
    """Image side: embeds ndarray image columns."""

    def __init__(self, clip_model=None, device=None, **kwargs):
        from ...models.clip import ClipModel

        self._model = clip_model or ClipModel(device=device)
        model = self._model

        def embed(images) -> np.ndarray:
            return model.encode_image(list(images))

        super().__init__(embed, batched=True, **kwargs)

    def get_embedding_dimension(self, **kwargs) -> int:
        return self._model.get_embedding_dimension()
