"""SentenceEncoder — batched text -> embedding (counterpart of
``pathway_tpu/models/encoder.py``: the constructor, ``encode_to_device``,
``encode``, the packed encode and the batch buckets).

Batches are tokenized on the host, padded to a bucketed batch size, and
run through one eager forward of the trunk; the result stays on the
device for ``DeviceKnnIndex.add_from_device``.  ``encode_token_states``
is the doc-side token-state export of the forward index: the same
module with its pool skipped, per-token L2-normalized.
``encode_packed_to_device`` packs short documents into shared rows
(``models/packing.py``, block-diagonal attention) and returns the same
``[n, d]`` embeddings.  Every forward dispatches under
``retry_call("encoder.dispatch", ...)``, the reference's retry and fault
site.  Checkpoints, HF import and the encoder's own embedding cache are
not ported yet.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import observe
from ..device import DEFAULT_DTYPE, resolve_device, upload
from ..robust import retry_call
from .packing import pack_rows, pad_packed_rows, seg_bucket
from .params import init_encoder_, params_from_flax
from .tokenizer import HashTokenizer
from .transformer import (
    TransformerConfig,
    TransformerEncoder,
    normalized_token_states,
    resolve_heads,
)

__all__ = ["SentenceEncoder"]

_BATCH_BUCKETS = (1, 4, 16, 64, 256)


def _bucket(n: int, buckets=_BATCH_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


class SentenceEncoder:
    """``params``: a Flax parameter tree of numpy arrays from the
    reference (carried over by ``params_from_flax``); ``None`` uses the
    port's seeded init from ``seed``."""

    def __init__(
        self,
        dimension: int = 384,
        n_layers: int = 6,
        n_heads: int = 6,
        max_length: int = 128,
        vocab_size: int = 32768,
        seed: int = 0,
        dtype: torch.dtype = DEFAULT_DTYPE,
        normalize: bool = True,
        device=None,
        params: Optional[Mapping[str, Any]] = None,
    ):
        self.device = resolve_device(device)
        self.normalize = normalize
        self.config = TransformerConfig(
            vocab_size=vocab_size,
            d_model=dimension,
            n_heads=resolve_heads(dimension, n_heads),
            n_layers=n_layers,
            d_ff=dimension * 4,
            max_len=max_length,
            dtype=dtype,
            pool="mean",
        )
        self.tokenizer = HashTokenizer(vocab_size=vocab_size, max_length=max_length)
        module = TransformerEncoder(self.config)
        if params is None:
            init_encoder_(module, torch.Generator().manual_seed(seed))
        else:
            module.load_state_dict(params_from_flax(params, self.config))
        self.module = module.to(self.device).eval()

    def get_embedding_dimension(self) -> int:
        return self.config.d_model

    def _normalized(self, out: torch.Tensor) -> torch.Tensor:
        if self.normalize:
            out = out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-9)
        return out

    @torch.no_grad()
    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Pooled (and, with ``normalize``, L2-normalized) f32 embeddings
        of a tokenized batch already on the device."""
        return self._normalized(self.module(ids, mask))

    def encode_to_device(self, texts: Sequence[str]) -> torch.Tensor:
        """Batch encode with the result left on the device ([n, d] f32)."""
        texts = ["" if t is None else str(t) for t in texts]
        n = len(texts)
        if n == 0:
            return torch.zeros((0, self.config.d_model), device=self.device)
        padded = list(texts) + [""] * (_bucket(n) - n)
        ids, mask = self.tokenizer.encode_batch(padded)
        observe.record_occupancy("encoder", n, ids.shape[0])
        ids_t, mask_t = upload(ids, self.device), upload(mask, self.device)
        out = retry_call("encoder.dispatch", self.forward, ids_t, mask_t)
        return out[:n]

    @torch.no_grad()
    def encode_packed_to_device(self, texts: Sequence[str]) -> torch.Tensor:
        """Encode with sequence packing: tokenized documents share rows of
        ``max_len`` tokens (best-fit decreasing, at most 8 per row) with
        block-diagonal attention and per-document positions.  Returns
        ``[n, d]`` f32 on the device, aligned with ``texts``."""
        texts = ["" if t is None else str(t) for t in texts]
        n = len(texts)
        if n == 0:
            return torch.zeros((0, self.config.d_model), device=self.device)
        L = self.config.max_len
        ids_b, mask_b = self.tokenizer.encode_batch(texts)
        lens = np.minimum(np.asarray(mask_b).sum(axis=1), L).astype(np.int64)
        ids, _mask, segments, positions, doc_slots, n_seg = pack_rows(np.asarray(ids_b), lens, L)
        rows_real = ids.shape[0]
        Rb = _bucket(rows_real)
        observe.record_occupancy("encoder_packed", rows_real, Rb)
        ids, segments, positions = pad_packed_rows(ids, segments, positions, Rb)
        S = seg_bucket(n_seg)
        dev = self.device
        ids_t, seg_t, pos_t = upload(ids, dev), upload(segments, dev), upload(positions, dev)

        def packed():
            return self._normalized(self.module(ids_t, seg_t > 0, segments=seg_t, positions=pos_t, n_segments=S))

        pooled = retry_call("encoder.dispatch", packed)  # [Rb, S, d]
        flat_ix = torch.as_tensor([r * S + seg for r, seg in doc_slots], dtype=torch.int64)
        return pooled.reshape(Rb * S, -1).index_select(0, flat_ix.to(dev))

    @torch.no_grad()
    def encode_token_states(self, texts: Sequence[str]):
        """Batch encode to per-token states on the device: returns
        ``(tokens [B, L, d] f32, mask [B, L] np int32, n_real)`` with the
        batch padded to its bucket by empty texts and ``L`` pinned to
        ``max_len``; pad tokens are zero, real tokens unit-norm."""
        texts = ["" if t is None else str(t) for t in texts]
        n = len(texts)
        L = self.config.max_len
        if n == 0:
            empty = torch.zeros((0, L, self.config.d_model), device=self.device)
            return empty, np.zeros((0, L), np.int32), 0
        padded = list(texts) + [""] * (_bucket(n) - n)
        ids, mask = self.tokenizer.encode_batch(padded, pad_to=L)
        ids_t, mask_t = upload(ids, self.device), upload(mask, self.device)

        def token_states():
            return normalized_token_states(self.module(ids_t, mask_t, pool="none"), mask_t)

        return retry_call("encoder.dispatch", token_states), mask, n

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """Batch encode: [n] strings -> [n, d] float32 numpy."""
        return self.encode_to_device(texts).cpu().numpy()

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode(texts)
