"""Cross-encoder pair scorer (counterpart of
``pathway_tpu/models/cross_encoder.py`` ``CrossEncoderModel``, the
in-framework trunk): a (query, doc) pair is one sequence ``[CLS] q [SEP]
d [SEP]``; trunk + masked mean pool, then ``head_dense`` -> ``tanh`` ->
``head_out`` -> one score.  The head computes in f32, as the reference's
Flax ``Dense`` layers with f32 parameters do on the f32 pooled input.

``submit`` packs by default: pairs are tokenized, packed into
length-bucketed rows (``models/packing.py``) and scored in one forward
under block-diagonal segment attention; ``packed=False`` gives one pair
per padded row (the parity oracle of the packed path).  Both return a
completion that waits for one pinned host copy.  The HF-checkpoint path
is not ported yet.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DEFAULT_DTYPE, resolve_device, to_host, upload
from .encoder import _bucket
from .packing import pack_rows, pad_packed_rows, row_length_bucket, seg_bucket
from .params import cross_encoder_params_from_flax, init_encoder_
from .tokenizer import HashTokenizer
from .transformer import Dense, TransformerConfig, TransformerEncoder, resolve_heads

__all__ = ["CrossEncoderModel", "CrossEncoderModule"]


class CrossEncoderModule(nn.Module):
    """Unpacked ``(ids, mask) -> [B]`` pair scores; packed (``segments``,
    ``positions``, ``n_segments``) ``-> [B, n_segments]``."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.trunk = TransformerEncoder(config)
        self.head_dense = Dense(config.d_model, config.d_model, torch.float32)
        self.head_out = Dense(config.d_model, 1, torch.float32)

    def forward(self, ids, mask, segments=None, positions=None, n_segments: int = 0):
        pooled = self.trunk(ids, mask, segments=segments, positions=positions, n_segments=n_segments)
        return self.head_out(torch.tanh(self.head_dense(pooled)))[..., 0]


class CrossEncoderModel:
    """``params``: the reference's Flax tree as numpy arrays (carried over
    by ``cross_encoder_params_from_flax``); ``None`` uses the port's
    seeded init from ``seed``."""

    def __init__(
        self,
        dimension: int = 256,
        n_layers: int = 4,
        n_heads: int = 4,
        max_length: int = 256,
        vocab_size: int = 32768,
        seed: int = 1,
        dtype: torch.dtype = DEFAULT_DTYPE,
        device=None,
        params: Optional[Mapping[str, Any]] = None,
    ):
        self.device = resolve_device(device)
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
        module = CrossEncoderModule(self.config)
        if params is None:
            init_encoder_(module, torch.Generator().manual_seed(seed))
        else:
            module.load_state_dict(cross_encoder_params_from_flax(params, self.config))
        self.module = module.to(self.device).eval()

    def predict(self, pairs: Sequence[Tuple[str, str]], packed: Optional[bool] = None) -> np.ndarray:
        """[(query, doc)] -> scores [n] f32 (packed unless ``packed=False``)."""
        return self.submit(pairs, packed=packed)()

    def submit(self, pairs: Sequence[Tuple[str, str]], packed: Optional[bool] = None, deadline=None):
        """Launch one scoring batch WITHOUT waiting; returns a zero-arg
        completion.  ``deadline`` is checked before the completion
        waits for the copy."""
        if not pairs:
            return lambda: np.zeros((0,), np.float32)
        if packed is None or packed:
            return self._submit_packed(pairs, deadline)
        return self._submit_unpacked(pairs, deadline)

    @torch.no_grad()
    def _submit_unpacked(self, pairs, deadline):
        n = len(pairs)
        b = _bucket(n)
        qs = [str(p[0]) for p in pairs] + [""] * (b - n)
        ds = [str(p[1]) for p in pairs] + [""] * (b - n)
        ids, mask = self.tokenizer.encode_batch(qs, pairs=ds)
        fetch = to_host(self.module(upload(ids, self.device), upload(mask, self.device)))

        def complete() -> np.ndarray:
            if deadline is not None:
                deadline.check("cross_encoder.fetch")
            return fetch()[:n]

        return complete

    def _pack_pairs(self, pairs: Sequence[Tuple[str, str]]):
        """Tokenize pairs and pack them into length-bucketed rows: returns
        (ids, segments, positions, doc_slots, n_seg), doc_slots[i] =
        (row, segment - 1) of pair i."""
        ids_b, mask_b = self.tokenizer.encode_batch(
            [str(p[0]) for p in pairs], pairs=[str(p[1]) for p in pairs]
        )
        lens = mask_b.sum(axis=1).astype(np.int64)
        L = row_length_bucket(int(lens.max()), self.config.max_len)
        lens = np.minimum(lens, L)
        ids, _mask, segments, positions, doc_slots, n_seg = pack_rows(ids_b, lens, L)
        return ids, segments, positions, doc_slots, n_seg

    def packed_inputs(self, pairs: Sequence[Tuple[str, str]]):
        """Packed rows of ``pairs`` padded to the row bucket, on the
        device: ``(ids, segments, positions, S, flat_ix)``; the packed
        forward's ``[R, S]`` scores flattened and taken at ``flat_ix``
        are the pair scores in input order."""
        ids, segments, positions, doc_slots, n_seg = self._pack_pairs(pairs)
        ids, segments, positions = pad_packed_rows(ids, segments, positions, _bucket(ids.shape[0]))
        S = seg_bucket(n_seg)
        flat_ix = np.asarray([r * S + s for r, s in doc_slots], np.int64)
        dev = self.device
        return upload(ids, dev), upload(segments, dev), upload(positions, dev), S, flat_ix

    def packed_forward(self, ids, segments, positions, S: int) -> torch.Tensor:
        """``[R, S]`` per-segment pair scores of packed rows."""
        return self.module(ids, segments > 0, segments=segments, positions=positions, n_segments=S)

    @torch.no_grad()
    def _submit_packed(self, pairs, deadline):
        n = len(pairs)
        ids, segments, positions, S, flat_ix = self.packed_inputs(pairs)
        fetch = to_host(self.packed_forward(ids, segments, positions, S))

        def complete() -> np.ndarray:
            if deadline is not None:
                deadline.check("cross_encoder.fetch")
            return fetch().reshape(-1)[flat_ix][:n]

        return complete
