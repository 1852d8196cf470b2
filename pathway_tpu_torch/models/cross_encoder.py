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
completion that waits for one pinned host copy.  The launch retries
under the ``cross_encoder.dispatch`` site and the completion fires
``cross_encoder.fetch``; submit-to-ready lands on
``pathway_serve_model_seconds{model="cross_encoder"}`` and the active
trace (``model.cross_encoder``).  The forwards are attributed by the
profiler as ``cross_encoder.forward`` / ``cross_encoder.packed``, their
shape keys go through the ``CrossEncoderModel`` tripwire, and the
module's parameters and buffers are on the device-memory ledger.

``checkpoint_path`` on an HF ``BertForSequenceClassification`` directory
(``models/hf_import.py``; the sentence-transformers cross-encoder
export) loads ``BertCrossEncoderModule``, computing in the checkpoint's
f32, with the vocab's ``WordPieceTokenizer``.  It takes no segments, so
it scores unpacked whatever ``packed`` says, with BERT pair segments:
``type_ids`` are 1 after the first ``[SEP]`` where the mask is set.  A
``checkpoint_path`` that is not an HF directory raises ``ValueError``.
"""

from __future__ import annotations

import time
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import observe
from ..device import DEFAULT_DTYPE, resolve_device, to_host, upload
from ..observe import hbm, profile, trace
from ..ops.recompile_guard import RecompileTripwire
from ..robust import inject, retry_call
from .encoder import _bucket
from .hf_import import is_hf_checkpoint, load_hf_text_model
from .packing import pack_rows, pad_packed_rows, row_length_bucket, seg_bucket
from .params import cross_encoder_params_from_flax, init_encoder_
from .tokenizer import HashTokenizer
from .transformer import Dense, TransformerConfig, TransformerEncoder, resolve_heads

__all__ = ["CrossEncoderModel", "CrossEncoderModule"]

_H_READY = observe.histogram("pathway_serve_model_seconds", model="cross_encoder")


def _completion(fetch, n: int, deadline, select):
    """The completion of one scoring launch: the fetch fault site, the
    deadline, the wait, then ``select(host array)`` -> scores [n]."""
    t_dispatch = time.perf_counter_ns()

    def complete() -> np.ndarray:
        inject.fire("cross_encoder.fetch", deadline=deadline)
        if deadline is not None:
            deadline.check("cross_encoder.fetch")
        scores = select(fetch())
        t_ready = time.perf_counter_ns()
        _H_READY.observe_ns(t_ready - t_dispatch)
        t = trace.current()
        if t is not None:
            t.add_span("model.cross_encoder", t_dispatch, t_ready, exemplar=_H_READY, pairs=n)
        return scores

    return complete


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
    by ``cross_encoder_params_from_flax``); ``checkpoint_path``: an HF
    cross-encoder directory; neither uses the port's seeded init from
    ``seed``."""

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
        checkpoint_path: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        self._hf = is_hf_checkpoint(checkpoint_path)
        if self._hf:
            module, self.config, self.tokenizer = load_hf_text_model(checkpoint_path, max_length, dtype, cross=True)
        elif checkpoint_path is not None:
            raise ValueError(
                f"checkpoint_path {checkpoint_path!r} is not an HF cross-encoder directory "
                "(config.json + model.safetensors + vocab.txt)"
            )
        else:
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
        self._tripwire = RecompileTripwire("CrossEncoderModel")
        hbm.track_params("cross_encoder", self)

    def predict(self, pairs: Sequence[Tuple[str, str]], packed: Optional[bool] = None) -> np.ndarray:
        """[(query, doc)] -> scores [n] f32 (packed unless ``packed=False``
        or the module is an HF import)."""
        return self.submit(pairs, packed=packed)()

    def submit(self, pairs: Sequence[Tuple[str, str]], packed: Optional[bool] = None, deadline=None):
        """Launch one scoring batch WITHOUT waiting; returns a zero-arg
        completion.  ``deadline`` is checked before the completion
        waits for the copy."""
        if not pairs:
            return lambda: np.zeros((0,), np.float32)
        if (packed is None or packed) and not self._hf:
            return self._submit_packed(pairs, deadline)
        return self._submit_unpacked(pairs, deadline)

    @torch.no_grad()
    def _submit_unpacked(self, pairs, deadline):
        n = len(pairs)
        b = _bucket(n)
        qs = [str(p[0]) for p in pairs] + [""] * (b - n)
        ds = [str(p[1]) for p in pairs] + [""] * (b - n)
        ids, mask = self.tokenizer.encode_batch(qs, pairs=ds)
        self._tripwire.observe(tuple(ids.shape))
        args = [upload(ids, self.device), upload(mask, self.device)]
        if self._hf:
            # BERT pair segments: tokens after the first [SEP] are type 1
            first_sep = np.argmax(ids == self.tokenizer.SEP, axis=1)
            type_ids = (np.arange(ids.shape[1])[None, :] > first_sep[:, None]) & (mask > 0)
            args.append(upload(type_ids.astype(np.int32), self.device))
        fetch = retry_call(
            "cross_encoder.dispatch", lambda: to_host(_FORWARD(self.module, *args)), deadline=deadline
        )
        return _completion(fetch, n, deadline, lambda arr: arr[:n])

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
        self._tripwire.observe(("packed", ids.shape[0], ids.shape[1], S))
        fetch = retry_call(
            "cross_encoder.dispatch",
            lambda: to_host(_PACKED(self, ids, segments, positions, S)),
            deadline=deadline,
        )
        return _completion(fetch, n, deadline, lambda arr: arr.reshape(-1)[flat_ix][:n])


# the forwards under the reference's profiler labels
_FORWARD = profile.wrap("cross_encoder.forward", lambda module, *a: module(*a))
_PACKED = profile.wrap("cross_encoder.packed", lambda ce, *a: ce.packed_forward(*a))
