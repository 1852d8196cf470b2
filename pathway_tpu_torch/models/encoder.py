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
site.  ``set_embed_cache`` arms the tier-1 embedding cache on the plain
encode path: cached rows skip the forward, the misses encode in one
bucketed forward, and the rows compose on the device.  The three
forwards are attributed by the profiler as ``encoder.forward``,
``encoder.token_states`` and ``encoder.packed``, their shape keys (the
reference's) go through the ``SentenceEncoder`` tripwire, and the
module's parameters and buffers are on the device-memory ledger.

``checkpoint_path`` takes two formats and nothing else:

- an HF BERT-family directory (``config.json`` + ``model.safetensors`` +
  ``vocab.txt``, ``models/hf_import.py``): the module is
  ``BertEncoderModule``, computing in the checkpoint's f32, with the
  vocab's ``WordPieceTokenizer``.  Its packed encode falls back to the
  plain one and its token-state export raises ``NotImplementedError``,
  as in the reference; the ledger, the ``encoder.forward`` label, the
  tripwire keys and the ``encoder.dispatch`` retry cover it as they
  cover the in-framework trunk;
- a directory written by ``save_checkpoint``: the trunk's state dict in
  ``encoder.safetensors`` (the port's counterpart of the reference's
  orbax checkpoint, which the port cannot read: restore that with the
  reference and pass the tree as ``params``).

Any other path raises ``ValueError`` naming both formats; it never
falls back to the seeded init.

``mesh`` (a port ``Mesh``, counterpart of the reference's
``SentenceEncoder(mesh=...)``): the parameters are replicated on each
data device of the mesh this process owns, and ``forward`` splits its
batch into row blocks over "data", each padded to a batch bucket
(``_bucket``: no new shapes) and run on its shard's device (forward,
pool, normalize); the rows come back in order on the encoder's
``device``, through one ``all_gather`` on a mesh across processes.  The
tripwire sees each block's shape.
"""

# pathway: serve-path  (hidden-sync lint applies: no implicit host round trips)
from __future__ import annotations

import copy
import json
import os
from dataclasses import asdict
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import observe
from ..device import DEFAULT_DTYPE, resolve_device, upload
from ..observe import hbm, profile
from ..ops.recompile_guard import RecompileTripwire
from ..parallel.mesh import gather_shards, local_shards
from ..robust import retry_call
from .hf_import import is_hf_checkpoint, load_hf_text_model
from .packing import pack_rows, pad_packed_rows, seg_bucket
from .params import init_encoder_, params_from_flax
from .safetensors import load_file_with_metadata, save_file
from .tokenizer import HashTokenizer
from .transformer import (
    TransformerConfig,
    TransformerEncoder,
    normalized_token_states,
    resolve_heads,
)

__all__ = ["CHECKPOINT_FILE", "SentenceEncoder"]

# the port's own checkpoint: one safetensors file in the checkpoint
# directory (a name ``is_hf_checkpoint`` does not match)
CHECKPOINT_FILE = "encoder.safetensors"
_CHECKPOINT_FORMAT = "pathway_tpu_torch.SentenceEncoder"
# the config fields a checkpoint must agree on (the dtype is the
# caller's: the state dict is f32 either way)
_SHAPE_FIELDS = ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff", "max_len", "pool")

_BATCH_BUCKETS = (1, 4, 16, 64, 256)


def _bucket(n: int, buckets=_BATCH_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


class SentenceEncoder:
    """``params``: a Flax parameter tree of numpy arrays from the
    reference (carried over by ``params_from_flax``); ``checkpoint_path``:
    an HF directory or the port's own checkpoint (see the module
    docstring); neither uses the port's seeded init from ``seed``.
    ``mesh``: split batches over its "data" axis (module docstring)."""

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
        checkpoint_path: Optional[str] = None,
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.normalize = normalize
        self.mesh = mesh
        if is_hf_checkpoint(checkpoint_path):
            module, self.config, self.tokenizer = load_hf_text_model(checkpoint_path, max_length, dtype)
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
            module = TransformerEncoder(self.config)
            if checkpoint_path is not None:
                module.load_state_dict(_load_checkpoint(checkpoint_path, self.config))
            elif params is None:
                init_encoder_(module, torch.Generator().manual_seed(seed))
            else:
                module.load_state_dict(params_from_flax(params, self.config))
        self.module = module.to(self.device).eval()
        # one replica of the parameters per distinct data device of the mesh
        self._replicas: Dict[str, torch.nn.Module] = {}
        if mesh is not None:
            for s in local_shards(mesh):
                dev = mesh.data_device(s)
                if str(dev) not in self._replicas:
                    same = dev.type == self.device.type and (dev.index or 0) == (self.device.index or 0)
                    self._replicas[str(dev)] = self.module if same else copy.deepcopy(self.module).to(dev)
        self.embed_cache = None
        self._tripwire = RecompileTripwire("SentenceEncoder")
        hbm.track_params("encoder", self)

    @property
    def hf(self) -> bool:
        """True when the module is an HF BERT import."""
        return not isinstance(self.module, TransformerEncoder)

    def save_checkpoint(self, path: str) -> None:
        """Write the trunk's state dict to ``path/encoder.safetensors``
        (the directory is made when missing); ``checkpoint_path=path``
        loads it back bit for bit."""
        if self.hf:
            raise ValueError("an HF-imported encoder is saved by its own checkpoint directory, not save_checkpoint")
        os.makedirs(path, exist_ok=True)
        cfg = {key: value for key, value in asdict(self.config).items() if key in _SHAPE_FIELDS}
        save_file(
            {name: t.detach().cpu().numpy() for name, t in self.module.state_dict().items()},
            os.path.join(path, CHECKPOINT_FILE),
            metadata={"format": _CHECKPOINT_FORMAT, "config": json.dumps(cfg, sort_keys=True)},
        )

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
        if self.mesh is not None:
            return self._mesh_forward(ids, mask)
        return self._normalized(self.module(ids, mask))

    def _mesh_forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``forward`` split into row blocks over the mesh's "data" axis:
        block ``s`` holds rows ``[s * per, (s + 1) * per)`` padded to
        ``_bucket(per)`` with fully masked rows."""
        B, L = ids.shape
        n = self.mesh.shape["data"]
        per = -(-B // n)
        rb = _bucket(per)
        spans = [(min(B, s * per), min(B, (s + 1) * per)) for s in range(n)]
        self._tripwire.observe(("block", rb, L))
        outs = []
        for s in local_shards(self.mesh):  # pathway: allow(hidden-sync): device→device scatter of the batch's row blocks to the mesh's data devices and gather of their outputs — ids and mask are already on the encoder's device (uploaded by the caller), so these are peer copies with no host wait
            lo, hi = spans[s]
            dev = self.mesh.data_device(s)
            bi = torch.zeros((rb, L), dtype=ids.dtype, device=dev)
            bm = torch.zeros((rb, L), dtype=mask.dtype, device=dev)
            bi[: hi - lo] = ids[lo:hi].to(dev)
            bm[: hi - lo] = mask[lo:hi].to(dev)
            outs.append(self._normalized(self._replicas[str(dev)](bi, bm)).to(self.device))
        blocks = gather_shards(self.mesh, torch.stack(outs))
        return torch.cat([blocks[s, : hi - lo] for s, (lo, hi) in enumerate(spans)])

    def set_embed_cache(self, cache) -> None:
        """Arm the tier-1 embedding cache (``EmbeddingCache`` or None) on
        ``encode_to_device``: its rows are this encoder's own earlier
        outputs, on its device."""
        self.embed_cache = cache

    def _cached_encode_rows(self, ids: np.ndarray, mask: np.ndarray, n: int) -> torch.Tensor:
        """Per-row lookup keyed on token ids in the ``encode:<normalize>``
        space, ONE bucketed forward for the misses under the
        ``encoder.dispatch`` retry, composition on the device."""

        def embed(ids_m, mask_m):
            self._tripwire.observe(ids_m.shape)
            # pathway: allow(recompile-hazard): shapes bucketed upstream — the embedding cache pads the misses with zero rows to _bucket(misses) before it calls embed (cache/embedding.py encode_rows)
            return _FORWARD(self, upload(ids_m, self.device), upload(mask_m, self.device))

        out, misses = self.embed_cache.encode_rows(
            ids, mask, n, embed, _bucket, space=f"encode:{int(self.normalize)}", site="encoder.dispatch"
        )
        if misses:
            observe.record_occupancy("encoder", misses, _bucket(misses))
        return out

    def encode_to_device(self, texts: Sequence[str]) -> torch.Tensor:
        """Batch encode with the result left on the device ([n, d] f32)."""
        texts = ["" if t is None else str(t) for t in texts]
        n = len(texts)
        if n == 0:
            return torch.zeros((0, self.config.d_model), device=self.device)
        padded = list(texts) + [""] * (_bucket(n) - n)
        ids, mask = self.tokenizer.encode_batch(padded)
        if self.embed_cache is not None:
            return self._cached_encode_rows(np.asarray(ids), np.asarray(mask), n)
        observe.record_occupancy("encoder", n, ids.shape[0])
        self._tripwire.observe(tuple(ids.shape))
        ids_t, mask_t = upload(ids, self.device), upload(mask, self.device)
        out = retry_call("encoder.dispatch", _FORWARD, self, ids_t, mask_t)
        return out[:n]

    @torch.no_grad()
    def encode_packed_to_device(self, texts: Sequence[str]) -> torch.Tensor:
        """Encode with sequence packing: tokenized documents share rows of
        ``max_len`` tokens (best-fit decreasing, at most 8 per row) with
        block-diagonal attention and per-document positions.  Returns
        ``[n, d]`` f32 on the device, aligned with ``texts``.  An HF
        module takes no segments: it encodes through ``encode_to_device``
        (packing is a shape optimization)."""
        if self.hf:
            return self.encode_to_device(texts)
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
        self._tripwire.observe(("packed", Rb, L, S))
        dev = self.device
        ids_t, seg_t, pos_t = upload(ids, dev), upload(segments, dev), upload(positions, dev)
        # the row index rides the same pinned, non-blocking upload as the
        # operands: a blocking copy after the launch would hold the host
        # until the packed forward finished
        flat_ix = upload(np.asarray([r * S + seg for r, seg in doc_slots], np.int64), dev)
        pooled = retry_call("encoder.dispatch", _PACKED, self, ids_t, seg_t, pos_t, S)  # [Rb, S, d]
        return pooled.reshape(Rb * S, -1).index_select(0, flat_ix)

    @torch.no_grad()
    def encode_token_states(self, texts: Sequence[str]):
        """Batch encode to per-token states on the device: returns
        ``(tokens [B, L, d] f32, mask [B, L] np int32, n_real)`` with the
        batch padded to its bucket by empty texts and ``L`` pinned to
        ``max_len``; pad tokens are zero, real tokens unit-norm.  Needs the
        in-framework trunk: an HF module pools inside its forward."""
        texts = ["" if t is None else str(t) for t in texts]
        n = len(texts)
        L = self.config.max_len
        if n == 0:
            empty = torch.zeros((0, L, self.config.d_model), device=self.device)
            return empty, np.zeros((0, L), np.int32), 0
        if self.hf:
            raise NotImplementedError(
                "token-state export needs the in-framework TransformerEncoder trunk "
                "(HF-imported modules pool internally)"
            )
        padded = list(texts) + [""] * (_bucket(n) - n)
        ids, mask = self.tokenizer.encode_batch(padded, pad_to=L)
        self._tripwire.observe(("tokens",) + tuple(ids.shape))
        ids_t, mask_t = upload(ids, self.device), upload(mask, self.device)
        return retry_call("encoder.dispatch", _TOKEN_STATES, self, ids_t, mask_t), mask, n

    @torch.no_grad()
    def _packed_forward(self, ids_t, seg_t, pos_t, S: int) -> torch.Tensor:
        return self._normalized(self.module(ids_t, seg_t > 0, segments=seg_t, positions=pos_t, n_segments=S))

    @torch.no_grad()
    def _token_states(self, ids_t, mask_t) -> torch.Tensor:
        return normalized_token_states(self.module(ids_t, mask_t, pool="none"), mask_t)

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """Batch encode: [n] strings -> [n, d] float32 numpy."""
        return self.encode_to_device(texts).cpu().numpy()

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode(texts)


# the device steps under the reference's profiler labels
_FORWARD = profile.wrap("encoder.forward", lambda enc, *a: enc.forward(*a))
_TOKEN_STATES = profile.wrap("encoder.token_states", lambda enc, *a: enc._token_states(*a))
_PACKED = profile.wrap("encoder.packed", lambda enc, *a: enc._packed_forward(*a))


def _load_checkpoint(path: str, config: TransformerConfig) -> Dict[str, torch.Tensor]:
    """The state dict of a ``save_checkpoint`` directory, its config
    checked against ``config``; any other path raises."""
    file = os.path.join(path, CHECKPOINT_FILE) if isinstance(path, str) else ""
    if not os.path.isfile(file):
        raise ValueError(
            f"checkpoint_path {path!r} is neither an HF checkpoint directory (config.json + "
            f"model.safetensors + vocab.txt) nor a pathway_tpu_torch checkpoint ({CHECKPOINT_FILE}, "
            "written by SentenceEncoder.save_checkpoint); an orbax checkpoint of the JAX package is "
            "restored with that package and passed as params="
        )
    tensors, meta = load_file_with_metadata(file)
    if meta.get("format") != _CHECKPOINT_FORMAT:
        raise ValueError(f"{file}: not a {_CHECKPOINT_FORMAT} checkpoint (format {meta.get('format')!r})")
    saved = json.loads(meta["config"])
    want = {key: value for key, value in asdict(config).items() if key in _SHAPE_FIELDS}
    if saved != want:
        raise ValueError(f"{file}: saved for {saved}, this encoder is {want}")
    return {name: torch.from_numpy(a) for name, a in tensors.items()}
