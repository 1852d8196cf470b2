"""ClipModel — dual text / image encoder for multimodal retrieval
(counterpart of ``pathway_tpu/models/clip.py``: ``_ImageEncoder``,
``_ClipModule``, ``ClipModel``).

The text tower is the port's ``TransformerEncoder`` (masked mean pool);
the image tower patchifies ``[B, S, S, 3]`` images with a strided
``Conv`` (kernel = stride = ``patch``, Flax's ``SAME`` padding), adds a
learned position table, runs the same ``EncoderBlock`` stack, a final
LayerNorm and a mean over the patches.  Each tower is projected to
``proj_dim`` by an f32 ``Dense`` and L2-normalized, so text and image rows
live in one space.  As in the reference, the Conv, the position table
and the blocks compute in ``config.dtype`` (the parameters are f32) and
the projections in f32.  Flax's Conv is NHWC with a ``[kh, kw, in,
out]`` kernel; the port's ``Conv2d`` is NCHW with ``[out, in, kh, kw]``,
and the patch grid is flattened row-major over (h, w) as the reference's
NHWC reshape does.  The text path never runs the image tower, whose
output it would not use.

``encode_text`` / ``encode_image`` return host rows ``[n, proj_dim]`` f32
(the reference's synchronous contract).  Batches pad to the encoder's
buckets; images are cropped or zero-padded into ``[b, S, S, 3]`` and a
2-D image is stacked to three channels.  Each launch retries under the
``clip.dispatch`` site; submit-to-host lands on
``pathway_serve_model_seconds{model="clip_text"|"clip_image"}`` with the
occupancy records ``clip_text`` / ``clip_image``, and the shape keys
(``("text", b, L)``, ``("image", b)``) go through the ``ClipModel``
tripwire.  The module's parameters are on the device-memory ledger.
"""

from __future__ import annotations

import time
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import observe
from ..device import DEFAULT_DTYPE, resolve_device, upload
from ..observe import hbm
from ..ops.recompile_guard import RecompileTripwire
from ..robust import retry_call
from .encoder import _bucket
from .params import clip_params_from_flax, init_clip_
from .tokenizer import HashTokenizer
from .transformer import Dense, EncoderBlock, LayerNorm, TransformerConfig, TransformerEncoder, resolve_heads

__all__ = ["ClipModel", "ClipModule", "ImageEncoder"]

_H_TEXT = observe.histogram("pathway_serve_model_seconds", model="clip_text")
_H_IMAGE = observe.histogram("pathway_serve_model_seconds", model="clip_image")


def _same_pad(size: int, patch: int):
    """Flax ``SAME`` padding of one spatial axis at kernel = stride =
    ``patch``: (low, high)."""
    out = -(-size // patch)
    total = max((out - 1) * patch + patch - size, 0)
    return total // 2, total - total // 2


class ImageEncoder(nn.Module):
    """``[B, S, S, 3]`` f32 images in [0, 1] -> ``[B, d]`` f32."""

    def __init__(self, config: TransformerConfig, patch: int, image_size: int):
        super().__init__()
        self.config = config
        self.patch = patch
        d = config.d_model
        self.patchify = nn.Conv2d(3, d, kernel_size=patch, stride=patch)
        self.pos = nn.Embedding((-(-image_size // patch)) ** 2, d)
        self.blocks = nn.ModuleList(EncoderBlock(config) for _ in range(config.n_layers))
        self.ln = LayerNorm(d, config.dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.config.dtype
        B = images.shape[0]
        x = images.to(dt).permute(0, 3, 1, 2)  # NHWC -> NCHW
        (hl, hh), (wl, wh) = _same_pad(x.shape[2], self.patch), _same_pad(x.shape[3], self.patch)
        if hl or hh or wl or wh:
            x = F.pad(x, (wl, wh, hl, hh))
        x = F.conv2d(x, self.patchify.weight.to(dt), self.patchify.bias.to(dt), stride=self.patch)
        x = x.permute(0, 2, 3, 1).reshape(B, -1, self.config.d_model)  # patches row-major over (h, w)
        L = x.shape[1]
        x = x + self.pos.weight[:L].to(dt)[None]
        mask = torch.ones((B, L), dtype=torch.int32, device=x.device)
        for block in self.blocks:
            x = block(x, mask)
        return self.ln(x).mean(dim=1).float()


class ClipModule(nn.Module):
    """The two towers and their f32 projections."""

    def __init__(self, config: TransformerConfig, image_size: int, patch: int, proj_dim: int):
        super().__init__()
        self.text = TransformerEncoder(config)
        self.image = ImageEncoder(config, patch, image_size)
        self.text_proj = Dense(config.d_model, proj_dim, torch.float32)
        self.image_proj = Dense(config.d_model, proj_dim, torch.float32)

    @staticmethod
    def _unit(x: torch.Tensor) -> torch.Tensor:
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-9)

    def encode_text(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self._unit(self.text_proj(self.text(ids, mask)))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self._unit(self.image_proj(self.image(images)))


class ClipModel:
    """``params``: the reference's ``_ClipModule`` tree as numpy arrays
    (carried over by ``clip_params_from_flax``); ``None`` uses the port's
    seeded init from ``seed``."""

    def __init__(
        self,
        dimension: int = 256,
        proj_dim: int = 256,
        n_layers: int = 4,
        n_heads: int = 4,
        image_size: int = 64,
        patch: int = 16,
        max_length: int = 64,
        vocab_size: int = 32768,
        seed: int = 3,
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
        self.image_size = image_size
        self.proj_dim = proj_dim
        self.tokenizer = HashTokenizer(vocab_size=vocab_size, max_length=max_length)
        module = ClipModule(self.config, image_size, patch, proj_dim)
        if params is None:
            init_clip_(module, torch.Generator().manual_seed(seed))
        else:
            module.load_state_dict(clip_params_from_flax(params, self.config))
        self.module = module.to(self.device).eval()
        self._tripwire = RecompileTripwire("ClipModel")
        hbm.track_params("clip", self)

    def get_embedding_dimension(self) -> int:
        return self.proj_dim

    @torch.no_grad()
    def encode_text(self, texts: Sequence[str]) -> np.ndarray:
        """[n] strings -> [n, proj_dim] f32 unit rows."""
        n = len(texts)
        if n == 0:
            return np.zeros((0, self.proj_dim), np.float32)
        b = _bucket(n)
        ids, mask = self.tokenizer.encode_batch([str(t) for t in texts] + [""] * (b - n))
        self._tripwire.observe(("text",) + tuple(ids.shape))
        t0 = time.perf_counter_ns()
        observe.record_occupancy("clip_text", n, b)
        ids_t, mask_t = upload(ids, self.device), upload(mask, self.device)
        out = retry_call("clip.dispatch", self.module.encode_text, ids_t, mask_t)
        host = out[:n].cpu().numpy()  # pathway: allow(value-flow): encode_text's contract is synchronous host rows (the serve path goes through submit/complete, which books its fetch)
        _H_TEXT.observe_ns(time.perf_counter_ns() - t0)
        return host

    def image_batch(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """Images cropped or zero-padded into ``[bucket(n), S, S, 3]`` f32;
        a 2-D image is stacked to three channels."""
        S = self.image_size
        batch = np.zeros((_bucket(len(images)), S, S, 3), np.float32)
        for i, img in enumerate(images):
            img = np.asarray(img, dtype=np.float32)
            if img.ndim == 2:
                img = np.stack([img] * 3, axis=-1)
            h, w = img.shape[:2]
            hh, ww = min(h, S), min(w, S)
            batch[i, :hh, :ww, :] = img[:hh, :ww, :3]
        return batch

    @torch.no_grad()
    def encode_image(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """[n] images (``[h, w, 3]`` or ``[h, w]``, values in [0, 1]) ->
        [n, proj_dim] f32 unit rows."""
        n = len(images)
        if n == 0:
            return np.zeros((0, self.proj_dim), np.float32)
        batch = self.image_batch(images)
        self._tripwire.observe(("image", batch.shape[0]))
        t0 = time.perf_counter_ns()
        observe.record_occupancy("clip_image", n, batch.shape[0])
        # pathway: allow(recompile-hazard): shapes bucketed upstream — image_batch pads the images to [_bucket(n), S, S, 3], the census key this scope observes
        out = retry_call("clip.dispatch", self.module.encode_image, upload(batch, self.device))
        host = out[:n].cpu().numpy()  # pathway: allow(value-flow): encode_image's contract is synchronous host rows, same as encode_text
        _H_IMAGE.observe_ns(time.perf_counter_ns() - t0)
        return host
