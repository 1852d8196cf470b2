"""Parameters of the encoder trunk and the cross-encoder: the bridge
from the reference's Flax trees, and the port's own seeded init.

Flax tree of ``pathway_tpu`` ``TransformerEncoder`` (``module.init``):

- ``tok_embed/embedding [V, d]``, ``pos_embed/embedding [max_len, d]``;
- ``block_{i}/LayerNorm_{0,1}/{scale, bias}``;
- ``block_{i}/SelfAttention_0/{query, key, value, out}/{kernel [d, d], bias}``;
- ``block_{i}/MlpBlock_0/Dense_{0,1}/{kernel, bias}``;
- ``final_ln/{scale, bias}``.

The cross-encoder's tree (``pathway_tpu`` ``_CrossEncoderModule``) is
``trunk/...`` (the tree above) plus the head ``head_dense/{kernel [d, d],
bias}`` and ``head_out/{kernel [d, 1], bias}``.

The CLIP tree (``pathway_tpu`` ``_ClipModule``) is ``text/...`` (the
trunk's tree), ``image/{patchify/{kernel [kh, kw, 3, d], bias},
pos/embedding [L, d], block_{i}/..., LayerNorm_0/{scale, bias}}`` and the
projections ``text_proj`` / ``image_proj`` ``{kernel [d, p], bias}``.  A
Flax ``Conv`` kernel is ``[kh, kw, in, out]`` over NHWC; a torch
``Conv2d`` weight is ``[out, in, kh, kw]`` over NCHW.

A Flax Dense ``kernel`` is ``[in, out]``; a torch ``Linear.weight`` is
``[out, in]``, so kernels are transposed.  LayerNorm ``scale`` becomes
``weight``.  The bridge takes numpy arrays only (``np.asarray`` of each
leaf), so this module never needs JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from .transformer import Dense, TransformerConfig

__all__ = [
    "clip_params_from_flax",
    "cross_encoder_params_from_flax",
    "generator_params_from_flax",
    "init_clip_",
    "init_encoder_",
    "params_from_flax",
]


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _block_from_flax(blk: Mapping[str, Any], p: str, sd: Dict[str, torch.Tensor]) -> None:
    """One ``EncoderBlock``'s Flax subtree into ``sd`` under prefix ``p``."""
    for src, dst in (("LayerNorm_0", "ln_0"), ("LayerNorm_1", "ln_1")):
        sd[p + dst + ".weight"] = _t(blk[src]["scale"])
        sd[p + dst + ".bias"] = _t(blk[src]["bias"])
    dense = {f"attn.{name}": blk["SelfAttention_0"][name] for name in ("query", "key", "value", "out")}
    dense["mlp.fc0"] = blk["MlpBlock_0"]["Dense_0"]
    dense["mlp.fc1"] = blk["MlpBlock_0"]["Dense_1"]
    for dst, leaf in dense.items():
        _dense(leaf, p + dst, sd)


def _dense(leaf: Mapping[str, Any], name: str, sd: Dict[str, torch.Tensor]) -> None:
    sd[name + ".weight"] = _t(leaf["kernel"]).t().contiguous()
    sd[name + ".bias"] = _t(leaf["bias"])


def params_from_flax(
    tree: Mapping[str, Any], config: TransformerConfig
) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (nested dicts of numpy arrays, ``params``
    level already stripped) -> state dict of the port's
    ``TransformerEncoder`` for ``config``."""
    sd: Dict[str, torch.Tensor] = {
        "tok_embed.weight": _t(tree["tok_embed"]["embedding"]),
        "pos_embed.weight": _t(tree["pos_embed"]["embedding"]),
        "final_ln.weight": _t(tree["final_ln"]["scale"]),
        "final_ln.bias": _t(tree["final_ln"]["bias"]),
    }
    for i in range(config.n_layers):
        _block_from_flax(tree[f"block_{i}"], f"blocks.{i}.", sd)
    return sd


def cross_encoder_params_from_flax(
    tree: Mapping[str, Any], config: TransformerConfig
) -> Dict[str, torch.Tensor]:
    """Flax tree of the reference's cross-encoder -> state dict of the
    port's ``CrossEncoderModule``."""
    sd = {f"trunk.{k}": v for k, v in params_from_flax(tree["trunk"], config).items()}
    for name in ("head_dense", "head_out"):
        _dense(tree[name], name, sd)
    return sd


def clip_params_from_flax(
    tree: Mapping[str, Any], config: TransformerConfig
) -> Dict[str, torch.Tensor]:
    """Flax tree of the reference's ``_ClipModule`` -> state dict of the
    port's ``ClipModule`` (``models/clip.py``)."""
    sd = {f"text.{k}": v for k, v in params_from_flax(tree["text"], config).items()}
    img = tree["image"]
    # [kh, kw, in, out] -> [out, in, kh, kw]
    sd["image.patchify.weight"] = _t(img["patchify"]["kernel"]).permute(3, 2, 0, 1).contiguous()
    sd["image.patchify.bias"] = _t(img["patchify"]["bias"])
    sd["image.pos.weight"] = _t(img["pos"]["embedding"])
    for i in range(config.n_layers):
        _block_from_flax(img[f"block_{i}"], f"image.blocks.{i}.", sd)
    sd["image.ln.weight"] = _t(img["LayerNorm_0"]["scale"])
    sd["image.ln.bias"] = _t(img["LayerNorm_0"]["bias"])
    for name in ("text_proj", "image_proj"):
        _dense(tree[name], name, sd)
    return sd


def generator_params_from_flax(
    tree: Mapping[str, Any], config: TransformerConfig
) -> Dict[str, torch.Tensor]:
    """Flax tree of the reference's ``TextGenerator`` (a causal trunk
    with no pool, so the trunk's tree) -> state dict of the port's
    trunk, which the generator's KV and slot twins share.  The readout
    has no parameters of its own: it is ``h.float() @
    tok_embed.float().T``."""
    extra = set(tree) - {"tok_embed", "pos_embed", "final_ln"} - {f"block_{i}" for i in range(config.n_layers)}
    if extra:
        raise ValueError(f"not a generator tree: unexpected {sorted(extra)}")
    return params_from_flax(tree, config)


@torch.no_grad()
def init_encoder_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with the Flax distributions (not the Flax numbers):
    xavier-uniform Dense kernels with zero biases, normal(0.02)
    embeddings, LayerNorm scale 1 and bias 0.  In place; ``generator``
    must live on the module's device."""
    for m in module.modules():
        if isinstance(m, Dense):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, std=0.02, generator=generator)


@torch.no_grad()
def init_clip_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of the port's ``ClipModule`` with the Flax
    distributions: the trunks as ``init_encoder_``; the patchify ``Conv``
    and the two projections (Flax defaults) LeCun-normal truncated at two
    standard deviations, zero biases."""
    init_encoder_(module, generator)
    for m in (module.image.patchify, module.text_proj, module.image_proj):
        fan_in = m.weight[0].numel()
        # Flax's truncated normal keeps the variance 1 / fan_in after the cut
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        nn.init.zeros_(m.bias)
