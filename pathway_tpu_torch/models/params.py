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

__all__ = ["cross_encoder_params_from_flax", "init_encoder_", "params_from_flax"]


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


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
        blk = tree[f"block_{i}"]
        p = f"blocks.{i}."
        for src, dst in (("LayerNorm_0", "ln_0"), ("LayerNorm_1", "ln_1")):
            sd[p + dst + ".weight"] = _t(blk[src]["scale"])
            sd[p + dst + ".bias"] = _t(blk[src]["bias"])
        dense = {
            f"attn.{name}": blk["SelfAttention_0"][name]
            for name in ("query", "key", "value", "out")
        }
        dense["mlp.fc0"] = blk["MlpBlock_0"]["Dense_0"]
        dense["mlp.fc1"] = blk["MlpBlock_0"]["Dense_1"]
        for dst, leaf in dense.items():
            sd[p + dst + ".weight"] = _t(leaf["kernel"]).t().contiguous()
            sd[p + dst + ".bias"] = _t(leaf["bias"])
    return sd


def cross_encoder_params_from_flax(
    tree: Mapping[str, Any], config: TransformerConfig
) -> Dict[str, torch.Tensor]:
    """Flax tree of the reference's cross-encoder -> state dict of the
    port's ``CrossEncoderModule``."""
    sd = {f"trunk.{k}": v for k, v in params_from_flax(tree["trunk"], config).items()}
    for name in ("head_dense", "head_out"):
        sd[f"{name}.weight"] = _t(tree[name]["kernel"]).t().contiguous()
        sd[f"{name}.bias"] = _t(tree[name]["bias"])
    return sd


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
