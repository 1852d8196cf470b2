"""int8 K/V of the continuous decoder's slot pool (counterpart of
``pathway_tpu/ops/kv_quant.py``): per-(layer, head, channel) scales,
static per generator.

K and V are LayerNorm outputs pushed through the key / value Dense, so
``|k_c| <= sqrt(d) * ||gamma * W[:, c]||_2 + |beta . W[:, c]| + |b_c|``
bounds every channel; ``scale = bound / 127``.  One scale for every
write makes quantization idempotent (``quantize(dequantize(q)) == q``),
so a warm prefix join re-quantizes captured blocks to the cold pool's
bytes.  Every attention read dequantizes (``models/transformer.py``
quant twins), so prefill and decode attend the same values.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch

__all__ = ["dequantize_kv", "kv_pool_scales", "quantize_kv"]


@torch.no_grad()
def kv_pool_scales(
    state: Mapping[str, torch.Tensor], n_layers: int, n_heads: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(k_scales, v_scales)``, each ``[L, H, hd]`` f32, from a trunk
    state dict (``blocks.{i}.ln_0`` and ``blocks.{i}.attn.{key,value}``);
    on the state dict's device."""
    k_rows, v_rows = [], []
    for i in range(n_layers):
        p = f"blocks.{i}."
        gamma = state[p + "ln_0.weight"].float()
        beta = state[p + "ln_0.bias"].float()
        d = gamma.shape[0]
        for name, rows in (("key", k_rows), ("value", v_rows)):
            W = state[p + f"attn.{name}.weight"].float().t()  # [in, out], the Flax kernel
            b = state[p + f"attn.{name}.bias"].float()
            bound = (
                float(d) ** 0.5 * torch.linalg.vector_norm(gamma[:, None] * W, dim=0)
                + torch.abs(beta @ W)
                + torch.abs(b)
            )
            rows.append(torch.clamp(bound / 127.0, min=1e-8).reshape(n_heads, d // n_heads))
    return torch.stack(k_rows), torch.stack(v_rows)


def quantize_kv(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``[..., T, H, hd]`` values -> int8 against ``[..., H, hd]`` scales:
    round half to even, clip to +-127."""
    q = torch.round(x.float() / scales.unsqueeze(-3))
    return torch.clamp(q, -127, 127).to(torch.int8)


def dequantize_kv(q: torch.Tensor, scales: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """int8 K/V back to ``dtype`` (the f32 product, then the cast)."""
    return (q.float() * scales.unsqueeze(-3)).to(dtype)
