"""Transformer encoder trunk (counterpart of
``pathway_tpu/models/transformer.py``: ``TransformerConfig``,
``resolve_heads``, ``MlpBlock``, ``SelfAttention``, ``EncoderBlock``,
``TransformerEncoder``, ``token_state_trunk``,
``normalized_token_states``).

The numerics follow the Flax modules step by step, since a silent drift
here moves every embedding:

- parameters are f32; each Dense casts its input, kernel and bias to
  ``config.dtype`` and multiplies in that type, as ``nn.Dense(dtype=...)``;
- LayerNorm takes its statistics in f32 with Flax's fast variance
  (E[x^2] - E[x]^2, clipped at 0) and epsilon 1e-6, then casts to
  ``config.dtype``;
- GELU is the tanh approximation (Flax's ``nn.gelu`` default), written
  op for op as ``jax.nn.gelu`` so that bf16 rounds at the same points
  (one fused ``F.gelu`` rounds once and moves ~40% of the bf16 outputs
  by an ulp);
- masked attention scores are filled with ``finfo(float32).min``, not
  ``-inf``, so a fully masked pad row of a batch bucket gets a finite
  uniform softmax; the softmax runs in f32 and is cast back;
- the masked mean pool sums in ``config.dtype`` before the f32 cast.

Attention is plain torch (matmul, softmax, matmul): the reference
computes it with XLA, not with a Pallas kernel.

Packed forward (``segments`` / ``positions`` / ``n_segments``, the
reference's sequence packing): several short sequences share one row;
token l attends token m iff both carry the same nonzero segment id
(block-diagonal attention, the segment mask replacing the key mask),
positions restart per sequence, and the output is the per-segment
masked mean pool ``[B, n_segments, d]`` f32.

KV / slot decode twins (``kv_forward``): ``Ln`` new tokens per row attend
to per-layer K/V buffers ``[B, T, H, hd]`` written in place at
``write_pos`` (clamped into ``[0, T - Ln]``, as ``dynamic_update_slice``
clamps); ``q_pos`` masks each query to the positions at or before it;
``active`` leaves inactive lanes' K/V untouched; ``layers`` runs the
first blocks only (the draft trunk); int8 buffers take per-(layer, head,
channel) scales.  Their LayerNorms, each with the residual add before
it, run through the row-invariant kernels of ``ops/decode_rows.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.decode_rows import add_layer_norm_rows
from ..ops.kv_quant import dequantize_kv, quantize_kv

__all__ = [
    "Dense",
    "EncoderBlock",
    "LayerNorm",
    "MlpBlock",
    "SelfAttention",
    "KVTransformerDecoder",
    "SlotKVDecoder",
    "TransformerConfig",
    "TransformerEncoder",
    "gelu_tanh",
    "kv_forward",
    "masked_mean_pool",
    "normalized_token_states",
    "resolve_heads",
    "token_state_trunk",
]

_LN_EPS = 1e-6


def resolve_heads(d_model: int, requested: int) -> int:
    """Largest head count <= requested that divides d_model."""
    for h in range(min(requested, d_model), 0, -1):
        if d_model % h == 0:
            return h
    return 1


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 384
    n_heads: int = 6
    n_layers: int = 6
    d_ff: int = 1536
    max_len: int = 512
    dtype: Any = torch.bfloat16
    pool: str = "mean"  # mean | cls | none
    causal: bool = False


def token_state_trunk(config: TransformerConfig) -> "TransformerEncoder":
    """A pool-free twin of a trunk config: takes the SAME state dict (no
    pooling layer carries weights) and returns raw [B, L, d] states."""
    return TransformerEncoder(replace(config, pool="none"))


def masked_mean_pool(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The trunk's masked mean pool: sums in ``x.dtype``, then f32.  The
    one pool for the module and for the token-state export, so the two
    give bit-identical embeddings."""
    m = mask[:, :, None].to(x.dtype)
    summed = torch.sum(x * m, dim=1)
    counts = torch.clamp(torch.sum(m, dim=1), min=1.0)
    return (summed / counts).float()


def normalized_token_states(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """f32 cast, per-token L2 normalization (1e-9 floor), pad tokens
    zeroed — the one post-processing for late-interaction token states."""
    hidden = hidden.float()
    hidden = hidden / torch.clamp(
        torch.linalg.vector_norm(hidden, dim=-1, keepdim=True), min=1e-9
    )
    return hidden * mask[:, :, None].float()


class Dense(nn.Linear):
    """``nn.Linear`` with f32 parameters that computes in ``dtype``."""

    def __init__(self, d_in: int, d_out: int, dtype):
        super().__init__(d_in, d_out)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(dtype=...)``: f32 statistics, fast variance,
    epsilon 1e-6, output cast to ``dtype``."""

    def __init__(self, d: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + _LN_EPS) * self.weight
        y = (x32 - mean) * mul + self.bias
        return y.to(self.compute_dtype)


_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` with its op order."""
    c = torch.tensor(_SQRT_2_OVER_PI, dtype=torch.float32).to(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x**3)))))


class MlpBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.fc0 = Dense(cfg.d_model, cfg.d_ff, cfg.dtype)
        self.fc1 = Dense(cfg.d_ff, cfg.d_model, cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc1(gelu_tanh(self.fc0(x)))


class SelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.query = Dense(d, d, cfg.dtype)
        self.key = Dense(d, d, cfg.dtype)
        self.value = Dense(d, d, cfg.dtype)
        self.out = Dense(d, d, cfg.dtype)

    def forward(
        self, x: torch.Tensor, mask: torch.Tensor, segments: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        cfg = self.cfg
        B, L, _ = x.shape
        H = cfg.n_heads
        hd = cfg.d_model // H
        # [B, H, L, hd]
        q = self.query(x).view(B, L, H, hd).transpose(1, 2)
        k = self.key(x).view(B, L, H, hd).transpose(1, 2)
        v = self.value(x).view(B, L, H, hd).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        if segments is not None:
            # packed rows: block-diagonal attention within each nonzero
            # segment; [B, 1, L, L]
            same = segments[:, None, :, None] == segments[:, None, None, :]
            allowed = same & (segments[:, None, None, :] > 0)
        else:
            allowed = (mask > 0)[:, None, None, :]  # [B, 1, 1, L] key mask
        if cfg.causal:
            allowed = allowed & torch.ones(
                L, L, dtype=torch.bool, device=x.device
            ).tril()
        scores = scores.float().masked_fill(
            ~allowed, torch.finfo(torch.float32).min
        )
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, cfg.d_model)
        return self.out(out)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.ln_0 = LayerNorm(cfg.d_model, cfg.dtype)
        self.attn = SelfAttention(cfg)
        self.ln_1 = LayerNorm(cfg.d_model, cfg.dtype)
        self.mlp = MlpBlock(cfg)

    def forward(
        self, x: torch.Tensor, mask: torch.Tensor, segments: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        x = x + self.attn(self.ln_0(x), mask, segments)
        return x + self.mlp(self.ln_1(x))


class TransformerEncoder(nn.Module):
    """Token ids + mask -> pooled embedding [B, d] f32 (``pool`` mean or
    cls) or the final-LN hidden states [B, L, d] in ``config.dtype``
    (``pool="none"``); ``forward(..., pool=...)`` overrides the config's
    pool for one call.  Packed rows (``segments`` [B, L], 0 = pad,
    1..``n_segments`` = sequence within the row; ``positions`` [B, L]
    restarting per sequence) give ``[B, n_segments, d]`` f32, zero rows
    for absent segments."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        if config.pool not in ("mean", "cls", "none"):
            raise ValueError(f"unknown pool {config.pool!r}")
        self.config = config
        self.tok_embed = nn.Embedding(config.vocab_size, config.d_model)
        self.pos_embed = nn.Embedding(config.max_len, config.d_model)
        self.blocks = nn.ModuleList(
            EncoderBlock(config) for _ in range(config.n_layers)
        )
        self.final_ln = LayerNorm(config.d_model, config.dtype)

    def forward(
        self,
        ids: torch.Tensor,
        mask: torch.Tensor,
        segments: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        n_segments: int = 0,
        pool: Optional[str] = None,
    ) -> torch.Tensor:
        cfg = self.config
        pool = cfg.pool if pool is None else pool
        L = ids.shape[1]
        if positions is None:
            positions = torch.arange(L, device=ids.device)[None]
        # f32 tables looked up, then cast (Flax casts the table first:
        # the same values)
        x = self.tok_embed(ids).to(cfg.dtype) + self.pos_embed(positions).to(cfg.dtype)
        for block in self.blocks:
            x = block(x, mask, segments)
        x = self.final_ln(x)
        if segments is not None:
            # per-segment masked mean pool as one matmul per row:
            # onehot [B, L, S] x hidden [B, L, d] -> [B, S, d]
            if n_segments <= 0 or pool != "mean":
                raise ValueError("the packed forward needs n_segments > 0 and pool='mean'")
            seg_ids = torch.arange(1, n_segments + 1, device=ids.device)
            onehot = (segments[:, :, None] == seg_ids[None, None, :]).to(x.dtype)
            summed = torch.einsum("bls,bld->bsd", onehot, x)
            counts = torch.clamp(torch.sum(onehot, dim=1), min=1.0)[:, :, None]
            return (summed / counts).float()
        if pool == "none":
            return x
        if pool == "cls":
            return x[:, 0, :].float()
        if pool != "mean":
            raise ValueError(f"unknown pool {pool!r}")
        return masked_mean_pool(x, mask)


def _kv_attention(
    attn: SelfAttention,
    h: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    write_pos: torch.Tensor,
    q_pos: torch.Tensor,
    active: Optional[torch.Tensor],
    k_scales: Optional[torch.Tensor],
    v_scales: Optional[torch.Tensor],
) -> torch.Tensor:
    """One layer's incremental attention; ``k_cache`` / ``v_cache`` are
    ``[B, T, H, hd]`` views written in place."""
    cfg = attn.cfg
    B, Ln, _ = h.shape
    H = cfg.n_heads
    hd = cfg.d_model // H
    T = k_cache.shape[1]
    q = attn.query(h).view(B, Ln, H, hd)
    k_new = attn.key(h).view(B, Ln, H, hd)
    v_new = attn.value(h).view(B, Ln, H, hd)
    if k_scales is not None:
        k_new = quantize_kv(k_new, k_scales)
        v_new = quantize_kv(v_new, v_scales)
    # the write window [start, start + Ln), start clamped into [0, T - Ln]
    start = torch.clamp(write_pos.long(), 0, T - Ln)
    cols = start[:, None] + torch.arange(Ln, device=h.device)
    rows = torch.arange(B, device=h.device)[:, None]
    if active is not None:
        keep = ~active[:, None, None, None]
        k_new = torch.where(keep, k_cache[rows, cols], k_new)
        v_new = torch.where(keep, v_cache[rows, cols], v_new)
    k_cache[rows, cols] = k_new
    v_cache[rows, cols] = v_new
    if k_scales is not None:
        k_att = dequantize_kv(k_cache, k_scales, cfg.dtype)
        v_att = dequantize_kv(v_cache, v_scales, cfg.dtype)
    else:
        k_att, v_att = k_cache, v_cache
    scores = torch.matmul(q.transpose(1, 2), k_att.permute(0, 2, 3, 1)).float() / math.sqrt(hd)
    allowed = torch.arange(T, device=h.device)[None, None, :] <= q_pos.long()[:, :, None]
    scores = scores.masked_fill(~allowed[:, None], torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    out = torch.matmul(probs, v_att.transpose(1, 2)).transpose(1, 2).reshape(B, Ln, cfg.d_model)
    return attn.out(out)


def kv_forward(
    trunk: "TransformerEncoder",
    ids_new: torch.Tensor,
    positions: torch.Tensor,
    k_caches: torch.Tensor,
    v_caches: torch.Tensor,
    write_pos: torch.Tensor,
    q_pos: torch.Tensor,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
    layers: Optional[int] = None,
):
    """``Ln`` new tokens ``ids_new [B, Ln]`` at ``positions [B, Ln]``
    through the causal ``trunk`` against ``k_caches`` / ``v_caches``
    ``[B, n_layers, T, H, hd]``: returns ``(final-LN hidden [B, Ln, d],
    k_caches, v_caches)``, the buffers written in place (see the module
    docstring for ``write_pos``, ``q_pos``, ``active``, ``layers`` and the
    int8 scales)."""
    cfg = trunk.config
    dt = cfg.dtype
    n = cfg.n_layers if layers is None else layers
    # every LayerNorm takes the residual add before it in the same launch
    # (``add_layer_norm_rows``): the embedding sum, then per block the
    # attention and MLP residuals, the last one feeding ``final_ln``
    lns = [ln for blk in trunk.blocks[:n] for ln in (blk.ln_0, blk.ln_1)] + [trunk.final_ln]
    x, h = add_layer_norm_rows(
        trunk.tok_embed(ids_new).to(dt), trunk.pos_embed(positions).to(dt), lns[0].weight, lns[0].bias, dt
    )
    for i in range(n):
        blk = trunk.blocks[i]
        a = _kv_attention(
            blk.attn, h, k_caches[:, i], v_caches[:, i], write_pos, q_pos, active,
            None if k_scales is None else k_scales[i],
            None if v_scales is None else v_scales[i],
        )
        x, h = add_layer_norm_rows(x, a, blk.ln_1.weight, blk.ln_1.bias, dt)
        ln = lns[2 * i + 2]
        x, h = add_layer_norm_rows(x, blk.mlp(h), ln.weight, ln.bias, dt)
    return h, k_caches, v_caches


class KVTransformerDecoder(TransformerEncoder):
    """The incremental twin over the causal trunk's state dict:
    ``forward(ids_new, positions, k_caches, v_caches, write_pos, q_pos,
    k_scales=None, v_scales=None)`` -> ``(hidden, k_caches, v_caches)``
    (prefill: ``Ln`` = the prompt suffix, ``write_pos`` = the cached
    prefix length; step: ``Ln = 1``).  ``quant=True`` takes int8 buffers
    and the scales."""

    def __init__(self, config: TransformerConfig, quant: bool = False):
        super().__init__(replace(config, pool="none"))
        self.quant = quant

    def forward(self, ids_new, positions, k_caches, v_caches, write_pos, q_pos, k_scales=None, v_scales=None):
        if self.quant != (k_scales is not None):
            raise ValueError("int8 buffers need k_scales / v_scales, bf16 / f32 ones none")
        return kv_forward(self, ids_new, positions, k_caches, v_caches, write_pos, q_pos, k_scales, v_scales)


class SlotKVDecoder(TransformerEncoder):
    """The slot-pool twin: the batch is a pool of persistent slots and
    only ``active`` lanes move their K/V; ``layers=D`` runs the first
    ``D`` blocks plus ``final_ln``."""

    def __init__(self, config: TransformerConfig, quant: bool = False, layers: Optional[int] = None):
        super().__init__(replace(config, pool="none"))
        self.quant = quant
        self.layers = layers

    def forward(
        self, ids_new, positions, k_pool, v_pool, write_pos, q_pos, active, k_scales=None, v_scales=None
    ):
        if self.quant != (k_scales is not None):
            raise ValueError("int8 buffers need k_scales / v_scales, bf16 / f32 ones none")
        return kv_forward(
            self, ids_new, positions, k_pool, v_pool, write_pos, q_pos, k_scales, v_scales,
            active=active, layers=self.layers,
        )
