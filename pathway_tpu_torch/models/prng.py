"""Counter-based sampling RNG of the generator (counterpart of the
``jax.random`` calls in ``pathway_tpu/models/generator.py``: ``PRNGKey``,
``split`` and ``categorical``).

Threefry-2x32 (20 rounds) in torch integer ops, bit for bit the layout
JAX uses with ``jax_threefry_partitionable=True``:

- ``key(seed)`` is ``[0, seed & 0xFFFFFFFF]`` (``PRNGKey`` without
  64-bit mode);
- ``split(keys)`` gives ``threefry(key, (0, 0))`` and
  ``threefry(key, (0, 1))`` per key (``split(key, 2)``);
- ``random_bits(key, shape)`` hashes the flat element index ``i`` as the
  counter ``(i >> 32, i & 0xFFFFFFFF)`` and XORs the two output words;
- ``categorical`` is ``argmax(logits + gumbel)``, the gumbel noise
  ``-log(-log(u))`` with ``u`` from the top 23 random bits, as
  ``jax.random.uniform(minval=tiny)`` makes it.

Keys are int64 tensors holding 32-bit words (torch has no full uint32
arithmetic); every result is masked back to 32 bits.  A lane's chain
depends only on its seed and how many times it was split, never on the
other lanes of a batch: ``torch.Generator`` cannot give that, so it
stays the generator of the seeded weight init only.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["categorical", "key", "random_bits", "split", "threefry2x32", "uniform"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(
    k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of counters ``(x0, x1)`` under key ``(k0, k1)``; all
    int64 tensors of 32-bit words, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as a host ``[2]`` int64 array.  JAX
    without 64-bit mode takes the seed as an int32, so the high word is
    0 and the low word the seed's low 32 bits."""
    return np.array([0, int(seed) & _MASK], np.int64)


def split(keys: torch.Tensor) -> torch.Tensor:
    """``jax.random.split(k)`` of every key of ``keys [..., 2]``: returns
    ``[..., 2, 2]`` (the first new key, then the second)."""
    k0, k1 = keys[..., 0:1], keys[..., 1:2]
    zero = torch.zeros(2, dtype=torch.int64, device=keys.device)
    ctr = torch.arange(2, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32(k0, k1, zero, ctr)  # [..., 2] each
    return torch.stack([b0, b1], dim=-1)


def _counters(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _MASK


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit words of ``jax.random.bits(k, shape)`` as int64: one key
    ``[2]`` hashes the flat index of ``shape``; keys ``[S, 2]`` give
    ``[S, *shape]``, each lane with its own key (``vmap`` over keys)."""
    n = int(np.prod(shape)) if len(shape) else 1
    hi, lo = _counters(n, keys.device)
    k0 = keys[..., 0:1]
    k1 = keys[..., 1:2]
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return (b0 ^ b1).reshape(*keys.shape[:-1], *shape)


def uniform(keys: torch.Tensor, shape: Sequence[int], minval: float = 0.0) -> torch.Tensor:
    """f32 ``jax.random.uniform(k, shape, minval=minval, maxval=1)``."""
    bits = random_bits(keys, shape)
    one = 0x3F800000  # the bits of 1.0f
    floats = (((bits >> 9) | one).to(torch.int32)).view(torch.float32) - 1.0
    # scalars made on the device (a host scalar would be a copy, and a
    # sync, on every draw)
    lo = torch.full((), minval, dtype=torch.float32, device=keys.device)
    span = torch.full((), 1.0, dtype=torch.float32, device=keys.device) - lo
    return torch.maximum(lo, floats * span + lo)


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(k, logits)`` over the last axis of f32
    ``logits``.  One key ``[2]``: the gumbel draw over the whole
    ``logits`` shape (flat-index counters); keys ``[S, 2]`` with logits
    ``[S, V]``: one draw per lane from its own key (``vmap``)."""
    if keys.dim() == 1:
        u = uniform(keys, tuple(logits.shape), minval=_TINY)
    else:
        u = uniform(keys, (logits.shape[-1],), minval=_TINY)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(gumbel + logits, dim=-1)
