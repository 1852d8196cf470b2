"""Sharded top-k (counterpart of ``pathway_tpu/ops/topk.py``).

The recipe for a row-sharded score matrix: score each row block on its
own device, take a LOCAL top-k there, move only the ``(score, index)``
pairs to the merge device, and merge: ``S * B * k`` elements cross
between devices instead of ``B * N``.

Every selection keeps ``jax.lax.top_k``'s order on ties: the lower
position first, so in a merge the left operand (the lower shard) first.
``torch.topk`` promises no tie order, so selections here are a stable
descending sort cut to ``k``; ``-inf`` pads and their ids land where the
reference puts them.  The merges are plain torch ops, as they are XLA
programs (no Pallas kernel) in the reference.  Over a mesh across
processes the candidates cross ranks by one ``all_gather``
(``sharded_topk``).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import observe
from ..parallel.mesh import gather_shards

__all__ = [
    "local_score_topk",
    "merge_topk",
    "sharded_topk",
    "stable_topk",
    "tree_merge_topk",
    "tree_merge_topk_host",
]


def stable_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis of f32 ``[B, n]``: the ``k``
    largest, descending, the lower index first among ties.  The sort runs
    on the IEEE total-order key of the bits, as ``lax.top_k`` compares
    (``-0.0`` below ``+0.0``)."""
    bits = scores.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    i = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(scores, -1, i), i


def local_score_topk(
    queries: torch.Tensor, matrix: torch.Tensor, valid: torch.Tensor, k: int, metric: str = "dot"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense scores of ``queries [B, d]`` against one row block ``matrix
    [N, d]`` and its top-k: ``(scores [B, k] f32, rows [B, k] int64)``.
    Products accumulate in f32 (a bf16 block through an f32 copy);
    invalid rows score ``-inf``; past ``N`` the result pads with ``-inf``
    and row 0.  "l2sq" ranks by ``2 q.x - ||x||^2``."""
    m = matrix.float()
    scores = queries.to(matrix.dtype).float() @ m.t()
    if metric == "l2sq":
        scores = 2 * scores - (m * m).sum(dim=1)[None, :]
    scores = scores.masked_fill(~valid[None, :], float("-inf"))
    k_eff = min(k, matrix.shape[0])
    s, i = stable_topk(scores, k_eff)
    if k_eff < k:
        pad = k - k_eff
        s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
        i = torch.nn.functional.pad(i, (0, pad), value=0)
    return s, i


def merge_topk(
    all_scores: torch.Tensor, all_idx: torch.Tensor, shard_offsets: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard candidates ``[S, B, kk]`` (local row indices) -> global
    top-k ``([B, k] scores, [B, k] global rows)``."""
    S, B, kk = all_scores.shape
    global_idx = all_idx + shard_offsets.to(all_idx.dtype)[:, None, None]
    flat_s = all_scores.permute(1, 0, 2).reshape(B, S * kk)
    flat_i = global_idx.permute(1, 0, 2).reshape(B, S * kk)
    s, pos = stable_topk(flat_s, k)
    return s, torch.gather(flat_i, 1, pos)


def tree_merge_topk(scores: torch.Tensor, shard_ids: torch.Tensor, ids: torch.Tensor, k: int):
    """Pairwise tree reduce over the shard axis of ``[S, B, K]``
    candidate lists (scores descending per shard): each level merges two
    neighbours' lists with one top-k over their 2K-wide concat, an odd
    last list passing up unchanged, until one list remains.  Returns
    ``(scores, shard_ids, ids)``, each ``[B, k]``, by score descending."""
    level = [(scores[s], shard_ids[s], ids[s]) for s in range(scores.shape[0])]
    while len(level) > 1:
        nxt = []
        for a in range(0, len(level) - 1, 2):
            (sa, ha, ia), (sb, hb, ib) = level[a], level[a + 1]
            cs = torch.cat([sa, sb], dim=1)
            ms, pos = stable_topk(cs, min(k, cs.shape[1]))
            nxt.append((ms, torch.gather(torch.cat([ha, hb], dim=1), 1, pos),
                        torch.gather(torch.cat([ia, ib], dim=1), 1, pos)))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    s, h, i = level[0]
    if s.shape[1] > k:
        s, pos = stable_topk(s, k)
        h, i = torch.gather(h, 1, pos), torch.gather(i, 1, pos)
    return s, h, i


def tree_merge_topk_host(scores: np.ndarray, shard_ids: np.ndarray, ids: np.ndarray, k: int):
    """NumPy reference of ``tree_merge_topk`` (tests, and the host-merge
    probe that prices the device merge): the same candidate set and
    order, one stable host argsort over the shard-major concat."""
    S, B, K = scores.shape

    def flat(a):
        return np.transpose(a, (1, 0, 2)).reshape(B, S * K)

    order = np.argsort(-flat(scores), axis=1, kind="stable")[:, :k]
    return tuple(np.take_along_axis(flat(a), order, axis=1) for a in (scores, shard_ids, ids))


def _exchange(mesh, scores: torch.Tensor, idx: torch.Tensor):
    """Every rank's ``[S_local, B, k]`` candidates in global shard order:
    one ``all_gather`` of the pairs packed as f64 (f32 scores and row
    indices below 2^53 round-trip exactly)."""
    t0 = time.perf_counter()
    k = scores.shape[-1]
    out = gather_shards(mesh, torch.cat([scores.double(), idx.double()], dim=-1))
    observe.histogram("pathway_serve_shard_stage_seconds", stage="exchange", shard="all").observe_s(
        time.perf_counter() - t0
    )
    return out[..., :k].float(), out[..., k:].long()


def sharded_topk(
    mesh,
    queries: torch.Tensor,
    blocks: Sequence[Optional[torch.Tensor]],
    valids: Sequence[Optional[torch.Tensor]],
    k: int,
    metric: str = "dot",
    merge_device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the row blocks of a port ``Mesh`` (block ``s`` on
    ``mesh.data_device(s)``, all of one row count): per-block score and
    local top-k on the block's device, the ``(score, index)`` pairs
    gathered to ``merge_device`` (the queries' device by default), then
    ``merge_topk``.  Returns ``([B, k] scores, [B, k] global rows)``.

    On a mesh across processes a block another rank owns is None: each
    rank scores its own blocks, one ``all_gather`` moves the
    ``[S_local, B, k]`` candidates (through host memory under gloo), and
    every rank merges all ``S`` lists in global shard order, so every
    rank's answer equals a one-process mesh's bit for bit."""
    dev = merge_device or queries.device
    local = [s for s, b in enumerate(blocks) if b is not None]
    rows_per_shard = blocks[local[0]].shape[0]
    parts_s: List[torch.Tensor] = []
    parts_i: List[torch.Tensor] = []
    for s in local:
        ls, li = local_score_topk(queries.to(mesh.data_device(s)), blocks[s], valids[s], k, metric=metric)
        parts_s.append(ls.to(dev))
        parts_i.append(li.to(dev))
    all_s, all_i = torch.stack(parts_s), torch.stack(parts_i)
    if len(local) < len(blocks):
        all_s, all_i = _exchange(mesh, all_s, all_i)
    offsets = torch.arange(len(blocks), device=dev, dtype=torch.int64) * rows_per_shard
    return merge_topk(all_s, all_i, offsets, k)
