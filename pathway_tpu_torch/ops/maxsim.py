"""Gather + dequantize + MaxSim + top-k over the forward index
(counterpart of ``pathway_tpu/ops/maxsim.py``: ``_maxsim_table``,
``build_maxsim_kernel``, ``build_maxsim_table_kernel`` and
``build_table_merge_kernel`` of the sharded forward index,
``maxsim_scores_host``).

The reference compiles this step with XLA, not with a Pallas kernel, so
the port writes it as plain torch ops; whether it earns a hand kernel is
decided by its card time (``PERF.md``).

For query token states ``qtok [B, Lq, d]`` (pad tokens masked by
``qmask``) and candidate slots ``[B, Kc]`` into the row buckets ``tok
[N, T, d]`` (int8 with per-channel ``scales [N, d]``, or f32) with
``nvalid [N]`` valid rows each, a candidate scores
``sum over real query tokens of max over its valid rows of q . row``.
Absent candidates (slot -1) and candidates with no valid row score
``-inf``.  The top-k keeps ``jax.lax.top_k``'s tie order (lower
candidate index first) through a stable descending sort, so the
permutation matches the reference integer for integer.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["maxsim_scores_host", "maxsim_table", "maxsim_topk", "merge_tables", "pack_topk"]


def maxsim_table(
    qtok: torch.Tensor,
    qmask: torch.Tensor,
    tok: torch.Tensor,
    scales: torch.Tensor,
    nvalid: torch.Tensor,
    slots: torch.Tensor,
    quantized: bool,
) -> torch.Tensor:
    """The ``[B, Kc]`` f32 candidate score table (``-inf`` for absent
    slots): gather rows by slot, dequantize, one einsum, mask rows at
    ``t >= nvalid``, per-query-token max, pad query tokens 0, sum."""
    B, Kc = slots.shape
    T = tok.shape[1]
    flat = torch.clamp(slots, min=0).reshape(B * Kc).long()
    docs = tok.index_select(0, flat).float()  # [B*Kc, T, d]
    if quantized:
        docs = docs * scales.index_select(0, flat)[:, None, :]
    nv = nvalid.index_select(0, flat)
    docs = docs.reshape(B, Kc, T, -1)
    sim = torch.einsum("bld,bktd->bklt", qtok.float(), docs)
    tvalid = (torch.arange(T, device=tok.device)[None, :] < nv[:, None]).reshape(B, Kc, 1, T)
    sim = sim.masked_fill(~tvalid, float("-inf"))
    best = sim.amax(dim=3)  # [B, Kc, Lq]
    # pad query tokens contribute 0; real tokens of a candidate with no
    # valid row stay -inf, so its sum is -inf
    best = torch.where(qmask[:, None, :] > 0, best, torch.zeros_like(best))
    scores = best.sum(dim=2)
    return torch.where(slots >= 0, scores, torch.full_like(scores, float("-inf")))


def pack_topk(table: torch.Tensor, k_out: int) -> torch.Tensor:
    """Per-row top ``k_out`` of a ``[B, Kc]`` score table as ONE packed
    ``[B, 2 * k_out]`` int32 tensor (score bits, then candidate indices).
    A stable descending sort keeps the lower index first among ties, as
    ``jax.lax.top_k`` does."""
    s, perm = torch.sort(table, dim=1, descending=True, stable=True)
    s, perm = s[:, :k_out].contiguous(), perm[:, :k_out].to(torch.int32)
    return torch.cat([s.view(torch.int32), perm], dim=1)


def maxsim_topk(qtok, qmask, tok, scales, nvalid, slots, k_out: int, quantized: bool) -> torch.Tensor:
    """The serve step (the reference's ``build_maxsim_kernel``):
    ``maxsim_table`` then ``pack_topk``."""
    return pack_topk(maxsim_table(qtok, qmask, tok, scales, nvalid, slots, quantized), k_out)


def merge_tables(tables, k_out: int) -> torch.Tensor:
    """The sharded forward index's merge (the reference's
    ``build_table_merge_kernel``): the elementwise max of ``S`` per-shard
    ``[B, Kc]`` tables, then ``pack_topk``.  Routing gives every
    candidate one owning shard, so each cell has at most one finite
    contributor and the merged table equals one unsharded index's."""
    table = tables[0]
    for t in tables[1:]:
        table = torch.maximum(table, t)
    return pack_topk(table, k_out)


def maxsim_scores_host(
    qtok: np.ndarray, qmask: np.ndarray, docs: np.ndarray, nvalid: np.ndarray
) -> np.ndarray:
    """NumPy reference of the scoring math: ``qtok [Lq, d]``, ``qmask
    [Lq]``, ``docs [K, T, d]`` (dequantized), ``nvalid [K]`` -> ``[K]``
    MaxSim scores; a candidate with no valid row scores ``-inf``."""
    Lq = qtok.shape[0]
    K = docs.shape[0]
    out = np.full(K, -np.inf, np.float32)
    for ki in range(K):
        nv = int(nvalid[ki])
        if nv <= 0:
            continue
        sim = qtok @ docs[ki, :nv].T  # [Lq, nv]
        best = sim.max(axis=1)
        out[ki] = float(best[np.asarray(qmask[:Lq]) > 0].sum())
    return out
