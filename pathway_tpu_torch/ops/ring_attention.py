"""Ring attention: sequence-parallel exact attention for long contexts
(counterpart of ``pathway_tpu/ops/ring_attention.py``).

The sequence is split into ``n`` blocks over one axis of a port ``Mesh``
(``("sp",)`` by default), block ``i`` on the axis's device ``i``.  Each
device keeps its Q block and walks the K/V blocks in ring order: its own
block first, then ``n - 1`` rotations, each passing every held K/V block
(with its key mask and positions) to the next device by a ``.to(device)``.
Scores accumulate as an online softmax in f32: a running max per query,
``exp`` corrections of the earlier sums when it grows, and queries whose
every key is masked give 0.  In exact arithmetic this is full softmax
attention; each device holds ``O(L / n)`` of the sequence.

Over a mesh whose axis spans processes (``parallel/mesh.py``
``is_multiprocess``), each rank keeps only the blocks it owns
(``local_shards``): a rotation passes K/V between the rank's own blocks
by ``.to(device)`` and sends its last block to the next rank while the
previous rank's last block arrives (``distributed.ring_shift``, the
counterpart of ``ppermute``).  The output blocks are then gathered, so
every rank returns the whole ``[B, L, H, Dh]``, as the reference's
``shard_map`` returns a global array.

The reference writes this with ``shard_map`` and ``ppermute`` in XLA, not
in Pallas, so the port writes it as plain torch ops (einsum, exp, max)
and ``torch.distributed`` point-to-point sends.

Layouts, as the reference's: q, k, v ``[B, L, H, Dh]``; ``kv_mask``
``[B, L]`` key validity; ``positions`` ``[B, L]`` global token positions
(for ``causal``).
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import torch

from ..parallel import distributed
from ..parallel.mesh import gather_shards, is_multiprocess, local_shards

__all__ = ["dense_attention", "ring_attention_blocks", "ring_attention_sharded"]


def _block_attn(q32, k, v, allowed, q_pos, k_pos, causal: bool, scale: float):
    """One Q block against one K/V block: ``(max [B, H, Lq], exp(s - max)
    @ v [B, Lq, H, Dh], row sums [B, H, Lq])``, all f32."""
    s = torch.einsum("blhd,bmhd->bhlm", q32, k.float()) * scale
    allowed = allowed[:, None, None, :]
    if causal:
        allowed = allowed & (k_pos[:, None, None, :] <= q_pos[:, None, :, None])
    s = s.masked_fill(~allowed, float("-inf"))
    m = s.amax(dim=-1)
    safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    o = torch.einsum("bhlm,bmhd->blhd", p, v.float())
    return m, o, p.sum(dim=-1)


def _merge(m, o, l, bm, bo, bl):
    """Fold one block's pieces into the running ``(max, out, sum)``."""
    new_m = torch.maximum(m, bm)
    safe = torch.where(torch.isfinite(new_m), new_m, torch.zeros_like(new_m))
    corr_old = torch.where(torch.isfinite(m), torch.exp(m - safe), torch.zeros_like(m))
    corr_new = torch.where(torch.isfinite(bm), torch.exp(bm - safe), torch.zeros_like(bm))
    o = o * corr_old.transpose(1, 2)[..., None] + bo * corr_new.transpose(1, 2)[..., None]
    return new_m, o, l * corr_old + bl * corr_new


_Held = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _ring(
    q: Sequence[torch.Tensor],
    held: List[_Held],
    steps: int,
    rotate: Callable[[List[_Held]], List[_Held]],
    causal: bool,
) -> List[torch.Tensor]:
    """The ring over the Q blocks ``q``: each attends to its own K/V block
    ``held[i]`` (keys, values, key mask, key positions, on ``q[i]``'s
    device), then ``steps`` times to what ``rotate`` brings it."""
    scale = 1.0 / math.sqrt(q[0].shape[-1])
    q32 = [qi.float() for qi in q]
    q_pos = [h[3] for h in held]
    state = [_block_attn(q32[i], *held[i][:3], q_pos[i], held[i][3], causal, scale) for i in range(len(q))]
    for _ in range(steps):
        held = rotate(held)
        for i, (kb, vb, mb, pb) in enumerate(held):
            state[i] = _merge(*state[i], *_block_attn(q32[i], kb, vb, mb, q_pos[i], pb, causal, scale))
    out = []
    for i, (_, o, l) in enumerate(state):
        denom = torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]  # [B, L_i, H, 1]
        out.append((o / denom).to(q[i].dtype))
    return out


def ring_attention_blocks(
    devices: Sequence[torch.device],
    q: Sequence[torch.Tensor],
    k: Sequence[torch.Tensor],
    v: Sequence[torch.Tensor],
    kv_mask: Sequence[torch.Tensor],
    positions: Sequence[torch.Tensor],
    causal: bool = False,
) -> List[torch.Tensor]:
    """Ring attention over blocks already placed: block ``i`` of every
    argument on ``devices[i]``.  Returns each device's output block
    ``[B, L_i, H, Dh]`` in ``q``'s dtype, on its device."""
    n = len(devices)

    def rotate(held):
        # device i receives what device i - 1 held
        return [tuple(t.to(devices[i]) for t in held[i - 1]) for i in range(n)]

    held = [(k[i], v[i], kv_mask[i].bool(), positions[i]) for i in range(n)]
    return _ring(q, held, n - 1, rotate, causal)


def _split(t: torch.Tensor, n: int, devices: Sequence[torch.device], which: Sequence[int] = ()) -> List[torch.Tensor]:
    """Blocks ``which`` (every block when empty) of ``t``'s sequence dim
    split ``n`` ways, each on its device."""
    if t.shape[1] % n:
        raise ValueError(f"sequence length {t.shape[1]} does not split over {n} blocks")
    chunks = t.chunk(n, dim=1)
    return [chunks[i].to(devices[i]) for i in (which or range(n))]


def _ring_across_processes(mesh, devices, q, k, v, kv_mask, positions, causal: bool) -> torch.Tensor:
    """This rank's blocks of the ring, then every rank's output blocks
    gathered in sequence order on ``q``'s device."""
    n = len(devices)
    world = distributed.process_count()
    if mesh.owners != [r for r in range(world) for _ in range(n // world)]:
        raise ValueError(f"ring attention needs each rank's blocks contiguous and in rank order, got owners "
                         f"{mesh.owners}")
    mine = local_shards(mesh)
    q_mine, k_mine, v_mine, m_mine, p_mine = (_split(t, n, devices, mine) for t in (q, k, v, kv_mask, positions))
    local = [devices[i] for i in mine]
    held = [(kb, vb, mb.bool(), pb) for kb, vb, mb, pb in zip(k_mine, v_mine, m_mine, p_mine)]

    def rotate(held):
        # the rank's last block goes to rank r + 1; its first block
        # position receives rank r - 1's last; the rest move up by one
        incoming = distributed.ring_shift(held[-1])
        moved = [tuple(t.to(local[0]) for t in incoming)]
        return moved + [tuple(t.to(local[a]) for t in held[a - 1]) for a in range(1, len(held))]

    blocks = _ring(q_mine, held, n - 1, rotate, causal)
    got = gather_shards(mesh, torch.stack([b.to(q.device) for b in blocks]))  # [n, B, L / n, H, Dh]
    return torch.cat(list(got), dim=1)


def ring_attention_sharded(
    mesh,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor,
    positions: torch.Tensor,
    axis: str = "sp",
    causal: bool = False,
) -> torch.Tensor:
    """Ring attention with the sequence dim split over ``axis`` of
    ``mesh``: the blocks are placed on the axis's devices, attended and
    concatenated on ``q``'s device.  Over a mesh across processes
    (``axis`` its first axis) every rank passes the same full inputs,
    attends only its own blocks, and returns the whole output."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    if is_multiprocess(mesh):
        if mesh.axis_names[0] != axis:
            raise ValueError(f"ring attention across processes needs {axis!r} as the mesh's first axis, "
                             f"got {mesh.axis_names}")
        return _ring_across_processes(mesh, devices, q, k, v, kv_mask, positions, causal)
    blocks = ring_attention_blocks(
        devices, *(_split(t, n, devices) for t in (q, k, v, kv_mask, positions)), causal=causal
    )
    return torch.cat([b.to(q.device) for b in blocks], dim=1)


def dense_attention(q, k, v, kv_mask, positions, causal: bool = False) -> torch.Tensor:
    """Plain full softmax attention in f32 (the comparison of the tests
    and the card run); queries with no allowed key give 0."""
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) / math.sqrt(q.shape[-1])
    allowed = kv_mask.bool()[:, None, None, :]
    if causal:
        allowed = allowed & (positions[:, None, None, :] <= positions[:, None, :, None])
    p = torch.softmax(s.masked_fill(~allowed, float("-inf")), dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    return torch.einsum("bhlm,bmhd->blhd", p, v.float())
