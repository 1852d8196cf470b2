"""Sequence-packing row layout (the port's own copy of
``pathway_tpu/models/packing.py``, numpy only) — shared by the
cross-encoder's packed pair scoring and any packed encoder path.

Best-fit-decreasing bin packing of tokenized sequences into fixed-length
rows for block-diagonal segment attention (``models/transformer.py``):
several short sequences share one row, so the matmuls see full-length
rows regardless of the input length distribution.
"""

from __future__ import annotations

import bisect
from typing import List, Tuple

import numpy as np

__all__ = ["pack_rows", "pad_packed_rows", "row_length_bucket", "seg_bucket"]

_ROW_LEN_BUCKETS = (32, 64, 128, 256, 512)


def seg_bucket(n_seg: int) -> int:
    """Segment width bucket (8 wide, then /4 steps), so every packed
    consumer sees the same handful of shapes (the reference's rule)."""
    return 8 if n_seg <= 8 else max(1, ((n_seg + 3) // 4) * 4)


def pad_packed_rows(
    ids: np.ndarray,
    segments: np.ndarray,
    positions: np.ndarray,
    rows: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Zero-pad the packed [R, L] layout arrays up to ``rows`` rows (pad
    rows carry segment 0 everywhere = fully masked)."""
    R, L = ids.shape
    if rows > R:
        pad = np.zeros((rows - R, L), np.int32)
        ids = np.concatenate([ids, pad])
        segments = np.concatenate([segments, pad])
        positions = np.concatenate([positions, pad])
    return ids, segments, positions


def row_length_bucket(longest: int, max_len: int) -> int:
    """Length-bucketed row width: the smallest power-of-two bucket that
    holds the longest sequence, capped at ``max_len`` — short micro-batches
    see a handful of (R, L) shapes instead of one per input length, and
    an all-short batch never pays a ``max_len``-wide forward."""
    for b in _ROW_LEN_BUCKETS:
        if b >= max_len:
            return max_len
        if longest <= b:
            return b
    return max_len


def pack_rows(
    ids_b: np.ndarray,
    lens: np.ndarray,
    L: int,
    max_docs_per_row: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[Tuple[int, int]], int]:
    """Pack ``n`` tokenized sequences (``ids_b`` [n, L_tok] padded, ``lens``
    [n] real token counts, already clipped to ``L``) into rows of ``L``
    tokens.  Returns (ids [R, L], mask, segments, positions, doc_slots,
    n_seg) where doc_slots[i] = (row, segment-1) of input sequence i;
    segments are 1-based per row, positions restart per sequence (so
    positional embeddings match the unpacked encoding)."""
    n = int(ids_b.shape[0])
    lens = np.asarray(lens, np.int64)
    order = np.argsort(-lens, kind="stable")
    # best-fit-decreasing via a capacity-sorted open-row list: O(log R)
    # placement per doc instead of a scan over all rows.  The per-row
    # doc cap keeps the segment width (a shape dimension) small and
    # stable across chunks.
    open_caps: list = []  # ascending (cap_left, row_id)
    row_of = np.empty(n, np.int64)
    seg_of = np.empty(n, np.int64)
    off_of = np.empty(n, np.int64)
    row_fill: list = []  # tokens used per row
    row_count: list = []  # docs per row
    for i in order.tolist():
        need = int(lens[i])
        j = bisect.bisect_left(open_caps, (need, -1))
        if j < len(open_caps):
            cap_left, rid = open_caps.pop(j)
            row_of[i] = rid
            seg_of[i] = row_count[rid]
            off_of[i] = row_fill[rid]
            row_count[rid] += 1
            row_fill[rid] += need
            new_cap = cap_left - need
            if row_count[rid] < max_docs_per_row and new_cap >= 2:
                bisect.insort(open_caps, (new_cap, rid))
        else:
            rid = len(row_fill)
            row_of[i] = rid
            seg_of[i] = 0
            off_of[i] = 0
            row_fill.append(need)
            row_count.append(1)
            if max_docs_per_row > 1 and L - need >= 2:
                bisect.insort(open_caps, (L - need, rid))
    R = len(row_fill)
    n_seg = max(row_count) if row_count else 1
    # vectorized assembly: one flat scatter for all token positions
    total = int(lens.sum())
    within = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(lens)[:-1]]), lens
    )
    src = np.repeat(np.arange(n) * ids_b.shape[1], lens) + within
    dest = np.repeat(row_of * L + off_of, lens) + within
    ids = np.zeros(R * L, np.int32)
    mask = np.zeros(R * L, np.int32)
    segments = np.zeros(R * L, np.int32)
    positions = np.zeros(R * L, np.int32)
    ids[dest] = ids_b.reshape(-1)[src]
    mask[dest] = 1
    segments[dest] = np.repeat(seg_of + 1, lens)
    positions[dest] = within
    doc_slots = list(zip(row_of.tolist(), seg_of.tolist()))
    return (
        ids.reshape(R, L),
        mask.reshape(R, L),
        segments.reshape(R, L),
        positions.reshape(R, L),
        doc_slots,
        n_seg,
    )
