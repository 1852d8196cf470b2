"""CRC-framed records for snapshot chunks (counterpart of
``pathway_tpu/persistence/framing.py``).

Frame = ``[u32 LE payload_len][u32 LE crc32(payload)][payload]`` with the
zlib CRC-32, the checksum the reference's native library computes, so
one payload frames to the same bytes in both packages.  ``scan`` returns
the payloads of the valid prefix: a torn write or bit rot ends the scan
at the last intact frame instead of failing the reader.

``frame_all`` and ``scan_views`` are the bulk forms a snapshot of many
chunks uses: the CRCs of a large blob are computed on several threads
(``zlib.crc32`` releases the GIL), and the views avoid a copy of every
payload.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

__all__ = ["frame", "frame_all", "scan", "scan_views"]

_HEADER = struct.Struct("<II")
_PARALLEL_BYTES = 8 << 20  # below this one thread computes the CRCs


def _crc(data) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _crcs(chunks: Sequence) -> List[int]:
    if len(chunks) < 2 or sum(len(c) for c in chunks) < _PARALLEL_BYTES:
        return [_crc(c) for c in chunks]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(_crc, chunks))


def frame(payload: bytes) -> bytes:
    return _HEADER.pack(len(payload), _crc(payload)) + payload


def frame_all(chunks: Sequence) -> bytes:
    """``b"".join(frame(c) for c in chunks)``, in one copy of the chunks."""
    parts = []
    for chunk, crc in zip(chunks, _crcs(chunks)):
        parts += (_HEADER.pack(len(chunk), crc), chunk)
    return b"".join(parts)


def scan_views(blob: bytes) -> Tuple[List[memoryview], bool]:
    """``scan`` with the payloads as views into ``blob``."""
    view = memoryview(blob)
    payloads: List[memoryview] = []
    crcs: List[int] = []
    pos, n = 0, len(view)
    while pos + _HEADER.size <= n:
        length, crc = _HEADER.unpack_from(view, pos)
        start = pos + _HEADER.size
        if start + length > n:
            break
        payloads.append(view[start : start + length])
        crcs.append(crc)
        pos = start + length
    # the valid prefix ends at the first frame whose CRC does not match
    for i, (got, want) in enumerate(zip(_crcs(payloads), crcs)):
        if got != want:
            return payloads[:i], False
    return payloads, pos == n


def scan(blob: bytes) -> Tuple[List[bytes], bool]:
    """Decode concatenated frames: ``(payloads, intact)``, ``intact``
    False when a truncated or corrupt tail was dropped."""
    views, intact = scan_views(blob)
    return [v.tobytes() for v in views], intact
