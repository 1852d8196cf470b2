"""CRC-framed records for snapshot chunks (counterpart of
``pathway_tpu/persistence/framing.py``).

Frame = ``[u32 LE payload_len][u32 LE crc32(payload)][payload]`` with the
zlib CRC-32, the checksum the reference's native library computes, so
one payload frames to the same bytes in both packages.  ``scan`` returns
the payloads of the valid prefix: a torn write or bit rot ends the scan
at the last intact frame instead of failing the reader.  It walks the
frames and checks their CRCs in one call of the native runtime
(``native.frame_scan``); ``frame`` computes one payload's CRC with
``zlib.crc32``, which costs less than a library call at the size of an
event's payload.

``frame_all`` and ``scan_views`` are the bulk forms a snapshot of many
chunks uses: the CRCs of a large blob are computed on several threads
(``zlib.crc32`` releases the GIL), and the views avoid a copy of every
payload; ``ViewStream`` reads the payloads as one stream, so a reader
(the unpickler) copies each byte once instead of after a join, and a
large read is copied on several threads (numpy releases the GIL): the
cost of such a read is the first touch of the fresh buffer it fills.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

from .. import native

__all__ = ["ViewStream", "frame", "frame_all", "scan", "scan_views"]

_HEADER = struct.Struct("<II")
_PARALLEL_BYTES = 8 << 20  # below this a CRC or copy job runs on one thread


def _crc(data) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _parallel_map(fn, items, n_bytes: int) -> list:
    """``list(map(fn, items))``, on several threads for a large job."""
    if len(items) < 2 or n_bytes < _PARALLEL_BYTES:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(fn, items))


def _crcs(chunks: Sequence) -> List[int]:
    return _parallel_map(_crc, chunks, sum(len(c) for c in chunks))


def _copy(job) -> None:
    dst, src = job
    dst[:] = src


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
    offsets, lengths, consumed = native.frame_scan(blob)
    view = memoryview(blob)
    return [view[o : o + n].tobytes() for o, n in zip(offsets.tolist(), lengths.tolist())], consumed == len(view)


class ViewStream(io.RawIOBase):
    """The concatenation of ``views`` as a readable binary stream."""

    def __init__(self, views: Sequence[memoryview]):
        self._views = views
        self._i = 0
        self._off = 0

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        out = np.frombuffer(b, np.uint8)
        jobs = []
        n = 0
        while n < len(out) and self._i < len(self._views):
            view = self._views[self._i]
            take = min(len(out) - n, len(view) - self._off)
            jobs.append((out[n : n + take], np.frombuffer(view, np.uint8, take, self._off)))
            n += take
            self._off += take
            if self._off == len(view):
                self._i += 1
                self._off = 0
        _parallel_map(_copy, jobs, n)
        return n
