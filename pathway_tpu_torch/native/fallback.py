"""The plain versions of the native host runtime (counterpart of
``pathway_tpu/native/fallback.py``): the same answers as
``csrc/host/native_io.cc`` on every input, computed in Python and numpy.
``native`` uses them when the ``native.disable`` knob is set; the tests
hold the library against them.

Two choices follow the library rather than Python's own parsers:
``parse_int64`` and ``parse_float64`` accept what ``strtoll``-style digit
loops and ``strtod`` accept (no ``_`` digit separators; hexadecimal
floats such as ``0x1.8p1``; ``nan(chars)``), where ``int()`` and
``float()`` would differ."""

from __future__ import annotations

import math
import re
import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "csv_scan",
    "csv_unescape",
    "parse_int64",
    "parse_float64",
    "serialize_rows",
    "crc32",
    "frame_scan",
    "shard_rows",
]


def csv_scan(data: bytes, delim: str = ",", quote: str = '"'):
    """``(row_cell_start[n_rows + 1], cell_off, cell_len, cell_quoted)`` of
    a CSV buffer, as ``ptt_csv_scan`` gives them: a blank line (``\\n``,
    ``\\r\\n`` or a bare ``\\r``) is a zero-cell row."""
    d, q = ord(delim), ord(quote)
    n = len(data)
    row_cell_start: List[int] = [0]
    off: List[int] = []
    ln: List[int] = []
    quoted: List[int] = []

    def ends_cell(c: int) -> bool:
        return c == d or c == 10 or c == 13

    i = 0
    while i < n:
        if data[i] == 10 or data[i] == 13:
            i += 2 if data[i] == 13 and data[i + 1 : i + 2] == b"\n" else 1
            row_cell_start.append(len(off))
            continue
        while True:
            if i < n and data[i] == q:
                i += 1
                start = i
                while i < n:
                    if data[i] == q:
                        if i + 1 < n and data[i + 1] == q:
                            i += 2
                            continue
                        break
                    i += 1
                body_end = i
                if i < n:
                    i += 1
                tail_start = i
                while i < n and not ends_cell(data[i]):
                    i += 1
                # a tail after the closing quote is kept verbatim: the
                # extent then spans body, closing quote and tail
                off.append(start)
                ln.append((body_end if i == tail_start else i) - start)
                quoted.append(1)
            else:
                start = i
                while i < n and not ends_cell(data[i]):
                    i += 1
                off.append(start)
                ln.append(i - start)
                quoted.append(0)
            if i >= n:
                break
            if data[i] == d:
                i += 1
                if i >= n:  # a delimiter at the end of the buffer: a last empty cell
                    off.append(n)
                    ln.append(0)
                    quoted.append(0)
                    break
                continue
            i += 2 if data[i] == 13 and data[i + 1 : i + 2] == b"\n" else 1
            break
        row_cell_start.append(len(off))
    return (
        np.asarray(row_cell_start, dtype=np.int64),
        np.asarray(off, dtype=np.int64),
        np.asarray(ln, dtype=np.int64),
        np.asarray(quoted, dtype=np.uint8),
    )


def csv_unescape(cell: bytes, quote: str = '"') -> bytes:
    """A quoted cell's extent unescaped: ``""`` -> ``"``; the lone closing
    quote is dropped and the tail after it copied verbatim."""
    q = ord(quote)
    out = bytearray()
    in_quotes = True
    i, n = 0, len(cell)
    while i < n:
        if in_quotes and cell[i] == q:
            if i + 1 < n and cell[i + 1] == q:
                out.append(q)
                i += 2
                continue
            in_quotes = False
        else:
            out.append(cell[i])
        i += 1
    return bytes(out)


_INT_RE = re.compile(rb"[+-]?[0-9]+")
# what strtod converts in full, after the whitespace it skips (C locale)
_FLOAT_RE = re.compile(
    rb"""(?P<sign>[+-]?)(?:
        (?P<dec>(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?)
      | (?P<hex>0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)(?:[pP][+-]?[0-9]+)?)
      | (?P<inf>[iI][nN][fF](?:[iI][nN][iI][tT][yY])?)
      | (?P<nan>[nN][aA][nN](?:\([0-9a-zA-Z_]*\))?)
    )""",
    re.X,
)
_C_SPACE = b" \t\n\v\f\r"


def _cells(data: bytes, off, ln):
    for o, n in zip(np.asarray(off).tolist(), np.asarray(ln).tolist()):
        yield data[o : o + n].strip(b" \t")


def parse_int64(data: bytes, off, ln) -> Tuple[np.ndarray, np.ndarray]:
    """Each cell (spaces and tabs around it dropped) as a base-10 int64:
    ``(values, ok)``, ``ok`` 0 (value 0) where it is not one."""
    n = len(off)
    out = np.zeros(n, dtype=np.int64)
    ok = np.zeros(n, dtype=np.uint8)
    for i, s in enumerate(_cells(data, off, ln)):
        if _INT_RE.fullmatch(s):
            v = int(s)
            if -(1 << 63) <= v < (1 << 63):
                out[i] = v
                ok[i] = 1
    return out, ok


def _strtod(s: bytes) -> Optional[float]:
    m = _FLOAT_RE.fullmatch(s.lstrip(_C_SPACE))
    if m is None:
        return None
    sign = -1.0 if m["sign"] == b"-" else 1.0
    if m["dec"] is not None:
        return sign * float(m["dec"])  # correctly rounded, as strtod
    if m["hex"] is not None:
        try:
            return sign * float.fromhex(m["hex"].decode())
        except OverflowError:
            return sign * math.inf  # strtod's HUGE_VAL
    return sign * math.inf if m["inf"] is not None else math.copysign(math.nan, sign)


def parse_float64(data: bytes, off, ln) -> Tuple[np.ndarray, np.ndarray]:
    """Each cell (spaces and tabs around it dropped, at most 510 bytes) as
    ``strtod`` reads all of it: ``(values, ok)``, ``ok`` 0 (value NaN)
    where it is not a number."""
    n = len(off)
    out = np.full(n, np.nan, dtype=np.float64)
    ok = np.zeros(n, dtype=np.uint8)
    for i, s in enumerate(_cells(data, off, ln)):
        if 0 < len(s) <= 510:
            v = _strtod(s)
            if v is not None:
                out[i] = v
                ok[i] = 1
    return out, ok


def serialize_rows(
    n_rows: int,
    col_types: Sequence[int],
    col_arrays: Sequence[object],
    col_nulls: Sequence[Optional[np.ndarray]],
) -> Tuple[bytes, np.ndarray]:
    """``ptt_serialize_rows`` in Python: per-row key-derivation buffers of
    typed columns, byte for byte what ``internals.keys._serialize_value``
    writes."""
    from . import COL_BOOL, COL_BYTES, COL_FLOAT64, COL_INT64, COL_NONE, COL_POINTER, COL_STR

    out = bytearray()
    row_offsets = np.empty(n_rows + 1, dtype=np.int64)
    row_offsets[0] = 0
    for r in range(n_rows):
        for c, t in enumerate(col_types):
            mask = col_nulls[c] if col_nulls else None
            if (mask is not None and mask[r]) or t == COL_NONE:
                out += b"\x00"
            elif t == COL_BOOL:
                out += b"\x01" + (b"\x01" if col_arrays[c][r] else b"\x00")
            elif t == COL_INT64:
                out += b"\x02" + struct.pack("<q", int(col_arrays[c][r]))
            elif t == COL_FLOAT64:
                out += b"\x03" + struct.pack("<d", float(col_arrays[c][r]))
            elif t == COL_POINTER:
                out += b"\x06" + struct.pack("<Q", int(col_arrays[c][r]))
            elif t in (COL_STR, COL_BYTES):
                blob, offs = col_arrays[c]
                cell = blob[offs[r] : offs[r + 1]]
                out += (b"\x04" if t == COL_STR else b"\x05") + struct.pack("<I", len(cell)) + cell
        row_offsets[r + 1] = len(out)
    return bytes(out), row_offsets


def crc32(data, value: int = 0) -> int:
    return zlib.crc32(data, value & 0xFFFFFFFF) & 0xFFFFFFFF


def frame_scan(data) -> Tuple[np.ndarray, np.ndarray, int]:
    """``(payload_offsets, payload_lengths, consumed)`` of the valid prefix
    of ``[u32 len][u32 crc32][payload]`` frames."""
    offs: List[int] = []
    lens: List[int] = []
    view = memoryview(data)
    pos, n = 0, len(view)
    while pos + 8 <= n:
        payload_len, crc = struct.unpack_from("<II", view, pos)
        if pos + 8 + payload_len > n or zlib.crc32(view[pos + 8 : pos + 8 + payload_len]) != crc:
            break
        offs.append(pos + 8)
        lens.append(payload_len)
        pos += 8 + payload_len
    return np.asarray(offs, dtype=np.int64), np.asarray(lens, dtype=np.int64), pos


def shard_rows(keys, n_shards: int, shard_mask: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(counts[n_shards], order)``: the stable grouping of row indices by
    ``(key & shard_mask) % n_shards``."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    shards = (keys & np.uint64(shard_mask)) % np.uint64(n_shards)
    counts = np.bincount(shards.astype(np.int64), minlength=n_shards).astype(np.int64)
    order = np.argsort(shards, kind="stable").astype(np.int64)
    return counts, order
