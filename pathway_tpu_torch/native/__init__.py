"""The port's native host runtime (counterpart of ``pathway_tpu/native``,
the same names and signatures): the CSV scanner, the typed cell
parsers, CRC-32 and the snapshot frame scan under persistence
(``framing.scan``), shard routing, and the row serializer, row hash and batch
tokenizer the keys and the tokenizer use.

The CSV, parse, CRC, frame and shard functions run
``csrc/host/native_io.cc``; ``serialize_rows``, ``hash_rows`` and
``tokenize_hash`` wrap the functions of ``csrc/host/tokenize_hash.cc``
that ``kernels/host.py`` binds.  Both libraries are built with ``g++`` at
first use (``kernels/build.py``).  There is no silent fallback: unless
the ``native.disable`` knob (``PATHWAY_TPU_DISABLE_NATIVE``) is set, a
library that does not build raises ``BuildError``.  With the knob set,
the plain versions of ``native.fallback`` answer instead (``hash_rows``
and ``tokenize_hash`` then return None, as the reference's do without
its library).

Two answers differ from the reference's library on purpose: its scanner
reads a blank line ending in a bare ``\\r`` as a row of one empty cell,
this one skips it as Python's ``csv`` module does; and its plain
``parse_*`` (``int()`` / ``float()``) accept ``_`` separators and refuse
hexadecimal floats, where its library (and both versions here) do the
opposite.
"""

from __future__ import annotations

import ctypes
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import config
from ..kernels.build import BuildError, build_host
from ..kernels.host import host_lib, native_io_lib
from . import fallback

__all__ = [
    "BuildError",
    "available",
    "lib",
    "build",
    "csv_scan",
    "csv_unescape",
    "csv_rows",
    "parse_int64",
    "parse_float64",
    "serialize_rows",
    "hash_rows",
    "crc32",
    "frame_scan",
    "shard_rows",
    "tokenize_hash",
    "COL_NONE",
    "COL_BOOL",
    "COL_INT64",
    "COL_FLOAT64",
    "COL_STR",
    "COL_BYTES",
    "COL_POINTER",
]

# column type tags of ptt_serialize_rows (csrc/host/tokenize_hash.cc)
COL_NONE, COL_BOOL, COL_INT64, COL_FLOAT64, COL_STR, COL_BYTES, COL_POINTER = range(7)

_FRAMES_PER_CALL = 1 << 16  # frame_scan's extents per library call


def build(force: bool = False) -> bool:
    """Build both host libraries unless current (``force``: build again).
    Returns True; a failed build raises ``BuildError``."""
    for name in ("native_io", "tokenize_hash"):
        build_host(name, force=force)
    return True


def lib() -> Optional[ctypes.CDLL]:
    """The native I/O library, built at first use; None when the
    ``native.disable`` knob is set."""
    if config.get("native.disable"):
        return None
    return native_io_lib()


def available() -> bool:
    """Whether the native versions answer (the knob is unset and the
    library built; a failed build raises)."""
    return lib() is not None


def _addr(arr: np.ndarray) -> int:
    return arr.ctypes.data


def _u8(data) -> np.ndarray:
    """A zero-copy uint8 view of a bytes-like object (bytes, bytearray,
    memoryview)."""
    return np.frombuffer(data, dtype=np.uint8)


def _ascii(ch: str, what: str) -> int:
    """The byte of a one-character ASCII delimiter or quote."""
    if len(ch) != 1 or ord(ch) > 127:
        raise ValueError(f"the CSV {what} must be one ASCII character, not {ch!r}")
    return ord(ch)


# ---------------------------------------------------------------- CSV


def csv_scan(data: bytes, delim: str = ",", quote: str = '"') -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Columnar extents of a CSV buffer: ``(row_cell_start[n_rows + 1],
    cell_off, cell_len, cell_quoted)``; a blank line is a zero-cell row."""
    d, q = _ascii(delim, "delimiter"), _ascii(quote, "quote")
    dll = lib()
    if dll is None:
        return fallback.csv_scan(data, delim, quote)
    buf = _u8(data)
    n_rows, n_cells = ctypes.c_int64(0), ctypes.c_int64(0)
    dll.ptt_csv_count(_addr(buf), len(buf), d, q, ctypes.addressof(n_rows), ctypes.addressof(n_cells))
    rcs = np.empty(n_rows.value + 1, dtype=np.int64)
    off = np.empty(n_cells.value, dtype=np.int64)
    ln = np.empty(n_cells.value, dtype=np.int64)
    quoted = np.empty(n_cells.value, dtype=np.uint8)
    dll.ptt_csv_scan(_addr(buf), len(buf), d, q, _addr(rcs), _addr(off), _addr(ln), _addr(quoted))
    return rcs, off, ln, quoted


def csv_unescape(cell: bytes, quote: str = '"') -> bytes:
    """A quoted cell's extent unescaped: ``""`` -> ``"``; the lone closing
    quote is dropped and the tail after it copied verbatim."""
    q = _ascii(quote, "quote")
    dll = lib()
    if dll is None:
        return fallback.csv_unescape(cell, quote)
    src = _u8(cell)
    out = np.empty(max(len(src), 1), dtype=np.uint8)
    n = dll.ptt_csv_unescape(_addr(src), len(src), q, _addr(out))
    return out[:n].tobytes()


def _unescape_str(cell: str, quote: str) -> str:
    """``csv_unescape`` of a decoded ASCII cell: the longest prefix of
    other characters and doubled quotes is the body, then the lone quote,
    then the verbatim tail."""
    q = re.escape(quote)
    body, tail = re.fullmatch(f"([^{q}]*(?:{q}{q}[^{q}]*)*){q}?(.*)", cell, re.S).groups()
    return body.replace(quote + quote, quote) + tail


def csv_rows(data: bytes, delim: str = ",", quote: str = '"') -> List[List[str]]:
    """A CSV buffer as rows of str, blank lines skipped; each cell
    unescaped, then decoded as UTF-8 with undecodable bytes replaced."""
    rcs, off, ln, quoted = csv_scan(data, delim, quote)
    extents = list(map(slice, off.tolist(), (off + ln).tolist()))
    data = bytes(data)
    if data.isascii():  # byte extents are character extents: one decode, then slices
        cells = list(map(data.decode("ascii").__getitem__, extents))
        for c in np.flatnonzero(quoted).tolist():
            if quote in cells[c]:
                cells[c] = _unescape_str(cells[c], quote)
    else:
        qb = quote.encode()
        cells = list(map(data.__getitem__, extents))
        for c in np.flatnonzero(quoted).tolist():
            if qb in cells[c]:
                cells[c] = csv_unescape(cells[c], quote)
        cells = [cell.decode("utf-8", errors="replace") for cell in cells]
    rows = np.flatnonzero(rcs[1:] != rcs[:-1])  # zero-cell rows (blank lines) skipped
    return list(map(cells.__getitem__, map(slice, rcs[rows].tolist(), rcs[rows + 1].tolist())))


# ---------------------------------------------------------------- typed parse


def _parse(name: str, dtype, data: bytes, off: np.ndarray, ln: np.ndarray):
    dll = lib()
    if dll is None:
        return getattr(fallback, name)(data, off, ln)
    buf = _u8(data)
    off = np.ascontiguousarray(off, dtype=np.int64)
    ln = np.ascontiguousarray(ln, dtype=np.int64)
    if len(off) != len(ln) or (len(off) and (int(off.min()) < 0 or int((off + ln).max()) > len(buf)
                                              or int(ln.min()) < 0)):
        raise ValueError("cell extents must lie inside data")
    out = np.empty(len(off), dtype=dtype)
    ok = np.empty(len(off), dtype=np.uint8)
    getattr(dll, "ptt_" + name)(_addr(buf), _addr(off), _addr(ln), len(off), _addr(out), _addr(ok))
    return out, ok


def parse_int64(data: bytes, off: np.ndarray, ln: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Cells ``data[off[i] : off[i] + ln[i]]`` as base-10 int64:
    ``(values, ok)``, ``ok`` 0 (value 0) where a cell is not one."""
    return _parse("parse_int64", np.int64, data, off, ln)


def parse_float64(data: bytes, off: np.ndarray, ln: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Cells as ``strtod`` reads all of each: ``(values, ok)``, ``ok`` 0
    (value NaN) where a cell is not a number."""
    return _parse("parse_float64", np.float64, data, off, ln)


# ---------------------------------------------------------------- serialize / hash


def serialize_rows(
    n_rows: int,
    col_types: Sequence[int],
    col_arrays: Sequence[object],
    col_nulls: Optional[Sequence[Optional[np.ndarray]]],
) -> Tuple[bytes, np.ndarray]:
    """Typed columns as per-row key-derivation buffers: ``(buffer,
    row_offsets[n_rows + 1])``, byte for byte what
    ``internals.keys._serialize_value`` writes.  ``col_arrays[c]`` is an
    int64 / float64 / uint8 / uint64 array, or ``(blob, offsets[n_rows +
    1])`` for a str / bytes column."""
    col_nulls = list(col_nulls) if col_nulls else [None] * len(col_types)
    if config.get("native.disable"):
        return fallback.serialize_rows(n_rows, col_types, col_arrays, col_nulls)
    from ..internals import keys

    return keys.serialize_rows(n_rows, col_types, col_arrays, col_nulls)


def hash_rows(buf: bytes, row_offsets: np.ndarray) -> Optional[np.ndarray]:
    """XXH3-64 of each row slice of a ``serialize_rows`` buffer; None
    when the ``native.disable`` knob is set (callers hash row by row)."""
    if config.get("native.disable"):
        return None
    from ..internals import keys

    return keys.hash_rows(buf, row_offsets)


# ---------------------------------------------------------------- CRC / frames


def crc32(data, value: int = 0) -> int:
    """``zlib.crc32(data, value)`` of a bytes-like object."""
    dll = lib()
    if dll is None:
        return fallback.crc32(data, value)
    buf = _u8(data)
    return int(dll.ptt_crc32(_addr(buf), len(buf), value & 0xFFFFFFFF))


def frame_scan(data) -> Tuple[np.ndarray, np.ndarray, int]:
    """``(payload_offsets, payload_lengths, consumed)`` of the valid prefix
    of concatenated ``[u32 LE len][u32 LE crc32][payload]`` frames: a torn
    or corrupt frame ends it."""
    dll = lib()
    if dll is None:
        return fallback.frame_scan(data)
    buf = _u8(data)
    offs, lens = [], []
    pos = 0
    while True:
        o = np.empty(_FRAMES_PER_CALL, dtype=np.int64)
        n_ = np.empty(_FRAMES_PER_CALL, dtype=np.int64)
        consumed = ctypes.c_int64(0)
        count = dll.ptt_frame_scan(_addr(buf) + pos, len(buf) - pos, _addr(o), _addr(n_), _FRAMES_PER_CALL,
                                   ctypes.addressof(consumed))
        offs.append(o[:count] + pos)
        lens.append(n_[:count])
        pos += consumed.value
        if count < _FRAMES_PER_CALL:
            return np.concatenate(offs), np.concatenate(lens), pos


# ---------------------------------------------------------------- sharding


def shard_rows(keys: np.ndarray, n_shards: int, shard_mask: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(counts[n_shards], order[n])``: the stable grouping of row indices
    by ``shard(key) = (key & shard_mask) % n_shards``."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be at least 1, not {n_shards}")
    dll = lib()
    if dll is None:
        return fallback.shard_rows(keys, n_shards, shard_mask)
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    counts = np.empty(n_shards, dtype=np.int64)
    order = np.empty(len(keys), dtype=np.int64)
    dll.ptt_shard_rows(_addr(keys), len(keys), n_shards, shard_mask & 0xFFFFFFFFFFFFFFFF, _addr(counts),
                       _addr(order))
    return counts, order


# ---------------------------------------------------------------- tokenizer


def tokenize_hash(
    blob: bytes, offsets: np.ndarray, vocab_size: int, reserved: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The hashing tokenizer over concatenated ASCII texts (text t in
    ``blob[offsets[t] : offsets[t + 1]]``): ``(ids int32, tok_offsets
    int64[n + 1])``; None when the ``native.disable`` knob is set."""
    if config.get("native.disable"):
        return None
    n_texts = len(offsets) - 1
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    ids = np.empty(max(len(blob), 1), dtype=np.int32)
    tok_off = np.empty(n_texts + 1, dtype=np.int64)
    rc = host_lib().ptt_tokenize_hash(blob, _addr(offsets), n_texts, vocab_size, reserved, _addr(ids),
                                      _addr(tok_off))
    if rc != 0:
        raise RuntimeError(f"ptt_tokenize_hash returned {rc}")
    return ids[: tok_off[n_texts]], tok_off
