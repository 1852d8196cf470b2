"""Row keys ("pointers") of the port (counterpart of
``pathway_tpu/internals/keys.py``).

A key is the XXH3-64 of the row's id values in a canonical tagged byte
format, stored as ``np.uint64``; the low ``SHARD_BITS`` bits select the
shard.  Keys equal the reference's bit for bit, since every table's row
ids derive from them.

Hashing is always the port's host library (``csrc/host/tokenize_hash.cc``,
built with ``g++`` at first use; a failed build raises): uniformly typed
id columns are serialized there too (``ptt_serialize_rows``, byte-identical
to ``_serialize_value``) and hashed per row (``ptt_hash_rows``).  Mixed or
exotic columns (tuples, arrays, wide ints, ``repr`` values) are serialized
by ``_serialize_value`` in Python and hashed by the same library.  The
pure-Python XXH3 (``models/_xxh3.py``) is no path of this module: the
tests hold the library against it.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Any, Optional, Sequence

import numpy as np

from ..kernels.host import host_lib, native_xxh3_64
from ..native import COL_BOOL, COL_BYTES, COL_FLOAT64, COL_INT64, COL_NONE, COL_POINTER, COL_STR

__all__ = [
    "Pointer",
    "SHARD_BITS",
    "SHARD_MASK",
    "ref_scalar",
    "ref_scalars_batch",
    "sequential_keys",
    "shard_of",
    "shards_of",
    "KEY_DTYPE",
    "hash_rows",
    "serialize_rows",
]

KEY_DTYPE = np.uint64
SHARD_BITS = 16
SHARD_MASK = (1 << SHARD_BITS) - 1


# Salt distinguishing "no id columns → sequential row number" keys from hashed keys.
_SEQ_SALT = 0x9E3779B97F4A7C15


class Pointer(int):
    """A row key.  Subclass of int so it round-trips through numpy uint64."""

    def __repr__(self) -> str:
        return f"^{int(self):016X}"


def _serialize_value(value: Any, out: bytearray) -> None:
    """Canonical byte serialization of a value for hashing (order/type tagged)."""
    if value is None:
        out += b"\x00"
    elif isinstance(value, (bool, np.bool_)):
        out += b"\x01" + (b"\x01" if value else b"\x00")
    elif isinstance(value, (Pointer, np.uint64)):
        # engine convention: np.uint64 IS the pointer type (KEY_DTYPE); plain
        # ints are int64/python int.  Tagging both identically keeps keys
        # consistent whether a pointer column flows as a dense uint64 array,
        # an object array of np.uint64, or Pointer scalars.
        out += b"\x06" + struct.pack("<Q", int(value))
    elif isinstance(value, (int, np.integer)):
        v = int(value)
        if -(1 << 63) <= v < (1 << 63):
            out += b"\x02" + struct.pack("<q", v)
        else:
            out += b"\x0A" + struct.pack("<Q", v & 0xFFFFFFFFFFFFFFFF)
    elif isinstance(value, (float, np.floating)):
        out += b"\x03" + struct.pack("<d", float(value))
    elif isinstance(value, str):
        b = value.encode()
        out += b"\x04" + struct.pack("<I", len(b)) + b
    elif isinstance(value, bytes):
        out += b"\x05" + struct.pack("<I", len(value)) + value
    elif isinstance(value, (tuple, list)):
        out += b"\x07" + struct.pack("<I", len(value))
        for v in value:
            _serialize_value(v, out)
    elif isinstance(value, np.ndarray):
        out += b"\x08" + str(value.dtype).encode() + struct.pack(
            "<I", value.ndim
        ) + struct.pack(f"<{value.ndim}I", *value.shape) + value.tobytes()
    else:
        b = repr(value).encode()
        out += b"\x09" + struct.pack("<I", len(b)) + b


def ref_scalar(*values: Any, optional: bool = False) -> Pointer:
    """Derive a deterministic key from id-column values
    (reference ``ref_scalar``, python/pathway/engine.pyi:30)."""
    if optional and any(v is None for v in values):
        raise ValueError("ref_scalar received None for a non-optional id")
    buf = bytearray()
    for v in values:
        _serialize_value(v, buf)
    return Pointer(native_xxh3_64(bytes(buf)))


# exact-type → kind for the object-column scan: a dict hit is one hash lookup
# per value instead of a 6-deep isinstance chain (this scan runs over every
# id value of every delta — it must stay close to C speed)
_KIND_BY_TYPE = {
    bool: "bool",
    np.bool_: "bool",
    Pointer: "ptr",
    np.uint64: "ptr",
    int: "int",
    np.int64: "int",
    np.int32: "int",
    np.int16: "int",
    np.int8: "int",
    np.uint32: "int",
    np.uint16: "int",
    np.uint8: "int",
    float: "float",
    np.float64: "float",
    np.float32: "float",
    str: "str",
    bytes: "bytes",
}


def _as_object_array(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _kind_of_type_slow(t: type) -> "str | None":
    """issubclass fallback for subclasses / exotic numeric types (ordering
    matters: bool<int, Pointer<int, np.uint64<np.integer)."""
    if issubclass(t, (bool, np.bool_)):
        return "bool"
    if issubclass(t, (Pointer, np.uint64)):
        return "ptr"
    if issubclass(t, (int, np.integer)):
        return "int"
    if issubclass(t, (float, np.floating)):
        return "float"
    if issubclass(t, str):
        return "str"
    if issubclass(t, bytes):
        return "bytes"
    return None


def _str_col_layout(col, n: int, kind: str):
    """(blob, offsets) for a null-free str/bytes column, vectorised: one big
    join + one encode (ascii fast path) instead of per-value appends."""
    if kind == "bytes":
        parts = list(col)
        lens = np.fromiter(map(len, parts), dtype=np.int64, count=n)
        blob = b"".join(parts)
    else:
        joined = "".join(col)
        if joined.isascii():
            lens = np.fromiter(map(len, col), dtype=np.int64, count=n)
            blob = joined.encode()
        else:
            parts = [v.encode() for v in col]
            lens = np.fromiter(map(len, parts), dtype=np.int64, count=n)
            blob = b"".join(parts)
    offsets = np.empty(n + 1, dtype=np.int64)
    offsets[0] = 0
    np.cumsum(lens, out=offsets[1:])
    return blob, offsets


def _native_col_spec(col, n: int):
    """Map one id column onto the native serializer's typed layout
    (``serialize_rows``); None if the column needs the generic per-value
    Python path."""
    if isinstance(col, np.ndarray) and col.ndim == 1:
        if col.dtype == np.bool_:
            return COL_BOOL, col.astype(np.uint8), None
        if col.dtype == np.uint64:
            # uint64 = pointer column (engine convention, see _serialize_value)
            return COL_POINTER, col, None
        if np.issubdtype(col.dtype, np.integer):
            return COL_INT64, col.astype(np.int64), None
        if np.issubdtype(col.dtype, np.floating):
            return COL_FLOAT64, col.astype(np.float64), None
        if col.dtype != object:
            return None
    # one C-level pass collects the distinct cell types; kind resolution then
    # runs over the handful of types, not the n values
    type_set = set(map(type, col))
    nulls = type(None) in type_set
    if nulls:
        type_set.discard(type(None))
    kinds = set()
    for t in type_set:
        k = _KIND_BY_TYPE.get(t)
        if k is None:
            k = _kind_of_type_slow(t)
            if k is None:
                return None
        kinds.add(k)
        if len(kinds) > 1:
            return None
    mask = None
    if nulls:
        mask = np.fromiter((v is None for v in col), dtype=np.uint8, count=n)
    if not kinds:  # all null
        return COL_NONE, None, mask
    kind = kinds.pop()
    if kind in ("str", "bytes"):
        tag = COL_STR if kind == "str" else COL_BYTES
        if not nulls:
            return tag, _str_col_layout(col, n, kind), mask
        offsets = np.empty(n + 1, dtype=np.int64)
        offsets[0] = 0
        parts = []
        for i, v in enumerate(col):
            b = b"" if v is None else (v.encode() if kind == "str" else v)
            parts.append(b)
            offsets[i + 1] = offsets[i] + len(b)
        return tag, (b"".join(parts), offsets), mask
    fill = {"bool": False, "ptr": 0, "int": 0, "float": 0.0}[kind]
    if not isinstance(col, np.ndarray):
        col = _as_object_array(col)
    if nulls:
        col = np.where(mask.astype(bool), fill, col)
    try:
        if kind == "bool":
            return COL_BOOL, col.astype(np.uint8), mask
        if kind == "ptr":
            return COL_POINTER, col.astype(np.uint64), mask
        if kind == "int":
            # astype(object->int64) raises on > 64-bit ints, which need the
            # generic Python tagging path (\x0A wide-int tag)
            return COL_INT64, col.astype(np.int64), mask
        return COL_FLOAT64, col.astype(np.float64), mask
    except (OverflowError, TypeError, ValueError):
        return None


def ref_scalars_batch(columns: Sequence[Sequence[Any]]) -> np.ndarray:
    """Vector of keys for rows given as parallel columns of id values.

    Uniformly-typed columns are serialized by the host library
    (byte-identical to ``_serialize_value``) and hashed there, one XXH3-64
    per row.  Mixed/exotic columns take the per-value Python serializer,
    and the same library hashes its rows."""
    n = len(columns[0])
    specs = []
    for col in columns:
        spec = _native_col_spec(col, n)
        if spec is None:
            specs = None
            break
        specs.append(spec)
    if specs is not None:
        buf, row_offsets = serialize_rows(
            n,
            [s[0] for s in specs],
            [s[1] for s in specs],
            [s[2] for s in specs],
        )
    else:
        parts = []
        row_offsets = np.empty(n + 1, dtype=np.int64)
        row_offsets[0] = 0
        for i in range(n):
            row = bytearray()
            for col in columns:
                _serialize_value(col[i], row)
            parts.append(bytes(row))
            row_offsets[i + 1] = row_offsets[i] + len(row)
        buf = b"".join(parts)
    return hash_rows(buf, row_offsets)


def serialize_rows(n_rows: int, col_types: Sequence[int], col_arrays: Sequence[object],
                   col_nulls: Sequence[Optional[np.ndarray]]):
    """Serialize typed columns into per-row key-derivation buffers.

    ``col_arrays[c]``: an int64/float64/uint8/uint64 array, or ``(blob,
    offsets[n_rows + 1])`` for str/bytes columns.  Returns ``(buffer,
    row_offsets[n_rows + 1])``, byte for byte what ``_serialize_value``
    writes."""
    n_cols = len(col_types)
    types = np.asarray(col_types, dtype=np.uint8)
    data_ptrs = (ctypes.c_void_p * n_cols)()
    off_ptrs = (ctypes.c_void_p * n_cols)()
    null_ptrs = (ctypes.c_void_p * n_cols)()
    keepalive = []
    for c, t in enumerate(col_types):
        if t in (COL_STR, COL_BYTES):
            blob, offs = col_arrays[c]
            blob = np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(1, np.uint8)
            offs = np.ascontiguousarray(offs, dtype=np.int64)
            keepalive.append((blob, offs))
            data_ptrs[c] = blob.ctypes.data
            off_ptrs[c] = offs.ctypes.data
        elif t != COL_NONE:
            arr = np.ascontiguousarray(col_arrays[c])
            keepalive.append(arr)
            data_ptrs[c] = arr.ctypes.data
        mask = col_nulls[c]
        if mask is not None:
            mask = np.ascontiguousarray(mask, dtype=np.uint8)
            keepalive.append(mask)
            null_ptrs[c] = mask.ctypes.data
    lib = host_lib()
    row_offsets = np.empty(n_rows + 1, dtype=np.int64)
    needed = lib.ptt_serialize_rows(n_rows, n_cols, types.ctypes.data, data_ptrs, off_ptrs, null_ptrs,
                                    None, 0, row_offsets.ctypes.data)
    out = np.empty(max(int(needed), 1), dtype=np.uint8)
    lib.ptt_serialize_rows(n_rows, n_cols, types.ctypes.data, data_ptrs, off_ptrs, null_ptrs,
                           out.ctypes.data, needed, row_offsets.ctypes.data)
    return out[:needed].tobytes(), row_offsets


def hash_rows(buf: bytes, row_offsets: np.ndarray) -> np.ndarray:
    """XXH3-64 of each row slice of ``buf`` (the ``serialize_rows``
    layout), as keys."""
    n = len(row_offsets) - 1
    offs = np.ascontiguousarray(row_offsets, dtype=np.int64)
    if n < 0 or offs[0] < 0 or offs[-1] > len(buf) or bool(np.any(offs[1:] < offs[:-1])):
        raise ValueError("row_offsets must be ascending offsets into buf")
    out = np.empty(n, dtype=KEY_DTYPE)
    host_lib().ptt_hash_rows(buf, offs.ctypes.data, n, out.ctypes.data)
    return out


def sequential_keys(start: int, count: int, salt: int = 0) -> np.ndarray:
    """Keys for rows with no explicit primary key: hash of (salt, row number).

    Hashing (vs. raw counters) keeps the shard distribution uniform, which is
    what the sharded index/groupby paths on the mesh rely on."""
    idx = np.arange(start, start + count, dtype=np.uint64)
    # splitmix64 finalizer - cheap, vectorized, well distributed; uint64
    # wraparound is intentional (mod-2^64 arithmetic)
    with np.errstate(over="ignore"):
        z = idx + np.uint64(_SEQ_SALT) + (
            np.uint64(salt) * np.uint64(0xBF58476D1CE4E5B9)
        )
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return z.astype(KEY_DTYPE)


def shard_of(key: int, n_shards: int) -> int:
    """Shard index of a key (reference: low 16 bits of the key,
    src/engine/value.rs:38, src/engine/dataflow/shard.rs:6)."""
    return (int(key) & SHARD_MASK) % n_shards


def shards_of(keys: np.ndarray, n_shards: int) -> np.ndarray:
    return (keys.astype(np.uint64) & np.uint64(SHARD_MASK)) % np.uint64(n_shards)
