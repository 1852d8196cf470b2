"""ctypes bindings of the port's host libraries: ``csrc/host/tokenize_hash.cc``
and ``csrc/host/native_io.cc``.

Every function the libraries export is declared here, once: the batch
tokenizer (``models/tokenizer.py``) and the row keys
(``internals/keys.py``) call through ``host_lib()``; the CSV scanner,
the typed parsers, CRC-32, frame scanning and shard routing of
``native/`` through ``native_io_lib()``.  Each library is built with
``g++`` at first use by ``kernels/build.py``; a failed build or load
raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

from .build import load_host

__all__ = ["host_lib", "native_io_lib", "native_xxh3_64"]

_lib: Optional[ctypes.CDLL] = None
_io_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def host_lib() -> ctypes.CDLL:
    """The host library with all of its functions declared, built at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = load_host("tokenize_hash")
            lib.ptt_tokenize_hash.restype = ctypes.c_int32
            lib.ptt_tokenize_hash.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.ptt_xxh3_64.restype = ctypes.c_uint64
            lib.ptt_xxh3_64.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.ptt_serialize_rows.restype = ctypes.c_int64
            lib.ptt_serialize_rows.argtypes = [
                ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.ptt_hash_rows.restype = None
            lib.ptt_hash_rows.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            _lib = lib
        return _lib


def native_io_lib() -> ctypes.CDLL:
    """The native I/O library with all of its functions declared, built at
    first use.  Buffers are passed as addresses (``c_void_p``)."""
    global _io_lib
    with _lib_lock:
        if _io_lib is None:
            lib = load_host("native_io")
            ptr, i64, u8 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint8
            lib.ptt_csv_count.restype = ctypes.c_int32
            lib.ptt_csv_count.argtypes = [ptr, i64, u8, u8, ptr, ptr]
            lib.ptt_csv_scan.restype = ctypes.c_int32
            lib.ptt_csv_scan.argtypes = [ptr, i64, u8, u8, ptr, ptr, ptr, ptr]
            lib.ptt_csv_unescape.restype = i64
            lib.ptt_csv_unescape.argtypes = [ptr, i64, u8, ptr]
            for name in ("ptt_parse_int64", "ptt_parse_float64"):
                getattr(lib, name).restype = None
                getattr(lib, name).argtypes = [ptr, ptr, ptr, i64, ptr, ptr]
            lib.ptt_crc32.restype = ctypes.c_uint32
            lib.ptt_crc32.argtypes = [ptr, i64, ctypes.c_uint32]
            lib.ptt_frame_scan.restype = i64
            lib.ptt_frame_scan.argtypes = [ptr, i64, ptr, ptr, i64, ptr]
            lib.ptt_shard_rows.restype = None
            lib.ptt_shard_rows.argtypes = [ptr, i64, ctypes.c_uint32, ctypes.c_uint64, ptr, ptr]
            _io_lib = lib
        return _io_lib


def native_xxh3_64(data: bytes) -> int:
    """XXH3-64 (seed 0) of ``data`` by the host library."""
    return int(host_lib().ptt_xxh3_64(data, len(data)))
