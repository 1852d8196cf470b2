"""ctypes bindings of the port's host library (``csrc/host/tokenize_hash.cc``).

Every function the library exports is declared here, once: the batch
tokenizer (``models/tokenizer.py``) and the row keys
(``internals/keys.py``) both call through ``host_lib()``.  The library is
built with ``g++`` at first use by ``kernels/build.py``; a failed build
or load raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

from .build import load_host

__all__ = ["host_lib", "native_xxh3_64"]

_lib: Optional[ctypes.CDLL] = None
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


def native_xxh3_64(data: bytes) -> int:
    """XXH3-64 (seed 0) of ``data`` by the host library."""
    return int(host_lib().ptt_xxh3_64(data, len(data)))
