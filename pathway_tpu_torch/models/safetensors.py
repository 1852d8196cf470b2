"""safetensors files read and written with ``json`` and numpy (the
reference reads them with ``safetensors.numpy.load_file``,
``pathway_tpu/models/hf_import.py:136-145``; the port may not import
that package).

The format: an 8-byte little-endian header length ``N``, ``N`` bytes of
JSON ``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` map of strings, then the raw little-endian
tensor bytes, offsets counted from the end of the header.

``load_file`` maps exactly the dtypes ``safetensors.numpy`` maps (F64,
F32, F16, I64, U64, I32, U32, I16, U16, I8, U8, BOOL, C64).  numpy has no
bfloat16 of its own, so a ``BF16`` tensor raises ``TypeError``, as
``safetensors.numpy`` does in a process without ``ml_dtypes``; it is
never widened quietly.  ``save_file``
writes what ``load_file`` reads (and what ``safetensors.numpy`` reads
back): tensors in name order, the header padded with spaces to 8 bytes.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

__all__ = ["load_file", "load_file_with_metadata", "save_file"]

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "U64": np.uint64,
    "I32": np.int32,
    "U32": np.uint32,
    "I16": np.int16,
    "U16": np.uint16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
    "C64": np.complex64,
}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}

# a header larger than this is a corrupt length field, not a real header
_MAX_HEADER = 100 * 1024 * 1024


def load_file_with_metadata(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """``(tensors, metadata)`` of one safetensors file; each array is a
    writable view into one buffer holding the file's data."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
        (n_header,) = struct.unpack("<Q", raw)
        if n_header > _MAX_HEADER:
            raise ValueError(f"{path}: header length {n_header} is not plausible")
        header = json.loads(f.read(n_header).decode("utf-8"))
        data = bytearray(f.read())
    metadata = header.pop("__metadata__", None) or {}
    tensors: Dict[str, np.ndarray] = {}
    for name, spec in header.items():
        dtype_name = spec["dtype"]
        if dtype_name not in _DTYPES:
            raise TypeError(
                f"{path}: tensor {name!r} has dtype {dtype_name}, which numpy cannot hold "
                f"(mapped: {', '.join(_DTYPES)})"
            )
        dtype = np.dtype(_DTYPES[dtype_name])
        shape = tuple(int(s) for s in spec["shape"])
        begin, end = (int(o) for o in spec["data_offsets"])
        n = int(np.prod(shape))
        if not 0 <= begin <= end <= len(data) or end - begin != n * dtype.itemsize:
            raise ValueError(f"{path}: tensor {name!r} has offsets {begin}..{end} that do not fit {shape} {dtype_name}")
        if n:
            tensors[name] = np.frombuffer(data, dtype=dtype, count=n, offset=begin).reshape(shape)
        else:
            tensors[name] = np.zeros(shape, dtype)
    return tensors, metadata


def load_file(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a safetensors file, by name."""
    return load_file_with_metadata(path)[0]


def save_file(
    tensors: Mapping[str, Any], path: str, metadata: Optional[Mapping[str, str]] = None
) -> None:
    """Write numpy arrays under their names; ``metadata`` maps strings to
    strings."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    arrays = []
    offset = 0
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])  # tobytes() below writes C order
        code = f"{arr.dtype.kind}{arr.dtype.itemsize}"  # byte order aside
        dtype_name = _NAMES.get(np.dtype(code))
        if dtype_name is None:
            raise TypeError(f"tensor {name!r}: dtype {arr.dtype} has no safetensors name here")
        arr = arr.astype("<" + code, copy=False)
        header[name] = {"dtype": dtype_name, "shape": list(arr.shape), "data_offsets": [offset, offset + arr.nbytes]}
        arrays.append(arr)
        offset += arr.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for arr in arrays:
            f.write(arr.tobytes())
