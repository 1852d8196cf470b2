"""Runtime type system for the port's tables (counterpart of
``pathway_tpu/internals/dtype.py``).

Design notes: the reference models column types as a Rust ``Type`` enum plus a
mirrored Python ``dtype`` module (reference: src/engine/value.rs:487-530,
python/pathway/internals/dtype.py).  Here dtypes are lightweight singletons /
parametric wrappers used for schema checking and for picking the storage layout
of a column (numpy object column vs. dense numeric column vs. device array).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, Union, get_args, get_origin

import numpy as np
import torch

__all__ = [
    "DType",
    "ANY",
    "NONE",
    "BOOL",
    "INT",
    "FLOAT",
    "STR",
    "BYTES",
    "POINTER",
    "JSON",
    "DATE_TIME_NAIVE",
    "DATE_TIME_UTC",
    "DURATION",
    "PY_OBJECT",
    "Array",
    "Tuple_",
    "Optional_",
    "Callable_",
    "wrap",
    "unoptionalize",
    "is_optional",
    "dtype_of_value",
    "numpy_dtype_for",
    "types_lca",
]


class DType:
    """Base class for all dtypes."""

    _name: str = "dtype"

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return self._name

    @property
    def name(self) -> str:
        return self._name

    def is_value_compatible(self, value: Any) -> bool:
        raise NotImplementedError

    # dense = representable as a fixed-width numpy column (device-friendly)
    @property
    def dense(self) -> bool:
        return False

    def __eq__(self, other: object) -> bool:
        return type(self) is type(other) and self.__dict__ == getattr(
            other, "__dict__", None
        )

    def __hash__(self) -> int:
        return hash((type(self), tuple(sorted(self.__dict__.items(), key=str))))


class _Simple(DType):
    def __init__(self, name: str, pytypes: tuple, np_dtype=None, dense: bool = False):
        self._name = name
        self._pytypes = pytypes
        self._np_dtype = np_dtype
        self._dense = dense

    def is_value_compatible(self, value: Any) -> bool:
        if value is None:
            return self is NONE or self is ANY
        return isinstance(value, self._pytypes) or self is ANY

    @property
    def dense(self) -> bool:
        return self._dense

    def __eq__(self, other: object) -> bool:
        return self is other

    def __hash__(self) -> int:
        return id(self)


ANY = _Simple("ANY", (object,))
NONE = _Simple("NONE", (type(None),))
BOOL = _Simple("BOOL", (bool, np.bool_), np.bool_, dense=True)
INT = _Simple("INT", (int, np.integer), np.int64, dense=True)
FLOAT = _Simple("FLOAT", (float, int, np.floating, np.integer), np.float64, dense=True)
STR = _Simple("STR", (str,))
BYTES = _Simple("BYTES", (bytes,))
POINTER = _Simple("POINTER", (int, np.integer), np.uint64, dense=True)
JSON = _Simple("JSON", (dict, list, str, int, float, bool, type(None)))
DATE_TIME_NAIVE = _Simple("DATE_TIME_NAIVE", (datetime.datetime,), "datetime64[ns]", dense=True)
DATE_TIME_UTC = _Simple("DATE_TIME_UTC", (datetime.datetime,), "datetime64[ns]", dense=True)
DURATION = _Simple("DURATION", (datetime.timedelta,), "timedelta64[ns]", dense=True)
PY_OBJECT = _Simple("PY_OBJECT", (object,))


@dataclass(frozen=True)
class Array(DType):
    """N-dimensional array column (reference Value::IntArray/FloatArray,
    src/engine/value.rs:218-219).  When ``n_dim`` and a numeric wrapped dtype
    are known and all rows share a shape, the column is stored as one dense
    ``np.ndarray``/``torch.Tensor`` of shape ``(n_rows, *shape)`` — the device hot
    path for embeddings."""

    n_dim: Optional[int] = None
    wrapped: Optional[DType] = None

    @property
    def _name(self) -> str:  # type: ignore[override]
        return f"Array({self.n_dim}, {self.wrapped})"

    def is_value_compatible(self, value: Any) -> bool:
        if not isinstance(value, (np.ndarray, torch.Tensor)):
            return False
        if self.n_dim is not None and getattr(value, "ndim", None) != self.n_dim:
            return False
        return True

    def __repr__(self) -> str:  # pragma: no cover
        return self._name


@dataclass(frozen=True)
class Tuple_(DType):
    args: Tuple[DType, ...] = ()

    @property
    def _name(self) -> str:  # type: ignore[override]
        return f"Tuple{list(self.args)}"

    def is_value_compatible(self, value: Any) -> bool:
        return isinstance(value, (tuple, list))

    def __repr__(self) -> str:  # pragma: no cover
        return self._name


@dataclass(frozen=True)
class List_(DType):
    """Homogeneous variable-length sequence (reference PathwayType.list,
    engine.pyi:49) — unlike Tuple_, one element type for every position."""

    wrapped: DType = ANY

    @property
    def _name(self) -> str:  # type: ignore[override]
        return f"List({self.wrapped})"

    def is_value_compatible(self, value: Any) -> bool:
        return isinstance(value, (tuple, list)) and all(
            self.wrapped.is_value_compatible(v) for v in value
        )

    def __repr__(self) -> str:  # pragma: no cover
        return self._name


@dataclass(frozen=True)
class Optional_(DType):
    wrapped: DType = ANY

    @property
    def _name(self) -> str:  # type: ignore[override]
        return f"Optional({self.wrapped})"

    def is_value_compatible(self, value: Any) -> bool:
        return value is None or self.wrapped.is_value_compatible(value)

    def __repr__(self) -> str:  # pragma: no cover
        return self._name


@dataclass(frozen=True)
class Callable_(DType):
    @property
    def _name(self) -> str:  # type: ignore[override]
        return "Callable"

    def is_value_compatible(self, value: Any) -> bool:
        return callable(value)


_PY_MAP = {
    int: INT,
    float: FLOAT,
    bool: BOOL,
    str: STR,
    bytes: BYTES,
    dict: JSON,
    type(None): NONE,
    datetime.datetime: DATE_TIME_NAIVE,
    datetime.timedelta: DURATION,
    np.ndarray: Array(),
    Any: ANY,
    object: ANY,
}


def wrap(t: Any) -> DType:
    """Convert a python type annotation / dtype-ish object into a DType."""
    if isinstance(t, DType):
        return t
    if t in _PY_MAP:
        return _PY_MAP[t]
    from .keys import Pointer

    if t is Pointer:
        return POINTER
    origin = get_origin(t)
    if origin is Union:
        args = [a for a in get_args(t) if a is not type(None)]
        if len(args) == 1 and len(get_args(t)) == 2:
            return Optional_(wrap(args[0]))
        return ANY
    if origin in (tuple,):
        return Tuple_(tuple(wrap(a) for a in get_args(t)))
    if origin in (list,):
        return JSON
    if origin is np.ndarray:
        args = get_args(t)
        wrapped = ANY
        if len(args) == 2:
            inner = get_args(args[1])
            if inner:
                wrapped = wrap(inner[0]) if inner[0] in (int, float) else ANY
        return Array(wrapped=wrapped)
    if isinstance(t, type) and issubclass(t, np.floating):
        return FLOAT
    if isinstance(t, type) and issubclass(t, np.integer):
        return INT
    if callable(t) and not isinstance(t, type):
        return Callable_()
    return ANY


def is_optional(t: DType) -> bool:
    return isinstance(t, Optional_) or t is ANY or t is NONE


def unoptionalize(t: DType) -> DType:
    return t.wrapped if isinstance(t, Optional_) else t


def dtype_of_value(value: Any) -> DType:
    if value is None:
        return NONE
    if isinstance(value, bool) or isinstance(value, np.bool_):
        return BOOL
    if isinstance(value, (int, np.integer)):
        return INT
    if isinstance(value, (float, np.floating)):
        return FLOAT
    if isinstance(value, str):
        return STR
    if isinstance(value, bytes):
        return BYTES
    if isinstance(value, datetime.datetime):
        return DATE_TIME_UTC if value.tzinfo is not None else DATE_TIME_NAIVE
    if isinstance(value, datetime.timedelta):
        return DURATION
    if isinstance(value, np.ndarray):
        wrapped = (
            INT
            if np.issubdtype(value.dtype, np.integer)
            else FLOAT
            if np.issubdtype(value.dtype, np.floating)
            else ANY
        )
        return Array(n_dim=value.ndim, wrapped=wrapped)
    if isinstance(value, torch.Tensor):
        return Array(n_dim=value.ndim, wrapped=FLOAT if value.is_floating_point() else INT)
    if isinstance(value, tuple):
        return Tuple_(tuple(dtype_of_value(v) for v in value))
    if isinstance(value, (dict, list)):
        return JSON
    if callable(value):
        return Callable_()
    return PY_OBJECT


def numpy_dtype_for(t: DType):
    """numpy dtype for dense storage, or None → object column."""
    t = unoptionalize(t)
    if isinstance(t, _Simple) and t._np_dtype is not None and t.dense:
        return np.dtype(t._np_dtype)
    return None


_ORDER = {NONE: 0, BOOL: 1, INT: 2, FLOAT: 3}


def types_lca(a: DType, b: DType) -> DType:
    """Least common ancestor of two dtypes (for concat/if_else typing)."""
    if a == b:
        return a
    if a is NONE:
        return Optional_(unoptionalize(b)) if b is not ANY else ANY
    if b is NONE:
        return Optional_(unoptionalize(a)) if a is not ANY else ANY
    if isinstance(a, Optional_) or isinstance(b, Optional_):
        inner = types_lca(unoptionalize(a), unoptionalize(b))
        return ANY if inner is ANY else Optional_(inner)
    if a in _ORDER and b in _ORDER:
        return a if _ORDER[a] >= _ORDER[b] else b
    if isinstance(a, Array) and isinstance(b, Array):
        return Array(
            n_dim=a.n_dim if a.n_dim == b.n_dim else None,
            wrapped=a.wrapped if a.wrapped == b.wrapped else ANY,
        )
    return ANY


class PathwayType:
    """``pw.Type`` — the reference's engine-level type vocabulary
    (engine.pyi:33 PathwayType) mapped onto this module's DTypes; lets
    connector schemas written against the reference (``pw.Type.STRING`` …)
    work unchanged."""

    ANY = ANY
    STRING = STR
    INT = INT
    BOOL = BOOL
    FLOAT = FLOAT
    POINTER = POINTER
    DATE_TIME_NAIVE = DATE_TIME_NAIVE
    DATE_TIME_UTC = DATE_TIME_UTC
    DURATION = DURATION
    JSON = JSON
    BYTES = BYTES
    PY_OBJECT_WRAPPER = PY_OBJECT

    @staticmethod
    def array(dim=None, wrapped=None):
        return Array(n_dim=dim, wrapped=wrapped if wrapped is not None else FLOAT)

    @staticmethod
    def tuple(*args):
        return Tuple_(tuple(args))

    @staticmethod
    def list(arg):
        return List_(arg)

    @staticmethod
    def optional(arg):
        return Optional_(arg)
