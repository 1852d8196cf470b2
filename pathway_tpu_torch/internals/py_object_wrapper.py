"""Opaque Python objects as first-class engine values.

Reference: ``PyObjectWrapper`` (src/engine/py_object_wrapper.rs:130,
internals/api.py:256 ``wrap_py_object``) lets arbitrary Python objects flow
through the Rust engine by serializing them (pickle by default, custom
serializer optional) at worker-exchange and persistence boundaries.  This
engine is Python-native, so the wrapper's job here is narrower: mark a value
as deliberately opaque (schemas type it ``PyObjectWrapper``) and carry the
serializer used when the value crosses a persistence/snapshot boundary.
"""

from __future__ import annotations

import importlib
import pickle
from typing import Any, Generic, Optional, TypeVar

__all__ = ["PyObjectWrapper", "wrap_py_object"]

T = TypeVar("T")


def _serializer_spec(serializer) -> Optional[str]:
    """A reimportable name for a module-style serializer (e.g. ``dill``)."""
    name = getattr(serializer, "__name__", None)
    if name is not None:
        try:
            if importlib.import_module(name) is serializer:
                return name
        except ImportError:
            pass
    return None


def _rebuild(payload: bytes, serializer_name: Optional[str]) -> "PyObjectWrapper":
    serializer = (
        pickle if serializer_name is None else importlib.import_module(serializer_name)
    )
    return PyObjectWrapper(
        serializer.loads(payload),
        serializer=None if serializer_name is None else serializer,
    )


def _rebuild_obj(payload: bytes, serializer) -> "PyObjectWrapper":
    return PyObjectWrapper(serializer.loads(payload), serializer=serializer)


class PyObjectWrapper(Generic[T]):
    """``pw.PyObjectWrapper[T]`` — holds ``.value``; equality/hash delegate
    to the wrapped object so wrapped values group and join naturally."""

    __slots__ = ("value", "_serializer")

    def __init__(self, value: T, *, serializer=None):
        self.value = value
        self._serializer = serializer

    def __repr__(self) -> str:
        return f"PyObjectWrapper({self.value!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, PyObjectWrapper) and self.value == other.value

    def __hash__(self) -> int:
        try:
            return hash((PyObjectWrapper, self.value))
        except TypeError:
            # unhashable payloads (dict/list — a primary use case for opaque
            # wrappers) must not TypeError in hashed contexts.  The hash is
            # deliberately COARSE (per payload type): any value-derived hash
            # (pickle bytes, sorted items) breaks the hash/eq contract for
            # payloads that compare equal but serialize differently
            # ({True: 1} == {1: 1}, [1] == [1.0]).  Equal values therefore
            # always collide into the same bucket and resolve via __eq__;
            # engine keys hash via serialization (internals/keys.py), so
            # only host-side dict/set use pays the bucket scan.
            return hash((PyObjectWrapper, type(self.value).__name__))

    def __reduce__(self):
        ser = self._serializer if self._serializer is not None else pickle
        spec = _serializer_spec(ser)
        if spec is not None or ser is pickle:
            return (_rebuild, (ser.dumps(self.value), spec))
        # non-module serializer (class/object with dumps/loads): carry it by
        # reference so the payload is decoded by the same codec
        return (_rebuild_obj, (ser.dumps(self.value), ser))

    # typing sugar: PyObjectWrapper[Simple] in schema annotations
    def __class_getitem__(cls, item):
        return cls


def wrap_py_object(object: T, *, serializer=None) -> PyObjectWrapper[T]:
    """Wrap an arbitrary Python object for use as an engine value
    (reference internals/api.py:256).  ``serializer`` needs ``dumps``/``loads``
    (e.g. the ``dill`` module); ``pickle`` is the default."""
    return PyObjectWrapper(object, serializer=serializer)
