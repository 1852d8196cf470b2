"""Stubs for the names of the reference's ``pw`` namespace whose modules
are later slices of the port (the transport-gated connectors under
``pw.io``).

Each stub raises ``NotImplementedError`` naming its slice in ``ROADMAP.md``
when it is used, so a program written for the reference stops with a
message that says what is missing, never with ``AttributeError``.  A
module becomes a stub module (every public attribute is a stub
function).  Every stub carries its slice as ``later_slice``."""

from __future__ import annotations

import types

__all__ = ["later_slice", "LaterSliceModule"]


def _message(qualname: str, slice_name: str, what: str) -> str:
    return f"pw.{qualname} ({what}) is not ported yet: ROADMAP.md, framework slice {slice_name}"


def later_slice(qualname: str, slice_name: str, what: str):
    """A function that raises ``NotImplementedError`` naming the slice."""

    def unported(*args, **kwargs):
        raise NotImplementedError(_message(qualname, slice_name, what))

    unported.__name__ = qualname.rsplit(".", 1)[-1]
    unported.__qualname__ = qualname
    unported.later_slice = slice_name
    return unported


class LaterSliceModule(types.ModuleType):
    """A module of a later slice: each public attribute is a stub
    function naming the slice; private and dunder names stay
    ``AttributeError``, as the import machinery expects."""

    def __init__(self, qualname: str, slice_name: str, what: str):
        super().__init__(f"pw.{qualname}", f"not ported yet: ROADMAP.md, framework slice {slice_name}")
        self.later_slice = slice_name
        self._qualname = qualname
        self._what = what

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return later_slice(f"{self._qualname}.{name}", self.later_slice, self._what)
