"""Per-row error values.

Reference: ``Value::Error`` (src/engine/value.rs:225) + DataError routing
(src/engine/error.rs) — a failing expression poisons the *cell*, not the
pipeline; filters drop error rows; sinks surface them.  ``ERROR`` is the
singleton sentinel; ``unsafe_promise_not_error``-style unwrapping can be
added at the expression layer."""

from __future__ import annotations

__all__ = ["Error", "ERROR", "is_error"]


class Error:
    """Sentinel for a failed per-row computation."""

    _instance = None

    def __new__(cls, message: str = ""):
        if message:
            obj = super().__new__(cls)
            obj.message = message
            return obj
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance.message = ""
        return cls._instance

    def __repr__(self):
        return f"Error({self.message})" if self.message else "Error"

    def __bool__(self):
        return False

    def __eq__(self, other):
        return isinstance(other, Error)

    def __hash__(self):
        return hash(Error)


ERROR = Error()


def is_error(v) -> bool:
    return isinstance(v, Error)
