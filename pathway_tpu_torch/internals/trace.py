"""User-frame tracing for engine errors.

The reference captures the user's stack frame at every operator/expression
build site (python/pathway/internals/trace.py; ``Trace``
src/engine/error.rs:198) and re-raises engine errors pointing at the user's
line (graph_runner/__init__.py:218-230).  Here operators are built eagerly
at Table-API call time, so the frame is captured once in
``EngineGraph.add_operator`` / expression constructors and attached to the
operator; the executor re-raises any exception escaping an operator as
``EngineErrorWithTrace`` naming that line.
"""

from __future__ import annotations

import linecache
import os
import sys
from dataclasses import dataclass
from typing import Optional

__all__ = ["Trace", "trace_user_frame", "EngineErrorWithTrace", "reraise_with_trace"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass(frozen=True)
class Trace:
    file: str
    line: int
    function: str
    line_text: str

    def __str__(self) -> str:
        src = self.line_text.strip()
        loc = f"{self.file}:{self.line} in {self.function}"
        return f"{loc}: {src}" if src else loc


def trace_user_frame() -> Optional[Trace]:
    """The innermost stack frame OUTSIDE the pathway_tpu_torch package — i.e. the
    user's line that triggered the current API call."""
    frame = sys._getframe(1)
    while frame is not None:
        fname = frame.f_code.co_filename
        if (
            not fname.startswith(_PKG_DIR + os.sep)
            and "importlib" not in fname
            and not fname.startswith("<")
        ):
            return Trace(
                file=fname,
                line=frame.f_lineno,
                function=frame.f_code.co_name,
                line_text=linecache.getline(fname, frame.f_lineno) or "",
            )
        frame = frame.f_back
    return None


class EngineErrorWithTrace(Exception):
    """An engine-side failure re-raised with the user frame that built the
    failing operator (the reference's re-raise contract)."""

    def __init__(self, message: str, trace: Optional[Trace] = None):
        super().__init__(message)
        self.trace = trace


def reraise_with_trace(op, exc: BaseException) -> None:
    """Wrap an exception escaping operator ``op`` with its build-site user
    frame and re-raise; already-wrapped errors pass through untouched."""
    if isinstance(exc, EngineErrorWithTrace):
        raise exc
    trace = getattr(op, "trace", None)
    loc = f" (defined at {trace})" if trace is not None else ""
    raise EngineErrorWithTrace(
        f"error inside operator {op.name}#{op.id}{loc}: "
        f"{type(exc).__name__}: {exc}",
        trace,
    ) from exc
