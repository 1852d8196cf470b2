"""Helpers for connectors whose transport library is not bundled.

The connector modules are always importable (so ``pw.io.<name>`` exists and
documents its surface); the ImportError fires at call time with a clear
message, mirroring how the reference gates optional xpack deps.
"""

from __future__ import annotations

import importlib

__all__ = ["require"]


def require(module: str, connector: str, hint: str = ""):
    try:
        return importlib.import_module(module)
    except ImportError as e:
        msg = f"pw.io.{connector} requires the {module!r} package (not installed)"
        if hint:
            msg += f"; {hint}"
        raise ImportError(msg) from e
