"""Shape-census tripwire (counterpart of ``pathway_tpu/ops/recompile_guard.py``).

Eager torch compiles nothing per shape, so what the tripwire guards in
the port is the **shape census**: the set of distinct call signatures
each callable of the serve and decode stack has seen.  A dimension that
stops being bucketed shows up as one callable accumulating signatures
without bound; bounding the census is what keeps one CUDA graph (or one
compiled kernel variant) per signature affordable.  Past its budget
(``ops.recompile_limit``) a tripwire warns once in production and
raises under tests (pytest, or ``PATHWAY_RECOMPILE_STRICT=1``).

``RecompileTripwire`` is the counting primitive, observed by each
callable with its reference shape key; ``guarded_jit`` wraps a plain
function and observes every call's ``signature_of``.  Each tripwire
renders ``pathway_recompile_{signatures,limit,tripped}{callable,id}``.
"""

from __future__ import annotations

import functools
import threading
import warnings
from typing import Any, Callable, Dict, Optional, Set, Tuple

from .. import config, observe

__all__ = [
    "RecompileBudgetExceeded",
    "RecompileTripwire",
    "RecompileWarning",
    "guarded_jit",
    "signature_of",
    "strict_mode",
    "trips",
]

# callable name -> trips over the process's life, kept after the
# tripwire itself is collected
_trips: Dict[str, int] = {}
_trips_lock = threading.Lock()


def trips() -> Dict[str, int]:
    """Every callable whose tripwire tripped in this process, with how
    often (the first excess and every further doubling)."""
    with _trips_lock:
        return dict(_trips)


class RecompileWarning(UserWarning):
    """A callable crossed its shape-signature budget."""


class RecompileBudgetExceeded(RuntimeError):
    """Strict-mode flavor of :class:`RecompileWarning`."""


def strict_mode() -> bool:
    """Raise instead of warn: ``PATHWAY_RECOMPILE_STRICT=1`` / ``=0``,
    on under pytest when unset."""
    return config.get("ops.recompile_strict")


class RecompileTripwire:
    """Distinct signatures of ONE logical callable.  ``observe(key)``
    records a signature; past ``limit`` distinct keys it warns, or
    raises in strict mode, at the first excess and every further
    doubling."""

    def __init__(self, name: str, limit: Optional[int] = None):
        self.name = name
        self.limit = limit if limit is not None else config.get("ops.recompile_limit")
        self._sigs: Set[Any] = set()
        self._lock = threading.Lock()
        self.tripped = False
        self._observe_id = observe.next_id()
        observe.register_provider(self)

    def observe_metrics(self):
        labels = {"callable": self.name, "id": str(self._observe_id)}
        yield ("gauge", "pathway_recompile_signatures", labels, len(self._sigs))
        yield ("gauge", "pathway_recompile_limit", labels, self.limit)
        yield ("gauge", "pathway_recompile_tripped", labels, int(self.tripped))

    @property
    def signatures(self) -> int:
        return len(self._sigs)

    def observe(self, signature: Any) -> bool:
        """Record one signature; True if it was new."""
        if signature in self._sigs:  # the steady state: one set probe, no lock
            return False
        with self._lock:
            if signature in self._sigs:
                return False
            self._sigs.add(signature)
            n = len(self._sigs)
        if n > self.limit and (n == self.limit + 1 or (n & (n - 1)) == 0):
            self.tripped = True
            with _trips_lock:
                _trips[self.name] = _trips.get(self.name, 0) + 1
            msg = (
                f"callable {self.name!r} accumulated {n} shape signatures (budget {self.limit}): "
                f"an input dimension is not bucketed; last signature: {signature!r}. Bucket the "
                "varying dimension or raise PATHWAY_RECOMPILE_LIMIT if the shape set is genuinely this large."
            )
            if strict_mode():
                raise RecompileBudgetExceeded(msg)
            warnings.warn(msg, RecompileWarning, stacklevel=3)
        return True


def signature_of(*args: Any, **kwargs: Any) -> Tuple:
    """Abstract signature of a call: (shape, dtype) for tensors and
    arrays, containers walked structurally, scalars by type and value,
    anything else by type."""

    def leaf(x: Any) -> Any:
        shape = getattr(x, "shape", None)
        dtype = getattr(x, "dtype", None)
        if shape is not None and dtype is not None:
            return (tuple(shape), str(dtype).replace("torch.", ""))
        if isinstance(x, (list, tuple)):
            return tuple(leaf(v) for v in x)
        if isinstance(x, dict):
            return tuple(sorted((k, leaf(v)) for k, v in x.items()))
        if isinstance(x, (bool, int, float, str, bytes, type(None))):
            return (type(x).__name__, x)
        return type(x).__name__

    sig = tuple(leaf(a) for a in args)
    if kwargs:
        sig += (tuple(sorted((k, leaf(v)) for k, v in kwargs.items())),)
    return sig


def guarded_jit(fn: Optional[Callable] = None, *, name: Optional[str] = None, limit: Optional[int] = None) -> Callable:
    """A plain function with the tripwire attached: each call's
    ``signature_of`` is observed before it runs.  Usable bare
    (``@guarded_jit``) or configured (``@guarded_jit(limit=8)``); the
    wrapper exposes ``.tripwire``."""
    if fn is None:
        return lambda f: guarded_jit(f, name=name, limit=limit)
    tripwire = RecompileTripwire(name or getattr(fn, "__qualname__", repr(fn)), limit=limit)

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any):
        tripwire.observe(signature_of(*args, **kwargs))
        return fn(*args, **kwargs)

    wrapper.tripwire = tripwire
    return wrapper
