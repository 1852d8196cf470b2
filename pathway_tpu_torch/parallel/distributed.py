"""Cross-process control plane of the port (counterpart of
``pathway_tpu/parallel/distributed.py``), single-process subset.

The port runs one process: ``is_coordinator()`` is True and
``broadcast_obj`` returns the coordinator's (this process's) value.  The
fault contract is the reference's: a fault at the ``dist.broadcast``
site degrades to a local-only answer (``None`` here, where the value
would have come from the coordinator), counted on
``pathway_dist_degraded_total{site="broadcast"}``, never a hung caller.
A multi-process version over ``torch.distributed`` replaces the body of
``broadcast_obj`` when the port runs replica groups of several
processes; until then warm-state generation agreement
(``serve/warmstate.py``) is single-process.
"""

from __future__ import annotations

from typing import Any, Dict

from .. import observe
from ..robust import inject, log_once

__all__ = ["broadcast_obj", "is_coordinator"]

_degraded_counters: Dict[str, observe.Counter] = {}


def _count_degraded(site: str) -> None:
    c = _degraded_counters.get(site)
    if c is None:
        c = _degraded_counters[site] = observe.counter("pathway_dist_degraded_total", site=site)
    c.inc()


def is_coordinator() -> bool:
    return True


def broadcast_obj(obj: Any = None, *, name: str, deadline=None) -> Any:
    """The coordinator's ``obj`` (``name`` is unique per broadcast, as in
    the reference's key-value store); ``None`` when the site faults."""
    try:
        inject.fire("dist.broadcast", deadline=deadline)
        return obj
    except Exception as exc:  # noqa: BLE001 - a degraded control plane is flagged, never raised
        _count_degraded("broadcast")
        log_once(
            f"dist.broadcast:{type(exc).__name__}",
            "control-plane broadcast %r degraded (%r); serving local value", name, exc,
        )
        return None
