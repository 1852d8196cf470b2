"""Temporal behaviors: delay / cutoff / keep_results (counterpart of
``pathway_tpu/stdlib/temporal/temporal_behavior.py``; reference: python/pathway/stdlib/temporal/temporal_behavior.py:10-101).

Behaviors bound state and control emission cadence of windows.  They are
carried as metadata on windowed operations; the buffering/forgetting engine
operators (reference postpone_core/ignore_late,
src/engine/dataflow/operators/time_column.rs:380,677) consume them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

__all__ = [
    "Behavior",
    "CommonBehavior",
    "ExactlyOnceBehavior",
    "common_behavior",
    "exactly_once_behavior",
]


class Behavior:
    pass


@dataclass
class CommonBehavior(Behavior):
    delay: Optional[Any] = None
    cutoff: Optional[Any] = None
    keep_results: bool = True


def common_behavior(
    delay: Optional[Any] = None,
    cutoff: Optional[Any] = None,
    keep_results: bool = True,
) -> CommonBehavior:
    return CommonBehavior(delay, cutoff, keep_results)


@dataclass
class ExactlyOnceBehavior(Behavior):
    shift: Optional[Any] = None


def exactly_once_behavior(shift: Optional[Any] = None) -> ExactlyOnceBehavior:
    return ExactlyOnceBehavior(shift)
