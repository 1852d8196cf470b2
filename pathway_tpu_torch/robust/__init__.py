"""Serve-path fault tolerance of the port (counterpart of
``pathway_tpu/robust``): deadlines with stage sub-budgets
(``deadline.py``), the degradation ladder (``degrade.py``), seeded
retries and circuit breakers (``retry.py``) and deterministic fault
injection (``inject.py``)."""

from . import inject
from .deadline import Deadline, DeadlineExceeded, stage1_fraction
from .degrade import (
    EXTRACTIVE_ANSWER,
    HOST_FAILOVER,
    LATE_INTERACTION_SKIPPED,
    LOAD_SHED,
    PARTITION_LOST,
    REPLICA_LOST,
    RERANK_SKIPPED,
    RETRIEVAL_FAILED,
    SHARD_SKIPPED,
    TAIL_SKIPPED,
    ServeResult,
    extractive_answer,
    record_degraded,
)
from .inject import FaultInjected
from .retry import CircuitBreaker, CircuitOpen, RetryPolicy, breaker, log_once, retry_call

__all__ = [
    "CircuitBreaker",
    "CircuitOpen",
    "Deadline",
    "DeadlineExceeded",
    "EXTRACTIVE_ANSWER",
    "FaultInjected",
    "HOST_FAILOVER",
    "LATE_INTERACTION_SKIPPED",
    "LOAD_SHED",
    "PARTITION_LOST",
    "REPLICA_LOST",
    "RERANK_SKIPPED",
    "RETRIEVAL_FAILED",
    "RetryPolicy",
    "SHARD_SKIPPED",
    "ServeResult",
    "TAIL_SKIPPED",
    "breaker",
    "extractive_answer",
    "inject",
    "log_once",
    "record_degraded",
    "retry_call",
    "stage1_fraction",
]
