"""The declared lock hierarchy for the port's serve stack — ONE ordered
table (counterpart of ``pathway_tpu/analysis/lock_ranks.py``, with the
same ranks, so a port lock site and its reference twin rank alike).

The thread fabric behind the serve tier holds 60+ distinct locks across
the scheduler, decode slot pool, cache tiers, indexes, shard group,
exchange plane and the observe stack.  Per-module lock discipline
(``lock_discipline.py``) keeps device work out of lock bodies, but says
nothing about cross-module ACQUISITION ORDER — the deadlock dimension.
This module declares the order; ``lock_order.py`` (static) and
``sanitizer.py`` (runtime) enforce it.

The hierarchy, lowest to highest::

    observe < cache < model < index < shard < scheduler < pool

reads "a lock on the LEFT may be acquired while holding a lock on the
RIGHT".  Equivalently: **threads acquire in descending rank order** —
while holding a lock of rank ``r`` you may only acquire locks of rank
``< r`` (equal ranks are ordered by the cycle check instead, so two
same-domain locks may nest as long as every thread agrees on the
direction).  The top of the table is the outermost coordination layer
(the decode slot pool and admission scheduler own threads and drive the
layers below); the bottom is leaf bookkeeping (metrics counters, trace
stores) that every layer may touch last.

Domain assignment is by DEFINING module: a lock created in
``cache/store.py`` is a ``cache``-rank lock wherever it is acquired.
Modules outside the serve stack (engine operators, IO connectors,
stdlib, xpacks) are **unranked**: their locks still participate in
deadlock-cycle detection, but the rank table makes no claim about them.

A deliberate exception to the declared order is waived in place with a
reviewed pragma naming the rank exception::

    with self._lock:  # pathway: allow(lock-order): <which ranks and why safe>
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

__all__ = [
    "DECLARED_EXCEPTIONS",
    "RANK_ORDER",
    "domain_of_path",
    "domain_of_receiver",
    "pair_waived",
    "rank_name",
    "rank_of_path",
    "rank_of_receiver",
    "table",
]

# lowest (innermost leaf) → highest (outermost coordinator)
RANK_ORDER: Tuple[str, ...] = (
    "observe",    # 0: metrics/trace/profiler/SLO bookkeeping, tripwires
    "cache",      # 1: result/embedding/prefix-KV tiers, object cache
    "model",      # 2: encoder/cross-encoder/generator compiled-fn caches
    "index",      # 3: IVF, forward index, kNN structures
    "shard",      # 4: shard group, exchange plane, process clusters
    "scheduler",  # 5: admission queue, serve pipelines, batch handoff
    "pool",       # 6: continuous-decode slot pool (owns the step loop)
)

_RANK_BY_NAME = {name: i for i, name in enumerate(RANK_ORDER)}

# ordered (pattern, domain) table over repo-relative display paths; the
# FIRST match wins.  Paths normalised to "/" before matching.
_DOMAIN_PATTERNS: Tuple[Tuple[re.Pattern, str], ...] = tuple(
    (re.compile(pat), dom)
    for pat, dom in (
        # observe: the flight recorder + derived samplers, plus the
        # runtime tripwires (dispatch counter, recompile guard) and the
        # robust layer's breaker/retry/inject bookkeeping — all leaf
        # locks held only around counter/dict updates
        (r"(^|/)observe/", "observe"),
        (r"(^|/)robust/", "observe"),
        (r"(^|/)ops/dispatch_counter\.py$", "observe"),
        (r"(^|/)ops/recompile_guard\.py$", "observe"),
        (r"(^|/)analysis/", "observe"),
        # cache: the serve cache tiers and the persistence object cache
        (r"(^|/)cache/", "cache"),
        (r"(^|/)persistence/", "cache"),
        # model: per-model compiled-fn caches and parameter state
        (r"(^|/)models/", "model"),
        # index: IVF + forward + kNN/LSH structures
        (r"(^|/)ops/ivf\.py$", "index"),
        (r"(^|/)ops/knn\.py$", "index"),
        (r"(^|/)index/", "index"),
        (r"(^|/)stdlib/ml/", "index"),
        # shard: device shard group + host exchange/cluster planes
        (r"(^|/)parallel/", "shard"),
        # scheduler: admission + serve pipelines (the coalescing
        # scheduler, fused search, retrieve→rerank handoff locks)
        (r"(^|/)serve/scheduler\.py$", "scheduler"),
        (r"(^|/)ops/serving\.py$", "scheduler"),
        (r"(^|/)ops/retrieve_rerank\.py$", "scheduler"),
        # pool: the continuous-decode slot pool
        (r"(^|/)serve/decode\.py$", "pool"),
    )
)


# receiver-name convention for OPAQUE lock sites (`with child._lock:`
# where `child`'s class is statically unknown): the serve stack names
# its cross-object receivers consistently, so the spelling carries the
# domain even when the defining class does not resolve.  Only receivers
# listed here get a rank; everything else stays unranked.
_RECEIVER_DOMAINS = {
    "index": "index",
    "ivf": "index",
    "forward": "index",
    "child": "index",      # shard-resident per-child index handles
    "shard": "shard",
    "plane": "shard",
    "group": "shard",
    "gen": "model",
    "generator": "model",
    "encoder": "model",
    "model": "model",
    "cache": "cache",
    "tier": "cache",
    "sched": "scheduler",
    "scheduler": "scheduler",
    "pipe": "scheduler",
    "pipeline": "scheduler",
    "pool": "pool",
    "engine": "pool",
}


# reviewed DOMAIN-PAIR exceptions to the descending rule — the runtime
# sanitizer's mirror of the port's `# pathway: allow(lock-order)` pragmas
# in code (the static side waives at the acquisition site; the runtime side
# sees the lock's REAL defining module, so the same exception must be
# declared here).  (outer, inner) means "an `outer`-domain lock may be
# held while acquiring an `inner`-domain lock despite inner > outer".
# Adding a pair here is a review event, exactly like adding a pragma.
DECLARED_EXCEPTIONS = frozenset(
    {
        # index-before-pipeline: the fused-serve pair order at every
        # site (the IVF absorb writes the slabs in place, so the stage-1
        # launch is enqueued before the index lock drops; the pipeline's
        # lock nests inside) — see ops/serving.py's lock-order pragmas
        ("index", "scheduler"),
    }
)


def pair_waived(outer_rank: Optional[int], inner_rank: Optional[int]) -> bool:
    """True when (outer, inner) is a declared rank-pair exception."""
    if outer_rank is None or inner_rank is None:
        return False
    return (
        RANK_ORDER[outer_rank], RANK_ORDER[inner_rank]
    ) in DECLARED_EXCEPTIONS


def domain_of_receiver(receiver: str) -> Optional[str]:
    """Rank domain for an opaque lock's receiver spelling (``child`` in
    ``with child._lock:``), or None when the name carries no convention."""
    return _RECEIVER_DOMAINS.get(receiver.lstrip("_"))


def rank_of_receiver(receiver: str) -> Optional[int]:
    domain = domain_of_receiver(receiver)
    return None if domain is None else _RANK_BY_NAME[domain]


def domain_of_path(display_path: str) -> Optional[str]:
    """Rank domain for a lock DEFINED in ``display_path`` (repo-relative
    or absolute; separators normalised), or None when the module is off
    the declared serve stack."""
    path = display_path.replace("\\", "/")
    for pattern, domain in _DOMAIN_PATTERNS:
        if pattern.search(path):
            return domain
    return None


def rank_of_path(display_path: str) -> Optional[int]:
    """Numeric rank (0 = innermost leaf) for a defining module, or None
    when unranked."""
    domain = domain_of_path(display_path)
    return None if domain is None else _RANK_BY_NAME[domain]


def rank_name(rank: Optional[int]) -> str:
    if rank is None:
        return "unranked"
    return f"{RANK_ORDER[rank]}({rank})"


def table() -> str:
    """The one-line rendering used by docs and diagnostics."""
    return " < ".join(RANK_ORDER)
