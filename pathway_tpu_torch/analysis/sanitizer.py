"""Runtime lock-order tripwire — the dynamic twin of ``lock_order.py``
(counterpart of ``pathway_tpu/analysis/sanitizer.py``).

``PATHWAY_LOCK_SANITIZER=1`` (checked at ``pathway_tpu_torch`` import,
before any other module of the package loads) wraps every lock CREATED
by the port's code in an order-recording proxy: ``threading.Lock`` /
``RLock`` / ``Condition`` are replaced by factories that inspect the
creating frame.  A creation under the package root (``_PKG_ROOT``, the
``pathway_tpu_torch`` directory) gets a proxy named by the SAME site
discovery the static analyzer uses (``lock_order.module_lock_sites``: the
runtime edge ``serve.scheduler._CoalescerBase._qlock →
observe.trace._store_lock`` names exactly the identity the static graph
predicted, so live interleavings confirm or refute specific static
edges); everything else (stdlib, torch, pytest internals, the reference
package) keeps the raw primitive at zero cost.

Per acquisition the proxy maintains:

- a **per-thread held stack** — what this thread holds, in order;
- a **global edge set** — every (held → acquired) site pair ever
  observed, with a **cycle check on each NEW edge** (DFS before the
  blocking acquire, so a planted ABBA deadlock raises instead of
  hanging);
- the **rank check** against ``lock_ranks``' declared hierarchy
  (descending order; ``DECLARED_EXCEPTIONS`` mirrors the reviewed
  ``allow(lock-order)`` pragmas);
- ``Condition.wait`` **while holding a second lock** detection;
- a **held-too-long watchdog**: ``PATHWAY_LOCK_HOLD_MS=<ms>`` counts a
  violation when a lock is held past the budget (count-only — wall
  timing is too noisy for a hard failure).

Violation policy: **raise under pytest** (``LockOrderViolation``),
**log + count otherwise** — ``pathway_sanitizer_violations_total{kind}``
on the port's scrape surface, kinds ``rank-inversion`` / ``cycle`` /
``self-deadlock`` / ``wait-holding-lock`` / ``held-too-long``.
``PATHWAY_LOCK_SANITIZER_RAISE`` overrides (1=always raise, 0=never).
``edges()`` hands the observed edge set to a caller that holds it
against the static graph.

This module is pure stdlib (no torch, no pathway imports at module
scope) and registers nothing at import, so ``install()`` can run at the
very top of ``pathway_tpu_torch/__init__`` before any module of the
package creates its locks.  The reference's sanitizer patches the same
constructors: install one of the two at a time.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

__all__ = [
    "LockOrderViolation",
    "edges",
    "enabled_from_env",
    "install",
    "installed",
    "make_lock",
    "reset",
    "stats",
    "uninstall",
    "violations",
]

_log = logging.getLogger("pathway_tpu_torch.sanitizer")

VIOLATION_KINDS = (
    "rank-inversion", "cycle", "self-deadlock", "wait-holding-lock",
    "held-too-long",
)


class LockOrderViolation(RuntimeError):
    """A lock-order rule broken at runtime (raised under pytest)."""


# originals captured at import: the factories and internal state must
# never recurse through themselves
_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock
_ORIG_CONDITION = threading.Condition

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_installed = False
_mutex = _ORIG_LOCK()          # guards the graph/edge/violation state
_tls = threading.local()       # .stack: List[_Held]
_seen_pairs: Set[Tuple[str, str]] = set()
_bad_pairs: Dict[Tuple[str, str], str] = {}  # pair -> violation kind
_graph: Dict[str, Set[str]] = {}
_violation_counts: Dict[str, int] = {k: 0 for k in VIOLATION_KINDS}
_logged: Set[str] = set()
_locks_tracked = 0
_site_tables: Dict[str, Dict[int, Tuple[str, str]]] = {}
_rank_cache: Dict[str, Optional[int]] = {}
_provider = None


def _hold_budget_ns() -> Optional[int]:
    ms = _config().get("analysis.lock_hold_ms")
    return int(ms * 1e6) if ms > 0 else None


def enabled_from_env() -> bool:
    return _config().get("analysis.lock_sanitizer")


def _should_raise() -> bool:
    return _config().get("analysis.lock_sanitizer_raise")


def _config():
    from .. import config

    return config


def _stack() -> List["_Held"]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class _Held:
    __slots__ = ("site", "inst", "rank", "t0_ns")

    def __init__(self, site: str, inst: int, rank: Optional[int]):
        self.site = site
        self.inst = inst
        self.rank = rank
        self.t0_ns = time.monotonic_ns()


# -- identity: shared with the static side --------------------------------
def _site_for_frame(filename: str, lineno: int) -> Tuple[str, Optional[int]]:
    """(site_id, rank) for a lock created at filename:lineno, named by
    the static analyzer's own site table for that module."""
    root_parent = os.path.dirname(_PKG_ROOT)
    rel = filename
    if filename.startswith(root_parent + os.sep):
        rel = os.path.relpath(filename, root_parent)
    table = _site_tables.get(filename)
    if table is None:
        from .lock_order import module_lock_sites

        table = _site_tables[filename] = module_lock_sites(filename, rel)
    rank = _rank_cache.get(filename)
    if filename not in _rank_cache:
        from .lock_ranks import rank_of_path

        rank = _rank_cache[filename] = rank_of_path(filename)
    entry = table.get(lineno)
    if entry is not None:
        return entry[0], rank
    # a creation the static table does not name (local variable, helper
    # factory): stable repo-relative module:line identity (NOT the
    # absolute path — ids must match across checkouts), module rank
    # still applies
    from .lock_order import module_dotted

    return f"{module_dotted(rel)}:{lineno}", rank


# -- violation recording ----------------------------------------------------
def _record_violation(
    kind: str, message: str, raise_ok: bool = True, detail: str = ""
) -> None:
    """``message`` must be STABLE per violation site (it is the log-dedup
    key and lives in a process-lifetime set); per-occurrence numbers go
    in ``detail``, which is logged but never keyed."""
    with _mutex:
        _violation_counts[kind] = _violation_counts.get(kind, 0) + 1
        first = message not in _logged
        if first:
            _logged.add(message)
    if first:  # one log line per distinct message; the counter sees all
        _log.error("lock sanitizer [%s]: %s%s", kind, message, detail)
    if raise_ok and _should_raise():
        raise LockOrderViolation(f"[{kind}] {message}{detail}")


def _path_exists(src: str, dst: str) -> Optional[List[str]]:
    """DFS path src→dst in the observed edge graph (caller holds _mutex)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for succ in _graph.get(node, ()):
            if succ == dst:
                return path + [dst]
            if succ not in seen:
                seen.add(succ)
                stack.append((succ, path + [succ]))
    return None


def _check_acquire(site: str, inst: int, rank: Optional[int], kind: str) -> None:
    """Order checks BEFORE the blocking acquire — a detected deadlock
    raises instead of deadlocking.  Bookkeeping is committed BEFORE any
    raise, so a swallowed first raise (the robust ladder catches broad
    exceptions) still leaves the pair marked bad and every recurrence
    counted and re-raised."""
    stack = _stack()
    if not stack:
        return
    # same-instance re-entry: legal for RLock/Condition (recorded, not an
    # edge), a guaranteed self-deadlock for a plain Lock
    for held in stack:
        if held.inst == inst:
            if kind == "lock":
                _record_violation(
                    "self-deadlock",
                    f"non-reentrant lock `{site}` re-acquired by the "
                    "thread already holding it",
                )
            return
    from .lock_ranks import pair_waived, rank_name, table

    # rank check against EVERY held lock on EVERY acquire (the static
    # side records edges from every held lock — the runtime must not
    # narrow that to the top of the stack, or an inversion against a
    # deeper-held lock hides behind a known-good (top, new) pair).  The
    # clean-path cost is one integer scan over a 1–3 entry stack.
    if rank is not None:
        for h in stack:
            if (
                h.rank is not None
                and h.rank < rank
                and not pair_waived(h.rank, rank)
            ):
                with _mutex:
                    _bad_pairs.setdefault((h.site, site), "rank-inversion")
                _record_violation(
                    "rank-inversion",
                    f"`{site}` ({rank_name(rank)}) acquired while holding "
                    f"`{h.site}` ({rank_name(h.rank)}) — declared "
                    f"hierarchy ({table()}) requires descending rank order",
                )
                break
    top = stack[-1]
    pair = (top.site, site)
    if pair in _seen_pairs:
        if _bad_pairs.get(pair) == "cycle":
            # count every recurrence, raise again under pytest so the
            # offending test fails deterministically
            _record_violation(
                "cycle",
                f"`{site}` acquired while holding `{top.site}` "
                "(recurrence of a reported deadlock cycle)",
            )
        return
    with _mutex:
        fresh = pair not in _seen_pairs
        if fresh:
            _seen_pairs.add(pair)
    if not fresh:
        return  # raced another thread's first observation
    # cycle check on the new edge: does the reverse direction already
    # exist in the observed graph?  The pair is marked bad INSIDE the
    # mutex, before the violation can raise.
    with _mutex:
        cycle = _path_exists(site, top.site)
        if cycle is None:
            _graph.setdefault(top.site, set()).add(site)
        else:
            _bad_pairs[pair] = "cycle"
    if cycle is not None:
        witness = " → ".join(cycle + [cycle[0]] if cycle[-1] != site else cycle)
        _record_violation(
            "cycle",
            f"acquiring `{site}` while holding `{top.site}` closes a "
            f"cycle in the observed acquisition graph (reverse path: "
            f"{witness}) — two threads taking the loop from different "
            "entry points deadlock",
        )


def _on_acquired(site: str, inst: int, rank: Optional[int]) -> None:
    _stack().append(_Held(site, inst, rank))


def _on_release(inst: int) -> None:
    stack = _stack()
    budget = _hold_budget_ns()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i].inst == inst:
            held = stack.pop(i)
            if budget is not None:
                dt = time.monotonic_ns() - held.t0_ns
                if dt > budget:
                    _record_violation(
                        "held-too-long",
                        f"`{held.site}` held past the "
                        f"{budget / 1e6:.0f} ms budget",
                        raise_ok=False,
                        detail=f" ({dt / 1e6:.1f} ms this occurrence)",
                    )
            return


# -- the proxies ------------------------------------------------------------
class _SanLock:
    """Order-recording wrapper over a raw Lock/RLock.  Exposes the full
    lock protocol including the private Condition hooks
    (``_release_save`` / ``_acquire_restore`` / ``_is_owned``) so a
    ``threading.Condition`` built over it works unchanged."""

    __slots__ = ("_inner", "site", "kind", "rank")

    def __init__(self, inner: Any, site: str, kind: str, rank: Optional[int]):
        self._inner = inner
        self.site = site
        self.kind = kind
        self.rank = rank

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking:
            # try-acquires cannot deadlock and carry no ordering claim
            _check_acquire(self.site, id(self), self.rank, self.kind)
        got = self._inner.acquire(blocking, timeout)
        if got:
            _on_acquired(self.site, id(self), self.rank)
        return got

    def release(self) -> None:
        _on_release(id(self))
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        try:
            return self._inner.locked()
        except AttributeError:  # RLock pre-3.12 has no locked()
            return self._is_owned()

    # Condition protocol ---------------------------------------------------
    def _release_save(self):
        _on_release(id(self))
        inner = self._inner
        save = getattr(inner, "_release_save", None)
        if save is not None:
            return save()
        inner.release()
        return None

    def _acquire_restore(self, state) -> None:
        inner = self._inner
        restore = getattr(inner, "_acquire_restore", None)
        if restore is not None:
            restore(state)
        else:
            inner.acquire()
        # re-acquire after a wait re-establishes the hold WITHOUT a new
        # ordering claim (wait-holding-lock already policed the rest)
        _on_acquired(self.site, id(self), self.rank)

    def _is_owned(self) -> bool:
        owned = getattr(self._inner, "_is_owned", None)
        if owned is not None:
            return owned()
        return any(h.inst == id(self) for h in _stack())

    def __repr__(self) -> str:
        return f"<SanLock {self.site} over {self._inner!r}>"


class _SanCondition(_ORIG_CONDITION):
    """``threading.Condition`` over a sanitized lock, with the
    wait-holding-a-second-lock tripwire."""

    def _check_wait(self) -> None:
        me = self._lock
        inst = id(me)
        others = sorted(
            {
                h.site
                for h in _stack()
                if h.inst != inst
            }
        )
        if others:
            site = getattr(me, "site", repr(me))
            _record_violation(
                "wait-holding-lock",
                f"Condition.wait on `{site}` while holding "
                f"{', '.join(others)} — wait releases only its own "
                "lock; every other held lock blocks its waiters for "
                "the whole wait",
            )

    def wait(self, timeout: Optional[float] = None):
        self._check_wait()
        return super().wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        self._check_wait()
        return super().wait_for(predicate, timeout)


# -- factories --------------------------------------------------------------
def _creation_site(depth: int = 2) -> Optional[Tuple[str, int]]:
    try:
        frame = sys._getframe(depth)
    except ValueError:  # pragma: no cover - shallow stack
        return None
    filename = frame.f_code.co_filename
    if not filename.startswith(_PKG_ROOT + os.sep):
        return None
    if os.sep + "analysis" + os.sep in filename:
        return None  # never wrap the analyzer/sanitizer's own locks
    return filename, frame.f_lineno


def _wrap(inner: Any, kind: str, where: Tuple[str, int]) -> _SanLock:
    global _locks_tracked
    site, rank = _site_for_frame(*where)
    with _mutex:
        _locks_tracked += 1
    return _SanLock(inner, site, kind, rank)


def _lock_factory():
    where = _creation_site()
    inner = _ORIG_LOCK()
    if where is None:
        return inner
    return _wrap(inner, "lock", where)


def _rlock_factory():
    where = _creation_site()
    inner = _ORIG_RLOCK()
    if where is None:
        return inner
    return _wrap(inner, "rlock", where)


def _condition_factory(lock: Any = None):
    where = _creation_site()
    if where is None:
        return _ORIG_CONDITION(lock)
    if lock is None:
        # Condition() owns a fresh RLock: track it under the condition's
        # own creation site
        lock = _wrap(_ORIG_RLOCK(), "rlock", where)
    return _SanCondition(lock)


def make_lock(
    name: str, kind: str = "lock", rank: Optional[int] = None
) -> _SanLock:
    """Explicitly tracked lock for tests/fixtures (the planted-deadlock
    pair): named and ranked regardless of where it is created."""
    global _locks_tracked
    inner = _ORIG_RLOCK() if kind == "rlock" else _ORIG_LOCK()
    with _mutex:
        _locks_tracked += 1
    return _SanLock(inner, name, kind, rank)


# -- install / observe -------------------------------------------------------
def install() -> bool:
    """Patch the threading lock constructors (idempotent).  Returns True
    when the sanitizer is active after the call."""
    global _installed
    if _installed:
        return True
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory
    _installed = True
    _ensure_provider()
    return True


def uninstall() -> None:
    """Restore the raw constructors.  Already-wrapped locks keep their
    proxies (they are plain objects); new creations go raw."""
    global _installed
    threading.Lock = _ORIG_LOCK
    threading.RLock = _ORIG_RLOCK
    threading.Condition = _ORIG_CONDITION
    _installed = False


def installed() -> bool:
    return _installed


def reset() -> None:
    """Clear edges/violations (tests, bench A/B arms).  Held stacks are
    per-thread and drain naturally."""
    with _mutex:
        _seen_pairs.clear()
        _bad_pairs.clear()
        _graph.clear()
        _logged.clear()
        for k in list(_violation_counts):
            _violation_counts[k] = 0


def violations() -> Dict[str, int]:
    with _mutex:
        return dict(_violation_counts)


def edges() -> List[Tuple[str, str]]:
    """Every (held, acquired) site pair observed since the last
    ``reset()``, the pairs that closed a cycle excluded."""
    with _mutex:
        return sorted((a, b) for a, succ in _graph.items() for b in succ)


def stats() -> Dict[str, Any]:
    _ensure_provider()
    with _mutex:
        return {
            "installed": _installed,
            "locks_tracked": _locks_tracked,
            "edges_observed": sum(len(v) for v in _graph.values()),
            "violations": dict(_violation_counts),
        }


class _Provider:
    """Flight-recorder provider: the ``pathway_sanitizer_*`` families
    (registered once the observe stack is importable; every kind always
    renders so a zero stays visible on the scrape)."""

    def observe_metrics(self):
        with _mutex:
            counts = dict(_violation_counts)
            tracked = _locks_tracked
            edges = sum(len(v) for v in _graph.values())
        for kind in VIOLATION_KINDS:
            yield (
                "counter",
                "pathway_sanitizer_violations_total",
                {"kind": kind},
                counts.get(kind, 0),
            )
        yield ("gauge", "pathway_sanitizer_locks_tracked", {}, tracked)
        yield ("gauge", "pathway_sanitizer_edges_observed", {}, edges)


def _ensure_provider() -> None:
    """Register the metrics provider when the observe stack is ready.
    At ``pathway_tpu_torch/__init__`` time (install runs FIRST, before the
    package finishes importing) observe is not importable yet — retried
    from ``stats()``."""
    global _provider
    if _provider is not None:
        return
    try:
        from ..observe import register_provider
    except Exception:
        return
    _provider = _Provider()
    register_provider(_provider)
