"""lock-discipline: no device work or GIL-holding C calls under a lock
(counterpart of ``pathway_tpu/analysis/lock_discipline.py``).

The reference's round-5 bug class, in the port's idioms: a kernel launch
plus a ``.cpu()`` fetch inside an index's lock section (every concurrent
``search``/``submit`` stalls for the whole absorb), or one
multi-hundred-MB ``pickle.dumps`` holding the GIL so a heartbeat thread
starves.  Both are invisible to tests that don't race the exact schedule
— but both are *lexically visible*: a call with device-dispatch /
host-sync / transfer / GIL-holding semantics inside a ``with <lock>:``
body.

Flagged inside lock bodies (nested ``def``/``lambda`` bodies excluded —
they execute later, not under the lock):

- device dispatches (kernel wrappers, ``guarded_jit`` / ``profile.wrap``
  bindings, per-shape getters, ``retry_call`` over any of them — see
  ``registry.py``): a launch enqueues device work and can block in C on
  a full launch queue or an allocator sync;
- ``torch.cuda.synchronize()`` / ``Event.synchronize()`` /
  ``Stream.synchronize()`` — an unbounded host sync;
- transfers to the device: ``.cuda()``, ``.to(device)``,
  ``torch.as_tensor(..., device=...)`` — a pageable copy blocks the
  calling thread for the whole copy;
- ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
  ``.to("cpu")`` and ``np.asarray`` / ``float`` / ``int`` / ``bool`` of a value a
  dispatch produced, and the call of a ``to_host`` waiter (``fetch()``)
  — a device→host sync;
- ``pickle.dumps`` / ``pickle.loads`` / ``Pickler.dump`` /
  ``Unpickler.load`` — one GIL-holding C call for the whole payload;
- completing a serve handle (``handle = <obj>.submit(...)`` then
  ``handle()`` / ``handle.result()`` / ``handle.advance()``) — the
  completion IS the host fetch (the scheduler's future-handoff contract
  is dispatch on the scheduler thread, fetch on the WAITER);
- serve-cache access (``<*_cache>.get/put/lookup/...``): a cache call
  takes the tier's own lock and fires the cache.get / cache.put chaos
  sites, which may delay or HANG;
- stream network I/O (``<stream|link|peer|conn>.send/.recv/
  .send_request``): a frame send can stall for a full heartbeat timeout.

And the INVERSE scope check on serve-path modules: a trace span opened
as a context manager (``with trace.span(...):`` / ``start_span`` /
``span_timer``) whose body ACQUIRES a lock.  Spans time *work*, not
lock waits.

Deliberate cases (a dispatch-only launch under the lock that snapshots
device state consistently and never blocks on the result) are
suppressed at the statement with a reviewed reason:
``with self._lock:  # pathway: allow(lock-discipline): <why it is safe>``
"""

from __future__ import annotations

import ast
import re
from typing import Set

from .core import ModuleContext, Rule
from .registry import (
    dotted_name,
    fence_call,
    host_fetch_call,
    is_cache_access,
    is_device_value_arg,
    is_device_value_base,
    is_dispatch_call,
    is_handle_fetch,
    is_lock_context,
    is_observability_callback,
    is_stream_io,
    method_sync,
    scope_dispatch_and_device_vars,
    scope_handle_vars,
    transfer_call,
    walk_scope,
)

__all__ = ["LockDisciplineRule"]

_PICKLE_CALLS = {
    "pickle.dumps", "pickle.loads", "pickle.dump", "pickle.load",
    "marshal.dumps", "marshal.loads",
}
_COERCIONS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
              "float", "int", "bool"}
# span-opening context managers (observe/trace.py and OTLP-style APIs):
# `with trace.span(...)`, `with tracer.start_span(...)`, span timers
_SPAN_CM_LEAVES = {"span", "start_span", "span_timer"}


def _is_span_context(with_node: ast.With) -> bool:
    """``with <something>.span(...):`` / ``start_span`` / ``span_timer``
    — a context manager that TIMES its body as a trace span."""
    return _span_item_index(with_node) is not None


def _span_item_index(with_node: ast.With):
    """Index of the first span-opening item in the with statement, or
    None."""
    for i, item in enumerate(with_node.items):
        expr = item.context_expr
        if not isinstance(expr, ast.Call):
            continue
        callee = dotted_name(expr.func)
        if callee is None:
            continue
        if callee.rsplit(".", 1)[-1] in _SPAN_CM_LEAVES:
            return i
    return None


def _lock_item_index(with_node: ast.With):
    """Index of the first lock item in the with statement, or None."""
    for i, item in enumerate(with_node.items):
        name = dotted_name(item.context_expr)
        if name and _LOCK_ITEM_RE.search(name.rsplit(".", 1)[-1]):
            return i
    return None


# mirrors registry.is_lock_context's name heuristic, applied per item so
# the combined `with tracer.span(...), self._lock:` form resolves with
# ITEM ORDER (span before lock = the lock wait is timed)
_LOCK_ITEM_RE = re.compile(r"lock|mutex|cv\b|cond", re.IGNORECASE)


class LockDisciplineRule(Rule):
    name = "lock-discipline"
    salt_sources = ("lock_discipline.py",)
    description = (
        "device dispatch / host sync / GIL-holding C call inside a "
        "`with <lock>:` body"
    )

    def run(self, ctx: ModuleContext) -> None:
        # map each function scope to its (dispatch callables, device vars,
        # serve handles), inheriting through closures so `with` bodies
        # resolve names bound by the enclosing function
        scope_envs = {}

        def visit_scope(scope, inherited_fns, inherited_vars, inherited_handles):
            fns, dvars = scope_dispatch_and_device_vars(
                scope, ctx.dispatch_names, inherited_fns, inherited_vars
            )
            handles = scope_handle_vars(scope, inherited_handles)
            scope_envs[scope] = (fns, dvars, handles)
            # walk_scope stops at nested defs; recurse into them explicitly
            # so closures inherit the enclosing scope's environment
            for child in ast.iter_child_nodes(scope):
                self._recurse_defs(child, fns, dvars, handles, visit_scope)

        visit_scope(ctx.tree, None, None, None)

        for scope, (fns, device_vars, handles) in scope_envs.items():
            for node in walk_scope(scope):
                if isinstance(node, ast.With) and is_lock_context(node):
                    self._check_lock_body(ctx, node, fns, device_vars, handles)

        # the inverse scope check (serve-path modules): a span context
        # manager whose body acquires a lock times the lock WAIT as if
        # it were stage work
        if ctx.serve_path:
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.With) and _is_span_context(node):
                    self._check_span_body(ctx, node)

    def _check_span_body(self, ctx: ModuleContext, span_node: ast.With) -> None:
        message = (
            "trace span opened across a `with <lock>:` boundary on "
            "a serve-path module — spans time WORK, not lock waits; "
            "record the span with explicit timestamps "
            "(trace.current().add_span(name, t0, t1)) around the "
            "work itself, outside the lock acquisition"
        )
        # combined single-statement form: `with tracer.span(...),
        # self._lock:` acquires the lock INSIDE the span timing when the
        # span item comes first (`with self._lock, tracer.span(...)` is
        # the nested span-under-lock shape, which is allowed)
        span_i = _span_item_index(span_node)
        lock_i = _lock_item_index(span_node)
        if lock_i is not None and span_i is not None and span_i < lock_i:
            ctx.report(self.name, span_node, message)
            return
        for inner in walk_scope(span_node):
            if isinstance(inner, ast.With) and is_lock_context(inner):
                ctx.report(self.name, span_node, message)
                return

    def _recurse_defs(self, node, fns, dvars, handles, visit_scope) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            visit_scope(node, fns, dvars, handles)
            return
        if isinstance(node, (ast.Lambda,)):
            return
        for child in ast.iter_child_nodes(node):
            self._recurse_defs(child, fns, dvars, handles, visit_scope)

    def _check_lock_body(
        self,
        ctx: ModuleContext,
        with_node: ast.With,
        fns: Set[str],
        device_vars: Set[str],
        handle_vars: Set[str],
    ) -> None:
        for node in walk_scope(with_node):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            leaf = callee.rsplit(".", 1)[-1] if callee else ""
            if is_dispatch_call(node, fns):
                ctx.report(
                    self.name, node,
                    f"device dispatch `{callee}(...)` under lock — device "
                    "work (and a possible C-level block on a full launch "
                    "queue) while every other thread waits on this lock",
                )
            elif fence_call(node) is not None:
                ctx.report(
                    self.name, node,
                    f"`{callee}()` under lock — unbounded host sync while "
                    "holding the lock",
                )
            elif host_fetch_call(node) is not None:
                ctx.report(
                    self.name, node,
                    f"host fetch `{host_fetch_call(node)}` under lock — the "
                    "waiter blocks until the device finishes and the copy "
                    "lands, while every other thread waits on this lock",
                )
            elif transfer_call(node) is not None:
                ctx.report(
                    self.name, node,
                    f"`{transfer_call(node)}` under lock — a host→device "
                    "transfer blocks the lock for the whole copy",
                )
            elif callee in _PICKLE_CALLS or leaf in ("dump", "load") and (
                callee or ""
            ).split(".", 1)[0].lower().find("pickl") >= 0:
                ctx.report(
                    self.name, node,
                    f"`{callee}` under lock — one GIL-holding C call for "
                    "the whole payload starves every other thread "
                    "(heartbeats included) for its duration",
                )
            elif callee in _COERCIONS and is_device_value_arg(
                node, fns, device_vars
            ):
                ctx.report(
                    self.name, node,
                    f"`{callee}` of a device value under lock — "
                    "implicit device→host sync while holding the lock",
                )
            elif method_sync(node) is not None and is_device_value_base(
                node, device_vars
            ):
                ctx.report(
                    self.name, node,
                    f"`.{method_sync(node)}()` on a device value under lock "
                    "— implicit device→host sync while holding the lock",
                )
            else:
                handle = is_handle_fetch(node, handle_vars)
                cache = is_cache_access(node)
                obs = is_observability_callback(node)
                stream = is_stream_io(node)
                if handle is not None:
                    ctx.report(
                        self.name, node,
                        f"serve handle `{handle}(...)` completed under lock "
                        "— the completion is the host fetch; the "
                        "future-handoff contract is dispatch on the "
                        "scheduler thread, fetch on the WAITER off-lock "
                        "(blocking here stalls every admitter)",
                    )
                elif cache is not None:
                    ctx.report(
                        self.name, node,
                        f"serve-cache access `{cache}(...)` under lock — "
                        "cache calls take the tier's own lock and fire "
                        "the cache.get/cache.put chaos sites (delay/hang);"
                        " keep lookups off the serve locks so a cache "
                        "fault wedges only its own request",
                    )
                elif obs is not None:
                    ctx.report(
                        self.name, node,
                        f"observability callback `{obs}(...)` under lock "
                        "— profiler/ledger/SLO sampling is pull-based by "
                        "design (walks weak registries, fires the "
                        "profile.sample/hbm.ledger/slo.evaluate chaos "
                        "sites, may delay or hang); it belongs on "
                        "scrape/bench threads, never inside a serve-path "
                        "lock where the walk stalls every admitter",
                    )
                elif stream is not None:
                    ctx.report(
                        self.name, node,
                        f"stream network I/O `{stream}(...)` under lock — "
                        "a frame send can stall for a full heartbeat "
                        "timeout on a congested peer and fires the "
                        "fabric.send/fabric.recv chaos sites (delay/hang);"
                        " swap the stream slot under the lock and perform "
                        "the I/O after releasing it (the fabric "
                        "mark_down/close discipline)",
                    )
