"""hidden-sync: implicit host round trips on serve-path modules
(counterpart of ``pathway_tpu/analysis/hidden_sync.py``).

The serving budget is "2 dispatches + 2 fetches per retrieve→rerank
call" (``ops/dispatch_counter.py`` proves it at run time).  A single
stray ``.item()`` on a device tensor, an un-``submit``ted ``predict``
call, a ``torch.cuda.synchronize()`` or a blocking upload quietly adds a
full round trip to every serve — and nothing fails, it just gets
slower.  This rule makes those host round trips lexically visible in the
modules marked serve-path (``# pathway: serve-path`` marker, plus the
default list in core.py).

Checks, per function scope:

- **blocking dispatch+sync**: a scope that both dispatches and fetches
  the result to the host (``.item()`` / ``.tolist()`` / ``.cpu()`` /
  ``.numpy()`` / ``.to("cpu")``, ``np.asarray`` / ``float`` / ``int`` / ``bool`` of
  a device value, or the call of a ``to_host`` waiter: ``fetch()``) is a
  synchronous round trip.  The sanctioned pattern is
  submit/complete: dispatch in one scope, fetch inside the completion
  closure (closures are separate scopes, so the async pattern is clean);
- **fences** — ``torch.cuda.synchronize()``, ``Event.synchronize()``,
  ``Stream.synchronize()`` — anywhere on a serve path: latency fences
  belong in bench and tests, not serving code;
- **blocking uploads** — ``.cuda()`` / ``.to(device)`` /
  ``torch.as_tensor(..., device=...)`` without ``non_blocking=True``, of
  a value not already on a card: a pageable host→device copy
  synchronizes the stream, so the host waits for every kernel queued
  ahead of it (under ``torch.cuda.set_sync_debug_mode`` it reports as a
  sync).  Construction (``__init__``) is not a serve and is skipped;
  the port's ``device.upload`` (pinned, non-blocking) is the fix;
- **un-``submit``ted ``predict``**: ``.predict(...)`` blocks on its
  result; serve paths must use ``.submit(...)`` and complete later;
- **budget accounting** (only in modules that import the dispatch
  counter): a scope that dispatches must call ``record_dispatch``, and a
  scope that fetches must call ``record_fetch`` — otherwise the runtime
  dispatch/fetch assertion silently under-counts.  Cache wrappers
  (``_cached_*`` / ``get_or_*``) are exempt from the budget checks: their
  miss-path dispatch is booked by the caller's dispatch group; so is a
  closure the enclosing scope launches as its dispatch (``def launch():``
  handed to ``retry_call``);
- **fan-out width** (only in budget modules): a booked scope that fans
  stream I/O out in a loop must declare the physical width on the
  booking (``record_dispatch(tag, shards=N)``).

Besides findings, the rule records every function scope of a serve-path
module that performs a host sync, with how the rule accounts for it:
``booked`` (the scope calls ``record_fetch``), ``waived`` (a reviewed
``allow(hidden-sync)`` pragma covers its syncs), ``unbooked`` (allowed
without booking) or ``live`` (an unsuppressed finding).  ``fetch_scopes(paths)`` returns that table:
the runtime side (``chip_smoke.py``'s sanitized phase) holds every sync
that ``torch.cuda.set_sync_debug_mode("warn")`` reports against it.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Tuple

from .core import ModuleContext, Rule
from .registry import (
    booking_declares_fanout,
    dotted_name,
    fence_call,
    host_fetch_call,
    is_cache_wrapper,
    is_device_value_arg,
    is_device_value_base,
    is_dispatch_call,
    is_stream_io,
    method_sync,
    scope_dispatch_and_device_vars,
    scope_fetch_vars,
    transfer_call,
    walk_scope,
)

__all__ = ["HiddenSyncRule", "fetch_scopes"]

_COERCIONS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
              "float", "int", "bool"}


def _non_blocking(call: ast.Call) -> bool:
    return any(
        kw.arg == "non_blocking"
        and isinstance(kw.value, ast.Constant)
        and kw.value.value is True
        for kw in call.keywords
    )


def _moves_device_value(call: ast.Call, device_vars) -> bool:
    """``z.to(other_dev)`` of a value already on a card: a device→device
    copy, which blocks no host thread."""
    if isinstance(call.func, ast.Attribute) and call.func.attr in ("to", "cuda"):
        base = dotted_name(call.func.value)
        return base is not None and base in device_vars
    return False


class HiddenSyncRule(Rule):
    name = "hidden-sync"
    salt_sources = ("hidden_sync.py",)
    description = (
        "implicit host sync / unaccounted dispatch on a serve-path module"
    )

    def __init__(self) -> None:
        # display path -> {qualname: [sync lines]} of serve-path scopes
        self.sync_scopes: Dict[str, Dict[str, dict]] = {}

    def run(self, ctx: ModuleContext) -> None:
        if not ctx.serve_path:
            return
        self._budget_module = (
            "record_dispatch" in ctx.source or "record_fetch" in ctx.source
        )
        self._scopes: Dict[str, dict] = {}
        self._visit_scope(ctx, ctx.tree, None, None, [])
        self.sync_scopes[ctx.display_path] = self._scopes

    def dump_summary(self, display_path: str) -> Optional[dict]:
        return self.sync_scopes.get(display_path)

    def load_summary(self, display_path: str, summary: dict) -> None:
        self.sync_scopes[display_path] = summary

    def _visit_scope(self, ctx, scope, inherited_fns, inherited_vars, qual, closure=False) -> None:
        fns, device_vars = scope_dispatch_and_device_vars(
            scope, ctx.dispatch_names, inherited_fns, inherited_vars
        )
        if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a closure the enclosing function launches as a dispatch (`def
            # launch(): ...` handed to retry_call) is booked by that function
            launched = closure and scope.name in inherited_fns
            self._check_scope(ctx, scope, fns, device_vars, ".".join(qual), launched)
        is_function = isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef))
        for child in ast.iter_child_nodes(scope):
            self._recurse_defs(ctx, child, fns, device_vars, qual, is_function)

    def _recurse_defs(self, ctx, node, fns, dvars, qual, in_function=False) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._visit_scope(ctx, node, fns, dvars, qual + [node.name], closure=in_function)
            return
        if isinstance(node, ast.ClassDef):
            for child in ast.iter_child_nodes(node):
                self._recurse_defs(ctx, child, fns, dvars, qual + [node.name])
            return
        if isinstance(node, ast.Lambda):
            return
        for child in ast.iter_child_nodes(node):
            self._recurse_defs(ctx, child, fns, dvars, qual, in_function)

    def _report_sync(self, ctx, node, message, qual, kind) -> None:
        ctx.report(self.name, node, message)
        entry = self._scopes.setdefault(
            qual, {"lines": [], "booked": False, "live": 0, "waived": 0}
        )
        entry["lines"].append([node.lineno, kind])
        if ctx.findings[-1].suppressed:
            entry["waived"] += 1
        else:
            entry["live"] += 1

    def _check_scope(self, ctx, scope, fns, device_vars, qual, launched=False) -> None:
        # a traced or kernel-wrapper body is not host serving code
        if scope.name in ctx.dispatch_names:
            return
        cache_wrapper = is_cache_wrapper(scope.name)
        dispatches: List[ast.Call] = []
        syncs: List[Tuple[ast.Call, str]] = []
        uploads: List[Tuple[ast.Call, str]] = []
        bookings: List[ast.Call] = []
        has_record_dispatch = False
        has_record_fetch = False
        fetch_vars = scope_fetch_vars(scope)
        for node in walk_scope(scope):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            leaf = callee.rsplit(".", 1)[-1] if callee else ""
            if host_fetch_call(node, fetch_vars) is not None:
                syncs.append((node, host_fetch_call(node, fetch_vars)))
            elif leaf == "record_dispatch":
                has_record_dispatch = True
                bookings.append(node)
            elif leaf == "record_fetch":
                has_record_fetch = True
                bookings.append(node)
            elif is_dispatch_call(node, fns):
                dispatches.append(node)
            elif fence_call(node) is not None:
                self._report_sync(
                    ctx, node,
                    f"`{callee}()` on a serve path — a blocking device "
                    "fence costs a full round trip per call; fences "
                    "belong in bench/tests",
                    qual, "fence",
                )
            elif leaf == "predict" and isinstance(node.func, ast.Attribute):
                ctx.report(
                    self.name, node,
                    f"blocking `{callee}(...)` on a serve path — use "
                    "`.submit(...)` and complete asynchronously so "
                    "consecutive serves pipeline",
                )
            elif callee in _COERCIONS and is_device_value_arg(
                node, fns, device_vars
            ):
                syncs.append((node, callee))
            elif method_sync(node) is not None and is_device_value_base(
                node, device_vars
            ):
                syncs.append((node, f".{method_sync(node)}()"))
            elif (
                transfer_call(node) is not None
                and not _non_blocking(node)
                and scope.name != "__init__"
                and not _moves_device_value(node, device_vars)
            ):
                uploads.append((node, transfer_call(node)))
        if has_record_fetch and (syncs or uploads):
            self._scopes.setdefault(
                qual, {"lines": [], "booked": False, "live": 0, "waived": 0}
            )["booked"] = True
        for node, spelled in uploads:
            if has_record_fetch:
                self._scopes[qual]["lines"].append([node.lineno, "upload"])
                continue
            self._report_sync(
                ctx, node,
                f"blocking upload `{spelled}` on a serve path — a "
                "pageable host→device copy synchronizes the stream, so "
                "the host waits for every kernel queued ahead of it; "
                "copy from pinned memory with non_blocking=True",
                qual, "upload",
            )
        for node, callee in syncs:
            if dispatches:
                self._report_sync(
                    ctx, node,
                    f"`{callee}` of a device value in the same scope that "
                    "dispatched it — a synchronous round trip; move the "
                    "fetch into a completion closure (submit/complete)",
                    qual, "fetch",
                )
            elif self._budget_module and not has_record_fetch and not cache_wrapper:
                self._report_sync(
                    ctx, node,
                    f"`{callee}` fetches a device value but the scope "
                    "never calls record_fetch — the serving fetch budget "
                    "under-counts this round trip",
                    qual, "fetch",
                )
            else:
                self._scopes.setdefault(
                    qual, {"lines": [], "booked": False, "live": 0, "waived": 0}
                )["lines"].append([node.lineno, "fetch"])
        if cache_wrapper:
            return
        if self._budget_module and bookings and not any(
            booking_declares_fanout(b) for b in bookings
        ):
            fanned = self._loop_stream_io(scope)
            if fanned is not None:
                ctx.report(
                    self.name, bookings[0],
                    f"stream fan-out (`{fanned}` inside a loop) booked "
                    "without its physical width — book the scatter as "
                    "record_dispatch(tag, shards=N) / record_fetch(tag, "
                    "shards=N) so the budget stays 1 logical + N physical",
                )
        if self._budget_module and dispatches and not has_record_dispatch and not launched:
            for node in dispatches:
                ctx.report(
                    self.name, node,
                    "device dispatch without record_dispatch in scope — "
                    "the serving dispatch budget under-counts this launch",
                )

    @staticmethod
    def _loop_stream_io(scope) -> Optional[str]:
        """The dotted spelling of the first stream I/O call lexically
        inside a loop of this scope (nested defs excluded), or None."""
        for node in walk_scope(scope):
            if not isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                continue
            for inner in walk_scope(node):
                if isinstance(inner, ast.Call):
                    spelled = is_stream_io(inner)
                    if spelled:
                        return spelled
        return None


def fetch_scopes(paths: Sequence[str]) -> Dict[Tuple[str, str], str]:
    """``{(display path, qualname): "booked" | "waived" | "unbooked" |
    "live"}`` for every serve-path function scope that performs a host
    sync (a fetch, a fence or a blocking upload), as the hidden-sync rule
    accounts for it over ``paths``.  A scope is ``live`` when a sync
    finding in it is unsuppressed, ``booked`` when it calls
    ``record_fetch``, ``waived`` when its sync findings are suppressed by
    reviewed pragmas, and ``unbooked`` when the rule lets its syncs pass
    without booking (a module that imports no dispatch counter, a cache
    wrapper)."""
    from .core import analyze_paths

    rule = HiddenSyncRule()
    analyze_paths(paths, rules=[rule])
    out: Dict[Tuple[str, str], str] = {}
    for path, scopes in rule.sync_scopes.items():
        for qual, entry in scopes.items():
            if not entry["lines"]:
                continue
            if entry["live"]:
                out[(path, qual)] = "live"
            elif entry["booked"]:
                out[(path, qual)] = "booked"
            elif entry["waived"]:
                out[(path, qual)] = "waived"
            else:
                out[(path, qual)] = "unbooked"
    return out
