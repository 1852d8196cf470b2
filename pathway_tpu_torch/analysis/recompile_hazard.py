"""recompile-hazard: the port's shape census — an unbucketed host length
reaching an observed callable (counterpart of
``pathway_tpu/analysis/recompile_hazard.py``).

Eager torch compiles nothing per shape, but the port keeps the
reference's discipline all the same: every callable of the serve and
decode stack sees a small closed set of shapes, so that one CUDA graph
(or one compiled kernel variant) per signature stays affordable.  The
runtime census is ``ops/recompile_guard.py``: a ``RecompileTripwire``
observed by a callable with its shape key, or a ``guarded_jit`` wrapper
observing every call's signature, trips past its budget.

A census key can lie: a scope may observe ``_bucket(nq)`` and then hand
the callable a tensor that keeps ``nq`` rows.  This rule checks the
tensors themselves.  Per function scope:

- an **upload** is ``torch.from_numpy(x)`` / ``torch.as_tensor(x)`` /
  ``torch.tensor(x)`` / ``torch.asarray(x)`` / ``upload(x, dev)`` (and any ``.to(...)`` /
  ``.cuda()`` / ``.contiguous()`` chained onto it): host data whose
  leading size is a Python-varying length;
- it is **bucketed** when ``x`` derives, through the scope's
  assignments, from a bucketing helper's result (``_bucket``,
  ``seg_bucket``, ``row_length_bucket``, ``pad_packed_rows``,
  ``tail_bucket``): the padding follows the census;
- an unbucketed upload (or a name bound from one) that reaches an
  **observed callable** is a finding: a ``guarded_jit`` callable, a
  per-shape getter's callable, or any dispatch in a scope that observes
  a tripwire (``<...tripwire>.observe(...)``).

Waive a deliberate case with its reason:
``# pathway: allow(recompile-hazard): <why the shape set stays closed>``.
"""

from __future__ import annotations

import ast
from typing import Set

from .core import ModuleContext, Rule
from .registry import (
    _CACHE_GETTER_RE,
    dotted_name,
    is_dispatch_call,
    scope_dispatch_and_device_vars,
    walk_scope,
)

__all__ = ["RecompileHazardRule"]

_UPLOAD_CALLS = {
    "torch.from_numpy", "torch.as_tensor", "torch.tensor", "torch.asarray",
    "upload", "device.upload",
}
_CHAIN_METHODS = {"to", "cuda", "contiguous", "float", "half", "bfloat16", "long", "int"}
_BUCKET_HELPERS = {
    "_bucket", "seg_bucket", "row_length_bucket", "pad_packed_rows", "tail_bucket",
}
_GUARDED_CTORS = {"guarded_jit", "recompile_guard.guarded_jit"}


def _names_in(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        name = dotted_name(sub) if isinstance(sub, ast.Attribute) else None
        if name is not None:
            out.add(name)
    return out


def _calls_bucket(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            callee = dotted_name(sub.func) or ""
            if callee.rsplit(".", 1)[-1] in _BUCKET_HELPERS:
                return True
    return False


def _upload_arg(node: ast.AST):
    """The host argument of an upload expression (through chained
    methods), or None when ``node`` is not an upload."""
    while (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in _CHAIN_METHODS
    ):
        node = node.func.value
    if isinstance(node, ast.Call) and dotted_name(node.func) in _UPLOAD_CALLS and node.args:
        return node.args[0]
    return None


def _guarded_names(tree: ast.AST) -> Set[str]:
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                ctor = dotted_name(dec.func if isinstance(dec, ast.Call) else dec)
                if ctor in _GUARDED_CTORS:
                    names.add(node.name)
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if dotted_name(node.value.func) in _GUARDED_CTORS:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        names.add(tgt.id)
    return names


class RecompileHazardRule(Rule):
    name = "recompile-hazard"
    salt_sources = ("recompile_hazard.py",)
    description = (
        "an upload of host data with no shape bucketing reaches a callable "
        "the shape census observes — every distinct input size is a new "
        "signature"
    )

    def run(self, ctx: ModuleContext) -> None:
        self._guarded = _guarded_names(ctx.tree)
        self._visit_scope(ctx, ctx.tree, None)

    def _visit_scope(self, ctx, scope, inherited_fns) -> None:
        fns, _dvars = scope_dispatch_and_device_vars(
            scope, ctx.dispatch_names, inherited_fns, None
        )
        if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._check_scope(ctx, scope, fns)
        for child in ast.iter_child_nodes(scope):
            self._recurse_defs(ctx, child, fns)

    def _recurse_defs(self, ctx, node, fns) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._visit_scope(ctx, node, fns)
            return
        if isinstance(node, ast.Lambda):
            return
        for child in ast.iter_child_nodes(node):
            self._recurse_defs(ctx, child, fns)

    def _check_scope(self, ctx, scope, fns: Set[str]) -> None:
        if scope.name in ctx.dispatch_names:
            return  # the observed body itself: its uploads are per call
        assigns = [n for n in walk_scope(scope) if isinstance(n, ast.Assign)]
        # names whose value derives from a bucketing helper's result
        bucketed: Set[str] = set()
        # names bound from an unbucketed upload (or derived from one by
        # a method chain / plain rebinding)
        raw: Set[str] = set()
        getter_fns: Set[str] = set()
        facts = [
            (
                {t.id for tgt in node.targets for t in ast.walk(tgt) if isinstance(t, ast.Name)},
                node.value, _calls_bucket(node.value), _names_in(node.value),
            )
            for node in assigns
        ]
        for _ in range(len(facts) + 1):  # bucketed names first, to a fixpoint
            grown = False
            for targets, _value, calls, names in facts:
                if (calls or names & bucketed) and not targets <= bucketed:
                    bucketed |= targets
                    grown = True
            if not grown:
                break
        for _ in range(3):
            for node, (targets, value, calls, names) in zip(assigns, facts):
                if calls or names & bucketed:
                    continue
                arg = _upload_arg(value)
                if arg is not None:
                    if not (_calls_bucket(arg) or _names_in(arg) & bucketed):
                        raw |= targets
                    continue
                base = value
                while (
                    isinstance(base, ast.Call)
                    and isinstance(base.func, ast.Attribute)
                    and base.func.attr in _CHAIN_METHODS
                ):
                    base = base.func.value
                if isinstance(base, ast.Name) and base.id in raw:
                    raw |= targets
                if isinstance(value, ast.Call):
                    callee = dotted_name(value.func) or ""
                    if _CACHE_GETTER_RE.match(callee.rsplit(".", 1)[-1]):
                        for tgt in node.targets:
                            first = tgt.elts[0] if isinstance(tgt, (ast.Tuple, ast.List)) and tgt.elts else tgt
                            if isinstance(first, ast.Name):
                                getter_fns.add(first.id)
        observes = any(
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "observe"
            and "tripwire" in (dotted_name(n.func.value) or "").rsplit(".", 1)[-1]
            for n in walk_scope(scope)
        )
        for node in walk_scope(scope):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func) or ""
            leaf = callee.rsplit(".", 1)[-1]
            observed = (
                leaf in self._guarded
                or leaf in getter_fns
                or (observes and is_dispatch_call(node, fns))
            )
            if not observed:
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                up = _upload_arg(arg)
                hit = None
                if up is not None and not (_calls_bucket(up) or _names_in(up) & bucketed):
                    hit = f"{dotted_name(arg.func) if isinstance(arg, ast.Call) else 'upload'}(host data)"
                elif isinstance(arg, ast.Name) and arg.id in raw:
                    hit = f"`{arg.id}` (an upload of host data)"
                if hit is not None:
                    ctx.report(
                        self.name, node,
                        f"observed callable `{callee}(...)` takes {hit} "
                        "whose leading size is a Python-varying length no "
                        "bucketing covers — every distinct input size is a "
                        "new shape signature (pad to _bucket/seg_bucket/"
                        "row_length_bucket/pad_packed_rows, or suppress "
                        "with the reason)",
                    )
                    break
