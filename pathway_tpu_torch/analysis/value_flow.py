"""value-flow: where the bytes go — write-after-snapshot, hidden host
transfers, redundant uploads (counterpart of
``pathway_tpu/analysis/value_flow.py``).

The port writes device state in place where the reference donates it
(``ops/donation_guard.py``): the IVF absorb's ``index_copy_`` /
``index_fill_`` into slabs and bias, the forward index's commit into its
row buckets, the slot pool's K/V writes.  So the reference's
use-after-donate becomes **write-after-snapshot** here.  The family runs
an interprocedural pass over the residency lattice (``residency.py``)
through assignments, helper calls and the dispatch conventions of
``registry.py``, and checks:

1. **write-after-snapshot** — a reference handed out as a snapshot
   (passed to ``donation_guard.stamp(...)``, or stored — ``self.x = t``
   / ``box[i] = t`` — from a tensor the same module passes to
   ``note_write``) is written in place afterwards in the same scope —
   ``t.copy_(...)``, ``t.index_copy_(...)``, ``t.index_fill_(...)``, any
   ``t.<op>_(...)``, ``t[...] = v``, or a call to a helper that writes
   its argument in place (directly, through ``retry_call`` or through a
   ``profile.wrap`` binding; resolved to a fixpoint in ``finalize``,
   seeded by ``residency.IN_PLACE_SITES``) — with no rebind or ``clone()`` in
   between.  The holder of the snapshot reads the new bytes.  This is
   the static twin of ``stamp`` / ``note_write``.
2. **hidden host transfer** — an IMPLICIT device→host sync the
   hidden-sync family cannot see: ``bool(dv)`` / branching on a device
   value (``if dv > 0:``), iterating one (``for x in dv:`` fetches per
   element), ``dv.tolist()``, plus — in modules hidden-sync does not
   cover — explicit fetches (``.item()`` / ``.cpu()`` / ``.numpy()`` /
   ``.to("cpu")``, ``np.asarray`` / ``float`` / ``int``) of a
   provably-device value, the call of a ``to_host`` waiter (``fetch()``,
   ``to_host(x)()``), and ``np.asarray`` of an unknown-residency
   PARAMETER inside a lock body (callers hand the encoder's device rows
   straight to ``add(keys, vectors)``; the sync then happens under the
   lock).  A scope that books the crossing with ``record_fetch`` is
   clean.
3. **redundant upload** — a host→device transfer (``.cuda()`` /
   ``.to(device)`` / ``torch.as_tensor(..., device=...)`` /
   ``upload(x, dev)``) of a loop-invariant value inside a serve-path
   loop: the same bytes ride the link once per iteration.  Hoist the
   upload or cache the device buffer; a deliberate per-target scatter is
   waived with a reviewed pragma mirrored in
   ``residency.DECLARED_TRANSFERS``.

A reviewed exception is waived at the site::

    host = out.cpu()  # pathway: allow(value-flow): <why the crossing is sound>
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Finding, ModuleContext, Rule
from .registry import (
    dotted_name,
    host_fetch_call,
    is_async_upload,
    is_device_producer_call,
    is_dispatch_call,
    method_sync,
    receiver_base,
    scope_dispatch_and_device_vars,
    scope_fetch_vars,
    snapshot_refs,
    transfer_call,
    walk_scope,
)
from . import residency

__all__ = ["ValueFlowRule"]

_EXPLICIT_COERCIONS = {
    "np.asarray", "np.array", "numpy.asarray", "numpy.array", "float", "int",
}
_PARAM_COERCIONS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
# methods returning a view of their receiver: an in-place op on the view
# writes the receiver's storage (`self._slabs.view(n, d).index_copy_(...)`)
_VIEW_METHODS = {
    "view", "reshape", "flatten", "view_as", "narrow", "select", "squeeze",
    "unsqueeze", "transpose", "permute", "t", "expand", "as_strided",
    "unflatten", "diagonal", "detach",
}
# in-place methods whose name does not end in "_"
_IN_PLACE_EXTRA = {"fill", "put"}
# wrapper spellings whose call runs their FUNCTION argument with the
# remaining args (retry_call("site", fn, *args)): written positions shift
# past the two leading args
_RETRY_LEAVES = {"retry_call"}
# wrapper BINDINGS that alias a callable: w = profile.wrap("site", fn) —
# calling w writes in place exactly like fn
_ALIAS_WRAP_LEAVES = {"wrap"}


def _pure_dotted(node: ast.AST) -> Optional[str]:
    """Dotted spelling of a Name/Attribute/Subscript chain containing no
    embedded calls (``self._slabs``, ``out[0]``), else None."""
    probe = node
    while True:
        if isinstance(probe, ast.Attribute):
            probe = probe.value
        elif isinstance(probe, ast.Subscript):
            probe = probe.value
        elif isinstance(probe, ast.Name):
            return dotted_name(node)
        else:
            return None


def _component_prefixed(name: str, prefix: str) -> bool:
    """``self._slabs`` covers ``self._slabs`` and ``self._slabs.shape``
    but NOT ``self._slabs_host`` — prefixing is per dotted component."""
    return name == prefix or name.startswith(prefix + ".")


def _write_target(call: ast.Call) -> Optional[str]:
    """The storage an in-place method call writes: ``t.copy_(x)`` → ``t``,
    ``self._slabs.view(n, d).index_copy_(...)`` → ``self._slabs``; None
    for other calls."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    attr = func.attr
    if not (
        (attr.endswith("_") and not attr.startswith("_")) or attr in _IN_PLACE_EXTRA
    ):
        return None
    base = func.value
    while True:
        if (
            isinstance(base, ast.Call)
            and isinstance(base.func, ast.Attribute)
            and base.func.attr in _VIEW_METHODS
        ):
            base = base.func.value
        elif isinstance(base, ast.Subscript):
            base = base.value
        else:
            break
    return _pure_dotted(base)


class _FunctionFacts:
    """Ordered event stream for one function scope: calls (with dotted
    arg spellings), snapshots, in-place writes and rebinds — everything
    the finalize-side replay needs, JSON-able for the cache."""

    def __init__(self, params: List[str]):
        self.params = params
        self.events: List[list] = []  # [line, col, kind, ...]
        self._names: Set[str] = set()

    def call(self, line: int, col: int, leaves: List[str], args: List[Optional[str]], method: bool) -> None:
        self.events.append([line, col, "call", leaves, args, method])
        self._names.update(a for a in args if a)

    def snap(self, line: int, col: int, name: str, how: str) -> None:
        self.events.append([line, col, "snap", name, how])
        self._names.add(name)

    def write(self, line: int, col: int, name: str, how: str) -> None:
        self.events.append([line, col, "write", name, how])
        self._names.add(name)

    def bind(self, line: int, col: int, name: str) -> None:
        self.events.append([line, col, "bind", name])

    def compact(self) -> dict:
        """Drop rebinds that can never interact with a snapshot or a
        written name."""
        cands = self._names

        def relevant(name: str) -> bool:
            return any(
                _component_prefixed(name, c) or _component_prefixed(c, name)
                for c in cands
            )

        events = [ev for ev in self.events if ev[2] != "bind" or relevant(ev[3])]
        return {"params": self.params, "events": events}


class _Extractor:
    """One pass over a module: reports the per-module findings (hidden
    host transfers, redundant uploads) and extracts the event streams
    for the whole-program write-after-snapshot pass."""

    def __init__(self, ctx: ModuleContext, rule_name: str):
        self.ctx = ctx
        self.rule_name = rule_name
        self.functions: Dict[str, dict] = {}
        self.written = self._note_write_names(ctx.tree)
        self.aliases = self._wrap_aliases(ctx.tree)
        self._visit_scope(ctx.tree, None, None, None)

    @staticmethod
    def _wrap_aliases(tree: ast.AST) -> Dict[str, str]:
        """``w = profile.wrap("site", fn)``: calling ``w`` calls ``fn`` with
        the same arguments, so ``w`` writes in place where ``fn`` does."""
        out: Dict[str, str] = {}
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
                continue
            callee = dotted_name(node.value.func) or ""
            if callee.rsplit(".", 1)[-1] not in _ALIAS_WRAP_LEAVES or len(node.value.args) < 2:
                continue
            target = dotted_name(node.value.args[1])
            if target is None:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out[tgt.id] = target.rsplit(".", 1)[-1]
        return out

    @staticmethod
    def _note_write_names(tree: ast.AST) -> Set[str]:
        """Every reference the module passes to ``note_write``: storage an
        in-place site writes, whose stored alias is a snapshot."""
        out: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                got = snapshot_refs(node)
                if got is not None and got[0] == "note_write":
                    for ref in got[1]:
                        name = _pure_dotted(ref)
                        if name is not None:
                            out.add(name)
        return out

    # -- scope walk (hidden-transfer + redundant-upload + events) ----------
    def _visit_scope(self, scope, cls, inherited_fns, inherited_vars) -> None:
        fns, device_vars = scope_dispatch_and_device_vars(
            scope, self.ctx.dispatch_names, inherited_fns, inherited_vars
        )
        device_vars = set(device_vars) | self._producer_vars(scope)
        if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            local = f"{cls}.{scope.name}" if cls else scope.name
            if scope.name not in self.ctx.dispatch_names:
                self._check_transfers(scope, fns, device_vars)
                self._check_uploads(scope)
            if local not in self.functions:
                self.functions[local] = self._extract_events(scope)
        for child in ast.iter_child_nodes(scope):
            self._recurse(child, cls, fns, device_vars)

    def _recurse(self, node, cls, fns, dvars) -> None:
        if isinstance(node, ast.ClassDef):
            for child in ast.iter_child_nodes(node):
                self._recurse(child, node.name, fns, dvars)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._visit_scope(node, cls, fns, dvars)
            return
        if isinstance(node, ast.Lambda):
            return
        for child in ast.iter_child_nodes(node):
            self._recurse(child, cls, fns, dvars)

    def _producer_vars(self, scope) -> Set[str]:
        """Names assigned from a device-producer call (the encoder
        ``.encode`` convention)."""
        out: Set[str] = set()
        for node in walk_scope(scope):
            if not isinstance(node, ast.Assign):
                continue
            if isinstance(node.value, ast.Call) and is_device_producer_call(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out.add(tgt.id)
        return out

    # -- rule 2: hidden host transfer --------------------------------------
    def _residency_of(self, node, fns, device_vars) -> int:
        if isinstance(node, ast.Call):
            if (
                is_dispatch_call(node, fns)
                or is_device_producer_call(node)
                or transfer_call(node) is not None
                or is_async_upload(node)
            ):
                return residency.DEVICE
            return residency.HOST
        name = _pure_dotted(node)
        if name is not None and name in device_vars:
            return residency.DEVICE
        return residency.HOST

    def _is_device_expr(self, node, fns, device_vars) -> bool:
        return self._residency_of(node, fns, device_vars) >= residency.DEVICE

    def _test_device_name(self, test, device_vars) -> Optional[str]:
        """A device value used as a DIRECT operand of a branch/loop/
        assert test (``if dv:``, ``if dv > 0:``, ``while not dv:``) —
        the bool() of the comparison result syncs.  Metadata reads
        (``len(dv)``, ``dv.shape[0]``) are free and stay quiet."""

        def direct(node) -> Optional[str]:
            if isinstance(node, (ast.Name, ast.Attribute, ast.Subscript)):
                name = _pure_dotted(node)
                if name is not None and name in device_vars:
                    return name
                return None
            if isinstance(node, ast.Compare):
                # `is` / `is not` are pure reference checks
                if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                    return None
                for operand in [node.left] + list(node.comparators):
                    got = direct(operand)
                    if got is not None:
                        return got
                return None
            if isinstance(node, ast.BoolOp):
                for operand in node.values:
                    got = direct(operand)
                    if got is not None:
                        return got
                return None
            if isinstance(node, ast.UnaryOp):
                return direct(node.operand)
            return None

        return direct(test)

    def _check_transfers(self, scope, fns, device_vars) -> None:
        ctx = self.ctx
        has_record_fetch = False
        found: List[Tuple[ast.AST, str]] = []
        params = {
            a.arg
            for a in list(scope.args.args) + list(scope.args.kwonlyargs)
            if a.arg not in ("self", "cls")
        }
        lock_depth_nodes = self._lock_bodies(scope)
        fetch_vars = scope_fetch_vars(scope)
        for node in walk_scope(scope):
            if isinstance(node, ast.Call):
                callee = dotted_name(node.func)
                leaf = callee.rsplit(".", 1)[-1] if callee else ""
                msync = method_sync(node)
                base = receiver_base(node)
                if leaf == "record_fetch":
                    has_record_fetch = True
                elif msync == "tolist" and base is not None and base in device_vars:
                    found.append(
                        (
                            node,
                            f"`{base}.tolist()` forces an element-wise "
                            "device→host transfer of the whole tensor",
                        )
                    )
                elif leaf == "bool" and node.args and self._is_device_expr(
                    node.args[0], fns, device_vars
                ):
                    found.append(
                        (
                            node,
                            "`bool()` of a device value blocks on the "
                            "transfer just to branch",
                        )
                    )
                elif (
                    not ctx.serve_path
                    and callee in _EXPLICIT_COERCIONS
                    and node.args
                    and self._is_device_expr(node.args[0], fns, device_vars)
                ):
                    found.append(
                        (
                            node,
                            f"`{callee}` of a device value — an unbooked "
                            "device→host sync",
                        )
                    )
                elif not ctx.serve_path and host_fetch_call(node, fetch_vars) is not None:
                    found.append(
                        (
                            node,
                            f"`{host_fetch_call(node, fetch_vars)}` waits for "
                            "a to_host copy — an unbooked device→host sync",
                        )
                    )
                elif (
                    not ctx.serve_path
                    and msync is not None
                    and base is not None
                    and base in device_vars
                ):
                    found.append(
                        (
                            node,
                            f"`{base}.{msync}()` — an unbooked device→host "
                            "sync",
                        )
                    )
                elif (
                    callee in _PARAM_COERCIONS
                    and node.args
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id in params
                    and node in lock_depth_nodes
                ):
                    found.append(
                        (
                            node,
                            f"`{callee}({node.args[0].id})` coerces a "
                            "caller-provided value inside a lock body — "
                            "callers hand device tensors here (the encoder "
                            "convention), making this a device→host sync "
                            "under the lock; coerce BEFORE acquiring it",
                        )
                    )
            elif isinstance(node, ast.For):
                name = _pure_dotted(node.iter)
                if name is not None and name in device_vars:
                    found.append(
                        (
                            node,
                            f"iterating device value `{name}` fetches one "
                            "element per step — a transfer per iteration",
                        )
                    )
            elif isinstance(node, (ast.If, ast.While, ast.Assert)):
                name = self._test_device_name(node.test, device_vars)
                if name is not None:
                    found.append(
                        (
                            node,
                            f"branching on device value `{name}` forces an "
                            "implicit bool() sync",
                        )
                    )
        if has_record_fetch:
            return  # the scope books its crossing: not hidden
        for node, what in found:
            self.ctx.report(
                self.rule_name, node,
                f"hidden host transfer: {what} outside a record_fetch "
                "scope — book the crossing (record_fetch) or move it off "
                "the hot path",
            )

    def _lock_bodies(self, scope) -> Set[ast.AST]:
        """Every node lexically inside a ``with <lock>:`` body of this
        scope (nested defs excluded, same as every other rule)."""
        from .registry import is_lock_context

        out: Set[ast.AST] = set()
        for node in walk_scope(scope):
            if isinstance(node, ast.With) and is_lock_context(node):
                for inner in walk_scope(node):
                    out.add(inner)
        return out

    # -- rule 3: redundant upload ------------------------------------------
    @staticmethod
    def _uploaded(call: ast.Call) -> Optional[Tuple[str, ast.AST]]:
        """(spelling, uploaded operand) of a transfer call, or None."""
        if is_async_upload(call):
            return (dotted_name(call.func), call.args[0]) if call.args else None
        spelled = transfer_call(call)
        if spelled is None:
            return None
        if isinstance(call.func, ast.Attribute) and call.func.attr in ("cuda", "to"):
            return spelled, call.func.value
        return (spelled, call.args[0]) if call.args else None

    def _check_uploads(self, scope) -> None:
        if not self.ctx.serve_path:
            return
        reported: Set[int] = set()  # one finding per call site: nested
        # loops each walk the inner call, but it is ONE upload
        for node in walk_scope(scope):
            if not isinstance(node, (ast.For, ast.While)):
                continue
            assigned = self._loop_assigned(node)
            for inner in walk_scope(node):
                if not isinstance(inner, ast.Call) or id(inner) in reported:
                    continue
                got = self._uploaded(inner)
                if got is None:
                    continue
                spelled, operand = got
                name = _pure_dotted(operand)
                if name is None:
                    continue
                root = name.split(".", 1)[0]
                if name in assigned or root in assigned:
                    continue  # varies per iteration: a real per-item upload
                if any(
                    isinstance(sub, ast.Subscript)
                    and any(
                        isinstance(n, ast.Name) and n.id in assigned
                        for n in ast.walk(sub.slice)
                    )
                    for sub in ast.walk(operand)
                ):
                    continue  # a per-iteration slice of it: new bytes each time
                reported.add(id(inner))
                self.ctx.report(
                    self.rule_name, inner,
                    f"redundant upload: `{spelled}` of `{name}` inside a "
                    "serve-path loop re-transfers a loop-invariant value "
                    "every iteration — hoist the upload (or cache the "
                    "device buffer); a deliberate per-target scatter needs "
                    "a reviewed pragma mirrored in "
                    "residency.DECLARED_TRANSFERS",
                )

    def _loop_assigned(self, loop) -> Set[str]:
        """Names that may vary per iteration: anything (re)bound inside
        the loop, the loop target(s), and the RECEIVER of any method
        call (``rows.append(item)`` mutates ``rows`` in place)."""
        out: Set[str] = set()

        def add_target(tgt) -> None:
            if isinstance(tgt, (ast.Tuple, ast.List)):
                for elt in tgt.elts:
                    add_target(elt)
                return
            name = _pure_dotted(tgt)
            if name is not None:
                out.add(name)
                out.add(name.split(".", 1)[0])

        if isinstance(loop, ast.For):
            add_target(loop.target)
        for node in walk_scope(loop):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    add_target(tgt)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                add_target(node.target)
            elif isinstance(node, ast.For):
                add_target(node.target)
            elif isinstance(node, ast.withitem) and node.optional_vars:
                add_target(node.optional_vars)
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                # a method receiver may have been mutated in place (a
                # transfer's own receiver excluded: `.to(dev)` reads it)
                if node.func.attr not in ("to", "cuda"):
                    add_target(node.func.value)
        return out

    # -- rule 1 facts: ordered event extraction ----------------------------
    def _extract_events(self, scope) -> dict:
        params = [a.arg for a in scope.args.args]
        facts = _FunctionFacts(params)
        written = self.written

        def emit_expr(node) -> None:
            if node is None or isinstance(node, ast.Lambda):
                return
            if isinstance(node, ast.Call):
                emit_call(node)
                return
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    emit_expr(child)

        def emit_call(node: ast.Call) -> None:
            callee = dotted_name(node.func)
            leaf = callee.rsplit(".", 1)[-1] if callee else ""
            args = list(node.args)
            method = isinstance(node.func, ast.Attribute)
            # the receiver chain and the arguments evaluate first
            if isinstance(node.func, ast.Attribute):
                emit_expr(node.func.value)
            for arg in args:
                if _pure_dotted(arg) is None:
                    emit_expr(arg)
            for kw in node.keywords:
                emit_expr(kw.value)
            got = snapshot_refs(node)
            if got is not None and got[0] == "stamp":
                for ref in got[1]:
                    name = _pure_dotted(ref)
                    if name is not None:
                        facts.snap(node.lineno, node.col_offset, name, "stamp")
                return
            target = _write_target(node)
            if target is not None:
                facts.write(node.lineno, node.col_offset, target, f".{node.func.attr}()")
            if leaf in _RETRY_LEAVES and len(args) >= 2:
                fn_name = dotted_name(args[1])
                leaf = fn_name.rsplit(".", 1)[-1] if fn_name else ""
                method = False
                args = args[2:]
            facts.call(
                node.lineno, node.col_offset, [self.aliases.get(leaf, leaf)] if leaf else [],
                [_pure_dotted(a) for a in args], method,
            )

        def emit_store(tgt, value) -> None:
            """``x = v`` / ``self.x = v`` / ``box[i] = v``: a subscript
            store writes ``box`` in place; storing a ``note_write``d
            reference hands it out as a snapshot."""
            if isinstance(tgt, (ast.Tuple, ast.List)):
                for elt in tgt.elts:
                    emit_store(elt, None)
                return
            src = _pure_dotted(value) if value is not None else None
            if isinstance(tgt, ast.Subscript):
                emit_expr(tgt.slice)
                name = _pure_dotted(tgt.value)
                if name is not None:
                    facts.write(tgt.lineno, tgt.col_offset, name, "[...] =")
                if src is not None and src in written:
                    facts.snap(tgt.lineno, tgt.col_offset, src, "stored")
                return
            name = _pure_dotted(tgt)
            if name is None:
                return
            facts.bind(tgt.lineno, tgt.col_offset, name)
            if src is not None and src in written and isinstance(tgt, ast.Attribute):
                facts.snap(tgt.lineno, tgt.col_offset, src, "stored")

        def emit_stmt(stmt) -> None:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                return
            if isinstance(stmt, ast.Assign):
                emit_expr(stmt.value)
                for tgt in stmt.targets:
                    emit_store(tgt, stmt.value)
                return
            if isinstance(stmt, ast.AugAssign):
                emit_expr(stmt.value)
                name = _pure_dotted(stmt.target)
                if name is not None:
                    tgt = stmt.target.value if isinstance(stmt.target, ast.Subscript) else stmt.target
                    base = _pure_dotted(tgt)
                    if base is not None:
                        facts.write(stmt.lineno, stmt.col_offset, base, "+=")
                return
            if isinstance(stmt, ast.AnnAssign):
                emit_expr(stmt.value)
                emit_store(stmt.target, stmt.value)
                return
            if isinstance(stmt, ast.For):
                emit_expr(stmt.iter)
                emit_store(stmt.target, None)
                for s in stmt.body + stmt.orelse:
                    emit_stmt(s)
                return
            if isinstance(stmt, ast.Delete):
                for tgt in stmt.targets:
                    name = _pure_dotted(tgt)
                    if name is not None and not isinstance(tgt, ast.Subscript):
                        facts.bind(tgt.lineno, tgt.col_offset, name)
                return
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    emit_expr(child)
                elif isinstance(child, ast.stmt):
                    emit_stmt(child)
                elif isinstance(child, ast.withitem):
                    emit_expr(child.context_expr)
                    if child.optional_vars is not None:
                        emit_store(child.optional_vars, None)
                elif isinstance(child, ast.ExceptHandler):
                    for s in child.body:
                        emit_stmt(s)

        for stmt in scope.body:
            emit_stmt(stmt)
        return facts.compact()

    def summary(self) -> dict:
        return {"functions": self.functions}


class _SnapshotProgram:
    """The whole-program write-after-snapshot pass: find every helper that
    writes a parameter in place (directly or by forwarding it to another
    such helper), to a fixpoint seeded by ``residency.IN_PLACE_SITES``,
    then replay each function's event stream."""

    def __init__(self, summaries: Dict[str, dict]):
        self.summaries = summaries
        # leaf -> (written positions, has_self)
        self.writers: Dict[str, Tuple[Tuple[int, ...], bool]] = {
            leaf: (tuple(pos), False)
            for leaf, pos in residency.IN_PLACE_SITES.items()
        }
        self._fixpoint()

    def _written_args(
        self, leaves: Sequence[str], args: Sequence[Optional[str]], method: bool
    ) -> Tuple[Optional[str], List[Optional[str]]]:
        for leaf in leaves:
            entry = self.writers.get(leaf)
            if entry is None:
                continue
            positions, has_self = entry
            offset = 1 if (has_self and method) else 0
            out: List[Optional[str]] = []
            for p in positions:
                i = p - offset
                out.append(args[i] if 0 <= i < len(args) else None)
            return leaf, out
        return None, []

    def _fixpoint(self) -> None:
        for _ in range(20):
            changed = False
            for path in sorted(self.summaries):
                funcs = self.summaries[path].get("functions", {})
                for local in sorted(funcs):
                    rec = funcs[local]
                    params = rec["params"]
                    leaf = local.rsplit(".", 1)[-1]
                    if leaf in self.writers:
                        continue
                    rebound: Set[str] = set()
                    found: Set[int] = set()
                    for ev in rec["events"]:
                        if ev[2] == "bind":
                            rebound.add(ev[3])
                            continue
                        names: List[Optional[str]] = []
                        if ev[2] == "write":
                            names = [ev[3]]
                        elif ev[2] == "call":
                            names = self._written_args(ev[3], ev[4], ev[5])[1]
                        for name in names:
                            if name in params and name not in rebound and name not in ("self", "cls"):
                                found.add(params.index(name))
                    if found:
                        has_self = bool(params) and params[0] in ("self", "cls")
                        self.writers[leaf] = (tuple(sorted(found)), has_self)
                        changed = True
            if not changed:
                return

    def findings(self) -> List[Finding]:
        out: List[Finding] = []
        for path in sorted(self.summaries):
            funcs = self.summaries[path].get("functions", {})
            for local in sorted(funcs):
                out.extend(self._replay(path, funcs[local]))
        return out

    def _replay(self, path: str, rec: dict) -> List[Finding]:
        snaps: Dict[str, Tuple[str, int]] = {}
        out: List[Finding] = []

        def hit(name: str) -> Optional[Tuple[str, Tuple[str, int]]]:
            for p, origin in snaps.items():
                if _component_prefixed(name, p) or _component_prefixed(p, name):
                    return p, origin
            return None

        def report(line, col, name, how, p, origin) -> None:
            kind, oline = origin
            out.append(
                Finding(
                    path, line, col, "value-flow",
                    f"write-after-snapshot: `{name}` written in place "
                    f"({how}) after `{p}` was handed out as a snapshot "
                    f"({kind}) at line {oline} — the holder of the snapshot "
                    "reads the new bytes; write a clone(), or rebind the "
                    "name before writing",
                )
            )
            del snaps[p]  # report each snapshot once

        for ev in rec["events"]:
            line, col, kind = ev[0], ev[1], ev[2]
            if kind == "snap":
                snaps[ev[3]] = (ev[4], line)
            elif kind == "write":
                got = hit(ev[3])
                if got is not None:
                    report(line, col, ev[3], ev[4], *got)
            elif kind == "call":
                callee, names = self._written_args(ev[3], ev[4], ev[5])
                for name in names:
                    if name is None:
                        continue
                    got = hit(name)
                    if got is not None:
                        report(line, col, name, f"through `{callee}(...)`", *got)
            elif kind == "bind":
                for p in [p for p in snaps if _component_prefixed(p, ev[3])]:
                    del snaps[p]
        return out


class ValueFlowRule(Rule):
    name = "value-flow"
    salt_sources = ("value_flow.py", "residency.py")
    description = (
        "device value-flow over the residency lattice: write-after-snapshot "
        "(static twin of ops/donation_guard.py), hidden host transfers "
        "(implicit device→host syncs), redundant loop-invariant uploads"
    )

    def __init__(self) -> None:
        self._summaries: Dict[str, dict] = {}

    def run(self, ctx: ModuleContext) -> None:
        extractor = _Extractor(ctx, self.name)
        self._summaries[ctx.display_path] = extractor.summary()

    def dump_summary(self, display_path: str) -> Optional[dict]:
        return self._summaries.get(display_path)

    def load_summary(self, display_path: str, summary: dict) -> None:
        self._summaries[display_path] = summary

    def finalize(self) -> List[Finding]:
        return _SnapshotProgram(self._summaries).findings()
