"""lock-order: whole-program lock-acquisition hierarchy + deadlock cycles
(counterpart of ``pathway_tpu/analysis/lock_order.py``).

``lock_discipline`` polices what happens *inside* one lock body; this
family polices the ORDER locks are taken in across the whole port — the
dimension where deadlocks live.  The port's thread fabric (scheduler,
decode slot pool, cache tiers, IVF + forward indexes, shard group,
exchange plane, observe stack) holds the reference's 74 lock sites with
no cross-module guarantee.  This pass makes the guarantee:

1. **Site discovery** — every attribute-rooted ``threading.Lock`` /
   ``RLock`` / ``Condition`` creation (``self._lock``, ``self._pool_lock``,
   ``_registry_lock``, ``self._send_locks[peer]``) gets a stable
   ``module.Class.attr`` identity.  Module names drop the package prefix
   (``pathway_tpu_torch/serve/scheduler.py`` → ``serve.scheduler``), so a
   port site and its reference twin have the same name and rank.
   ``Condition(self._qlock)`` records an ALIAS: acquiring the condition
   is acquiring the wrapped lock.
2. **Nested-acquisition graph** — walking ``with <lock>:`` bodies, plus
   interprocedural edges through the same call-resolution conventions the
   other rules use (``registry.py``): ``self.helper()``, same-module
   functions, imported-module functions, ``retry_call("site", fn, ...)``
   wrappers, and program-unique method names all carry a held lock into
   their callee's acquisitions.
3. **Checks** against the declared hierarchy (``lock_ranks.py``:
   ``observe < cache < model < index < shard < scheduler < pool``,
   acquired in DESCENDING rank order):

   - **rank inversion** — a higher-rank lock acquired while holding a
     lower-rank one;
   - **deadlock cycle** — ANY cycle in the observed graph (rank-waived
     or not), reported with the full witness path;
   - **self-deadlock** — a non-reentrant ``Lock`` re-acquired while
     already held (lexically or through a helper);
   - **Condition.wait holding a second lock** — the wait releases only
     the condition's own lock; every other held lock blocks its owner
     for the whole wait;
   - **lock acquire inside a traced scope** — a ``with <lock>:`` in a
     ``torch.compile`` / ``torch.jit.script`` body or inside a
     ``with torch.cuda.graph(...):`` capture runs at trace or capture
     time only, never per call or per replay: always a bug.

The runtime twin (``analysis/sanitizer.py``, ``PATHWAY_LOCK_SANITIZER=1``)
enforces the SAME hierarchy on live acquisition interleavings — the
dynamic oracle that confirms or refutes every static edge.

A reviewed exception is waived at the acquisition site::

    with self._lock:  # pathway: allow(lock-order): <rank exception + why safe>
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Finding, ModuleContext, Rule
from .lock_ranks import rank_name, rank_of_path, rank_of_receiver, table
from .registry import collect_traced_names, dotted_name, is_trace_context

__all__ = ["LockOrderRule", "module_dotted", "module_lock_sites", "static_graph"]

_PKG = "pathway_tpu_torch"

_LOCK_CTORS = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "condition",
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
}
# same terminal-identifier heuristic as registry.is_lock_context, applied
# per name so both passes agree on what spells a lock
_LOCK_NAME_RE = re.compile(r"lock|mutex|cv\b|cond", re.IGNORECASE)
_WAIT_ATTRS = ("wait", "wait_for")
# generic container/stdlib method names never resolved through the
# program-unique-method fallback (a repo class happening to define one
# must not vacuum every `x.append()` call into its lock footprint)
_GENERIC_METHODS = frozenset(
    {
        "append", "add", "get", "put", "pop", "popleft", "update", "remove",
        "clear", "close", "stop", "start", "join", "wait", "notify",
        "notify_all", "acquire", "release", "items", "keys", "values",
        "set", "is_set", "result", "submit", "send", "recv", "read",
        "write", "encode", "decode", "copy", "extend", "sort", "index",
        "count", "flush", "open", "reset", "render", "sample", "search",
        "build", "advance", "serve", "run", "next_id", "save", "load",
    }
)
_MAX_WITNESS = 6  # interprocedural witness-chain depth cap
# a stored serve completion handle (`self._handle()` in the scheduler's
# batch future): its call runs whichever completion the submit returned
_HANDLE_ATTRS = ("_handle", "handle")


def module_dotted(display_path: str) -> str:
    """Stable dotted module id from a repo-relative display path:
    ``pathway_tpu_torch/serve/scheduler.py`` → ``serve.scheduler`` (the
    reference's id for its twin); ``fixtures/mod.py`` → ``fixtures.mod``."""
    path = display_path.replace("\\", "/").replace(os.sep, "/")
    if path.endswith(".py"):
        path = path[: -len(".py")]
    parts = [p for p in path.split("/") if p and p != "."]
    if _PKG in parts:
        # relative or absolute: the id starts below the package root
        parts = parts[len(parts) - parts[::-1].index(_PKG):] or [_PKG]
    return ".".join(parts)


class _Extractor(ast.NodeVisitor):
    """One pass over a module: lock sites, aliases, per-function
    acquisition facts, and the module-local findings (cond-wait-second-
    lock, lock in a traced scope)."""

    def __init__(self, ctx: ModuleContext, rule_name: str):
        self.ctx = ctx
        self.rule_name = rule_name
        self.mod = module_dotted(ctx.display_path)
        self.sites: Dict[str, dict] = {}
        self.aliases: Dict[str, str] = {}
        self.classes: Dict[str, List[str]] = {}
        self.functions: Dict[str, dict] = {}
        self.imports: Dict[str, str] = {}
        self.externals: Set[str] = set()
        self.traced = collect_traced_names(ctx.tree)
        # name -> refs the wrapped callable makes: `step = profile.wrap("site", fn)`
        self.wrapped: Dict[str, List[List[str]]] = {}
        # outer function -> functions defined inside it (the closures a
        # wrapper returns)
        self.nested: Dict[str, List[str]] = {}
        # class -> {attr: __init__ parameter position} for `self.attr = param`
        self.stored: Dict[str, Dict[str, int]] = {}
        self._collect_imports(ctx.tree)
        self._collect_wrapped(ctx.tree)
        self._collect_stored(ctx.tree)
        self._collect_sites(ctx.tree)
        self._walk_functions(ctx.tree)

    # -- imports: local alias -> dotted module (for alias.func() edges) --
    def _collect_imports(self, tree: ast.Module) -> None:
        pkg_parts = self.mod.split(".")[:-1]
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for n in node.names:
                    name = n.name
                    if name == _PKG or name.startswith(_PKG + "."):
                        target = name[len(_PKG + "."):] or _PKG
                        self.imports[n.asname or name.split(".")[-1]] = target
                    else:
                        # torch, numpy, os ...: `torch.gather(...)` is never
                        # a method of one of the package's classes
                        self.externals.add(n.asname or name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                base: Optional[List[str]]
                if node.level == 0:
                    raw = node.module or ""
                    if raw == _PKG:
                        base = []
                    elif raw.startswith(_PKG + "."):
                        base = raw[len(_PKG + "."):].split(".")
                    else:
                        base = None
                else:
                    up = node.level - 1
                    if up > len(pkg_parts):
                        base = None
                    else:
                        base = list(
                            pkg_parts[: len(pkg_parts) - up]
                        )
                        if node.module:
                            base.extend(node.module.split("."))
                if base is None:
                    continue
                for n in node.names:
                    target = ".".join(base + [n.name]) if n.name != "*" else None
                    if target:
                        self.imports[n.asname or n.name] = target

    # -- callables stored by a constructor: `self._release = release` ----
    def _collect_stored(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for item in node.body:
                if not (isinstance(item, ast.FunctionDef) and item.name == "__init__"):
                    continue
                params = [a.arg for a in item.args.args[1:]]
                for sub in ast.walk(item):
                    if (
                        isinstance(sub, ast.Assign)
                        and isinstance(sub.value, ast.Name)
                        and sub.value.id in params
                    ):
                        for tgt in sub.targets:
                            if isinstance(tgt, ast.Attribute) and dotted_name(tgt.value) == "self":
                                self.stored.setdefault(node.name, {})[tgt.attr] = params.index(sub.value.id)

    # -- profile.wrap bindings: calling one runs the wrapper's closure ----
    def _collect_wrapped(self, tree: ast.Module) -> None:
        for _ in range(2):
            for node in ast.walk(tree):
                if not isinstance(node, ast.Assign):
                    continue
                value = node.value
                refs: Optional[List[List[str]]] = None
                if isinstance(value, ast.Call) and (
                    dotted_name(value.func) or ""
                ).endswith("profile.wrap"):
                    refs = []
                    fn = value.args[1] if len(value.args) >= 2 else None
                    if isinstance(fn, ast.Lambda):
                        # `lambda fes, *a: fes._ivf_step(*a)`: the calls it makes
                        for sub in ast.walk(fn.body):
                            if isinstance(sub, ast.Call):
                                if isinstance(sub.func, ast.Attribute):
                                    refs.append(["meth", sub.func.attr])
                                elif isinstance(sub.func, ast.Name):
                                    refs.append(["bare", sub.func.id])
                    elif fn is not None and dotted_name(fn) is not None:
                        name = dotted_name(fn)
                        refs.append(["bare", name] if "." not in name else ["meth", name.rsplit(".", 1)[-1]])
                elif isinstance(value, ast.IfExp):
                    picks = [dotted_name(value.body), dotted_name(value.orelse)]
                    if any(p in self.wrapped for p in picks if p):
                        refs = [r for p in picks if p for r in self.wrapped.get(p, [])]
                if refs is None:
                    continue
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.wrapped[tgt.id] = refs

    # -- site discovery ---------------------------------------------------
    def _collect_sites(self, tree: ast.Module) -> None:
        # walk with class context so `self._lock = threading.Lock()`
        # inside `def __init__` lands on the enclosing class
        def visit(node: ast.AST, cls: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    self.classes.setdefault(
                        child.name,
                        [
                            b for b in (
                                dotted_name(base) for base in child.bases
                            )
                            if b
                        ],
                    )
                    visit(child, child.name)
                    continue
                if isinstance(child, ast.Assign):
                    self._maybe_site(child, cls)
                visit(child, cls)

        visit(tree, None)

    def _maybe_site(self, node: ast.Assign, cls: Optional[str]) -> None:
        value = node.value
        if not isinstance(value, ast.Call):
            return
        ctor = dotted_name(value.func)
        kind = _LOCK_CTORS.get(ctor or "")
        if kind is None:
            return
        for tgt in node.targets:
            sid = self._site_id_for_target(tgt, cls)
            if sid is None:
                continue
            self.sites.setdefault(
                sid, {"kind": kind, "line": node.lineno}
            )
            if kind == "condition" and value.args:
                # Condition(self._qlock): acquiring the condition IS
                # acquiring the wrapped lock — record the alias
                wrapped = self._resolve_lock_name(
                    dotted_name(value.args[0]), cls, None
                )
                if wrapped is not None and wrapped != sid:
                    self.aliases[sid] = wrapped

    def _site_id_for_target(
        self, tgt: ast.AST, cls: Optional[str]
    ) -> Optional[str]:
        while isinstance(tgt, ast.Subscript):  # self._send_locks[peer]
            tgt = tgt.value
        if isinstance(tgt, ast.Attribute):
            base = dotted_name(tgt.value)
            if base == "self" and cls:
                return f"{self.mod}.{cls}.{tgt.attr}"
            return None
        if isinstance(tgt, ast.Name):
            if cls is None:
                return f"{self.mod}.{tgt.id}"
            return f"{self.mod}.{cls}.{tgt.id}"
        return None

    # -- per-function facts ----------------------------------------------
    def _walk_functions(self, tree: ast.Module) -> None:
        def visit(node: ast.AST, cls: Optional[str], fn: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, child.name, None)
                elif isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    if fn is None:
                        local = f"{cls}.{child.name}" if cls else child.name
                    else:
                        # a closure: named under the function defining it,
                        # so two methods' `launch` closures stay apart
                        local = f"{fn}.{child.name}"
                        self.nested.setdefault(fn, []).append(local)
                    self._extract_function(child, cls, local, nested=fn is not None)
                    # nested defs inside it are found by _extract_function's
                    # own recursion guard walking here too:
                    visit(child, cls, local)
                else:
                    visit(child, cls, fn)

        visit(tree, None, None)
        # module top level executes at import: treat as one function
        self._extract_function(tree, None, "<module>", top_level=True)

    def _extract_function(
        self,
        scope: ast.AST,
        cls: Optional[str],
        local: str,
        top_level: bool = False,
        nested: bool = False,
    ) -> None:
        if local in self.functions and not top_level:
            # a name collision (overload by branch) keeps the first body
            return
        rec = {"direct": [], "edges": [], "calls": [], "waits": []}
        if nested:
            rec["cls"] = cls
        traced = (
            not top_level
            and isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef))
            and scope.name in self.traced
        )

        def walk(
            node: ast.AST, stack: List[Tuple[str, int]], in_trace: bool
        ) -> None:
            if isinstance(
                node,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                 ast.ClassDef),
            ):
                return  # separate execution scope
            if isinstance(node, ast.With):
                inner_stack = stack
                body_trace = in_trace or is_trace_context(node)
                for item in node.items:
                    # the item's context expression evaluates BEFORE its
                    # lock is held (but under any earlier items/locks)
                    for sub in ast.iter_child_nodes(item):
                        walk(sub, inner_stack, in_trace)
                    sid = self._resolve_lock_name(
                        dotted_name(item.context_expr), cls, local
                    )
                    if sid is None:
                        continue
                    self._record_acquire(
                        rec, sid, node.lineno, inner_stack, in_trace, node
                    )
                    inner_stack = inner_stack + [(sid, node.lineno)]
                for stmt in node.body:
                    walk(stmt, inner_stack, body_trace)
                return
            if isinstance(node, ast.Call):
                self._record_call(rec, node, cls, local, stack)
            for child in ast.iter_child_nodes(node):
                walk(child, stack, in_trace)

        for child in ast.iter_child_nodes(scope):
            walk(child, [], traced)
        if any(rec.get(k) for k in ("direct", "edges", "calls", "waits", "ctors")):
            self.functions[local] = rec

    def _record_acquire(
        self,
        rec: dict,
        sid: str,
        line: int,
        stack: Sequence[Tuple[str, int]],
        in_trace: bool,
        node: ast.AST,
    ) -> None:
        rec["direct"].append([sid, line])
        for held, _hline in stack:
            rec["edges"].append([held, sid, line])
        if in_trace:
            self.ctx.report(
                self.rule_name, node,
                f"lock `{sid}` acquired inside a traced scope — a "
                "`with <lock>:` in a torch.compile / torch.jit.script "
                "body or a CUDA-graph capture runs at TRACE or CAPTURE "
                "time only, never per call or replay; locking belongs in "
                "the host-side caller",
            )

    def _record_call(
        self,
        rec: dict,
        call: ast.Call,
        cls: Optional[str],
        local: str,
        stack: Sequence[Tuple[str, int]],
    ) -> None:
        held = [s for s, _l in stack]
        func = call.func
        refs = self._plain_refs(call)
        leaf = None
        if isinstance(func, ast.Name):
            leaf = func.id
            # a constructor of the package's classes: callables passed to
            # it flow into the attributes its __init__ stores them in
            target = (
                f"{self.mod}.{func.id}" if func.id in self.classes else self.imports.get(func.id)
            )
            if target is not None:
                for i, arg in enumerate(call.args):
                    arg_refs = self._callable_refs(arg)
                    if arg_refs:
                        rec.setdefault("ctors", []).append([target, i, arg_refs])
        elif isinstance(func, ast.Attribute):
            leaf = func.attr
            recv = dotted_name(func.value)
            # explicit acquire()/wait() on a lock-spelled receiver
            if recv is not None:
                rsid = self._resolve_lock_name(recv, cls, local)
                if rsid is not None and func.attr == "acquire":
                    rec["direct"].append([rsid, call.lineno])
                    for h, _hl in stack:
                        rec["edges"].append([h, rsid, call.lineno])
                if rsid is not None and func.attr in _WAIT_ATTRS:
                    others = sorted(
                        {
                            self._canon_local(s)
                            for s in held
                        }
                        - {self._canon_local(rsid)}
                    )
                    if others:
                        self.ctx.report(
                            self.rule_name, call,
                            f"`{recv}.{func.attr}()` while holding "
                            f"{', '.join('`%s`' % o for o in others)} — "
                            "Condition.wait releases only its OWN lock; "
                            "every other held lock stays held for the "
                            "whole wait, wedging its waiters (release "
                            "the second lock before waiting)",
                        )
                    rec["waits"].append(
                        [rsid, others, call.lineno]
                    )
        # retry_call("site", fn, ...) dispatches fn: the held locks reach
        # fn's acquisitions through the wrapper (the robust-retry lesson)
        if leaf == "retry_call":
            for arg in call.args:
                refs.extend(self._callable_refs(arg))
        if refs:
            rec["calls"].append([held, refs, call.lineno])

    def _plain_refs(self, call: ast.Call) -> List[List[str]]:
        """How the program resolves one call: a bare name (and, for a
        ``profile.wrap`` binding, the wrapper's closure and the wrapped
        callable), a method of ``self``, a function of an imported module,
        or a program-unique method name."""
        func = call.func
        refs: List[List[str]] = []
        if isinstance(func, ast.Name):
            refs.append(["bare", func.id])
            if func.id in self.wrapped:
                prof = self.imports.get("profile", "observe.profile")
                refs.append(["nested", prof, "wrap"])
                refs.extend(self.wrapped[func.id])
        elif isinstance(func, ast.Attribute):
            recv = dotted_name(func.value)
            if recv == "self":
                refs.append(["self", func.attr])
                if func.attr in _HANDLE_ATTRS and not call.args and not call.keywords:
                    refs.append(["handle"])
            elif recv is not None and recv in self.imports:
                refs.append(["mod", self.imports[recv], func.attr])
            elif recv is None or recv.split(".", 1)[0] not in self.externals:
                refs.append(["meth", func.attr])
        return refs

    def _callable_refs(self, arg: ast.AST) -> List[List[str]]:
        """What calling a callable argument runs: a lambda's calls, a bare
        function, or a bound method of ``self``."""
        if isinstance(arg, ast.Lambda):
            return [
                r for sub in ast.walk(arg.body) if isinstance(sub, ast.Call) for r in self._plain_refs(sub)
            ]
        name = dotted_name(arg)
        if name is None or isinstance(arg, ast.Call):
            return []
        parts = name.split(".")
        if parts[0] == "self" and len(parts) == 2:
            return [["self", parts[1]]]
        if len(parts) == 1:
            return [["bare", parts[0]]]
        return []

    def _canon_local(self, sid: str) -> str:
        seen = set()
        while sid in self.aliases and sid not in seen:
            seen.add(sid)
            sid = self.aliases[sid]
        return sid

    # -- lock-expression resolution --------------------------------------
    def _resolve_lock_name(
        self, name: Optional[str], cls: Optional[str], local: Optional[str]
    ) -> Optional[str]:
        if name is None:
            return None
        parts = name.split(".")
        leaf = parts[-1]
        if not _LOCK_NAME_RE.search(leaf):
            return None
        if parts[0] == "self" and len(parts) == 2 and cls:
            for k in self._mro(cls):
                sid = f"{self.mod}.{k}.{leaf}"
                if sid in self.sites:
                    return sid
            owners = [
                c for c in self.classes
                if f"{self.mod}.{c}.{leaf}" in self.sites
            ]
            if len(owners) == 1:
                return f"{self.mod}.{owners[0]}.{leaf}"
            # attribute on self with no in-module definition (assigned
            # externally or in a cross-module base): stable per-class id
            return f"{self.mod}.{cls}.{leaf}"
        if len(parts) == 1:
            sid = f"{self.mod}.{leaf}"
            if sid in self.sites:
                return sid
            if local is not None:
                fsid = f"{self.mod}.{local}.{leaf}"
                if fsid in self.sites:
                    return fsid
            # parameter / local spelled like a lock (fixture style):
            # identity is module-local
            return f"{self.mod}.<{leaf}>"
        if len(parts) == 2 and parts[0] in self.imports:
            # module-global lock through an import alias
            # (`_recorder._registry_lock`)
            return f"{self.imports[parts[0]]}.{leaf}"
        # non-self receiver (child._lock, plane._cv): the defining class
        # is unknown statically — module-local opaque identity, unranked,
        # still a node for cycle detection
        return f"{self.mod}.<{name}>"

    def _mro(self, cls: str) -> List[str]:
        out, queue, seen = [], [cls], set()
        while queue:
            c = queue.pop(0)
            if c in seen:
                continue
            seen.add(c)
            out.append(c)
            queue.extend(
                b.split(".")[-1] for b in self.classes.get(c, ())
            )
        return out

    def summary(self) -> dict:
        return {
            "mod": self.mod,
            "sites": self.sites,
            "aliases": self.aliases,
            "classes": self.classes,
            "functions": self.functions,
            "imports": self.imports,
            "nested": self.nested,
            "stored": self.stored,
        }


class LockOrderRule(Rule):
    name = "lock-order"
    salt_sources = ("lock_order.py", "lock_ranks.py")
    description = (
        "lock-acquisition hierarchy: rank inversions against the declared "
        f"table ({table()}), deadlock cycles with witness paths, "
        "Condition.wait holding a second lock, locks in traced scopes"
    )

    def __init__(self) -> None:
        self._summaries: Dict[str, dict] = {}

    # -- per-module side --------------------------------------------------
    def run(self, ctx: ModuleContext) -> None:
        extractor = _Extractor(ctx, self.name)
        self._summaries[ctx.display_path] = extractor.summary()

    def dump_summary(self, display_path: str) -> Optional[dict]:
        return self._summaries.get(display_path)

    def load_summary(self, display_path: str, summary: dict) -> None:
        self._summaries[display_path] = summary

    # -- whole-program side ----------------------------------------------
    def finalize(self) -> List[Finding]:
        prog = _Program(self._summaries)
        return prog.findings()


class _Program:
    """The global graph: merged sites/aliases, resolved call graph,
    transitive acquire sets, and the rank/cycle checks."""

    def __init__(self, summaries: Dict[str, dict]):
        self.summaries = summaries
        self.site_info: Dict[str, dict] = {}    # sid -> {kind, path}
        self.aliases: Dict[str, str] = {}
        self.funcs: Dict[str, dict] = {}        # gfid -> record
        self.func_path: Dict[str, str] = {}     # gfid -> display path
        self.func_mod: Dict[str, str] = {}
        self.module_funcs: Dict[Tuple[str, str], str] = {}
        self.method_index: Dict[str, List[str]] = {}
        self.class_info: Dict[Tuple[str, str], List[str]] = {}
        self.mod_imports: Dict[str, Dict[str, str]] = {}
        self.mod_nested: Dict[str, Dict[str, List[str]]] = {}
        for path in sorted(summaries):
            s = summaries[path]
            mod = s["mod"]
            self.mod_imports[mod] = s.get("imports", {})
            self.mod_nested[mod] = s.get("nested", {})
            for sid, info in s["sites"].items():
                self.site_info.setdefault(
                    sid, {"kind": info["kind"], "path": path}
                )
            self.aliases.update(s["aliases"])
            for cls, bases in s["classes"].items():
                self.class_info[(mod, cls)] = bases
            for local, rec in s["functions"].items():
                gfid = f"{mod}::{local}"
                self.funcs[gfid] = rec
                self.func_path[gfid] = path
                self.func_mod[gfid] = mod
                if "cls" in rec:
                    continue  # a closure: reached through its definer
                if "." in local:
                    cls, meth = local.rsplit(".", 1)
                    self.method_index.setdefault(meth, []).append(gfid)
                elif local != "<module>":
                    self.module_funcs[(mod, local)] = gfid
        # (mod, cls, attr) -> [(gfid of the constructing function, refs)]:
        # the callables a constructor call stored in that attribute
        self.flows: Dict[Tuple[str, str, str], List[Tuple[str, list]]] = {}
        stored = {
            (summaries[p]["mod"], cls): attrs
            for p in summaries for cls, attrs in summaries[p].get("stored", {}).items()
        }
        for gfid, rec in self.funcs.items():
            for target, pos, refs in rec.get("ctors", ()):
                if "." not in target:
                    continue
                tmod, tcls = target.rsplit(".", 1)
                for attr, p in stored.get((tmod, tcls), {}).items():
                    if p == pos:
                        self.flows.setdefault((tmod, tcls, attr), []).append((gfid, refs))
        self._canon_cache: Dict[str, str] = {}
        self._resolved_calls: Dict[str, List[Tuple[List[str], List[str], int]]] = {}
        self._resolve_all_calls()
        self._acq = self._fixpoint_acquires()

    def canon(self, sid: str) -> str:
        cached = self._canon_cache.get(sid)
        if cached is not None:
            return cached
        self._canon_cache[sid] = out = self._canon_uncached(sid)
        return out

    def _canon_uncached(self, sid: str) -> str:
        seen = set()
        while True:
            if sid in self.aliases and sid not in seen:
                seen.add(sid)
                sid = self.aliases[sid]
                continue
            if sid not in self.site_info:
                remapped = self._remap_inherited(sid)
                if remapped is not None and remapped not in seen:
                    seen.add(sid)
                    sid = remapped
                    continue
            return sid

    def _remap_inherited(self, sid: str) -> Optional[str]:
        """A ``self.X`` lock with no in-module definition fabricates a
        per-subclass id (``serve.decode.ContinuousDecoder._qlock``); if
        the attribute is actually DEFINED by a cross-module base class
        (``serve.scheduler._CoalescerBase._qlock``), remap to the
        defining site so both spellings name ONE graph node — a real
        ABBA spanning the two modules must not split across them."""
        for (mod, cls) in self.class_info:
            prefix = f"{mod}.{cls}."
            if not sid.startswith(prefix):
                continue
            attr = sid[len(prefix):]
            if not attr or "." in attr:
                continue
            target = self._find_site_in_bases(mod, cls, attr, set())
            if target is not None:
                return target
        return None

    def _find_site_in_bases(
        self, mod: str, cls: str, attr: str, seen: Set[Tuple[str, str]]
    ) -> Optional[str]:
        if (mod, cls) in seen:
            return None
        seen.add((mod, cls))
        cand = f"{mod}.{cls}.{attr}"
        if cand in self.site_info:
            return cand
        for base in self.class_info.get((mod, cls), ()):
            leaf = base.split(".")[-1]
            if (mod, leaf) in self.class_info:
                got = self._find_site_in_bases(mod, leaf, attr, seen)
                if got is not None:
                    return got
                continue
            # cross-module base: resolve the base name through the
            # subclass module's imports (`from .scheduler import Base`)
            target = self.mod_imports.get(mod, {}).get(leaf)
            if target and "." in target:
                tmod, tcls = target.rsplit(".", 1)
                if (tmod, tcls) in self.class_info:
                    got = self._find_site_in_bases(tmod, tcls, attr, seen)
                    if got is not None:
                        return got
        return None

    def _rank(self, sid: str) -> Optional[int]:
        info = self.site_info.get(sid)
        if info is not None:
            return rank_of_path(info["path"])
        # opaque receiver lock (`mod.<child._lock>`): the receiver
        # spelling carries the domain by convention (lock_ranks)
        m = re.match(r".*\.<(\w+)\.", sid)
        if m:
            return rank_of_receiver(m.group(1))
        return None

    def _kind(self, sid: str) -> Optional[str]:
        info = self.site_info.get(sid)
        return None if info is None else info["kind"]

    # -- call resolution --------------------------------------------------
    def _resolve_ref(self, gfid: str, ref: Sequence[str]) -> List[str]:
        mod = self.func_mod[gfid]
        kind = ref[0]
        if kind == "self":
            meth = ref[1]
            local = gfid.split("::", 1)[1]
            if "cls" in self.funcs[gfid]:
                cls = self.funcs[gfid]["cls"]
            else:
                cls = local.rsplit(".", 1)[0] if "." in local else None
            if cls is not None:
                for k in self._mro(mod, cls):
                    cand = f"{mod}::{k}.{meth}"
                    if cand in self.funcs:
                        return [cand]
            # program-unique fallback ONLY when the class has a base the
            # module walk could not resolve (a cross-module parent may
            # define the method).  A base-less class calling `self.X()`
            # with no such method is calling an ATTRIBUTE (a stored
            # callable) — resolving that by name invents false edges.
            if cls is not None and (mod, cls, meth) in self.flows:
                # a callable a constructor stored in this attribute
                out: List[str] = []
                for ctx, refs in self.flows[(mod, cls, meth)]:
                    for r in refs:
                        out.extend(self._resolve_ref(ctx, r))
                return out
            if cls is not None and self._has_external_base(mod, cls):
                return self._unique_method(meth, mod)
            return []
        if kind == "handle":
            return self._completions()
        if kind == "bare":
            # a closure of this function or of a function enclosing it
            local = gfid.split("::", 1)[1]
            nested = self.mod_nested.get(mod, {})
            while True:
                for inner in nested.get(local, ()):
                    if inner.rsplit(".", 1)[-1] == ref[1] and f"{mod}::{inner}" in self.funcs:
                        return [f"{mod}::{inner}"]
                parent = next(
                    (outer for outer, inners in nested.items() if local in inners), None
                )
                if parent is None:
                    break
                local = parent
            cand = self.module_funcs.get((mod, ref[1]))
            if cand:
                return [cand]
            # a function imported by name (`from .build import load_host`)
            target = self.mod_imports.get(mod, {}).get(ref[1])
            if target and "." in target:
                tmod, func = target.rsplit(".", 1)
                for m in (tmod, tmod + ".__init__"):
                    cand = self.module_funcs.get((m, func))
                    if cand:
                        return [cand]
            return []
        if kind == "mod":
            target, func = ref[1], ref[2]
            for m in (target, target + ".__init__"):
                cand = self.module_funcs.get((m, func))
                if cand:
                    return [cand]
            return []
        if kind == "meth":
            return self._unique_method(ref[1], mod)
        if kind == "nested":
            # the closures defined inside ref[1].ref[2] (what a wrapper
            # returns and its caller then runs)
            target, func = ref[1], ref[2]
            out = []
            for inner in self.mod_nested.get(target, {}).get(func, ()):
                cand = f"{target}::{inner}"
                if cand in self.funcs:
                    out.append(cand)
            return out
        return []

    def _completions(self) -> List[str]:
        """Every function a stored serve handle's call may run: the
        ``complete`` closures the submit paths return, and the
        ``__call__`` of the handle classes (``*Handle``, ``*Ticket``)."""
        cached = getattr(self, "_completion_cache", None)
        if cached is None:
            cached = sorted(
                gfid for gfid in self.funcs
                if gfid.split("::", 1)[1].rsplit(".", 1)[-1] == "complete"
                or re.search(r"(Handle|Ticket)\.__call__$", gfid)
            )
            self._completion_cache = cached
        return cached

    def _has_external_base(self, mod: str, cls: str) -> bool:
        for c in self._mro(mod, cls):
            for base in self.class_info.get((mod, c), ()):
                leaf = base.split(".")[-1]
                if (mod, leaf) not in self.class_info and leaf not in (
                    "object", "Exception", "ABC",
                ):
                    return True
        return False

    def _unique_method(self, meth: str, caller_mod: Optional[str] = None) -> List[str]:
        """The functions a method name reaches: its one owner; else its
        owners in the modules the caller's module imports (or in its own),
        when those sit in one module (``h.snapshot()`` in a module that
        imports ``observe.histogram``: ``LatencyHistogram.snapshot`` /
        ``EventRing.snapshot``, one family, one rank)."""
        if meth in _GENERIC_METHODS:
            return []
        owners = self.method_index.get(meth, ())
        if len(owners) == 1:
            return list(owners)
        if caller_mod is not None and len(owners) > 1:
            seen = {caller_mod}
            for target in self.mod_imports.get(caller_mod, {}).values():
                seen.update((target, target.rsplit(".", 1)[0]))
            near = [o for o in owners if self.func_mod[o] in seen]
            if 0 < len(near) <= 3 and len({self.func_mod[o] for o in near}) == 1:
                return near
        return []

    def _mro(self, mod: str, cls: str) -> List[str]:
        out, queue, seen = [], [cls], set()
        while queue:
            c = queue.pop(0)
            if c in seen:
                continue
            seen.add(c)
            out.append(c)
            queue.extend(
                b.split(".")[-1]
                for b in self.class_info.get((mod, c), ())
            )
        return out

    def _resolve_all_calls(self) -> None:
        for gfid, rec in self.funcs.items():
            resolved = []
            for held, refs, line in rec["calls"]:
                callees: List[str] = []
                for ref in refs:
                    callees.extend(self._resolve_ref(gfid, ref))
                if callees:
                    resolved.append((held, callees, line))
            self._resolved_calls[gfid] = resolved

    # -- transitive acquisitions ------------------------------------------
    def _fixpoint_acquires(self) -> Dict[str, Dict[str, List[str]]]:
        acq: Dict[str, Dict[str, List[str]]] = {}
        for gfid, rec in self.funcs.items():
            path = self.func_path[gfid]
            mine: Dict[str, List[str]] = {}
            for sid, line in rec["direct"]:
                c = self.canon(sid)
                mine.setdefault(
                    c, [f"{gfid} acquires `{c}` at {path}:{line}"]
                )
            acq[gfid] = mine
        for _ in range(50):
            changed = False
            for gfid in self.funcs:
                path = self.func_path[gfid]
                mine = acq[gfid]
                for _held, callees, line in self._resolved_calls[gfid]:
                    for callee in callees:
                        for sid, chain in acq.get(callee, {}).items():
                            if sid in mine or len(chain) >= _MAX_WITNESS:
                                continue
                            mine[sid] = [
                                f"{gfid} calls {callee} at {path}:{line}"
                            ] + chain
                            changed = True
            if not changed:
                break
        return acq

    # -- the checks --------------------------------------------------------
    def findings(self) -> List[Finding]:
        # every distinct acquisition SITE of a (outer, inner) pair is its
        # own witness: a rank inversion is reported (and waived) per
        # site, exactly like the per-call lock-discipline findings — one
        # arbitrary witness per pair would leave sibling sites silently
        # unreviewed
        edges: Dict[Tuple[str, str], List[Tuple[str, int, List[str]]]] = {}

        def add_edge(
            outer: str, inner: str, path: str, line: int, chain: List[str]
        ) -> None:
            sites = edges.setdefault((outer, inner), [])
            if not any(p == path and l == line for p, l, _c in sites):
                sites.append((path, line, chain))

        for gfid in sorted(self.funcs):
            rec = self.funcs[gfid]
            path = self.func_path[gfid]
            for outer, inner, line in rec["edges"]:
                add_edge(self.canon(outer), self.canon(inner), path, line, [])
            for held, callees, line in self._resolved_calls[gfid]:
                if not held:
                    continue
                for callee in callees:
                    for sid, chain in self._acq.get(callee, {}).items():
                        for h in held:
                            add_edge(
                                self.canon(h), sid, path, line, chain
                            )

        out: List[Finding] = []
        for (outer, inner) in sorted(edges):
            for path, line, chain in edges[(outer, inner)]:
                via = (
                    " [via " + " ; ".join(chain) + "]" if chain else ""
                )
                if outer == inner:
                    if self._kind(outer) == "lock":
                        out.append(
                            Finding(
                                path, line, 0, "lock-order",
                                f"non-reentrant lock `{outer}` acquired "
                                "while already held by this thread — "
                                "guaranteed self-deadlock on first "
                                "execution (make it an RLock or split "
                                "the critical section)" + via,
                            )
                        )
                    continue
                r_out, r_in = self._rank(outer), self._rank(inner)
                if r_out is not None and r_in is not None and r_in > r_out:
                    out.append(
                        Finding(
                            path, line, 0, "lock-order",
                            f"rank inversion: `{inner}` "
                            f"({rank_name(r_in)}) acquired while holding "
                            f"`{outer}` ({rank_name(r_out)}) — the "
                            f"declared hierarchy ({table()}) requires "
                            "DESCENDING rank order; re-order the "
                            "acquisitions or waive with a reviewed "
                            "`# pathway: allow(lock-order): <rank "
                            "exception>`" + via,
                        )
                    )

        first_witness = {
            key: sites[0] for key, sites in edges.items()
        }
        out.extend(self._cycle_findings(first_witness))
        return out

    def _cycle_findings(
        self, edges: Dict[Tuple[str, str], Tuple[str, int, List[str]]]
    ) -> List[Finding]:
        graph: Dict[str, List[str]] = {}
        for (outer, inner) in edges:
            if outer != inner:
                graph.setdefault(outer, []).append(inner)
        for succs in graph.values():
            succs.sort()
        out: List[Finding] = []
        for scc in _sccs(graph):
            if len(scc) < 2:
                continue
            cycle = _find_cycle(graph, scc)
            if not cycle:
                continue
            hops = []
            for a, b in zip(cycle, cycle[1:] + cycle[:1]):
                path, line, _chain = edges[(a, b)]
                hops.append(f"`{a}` → `{b}` ({path}:{line})")
            first = edges[(cycle[0], cycle[1] if len(cycle) > 1 else cycle[0])]
            out.append(
                Finding(
                    first[0], first[1], 0, "lock-order",
                    "deadlock cycle in the observed acquisition graph — "
                    "two threads taking this loop from different entry "
                    "points deadlock; witness path: " + " ; ".join(hops),
                )
            )
        return out


def module_lock_sites(
    real_path: str, display_path: Optional[str] = None
) -> Dict[int, Tuple[str, str]]:
    """``{creation_line: (site_id, kind)}`` for every lock site in one
    module — the runtime sanitizer's naming table.  Both sides share
    THIS discovery, so a runtime edge names the same ``module.Class.attr``
    identity the static graph uses (the dynamic oracle can confirm or
    refute specific static edges)."""
    try:
        with open(real_path, "r", encoding="utf-8") as fh:
            source = fh.read()
        ctx = ModuleContext(real_path, display_path or real_path, source)
    except (OSError, SyntaxError, ValueError):
        return {}
    extractor = _Extractor(ctx, "lock-order")
    return {
        info["line"]: (sid, info["kind"])
        for sid, info in extractor.sites.items()
    }


def _sccs(graph: Dict[str, List[str]]) -> List[List[str]]:
    """Tarjan, iterative, deterministic (sorted node order)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]
    nodes = sorted(set(graph) | {v for vs in graph.values() for v in vs})

    for root in nodes:
        if root in index:
            continue
        work = [(root, 0)]
        while work:
            node, i = work.pop()
            if i == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            recurse = False
            succs = graph.get(node, ())
            for j in range(i, len(succs)):
                w = succs[j]
                if w not in index:
                    work.append((node, j + 1))
                    work.append((w, 0))
                    recurse = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if recurse:
                continue
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(sorted(scc))
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
    return sccs


def _find_cycle(
    graph: Dict[str, List[str]], scc: List[str]
) -> List[str]:
    """One concrete cycle inside an SCC (DFS from its smallest node)."""
    members = set(scc)
    start = scc[0]
    path: List[str] = [start]
    seen = {start}

    def dfs(node: str) -> Optional[List[str]]:
        for succ in graph.get(node, ()):
            if succ not in members:
                continue
            if succ == start:
                return list(path)
            if succ in seen:
                continue
            seen.add(succ)
            path.append(succ)
            got = dfs(succ)
            if got is not None:
                return got
            path.pop()
        return None

    return dfs(start) or []


def static_graph(paths: Sequence[str]) -> dict:
    """The whole-program lock graph over ``paths``, for a caller holding
    runtime edges against it: ``{"edges": {(outer, inner), ...},
    "sites": {site_id: {"kind", "path", "rank"}}}``.  Edges are canonical
    (aliases and inherited attributes resolved), lexical and through
    helpers alike."""
    from .core import analyze_paths

    rule = LockOrderRule()
    analyze_paths(paths, rules=[rule])
    prog = _Program(rule._summaries)
    edges: Set[Tuple[str, str]] = set()
    for gfid in prog.funcs:
        for outer, inner, _line in prog.funcs[gfid]["edges"]:
            edges.add((prog.canon(outer), prog.canon(inner)))
        for held, callees, _line in prog._resolved_calls[gfid]:
            for callee in callees:
                for sid in prog._acq.get(callee, {}):
                    for h in held:
                        edges.add((prog.canon(h), sid))
    sites = {
        sid: {"kind": info["kind"], "path": info["path"], "rank": rank_of_path(info["path"])}
        for sid, info in prog.site_info.items()
    }
    return {"edges": {e for e in edges if e[0] != e[1]}, "sites": sites}


def _runtime_rank(sid: str, sites: Dict[str, dict]) -> Optional[int]:
    info = sites.get(sid)
    if info is not None:
        return info["rank"]
    if ":" in sid:  # `module.path:line` — a creation the site table does not name
        return rank_of_path(sid.rsplit(":", 1)[0].replace(".", "/") + ".py")
    return None


def _matches(static_id: str, runtime_id: str, runtime_rank: Optional[int]) -> bool:
    """A static node names the runtime lock: the same site id, or an
    opaque receiver lock (``mod.<child._lock>``) whose receiver carries
    the runtime lock's rank and whose attribute is the same."""
    if static_id == runtime_id:
        return True
    m = re.match(r".*\.<(\w+)\.(\w+)>$", static_id)
    if m is None:
        return False
    return (
        runtime_rank is not None
        and rank_of_receiver(m.group(1)) == runtime_rank
        and runtime_id.rsplit(".", 1)[-1] == m.group(2)
    )


def runtime_edge_report(runtime_edges, graph: dict) -> dict:
    """Hold the sanitizer's observed edges against the static graph:
    ``{"inconsistent": [...], "missing": [...]}``.  An edge is
    INCONSISTENT when it inverts the declared ranks (a pair the rank table
    does not waive); it is MISSING when no static edge names it (a gap in
    the lint).  Cycles are the sanitizer's own check, at the acquire."""
    from .lock_ranks import pair_waived

    sites = graph["sites"]
    static = graph["edges"]
    inconsistent, missing = [], []
    for a, b in sorted(runtime_edges):
        ra, rb = _runtime_rank(a, sites), _runtime_rank(b, sites)
        if ra is not None and rb is not None and rb > ra and not pair_waived(ra, rb):
            inconsistent.append((a, b, "rank-inversion"))
        if not any(
            _matches(x, a, ra) and _matches(y, b, rb) for x, y in static
        ):
            missing.append((a, b))
    return {"inconsistent": inconsistent, "missing": missing}
