"""knob-discipline: every ``PATHWAY_*`` knob flows through the port's
knob table (counterpart of ``pathway_tpu/analysis/knob_discipline.py``).

The port declares every knob once, with the reference's key, environment
name, type, default and bounds, in ``pathway_tpu_torch/config.py``; a
raw ``os.environ`` read elsewhere re-parses per call, skips the declared
bounds and drifts from the reference.  This family is the ratchet:

- **raw-env-read**: any ``os.environ``/``os.getenv`` read of a
  ``PATHWAY_*`` name outside the table module is a finding.  The
  message escalates when the read sits in a serve-path function (a
  per-request env parse) or lexically inside a lock body (env parsing
  extends the critical section).  Alias assignments
  (``env = os.environ``) and ``from os import environ`` are resolved.
- **undeclared-knob** (whole-program): a ``PATHWAY_*`` literal, or a
  ``config.get("<key>")``-style reference, that no declaration covers.
  Checked against the ANALYZED tree's table module when one is in scope
  (the module calling the ``_knob`` declaration helper), falling back to
  the port's live table for single-module runs.
- **dead-knob** (whole-program): a declared knob never read back via
  ``config.get``/``get_site`` anywhere in the analyzed tree.  Skipped
  when the table module is not among the analyzed files.

Per-module facts are extracted in ``run`` and cross-module findings come
from ``finalize``, so the incremental cache stores only summaries.

Intentional exceptions live in ``DECLARED_KNOB_WAIVERS`` — mirrored both
directions against in-tree ``allow(knob-discipline)`` pragmas by the
tier-1 suite.  The port needs ZERO waivers: it has no raw ``PATHWAY_*``
read outside ``config.py``.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, ModuleContext, Rule
from .registry import dotted_name, is_lock_context

__all__ = ["DECLARED_KNOB_WAIVERS", "KnobDisciplineRule"]

# (display-path suffix, env or key name) -> reason.  Every entry must be
# matched by an in-tree ``pathway: allow(...)`` pragma naming this rule
# and vice versa (test_knob_waivers_mirror_matches_pragmas).
DECLARED_KNOB_WAIVERS: Dict[Tuple[str, str], str] = {}

_KNOB_NAME_RE = re.compile(r"PATHWAY_[A-Z0-9_]+")
# dotted registry keys look like "serve.coalesce_us"
_KEY_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")
_CONFIG_API = {"get", "get_site", "set", "clear_override"}


def waiver_for(display_path: str, name: str) -> Optional[str]:
    norm = display_path.replace("\\", "/")
    for (suffix, waived), reason in DECLARED_KNOB_WAIVERS.items():
        if name == waived and norm.endswith(suffix):
            return reason
    return None


def _is_environ_name(name: Optional[str], aliases: Set[str]) -> bool:
    return bool(name) and (
        name in ("os.environ", "environ") or name in aliases
    )


def _literal_env_arg(node: ast.AST) -> Optional[str]:
    """The PATHWAY_* env name an argument expression resolves to, if it
    statically starts with the prefix: plain literals, f-strings with a
    literal head, and ``"PATHWAY_X" + tail`` concatenations."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        text = node.value
    elif isinstance(node, ast.JoinedStr) and node.values:
        head = node.values[0]
        if not (
            isinstance(head, ast.Constant) and isinstance(head.value, str)
        ):
            return None
        text = head.value
    elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _literal_env_arg(node.left)
    else:
        return None
    m = _KNOB_NAME_RE.match(text)
    return m.group(0) if m else None


def _docstring_nodes(tree: ast.Module) -> Set[int]:
    """id()s of Constant nodes that are docstrings — knob names inside
    prose (e.g. historical design notes) are not references."""
    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(
            node,
            (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef),
        ) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                first.value, ast.Constant
            ) and isinstance(first.value.value, str):
                out.add(id(first.value))
    return out


class KnobDisciplineRule(Rule):
    name = "knob-discipline"
    salt_sources = ("knob_discipline.py",)
    description = (
        "raw PATHWAY_* env read outside the config registry, or an "
        "undeclared/dead knob"
    )

    def __init__(self) -> None:
        self._summaries: Dict[str, dict] = {}

    # -- per-module ---------------------------------------------------------

    def run(self, ctx: ModuleContext) -> None:
        tree = ctx.tree
        decls = self._registry_decls(tree)
        is_registry = bool(decls)
        aliases = self._environ_aliases(tree)
        helpers = self._env_helper_names(tree, aliases)
        doc_nodes = _docstring_nodes(tree)
        lock_spans = [
            (node.body[0].lineno, node.end_lineno or node.lineno)
            for node in ast.walk(tree)
            if isinstance(node, ast.With) and is_lock_context(node)
            and node.body
        ]
        fn_spans = [
            (node.lineno, node.end_lineno or node.lineno)
            for node in ast.walk(tree)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]

        env_refs: List[List] = []
        key_refs: List[List] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(
                node.value, str
            ):
                if id(node) in doc_nodes:
                    continue
                for name in _KNOB_NAME_RE.findall(node.value):
                    env_refs.append([name, node.lineno, node.col_offset])
            if isinstance(node, ast.Call):
                key = self._config_key_ref(node)
                if key is not None:
                    key_refs.append(
                        [key, node.lineno, node.col_offset]
                    )
                if not is_registry:
                    self._check_raw_read(
                        ctx, node, aliases, helpers, lock_spans, fn_spans
                    )
            elif not is_registry and isinstance(node, ast.Subscript):
                if isinstance(node.ctx, ast.Load) and _is_environ_name(
                    dotted_name(node.value), aliases
                ):
                    name = _literal_env_arg(node.slice)
                    if name is not None:
                        self._report_raw(
                            ctx, node, name, lock_spans, fn_spans,
                            via=f"os.environ[{name!r}]",
                        )
            elif not is_registry and isinstance(node, ast.Compare):
                for op, right in zip(node.ops, node.comparators):
                    if isinstance(op, (ast.In, ast.NotIn)) and (
                        _is_environ_name(dotted_name(right), aliases)
                    ):
                        name = _literal_env_arg(node.left)
                        if name is not None:
                            self._report_raw(
                                ctx, node, name, lock_spans, fn_spans,
                                via=f"{name!r} in os.environ",
                            )

        self._summaries[ctx.display_path] = {
            "registry": is_registry,
            "decls": decls,
            "env_refs": env_refs,
            "key_refs": key_refs,
        }

    def _registry_decls(self, tree: ast.Module) -> List[List]:
        """[key, env, line] per ``_knob("key", "ENV", ...)`` call — the
        module making such calls IS the registry (and is the one module
        allowed to touch ``os.environ`` for PATHWAY names)."""
        decls: List[List] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            if (callee or "").rsplit(".", 1)[-1] != "_knob":
                continue
            if len(node.args) < 2:
                continue
            key, env = node.args[0], node.args[1]
            if isinstance(key, ast.Constant) and isinstance(
                env, ast.Constant
            ):
                decls.append([key.value, env.value, node.lineno])
        return decls

    def _environ_aliases(self, tree: ast.Module) -> Set[str]:
        aliases: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, (ast.Name, ast.Attribute)
            ):
                if dotted_name(node.value) in ("os.environ", "environ"):
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            aliases.add(target.id)
            elif isinstance(node, ast.ImportFrom) and node.module == "os":
                for a in node.names:
                    if a.name in ("environ", "getenv"):
                        aliases.add(a.asname or a.name)
        return aliases

    def _env_helper_names(self, tree: ast.Module, aliases) -> Set[str]:
        """Local functions that forward a parameter into an environ read
        (``def _env_int(name, default): ... os.environ.get(name)``) —
        calling one with a PATHWAY_* literal is still a raw read; the
        helper is just a trench coat."""
        helpers: Set[str] = set()
        for node in ast.walk(tree):
            if not isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            params = {
                a.arg
                for a in (
                    node.args.posonlyargs
                    + node.args.args
                    + node.args.kwonlyargs
                )
            }
            for sub in ast.walk(node):
                hit = False
                if isinstance(sub, ast.Call):
                    callee = dotted_name(sub.func) or ""
                    leaf = callee.rsplit(".", 1)[-1]
                    if (
                        leaf in ("get", "setdefault")
                        and _is_environ_name(
                            callee.rsplit(".", 1)[0], aliases
                        )
                    ) or callee in ("os.getenv", "getenv"):
                        hit = bool(sub.args) and isinstance(
                            sub.args[0], ast.Name
                        ) and sub.args[0].id in params
                elif isinstance(sub, ast.Subscript) and _is_environ_name(
                    dotted_name(sub.value), aliases
                ):
                    hit = isinstance(
                        sub.slice, ast.Name
                    ) and sub.slice.id in params
                if hit:
                    helpers.add(node.name)
                    break
        return helpers

    def _config_key_ref(self, node: ast.Call) -> Optional[str]:
        """The literal first argument of a ``config.<api>("a.b", ...)``
        call — a registry-key reference (the dead-knob liveness signal)."""
        if not isinstance(node.func, ast.Attribute):
            return None
        if node.func.attr not in _CONFIG_API:
            return None
        base = dotted_name(node.func.value) or ""
        if base.rsplit(".", 1)[-1] not in ("config", "_config", "pwconfig"):
            return None
        if not node.args:
            return None
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value if _KEY_RE.match(arg.value) else None
        return None

    def _check_raw_read(
        self, ctx, node: ast.Call, aliases, helpers, lock_spans, fn_spans
    ) -> None:
        callee = dotted_name(node.func)
        if not callee:
            return
        leaf = callee.rsplit(".", 1)[-1]
        is_read = (
            (leaf in ("get", "setdefault") and _is_environ_name(
                callee.rsplit(".", 1)[0], aliases
            ))
            or callee in ("os.getenv", "getenv")
            or (leaf == "getenv" and callee in aliases)
            or callee in helpers
        )
        if not is_read or not node.args:
            return
        name = _literal_env_arg(node.args[0])
        if name is None:
            return
        self._report_raw(
            ctx, node, name, lock_spans, fn_spans,
            via=f"{callee}({name!r})",
        )

    def _report_raw(
        self, ctx, node, name, lock_spans, fn_spans, via
    ) -> None:
        if waiver_for(ctx.display_path, name):
            return
        line = node.lineno
        if any(lo <= line <= hi for lo, hi in lock_spans):
            ctx.report(
                self.name, node,
                f"raw env read `{via}` inside a lock body — env parsing "
                "extends the critical section; read it once through "
                "config.get outside the lock",
            )
        elif ctx.serve_path and any(
            lo <= line <= hi for lo, hi in fn_spans
        ):
            ctx.report(
                self.name, node,
                f"raw env read `{via}` on a serve-path function — a "
                "per-request env parse; config.get is a cached typed "
                "lookup, use it",
            )
        else:
            ctx.report(
                self.name, node,
                f"raw env read `{via}` outside config.py — declare the "
                "knob once in the registry and read it via config.get",
            )

    # -- incremental-cache plumbing ----------------------------------------

    def dump_summary(self, display_path: str) -> Optional[dict]:
        return self._summaries.get(display_path)

    def load_summary(self, display_path: str, summary: dict) -> None:
        self._summaries[display_path] = summary

    # -- whole-program ------------------------------------------------------

    def finalize(self) -> List[Finding]:
        reg_modules = {
            path: s for path, s in self._summaries.items() if s["registry"]
        }
        if reg_modules:
            declared_keys = {
                d[0] for s in reg_modules.values() for d in s["decls"]
            }
            declared_envs = {
                d[1] for s in reg_modules.values() for d in s["decls"]
            }
            # prefix families (PATHWAY_RETRY_ATTEMPTS_<SITE>) are strings
            # in the declaration's keyword args, which the AST extraction
            # above does not carry — derive them from the live registry,
            # which is authoritative for the real tree
            prefixes = self._live_prefixes()
        else:
            live = self._live_registry()
            declared_keys = set(live)
            declared_envs = {k.env for k in live.values()}
            prefixes = self._live_prefixes()

        out: List[Finding] = []
        read_keys: Set[str] = set()
        for path in sorted(self._summaries):
            s = self._summaries[path]
            if s["registry"]:
                continue
            read_keys.update(ref[0] for ref in s["key_refs"])
            seen_here: Set[Tuple[str, int]] = set()
            for name, line, col in s["env_refs"]:
                if name in declared_envs:
                    continue
                if any(name.startswith(p) or name == p for p in prefixes):
                    continue
                if waiver_for(path, name):
                    continue
                if (name, line) in seen_here:
                    continue
                seen_here.add((name, line))
                out.append(
                    Finding(
                        path, line, col, self.name,
                        f"undeclared knob `{name}` — every PATHWAY_* env "
                        "must be declared exactly once in the config "
                        "table (pathway_tpu_torch/config.py)",
                    )
                )
            for key, line, col in s["key_refs"]:
                if key in declared_keys or waiver_for(path, key):
                    continue
                out.append(
                    Finding(
                        path, line, col, self.name,
                        f"config key `{key}` is not declared in the "
                        "registry — config.get on it raises "
                        "UnknownKnobError at runtime",
                    )
                )
        # dead knobs need the READER side of the whole tree in scope;
        # a lone-fixture run (no registry module analyzed) skips this
        for path, s in sorted(reg_modules.items()):
            for key, env, line in s["decls"]:
                if key in read_keys or waiver_for(path, key):
                    continue
                out.append(
                    Finding(
                        path, line, 0, self.name,
                        f"dead knob: `{key}` ({env}) is declared but "
                        "never read via config.get/get_site anywhere in "
                        "the analyzed tree — delete the declaration or "
                        "wire up the reader",
                    )
                )
        return out

    def _live_registry(self):
        from .. import config as pwconfig

        return pwconfig.registry()

    def _live_prefixes(self) -> Set[str]:
        try:
            live = self._live_registry()
        except Exception:  # standalone analysis checkouts
            return set()
        return {
            k.site_prefix for k in live.values() if k.site_prefix
        }
