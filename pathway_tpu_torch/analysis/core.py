"""AST lint framework for the port's serving hot path (counterpart of
``pathway_tpu/analysis/core.py``).

The port's serve stack shares the reference's latent bug classes:
device work and GIL-holding C calls under a lock (a kernel launch or a
``.cpu()`` fetch inside an index lock, a pickle of a whole frame inside
the exchange plane's send lock), and the serve path's "2 dispatches + 2
fetches" budget is guarded only at run time by
``ops/dispatch_counter.py``.  This package finds those classes
statically, over the whole ``pathway_tpu_torch`` tree, on every tier-1
run.

Framework pieces (rules live in sibling modules):

- ``Finding`` — one diagnostic with ``path:line:col`` and a rule name;
- pragma suppression — ``# pathway: allow(<rule>[, <rule>]): <reason>``
  on (or covering) the offending line silences a finding WITH a recorded
  reason.  A pragma on the first line of a compound statement (``with``,
  ``for``, ``def``…) covers the whole statement body, so one reviewed
  reason can bless an entire lock section.  ``# pathway: allow-file(...)``
  covers the module.  Reasons are mandatory: a pragma without one is
  itself reported;
- ``# pathway: serve-path`` — marks a module as serve-path so the
  hidden-sync rule applies to it (a default list covers the known serving
  modules even without the marker);
- ``analyze_paths`` / ``analyze_file`` — the tree walker used by both the
  CLI (``python -m pathway_tpu_torch.analysis``) and the tier-1 gate
  test.

The package is standard library plus ``ast``: it imports no ``torch``
at module scope, so the lint runs on a machine without a card.
"""

from __future__ import annotations

import ast
import hashlib
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding",
    "ModuleContext",
    "Rule",
    "analyze_file",
    "analyze_paths",
    "analyze_source",
    "default_rules",
    "iter_py_files",
    "stale_pragma_findings",
]

_PRAGMA_RE = re.compile(
    r"#\s*pathway:\s*allow(?P<scope>-file)?\(\s*(?P<rules>[\w\-, ]+)\s*\)"
    r"\s*(?::\s*(?P<reason>\S.*?))?\s*$"
)
_SERVE_PATH_RE = re.compile(r"#\s*pathway:\s*serve-path\b")

# modules the hidden-sync rule covers even without an in-file marker
DEFAULT_SERVE_PATH_MODULES = (
    "ops/serving.py",
    "ops/retrieve_rerank.py",
    "models/encoder.py",
    "models/cross_encoder.py",
)


@dataclass
class Finding:
    """One diagnostic.  ``suppressed`` findings carry the pragma reason so
    the CLI can audit every allowance alongside the live violations."""

    path: str
    line: int
    col: int
    rule: str
    message: str
    suppressed: bool = False
    reason: Optional[str] = None

    def format(self) -> str:
        tag = f" [suppressed: {self.reason}]" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}{tag}"


@dataclass
class _Pragma:
    line: int
    rules: Set[str]
    reason: Optional[str]
    whole_file: bool
    span: Tuple[int, int] = (0, 0)  # statement body the pragma covers
    used: bool = False  # matched at least one finding (stale-waiver audit)


class ModuleContext:
    """Everything a rule needs about one parsed module."""

    def __init__(self, path: str, display_path: str, source: str):
        self.path = path
        self.display_path = display_path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.pragmas = _collect_pragmas(source)
        _attach_spans(self.pragmas, self.tree)
        self.serve_path = bool(_SERVE_PATH_RE.search(source)) or any(
            display_path.replace(os.sep, "/").endswith(m)
            for m in DEFAULT_SERVE_PATH_MODULES
        )
        from .registry import collect_dispatch_names

        self.dispatch_names = collect_dispatch_names(self.tree)
        self.findings: List[Finding] = []

    def report(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        col = getattr(node, "col_offset", 0)
        suppressed, reason = self._suppression_for(rule, line)
        self.findings.append(
            Finding(
                self.display_path, line, col, rule, message,
                suppressed=suppressed, reason=reason,
            )
        )

    def _suppression_for(self, rule: str, line: int) -> Tuple[bool, Optional[str]]:
        return _suppress_with(self.pragmas, rule, line)


def _suppress_with(
    pragmas: Sequence[_Pragma], rule: str, line: int
) -> Tuple[bool, Optional[str]]:
    """First pragma covering (rule, line) wins; the match is recorded on
    the pragma so ``--check-pragmas`` can flag waivers that no longer
    suppress anything."""
    for p in pragmas:
        if rule not in p.rules and "*" not in p.rules:
            continue
        if p.whole_file or p.line == line or p.span[0] <= line <= p.span[1]:
            p.used = True
            return True, p.reason
    return False, None


class Rule:
    """Base rule: subclasses set ``name`` and implement ``run(ctx)``,
    reporting through ``ctx.report`` (suppression is applied centrally).

    **Whole-program rules** (the lock-order and value-flow families)
    additionally define ``finalize() -> List[Finding]``: ``run``
    extracts a per-module summary, ``finalize`` is called ONCE after
    every module has been seen and returns cross-module findings
    (suppression is applied by the caller from each finding's own
    module's pragmas).  For the incremental cache they also define
    ``dump_summary(path) -> dict`` (JSON-able per-module facts) and
    ``load_summary(path, summary)`` (rehydrate a cache hit without
    re-parsing).

    ``salt_sources`` names the analyzer source files THIS family's
    results depend on (``core.py`` and ``registry.py`` are always
    included — they are shared resolution machinery).  The incremental
    cache salts each family's cached results with only those files, so
    editing (or ADDING) one family re-runs just that family on warm
    modules instead of cold-invalidating every other family's cached
    findings.  ``None`` (the conservative default for out-of-tree
    rules) salts with every ``.py`` in the analysis package."""

    name = "rule"
    description = ""
    salt_sources: Optional[Tuple[str, ...]] = None

    def run(self, ctx: ModuleContext) -> None:  # pragma: no cover - interface
        raise NotImplementedError


def _collect_pragmas(source: str) -> List[_Pragma]:
    pragmas: List[_Pragma] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _PRAGMA_RE.search(tok.string)
            if not m:
                continue
            rules = {r.strip() for r in m.group("rules").split(",") if r.strip()}
            pragmas.append(
                _Pragma(
                    line=tok.start[0],
                    rules=rules,
                    reason=m.group("reason"),
                    whole_file=bool(m.group("scope")),
                )
            )
    except tokenize.TokenError:  # unterminated strings etc: no pragmas then
        pass
    return pragmas


def _attach_spans(pragmas: List[_Pragma], tree: ast.Module) -> None:
    """A pragma on a statement's FIRST line covers the whole statement
    (multi-line calls, a ``with`` body, a whole ``def``); a pragma on a
    comment line of its own covers the statement starting on the NEXT
    line (the conventional lint-pragma placement)."""
    if not pragmas:
        return
    stmt_lines = {
        node.lineno for node in ast.walk(tree) if isinstance(node, ast.stmt)
    }
    by_line: Dict[int, List[_Pragma]] = {}
    for p in pragmas:
        by_line.setdefault(p.line, []).append(p)
        if p.line not in stmt_lines:
            # standalone-comment placement only: claim the next line.  A
            # TRAILING pragma must never leak onto the following statement
            # — an unreviewed violation added right below an allowance has
            # to stay visible to the gate.
            by_line.setdefault(p.line + 1, []).append(p)
    for node in ast.walk(tree):
        if not isinstance(node, ast.stmt):
            continue
        for p in by_line.get(node.lineno, ()):
            end = getattr(node, "end_lineno", node.lineno)
            start = min(p.line, node.lineno)
            p.span = (start, max(p.span[1], end))


def default_rules() -> List[Rule]:
    from .hidden_sync import HiddenSyncRule
    from .knob_discipline import KnobDisciplineRule
    from .lock_discipline import LockDisciplineRule
    from .lock_order import LockOrderRule
    from .recompile_hazard import RecompileHazardRule
    from .value_flow import ValueFlowRule

    return [
        LockDisciplineRule(),
        HiddenSyncRule(),
        RecompileHazardRule(),
        LockOrderRule(),
        ValueFlowRule(),
        KnobDisciplineRule(),
    ]


def _run_module(
    source: str,
    display_path: str,
    rules: Sequence[Rule],
    real_path: Optional[str] = None,
) -> Tuple[Optional[ModuleContext], List[Finding]]:
    """Parse + run the per-module side of every rule.  Whole-program
    findings (rule.finalize) are NOT included — the caller owns that."""
    try:
        ctx = ModuleContext(real_path or display_path, display_path, source)
    except SyntaxError as exc:
        return None, [
            Finding(
                display_path, exc.lineno or 0, exc.offset or 0,
                "parse-error", f"could not parse: {exc.msg}",
            )
        ]
    for rule in rules:
        rule.run(ctx)
    # a pragma with no reason is itself a violation: allowances must be
    # reviewable, and "because it complained" is not a review
    for p in ctx.pragmas:
        if p.reason is None:
            ctx.findings.append(
                Finding(
                    display_path, p.line, 0, "pragma-missing-reason",
                    "suppression pragma without a ': <reason>' — every "
                    "allowance must record why it is safe",
                )
            )
    return ctx, ctx.findings


def _finalize_rules(
    rules: Sequence[Rule], pragma_map: Dict[str, List[_Pragma]]
) -> List[Finding]:
    """Collect whole-program findings and apply each one's own module's
    pragma suppression (a waiver lives at the acquisition site it
    blesses, exactly like per-module findings)."""
    out: List[Finding] = []
    for rule in rules:
        finalize = getattr(rule, "finalize", None)
        if finalize is None:
            continue
        for f in finalize():
            suppressed, reason = _suppress_with(
                pragma_map.get(f.path, ()), f.rule, f.line
            )
            f.suppressed, f.reason = suppressed, reason
            out.append(f)
    return out


def analyze_file(
    path: str,
    rules: Optional[Sequence[Rule]] = None,
    display_path: Optional[str] = None,
) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        source = fh.read()
    return analyze_source(
        source, display_path or path, rules=rules, real_path=path
    )


def analyze_source(
    source: str,
    display_path: str,
    rules: Optional[Sequence[Rule]] = None,
    real_path: Optional[str] = None,
) -> List[Finding]:
    """Single-module entry (fixtures, one-file CLI runs): per-module
    rules plus the whole-program pass over just this module."""
    rules = list(rules) if rules is not None else default_rules()
    ctx, findings = _run_module(source, display_path, rules, real_path)
    if ctx is not None:
        findings.extend(
            _finalize_rules(rules, {display_path: ctx.pragmas})
        )
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def iter_py_files(paths: Iterable[str]) -> Iterable[str]:
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                yield path
            continue
        for root, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(
                d for d in dirnames
                if not d.startswith(".") and d != "__pycache__"
            )
            for name in sorted(filenames):
                if name.endswith(".py"):
                    yield os.path.join(root, name)


# -- incremental analysis cache -------------------------------------------
#
# PATHWAY_ANALYSIS_CACHE=<dir> (``analysis.cache_dir``) keys one JSON
# record per module on a
# content hash salted with the SHARED analyzer machinery (core.py +
# registry.py) — the repo-wide tier-1 gate then re-parses only changed
# modules.  Within a record, each rule FAMILY's findings and module
# summary carry their own salt over just that family's sources
# (``Rule.salt_sources``): editing one family — or ADDING a new one —
# re-runs only that family on warm modules instead of cold-invalidating
# the other families' cached results.  Records carry the per-family
# findings, the pragma table (spans included — whole-program
# suppression needs them without re-parsing) and each whole-program
# rule's module summary, so warm runs produce bit-identical findings
# to cold ones.

# analyzer files every family depends on (parsing, pragma handling and
# the shared name-resolution registry live here)
_SHARED_SOURCES = ("core.py", "registry.py")

_SALT_CACHE: Dict[Tuple[str, ...], str] = {}


def _salt_of(files: Tuple[str, ...]) -> str:
    cached = _SALT_CACHE.get(files)
    if cached is not None:
        return cached
    h = hashlib.sha256()
    pkg = os.path.dirname(os.path.abspath(__file__))
    for name in files:
        path = os.path.join(pkg, name)
        h.update(name.encode())
        try:
            with open(path, "rb") as fh:
                h.update(fh.read())
        except OSError:
            h.update(b"<missing>")
    _SALT_CACHE[files] = out = h.hexdigest()
    return out


def _shared_salt() -> str:
    return _salt_of(_SHARED_SOURCES)


def _family_salt(rule: Rule) -> str:
    sources = rule.salt_sources
    if sources is None:
        # conservative fallback: every .py in the package
        pkg = os.path.dirname(os.path.abspath(__file__))
        sources = tuple(
            sorted(n for n in os.listdir(pkg) if n.endswith(".py"))
        )
    return _salt_of(_SHARED_SOURCES + tuple(sources))


def _cache_dir() -> Optional[str]:
    from .. import config

    return config.get("analysis.cache_dir") or None


def _cache_key(display: str, source: bytes) -> str:
    h = hashlib.sha256()
    h.update(_shared_salt().encode())
    h.update(display.encode())
    h.update(b"\0")
    h.update(source)
    return h.hexdigest()


def _cache_load(cache_dir: str, key: str) -> Optional[dict]:
    try:
        with open(os.path.join(cache_dir, key + ".json")) as fh:
            record = json.load(fh)
        return record if record.get("v") == 2 else None
    except (OSError, ValueError):
        return None


def _cache_store(cache_dir: str, key: str, record: dict) -> None:
    # best effort: an unwritable cache degrades to a cold run, never an
    # analysis failure
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = os.path.join(cache_dir, f".{key}.tmp.{os.getpid()}")
        with open(tmp, "w") as fh:
            json.dump(record, fh)
        os.replace(tmp, os.path.join(cache_dir, key + ".json"))
    except OSError:
        pass


def _pragma_to_json(p: _Pragma) -> dict:
    return {
        "line": p.line, "rules": sorted(p.rules), "reason": p.reason,
        "whole_file": p.whole_file, "span": list(p.span), "used": p.used,
    }


def _pragma_from_json(d: dict) -> _Pragma:
    return _Pragma(
        line=d["line"], rules=set(d["rules"]), reason=d["reason"],
        whole_file=d["whole_file"], span=tuple(d["span"]), used=d["used"],
    )


def _analyze_one(
    file_path: str,
    display: str,
    rules: Sequence[Rule],
    cache_dir: Optional[str],
) -> Tuple[List[Finding], List[_Pragma]]:
    """One module through the per-family cache: families whose salt
    matches reuse their cached findings + summary; the module is parsed
    (once) only when at least one family is missing or stale, and only
    THOSE families run on it."""
    with open(file_path, "rb") as fh:
        raw = fh.read()
    key = _cache_key(display, raw) if cache_dir else None
    record = _cache_load(cache_dir, key) if cache_dir else None
    fam_salts = {rule.name: _family_salt(rule) for rule in rules}
    families = dict(record["families"]) if record is not None else {}
    need = [
        rule
        for rule in rules
        if families.get(rule.name, {}).get("salt") != fam_salts[rule.name]
    ]
    if record is not None and not need:
        pragmas = [_pragma_from_json(p) for p in record["pragmas"]]
        base_findings = [Finding(**f) for f in record["base"]]
        for rule in rules:
            loader = getattr(rule, "load_summary", None)
            summary = families[rule.name].get("summary")
            if loader is not None and summary is not None:
                loader(display, summary)
        fresh_names: Set[str] = set()
    else:
        source = raw.decode("utf-8")
        ctx, run_findings = _run_module(
            source, display, need, real_path=file_path
        )
        pragmas = ctx.pragmas if ctx is not None else []
        fresh_names = {rule.name for rule in need}
        base_findings = [
            f for f in run_findings if f.rule not in fresh_names
        ]
        for rule in need:
            entry: dict = {
                "salt": fam_salts[rule.name],
                "findings": [
                    f.__dict__
                    for f in sorted(
                        (f for f in run_findings if f.rule == rule.name),
                        key=lambda f: (f.line, f.col),
                    )
                ],
                "summary": None,
            }
            dumper = getattr(rule, "dump_summary", None)
            if dumper is not None:
                entry["summary"] = dumper(display)
            families[rule.name] = entry
        # salt-valid families NOT re-run still need their summaries live
        for rule in rules:
            if rule.name in fresh_names:
                continue
            loader = getattr(rule, "load_summary", None)
            summary = families.get(rule.name, {}).get("summary")
            if loader is not None and summary is not None:
                loader(display, summary)
        if cache_dir:
            _cache_store(
                cache_dir, key,
                {
                    "v": 2,
                    "pragmas": [_pragma_to_json(p) for p in pragmas],
                    "base": [f.__dict__ for f in base_findings],
                    "families": families,
                },
            )
    module_findings = list(base_findings)
    for rule in rules:
        entry = families.get(rule.name)
        if entry is None:
            continue
        if rule.name in fresh_names:
            module_findings.extend(
                Finding(**f) for f in entry["findings"]
            )
        else:
            cached = [Finding(**f) for f in entry["findings"]]
            # cached findings did not pass through ctx.report this run:
            # replay the suppression match so the pragma `used` flags
            # (the --check-pragmas audit) stay identical to a cold run
            for f in cached:
                if f.suppressed:
                    _suppress_with(pragmas, f.rule, f.line)
            module_findings.extend(cached)
    module_findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return module_findings, pragmas


def analyze_paths(
    paths: Sequence[str],
    rules: Optional[Sequence[Rule]] = None,
    return_pragmas: bool = False,
):
    """Repo walker used by the CLI and the tier-1 gate: per-module rules
    over every ``.py`` under ``paths``, then the whole-program passes
    (lock-order graph, value-flow donation replay) over all of them
    together.  With ``return_pragmas=True`` returns ``(findings,
    pragma_map)`` so the caller can audit stale waivers
    (``--check-pragmas``)."""
    rules = list(rules) if rules is not None else default_rules()
    findings: List[Finding] = []
    pragma_map: Dict[str, List[_Pragma]] = {}
    cache_dir = _cache_dir()
    base = os.getcwd()
    for file_path in iter_py_files(paths):
        display = os.path.relpath(file_path, base)
        if display.startswith(".."):
            display = file_path
        module_findings, pragmas = _analyze_one(
            file_path, display, rules, cache_dir
        )
        findings.extend(module_findings)
        pragma_map[display] = pragmas
    extra = _finalize_rules(rules, pragma_map)
    extra.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    findings.extend(extra)
    if return_pragmas:
        return findings, pragma_map
    return findings


def stale_pragma_findings(
    pragma_map: Dict[str, List[_Pragma]]
) -> List[Finding]:
    """``--check-pragmas``: every suppression pragma that matched ZERO
    findings is itself reported — a waiver that no longer waives
    anything is rot (the code it blessed moved or was fixed), and it
    would silently bless the NEXT violation added near it."""
    out: List[Finding] = []
    for path in sorted(pragma_map):
        for p in pragma_map[path]:
            if p.used or p.reason is None:
                # reasonless pragmas are already reported as
                # pragma-missing-reason; don't double-count them here
                continue
            rules = ", ".join(sorted(p.rules))
            out.append(
                Finding(
                    path, p.line, 0, "stale-pragma",
                    f"suppression pragma allow({rules}) no longer "
                    "suppresses any finding — the violation it waived "
                    "was fixed or moved; delete the pragma (reason was: "
                    f"{p.reason})",
                )
            )
    return out
