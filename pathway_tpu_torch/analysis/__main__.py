"""CLI: ``python -m pathway_tpu_torch.analysis [paths...]`` (counterpart of
``pathway_tpu/analysis/__main__.py``, same flags and exit codes).

Prints one ``path:line:col: rule: message`` diagnostic per unsuppressed
finding and exits 1 if any exist (0 on a clean tree) — the same contract
the tier-1 gate test asserts through the API.  ``--show-suppressed``
audits every pragma allowance alongside the live findings.

Machine-readable output: ``--format json`` emits ONE JSON document
(``{"findings": [...], "live": N, "suppressed": M}`` — the CI-friendly
shape); ``--format jsonl`` (alias: the legacy ``--json`` flag) emits one
JSON record per finding; ``--format sarif`` emits a SARIF 2.1.0 log so
CI can annotate findings directly onto PR diffs (suppressed findings
ride along as SARIF suppressions).  Exit codes are identical across
formats.

``--check-pragmas`` additionally reports every suppression pragma that
no longer suppresses any finding (stale waivers rot: the violation they
blessed was fixed or moved, and a dead pragma silently blesses the NEXT
violation near it).  ``PATHWAY_ANALYSIS_CACHE=<dir>`` arms the
content-hash incremental cache so repo-wide runs re-parse only changed
modules.

The analysis modules themselves are pure stdlib + AST (no torch import),
so the lint runs anywhere — pre-commit, CI boxes with no card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from .core import Finding, analyze_paths, default_rules, stale_pragma_findings

# SARIF severity: every rule here is a correctness gate, so findings map
# to "error"; suppressed ones carry a SARIF suppression object instead
_SARIF_VERSION = "2.1.0"
_SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)


def render_sarif(findings: Sequence[Finding]) -> dict:
    """One SARIF 2.1.0 log for the whole run — deterministic (findings
    arrive sorted), so the golden-file test can assert bytes."""
    rule_ids = sorted({f.rule for f in findings})
    descriptions = {
        rule.name: rule.description for rule in default_rules()
    }
    results = []
    for f in findings:
        result = {
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": f.path.replace("\\", "/"),
                        },
                        "region": {
                            "startLine": max(1, f.line),
                            "startColumn": max(1, f.col + 1),
                        },
                    }
                }
            ],
        }
        if f.suppressed:
            result["suppressions"] = [
                {
                    "kind": "inSource",
                    "justification": f.reason or "",
                }
            ]
        results.append(result)
    return {
        "$schema": _SARIF_SCHEMA,
        "version": _SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "pathway-analysis",
                        "informationUri": (
                            "python -m pathway_tpu_torch.analysis"
                        ),
                        "rules": [
                            {
                                "id": rid,
                                "shortDescription": {
                                    "text": descriptions.get(rid, rid)
                                },
                            }
                            for rid in rule_ids
                        ],
                    }
                },
                "results": results,
            }
        ],
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pathway_tpu_torch.analysis",
        description="Hot-path lint: lock-discipline, hidden-sync, "
        "recompile-hazard, lock-order, value-flow, knob-discipline.",
    )
    parser.add_argument(
        "paths", nargs="*", default=["pathway_tpu_torch"],
        help="files or directories to analyze (default: pathway_tpu_torch)",
    )
    parser.add_argument(
        "--show-suppressed", action="store_true",
        help="also print suppressed findings with their pragma reasons",
    )
    parser.add_argument(
        "--check-pragmas", action="store_true",
        help="also report suppression pragmas that no longer suppress "
        "any finding (stale waivers)",
    )
    parser.add_argument(
        "--format", choices=("text", "json", "jsonl", "sarif"),
        default="text", dest="fmt",
        help="output format: human text (default), one JSON document "
        "(json), one JSON record per finding (jsonl), or a SARIF 2.1.0 "
        "log for CI diff annotation (sarif)",
    )
    parser.add_argument(
        "--json", action="store_const", const="jsonl", dest="fmt",
        help="legacy alias for --format jsonl",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule names + descriptions and exit",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in default_rules():
            print(f"{rule.name}: {rule.description}")
        return 0

    findings, pragma_map = analyze_paths(args.paths, return_pragmas=True)
    if args.check_pragmas:
        findings = list(findings) + stale_pragma_findings(pragma_map)
    live = [f for f in findings if not f.suppressed]
    n_sup = len(findings) - len(live)
    if args.fmt == "sarif":
        print(json.dumps(render_sarif(findings), indent=1, sort_keys=True))
        return 1 if live else 0
    if args.fmt == "json":
        # one complete document: what a CI step or the tier-1 gate wants
        # to parse — every finding (suppressed ones carry their reason),
        # plus the counts the exit code is derived from
        print(
            json.dumps(
                {
                    "findings": [f.__dict__ for f in findings],
                    "live": len(live),
                    "suppressed": n_sup,
                }
            )
        )
        return 1 if live else 0
    shown = findings if args.show_suppressed else live
    for f in shown:
        if args.fmt == "jsonl":
            print(json.dumps(f.__dict__))
        else:
            print(f.format())
    print(
        f"{len(live)} finding{'s' if len(live) != 1 else ''} "
        f"({n_sup} suppressed)",
        file=sys.stderr,
    )
    return 1 if live else 0


if __name__ == "__main__":
    sys.exit(main())
