"""Bench-trajectory comparator of the port (counterpart of
``pathway_tpu/bench_compare.py``, standard library only):

    python -m pathway_tpu_torch.bench_compare BENCH_*.json [--threshold 0.10] [--json]

A bench writes one versioned record per round (``BENCH_12.json``,
``BENCH_13.json``, ...).  This module diffs consecutive records, in the
order of their ``round``, and flags any metric that REGRESSED by more
than the threshold (default 10%), so a perf cliff between rounds is a
red exit code instead of an unnoticed drift.

Metric direction is inferred from the name:

- lower-is-better: ``*_ms``, ``*_seconds``, latency percentiles
  (``p50``/``p95``/``p99``), ``*_overhead_pct``, ``*_agreement_pct``,
  anything spelled ``latency``/``lag``/``wait``, absolute errors, drops,
  failures and errors;
- higher-is-better: ``*_per_s(ec)``, ``qps``, ``*_speedup*``,
  ``accuracy``, ``mrr``, ``*_rate`` and ``*_ratio``, ``*_reduction_x``,
  ``compression``, ``vs_baseline``, ``*fraction``, ``tokens_per*``;
- everything else (counts, byte sizes, configuration echoes) is
  informational and never flagged.

Exit code: 0 = no regressions, 1 = at least one flagged regression,
2 = usage error (no or unreadable records).
"""

from __future__ import annotations

import argparse
import json
import math
import re
import sys
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["compare_records", "direction_of", "flatten_metrics", "main"]

_LOWER_RE = re.compile(
    r"(_ms$|_ms_|_seconds$|(^|_)p(50|95|99)(_|$)|overhead|latency|lag"
    r"|_wait|agreement_pct|abs_err|drops?(_|$)|dropped|failures?(_|$)"
    r"|_errors?(_|$))"
)
_HIGHER_RE = re.compile(
    r"(per_s(ec)?$|per_sec_|qps|speedup|accuracy|(^|_)mrr|_rate$|_ratio$"
    r"|reduction|compression|vs_baseline|fraction$|tokens_per)"
)


def direction_of(name: str) -> Optional[str]:
    """'lower' / 'higher' / None (informational) for one metric name."""
    n = name.lower()
    if _LOWER_RE.search(n):
        return "lower"
    if _HIGHER_RE.search(n):
        return "higher"
    return None


def flatten_metrics(record: Dict[str, Any]) -> Dict[str, float]:
    """Every numeric leaf of a bench record, dotted-flattened
    (``extras.serve_cache.qps`` style).  Non-numeric leaves, nulls, and
    bookkeeping keys are skipped."""
    skip = {"schema", "round", "created_unix", "elapsed_s", "partial"}
    out: Dict[str, float] = {}

    def walk(prefix: str, value: Any) -> None:
        if isinstance(value, dict):
            for k, v in value.items():
                if not prefix and k in skip:
                    continue
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        elif isinstance(value, bool):
            return
        elif isinstance(value, (int, float)) and math.isfinite(value):
            out[prefix] = float(value)

    walk("", record)
    return out


def compare_records(
    older: Dict[str, Any],
    newer: Dict[str, Any],
    threshold: float = 0.10,
) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """(regressions, improvements) between two records: metrics present
    in both, with a direction, whose relative change crosses
    ``threshold`` the wrong / right way."""
    a = flatten_metrics(older)
    b = flatten_metrics(newer)
    regressions: List[Dict[str, Any]] = []
    improvements: List[Dict[str, Any]] = []
    for name in sorted(set(a) & set(b)):
        direction = direction_of(name)
        if direction is None:
            continue
        old, new = a[name], b[name]
        if old == 0.0:
            continue  # no meaningful relative change from a zero base
        change = (new - old) / abs(old)
        worse = change > 0 if direction == "lower" else change < 0
        row = {
            "metric": name,
            "direction": direction,
            "old": old,
            "new": new,
            "change_pct": round(change * 100.0, 2),
        }
        if abs(change) <= threshold:
            continue
        (regressions if worse else improvements).append(row)
    return regressions, improvements


def _round_key(record: Dict[str, Any], path: str) -> Tuple[int, str]:
    rnd = record.get("round")
    if isinstance(rnd, int):
        return (rnd, path)
    m = re.search(r"(\d+)", str(rnd) if rnd is not None else path)
    return (int(m.group(1)) if m else 0, path)


def _usage_error(message: str) -> SystemExit:
    """Exit 2 (usage error) — distinct from exit 1 (flagged regression),
    so a CI gate never misreads a mistyped path as a perf cliff."""
    print(f"bench_compare: {message}", file=sys.stderr)
    return SystemExit(2)


def _load(paths: List[str]) -> Iterator[Tuple[str, Dict[str, Any]]]:
    for path in paths:
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, json.JSONDecodeError) as exc:
            raise _usage_error(f"cannot read {path}: {exc}")
        if not isinstance(doc, dict):
            raise _usage_error(f"{path} is not a record object")
        yield path, doc


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pathway_tpu_torch.bench_compare",
        description=(
            "Diff versioned bench records (BENCH_*.json) and flag "
            "metric regressions beyond the threshold."
        ),
    )
    parser.add_argument("records", nargs="+", help="BENCH_*.json paths")
    parser.add_argument(
        "--threshold",
        type=float,
        default=0.10,
        help="relative-change flag threshold (default 0.10 = 10%%)",
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable report"
    )
    args = parser.parse_args(argv)

    loaded = sorted(
        _load(args.records), key=lambda kv: _round_key(kv[1], kv[0])
    )
    if len(loaded) < 2:
        path, doc = loaded[0]
        n = len(flatten_metrics(doc))
        print(
            f"bench_compare: 1 record ({path}, round "
            f"{doc.get('round', '?')}, {n} numeric metrics) — trajectory "
            "seeded; comparisons start with the next round's record."
        )
        return 0

    any_regression = False
    report = []
    for (path_a, a), (path_b, b) in zip(loaded, loaded[1:]):
        regressions, improvements = compare_records(
            a, b, threshold=args.threshold
        )
        any_regression = any_regression or bool(regressions)
        report.append(
            {
                "older": path_a,
                "newer": path_b,
                "regressions": regressions,
                "improvements": improvements,
            }
        )
        if args.json:
            continue
        print(f"{path_a} -> {path_b}:")
        if not regressions and not improvements:
            print(
                f"  no metric moved more than {args.threshold:.0%} "
                "in either direction"
            )
        for row in regressions:
            print(
                f"  REGRESSION {row['metric']}: {row['old']:g} -> "
                f"{row['new']:g} ({row['change_pct']:+.1f}%, "
                f"{row['direction']}-is-better)"
            )
        for row in improvements:
            print(
                f"  improved   {row['metric']}: {row['old']:g} -> "
                f"{row['new']:g} ({row['change_pct']:+.1f}%)"
            )
    if args.json:
        print(json.dumps({"comparisons": report}, indent=1))
    return 1 if any_regression else 0


if __name__ == "__main__":
    sys.exit(main())
