#!/usr/bin/env python3
"""Seconds per phase of ``chip_smoke.py`` runs, read from their output.

    python3 chip_smoke.py > run.log 2>&1
    python3 tools/phase_times.py run.log [more logs]
    python3 chip_smoke.py 2>&1 | python3 tools/phase_times.py --stamp > run.log

prints a markdown table with one column per log.  Phases 10-28 report
their own seconds (the line that ends each one); phases 1-9 report none,
so their row is the script's total less the phases after them.  A line
may carry a leading ``<seconds><tab>`` stamp, which is ignored here;
``--stamp`` writes its standard input with that stamp (seconds since it
started) before each line, so the time between two lines of a phase is
read from the log.
"""

from __future__ import annotations

import os
import re
import sys
import time

# the line that ends each phase, and its seconds in group 1
ENDS = [
    ("10 decode", r"decode phase .*; ([\d.]+) s$"),
    ("11 live ingest", r"shed A/B .*; phase ([\d.]+) s$"),
    ("12 warm state", r"warm state, the 1M .*; phase ([\d.]+) s$"),
    ("13 tuner", r"self-tuning .*; phase ([\d.]+) s$"),
    ("14 operator plane", r"in-place-write guard.*; phase ([\d.]+) s$"),
    ("15 real weights", r"phase 15 in ([\d.]+) s$"),
    ("16 sharded", r"phase 16 in ([\d.]+) s$"),
    ("17 multi-process", r"phase 17 in ([\d.]+) s$"),
    ("18 fabric", r"phase 18 in ([\d.]+) s$"),
    ("19 framework", r"; phase 19 ([\d.]+) s$"),
    ("20 qa", r"^phase 20 ([\d.]+) s$"),
    ("21 persist", r"; phase 21 ([\d.]+) s$"),
    ("22 temporal", r"; phase 22 ([\d.]+) s$"),
    ("23 hostapi", r"; phase 23 ([\d.]+) s$"),
    ("24 cluster", r"; phase 24 ([\d.]+) s \(the cluster arm [\d.]+ s\)$"),
    ("25 connectors", r": phase 25 ([\d.]+) s$"),
    ("26 analysis", r": phase 26 ([\d.]+) s \(worker"),
    ("27 native", r": phase 27 ([\d.]+) s$"),
    ("28 surface", r"; phase 28 ([\d.]+) s$"),
]
TOTAL = r"chip_smoke: all phases passed in ([\d.]+) s$"
EARLY = "1-9 (total less the rest)"


def phase_seconds(log_path: str) -> dict[str, float]:
    with open(log_path, errors="replace") as f:
        lines = [re.sub(r"^[\d.]+\t", "", raw.rstrip("\n")) for raw in f]
    out = {}
    for name, pattern in ENDS + [("total", TOTAL)]:
        rx = re.compile(pattern)
        hits = [float(m.group(1)) for m in map(rx.search, lines) if m]
        if hits:
            out[name] = hits[0]
    if "total" in out:
        out[EARLY] = round(out["total"] - sum(v for k, v in out.items() if k != "total"), 1)
    return out


def table(paths: list[str]) -> str:
    cols = [phase_seconds(p) for p in paths]
    rows = ["| phase | " + " | ".join(os.path.basename(p) for p in paths) + " |",
            "| --- |" + " --- |" * len(paths)]
    for name in [EARLY] + [name for name, _ in ENDS] + ["total"]:
        rows.append(f"| {name} | " + " | ".join(str(c.get(name, "")) for c in cols) + " |")
    return "\n".join(rows)


def stamp(lines, out) -> None:
    t0 = time.perf_counter()
    for line in lines:
        out.write(f"{time.perf_counter() - t0:.1f}\t{line}")
        out.flush()


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    if sys.argv[1:] == ["--stamp"]:
        stamp(sys.stdin, sys.stdout)
    else:
        print(table(sys.argv[1:]))
