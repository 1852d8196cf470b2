"""The port's bench-trajectory comparator (``pathway_tpu_torch/bench_compare.py``)
against the reference's: the four comparator cases of
``tests/test_bench_compare.py`` run on both packages, with the same
directions, flattened metrics, flagged moves, report lines and exit
codes on the same records."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from pathway_tpu import bench_compare as ref
from pathway_tpu_torch import bench_compare as port

from .utils import REPO_ROOT

PACKAGES = {"reference": ref, "port": port}


def _record(round_no: int, **extras):
    return {
        "schema": 1,
        "round": round_no,
        "created_unix": 1700000000.0 + round_no,
        "metric": "retrieval_p50_device_ms_1M",
        "value": extras.pop("value", 10.0),
        "unit": "ms",
        "vs_baseline": 5.0,
        "backend": "cpu",
        "extras": extras,
    }


_NAMES = [
    "retrieval_p50_ms", "profiling_overhead_pct", "trace_p50_on_ms", "serve_p99_e2e_ms", "ingest_docs_per_sec",
    "serve_coalesce_speedup_c16", "rag_eval_accuracy", "stage2_flop_reduction_x", "vs_baseline", "index_docs",
    "hbm_ledger_bytes", "max_abs_err", "lag_seconds", "dedup_rate", "hit_ratio", "busy_fraction", "tokens_per_s",
    "dropped", "failures", "worker_errors", "queue_wait_ms", "mrr", "recall_at_10",
]


@pytest.mark.parametrize("side", PACKAGES)
def test_direction_inference_follows_naming_convention(side):
    bc = PACKAGES[side]
    assert bc.direction_of("retrieval_p50_ms") == "lower"
    assert bc.direction_of("profiling_overhead_pct") == "lower"
    assert bc.direction_of("trace_p50_on_ms") == "lower"
    assert bc.direction_of("serve_p99_e2e_ms") == "lower"
    assert bc.direction_of("ingest_docs_per_sec") == "higher"
    assert bc.direction_of("serve_coalesce_speedup_c16") == "higher"
    assert bc.direction_of("rag_eval_accuracy") == "higher"
    assert bc.direction_of("stage2_flop_reduction_x") == "higher"
    assert bc.direction_of("vs_baseline") == "higher"
    assert bc.direction_of("index_docs") is None
    assert bc.direction_of("hbm_ledger_bytes") is None
    assert [port.direction_of(n) for n in _NAMES] == [ref.direction_of(n) for n in _NAMES]


@pytest.mark.parametrize("side", PACKAGES)
def test_flatten_skips_bookkeeping_and_nested_numerics(side):
    bc = PACKAGES[side]
    record = _record(12, qps=100.0, nested={"p99_ms": 5.0, "name": "x", "flag": True, "nan": float("nan")})
    flat = bc.flatten_metrics(record)
    assert flat["extras.qps"] == 100.0
    assert flat["extras.nested.p99_ms"] == 5.0
    assert "round" not in flat and "schema" not in flat
    assert "extras.nested.name" not in flat and "extras.nested.flag" not in flat and "extras.nested.nan" not in flat
    assert flat == ref.flatten_metrics(record)


@pytest.mark.parametrize("side", PACKAGES)
def test_regression_flagged_only_past_threshold_and_in_bad_direction(side):
    bc = PACKAGES[side]
    older = _record(12, serve_qps=100.0, serve_p50_ms=10.0, zero_ms=0.0)
    newer = _record(13, serve_qps=85.0, serve_p50_ms=10.5, zero_ms=3.0)
    regressions, improvements = bc.compare_records(older, newer, threshold=0.10)
    assert [r["metric"] for r in regressions] == ["extras.serve_qps"]
    assert regressions[0]["change_pct"] == -15.0
    assert improvements == []
    regressions, improvements = bc.compare_records(newer, older, threshold=0.10)
    assert regressions == []
    # a move from a zero base is never flagged; one to zero is
    assert [r["metric"] for r in improvements] == ["extras.serve_qps", "extras.zero_ms"]
    for threshold in (0.01, 0.10, 0.5):
        assert bc.compare_records(older, newer, threshold) == ref.compare_records(older, newer, threshold)


@pytest.mark.parametrize("side", PACKAGES)
def test_cli_exit_codes_and_report(side, tmp_path, capsys):
    bc = PACKAGES[side]
    a = tmp_path / "BENCH_12.json"
    b = tmp_path / "BENCH_13.json"
    a.write_text(json.dumps(_record(12, serve_qps=100.0)))
    b.write_text(json.dumps(_record(13, serve_qps=50.0)))
    assert bc.main([str(b), str(a)]) == 1  # records sort by round, not by the command line
    out = capsys.readouterr().out
    assert "REGRESSION extras.serve_qps" in out
    assert bc.main([str(a), str(b), "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["comparisons"][0]["regressions"][0]["metric"] == "extras.serve_qps"
    b.write_text(json.dumps(_record(13, serve_qps=101.0)))
    assert bc.main([str(a), str(b)]) == 0
    assert bc.main([str(a)]) == 0
    assert "trajectory seeded" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        bc.main([str(tmp_path / "BENCH_nope.json")])
    assert exc.value.code == 2
    assert "cannot read" in capsys.readouterr().err
    (tmp_path / "BENCH_14.json").write_text("[1, 2]")
    with pytest.raises(SystemExit) as exc:
        bc.main([str(a), str(tmp_path / "BENCH_14.json")])
    assert exc.value.code == 2


def test_cli_prints_the_references_report(tmp_path):
    """``python -m`` of both packages on the same records: the same
    exit code and the same report."""
    paths = []
    for r, qps in ((12, 100.0), (13, 50.0), (14, 80.0)):
        path = tmp_path / f"BENCH_{r}.json"
        path.write_text(json.dumps(_record(r, serve_qps=qps, serve_p50_ms=10.0 + r)))
        paths.append(str(path))
    runs = {}
    for side, module in (("reference", "pathway_tpu.bench_compare"), ("port", "pathway_tpu_torch.bench_compare")):
        runs[side] = subprocess.run([sys.executable, "-m", module, *paths, "--threshold", "0.2"], cwd=REPO_ROOT,
                                    capture_output=True, text=True, timeout=120)
    assert runs["port"].returncode == runs["reference"].returncode == 1
    assert runs["port"].stdout == runs["reference"].stdout
    assert "REGRESSION extras.serve_qps" in runs["port"].stdout
