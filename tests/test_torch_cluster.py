"""The port's multi-process engine against the reference's one-process
rows, on the CPU.

Two ranks of ``tests/torch_dist_worker.py`` run each scenario of the
reference's ``tests/test_distributed.py`` on the port's ``pw`` (torch
only, gloo and the exchange plane over localhost): the engine wordcount,
a live ``fs`` stream read by partitioned readers with an exactly-once
sink, the REST front on rank 0, a partitioned ``AsyncTransformer``, a
temporal ``windowby``, a ``DataIndex`` over a full-probe IVF and over a
mesh index spanning the ranks (with the fused serve path over that
mesh), a SIGKILL of one rank then a restart of the whole cluster from
its ``rank{N}/`` snapshots in both persistence modes, and a SIGSTOPped
rank detected within the heartbeat timeout.  Each scenario's rows are
held against the same pipeline run by the reference (``pathway_tpu``) in
this process.  Every spawn has its own timeout: a hung rank fails its
test and is killed.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.io import _connector as ref_connector
from pathway_tpu_torch.io import _connector as port_connector

from .test_recovery_e2e import final_counts, write_part
from .torch_dist_worker import (
    INDEX_DIM,
    _Doubled,
    captured,
    fused_mesh_serve,
    index_answers,
    index_tables,
    windowed,
    wordcount,
)

_ROOT = Path(__file__).resolve().parents[1]
_WORKER = Path(__file__).resolve().with_name("torch_dist_worker.py")
_SPAWN_TIMEOUT_S = 120.0
WORDS = ["alpha", "beta", "gamma", "delta", "epsilon"]


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setattr(ref_connector, "_source_counter", [0])
    monkeypatch.setattr(port_connector, "_source_counter", [0])
    pathway_tpu.reset()
    pathway_tpu_torch.reset()
    yield
    pathway_tpu.reset()
    pathway_tpu_torch.reset()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(scenario: str, env_extra=None, processes: int = 2):
    """Start the ranks without waiting (live tests write files and kill
    ranks while the cluster runs)."""
    port = _free_port()
    procs = []
    for pid in range(processes):
        env = dict(os.environ)
        env.pop("PYTEST_CURRENT_TEST", None)
        env.update(
            PATHWAY_PROCESSES=str(processes),
            PATHWAY_PROCESS_ID=str(pid),
            PATHWAY_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            PYTHONPATH=str(_ROOT),
            OMP_NUM_THREADS="1",
        )
        env.update(env_extra or {})
        procs.append(subprocess.Popen(
            [sys.executable, str(_WORKER), scenario], cwd=_ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    return procs


def _collect(procs, timeout: float = _SPAWN_TIMEOUT_S):
    """Each rank's RESULT, by rank; past ``timeout`` every rank is killed
    and the test fails with their output."""
    deadline = time.monotonic() + timeout
    results, failures = [], []
    for pid, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            status = f"rc={proc.returncode}"
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            out, err = proc.communicate()
            status = "TIMEOUT"
        payload = next((json.loads(line[7:]) for line in out.splitlines() if line.startswith("RESULT ")), None)
        if status != "rc=0" or payload is None:
            failures.append(f"rank {pid} {status}\nstdout:\n{out[-2000:]}\nstderr:\n{err[-3000:]}")
        results.append(payload)
    assert not failures, "\n\n".join(failures)
    for r in results:
        assert not r["jax_loaded"]
    return results


def _spawn(scenario: str, env_extra=None):
    return _collect(_launch(scenario, env_extra))


def _kill_all(procs) -> None:
    for p in procs:
        try:
            p.send_signal(signal.SIGCONT)
        except OSError:
            pass
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.communicate(timeout=10)
        except Exception:  # noqa: BLE001 - teardown of killed ranks
            pass


def test_engine_wordcount_equals_the_reference():
    """``pw.run`` joins the cluster; each rank reduces its owned groups
    (no rank holds all of them) and the union is the reference's rows."""
    ref = wordcount(pathway_tpu)
    pathway_tpu.run(monitoring_level=None)
    keys, cols = ref._materialize()
    want = sorted([str(cols["word"][i]), int(cols["total"][i])] for i in range(len(keys)))
    results = _spawn("engine")
    assert [r["proc"] for r in results] == [0, 1]
    for r in results:
        assert r["nproc"] == 2 and r["rows"] == want
        assert r["local_rows"] < len(want)
    assert sum(r["local_rows"] for r in results) == len(want)


def _emit(data_dir, truth: Counter, part: int, n: int) -> None:
    batch = [WORDS[(part * 7 + i) % len(WORDS)] for i in range(n)]
    truth.update(batch)
    write_part(str(data_dir), part, batch)


def _reference_counts(data_dir) -> Counter:
    """The reference's one-process wordcount over the same files."""
    pw = pathway_tpu
    pw.reset()

    class Row(pw.Schema):
        word: str

    docs = pw.io.csv.read(str(data_dir), schema=Row, mode="static")
    counts = docs.groupby(docs.word).reduce(word=docs.word, count=pw.reducers.count())
    pw.run(monitoring_level=None)
    keys, cols = counts._materialize()
    pw.reset()
    return Counter({str(cols["word"][i]): int(cols["count"][i]) for i in range(len(keys))})


def _wait_progress(procs, out_csv: str, at_least: int, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if sum(final_counts(out_csv).values()) >= at_least:
            return
        assert all(p.poll() is None for p in procs), "a rank died early"
        time.sleep(0.1)
    raise AssertionError(f"no progress: {sum(final_counts(out_csv).values())} rows of {at_least}")


def test_live_fs_stream_is_exactly_once(tmp_path):
    """Files written while the cluster runs: each rank reads its split,
    rows go to their key owners, and the one sink on rank 0 counts every
    row once: the reference's counts over the same files."""
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    out_csv = str(tmp_path / "out.csv")
    truth: Counter = Counter()
    _emit(data_dir, truth, 0, 30)
    _emit(data_dir, truth, 1, 30)
    procs = _launch("live_stream", {"DIST_DATA_DIR": str(data_dir), "DIST_OUT": out_csv,
                                    "DIST_EXPECTED_TOTAL": "100"})
    try:
        _wait_progress(procs, out_csv, 60)
        _emit(data_dir, truth, 2, 20)
        time.sleep(0.3)
        _emit(data_dir, truth, 3, 20)
        results = _collect(procs)
    finally:
        _kill_all(procs)
    assert [r["proc"] for r in results] == [0, 1]
    got = final_counts(out_csv)
    assert got == truth == _reference_counts(data_dir)


def test_rest_front_on_rank_zero_answers_like_the_reference():
    """Rank 0 binds the front (rank 1 registers no server), the queries
    reach both ranks and the answers come back through rank 0: the
    reference's ``value * 2`` rows over the same values."""
    pw = pathway_tpu
    values = list(range(6))
    table = pw.debug.table_from_rows(pw.schema_from_types(value=int), [(v,) for v in values])
    ref = table.select(result=pw.this.value * 2)
    pw.run(monitoring_level=None)
    _keys, cols = ref._materialize()
    want = sorted(int(v) for v in cols["result"])

    port = _free_port()
    procs = _launch("rest", {"DIST_REST_PORT": str(port), "DIST_REST_EXPECTED": str(len(values))})
    try:
        got = {}
        deadline = time.monotonic() + 60
        while len(got) < len(values) and time.monotonic() < deadline:
            v = len(got)
            try:
                req = urllib.request.Request(f"http://127.0.0.1:{port}/", data=json.dumps({"value": v}).encode())
                with urllib.request.urlopen(req, timeout=5) as resp:
                    got[v] = json.loads(resp.read())
            except Exception:  # noqa: BLE001 - the server is not up yet
                assert all(p.poll() is None for p in procs), "a rank died early"
                time.sleep(0.2)
        assert sorted(got.values()) == want
        results = _collect(procs, timeout=60)
    finally:
        _kill_all(procs)
    assert results[0]["served"] >= len(values)
    assert results[0]["servers"] == 1 and results[1]["servers"] == 0


def test_async_transformer_partitioned_loopback_equals_the_reference():
    """``invoke`` runs once per row on rank 0, the results go back to
    their key owners (neither rank holds all of them), and the union is
    the reference's rows."""
    ref = _Doubled.build(pathway_tpu)
    pathway_tpu.run(monitoring_level=None, commit_duration_ms=50)
    keys, cols = ref._materialize()
    want = sorted([str(cols["word"][i]), int(cols["doubled"][i])] for i in range(len(keys)))
    results = _spawn("async_transformer")
    for r in results:
        assert r["rows"] == want
    assert sum(r["local_rows"] for r in results) == len(want)
    assert all(r["local_rows"] < len(want) for r in results)


def test_temporal_windowby_equals_the_reference():
    ref = windowed(pathway_tpu)
    pathway_tpu.run(monitoring_level=None)
    keys, cols = ref._materialize()
    want = sorted([int(cols["start"][i]), int(cols["total"][i])] for i in range(len(keys)))
    assert want == [[0, 3], [4, 7], [8, 5], [12, 6]]
    for r in _spawn("temporal"):
        assert r["rows"] == want


def _reference_index_answers(kind: str) -> dict:
    pw = pathway_tpu
    docs, queries = index_tables(pw)
    mod = pw.stdlib.indexing
    factory = (mod.IvfKnnFactory(dimension=INDEX_DIM, n_clusters=4, n_probe=4) if kind == "ivf"
               else mod.TpuKnnFactory(dimension=INDEX_DIM))
    rows = captured(pw, index_answers(pw, factory, docs, queries), 0)
    pw.run(monitoring_level=None)
    pw.reset()
    return rows


def _port_one_process_mesh_answers() -> dict:
    from pathway_tpu_torch.parallel.mesh import make_mesh

    pw = pathway_tpu_torch
    docs, queries = index_tables(pw)
    factory = pw.stdlib.indexing.TpuKnnFactory(dimension=INDEX_DIM, mesh=make_mesh(8, 1, devices=["cpu"] * 8))
    rows = captured(pw, index_answers(pw, factory, docs, queries), 0)
    pw.run(monitoring_level=None)
    pw.reset()
    return rows


def _same_hits(got: dict, want: dict, atol: float = 1e-5) -> None:
    assert sorted(got) == sorted(want)
    for q in want:
        assert got[q][0] == want[q][0], q
        g = np.asarray(got[q][1], np.uint32).view(np.float32)
        w = np.asarray(want[q][1], np.uint32).view(np.float32)
        np.testing.assert_allclose(g, w, atol=atol)


def test_data_index_over_ivf_and_a_cross_process_mesh_equals_the_reference():
    """A full-probe IVF (each rank holds every row) and a ``TpuKnnFactory``
    index over 2 x 4 CPU shards: the answers rank 0's sink sees are the
    reference's (names equal, scores within 1e-5), and the mesh's are the
    port's one-process 8-shard mesh's bit for bit.  The fused serve path
    over the cross-process mesh equals one process's 8-shard mesh bit for
    bit on both ranks, in one dispatch and one fetch per stage-1 serve
    (the key planes' collective runs inside the dispatch)."""
    from pathway_tpu_torch.parallel.mesh import make_mesh

    want_ivf = _reference_index_answers("ivf")
    want_mesh = _reference_index_answers("tpu")
    one_mesh = _port_one_process_mesh_answers()
    serve_rows, serve_counts = fused_mesh_serve(make_mesh(8, 1, devices=["cpu"] * 8))
    results = _spawn("data_index")
    r0, r1 = results
    assert r0["index_rows"] == r1["index_rows"] == [120, 120]
    assert r1["ivf"] == {} and r1["mesh"] == {}, "rank 1's sink saw rows"
    _same_hits(r0["ivf"], want_ivf)
    _same_hits(r0["mesh"], want_mesh)
    assert r0["mesh"] == one_mesh
    for r in results:
        assert r["serve"] == serve_rows
        assert r["serve_counts"] == serve_counts == [1, 1]


@pytest.mark.parametrize("mode", ["PERSISTING", "OPERATOR_PERSISTING"])
def test_sigkill_of_one_rank_then_a_whole_restart_is_exactly_once(tmp_path, mode):
    """Kill rank 1 mid-stream: rank 0 exits non-zero (worker-panic
    propagation); a restart of the whole cluster from the per-rank
    ``rank{N}/`` snapshots gives the exactly-once counts, the reference's
    over the same files."""
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    out_csv = str(tmp_path / "out.csv")
    store = tmp_path / "snapshots"
    truth: Counter = Counter()
    env = {
        "DIST_DATA_DIR": str(data_dir), "DIST_OUT": out_csv, "DIST_EXPECTED_TOTAL": str(10**9),
        "PATHWAY_PERSISTENT_STORAGE": str(store), "PATHWAY_PERSISTENCE_MODE": mode,
        "PATHWAY_SNAPSHOT_INTERVAL_MS": "100",
    }
    _emit(data_dir, truth, 0, 40)
    _emit(data_dir, truth, 1, 40)
    procs = _launch("live_stream", env)
    try:
        _wait_progress(procs, out_csv, 80)
        time.sleep(0.4)  # a snapshot interval
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait()
        t0 = time.monotonic()
        while time.monotonic() - t0 < 30 and procs[0].poll() is None:
            time.sleep(0.1)
        assert procs[0].poll() is not None, "rank 0 kept running without its peer"
        assert procs[0].returncode != 0
        assert sorted(p.name for p in store.iterdir()) == ["rank0", "rank1"]
        if mode == "OPERATOR_PERSISTING":
            assert list(store.glob("rank*/operators/*")), "no operator snapshots before the kill"
        _emit(data_dir, truth, 2, 40)
        _emit(data_dir, truth, 3, 40)
        env["DIST_EXPECTED_TOTAL"] = str(sum(truth.values()))
        procs = _launch("live_stream", env)
        results = _collect(procs)
    finally:
        _kill_all(procs)
    assert [r["proc"] for r in results] == [0, 1]
    assert final_counts(out_csv) == truth == _reference_counts(data_dir)


def test_sigstop_of_one_rank_is_detected_within_the_heartbeat_timeout(tmp_path):
    """A rank that hangs without dying (SIGSTOP: no TCP reset) is caught by
    the heartbeat (the reference's knobs: 0.5 s, timeout 4 s): rank 0
    exits with the lost-peer status well inside the 20 s the reference
    allows, naming the silent peer."""
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    out_csv = str(tmp_path / "out.csv")
    truth: Counter = Counter()
    _emit(data_dir, truth, 0, 40)
    _emit(data_dir, truth, 1, 40)
    procs = _launch("live_stream", {
        "DIST_DATA_DIR": str(data_dir), "DIST_OUT": out_csv, "DIST_EXPECTED_TOTAL": str(10**9),
        "PATHWAY_EXCHANGE_HEARTBEAT": "0.5", "PATHWAY_EXCHANGE_HEARTBEAT_TIMEOUT": "4.0",
    })
    try:
        _wait_progress(procs, out_csv, 80)
        procs[1].send_signal(signal.SIGSTOP)
        t0 = time.monotonic()
        while time.monotonic() - t0 < 20 and procs[0].poll() is None:
            time.sleep(0.1)
        detect_s = time.monotonic() - t0
        assert procs[0].poll() is not None, f"rank 0 still blocked {detect_s:.1f} s after its peer hung"
        assert procs[0].returncode == 70
        err = procs[0].stderr.read()
        assert "silent" in err or "PeerLost" in err or "heartbeat" in err, err[-2000:]
    finally:
        _kill_all(procs)
