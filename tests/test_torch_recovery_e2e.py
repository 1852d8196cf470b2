"""Crash recovery of the port end to end (counterpart of
``tests/test_recovery_e2e.py``; reference: integration_tests/wordcount/
test_recovery.py): SIGKILL a persistent streaming wordcount
(``tests/torch_recovery_worker.py``) after its snapshots are on disk,
write more input while it is down, restart it, and check that the sink's
final counts are exactly the input's.  Then ``python -m
pathway_tpu_torch.cli replay`` over the same store answers the same
counts, and a torn tail of the log rewinds without a crash.
"""

from __future__ import annotations

import csv
import os
import signal
import subprocess
import sys
import time
from collections import Counter

from .utils import REPO_ROOT

WORDS = ["alpha", "beta", "gamma", "delta"]


def write_part(data_dir: str, part: int, words: list) -> None:
    path = os.path.join(data_dir, f"part{part:02d}.csv")
    tmp = os.path.join(os.path.dirname(data_dir), f"part{part:02d}.csv.part")  # outside the watched directory
    with open(tmp, "w") as f:
        f.write("word\n")
        for w in words:
            f.write(w + "\n")
    os.rename(tmp, path)  # atomic: the watcher never sees a torn file


def final_counts(out_csv: str) -> Counter:
    """Latest positive row per word = its current count (the csv sink
    writes an update stream with time / diff columns)."""
    if not os.path.exists(out_csv):
        return Counter()
    latest: dict = {}
    with open(out_csv) as f:
        for row in csv.DictReader(f):
            key = row["word"]
            t, diff = int(row["time"]), int(row["diff"])
            prev = latest.get(key)
            if prev is None or t >= prev[0]:
                if diff > 0:
                    latest[key] = (t, int(row["count"]))
                elif prev is not None and t > prev[0]:
                    latest[key] = (t, None)
    return Counter({k: c for k, (_t, c) in latest.items() if c is not None})


def _env(tmp_path, out_csv: str, mode: str = "streaming") -> dict:
    env = dict(os.environ)
    env.update(
        RECOVERY_DATA_DIR=str(tmp_path / "data"),
        RECOVERY_OUT=out_csv,
        RECOVERY_MODE=mode,
        PATHWAY_PERSISTENT_STORAGE=str(tmp_path / "snapshots"),
        PATHWAY_PERSISTENCE_MODE="PERSISTING",
        PATHWAY_SNAPSHOT_INTERVAL_MS="150",
        PYTHONPATH=REPO_ROOT,
    )
    return env


def spawn(env: dict) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, os.path.join(REPO_ROOT, "tests", "torch_recovery_worker.py")],
        cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def _wait(proc, pred, timeout_s: float, what: str) -> None:
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if pred():
            return
        if proc.poll() is not None:
            _, err = proc.communicate()
            raise AssertionError(f"worker died while waiting for {what}:\n{err[-3000:]}")
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _commits(store: str) -> int:
    meta = os.path.join(store, "sources", "wc_input", "METADATA")
    return os.path.getmtime(meta) if os.path.exists(meta) else 0


def test_sigkill_midstream_then_resume_exactly_once(tmp_path):
    (tmp_path / "data").mkdir()
    out_csv = str(tmp_path / "out.csv")
    env = _env(tmp_path, out_csv)
    truth: Counter = Counter()

    def emit(part: int, n: int) -> None:
        batch = [WORDS[(part * 7 + i) % len(WORDS)] for i in range(n)]
        truth.update(batch)
        write_part(str(tmp_path / "data"), part, batch)

    emit(0, 40)
    emit(1, 40)
    proc = spawn(env)
    try:
        _wait(proc, lambda: sum(final_counts(out_csv).values()) >= 80, 60, "the first two parts")
        seen = _commits(str(tmp_path / "snapshots"))
        _wait(proc, lambda: _commits(str(tmp_path / "snapshots")) > seen, 30, "a snapshot after them")
        proc.send_signal(signal.SIGKILL)
        proc.wait()

        emit(2, 40)
        emit(3, 40)
        proc = spawn(env)
        _wait(proc, lambda: final_counts(out_csv) == truth, 60, f"the counts {dict(truth)}")
        time.sleep(0.5)  # a few more ticks: nothing may be counted twice
        assert final_counts(out_csv) == truth
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    # the CLI replays the store with the static worker: the same counts,
    # every file skipped (its rows come back from the log)
    replay_out = str(tmp_path / "replay.csv")
    done = subprocess.run(
        [sys.executable, "-m", "pathway_tpu_torch.cli", "replay", "--record-path", str(tmp_path / "snapshots"),
         sys.executable, os.path.join(REPO_ROOT, "tests", "torch_recovery_worker.py")],
        cwd=REPO_ROOT, env=_env(tmp_path, replay_out, mode="static"), capture_output=True, text=True, timeout=120,
    )
    assert done.returncode == 0, done.stderr[-3000:]
    assert final_counts(replay_out) == truth

    # a torn tail: replay stops at the last intact record, the log and the
    # offsets rewind, and the restart re-reads what the tear lost (at least
    # once), without a crash
    chunks = sorted((tmp_path / "snapshots" / "sources" / "wc_input").glob("chunk-*"))
    torn = chunks[-1]
    torn.write_bytes(torn.read_bytes()[:-5])
    torn_out = str(tmp_path / "torn.csv")
    done = subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "tests", "torch_recovery_worker.py")],
        cwd=REPO_ROOT, env=_env(tmp_path, torn_out, mode="static"), capture_output=True, text=True, timeout=120,
    )
    assert done.returncode == 0, done.stderr[-3000:]
    assert "corrupt tail" in done.stderr
    got = final_counts(torn_out)
    assert set(got) == set(truth) and all(got[w] >= truth[w] for w in truth)
