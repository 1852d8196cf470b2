"""The port's runtime lock-order sanitizer (``pathway_tpu_torch/analysis/
sanitizer.py``) against the reference's (``pathway_tpu/analysis/
sanitizer.py``).

Both sanitizers patch ``threading``'s constructors, so each test installs
one at a time (the fixture) and uninstalls it after.  The planted cases
run through both packages' sanitizers and give the same violation counts;
a planted deadlock raises instead of hanging; a CPU scheduler burst over
``FusedEncodeSearch`` + ``IvfKnnIndex`` (the reference's
``test_scheduler_workload_runs_violation_free`` at its sizes) runs with
zero violations and real nesting observed.
"""

from __future__ import annotations

import threading
import time

import pytest
import torch

from pathway_tpu.analysis import sanitizer as ref_sanitizer
from pathway_tpu_torch.analysis import sanitizer


@pytest.fixture
def sanitized():
    """Install the port's sanitizer for one test, restoring prior state."""
    was = sanitizer.installed()
    sanitizer.install()
    sanitizer.reset()
    yield sanitizer
    sanitizer.reset()
    if not was:
        sanitizer.uninstall()


def _run_in_thread(fn):
    errs = []

    def body():
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 - the violation under test
            errs.append(exc)

    t = threading.Thread(target=body)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "the tripwire blocked instead of raising"
    return errs


# -- planted scenarios, each run through one sanitizer module ------------------

def _abba(san):
    a, b = san.make_lock("planted.A"), san.make_lock("planted.B")

    def forward():
        with a:
            with b:
                pass

    def backward():
        with b:
            with a:
                pass

    assert _run_in_thread(forward) == []
    errs = _run_in_thread(backward)
    assert errs and isinstance(errs[0], san.LockOrderViolation) and "cycle" in str(errs[0])
    assert "planted.A" in str(errs[0]) and "planted.B" in str(errs[0])


def _self_deadlock(san):
    lock = san.make_lock("planted.self")

    def reenter():
        with lock:
            with lock:
                pass

    errs = _run_in_thread(reenter)
    assert errs and "self-deadlock" in str(errs[0])
    assert lock.acquire(timeout=1)  # released cleanly after the raise
    lock.release()


def _rlock_reentry(san):
    lock = san.make_lock("planted.rlock", kind="rlock")
    with lock:
        with lock:
            pass


def _rank_inversion_and_waived_pair(san):
    low, high = san.make_lock("fixture.observe_lock", rank=0), san.make_lock("fixture.pool_lock", rank=6)
    with pytest.raises(san.LockOrderViolation, match="rank-inversion"):
        with low:
            with high:
                pass
    # index(3) before scheduler(5): the declared exception pair
    idx, sched = san.make_lock("fixture.index_lock", rank=3), san.make_lock("fixture.sched_lock", rank=5)
    with idx:
        with sched:
            pass


def _deeper_held_inversion(san):
    idx, sched, shard = (
        san.make_lock("deep.idx", rank=3), san.make_lock("deep.sched", rank=5), san.make_lock("deep.shard", rank=4)
    )
    with sched:
        with shard:
            pass
    with pytest.raises(san.LockOrderViolation, match="rank-inversion"):
        with idx:
            with sched:
                with shard:
                    pass


def _recurrence(san):
    low, high = san.make_lock("recur.low", rank=0), san.make_lock("recur.high", rank=6)
    for _ in range(3):
        try:
            with low:
                with high:
                    pass
        except san.LockOrderViolation:
            pass


def _cond_wait_holding_second_lock(san):
    other = san.make_lock("fixture.other")
    cond = san._SanCondition(san.make_lock("fixture.cv_lock", kind="rlock"))

    def waiter():
        with other:
            with cond:
                cond.wait(timeout=0.01)

    errs = _run_in_thread(waiter)
    assert errs and "wait-holding-lock" in str(errs[0])
    with cond:  # waiting while holding only its own lock is sanctioned
        cond.wait(timeout=0.01)


def _watchdog(san):
    lock = san.make_lock("watchdog.probe")
    with lock:
        time.sleep(0.03)
    with lock:  # count-only: nothing raised, the lock still works
        pass


_SCENARIOS = {
    "abba_raises_without_hanging": (_abba, {"cycle": 1}),
    "self_deadlock_raises": (_self_deadlock, {"self-deadlock": 1}),
    "rlock_reentry_is_legal": (_rlock_reentry, {}),
    "rank_inversion_caught_waived_pair_passes": (_rank_inversion_and_waived_pair, {"rank-inversion": 1}),
    "deeper_held_inversion_not_masked": (_deeper_held_inversion, {"rank-inversion": 1}),
    "recurrence_keeps_counting": (_recurrence, {"rank-inversion": 3}),
    "cond_wait_holding_second_lock": (_cond_wait_holding_second_lock, {"wait-holding-lock": 1}),
    "watchdog_counts_without_raising": (_watchdog, {"held-too-long": 1}),
}


def _counts_under(san, scenario):
    was = san.installed()
    san.install()
    san.reset()
    try:
        scenario(san)
        return san.violations()
    finally:
        san.reset()
        if not was:
            san.uninstall()


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_planted_case_counts_equal_the_reference(name, monkeypatch):
    """Every planted case raises (or counts) as stated, and the port's
    violation counts equal the reference sanitizer's on the same case."""
    scenario, expect = _SCENARIOS[name]
    monkeypatch.setenv("PATHWAY_LOCK_HOLD_MS", "5" if name.startswith("watchdog") else "0")
    theirs = _counts_under(ref_sanitizer, scenario)
    mine = _counts_under(sanitizer, scenario)
    assert mine == theirs
    assert {k: v for k, v in mine.items() if v} == expect


def test_installed_factories_name_sites_like_the_static_graph(sanitized):
    """A lock the port creates after install is proxied under the static
    analyzer's site id; a lock created outside the package stays raw."""
    from pathway_tpu_torch.serve.scheduler import _Batch

    batch = _Batch(lambda: 1, 1, 1, False)
    assert getattr(batch._lock, "site", None) == "serve.scheduler._Batch._lock"
    assert getattr(batch._lock, "rank", None) == 5
    raw = threading.Lock()
    assert not hasattr(raw, "site")
    assert sanitized.edges() == []


def test_metrics_family_renders(sanitized):
    from pathway_tpu_torch import observe

    a, b = sanitized.make_lock("metrics.A"), sanitized.make_lock("metrics.B")

    def fwd():
        with a:
            with b:
                pass

    assert _run_in_thread(fwd) == []
    try:
        with b:
            with a:
                pass
    except sanitizer.LockOrderViolation:
        pass
    stats = sanitized.stats()
    assert stats["violations"]["cycle"] >= 1 and stats["installed"]
    body = "\n".join(observe.render_prometheus())
    assert 'pathway_sanitizer_violations_total{kind="cycle"}' in body
    assert "pathway_sanitizer_locks_tracked" in body
    assert "pathway_sanitizer_edges_observed" in body


def test_overhead_per_acquire_stays_micro(sanitized):
    n = 20000
    raw = threading.Lock()
    t0 = time.perf_counter()
    for _ in range(n):
        with raw:
            pass
    t_raw = time.perf_counter() - t0
    proxy = sanitized.make_lock("overhead.probe")
    with proxy:
        pass
    t0 = time.perf_counter()
    for _ in range(n):
        with proxy:
            pass
    per_op = (time.perf_counter() - t0 - t_raw) / n
    assert per_op < 100e-6, f"sanitizer adds {per_op * 1e6:.1f} us per acquire"


def test_scheduler_workload_runs_violation_free(sanitized):
    """The reference's CPU burst at its sizes: a coalesced serve over the
    fused IVF stack (the waived index-before-pipeline pair included) under
    the installed proxies — zero violations, real nesting observed, and
    every observed edge consistent with the static graph's ranks."""
    from pathway_tpu_torch.analysis.lock_order import runtime_edge_report, static_graph
    from pathway_tpu_torch.models.encoder import SentenceEncoder
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch
    from pathway_tpu_torch.serve import ServeScheduler

    enc = SentenceEncoder(
        dimension=16, n_layers=1, n_heads=2, max_length=16, vocab_size=256, dtype=torch.float32, device="cpu",
    )
    docs = {i: f"sanitizer doc {i} about live retrieval" for i in range(16)}
    ivf = IvfKnnIndex(dimension=16, metric="cos", n_clusters=2, n_probe=2, device="cpu")
    ivf.add(sorted(docs), enc.encode([docs[i] for i in sorted(docs)]))
    ivf.build()
    fused = FusedEncodeSearch(enc, ivf, k=4)
    errs: list = []
    with ServeScheduler(fused, window_us=500, result_cache=None) as sched:
        def worker(q):
            try:
                rows = sched.serve([q])
                assert rows is not None
            except Exception as exc:  # noqa: BLE001 - LockOrderViolation included
                errs.append(repr(exc))

        threads = [
            threading.Thread(target=worker, args=(f"sanitizer doc {i % 16} about live retrieval",)) for i in range(6)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not errs, errs[:3]
    assert all(v == 0 for v in sanitized.violations().values()), sanitized.violations()
    stats = sanitized.stats()
    assert stats["locks_tracked"] > 0 and stats["edges_observed"] > 0
    import os

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(sanitizer.__file__)))
    report = runtime_edge_report(sanitized.edges(), static_graph([pkg]))
    assert report["inconsistent"] == []
