"""The port's robust layer (``pathway_tpu_torch/robust/``) against the
reference's on the same seeded inputs: retry backoff schedules, circuit
breaker transitions under the same failure/success/clock sequence, and
fault-injection firing sequences.  Then the four faults the port had
against the reference, each repaired:

1. a pipeline built with ``deadline_ms=None`` serves under the
   ``serve.deadline_ms`` default;
2. stage 1 gets ``serve.stage1_fraction`` of the deadline;
3. the stage-2 launch retries, and a per-model circuit breaker fed by
   every cross-encoder failure fails persistent faults fast;
4. ``record_degraded`` counts on ``pathway_serve_degraded_total{reason}``.
"""

import time

import pytest
import torch

from pathway_tpu import observe as ref_observe
from pathway_tpu.ops.retrieve_rerank import RerankStage as RefStage
from pathway_tpu.ops.retrieve_rerank import RetrieveRerankPipeline as RefPipeline
from pathway_tpu.robust import CircuitBreaker as RefBreaker
from pathway_tpu.robust import Deadline as RefDeadline
from pathway_tpu.robust import DeadlineExceeded as RefDeadlineExceeded
from pathway_tpu.robust import RetryPolicy as RefPolicy
from pathway_tpu.robust import ServeResult as RefResult
from pathway_tpu.robust import inject as ref_inject
from pathway_tpu.robust import retry_call as ref_retry_call
from pathway_tpu_torch import observe
from pathway_tpu_torch.index import ForwardIndex
from pathway_tpu_torch.ops import dispatch_counter
from pathway_tpu_torch.ops.retrieve_rerank import RerankStage, RetrieveRerankPipeline
from pathway_tpu_torch.robust import (
    CircuitBreaker,
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    ServeResult,
    inject,
    record_degraded,
    retry_call,
)

from .test_torch_forward import T_DOC
from .test_torch_rerank import QUERIES, _pipes, assert_same_serve, stack  # noqa: F401 - fixture


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    inject.disarm()
    ref_inject.disarm()


# -- retry schedule ------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_same_seed_same_backoff_schedule(seed, monkeypatch):
    for site in ("serve.dispatch", "ivf.dispatch", "rerank.dispatch", "cache.get"):
        for base, cap in ((0.005, 0.2), (0.002, 0.02)):
            mine, theirs = RetryPolicy(5, base, cap, seed), RefPolicy(5, base, cap, seed)
            assert [mine.delay_s(site, a) for a in range(1, 6)] == [theirs.delay_s(site, a) for a in range(1, 6)]
    monkeypatch.setenv("PATHWAY_RETRY_BASE_MS", "3")
    monkeypatch.setenv("PATHWAY_RETRY_MAX_MS", "40")
    monkeypatch.setenv("PATHWAY_RETRY_SEED", str(seed))
    monkeypatch.setenv("PATHWAY_RETRY_ATTEMPTS_RERANK_DISPATCH", "6")
    mine, theirs = RetryPolicy.from_env("rerank.dispatch"), RefPolicy.from_env("rerank.dispatch")
    assert (mine.attempts, mine.base_delay_s, mine.max_delay_s, mine.seed) == (
        theirs.attempts, theirs.base_delay_s, theirs.max_delay_s, theirs.seed,
    ) == (6, 0.003, 0.04, seed)


def test_retry_call_sleeps_and_counts_like_reference(monkeypatch):
    """A call failing three times then succeeding: the same sleeps in the
    same order, the same retry count, the same result."""
    sleeps = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    outcomes = {}
    for name, call, counter in (
        ("ref", ref_retry_call, ref_observe.counter("pathway_robust_retries_total", site="parity.site")),
        ("port", retry_call, observe.counter("pathway_robust_retries_total", site="parity.site")),
    ):
        policy = (RefPolicy if name == "ref" else RetryPolicy)(attempts=4, base_delay_s=0.01, max_delay_s=0.05, seed=3)
        fails = iter([True, True, True, False])

        def flaky():
            if next(fails):
                raise ConnectionError("transient")
            return 42

        before, n0 = counter.value, len(sleeps)
        assert call("parity.site", flaky, policy=policy) == 42
        outcomes[name] = (sleeps[n0:], counter.value - before)
    assert outcomes["port"] == outcomes["ref"] and outcomes["port"][1] == 3


def test_deadline_and_open_breaker_are_not_retried():
    calls = []

    def boom():
        calls.append(1)
        raise DeadlineExceeded("inner")

    with pytest.raises(DeadlineExceeded):
        retry_call("parity.deadline", boom, policy=RetryPolicy(attempts=3, base_delay_s=0.0))
    assert calls == [1]
    b = CircuitBreaker("parity-no-retry", failure_threshold=1, reset_s=60)
    b.record_failure()
    with pytest.raises(Exception, match="is open"):
        retry_call("parity.open", lambda: 1, breaker=b)


# -- breaker transitions ---------------------------------------------------------


def test_same_sequence_same_breaker_transitions(monkeypatch):
    """Failures, successes, fail-fast calls and clock ticks (a fake
    monotonic clock) through both breakers: the same state and stats
    after every step."""
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    steps = [
        "fail", "fail", "allow", "fail", "allow", ("tick", 10), "allow", ("tick", 25), "allow", "allow",
        "fail", "allow", ("tick", 31), "allow", "success", "allow", "fail", "fail", "fail", ("tick", 40),
        "allow", "abort", "allow", "success",
    ]
    trails = []
    for cls in (RefBreaker, CircuitBreaker):
        b = cls("parity-transitions", failure_threshold=3, reset_s=30)
        trail = []
        for step in steps:
            out = None
            if isinstance(step, tuple):
                now[0] += step[1]
            elif step == "allow":
                out = b.allow()
            elif step == "fail":
                b.record_failure()
            elif step == "success":
                b.record_success()
            elif step == "abort":
                b.abort_probe()
            trail.append((out, b.state, dict(b.stats)))
        trails.append(trail)
    assert trails[0] == trails[1]
    assert {s for _, s, _ in trails[1]} == {"closed", "open", "half_open"}


# -- fault injection -------------------------------------------------------------


def test_same_spec_same_firing_sequence():
    spec = "serve.dispatch=raise:p=0.3:seed=7;cache.get=raise:times=2,rerank.dispatch=raise:p=0.5"
    sequences = []
    for mod in (ref_inject, inject):
        assert mod.load_env(spec) == ["serve.dispatch", "cache.get", "rerank.dispatch"]
        seq = []
        for _ in range(40):
            for site in ("serve.dispatch", "cache.get", "rerank.dispatch", "ivf.dispatch"):
                try:
                    mod.fire(site)
                    seq.append(0)
                except RuntimeError:
                    seq.append(1)
        counts = [mod.fired_count(s) for s in ("serve.dispatch", "cache.get", "rerank.dispatch")]
        mod.disarm()
        sequences.append((seq, counts))
    assert sequences[0] == sequences[1]
    assert sequences[1][1][1] == 2 and 0 < sequences[1][1][0] < 40


def test_hang_releases_at_the_deadline_and_delay_is_capped():
    for mod, deadline_cls, exc in ((ref_inject, RefDeadline, RefDeadlineExceeded), (inject, Deadline, DeadlineExceeded)):
        with mod.armed("parity.hang", "hang", hang_s=5.0):
            t0 = time.monotonic()
            with pytest.raises(exc):
                mod.fire("parity.hang", deadline=deadline_cls(0.05))
            assert time.monotonic() - t0 < 1.0
        with mod.armed("parity.delay", "delay", delay_s=5.0):
            t0 = time.monotonic()
            mod.fire("parity.delay", deadline=deadline_cls(0.02))
            assert time.monotonic() - t0 < 1.0


# -- fault 1 and 2: the default deadline and the stage-1 share ---------------------


class _Recorder:
    """A duck-typed stage 1 that records the deadline it was given."""

    k = 4

    def __init__(self, result_cls):
        self.result_cls = result_cls
        self.budgets = []

    def submit(self, texts, k, deadline=None):
        self.budgets.append(None if deadline is None else deadline.remaining_s())
        if deadline is not None:
            deadline.check("serve.dispatch")
        rows = self.result_cls([[(1, 1.0), (2, 0.5)] for _ in texts])
        return lambda: rows


def _noop_stage(base):
    class Noop(base):
        name = "noop"

        def submit(self, pipeline, queries, cand_rows, keep, deadline, query_tokens=None, query_mask=None, pool_width=None):
            return lambda: ([list(r[:keep]) for r in cand_rows], None)

    return Noop(candidates=4)


def _duck_pipes(**kw):
    ref_r, port_r = _Recorder(RefResult), _Recorder(ServeResult)
    ref = RefPipeline(ref_r, k=2, stages=[_noop_stage(RefStage)], **kw)
    port = RetrieveRerankPipeline(port_r, k=2, stages=[_noop_stage(RerankStage)], **kw)
    return (ref, ref_r), (port, port_r)


def test_fault1_default_deadline_from_the_knob(monkeypatch):
    """``deadline_ms=None``: the serve runs under ``serve.deadline_ms``."""
    monkeypatch.setenv("PATHWAY_SERVE_DEADLINE_MS", "0.001")
    (ref, _), (port, _) = _duck_pipes()
    assert port._default_deadline() is not None
    want, got = ref(["q"]), port(["q"])
    assert got.degraded == want.degraded == ("retrieval_failed",)
    assert got == want == [[]]
    monkeypatch.setenv("PATHWAY_SERVE_DEADLINE_MS", "0")
    (ref, _), (port, _) = _duck_pipes()
    assert port._default_deadline() is None and port(["q"]) == ref(["q"]) == [[(1, 1.0), (2, 0.5)]]
    # an explicit deadline_ms <= 0 means none, whatever the knob says
    monkeypatch.setenv("PATHWAY_SERVE_DEADLINE_MS", "0.001")
    (_, _), (port, _) = _duck_pipes(deadline_ms=0)
    assert port(["q"]).ok


@pytest.mark.parametrize("fraction", ["0.25", "0.9"])
def test_fault2_stage1_share_from_the_knob(fraction, monkeypatch):
    monkeypatch.setenv("PATHWAY_SERVE_STAGE1_FRACTION", fraction)
    (ref, ref_r), (port, port_r) = _duck_pipes(deadline_ms=2000)
    ref(["q"])
    port(["q"])
    want, got = ref_r.budgets[0], port_r.budgets[0]
    assert abs(got - 2.0 * float(fraction)) < 0.05, got
    assert abs(got - want) < 0.05


# -- fault 3: retries and the circuit breaker ----------------------------------------


def _ce_pipes(stack, name, **breaker_kw):
    """The reference's and the port's cross-encoder pipeline, each with a
    breaker of its own (the shared default would leak between tests)."""
    ref, port = _pipes(stack, "cross_encoder")
    ref._breaker = RefBreaker(name, **breaker_kw)
    port._breaker = CircuitBreaker(name, **breaker_kw)
    return ref, port


def test_fault3_transient_stage2_fault_retries_to_a_clean_serve(stack):
    ref, port = _ce_pipes(stack, "parity-transient", failure_threshold=5, reset_s=60)
    clean_ref, clean_port = ref(QUERIES), port(QUERIES)
    retries = observe.counter("pathway_robust_retries_total", site="rerank.dispatch")
    ref_retries = ref_observe.counter("pathway_robust_retries_total", site="rerank.dispatch")
    before, ref_before = retries.value, ref_retries.value
    with ref_inject.armed("rerank.dispatch", "raise", times=1):
        want = ref(QUERIES)
    with inject.armed("rerank.dispatch", "raise", times=1):
        got = port(QUERIES)
    assert got.ok and want.ok
    assert got == clean_port and want == clean_ref
    assert retries.value - before == ref_retries.value - ref_before == 1
    assert port._breaker.state == ref._breaker.state == "closed"


def test_fault3_persistent_fault_opens_the_breaker_and_fails_fast(stack):
    ref, port = _ce_pipes(stack, "parity-persistent", failure_threshold=3, reset_s=3.0)
    clean = port(QUERIES)
    trails = []
    for pipe, mod in ((ref, ref_inject), (port, inject)):
        trail = []
        with mod.armed("rerank.dispatch", "raise"):
            for _ in range(3):
                fired = mod.fired_count("rerank.dispatch")
                got = pipe(QUERIES)
                trail.append((got.degraded, mod.fired_count("rerank.dispatch") - fired, pipe._breaker.state))
                assert [list(r) for r in got] == [list(r[:5]) for r in pipe.retriever(QUERIES, pipe.candidates)]
        trails.append((trail, dict(pipe._breaker.stats)))
    assert trails[0] == trails[1]
    # first serve: three failed attempts open the breaker; later serves
    # fail fast without reaching the fault site
    assert [t[1] for t in trails[1][0]] == [3, 0, 0]
    assert all(t[0] == ("rerank_skipped",) and t[2] == "open" for t in trails[1][0])
    with dispatch_counter.DispatchCounter() as counter:
        assert port(QUERIES).degraded == ("rerank_skipped",)
    assert [tag for _, tag in counter.events] == ["serve_exact", "serve_exact"]  # no stage-2 dispatch
    # disarmed and past reset_s: the half-open probe succeeds, serves are clean
    time.sleep(3.1)
    assert port(QUERIES) == clean and port(QUERIES).ok and port._breaker.state == "closed"


def test_default_breaker_is_the_shared_cross_encoder_breaker(stack):
    from pathway_tpu_torch.robust import breaker

    _, port = _pipes(stack, "cross_encoder")
    assert port._breaker is breaker("cross_encoder")


# -- fault 4: the degradation counter ------------------------------------------------


def test_fault4_degraded_serves_count_on_the_recorder(stack):
    (ref_enc, _, _, _), (enc, _, _, _) = stack["ref"], stack["port"]
    from pathway_tpu.index import ForwardIndex as RefForward

    ref, port = _pipes(
        stack, "maxsim", forward=ForwardIndex(enc, tokens_per_doc=T_DOC),
        ref_forward=RefForward(ref_enc, tokens_per_doc=T_DOC),
    )
    series = observe.counter("pathway_serve_degraded_total", reason="late_interaction_skipped")
    ref_series = ref_observe.counter("pathway_serve_degraded_total", reason="late_interaction_skipped")
    before, ref_before = series.value, ref_series.value
    want, got = ref(QUERIES), port(QUERIES)
    assert_same_serve(want, got)
    assert series.value - before == ref_series.value - ref_before == 1
    record_degraded("rerank_skipped", 3)
    lines = observe.render_prometheus()
    assert 'pathway_serve_degraded_total{reason="late_interaction_skipped"} ' + str(series.value) in lines


def test_retrieval_failure_counts_every_rider():
    before = observe.counter("pathway_serve_degraded_total", reason="retrieval_failed").value

    class Down:
        k = 2

        def submit(self, texts, k, deadline=None):
            raise ConnectionError("stage 1 down")

    pipe = RetrieveRerankPipeline(Down(), k=2, stages=[_noop_stage(RerankStage)])
    got = pipe.submit(["a", "b"], n_requests=4)()
    assert got.degraded == ("retrieval_failed",) and got == [[], []]
    assert observe.counter("pathway_serve_degraded_total", reason="retrieval_failed").value - before == 4
