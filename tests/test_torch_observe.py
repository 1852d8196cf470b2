"""The port's recorder, traces and SLO engine
(``pathway_tpu_torch/observe/``) against the reference's: the same
bucket bounds, the same events giving the same family names, label sets
and bucket counts in ``render_prometheus``, and the same span tree for
one traced serve through each package's ``ServeScheduler``."""

import importlib
import math
import threading

import pytest
import torch

from pathway_tpu import observe as ref_observe
from pathway_tpu.observe import slo as ref_slo
from pathway_tpu.observe import trace as ref_trace
from pathway_tpu.robust import CircuitBreaker as RefBreaker
from pathway_tpu.serve import ServeScheduler as RefScheduler
from pathway_tpu_torch import observe
from pathway_tpu_torch.observe import slo, trace
from pathway_tpu_torch.robust import CircuitBreaker, inject
from pathway_tpu_torch.serve import ServeScheduler

from .test_torch_rerank import QUERIES, _pipes, stack  # noqa: F401 - fixture


# the packages export a ``histogram`` function over the submodule's name
histogram = importlib.import_module("pathway_tpu_torch.observe.histogram")
ref_histogram = importlib.import_module("pathway_tpu.observe.histogram")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_same_buckets():
    assert histogram.bucket_bounds_s() == ref_histogram.bucket_bounds_s()
    assert histogram.N_BUCKETS == ref_histogram.N_BUCKETS
    for ns in [0, 1, 1023, 1024, 1025, 2**20, 3 * 10**6, 7 * 10**9, 2**45, 2**62]:
        assert histogram._bucket_index(ns) == ref_histogram._bucket_index(ns), ns


def _feed(obs, breaker_cls, probe):
    """One fixed sequence of recorder events under label value ``probe``."""
    h = obs.histogram("pathway_serve_stage_seconds", stage=probe)
    for ns in (900, 5_000, 5_000, 70_000_000, 3 * 10**9, 2**44):
        h.observe_ns(ns)
    obs.counter("pathway_serve_degraded_total", reason=probe).inc(3)
    obs.counter("pathway_serve_dispatches_total", tag=probe).inc()
    obs.gauge("pathway_serve_replica_depth", scheduler=probe, replica="0").set(2.5)
    obs.record_occupancy(probe, 5, 8)
    b = breaker_cls(probe, failure_threshold=1, reset_s=600)
    b.record_failure()
    b.allow()
    return b


def test_same_events_render_the_same_series():
    probe = "parity_render_probe"
    keep = []
    lines = []
    for obs, cls in ((ref_observe, RefBreaker), (observe, CircuitBreaker)):
        keep.append(_feed(obs, cls, probe))
        mine = [line for line in obs.render_prometheus() if probe in line]
        lines.append(mine)
    assert lines[0] == lines[1]
    families = {line.split("{")[0] for line in lines[1]}
    assert {
        "pathway_serve_stage_seconds_bucket", "pathway_serve_stage_seconds_sum", "pathway_serve_stage_seconds_count",
        "pathway_serve_degraded_total", "pathway_serve_dispatches_total", "pathway_serve_replica_depth",
        "pathway_serve_pack_rows_total", "pathway_serve_batch_bucket_total", "pathway_robust_breaker_open",
        "pathway_robust_breaker_opens_total", "pathway_robust_breaker_fail_fast_total",
    } <= families
    snap = observe.snapshot()
    key = f'pathway_serve_stage_seconds{{stage="{probe}"}}'
    assert snap["histograms"][key]["count"] == 6
    assert snap["histograms"][key]["p50_s"] == ref_observe.snapshot()["histograms"][key]["p50_s"]


def test_disabled_recorder_records_nothing():
    h = observe.histogram("pathway_serve_stage_seconds", stage="parity_disabled_probe")
    observe.set_enabled(False)
    try:
        h.observe_ns(5000)
        assert trace.start_trace("serve.request") is None
    finally:
        observe.set_enabled(True)
    assert h.count == 0


def _tree_shape(node, out, parent="root"):
    out.append((parent, node["name"], node["status"]))
    for child in node.get("children", ()):
        _tree_shape(child, out, node["name"])
    return out


def _traced_serve(sched_cls, pipe, tr, query):
    """One clean request through a fresh scheduler; its request and batch
    trees, read from the kept or the pending store (whether a clean trace
    is kept as slow depends on timing)."""
    tr.reset()
    with sched_cls(pipe, window_us=20_000, result_cache=None) as sched:
        got = sched.serve([query])
    records = {}
    for store in (tr._kept, tr._pending):
        for record in store.values():
            records[record["kind"]] = tr._tree(record, {}, inline=False)
    return got, records


def test_same_span_tree_for_one_traced_serve(stack):
    ref_pipe, port_pipe = _pipes(stack, "cascade")
    ref_pipe(QUERIES[:1])
    port_pipe(QUERIES[:1])
    shapes = []
    for cls, pipe, tr in ((RefScheduler, ref_pipe, ref_trace), (ServeScheduler, port_pipe, trace)):
        got, records = _traced_serve(cls, pipe, tr, QUERIES[0])
        assert got.ok and set(records) == {"request", "batch"}
        shapes.append({kind: sorted(_tree_shape(r["root"], [])) for kind, r in records.items()})
        shapes[-1]["counts"] = (records["batch"]["dispatches"], records["batch"]["fetches"])
    assert shapes[0] == shapes[1]
    names = {name for _, name, _ in shapes[1]["batch"]}
    assert {"stage1.dispatch", "stage1.fetch", "stage1.postprocess", "stage.late_interaction",
            "stage.cross_encoder", "stage2.pack_dispatch", "stage2.rtt"} <= names
    assert shapes[1]["counts"] == (3, 3)
    assert {name for _, name, _ in shapes[1]["request"]} == {"serve.request", "admission", "batch"}


def test_degraded_serve_keeps_its_trace_and_links_the_batch(stack):
    _, pipe = _pipes(stack, "cross_encoder")
    pipe._breaker = CircuitBreaker("parity-trace-keep", failure_threshold=100, reset_s=60)
    trace.reset()
    with inject.armed("rerank.dispatch", "raise"):
        with ServeScheduler(pipe, window_us=10_000, result_cache=None) as sched:
            got = sched.serve([QUERIES[1]])
    assert got.degraded == ("rerank_skipped",)
    kept = trace.snapshot_traces()["traces"]
    request = next(t for t in kept if t["kind"] == "request")
    assert request["keep_reason"] == "degraded" and request["statuses"] == ["rerank_skipped"]
    link = next(c for c in request["root"]["children"] if c["name"] == "batch")
    # the batch trace is kept too (itself degraded), and inlined under the link
    assert link["linked"]["kind"] == "batch" and link["linked"]["statuses"] == ["rerank_skipped"]
    assert trace.get_trace(request["trace_id"])["trace_id"] == request["trace_id"]


def test_trace_fault_sites_drop_spans_never_the_serve(stack):
    _, pipe = _pipes(stack, "maxsim")
    dropped = trace.stats()["spans_dropped"]
    with inject.armed("trace.record", "hang", hang_s=30.0):
        with ServeScheduler(pipe, window_us=5_000, result_cache=None) as sched:
            assert sched.serve([QUERIES[2]]).ok
    assert trace.stats()["spans_dropped"] > dropped
    with inject.armed("trace.export", "raise"):
        assert trace.snapshot_traces()["export_failed"] is True


def _burn(obs, slo_mod, n_bad: int):
    """Feed the availability objective ``n_bad`` degraded of 10 requests."""
    h = obs.histogram("pathway_serve_request_seconds")
    for _ in range(10):
        h.observe_ns(1_000_000)
    obs.counter("pathway_serve_degraded_total", reason="parity_slo_probe").inc(n_bad)
    return slo_mod.SloEngine(slo_mod.default_specs())


def test_slo_engine_matches_reference(monkeypatch):
    monkeypatch.setenv("PATHWAY_SLO_TICK_S", "0")
    docs = []
    for obs, slo_mod in ((ref_observe, ref_slo), (observe, slo)):
        obs.reset()
        engine = _burn(obs, slo_mod, 0)
        first = engine.evaluate(max_age_s=0)
        obs.counter("pathway_serve_degraded_total", reason="parity_slo_probe").inc(6)
        obs.histogram("pathway_serve_request_seconds").observe_ns(1_000_000)
        second = engine.evaluate(max_age_s=0)
        docs.append([
            {name: (row["state"], row["good"], row["total"], row["windows"]["fast"]["burn_rate"])
             for name, row in d["slos"].items() if name in ("serve_latency", "serve_availability")}
            for d in (first, second)
        ] + [second["should_shed"]])
    assert docs[0] == docs[1]
    assert docs[1][1]["serve_availability"][0] == "firing" and docs[1][2] is True
    assert not math.isnan(docs[1][1]["serve_latency"][3])


def test_shed_probe_turns_away_shed_class_requests(stack, monkeypatch):
    _, pipe = _pipes(stack, "maxsim")
    monkeypatch.setattr(slo, "should_shed", lambda: True)
    shed_before = observe.counter("pathway_serve_shed_total", priority="low").value
    with ServeScheduler(pipe, window_us=5_000, result_cache=None) as sched:
        got = sched.serve([QUERIES[0]], priority="low")
        assert got == [[]] and got.degraded == ("load_shed",) and got.meta["shed"]
        assert sched.serve([QUERIES[0]], priority="high").ok  # not shed-class: admitted
        assert sched.stats["shed"] == 1
    assert observe.counter("pathway_serve_shed_total", priority="low").value == shed_before + 1


def test_concurrent_recording_loses_no_update():
    h = observe.histogram("pathway_serve_stage_seconds", stage="parity_threads_probe")
    c = observe.counter("pathway_serve_degraded_total", reason="parity_threads_probe")
    before_h, before_c = h.count, c.value

    def work():
        for _ in range(2000):
            h.observe_ns(1000)
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert h.count - before_h == c.value - before_c == 16_000
