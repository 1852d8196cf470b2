"""Port parity of live ingest and the freshness plane on the CPU:
``LiveIngestRunner`` of ``pathway_tpu_torch`` against ``pathway_tpu``.

The same connector commits go through both packages' runners into an
IVF index and a forward index built alike, with the encoder weights
carried over (bridge).  Each commit holds at most ``ingest.batch_docs``
rows and is flushed, and the IVF's background absorb is waited for,
before the next: layouts then compare slot for slot.  Keys, slots,
generations, offsets, counters and SLO counts must be equal; f32 slab
rows within 1e-5 (the two encoders' rows differ in rounding), serve
rows by ``assert_same_ranking`` (keys in order, scores within 1e-4).

Also held alike in both packages: overdue pending documents burn the
freshness budget before they land, a ``serve_latency`` burn
backpressures the loop, the ``ingest.poll`` / ``ingest.embed`` /
``ingest.commit`` fault sites retry or drop with the same counts, the
queue cap blocks the producer, and ``ServeScheduler`` under a real
freshness burn sheds ``low`` and serves ``high`` clean, with
``serve.shed=0`` restoring advisory admission.  Within the port: the
per-batch trace's spans are contiguous and sum to its root, a mid-run
document becomes retrievable under serve, serves racing absorbs return
only keys whose scores match their rows, and the encoder's embedding
cache gives the plain path's rows and encodes nothing on a repeat.
"""

import threading
import time

import numpy as np
import pytest
import torch

from pathway_tpu import observe as ref_observe
from pathway_tpu.index import ForwardIndex as RefForward
from pathway_tpu.observe import slo as ref_slo
from pathway_tpu.ops.ivf import IvfKnnIndex as RefIvf
from pathway_tpu.ops.knn import DeviceKnnIndex as RefKnn
from pathway_tpu.ops.serving import FusedEncodeSearch as RefServe
from pathway_tpu.robust import inject as ref_inject
from pathway_tpu.serve import LiveIngestRunner as RefRunner
from pathway_tpu.serve import ServeScheduler as RefScheduler
from pathway_tpu.serve import ingest_runners as ref_ingest_runners
from pathway_tpu_torch import observe
from pathway_tpu_torch.cache import EmbeddingCache
from pathway_tpu_torch.index import ForwardIndex
from pathway_tpu_torch.observe import recorder, slo, trace
from pathway_tpu_torch.ops.ivf import IvfKnnIndex
from pathway_tpu_torch.ops.knn import DeviceKnnIndex
from pathway_tpu_torch.ops.serving import FusedEncodeSearch
from pathway_tpu_torch.robust import inject
from pathway_tpu_torch.serve import LiveIngestRunner, ServeScheduler, ingest_runners

from .test_torch_forward import T_DOC, _assert_same_forward, corpus, encoders
from .test_torch_ivf import assert_same_ranking

SLAB_ATOL = 1e-5
DOCS = dict(enumerate(corpus(64, seed=5, lo=3, hi=20)))
FRESH = {1000 + i: t for i, t in enumerate(corpus(40, seed=6, lo=3, hi=20))}
QUERIES = [" ".join(DOCS[i].split()[::2]) for i in (2, 9, 40)] + [FRESH[1005]]
# one package per row: (observe, slo, inject, runner class, runner registry)
SIDES = {
    "ref": (ref_observe, ref_slo, ref_inject, RefRunner, ref_ingest_runners),
    "port": (observe, slo, inject, LiveIngestRunner, ingest_runners),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    # an SLO burn left by an earlier test file in this process would hold
    # one side's backpressure on
    for obs, slo_mod, inj, _cls, _reg in SIDES.values():
        inj.disarm()
        slo_mod.reset()
    yield
    for obs, slo_mod, inj, _cls, _reg in SIDES.values():
        inj.disarm()
        slo_mod.reset()


@pytest.fixture(scope="module")
def pair():
    return encoders()


class StubEncoder:
    """Instant deterministic ``[B, d]`` rows (a torch tensor for the
    port, numpy for the reference); ``delay_s`` makes the embed stage
    visible to the span checks."""

    def __init__(self, as_tensor: bool, d: int = 8, delay_s: float = 0.0):
        self.as_tensor, self.d, self.delay_s = as_tensor, d, delay_s

    def encode_to_device(self, texts):
        if self.delay_s:
            time.sleep(self.delay_s)
        rows = np.stack([np.full(self.d, float(len(t) % 17) + 1.0, np.float32) for t in texts])
        return torch.from_numpy(rows) if self.as_tensor else rows


class StubIndex:
    def __init__(self):
        self.generation = 0
        self.keys = []

    def add(self, keys, vecs):
        assert isinstance(vecs, np.ndarray) and vecs.dtype == np.float32
        self.keys.extend(int(k) for k in keys)
        self.generation += 1
        return self.generation


def _stub_runner(side, name, **kw):
    encoder = StubEncoder(as_tensor=side == "port", delay_s=kw.pop("delay_s", 0.0))
    idx = StubIndex()
    return SIDES[side][3](encoder, idx, name=name, **kw), idx


def _wait_maintenance(*indexes, timeout=60.0):
    deadline = time.monotonic() + timeout
    while any(ix._absorbing or ix._retraining for ix in indexes):
        assert time.monotonic() < deadline, "background maintenance did not finish"
        time.sleep(0.01)


def _live_stack(pair):
    """Both packages' IVF (absorb threshold 8, no retrain) and forward
    index over the same base documents, built from the same rows."""
    ref_enc, enc = pair
    keys = sorted(DOCS)
    texts = [DOCS[k] for k in keys]
    vecs = ref_enc.encode(texts)
    kw = dict(dimension=32, n_clusters=4, seed=1, absorb_threshold=8, rebuild_fraction=100.0)
    ref_ivf, ivf = RefIvf(**kw), IvfKnnIndex(device="cpu", **kw)
    for index in (ref_ivf, ivf):
        index.add(keys, vecs)
        index.build()
    ref_fwd = RefForward(ref_enc, tokens_per_doc=T_DOC, initial_capacity=64)
    fwd = ForwardIndex(enc, tokens_per_doc=T_DOC, initial_capacity=64)
    ref_fwd.add(keys, texts)
    fwd.add(keys, texts)
    return {"ref": (ref_enc, ref_ivf, ref_fwd), "port": (enc, ivf, fwd)}


def _assert_same_ivf(port, ref):
    assert port._slot_of_key == ref._slot_of_key
    np.testing.assert_array_equal(port._keys_by_slot, ref._keys_by_slot)
    assert list(port._tail) == list(ref._tail)
    np.testing.assert_array_equal(port._live_mask, ref._live_mask)
    np.testing.assert_array_equal(port._bias.float().numpy(), np.asarray(ref._bias, np.float32))
    np.testing.assert_allclose(port._slabs.float().numpy(), np.asarray(ref._slabs, np.float32), atol=SLAB_ATOL)
    assert port.generation == ref.generation


# -- the runner: commit -> retrievable, slot for slot ----------------------------------


def test_commits_absorb_with_reference_layout(pair, monkeypatch):
    monkeypatch.setenv("PATHWAY_INGEST_BATCH_DOCS", "8")
    stack = _live_stack(pair)
    fresh = sorted(FRESH)
    got = {}
    for side, (enc, ivf, fwd) in stack.items():
        obs, _slo, _inj, runner_cls, registry = SIDES[side]
        fresh_h = obs.histogram("pathway_freshness_seconds")
        n0 = fresh_h.count
        gen0 = ivf.generation
        with runner_cls(enc, ivf, fwd, name=f"parity-{side}") as runner:
            assert runner in registry()
            conn = runner.connector("src0")
            offsets = []
            for c in range(0, len(fresh), 8):
                conn.insert_rows([(k, FRESH[k]) for k in fresh[c : c + 8]])
                offsets.append(conn.commit(offsets={"p0": c + 8, "p1": c // 8}).as_dict())
                assert runner.flush(timeout=60.0)
                _wait_maintenance(ivf)
            stats = runner.stats
        assert ivf.generation > gen0 and ivf.stats["absorbs"] >= 1
        got[side] = {
            "stats": stats,
            "offsets": offsets,
            "monitor": {k: v for k, v in conn.monitor.stats().items() if k in ("rows_inserted", "commits", "offsets")},
            "observed": fresh_h.count - n0,
        }
    assert got["port"] == got["ref"]
    assert got["port"]["stats"] == {"docs": 40, "batches": 5, "dropped": 0, "backpressure": 0, "pending": 0}
    assert got["port"]["offsets"][-1] == {"p0": 40, "p1": 4}
    (ref_enc, ref_ivf, ref_fwd), (enc, ivf, fwd) = stack["ref"], stack["port"]
    _assert_same_ivf(ivf, ref_ivf)
    _assert_same_forward(fwd, ref_fwd)
    want = RefServe(ref_enc, ref_ivf, k=5, embed_cache=None)(QUERIES)
    rows = FusedEncodeSearch(enc, ivf, k=5)(QUERIES)
    for w, g in zip(want, rows):
        assert_same_ranking(list(w), list(g))
    assert rows[-1][0][0] == 1005  # an ingested document ranks first for its own text


def test_runner_provider_samples_and_ingest_column():
    runner, _idx = _stub_runner("port", "t-column")
    with runner:
        conn = runner.connector("kafka-0")
        conn.insert_rows([(10, "a"), (11, "bb")])
        conn.commit(offsets={"0": 2})
        assert runner.flush(timeout=10.0)
        col = recorder.snapshot()["ingest"]["t-column"]
    assert col["pathway_ingest_docs_total"] == 2.0
    assert col["pathway_ingest_pending_docs"] == 0.0
    assert 'pathway_ingest_connector_lag_seconds{connector="kafka-0"}' in col
    assert 'pathway_freshness_quantile_seconds{q="0.99"}' in col


def test_freshness_plane_off_records_nothing_but_absorbs():
    h = observe.histogram("pathway_freshness_seconds")
    n0 = h.count
    runner, idx = _stub_runner("port", "t-plane-off", freshness_plane=False)
    with runner:
        conn = runner.connector()
        conn.insert_rows([(1, "x"), (2, "yy")])
        conn.commit()
        assert runner.flush(timeout=10.0)
        assert "t-plane-off" not in recorder.snapshot()["ingest"]
    assert idx.keys == [1, 2] and h.count == n0


def test_ingest_routed_keeps_the_remote_arrival_stamp():
    h = observe.histogram("pathway_freshness_seconds")
    n0 = h.count
    runner, idx = _stub_runner("port", "t-routed")
    with runner:
        stamp = time.perf_counter_ns() - 2_000_000_000  # committed 2 s ago elsewhere
        assert runner.ingest_routed([(7, "routed doc", stamp)]) == 1
        assert runner.flush(timeout=10.0)
    assert idx.keys == [7] and h.count == n0 + 1
    assert h.quantile_s(1.0) >= 1.0


@pytest.mark.parametrize("side", ["ref", "port"])
def test_queue_cap_blocks_the_producer(side, monkeypatch):
    monkeypatch.setenv("PATHWAY_INGEST_QUEUE_CAP", "4")
    runner, idx = _stub_runner(side, f"t-cap-{side}", autostart=False)
    conn = runner.connector()
    conn.insert_rows([(i, f"capped {i}") for i in range(6)])
    producer = threading.Thread(target=conn.commit, daemon=True)
    producer.start()
    time.sleep(0.2)
    try:
        assert producer.is_alive() and runner.pending_docs() == 4
        runner.start()
        producer.join(timeout=10.0)
        assert not producer.is_alive()
        assert runner.flush(timeout=10.0)
    finally:
        runner.stop()
    assert sorted(idx.keys) == list(range(6))


# -- traces: per-stage spans sum to arrival -> retrievable ---------------------------------


def test_batch_trace_spans_are_contiguous_and_sum_to_the_root(monkeypatch):
    monkeypatch.setenv("PATHWAY_SLO_FRESHNESS_MS", "1")  # every batch is slow: force-kept
    runner, idx = _stub_runner("port", "t-spans", delay_s=0.005)
    with runner:
        conn = runner.connector()
        conn.insert(42, "the attributed document")
        conn.commit()
        assert runner.flush(timeout=10.0)
    kept = [t for t in trace.snapshot_traces()["traces"] if t["name"] == "ingest.batch" and t["attrs"]["docs"] == 1]
    assert kept, "a batch slower than the freshness threshold must keep its trace"
    t = kept[0]
    assert t["kind"] == "ingest" and t["keep_reason"] == "forced"
    assert t["attrs"]["generation"] == t["attrs"]["generation_before"] + 1 == idx.generation
    root = t["root"]
    stages = root["children"]
    assert [s["name"] for s in stages] == [
        "ingest.queue_wait", "ingest.embed", "ingest.absorb_plan", "ingest.commit",
    ]
    assert stages[0]["start_ms"] == 0.0
    for prev, nxt in zip(stages, stages[1:]):
        assert nxt["start_ms"] == pytest.approx(prev["start_ms"] + prev["duration_ms"], abs=1e-6)
    total_ms = sum(s["duration_ms"] for s in stages)
    assert stages[1]["duration_ms"] >= 4.0  # the stub's embed delay
    assert total_ms <= root["duration_ms"] and root["duration_ms"] - total_ms < 5.0


def test_ingest_trace_slow_rule_reads_the_freshness_histogram():
    assert trace._SLOW_HISTS["ingest"] is observe.histogram("pathway_freshness_seconds")
    assert trace._SLOW_HISTS["request"] is observe.histogram("pathway_serve_request_seconds")


# -- the freshness SLO: an aging backlog burns before it lands --------------------------------


def test_overdue_pending_burns_freshness_budget_as_reference():
    rows = {}
    for side, (obs, slo_mod, _inj, _cls, _reg) in SIDES.items():
        spec = slo_mod.SloSpec(
            "test_freshness", "freshness", objective=0.99,
            hist=f"pathway_test_overdue_{side}_seconds", threshold_s=0.01, shed=True,
        )
        engine = slo_mod.SloEngine([spec])
        first = engine.evaluate(max_age_s=0.0)["slos"]["test_freshness"]
        runner, _idx = _stub_runner(side, f"t-overdue-{side}", autostart=False)
        try:
            conn = runner.connector()
            conn.insert_rows([(i, f"stalled {i}") for i in range(5)])
            conn.commit()
            time.sleep(0.03)
            overdue = runner.overdue_pending(0.01)
            doc = engine.evaluate(max_age_s=0.0)
            row = doc["slos"]["test_freshness"]
            runner.start()
            assert runner.flush(timeout=10.0)
            after = (runner.overdue_pending(0.01), runner.pending_docs())
        finally:
            runner.stop()
        rows[side] = (
            first["state"], overdue, row["good"], row["total"], row["state"], doc["should_shed"], after,
            row["windows"]["fast"]["events"],
        )
    assert rows["port"] == rows["ref"]
    assert rows["port"] == ("ok", 5, 0, 5, "firing", True, (0, 0), 5)


def _firing_engine(slo_mod, obs, spec_name, hist_tag):
    spec = slo_mod.SloSpec(spec_name, "latency", objective=0.999, hist=f"pathway_test_{hist_tag}_seconds",
                           threshold_s=0.01, shed=True)
    engine = slo_mod.SloEngine([spec])
    hist = obs.histogram(f"pathway_test_{hist_tag}_seconds")
    engine.evaluate(max_age_s=0.0)
    for _ in range(300):
        hist.observe_ns(500_000_000)
    assert engine.evaluate(max_age_s=0.0)["should_shed"] is True
    return engine


def test_serve_latency_burn_backpressures_ingest_as_reference():
    got = {}
    for side, (obs, slo_mod, _inj, _cls, _reg) in SIDES.items():
        slo_mod._engine = _firing_engine(slo_mod, obs, "serve_latency", f"bp_{side}")
        shed0 = slo_mod.shed_advisory_enabled()
        slo_mod.set_shed_advisory(True)
        try:
            runner, idx = _stub_runner(side, f"t-bp-{side}")
            with runner:
                assert slo_mod.firing_specs() == ("serve_latency",)
                conn = runner.connector()
                conn.insert(7, "under pressure")
                conn.commit()
                assert runner.flush(timeout=10.0)
                deadline = time.monotonic() + 5.0
                while runner.stats["backpressure"] == 0 and time.monotonic() < deadline:
                    time.sleep(0.01)
                got[side] = (runner.stats["backpressure"] > 0, idx.keys)
        finally:
            slo_mod.set_shed_advisory(shed0)
            slo_mod.reset()
    assert got["port"] == got["ref"] == (True, [7])


def test_firing_specs_empty_with_the_probe_off():
    slo._engine = _firing_engine(slo, observe, "serve_latency", "probe_off")
    shed0 = slo.shed_advisory_enabled()
    try:
        slo.set_shed_advisory(False)
        assert slo.firing_specs() == () and slo.should_shed() is False
        slo.set_shed_advisory(True)
        assert slo.firing_specs() == ("serve_latency",) and slo.should_shed() is True
    finally:
        slo.set_shed_advisory(shed0)


# -- fault sites: poll retries, embed / commit drop ------------------------------------------------

_MODES = (("raise", {}), ("delay", {"delay_s": 5.0}), ("hang", {"hang_s": 30.0}))


@pytest.mark.parametrize("stage", ["poll", "embed", "commit"])
def test_stage_fault_sites_as_reference(stage):
    got = {}
    for side, (obs, _slo, inj, _cls, _reg) in SIDES.items():
        fail = obs.counter("pathway_ingest_failures_total", stage=stage)
        runner, idx = _stub_runner(side, f"t-chaos-{stage}-{side}")
        deltas = []
        with runner:
            conn = runner.connector()
            for n, (mode, kwargs) in enumerate(_MODES):
                f0, t0 = fail.value, time.monotonic()
                with inj.armed(f"ingest.{stage}", mode, times=1, **kwargs):
                    conn.insert(100 + n, f"doc under {mode}")
                    conn.commit()
                    assert runner.flush(timeout=10.0), mode
                assert time.monotonic() - t0 < 3.0, mode  # the spent deadline releases delay and hang
                deltas.append(fail.value - f0 > 0)
            conn.insert(200, "healthy after the storm")
            conn.commit()
            assert runner.flush(timeout=10.0)
            stats = runner.stats
        got[side] = (deltas, {k: stats[k] for k in ("docs", "dropped", "pending")}, sorted(idx.keys))
    assert got["port"] == got["ref"]
    if stage == "poll":  # retry: every document lands
        assert got["port"] == ([True] * 3, {"docs": 4, "dropped": 0, "pending": 0}, [100, 101, 102, 200])
    else:  # drop: only the faulted batches are lost
        assert got["port"] == ([True] * 3, {"docs": 1, "dropped": 3, "pending": 0}, [200])


def test_dropped_batch_leaves_serve_bit_identical(pair):
    ref_enc, enc = pair
    index = DeviceKnnIndex(32, metric="cos", initial_capacity=128, device="cpu")
    index.add(sorted(DOCS), ref_enc.encode([DOCS[k] for k in sorted(DOCS)]))
    serve = FusedEncodeSearch(enc, index, k=5)
    with ServeScheduler(serve, window_us=0, result_cache=None) as sched:
        clean = sched.serve(QUERIES[:3])
        with LiveIngestRunner(enc, index, name="t-drop-serve") as runner:
            conn = runner.connector()
            for site in ("ingest.embed", "ingest.commit"):
                with inject.armed(site, "raise", times=1):
                    conn.insert(900, "poisoned document")
                    conn.commit()
                    assert runner.flush(timeout=10.0)
                got = sched.serve(QUERIES[:3])
                assert got.degraded == () and list(got) == list(clean)
            assert runner.stats["dropped"] == 2 and len(index) == len(DOCS)


# -- the decision: shed under a real freshness burn ------------------------------------------------


def test_scheduler_sheds_low_under_freshness_burn_as_reference(pair, monkeypatch):
    ref_enc, enc = pair
    keys = sorted(DOCS)
    vecs = ref_enc.encode([DOCS[k] for k in keys])
    ref_index = RefKnn(32, metric="cos", initial_capacity=128)
    index = DeviceKnnIndex(32, metric="cos", initial_capacity=128, device="cpu")
    ref_index.add(keys, vecs)
    index.add(keys, vecs)
    targets = {
        "ref": (RefScheduler, RefServe(ref_enc, ref_index, k=5, embed_cache=None)),
        "port": (ServeScheduler, FusedEncodeSearch(enc, index, k=5)),
    }
    monkeypatch.setenv("PATHWAY_SLO_FRESHNESS_MS", "50")
    got = {}
    for side, (obs, slo_mod, _inj, _cls, _reg) in SIDES.items():
        sched_cls, target = targets[side]
        shed0 = slo_mod.shed_advisory_enabled()
        slo_mod.set_shed_advisory(True)
        engine = slo_mod.set_engine(None)  # the default specs, freshness at 50 ms
        engine.evaluate(max_age_s=0.0)
        backlog, _idx = _stub_runner(side, f"t-backlog-{side}", autostart=False)
        shed_low = obs.counter("pathway_serve_shed_total", priority="low")
        advised = obs.counter("pathway_slo_shed_advised_total")
        try:
            conn = backlog.connector()
            conn.insert_rows([(i, f"backlog {i}") for i in range(8)])
            conn.commit()
            time.sleep(0.12)  # the paused backlog ages past the threshold
            engine.evaluate(max_age_s=0.0)
            firing = slo_mod.firing_specs()
            s0, a0 = shed_low.value, advised.value
            with sched_cls(target, window_us=0, result_cache=None) as sched:
                low = sched.serve(QUERIES[:2], priority="low")
                high = sched.serve(QUERIES[:2], priority="high")
                shed_stat = sched.stats.get("shed", 0)
            monkeypatch.setenv("PATHWAY_SERVE_SHED", "0")
            with sched_cls(target, window_us=0, result_cache=None) as sched:
                advisory = sched.serve(QUERIES[:2], priority="low")
            monkeypatch.delenv("PATHWAY_SERVE_SHED")
            got[side] = (
                "freshness" in firing,
                low.degraded, low.meta.get("shed"), [list(r) for r in low], shed_low.value - s0, shed_stat,
                high.degraded, all(high), "shed" in high.meta,
                advisory.degraded, all(advisory), advised.value - a0 > 0,
            )
        finally:
            backlog.start()
            assert backlog.flush(timeout=10.0)
            backlog.stop()
            slo_mod.set_shed_advisory(shed0)
            slo_mod.reset()
    assert got["port"] == got["ref"]
    assert got["port"] == (True, ("load_shed",), True, [[], []], 1, 1, (), True, False, (), True, True)


# -- absorb under live serve traffic ---------------------------------------------------------------


def test_mid_run_document_becomes_retrievable_under_serve(pair):
    ref_enc, enc = pair
    stack = _live_stack(pair)
    _enc, ivf, fwd = stack["port"]
    sentinel_key, sentinel = 9000, "zebra quasar submarine fresh sentinel document"
    serve = FusedEncodeSearch(enc, ivf, k=8)
    gen0 = ivf.generation
    with ServeScheduler(serve, window_us=0, result_cache=None) as sched:
        with LiveIngestRunner(enc, ivf, fwd, name="t-live") as runner:
            conn = runner.connector("live-src")
            assert all(sched.serve(QUERIES))
            conn.insert(sentinel_key, sentinel)
            conn.commit(offsets={"p0": 1})
            ticket = sched.submit(QUERIES)  # in flight while the runner absorbs
            assert runner.flush(timeout=30.0)
            assert all(ticket())
        assert ivf.generation > gen0 and runner.stats["docs"] == 1
        got = sched.serve([sentinel])
    assert got.degraded == () and got[0][0][0] == sentinel_key
    assert sentinel_key in fwd._slot_of_key


def test_serves_racing_absorbs_return_consistent_rows(pair, monkeypatch):
    """The absorb writes slab rows in place and swaps ``keys_by_slot``
    while serves run on other threads: every served (key, score) must be
    that key's own row scored against the query."""
    monkeypatch.setenv("PATHWAY_INGEST_BATCH_DOCS", "4")
    ref_enc, enc = pair
    stack = _live_stack(pair)
    _enc, ivf, _fwd = stack["port"]
    queries = ref_enc.encode(QUERIES + [FRESH[k] for k in sorted(FRESH)[:8]])
    unit = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    stop = threading.Event()
    bad, served = [], [0]

    def serve_loop():
        while not stop.is_set():
            for qi, row in enumerate(ivf.search(queries, k=6, n_probe=4)):
                for key, score in row:
                    want = float(unit[qi] @ ivf._rows[key])
                    if abs(want - score) > 1e-5:
                        bad.append((qi, key, score, want))
            served[0] += 1

    threads = [threading.Thread(target=serve_loop, daemon=True) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        with LiveIngestRunner(enc, ivf, name="t-race") as runner:
            conn = runner.connector()
            for c in range(0, 40, 4):
                conn.insert_rows([(k, FRESH[k]) for k in sorted(FRESH)[c : c + 4]])
                conn.commit()
                time.sleep(0.005)
            assert runner.flush(timeout=60.0)
            _wait_maintenance(ivf)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30.0)
    assert ivf.stats["absorbs"] >= 2 and served[0] > 0
    assert bad == []
    assert all(k in ivf._slot_of_key or k in ivf._tail for k in FRESH)


# -- the encoder's embedding cache --------------------------------------------------------------------


def test_encoder_embed_cache_rows_as_plain_and_reference(pair):
    ref_enc, enc = pair
    texts = [DOCS[i] for i in (1, 2, 3, 1, 5)] + ["a query the cache has never seen"]
    plain = enc.encode_to_device(texts)
    ref_cached = _ref_cached_rows(ref_enc, texts)
    cache = EmbeddingCache(device="cpu")
    enc.set_embed_cache(cache)
    calls = []
    forward = enc.forward
    try:
        enc.forward = lambda ids, mask: calls.append(ids.shape[0]) or forward(ids, mask)
        first = enc.encode_to_device(texts)
        second = enc.encode_to_device(texts)
    finally:
        enc.set_embed_cache(None)
        del enc.forward
    assert calls == [16]  # one bucketed forward for the 6 misses, none on the repeat
    assert len(cache) == 5 and cache.stats["hits"] == len(texts)
    np.testing.assert_allclose(first.numpy(), plain.numpy(), atol=1e-5)
    np.testing.assert_allclose(first.numpy(), ref_cached, atol=1e-5)
    assert torch.equal(first, second)
    keys = sorted(k for k, _v, _n in cache._tier.warm_entries())
    assert all(k.startswith(b"encode:1\x00") for k in keys)


def _ref_cached_rows(ref_enc, texts):
    from pathway_tpu.cache import EmbeddingCache as RefEmbeddingCache

    ref_enc.set_embed_cache(RefEmbeddingCache())
    try:
        return np.asarray(ref_enc.encode_to_device(texts))
    finally:
        ref_enc.set_embed_cache(None)
