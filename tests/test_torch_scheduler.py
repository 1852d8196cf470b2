"""The port's coalescing serve scheduler (``pathway_tpu_torch/serve/``)
on the CPU: counterparts of the reference's ``tests/test_scheduler.py``
cases over the port's pipelines, then the port against the reference
with bridged weights and batches formed deterministically, the index
generation sequence, and the two cache tiers under the scheduler.

Bars, as in the reference: coalesced riders get what they would get
alone (keys rank for rank, scores within 1e-5 in f32) and BIT-identical
results to one sequential serve of the sorted-unique composition; one
coalesced batch costs one solo serve's dispatches and fetches; tight
deadlines serve solo; a stage-1 failure degrades exactly its batch's
riders.  Against the reference: keys equal, scores within 1e-5 (f32) or
3e-2 (bf16), flags and the integer ``stats`` equal.  Every wait has a
timeout and every scheduler is stopped.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models.cross_encoder import CrossEncoderModel as RefCrossEncoder
from pathway_tpu.models.encoder import SentenceEncoder as RefEncoder
from pathway_tpu.ops.ivf import IvfKnnIndex as RefIvf
from pathway_tpu.ops.knn import DeviceKnnIndex as RefKnn
from pathway_tpu.ops.retrieve_rerank import RetrieveRerankPipeline as RefPipeline
from pathway_tpu.ops.serving import FusedEncodeSearch as RefServe
from pathway_tpu.serve import ServeScheduler as RefScheduler
from pathway_tpu_torch import observe
from pathway_tpu_torch.cache import EmbeddingCache, ResultCache
from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel
from pathway_tpu_torch.models.encoder import SentenceEncoder
from pathway_tpu_torch.ops import dispatch_counter
from pathway_tpu_torch.ops.ivf import IvfKnnIndex
from pathway_tpu_torch.ops.knn import DeviceKnnIndex
from pathway_tpu_torch.ops.retrieve_rerank import RetrieveRerankPipeline
from pathway_tpu_torch.ops.serving import FusedEncodeSearch
from pathway_tpu_torch.robust import RETRIEVAL_FAILED, CircuitBreaker, Deadline, inject
from pathway_tpu_torch.serve import ServeScheduler, SharedBatcher
from pathway_tpu_torch.serve.scheduler import _ReplicaHandle

from .test_torch_ivf import assert_same_ranking

TIMEOUT = 60
WINDOW_US = 500_000  # wide enough that barrier-released callers share one window under load
_TOPICS = [
    "incremental dataflow", "vector indexes", "exactly once", "stream joins", "window aggregation",
    "schema registries", "kafka offsets", "snapshot replay", "rag retrieval", "sharded state",
    "commit ticks", "key ownership", "mesh collectives", "tokenizer ingest", "serving latency",
    "cross encoders", "top k selection", "packing rows", "circuit breakers", "tail sampling",
]
DOCS = {i: f"document number {i} about {_TOPICS[i % 20]} case {i % 7} part {i // 20}" for i in range(240)}
QUERIES = [
    "rag retrieval serving", "exactly once stream", "packing segment rows",
    "kafka offsets replay", "vector index search", "mesh collective sync",
]
ENC = dict(dimension=64, n_layers=2, n_heads=4, max_length=32, vocab_size=1024)
CE = dict(dimension=64, n_layers=2, n_heads=4, max_length=64, vocab_size=1024)


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


def _models(dtype):
    """The reference's encoder and cross-encoder, and the port's with the
    same weights (bridge)."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref_enc = RefEncoder(dtype=jdt, **ENC)
    ref_ce = RefCrossEncoder(dtype=jdt, **CE)
    tree = lambda m: jax.tree_util.tree_map(np.asarray, m.params)  # noqa: E731
    enc = SentenceEncoder(dtype=tdt, device="cpu", params=tree(ref_enc), **ENC)
    ce = CrossEncoderModel(dtype=tdt, device="cpu", params=tree(ref_ce), **CE)
    return ref_enc, ref_ce, enc, ce


@pytest.fixture(scope="module")
def stack():
    ref_enc, ref_ce, enc, ce = _models("f32")
    keys = sorted(DOCS)
    vecs = ref_enc.encode([DOCS[i] for i in keys])
    index = DeviceKnnIndex(64, metric="cos", initial_capacity=256, device="cpu")
    index.add(keys, vecs)
    ref_index = RefKnn(64, metric="cos", initial_capacity=256)
    ref_index.add(keys, vecs)
    return {"port": (enc, ce, index), "ref": (ref_enc, ref_ce, ref_index), "vecs": vecs}


def _pipeline(stack, k=5, candidates=16):
    enc, ce, index = stack["port"]
    pipe = RetrieveRerankPipeline(FusedEncodeSearch(enc, index, k=8), ce, DOCS, k=k, candidates=candidates)
    pipe._breaker = CircuitBreaker("scheduler-tests", failure_threshold=1000)
    return pipe


def _together(calls):
    """Run each ``(tag, fn)`` in a thread of its own, released together by
    a barrier so the calls land in one window; returns {tag: fn()}."""
    results, errors = {}, []
    barrier = threading.Barrier(len(calls))

    def worker(tag, fn):
        try:
            barrier.wait(timeout=10)
            results[tag] = fn()
        except Exception as exc:  # noqa: BLE001 - surfaces in the assert below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=c) for c in calls]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not errors and not any(t.is_alive() for t in threads), errors
    return results


def _concurrent(sched, queries, k=None, deadline=None):
    """One single-query request per thread; returns {query: result}."""
    return _together([(q, lambda q=q: sched.submit([q], k, deadline=deadline).result(timeout=TIMEOUT)) for q in queries])


def test_concurrent_callers_match_sequential(stack):
    pipe = _pipeline(stack)
    solo = {q: pipe([q]) for q in QUERIES}
    with ServeScheduler(pipe, window_us=WINDOW_US, result_cache=None) as sched:
        results = _concurrent(sched, QUERIES)
        assert sched.stats["batches"] == 1 and sched.stats["requests"] == len(QUERIES), sched.stats
    for q in QUERIES:
        assert_same_ranking(list(solo[q][0]), list(results[q][0]), atol=1e-5)
        assert results[q].degraded == ()


def test_bit_identical_to_sequential_shared_batch(stack):
    pipe = _pipeline(stack)
    reference = pipe(sorted(QUERIES), k=5)
    with ServeScheduler(pipe, window_us=WINDOW_US, result_cache=None) as sched:
        results = _concurrent(sched, QUERIES)
    order = sorted(QUERIES)
    for q in QUERIES:
        assert results[q][0] == reference[order.index(q)]  # floats compared bit for bit


def test_dedup_encodes_once_and_scatters(stack):
    pipe = _pipeline(stack)
    hot = QUERIES[0]
    with ServeScheduler(pipe, window_us=WINDOW_US, result_cache=None) as sched:
        with dispatch_counter.DispatchCounter() as counter:
            res = _together([(i, lambda: sched.submit([hot]).result(timeout=TIMEOUT)) for i in range(8)])
        assert sched.stats["dedup_hits"] >= 7, sched.stats
    rows = [res[i] for i in range(8)]
    assert all(r == rows[0] for r in rows)
    assert counter.dispatches <= 4 and counter.fetches <= 4, counter.events


def test_per_batch_dispatch_budget_amortizes(stack):
    """Six riders in one batch cost one solo serve's 2 + 2."""
    pipe = _pipeline(stack)
    with dispatch_counter.DispatchCounter() as solo:
        pipe(QUERIES[:1])
    with ServeScheduler(pipe, window_us=WINDOW_US, result_cache=None) as sched:
        with dispatch_counter.DispatchCounter() as counter:
            _concurrent(sched, QUERIES)
        assert sched.stats["batches"] == 1, sched.stats
    assert (counter.dispatches, counter.fetches) == (solo.dispatches, solo.fetches) == (2, 2), counter.events


def test_tight_deadline_preempts_window(stack):
    pipe = _pipeline(stack)
    want = pipe([QUERIES[0]])
    # a 4 s deadline is within four 2 s windows: the request must not wait one
    with ServeScheduler(pipe, window_us=2_000_000, result_cache=None) as sched:
        t0 = time.perf_counter()
        got = sched.submit([QUERIES[0]], deadline=Deadline.after_ms(4000)).result(timeout=TIMEOUT)
        elapsed = time.perf_counter() - t0
        assert sched.stats["solo"] == 1 and sched.stats["batches"] == 0, sched.stats
    assert elapsed < 1.5, elapsed
    assert [key for key, _ in got[0]] == [key for key, _ in want[0]]


def test_mixed_k_requests_truncate_from_shared_batch(stack):
    pipe = _pipeline(stack, k=8)
    want3, want7 = pipe([QUERIES[0]], k=3), pipe([QUERIES[1]], k=7)
    with ServeScheduler(pipe, window_us=WINDOW_US, result_cache=None) as sched:
        out = _together([(k, lambda q=q, k=k: sched.submit([q], k).result(timeout=TIMEOUT))
                         for q, k in ((QUERIES[0], 3), (QUERIES[1], 7))])
        assert sched.stats["batches"] == 1, sched.stats
    assert len(out[3][0]) == 3 and len(out[7][0]) == 7
    assert [key for key, _ in out[3][0]] == [key for key, _ in want3[0]]
    assert [key for key, _ in out[7][0]] == [key for key, _ in want7[0]]


def test_stage1_failure_degrades_only_affected_requests(stack):
    pipe = _pipeline(stack)
    counter = observe.counter("pathway_serve_degraded_total", reason=RETRIEVAL_FAILED)
    before = counter.value
    riders = QUERIES[:4]
    with ServeScheduler(pipe, window_us=WINDOW_US, result_cache=None) as sched:
        # 3 raises = the stage-1 launch's whole retry budget, for ONE batch
        with inject.armed("serve.dispatch", "raise", times=3):
            results = _concurrent(sched, riders)
        for q in riders:
            assert results[q] == [[]] and RETRIEVAL_FAILED in results[q].degraded
        assert counter.value - before == len(riders)  # per request, not per batch
        clean = sched.submit([QUERIES[4]]).result(timeout=TIMEOUT)
        assert clean.degraded == () and clean[0]


def test_stop_drains_pending_tickets(stack):
    pipe = _pipeline(stack)
    sched = ServeScheduler(pipe, window_us=50_000, result_cache=None)
    tickets = [sched.submit([q]) for q in QUERIES[:3]]
    sched.stop()
    for t in tickets:
        assert t.result(timeout=TIMEOUT)[0]
    assert sched.serve([QUERIES[0]])[0]  # after stop: solo on the caller's thread
    assert sched.stats["solo"] >= 1


def test_tokenize_runs_off_the_serve_lock(stack):
    enc, _, index = stack["port"]
    serve = FusedEncodeSearch(enc, index, k=4)
    calls = []
    orig = enc.tokenizer.encode_batch

    def checked(*args, **kwargs):
        calls.append(serve._lock.locked())
        return orig(*args, **kwargs)

    enc.tokenizer.encode_batch = checked
    hist = observe.histogram("pathway_serve_stage_seconds", stage="tokenize_pack")
    before = hist.count
    try:
        assert serve.submit([QUERIES[0]])()[0]
    finally:
        enc.tokenizer.encode_batch = orig
    assert calls and not any(calls)
    assert hist.count == before + 1


def _pairs(idx):
    return [(QUERIES[0], DOCS[i]) for i in idx]


def test_shared_batcher_matches_predict_and_dedups(stack):
    _, ce, _ = stack["port"]
    pairs_a, pairs_b = _pairs((0, 3, 9, 17)), _pairs((3, 9, 21, 25))
    want_a, want_b = ce.predict(pairs_a), ce.predict(pairs_b)
    with SharedBatcher(ce.submit, window_us=WINDOW_US) as batcher:
        out = _together([(tag, lambda items=items: batcher.submit(items).result(timeout=TIMEOUT))
                         for tag, items in (("a", pairs_a), ("b", pairs_b))])
        assert batcher.stats["batches"] == 1 and batcher.stats["dedup_hits"] == 2, batcher.stats
    np.testing.assert_allclose(out["a"], want_a, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["b"], want_b, rtol=1e-4, atol=1e-4)


def test_shared_batcher_reranks_like_predict(stack):
    """The reference's QA rerank through a SharedBatcher, on the port:
    ordering documents by the batcher's scores gives predict's order."""
    _, ce, _ = stack["port"]
    docs = [DOCS[i] for i in (0, 3, 8, 14, 21, 30)]
    pairs = [(QUERIES[0], d) for d in docs]
    want = sorted(zip(ce.predict(pairs).tolist(), docs), reverse=True)
    with SharedBatcher(ce.submit, window_us=5_000) as batcher:
        got = sorted(zip(batcher.submit(pairs).result(timeout=TIMEOUT).tolist(), docs), reverse=True)
        assert batcher.stats["batches"] >= 1
    assert [d for _, d in got] == [d for _, d in want]
    np.testing.assert_allclose([s for s, _ in got], [s for s, _ in want], rtol=1e-4, atol=1e-4)


def test_scheduler_thread_survives_bad_items(stack):
    _, ce, _ = stack["port"]
    good = _pairs((0, 3))
    want = ce.predict(good)
    with SharedBatcher(ce.submit, window_us=10_000) as batcher:
        with pytest.raises(Exception):
            batcher.submit([["unhashable", "list-item"]]).result(timeout=TIMEOUT)
        np.testing.assert_allclose(batcher.submit(good).result(timeout=TIMEOUT), want, rtol=1e-4, atol=1e-4)


def _wait(cond, timeout=20.0):
    t0 = time.time()
    while not cond():
        assert time.time() - t0 < timeout, "condition not reached"
        time.sleep(0.005)


def test_dedup_key_includes_index_generation(stack):
    """An absorb landing inside an open window bumps the generation: a
    later duplicate gets its own slot, not one dispatched against the
    pre-absorb index."""
    enc, ce, _ = stack["port"]
    keys = sorted(DOCS)
    ivf = IvfKnnIndex(64, metric="cos", absorb_threshold=8, device="cpu")
    ivf.add(keys, stack["vecs"])
    ivf.build()
    pipe = RetrieveRerankPipeline(FusedEncodeSearch(enc, ivf, k=8), ce, DOCS, k=5, candidates=16)
    assert pipe.index_generation() == ivf.generation
    with ServeScheduler(pipe, window_us=400_000, result_cache=None) as sched:
        t1 = sched.submit([QUERIES[0]])
        g0 = ivf.generation
        noise = np.random.default_rng(5).standard_normal((16, 64)).astype(np.float32) * 0.01
        ivf.add([10_000 + i for i in range(16)], np.tile(stack["vecs"][:1], (16, 1)) + noise)
        _wait(lambda: ivf.generation > g0 and not ivf._absorbing)
        t2 = sched.submit([QUERIES[0]])
        r1, r2 = t1.result(timeout=TIMEOUT), t2.result(timeout=TIMEOUT)
        assert sched.stats["dedup_hits"] == 0 and sched.stats["items_dispatched"] == 2, sched.stats
        assert r1[0] and r2[0]
        fresh = pipe([QUERIES[0]], k=5)
        assert [key for key, _ in r2[0]] == [key for key, _ in fresh[0]]
        # same-generation duplicates still share a slot
        res = _together([(i, lambda: sched.submit([QUERIES[1]]).result(timeout=TIMEOUT)) for i in range(2)])
        assert res[0] == res[1] and sched.stats["dedup_hits"] >= 1, sched.stats


def test_replica_placement_fairness(stack):
    pipe_a, pipe_b = _pipeline(stack), _pipeline(stack)
    want = pipe_a([QUERIES[0]], k=5)
    with ServeScheduler(pipe_a, window_us=5_000, replicas=[pipe_b], result_cache=None) as sched:
        for i in range(8):
            got = sched.submit([QUERIES[i % len(QUERIES)]], k=5).result(timeout=TIMEOUT)
            assert got and got[0]
        assert list(sched._placed) == [4, 4] and sched._inflight == [0, 0]
        names = "\n".join(list(observe.snapshot()["gauges"]) + list(observe.snapshot()["counters"]))
        assert "pathway_serve_replica_depth" in names and "pathway_serve_replica_batches_total" in names
        got = sched.submit([QUERIES[0]], k=5).result(timeout=TIMEOUT)
        assert [key for key, _ in got[0]] == [key for key, _ in want[0]]


def test_slow_replica_sheds_load(stack):
    pipe_a, pipe_b = _pipeline(stack), _pipeline(stack)

    class Stuck:
        def __init__(self, inner):
            self.inner = inner
            self.release = threading.Event()

        def submit(self, texts, k=None, deadline=None, n_requests=1):
            handle = self.inner.submit(texts, k, deadline=deadline, n_requests=n_requests)

            def complete():
                self.release.wait(30)
                return handle()

            complete.advance = getattr(handle, "advance", lambda: None)
            return complete

    stuck = Stuck(pipe_b)
    with ServeScheduler(pipe_a, window_us=2_000, replicas=[stuck], result_cache=None) as sched:
        tickets = [sched.submit([q]) for q in QUERIES[:4]]
        time.sleep(0.3)
        placed_mid = list(sched._placed)
        stuck.release.set()
        assert all(t.result(timeout=TIMEOUT)[0] for t in tickets)
    assert placed_mid[0] >= placed_mid[1], placed_mid


def test_queue_metrics_reach_the_scrape_surface(stack):
    pipe = _pipeline(stack)
    with ServeScheduler(pipe, window_us=10_000, name="torch-metrics-test", result_cache=None) as sched:
        sched.submit([QUERIES[0]]).result(timeout=TIMEOUT)
        snap = observe.snapshot()
        names = list(snap["counters"]) + list(snap["gauges"])
        assert 'pathway_serve_queue_batches_total{scheduler="torch-metrics-test"}' in names
        joined = "\n".join(names)
        for family in ("pathway_serve_queue_depth", "pathway_serve_queue_requests_total",
                       "pathway_serve_queue_queries_total"):
            assert family in joined
        assert "pathway_serve_queue_wait_seconds" in "\n".join(snap["histograms"])
    assert any(line.startswith("pathway_serve_queue_depth") for line in observe.render_prometheus())


def test_replica_handle_releases_exactly_once():
    released = []

    def boom():
        raise RuntimeError("batch died")

    h = _ReplicaHandle(boom, lambda: released.append("boom"))
    for _ in range(2):
        with pytest.raises(RuntimeError):
            h()
    ok = _ReplicaHandle(lambda: "rows", lambda: released.append("ok"))
    assert ok() == ok() == "rows"
    assert released == ["boom", "ok"]


def test_replica_submit_raise_releases_slot_exactly_once(stack):
    pipe = _pipeline(stack)

    class Exploding:
        calls = 0

        def submit(self, texts, k=None, deadline=None, n_requests=1):
            type(self).calls += 1
            raise RuntimeError("replica died at submit")

    with ServeScheduler(pipe, window_us=2_000, replicas=[Exploding()], result_cache=None) as sched:
        releases = []
        orig = sched._release_replica
        sched._release_replica = lambda r: (releases.append(r), orig(r))
        for i in range(6):
            assert isinstance(sched.submit([QUERIES[i % len(QUERIES)]]).result(timeout=TIMEOUT), list)
        assert Exploding.calls > 0
        assert len(releases) == sum(sched._placed) and sched._inflight == [0, 0]
        assert sched.submit([QUERIES[0]]).result(timeout=TIMEOUT)[0]


# -- the port against the reference ---------------------------------------------


def _drive(sched, requests):
    """Admit ``requests`` (text, k) into the queue with no scheduler
    thread running, then form and dispatch the batches on this thread:
    batch composition is the same in both packages, whatever the timing."""
    sched._running = True
    tickets = [sched.submit([q], k) for q, k in requests]
    sched._running = False
    while True:
        reqs = sched._pop_batch()
        if not reqs:
            break
        sched._dispatch_batch(reqs)
    return [t.result(timeout=TIMEOUT) for t in tickets]


# (text, k): the six queries in turn with mixed k, then repeats; at 4 unique
# texts per batch the queue forms 3 batches (4; 4 unique + 1 duplicate; 1)
_REQUESTS = [(QUERIES[i % 6], k) for i, k in enumerate([5, 5, 3, 5, 5, 5, 2, 5])] + [(QUERIES[0], 5), (QUERIES[2], 5)]


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 3e-2)])
def test_scheduler_matches_reference(dtype, tol):
    """Reference scheduler over the reference pipeline vs the port's over
    the port's, same weights, same deterministic batches (``max_batch`` 4
    unique texts), the tier-0 cache on: a second pass is all hits."""
    ref_enc, ref_ce, enc, ce = _models(dtype)
    keys = sorted(DOCS)[:40]
    texts = [DOCS[i] for i in keys]
    vecs = np.asarray(ref_enc.encode(texts), np.float32)
    ref_index = RefKnn(64, metric="cos", initial_capacity=64)
    ref_index.add(keys, vecs)
    index = DeviceKnnIndex(64, metric="cos", initial_capacity=64, device="cpu")
    index.add(keys, vecs)
    docs = {i: DOCS[i] for i in keys}
    # every document is a stage-1 candidate: the rerank sees the same set
    ref_pipe = RefPipeline(RefServe(ref_enc, ref_index, k=8, embed_cache=None), ref_ce, docs, k=5, candidates=40)
    pipe = RetrieveRerankPipeline(FusedEncodeSearch(enc, index, k=8), ce, docs, k=5, candidates=40)
    from pathway_tpu.cache import ResultCache as RefResultCache

    outs, stats = [], []
    for sched_cls, p, cache in (
        (RefScheduler, ref_pipe, RefResultCache(max_bytes=1 << 20)),
        (ServeScheduler, pipe, ResultCache(max_bytes=1 << 20)),
    ):
        sched = sched_cls(p, max_batch=4, autostart=False, result_cache=cache)
        first = _drive(sched, _REQUESTS)
        second = _drive(sched, _REQUESTS)
        outs.append((first, second))
        stats.append({key: sched.stats[key] for key in
                      ("requests", "solo", "batches", "items", "items_dispatched", "dedup_hits", "cache_hits")})
    assert stats[0] == stats[1]
    assert (stats[1]["batches"], stats[1]["items_dispatched"], stats[1]["dedup_hits"]) == (3, 9, 1)
    assert stats[1]["cache_hits"] == len(_REQUESTS)
    (want1, want2), (got1, got2) = outs
    for w, g, g2 in zip(want1, got1, got2):
        assert g.degraded == w.degraded == () and g2 == g  # the cache hit is the stored rows
        assert_same_ranking(list(w[0]), list(g[0]), tie=tol, atol=tol)
    assert want2 == want1


def test_generation_sequence_matches_reference(stack):
    """Index generations bump where the reference's do: exact add,
    upsert, remove, no-op remove; IVF add, build, absorb, upsert, remove,
    and a background retrain (absorb held off)."""
    vecs = np.random.default_rng(0).normal(size=(400, 16)).astype(np.float32)
    seqs = []
    for make in (lambda: RefKnn(16, initial_capacity=16), lambda: DeviceKnnIndex(16, initial_capacity=16, device="cpu")):
        ix = make()
        seq = [ix.generation]
        for step in (lambda: ix.add(list(range(100)), vecs[:100]), lambda: ix.add(list(range(50, 150)), vecs[50:150]),
                     lambda: ix.remove(list(range(10, 20))), lambda: ix.remove([9999])):
            step()
            seq.append(ix.generation)
        seqs.append(seq)
    assert seqs[0] == seqs[1] == [0, 1, 3, 4, 4]
    seqs = []
    for cls, kw in ((RefIvf, {}), (IvfKnnIndex, {"device": "cpu"})):
        absorbing = cls(16, n_clusters=4, seed=1, absorb_threshold=8, **kw)
        retraining = cls(16, n_clusters=4, seed=1, absorb_threshold=100_000, **kw)
        seq = []
        for ix, steps in (
            (absorbing, [(range(200), None), ("build", None), (range(200, 210), None), (range(205, 215), None),
                         ("remove", range(5))]),
            (retraining, [(range(100), None), ("build", None), (range(100, 200), None)]),
        ):
            seq.append(ix.generation)
            for step, arg in steps:
                if step == "build":
                    ix.build()
                elif step == "remove":
                    ix.remove(list(arg))
                else:
                    ix.add(list(step), vecs[step.start:step.stop])
                _wait(lambda: not ix._absorbing and not ix._retraining)
                seq.append(ix.generation)
        assert retraining.stats["retrains"] == 1
        seqs.append(seq)
    assert seqs[0] == seqs[1]


# -- the cache tiers under the scheduler -------------------------------------------


def test_result_cache_zero_dispatch_bit_identical_and_invalidated(stack):
    pipe = _pipeline(stack)
    cache = ResultCache(max_bytes=1 << 20)
    with ServeScheduler(pipe, window_us=5_000, result_cache=cache) as sched:
        first = [sched.submit([q]).result(timeout=TIMEOUT) for q in QUERIES]
        with dispatch_counter.DispatchCounter() as counter:
            again = [sched.submit([q]).result(timeout=TIMEOUT) for q in QUERIES]
        assert counter.dispatches == counter.fetches == 0
        assert again == first and sched.stats["cache_hits"] == len(QUERIES)
        # a mutation bumps the generation: the next serve dispatches again
        _, _, index = stack["port"]
        index.add([999_999], stack["vecs"][:1])
        try:
            with dispatch_counter.DispatchCounter() as counter:
                fresh = sched.submit([QUERIES[0]]).result(timeout=TIMEOUT)
            assert counter.dispatches == 2 and fresh.meta["index_generation"] == index.generation
        finally:
            index.remove([999_999])


def test_embedding_cache_serve_matches_reference_and_skips_the_encode(stack):
    (ref_enc, _, ref_index), (enc, _, index) = stack["ref"], stack["port"]
    from pathway_tpu.cache import EmbeddingCache as RefEmbeddingCache

    ref_serve = RefServe(ref_enc, ref_index, k=6, embed_cache=RefEmbeddingCache(max_bytes=1 << 20))
    serve = FusedEncodeSearch(enc, index, k=6, embed_cache=EmbeddingCache(max_bytes=1 << 20))
    plain = FusedEncodeSearch(enc, index, k=6, embed_cache=None)
    for batch in (QUERIES[:3], QUERIES[1:5], QUERIES):
        want, got = ref_serve(batch), serve(batch)
        for w, g, p in zip(want, got, plain(batch)):
            assert_same_ranking(list(w), list(g), atol=1e-5)
            assert_same_ranking(list(p), list(g), atol=1e-5)
        assert serve.embed_cache.stats == ref_serve.embed_cache.stats
    with dispatch_counter.DispatchCounter() as counter:
        serve(QUERIES)  # every row cached: search only, no encode
    assert (counter.dispatches, counter.physical_dispatches) == (1, 1)
    with dispatch_counter.DispatchCounter() as counter:
        serve(QUERIES + ["a query never seen"])
    assert (counter.dispatches, counter.physical_dispatches) == (1, 2)
