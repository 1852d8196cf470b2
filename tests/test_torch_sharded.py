"""Port parity of the sharded serve tier on the CPU: ``ShardGroup``,
``ShardedIvfIndex``, the mesh-sharded ``DeviceKnnIndex``,
``ShardedForwardIndex`` and ``FusedEncodeSearch``'s scatter dispatch
with its on-device tree merge, against ``pathway_tpu``'s, in the fixture
of ``tests/test_sharded_serve.py`` (d 32, 2 layers, 4 heads, max_length
32, vocab 512, f32, its 108 documents and 6 queries).

The reference runs on the 8 CPU devices ``tests/conftest.py`` forces,
the port on 8 logical shards of ``cpu``, with the reference's encoder
weights carried over.  Integer outputs (keys, slots, shard ordinals,
candidate ids) must equal the reference's exactly; scores agree within
1e-5 across the packages (f32 sums in another order), and bit for bit
within the port where the reference's own test demands it (device merge
against host merge, 8 shards against 1 at full probe, sharded against
unsharded forward tables).  Mesh exact against unsharded: scores within
1e-6, keys equal.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.index.forward import ShardedForwardIndex as RefShardedForward
from pathway_tpu.models.encoder import SentenceEncoder as RefEncoder
from pathway_tpu.ops.ivf import ShardedIvfIndex as RefShardedIvf
from pathway_tpu.ops.knn import DeviceKnnIndex as RefKnn
from pathway_tpu.ops.retrieve_rerank import RetrieveRerankPipeline as RefPipeline
from pathway_tpu.ops.serving import FusedEncodeSearch as RefServe
from pathway_tpu.parallel.mesh import make_mesh as ref_make_mesh
from pathway_tpu_torch import observe
from pathway_tpu_torch.index import ForwardIndex, ShardedForwardIndex
from pathway_tpu_torch.models.encoder import SentenceEncoder
from pathway_tpu_torch.ops import dispatch_counter
from pathway_tpu_torch.ops.ivf import ShardedIvfIndex
from pathway_tpu_torch.ops.knn import DeviceKnnIndex
from pathway_tpu_torch.ops.retrieve_rerank import RetrieveRerankPipeline
from pathway_tpu_torch.ops.serving import FusedEncodeSearch, _merge_shard_lists
from pathway_tpu_torch.parallel import FleetPartitionMap, ShardGroup, make_mesh
from pathway_tpu_torch.robust import RETRIEVAL_FAILED, SHARD_SKIPPED, inject
from pathway_tpu_torch.serve import ServeScheduler

from .test_torch_ivf import assert_same_ranking

DOCS = {
    i: f"document number {i} about {topic} case {i % 7} with live updates"
    for i, topic in enumerate(
        [
            "incremental dataflow", "vector indexes", "exactly once",
            "stream joins", "window aggregation", "schema registries",
            "kafka offsets", "snapshot replay", "rag retrieval",
            "sharded state", "commit ticks", "key ownership",
            "mesh collectives", "tokenizer ingest", "serving latency",
            "cross encoders", "top k selection", "packing rows",
        ]
        * 6
    )
}
QUERIES = [
    "rag retrieval serving", "exactly once stream", "packing segment rows",
    "kafka offsets replay", "vector index search", "mesh collective sync",
]
ENC = dict(dimension=32, n_layers=2, n_heads=4, max_length=32, vocab_size=512)
CPU = [torch.device("cpu")]
FULL = 10 ** 6  # n_probe past every shard's cluster count


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    inject.disarm()


@pytest.fixture(scope="module")
def encs():
    ref = RefEncoder(dtype=jnp.float32, **ENC)
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    return ref, SentenceEncoder(dtype=torch.float32, device="cpu", params=tree, **ENC)


@pytest.fixture(scope="module")
def corpus(encs):
    keys = sorted(DOCS)
    return keys, np.array(encs[0].encode([DOCS[i] for i in keys]))


def _port(corpus, n_shards, n_probe=None, **kw):
    keys, vecs = corpus
    idx = ShardedIvfIndex(32, n_shards=n_shards, devices=CPU, n_probe=n_probe, **kw)
    idx.add(keys, vecs)
    idx.build()
    return idx


def _ref(corpus, n_shards, n_probe=None, **kw):
    keys, vecs = corpus
    idx = RefShardedIvf(32, n_shards=n_shards, n_probe=n_probe, **kw)
    idx.add(keys, vecs)
    idx.build()
    return idx


def _tail_rows(encs):
    """Six fresh rows (one an upsert of key 3) for the exact tails."""
    keys = [1001, 1002, 1003, 1004, 1005, 3]
    return keys, np.asarray(encs[0].encode([f"fresh tail row {k} about stream joins" for k in keys]))


def _assert_same_layout(ref_idx, idx):
    assert len(idx.shards) == len(ref_idx.shards)
    for want, got in zip(ref_idx.shards, idx.shards):
        assert got._slot_of_key == want._slot_of_key
        np.testing.assert_array_equal(got._keys_by_slot, want._keys_by_slot)
        assert list(got._tail) == list(want._tail)
        np.testing.assert_array_equal(torch.isneginf(got._bias).numpy(), np.isneginf(np.asarray(want._bias)))
        np.testing.assert_allclose(got._slabs.numpy(), np.asarray(want._slabs), atol=1e-6)


# -- routing ------------------------------------------------------------------

def test_group_routing_and_placement():
    group = ShardGroup(n_shards=5, devices=CPU * 2)
    assert len(group) == 5 and group.device(4) == torch.device("cpu") and group.spans_devices == 1
    keys = [0, 7, 12, 5, 1 << 40, 9]
    assert [group.owner_of(k) for k in keys] == [k % 5 for k in keys]
    assert group.route(keys) == {0: [0, 3], 2: [1, 2], 1: [4], 4: [5]}
    fleet = FleetPartitionMap(3)
    assert len(fleet) == 3 and fleet.route(keys) == {0: [0, 2, 5], 1: [1, 4], 2: [3]}
    with pytest.raises(ValueError):
        FleetPartitionMap(0)


def test_serve_shards_knob(monkeypatch):
    monkeypatch.setenv("PATHWAY_SERVE_SHARDS", "6")
    assert ShardGroup(devices=CPU).n_shards == 6
    monkeypatch.setenv("PATHWAY_SERVE_SHARDS", "0")
    assert ShardGroup(devices=CPU * 3).n_shards == 3  # one per device


# -- layouts --------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_layouts_match_reference_after_add_and_build(corpus, encs, n_shards):
    ref_idx, idx = _ref(corpus, n_shards), _port(corpus, n_shards)
    tk, tv = _tail_rows(encs)
    ref_idx.add(tk, tv)
    idx.add(tk, tv)
    _assert_same_layout(ref_idx, idx)
    assert len(idx) == len(ref_idx) and idx.generation == ref_idx.generation


def _wait(*indexes):
    deadline = time.time() + 30
    children = [c for ix in indexes for c in ix.shards]
    while time.time() < deadline and any(c._absorbing or c._retraining for c in children):
        time.sleep(0.005)


def test_layouts_match_reference_after_absorb(corpus):
    keys, vecs = corpus
    half = len(keys) // 2
    pair = []
    for make in (RefShardedIvf, lambda *a, **k: ShardedIvfIndex(*a, devices=CPU, **k)):
        idx = make(32, n_shards=4, n_probe=FULL, absorb_threshold=8)
        idx.add(keys[:half], vecs[:half])
        idx.build()
        pair.append(idx)
    ref_idx, idx = pair
    for i in range(half, len(keys), 16):  # each commit waits out the absorbs it starts
        for ix in pair:
            ix.add(keys[i : i + 16], vecs[i : i + 16])
        _wait(*pair)
    assert sum(c.stats["absorbs"] for c in idx.shards) >= 4
    assert [c.stats["absorbs"] for c in idx.shards] == [c.stats["absorbs"] for c in ref_idx.shards]
    _assert_same_layout(ref_idx, idx)
    for s, child in enumerate(idx.shards):
        assert all(idx.group.owner_of(key) == s for key in child._rows)


# -- per-shard packed outputs and the merge ---------------------------------------

@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_shard_lists_and_merge_match_reference(corpus, encs, n_shards):
    ref_enc, enc = encs
    ref_idx, idx = _ref(corpus, n_shards), _port(corpus, n_shards)
    tk, tv = _tail_rows(encs)
    ref_idx.add(tk, tv)
    idx.add(tk, tv)
    ref_serve, serve = RefServe(ref_enc, ref_idx, k=5, embed_cache=None), FusedEncodeSearch(enc, idx, k=5)
    ids, mask = ref_enc.tokenizer.encode_batch(QUERIES)
    ids, mask = np.asarray(ids), np.asarray(mask)
    pad = np.zeros((16 - len(QUERIES), ids.shape[1]), ids.dtype)  # the 16-query bucket
    ids, mask = np.concatenate([ids, pad]), np.concatenate([mask, pad])
    B, L, K = ids.shape[0], ids.shape[1], 5
    z_ref = ref_serve._encode_fn(B, L)(ref_enc.params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        z, _ = serve._embed(ids, mask)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-5)
    want_lists, got_lists = [], []
    for ref_child, child in zip(ref_idx.shards, idx.shards):
        tail, tail_dev, tail_valid, t_pad = ref_child._tail_snapshot_device()
        fn, n_slotspace = ref_serve._shard_search_fn(ref_child, B, K, t_pad)
        want = np.asarray(fn(z_ref, ref_child._slabs, ref_child._bias, jnp.asarray(ref_child._centroids),
                             tail_dev, tail_valid))
        _, port_tail_dev = child._tail_snapshot_device()
        with torch.no_grad():
            got = serve._shard_step(child, z, K, child.probe_count(), port_tail_dev).numpy()
        assert n_slotspace == child._slabs.shape[0] * child._M_pad
        # the real query rows (a pad row's zero embedding ties every
        # candidate at +-0 and is never read)
        n = len(QUERIES)
        np.testing.assert_array_equal(got[:n, K:], want[:n, K:])  # slot / n_slotspace + tail row / -1
        np.testing.assert_allclose(got[:n, :K].view(np.float32), want[:n, :K].view(np.float32), atol=1e-5)
        want_lists.append(want)
        got_lists.append(got)
    ref_merged = np.asarray(ref_serve._merge_fn(n_shards, B, K)(*want_lists))
    # fed the reference's lists, the port's merge is the reference's bit
    # for bit, pad rows included
    fed = _merge_shard_lists([torch.from_numpy(np.array(a)) for a in want_lists], K).numpy()
    np.testing.assert_array_equal(fed, ref_merged)
    own = _merge_shard_lists([torch.from_numpy(a) for a in got_lists], K).numpy()
    np.testing.assert_array_equal(own[:n, K:], ref_merged[:n, K:])  # live ordinals, candidate ids
    # the served rows equal the reference's
    for w, g in zip(ref_serve(QUERIES, k=5), serve(QUERIES, k=5)):
        assert_same_ranking(w, g)


# -- serve-path identities (the reference's own account) -----------------------------

def test_sharded_serve_matches_host_search(corpus, encs):
    serve = FusedEncodeSearch(encs[1], _port(corpus, 8), k=5)
    want = serve.index.search(encs[1].encode(QUERIES), 5)
    for g, w in zip(serve(QUERIES, k=5), want):
        assert [k for k, _ in g] == [k for k, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=1e-5, atol=1e-6)


def test_device_merge_bit_identical_to_host_merge(corpus, encs):
    serve = FusedEncodeSearch(encs[1], _port(corpus, 8), k=5)
    dev = serve(QUERIES, k=5)
    serve.shard_host_merge = True
    with dispatch_counter.DispatchCounter() as counter:
        host = serve(QUERIES, k=5)
    assert list(dev) == list(host)
    assert counter.events == [("dispatch", "serve_sharded"), ("fetch", "serve_sharded_host")]
    assert counter.physical_fetches == 8


def test_ivf_8_vs_1_shard_bit_identical_at_full_probe(corpus, encs):
    s1 = FusedEncodeSearch(encs[1], _port(corpus, 1, FULL), k=5)
    s8 = FusedEncodeSearch(encs[1], _port(corpus, 8, FULL), k=5)
    with ServeScheduler(s1, window_us=0) as sched1:
        r1 = sched1.serve(QUERIES, k=5)
    with ServeScheduler(s8, window_us=0) as sched8:
        r8 = sched8.serve(QUERIES, k=5)
    assert list(r1) == list(r8) and r8.degraded == ()


# -- the mesh-sharded exact index -----------------------------------------------------

def test_exact_mesh_matches_unsharded(corpus, encs):
    keys, vecs = corpus

    def build(mesh):
        idx = DeviceKnnIndex(32, metric="cos", initial_capacity=256, mesh=mesh, device="cpu")
        idx.add(keys, vecs)
        return FusedEncodeSearch(encs[1], idx, k=5)

    serve1, serve8 = build(None), build(make_mesh(8, 1, devices=CPU * 8))
    with ServeScheduler(serve1, window_us=0) as sched:
        r1 = sched.serve(QUERIES, k=5)
    with ServeScheduler(serve8, window_us=0) as sched:
        r8 = sched.serve(QUERIES, k=5)
    assert [[k for k, _ in row] for row in r1] == [[k for k, _ in row] for row in r8]
    for a, b in zip(r1, r8):
        np.testing.assert_allclose([s for _, s in a], [s for _, s in b], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("metric", ["cos", "l2sq", "dot"])
def test_mesh_index_add_remove_upsert_grow_matches_reference(metric):
    rng = np.random.default_rng(42)
    ref = RefKnn(16, metric=metric, initial_capacity=64, mesh=ref_make_mesh(8, 1))
    port = DeviceKnnIndex(16, metric=metric, initial_capacity=64, mesh=make_mesh(8, 1, devices=CPU * 8))
    v1 = rng.normal(size=(90, 16)).astype(np.float32)
    v2 = rng.normal(size=(7, 16)).astype(np.float32)
    for index in (ref, port):
        index.add(range(1, 91), v1)  # past the initial capacity: a grow
        index.remove(range(10, 30))
        index.add([1, 2, 3, 50, 60, 70, 200], v2)  # upserts and a new key
    assert port.capacity == ref.capacity and port.key_to_slot == ref.key_to_slot
    np.testing.assert_array_equal(port.slot_to_key, ref.slot_to_key)
    np.testing.assert_allclose(port._matrix.numpy(), np.asarray(ref._matrix), atol=1e-6)
    np.testing.assert_array_equal(port._valid.numpy(), np.asarray(ref._valid))
    queries = rng.normal(size=(9, 16)).astype(np.float32)
    for w, g in zip(ref.search(queries, k=5), port.search(queries, k=5)):
        assert_same_ranking(w, g)
    port.remove(range(200))
    assert len(port) == 1 and port.search(queries[:2], k=3)[0][0][0] == 200


# -- the sharded forward index ------------------------------------------------------

def test_sharded_forward_matches_reference_and_unsharded(corpus, encs):
    ref_enc, enc = encs
    keys, _ = corpus
    texts = [DOCS[i] for i in keys]
    ref_fwd = RefShardedForward(ref_enc, n_shards=8, tokens_per_doc=8)
    ref_fwd.add(keys, texts)
    fwd8 = ShardedForwardIndex(enc, n_shards=8, devices=CPU, tokens_per_doc=8)
    assert fwd8.add(keys, texts) == len(keys)
    for want, got in zip(ref_fwd.shards, fwd8.shards):
        assert got._slot_of_key == want._slot_of_key
    fwd1 = ForwardIndex(enc, tokens_per_doc=8)
    fwd1.add(keys, texts)
    idx = _port(corpus, 4, FULL)
    stage1 = FusedEncodeSearch(enc, idx, k=8)
    stage1.export_query_tokens = True
    handle = stage1.submit(QUERIES, 16)
    cands = [[k for k, _ in row] for row in handle()]
    # the sharded table merge equals one index holding every row, bit for bit
    done8, miss8 = fwd8.gather_submit(handle.query_tokens, handle.query_mask, cands, 5, width=16)
    done1, miss1 = fwd1.gather_submit(handle.query_tokens, handle.query_mask, cands, 5, width=16)
    (s8, p8), (s1, p1) = done8(), done1()
    np.testing.assert_array_equal(s8.view(np.int32), s1.view(np.int32))
    np.testing.assert_array_equal(p8, p1)
    assert miss8 == miss1
    # the pipelines: port sharded against the reference's sharded
    ref_idx = _ref(corpus, 4, FULL)
    want = RefPipeline(RefServe(ref_enc, ref_idx, k=8, embed_cache=None), forward_index=ref_fwd, k=5,
                       candidates=16)(QUERIES)
    got = RetrieveRerankPipeline(FusedEncodeSearch(enc, idx, k=8), forward_index=fwd8, k=5, candidates=16)(QUERIES)
    assert got.degraded == want.degraded == ()
    for w, g in zip(want, got):
        assert_same_ranking(w, g, tie=1e-3, atol=1e-3)  # int8 rows may sit one step apart


def test_sharded_forward_missing_docs_backfill(corpus, encs):
    keys, _ = corpus
    texts = [DOCS[i] for i in keys]
    fwd = ShardedForwardIndex(encs[1], n_shards=4, devices=CPU, tokens_per_doc=8)
    fwd.add(keys[: len(keys) // 2], texts[: len(keys) // 2])
    pipe = RetrieveRerankPipeline(FusedEncodeSearch(encs[1], _port(corpus, 4, FULL), k=8), forward_index=fwd,
                                  k=5, candidates=16)
    res = pipe(QUERIES[:2])
    missing = res.meta.get("forward_missing", ())
    assert res.degraded == () and missing and all(int(k) not in fwd for k in missing)


# -- dispatch budget ----------------------------------------------------------------

def test_sharded_budget_2_plus_2_logical(corpus, encs):
    keys, _ = corpus
    serve = FusedEncodeSearch(encs[1], _port(corpus, 8), k=5)
    fwd = ShardedForwardIndex(encs[1], group=serve.index.group, tokens_per_doc=8)
    fwd.add(keys, [DOCS[i] for i in keys])
    pipe = RetrieveRerankPipeline(serve, forward_index=fwd, k=5, candidates=16)
    pipe(QUERIES)
    with dispatch_counter.DispatchCounter() as counter:
        res = pipe(QUERIES)
    assert res and res[0] and res.degraded == ()
    assert (counter.dispatches, counter.fetches) == (2, 2), counter.events
    # stage 1: encode + 8 shards + merge; stage 2: the owning shards + merge
    assert counter.physical_dispatches > 2 + 8
    with dispatch_counter.DispatchCounter(mode="physical") as physical:
        pipe(QUERIES)
    assert physical.dispatches == physical.physical_dispatches > 4


# -- failure domains -----------------------------------------------------------------

def test_dead_shard_degrades_recall_never_the_request(corpus, encs):
    serve = FusedEncodeSearch(encs[1], _port(corpus, 4, FULL), k=8)
    healthy = serve(QUERIES, k=8)
    group, dead = serve.index.group, 2
    dead_keys = {key for key in DOCS if group.owner_of(key) == dead}
    before = observe.counter("pathway_serve_degraded_total", reason=SHARD_SKIPPED).value
    with inject.armed(f"shard.dispatch.{dead}", "raise"):
        with dispatch_counter.DispatchCounter() as counter:
            res = serve(QUERIES, k=8)
    assert (counter.dispatches, counter.fetches) == (1, 1)
    assert SHARD_SKIPPED in res.degraded and res.meta["shards_skipped"] == (dead,)
    assert observe.counter("pathway_serve_degraded_total", reason=SHARD_SKIPPED).value > before
    for qi, row in enumerate(res):
        got = [key for key, _ in row]
        assert got and not set(got) & dead_keys
        want = [key for key, _ in healthy[qi] if key not in dead_keys]
        assert got[: len(want)] == want
    assert group.skips[dead] >= 1
    clean = serve(QUERIES, k=8)
    assert clean.degraded == () and list(clean) == list(healthy)


def test_transient_merge_fault_is_retried(corpus, encs, monkeypatch):
    monkeypatch.setenv("PATHWAY_RETRY_BASE_MS", "0")
    serve = FusedEncodeSearch(encs[1], _port(corpus, 4), k=5)
    want = serve(QUERIES[:2], k=5)
    with inject.armed("shard.merge", "raise", times=1):
        got = serve(QUERIES[:2], k=5)
        assert inject.fired_count("shard.merge") == 1
    assert got.degraded == () and list(got) == list(want)


def test_shard_absorb_fault_drops_only_that_shard(corpus, encs):
    keys, vecs = corpus
    idx = ShardedIvfIndex(32, n_shards=4, devices=CPU)
    with inject.armed("shard.absorb.1", "raise"):
        idx.add(keys, vecs)
    owned = {s: [k for k in keys if idx.group.owner_of(k) == s] for s in range(4)}
    assert len(idx.shards[1]) == 0 and all(len(idx.shards[s]) == len(owned[s]) for s in (0, 2, 3))
    assert idx.stats == {"route_drops": 1, "route_drop_docs": len(owned[1])}
    fwd = ShardedForwardIndex(encs[1], group=idx.group, tokens_per_doc=8)
    with inject.armed("shard.absorb.2", "raise"):
        n = fwd.add(keys[:40], [DOCS[i] for i in keys[:40]])
    assert n == sum(1 for k in keys[:40] if idx.group.owner_of(k) != 2)
    assert fwd.stats["route_drops"] == 1


def test_all_shards_dead_is_retrieval_failed_not_a_crash(corpus, encs):
    serve = FusedEncodeSearch(encs[1], _port(corpus, 2), k=5)
    serve(QUERIES[:1])
    with ServeScheduler(serve, window_us=0) as sched:
        with inject.armed("shard.dispatch.0", "raise"), inject.armed("shard.dispatch.1", "raise"):
            res = sched.serve(QUERIES[:1])
    assert res == [[]] and RETRIEVAL_FAILED in res.degraded


def test_open_breaker_skips_its_shard(corpus, encs):
    serve = FusedEncodeSearch(encs[1], _port(corpus, 3), k=5)
    breaker = serve.index.group.breaker(1)
    for _ in range(breaker.failure_threshold):
        breaker.record_failure()
    res = serve(QUERIES[:2], k=5)
    assert res.meta["shards_skipped"] == (1,) and breaker.state == "open"


def test_absorb_under_serve_lands_on_owning_shard(corpus, encs):
    keys, vecs = corpus
    half = len(keys) // 2
    idx = ShardedIvfIndex(32, n_shards=4, devices=CPU, n_probe=FULL, absorb_threshold=8)
    idx.add(keys[:half], vecs[:half])
    idx.build()
    serve = FusedEncodeSearch(encs[1], idx, k=5)
    serve(QUERIES[:2])
    stop, errors = threading.Event(), []

    def churn():
        i = half
        try:
            while not stop.is_set() and i < len(keys):
                idx.add(keys[i : i + 6], vecs[i : i + 6])
                i += 6
                time.sleep(0.002)
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errors.append(exc)

    t = threading.Thread(target=churn)
    t.start()
    try:
        for _ in range(12):
            res = serve(QUERIES[:2])
            assert res and all(row for row in res)
    finally:
        stop.set()
        t.join(30)
    assert not errors, errors
    _wait(idx)
    for s, child in enumerate(idx.shards):
        assert all(idx.group.owner_of(key) == s for key in child._rows)
    assert sum(c.stats["absorbs"] for c in idx.shards) >= 1
    assert keys[-1] in [key for key, _ in serve([DOCS[keys[-1]]], k=3)[0]]


# -- observability ---------------------------------------------------------------------

def _shard_samples(*providers):
    return {
        (name, labels.get("shard"), labels.get("tier")): value
        for p in providers
        for _kind, name, labels, value in p.observe_metrics()
        if name.startswith("pathway_serve_shard_")
    }


def test_shard_metrics_match_reference(corpus, encs):
    ref_enc, enc = encs
    from pathway_tpu.robust import inject as ref_inject

    pair = [
        (RefServe(ref_enc, _ref(corpus, 4), k=5, embed_cache=None), RefShardedForward, ref_inject),
        (FusedEncodeSearch(enc, _port(corpus, 4), k=5), ShardedForwardIndex, inject),
    ]
    samples = []
    for serve, fwd_cls, sites in pair:
        with sites.armed("shard.dispatch.1", "raise", times=1):
            serve(QUERIES[:2])
        serve(QUERIES[:2])
        fwd = fwd_cls(serve.encoder, group=serve.index.group, tokens_per_doc=8)
        fwd.add(sorted(DOCS)[:30], [DOCS[i] for i in sorted(DOCS)[:30]])
        samples.append(_shard_samples(serve.index.group, serve.index, fwd))
    assert samples[1] == samples[0]
    assert samples[1][("pathway_serve_shard_skips_total", "1", None)] == 1
    snap = observe.snapshot()
    names = "\n".join(list(snap["counters"]) + list(snap["gauges"]))
    for family in ("pathway_serve_shard_skips_total", "pathway_serve_shard_breaker_open",
                   "pathway_serve_shard_resident_vectors", "pathway_serve_shard_dispatches_total"):
        assert family in names
    assert any(k.startswith("pathway_serve_shard_resident_vectors") for k in snap["shards"]["0"])
    assert any("pathway_serve_shard_stage_seconds" in h for h in snap["histograms"])
    assert any(line.startswith("pathway_serve_shard_skips_total") for line in observe.render_prometheus())


def test_profiler_labels_of_the_sharded_path(corpus, encs):
    from pathway_tpu_torch.observe import profile

    keys, _ = corpus
    stride = profile.sample_stride()
    profile.set_sample(1.0)
    try:
        serve = FusedEncodeSearch(encs[1], _port(corpus, 2), k=5)
        fwd = ShardedForwardIndex(encs[1], group=serve.index.group, tokens_per_doc=8)
        fwd.add(keys, [DOCS[i] for i in keys])
        RetrieveRerankPipeline(serve, forward_index=fwd, k=5, candidates=16)(QUERIES[:2])
        stats = profile.profile_stats()
    finally:
        profile.set_sample(1.0 / stride if stride else 0.0)
    for label in ("serve.encode", "serve.shard_search", "serve.shard_merge", "forward.table", "forward.table_merge"):
        assert stats[label]["samples"] >= 1, label


def test_build_from_matrix_routes_rows_to_their_shards(corpus):
    """The bulk device build gives each shard the layout a single index
    builds from that shard's rows."""
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex

    keys, vecs = corpus
    idx = ShardedIvfIndex(32, n_shards=3, devices=CPU)
    idx.build_from_matrix(keys, torch.from_numpy(vecs))
    for s, child in enumerate(idx.shards):
        mine = [i for i, k in enumerate(keys) if k % 3 == s]
        alone = IvfKnnIndex(32, device="cpu")
        alone.build_from_matrix([keys[i] for i in mine], torch.from_numpy(vecs[mine]))
        assert child._slot_of_key == alone._slot_of_key
        assert torch.equal(child._slabs, alone._slabs)
    with pytest.raises(ValueError):
        idx.build_from_matrix(keys[:3], torch.from_numpy(vecs))


def test_every_shard_is_on_the_device_memory_ledger(corpus, encs):
    """Each child registers in the ledger as its single-device twin does:
    building a sharded IVF and forward index moves the ``ivf`` and
    ``forward`` subsystems by the children's bytes."""
    from pathway_tpu_torch.observe import hbm

    def subsystem(name):
        return sum(hbm.sample()["subsystems"].get(name, {}).values())

    import gc

    keys, _ = corpus
    gc.collect()  # earlier tests' indexes leave the ledger now, not midway
    ivf0, fwd0 = subsystem("ivf"), subsystem("forward")
    idx = _port(corpus, 3)
    fwd = ShardedForwardIndex(encs[1], group=idx.group, tokens_per_doc=8)
    fwd.add(keys, [DOCS[i] for i in keys])
    assert subsystem("ivf") - ivf0 == sum(sum(c.hbm_bytes().values()) for c in idx.shards) > 0
    assert subsystem("forward") - fwd0 == fwd.hbm_bytes() > 0
