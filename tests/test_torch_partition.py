"""Port parity of the partitioned serve fabric (``pathway_tpu_torch/serve/fabric.py``
scatter-gather with owner-routed absorb) on the CPU, one counterpart for
each test of ``tests/test_partition.py``, in its fixture (d 32, 2 layers, 4
heads, max_length 32, vocab 512, f32, its 24 documents and 4 queries),
with the reference's encoder weights carried over through
``models/params.py`` ``params_from_flax``.

Within the port, H = 3 partition hosts (host i owning ``key % 3 == i``)
serve bit for bit what H = 1 serves, for the exact index and the IVF at
full probe, since the front merge only picks among the owners' rows.
Across the packages, the port's H = 3 keys equal the reference's and the
f32 scores agree within 1e-5.  A committed document lands on its owner
only; a per-partition warm restore serves the same rows at the same
generation vector; each host stays within 2 dispatches + 2 fetches per
batch, the scatter booked as 1 logical + H physical.

The reference's cache test asserts that a fresh document outranks the
cached rows on seeded weights, which they do not (see ``ROADMAP.md``
Queue 3); its counterpart here asserts the mechanism: the generation
vector moves when any partition absorbs (a scalar maximum would not), so
nothing is served from the cache after it, and a result whose dispatch
crossed an absorb is served but stored under neither generation.
"""

import itertools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models.encoder import SentenceEncoder as RefEncoder
from pathway_tpu.observe import slo as ref_slo
from pathway_tpu.ops.knn import DeviceKnnIndex as RefKnn
from pathway_tpu.ops.serving import FusedEncodeSearch as RefServe
from pathway_tpu.parallel import FleetPartitionMap as RefPartitionMap
from pathway_tpu.serve import FabricWorker as RefWorker
from pathway_tpu.serve import ServeFabric as RefFabric
from pathway_tpu.serve import ServeScheduler as RefScheduler
from pathway_tpu_torch import observe
from pathway_tpu_torch.cache import ResultCache, normalize_generation, query_key
from pathway_tpu_torch.models.encoder import SentenceEncoder
from pathway_tpu_torch.observe import slo
from pathway_tpu_torch.ops import dispatch_counter
from pathway_tpu_torch.ops.ivf import IvfKnnIndex
from pathway_tpu_torch.ops.knn import DeviceKnnIndex
from pathway_tpu_torch.ops.serving import FusedEncodeSearch
from pathway_tpu_torch.parallel import FleetPartitionMap
from pathway_tpu_torch.persistence.backends import MemoryBackend
from pathway_tpu_torch.serve import FabricWorker, LiveIngestRunner, ServeFabric, ServeScheduler, fabric_token
from pathway_tpu_torch.serve.warmstate import WarmStateManager

from .test_torch_ivf import assert_same_ranking

DOCS = {
    i: f"partition doc {i} about {topic} case {i % 7}"
    for i, topic in enumerate(
        [
            "key ownership", "vector indexes", "owner routing",
            "scatter gather", "generation vectors", "stream joins",
            "warm snapshots", "absorb throughput", "rag retrieval",
            "sharded state", "commit ticks", "partition maps",
        ]
        * 2
    )
}
QUERIES = ["owner routed absorb", "scatter gather merge",
           "generation vector keys", "warm partition restore"]
ENC = dict(dimension=32, n_layers=2, n_heads=4, max_length=32, vocab_size=512)
TOL = 1e-5

_ids = itertools.count()


def _names(n: int):
    """Fresh host names per fleet: breakers are keyed by host name."""
    tag = next(_ids)
    return [f"tpart{tag}-{i}" for i in range(n)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _fresh_slo_engines():
    """Slow serves around killed, drained and bounced hosts burn the
    latency objective of this process; the files after this one in the
    same worker start from fresh SLO engines of both packages."""
    yield
    slo.reset()
    ref_slo.reset()


@pytest.fixture(scope="module")
def encs():
    ref = RefEncoder(dtype=jnp.float32, **ENC)
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    return ref, SentenceEncoder(dtype=torch.float32, device="cpu", params=tree, **ENC)


def _wait_gens(fabric, want, timeout=10.0):
    """Poll the generation vector until it reads ``want`` (a first pong
    can lose the race with one poll window)."""
    t_end = time.monotonic() + timeout
    gens = fabric.poll_generations()
    while gens != want and time.monotonic() < t_end:
        time.sleep(0.05)
        gens = fabric.poll_generations()
    return gens


def _build_index(enc, keys, docs, kind: str):
    vecs = enc.encode([docs[i] for i in keys])
    if kind == "ivf":
        idx = IvfKnnIndex(32, metric="cos", n_clusters=2, n_probe=2, device="cpu")
        idx.add(keys, vecs)
        idx.build()
    else:
        idx = DeviceKnnIndex(32, metric="cos", initial_capacity=64, device="cpu")
        idx.add(keys, vecs)
    return idx


class _PartFleet:
    """H partition hosts (each: its owned slice of the corpus -> fused
    search -> scheduler -> worker, optionally a live ingest runner) and
    one partitioned front."""

    def __init__(self, enc, n, kind="exact", with_ingest=False, indexes=None):
        keys = sorted(DOCS)
        self.token = fabric_token()
        self.names = _names(n)
        self.indexes, self.scheds, self.runners, self.workers = [], [], [], []
        pmap = FleetPartitionMap(n)
        for i in range(n):
            idx = indexes[i] if indexes is not None else _build_index(
                enc, [k for k in keys if pmap.owner_of(k) == i], DOCS, kind
            )
            self.indexes.append(idx)
            sched = ServeScheduler(FusedEncodeSearch(enc, idx, k=8), window_us=0, result_cache=None,
                                   name=f"{self.names[i]}-s")
            self.scheds.append(sched)
            runner = LiveIngestRunner(enc, idx, name=f"{self.names[i]}-ing") if with_ingest else None
            self.runners.append(runner)
            self.workers.append(FabricWorker(sched, token=self.token, name=self.names[i], ingest=runner))
        self.fabric = ServeFabric({w.name: w.address for w in self.workers}, self.token,
                                  name=f"pfab-{self.names[0]}", partitions=n)

    def stop(self) -> None:
        self.fabric.stop()
        for w in self.workers:
            w.stop()
        for r in self.runners:
            if r is not None:
                r.stop()
        for s in self.scheds:
            s.stop()


class _RefPartFleet:
    """The reference's exact H-host fleet over the same vectors."""

    def __init__(self, ref_enc, n):
        keys = sorted(DOCS)
        self.token = fabric_token()
        self.names = _names(n)
        pmap = RefPartitionMap(n)
        self.scheds, self.workers = [], []
        for i in range(n):
            owned = [k for k in keys if pmap.owner_of(k) == i]
            idx = RefKnn(dimension=32, metric="cos", initial_capacity=64)
            idx.add(owned, ref_enc.encode([DOCS[k] for k in owned]))
            self.scheds.append(RefScheduler(RefServe(ref_enc, idx, k=8), window_us=0, result_cache=None,
                                            name=f"{self.names[i]}-rs"))
            self.workers.append(RefWorker(self.scheds[i], token=self.token, name=self.names[i]))
        self.fabric = RefFabric({w.name: w.address for w in self.workers}, self.token,
                                name=f"rpfab-{self.names[0]}", partitions=n)

    def stop(self) -> None:
        self.fabric.stop()
        for w in self.workers:
            w.stop()
        for s in self.scheds:
            s.stop()


# -- the routing rule ---------------------------------------------------------------------


def test_fleet_partition_map_is_the_modulo_rule():
    pmap, ref = FleetPartitionMap(3), RefPartitionMap(3)
    assert len(pmap) == 3
    for key in range(20):
        assert pmap.owner_of(key) == key % 3 == ref.owner_of(key)
    keys = [0, 1, 2, 3, 4, 30, 100]
    assert pmap.route(keys) == ref.route(keys) == {0: [0, 3, 5], 1: [1, 4, 6], 2: [2]}
    with pytest.raises(ValueError):
        FleetPartitionMap(0)


# -- clean-path bit identity -------------------------------------------------------------------


def test_h3_exact_bit_identical_to_h1_through_scheduler(encs):
    """H = 3 == H = 1 on the exact index, each query solo through a front
    scheduler on both sides; the port's H = 3 keys equal the
    reference's H = 3 keys (scores within 1e-5)."""
    ref_enc, enc = encs
    fleet3, fleet1 = _PartFleet(enc, 3), _PartFleet(enc, 1)
    ref3 = _RefPartFleet(ref_enc, 3)
    front3 = ServeScheduler(fleet3.fabric, window_us=0, result_cache=None)
    front1 = ServeScheduler(fleet1.fabric, window_us=0, result_cache=None)
    try:
        assert fleet3.fabric.connect() == 3
        for q in QUERIES:
            r3, r1 = front3.serve([q], k=5), front1.serve([q], k=5)
            assert list(r3) == list(r1), q  # floats bit-equal
            assert r3.degraded == () and r1.degraded == ()
            want = ref3.fabric.serve([q], k=5)
            assert [k for k, _ in want[0]] == [k for k, _ in r3[0]], q
            assert_same_ranking(want[0], r3[0], tie=TOL, atol=TOL)
        assert fleet3.fabric.stats["ok"] == len(QUERIES)
        assert fleet3.fabric.stats["partition_lost"] == 0
    finally:
        front3.stop()
        front1.stop()
        fleet3.stop()
        fleet1.stop()
        ref3.stop()


def test_h3_ivf_full_probe_bit_identical_to_h1(encs):
    """IVF at full probe: each partition scores its documents as the H = 1
    index does, so the merge is bit-identical too."""
    _ref_enc, enc = encs
    fleet3, fleet1 = _PartFleet(enc, 3, kind="ivf"), _PartFleet(enc, 1, kind="ivf")
    try:
        got3 = fleet3.fabric.serve(QUERIES, k=5)
        got1 = fleet1.fabric.serve(QUERIES, k=5)
        assert list(got3) == list(got1)
        assert got3.degraded == ()
        assert got3.meta["fabric_partitions"] == 3
        assert got3.meta["index_generation"] == (2, 2, 2)  # add() then build()
    finally:
        fleet3.stop()
        fleet1.stop()


# -- owner-routed absorb ----------------------------------------------------------------------


def test_absorb_routes_to_owner_only_and_is_fleet_visible(encs):
    _ref_enc, enc = encs
    new_key = 100  # owner 100 % 3 = 1
    text = "owner routed absorb lands on its owner"
    fleet = _PartFleet(enc, 3, with_ingest=True)
    try:
        sizes = [len(idx) for idx in fleet.indexes]
        conn = fleet.fabric.connector("src0")
        conn.insert(new_key, text)
        assert conn.commit() == 1
        assert fleet.runners[1].flush(timeout=30.0)
        assert _wait_gens(fleet.fabric, (1, 2, 1)) == (1, 2, 1)  # only the owner moved
        assert [len(idx) for idx in fleet.indexes] == [sizes[0], sizes[1] + 1, sizes[2]]
        assert fleet.fabric._absorb_docs == [0, 1, 0]
        assert fleet.fabric._absorb_dropped == [0, 0, 0]
        for part, sched in enumerate(fleet.scheds):  # retrievable only through its owner...
            rows = sched.serve([text], k=8)
            assert any(int(k) == new_key for k, _s in rows[0]) == (part == 1), part
        got = fleet.fabric.serve([text], k=8)  # ...and fleet-wide through the merge
        assert got.degraded == ()
        assert got[0][0][0] == new_key  # its own text ranks it first
    finally:
        fleet.stop()


def test_connector_requires_partitioned_fabric(encs):
    _ref_enc, enc = encs
    fused = FusedEncodeSearch(enc, _build_index(enc, sorted(DOCS), DOCS, "exact"), k=8)
    token = fabric_token()
    sched = ServeScheduler(fused, window_us=0, result_cache=None)
    worker = FabricWorker(sched, token=token, name=_names(1)[0])
    fabric = ServeFabric({worker.name: worker.address}, token, name=f"rep-{worker.name}")
    try:
        with pytest.raises(RuntimeError):
            fabric.connector()
        with pytest.raises(RuntimeError):
            fabric.absorb([(1, "x", 0)])
        with pytest.raises(ValueError):  # every host is one partition
            ServeFabric({worker.name: worker.address}, token, partitions=2)
    finally:
        fabric.stop()
        worker.stop()
        sched.stop()


# -- generation-vector cache keys ---------------------------------------------------------------


def test_partition_absorb_invalidates_fleet_wide_cache_keys(encs):
    """Host 0 at generation 3, host 1 at 1: an absorb on host 1 leaves the
    fleet maximum at 3, so a scalar key would serve the cached result; the
    vector key moves, and the front serves fresh.  A result whose window
    crossed an absorb is served but cached under neither generation."""
    _ref_enc, enc = encs
    q = "generation vector keys"
    fleet = _PartFleet(enc, 3, with_ingest=True)
    cache = ResultCache()
    front = ServeScheduler(fleet.fabric, window_us=0, result_cache=cache, name="tpart-front")

    def absorb(key, text, want):
        conn = fleet.fabric.connector("gen-src")
        conn.insert(key, text)
        assert conn.commit() == 1
        assert fleet.runners[key % 3].flush(timeout=30.0)
        assert _wait_gens(fleet.fabric, want) == want

    def cached(gen):
        return cache.get_rows([query_key(q, gen)], 5)

    try:
        absorb(30, "warmup absorb doc one", (2, 1, 1))
        absorb(33, "warmup absorb doc two", (3, 1, 1))
        r1 = front.serve([q], k=5)
        assert r1.degraded == () and cached((3, 1, 1)) == list(r1)
        assert front.serve([q], k=5) == r1 and front.stats["cache_hits"] == 1
        absorb(100, f"fresh doc about {q}", (3, 2, 1))
        assert max((3, 2, 1)) == max((3, 1, 1))  # a scalar maximum would not move
        assert query_key(q, fleet.fabric.index_generation()) != query_key(q, (3, 1, 1))
        assert cached((3, 2, 1)) is None
        r2 = front.serve([q], k=5)
        assert front.stats["cache_hits"] == 1  # served fresh, not from the entry of (3, 1, 1)
        assert list(r2) == list(fleet.fabric.serve([q], k=5)) and r2.meta["index_generation"] == (3, 2, 1)
        assert cached((3, 2, 1)) == list(r2)
        assert fleet.fabric.serve(["fresh doc about generation vector keys"], k=5)[0][0][0] == 100

        # the window case: admitted under (3, 2, 1), dispatched after an
        # absorb on host 1 moved the vector to (3, 3, 1)
        slow = ServeScheduler(fleet.fabric, window_us=1_500_000, result_cache=cache, name="tpart-front-w")
        try:
            cache.clear()
            ticket = slow.submit([q], k=5)
            absorb(103, f"second fresh doc about {q}", (3, 3, 1))
            assert not ticket._request.event.is_set(), "the absorb must land inside the window"
            crossed = ticket.result(timeout=30.0)
            assert crossed and crossed.degraded == ()
            assert crossed.meta["index_generation"] == (3, 3, 1)
            assert cached((3, 2, 1)) is None and cached((3, 3, 1)) is None
            assert slow.stats["cache_hits"] == 0
        finally:
            slow.stop()
    finally:
        front.stop()
        fleet.stop()


def test_index_generation_vector_normalizes_for_cache_keys(encs):
    _ref_enc, enc = encs
    fleet = _PartFleet(enc, 2)
    try:
        gens = _wait_gens(fleet.fabric, (1, 1))
        assert gens == (1, 1)
        assert normalize_generation(gens) == (1, 1)
        assert normalize_generation(list(gens)) == (1, 1)
        assert normalize_generation(7) == 7
    finally:
        fleet.stop()


# -- per-partition warm restore -------------------------------------------------------------------


def test_per_partition_warm_restore_is_bit_identical(encs):
    """Each partition snapshots its owned slabs only; a replacement fleet
    restored per partition serves the same rows at the same vector."""
    _ref_enc, enc = encs
    fleet = _PartFleet(enc, 3, kind="ivf")
    backends = []
    try:
        want = fleet.fabric.serve(QUERIES, k=5)
        want_gens = _wait_gens(fleet.fabric, (2, 2, 2))
        for i, idx in enumerate(fleet.indexes):
            backend = MemoryBackend()
            assert WarmStateManager(backend, name=f"tpart-{i}", components={"ivf": idx}).snapshot() is not None
            backends.append(backend)
    finally:
        fleet.stop()
    replicas = []
    for i, backend in enumerate(backends):
        replica = IvfKnnIndex(32, metric="cos", n_clusters=2, n_probe=2, device="cpu")
        report = WarmStateManager(backend, name=f"tpart-{i}", components={"ivf": replica}).restore()
        assert report.restored, (i, report)
        assert len(replica) == len(fleet.indexes[i])
        replicas.append(replica)
    fleet2 = _PartFleet(enc, 3, indexes=replicas)
    try:
        got = fleet2.fabric.serve(QUERIES, k=5)
        assert list(got) == list(want)
        assert got.degraded == ()
        assert _wait_gens(fleet2.fabric, want_gens) == want_gens == (2, 2, 2)
    finally:
        fleet2.stop()


# -- dispatch budget ------------------------------------------------------------------------------


def test_partitioned_serve_keeps_two_plus_two_per_host(encs):
    """With partitioned serve and owner-routed absorb live, each host's
    batch stays within 2 dispatches + 2 fetches, and the front books the
    scatter as one logical + H physical."""
    _ref_enc, enc = encs
    fleet = _PartFleet(enc, 3, with_ingest=True)
    try:
        q = QUERIES[0]
        fleet.fabric.serve([q], k=5)
        conn = fleet.fabric.connector("budget-src")
        conn.insert(102, "absorb rides before the measured serve")
        assert conn.commit() == 1
        assert fleet.runners[0].flush(timeout=30.0)
        for sched in fleet.scheds:
            with dispatch_counter.DispatchCounter() as counter:
                sched.serve([q], k=5)
            assert counter.dispatches <= 2 and counter.fetches <= 2, counter.events
        with dispatch_counter.DispatchCounter() as counter:
            got = fleet.fabric.serve([q], k=5)
        assert got.degraded == ()
        disp = [t for kind, t in counter.events if kind == "dispatch"]
        fet = [t for kind, t in counter.events if kind == "fetch"]
        assert disp.count("fabric.scatter") == 1
        assert fet.count("fabric.gather") == 1
        assert len([t for t in disp if t != "fabric.scatter"]) <= 3 * 2, counter.events
        assert len([t for t in fet if t != "fabric.gather"]) <= 3 * 2, counter.events
        assert not any(t.startswith("partition.") for t in disp + fet)  # absorb is not a serve dispatch
        with dispatch_counter.DispatchCounter(mode="physical") as counter:
            fleet.fabric.serve([q], k=5)
        phys = [t for kind, t in counter.events if kind == "dispatch"]
        assert phys.count("fabric.scatter") == 1  # one event ...
        assert counter.physical_dispatches >= 3  # ... of H physical sends
    finally:
        fleet.stop()


# -- scrape surface ---------------------------------------------------------------------------------


def test_partition_metrics_reach_the_scrape_surface(encs):
    _ref_enc, enc = encs
    fleet = _PartFleet(enc, 2)
    try:
        fleet.fabric.serve([QUERIES[0]], k=5)
        snap = observe.snapshot()
        names = "\n".join(list(snap["counters"]) + list(snap["gauges"]))
        for family in ("pathway_partition_count", "pathway_partition_lost_total",
                       "pathway_partition_absorb_docs_total", "pathway_partition_absorb_dropped_total"):
            assert family in names
        count = [v for key, v in snap["gauges"].items()
                 if key.startswith("pathway_partition_count") and f'fabric="{fleet.fabric.name}"' in key]
        assert count == [2]
    finally:
        fleet.stop()


def test_dead_partition_serves_the_survivors_flagged(encs):
    """A killed partition costs its own keys only: the survivors' merge is
    served flagged ``partition_lost``, never an exception, and the dead
    host's breaker opens."""
    _ref_enc, enc = encs
    from pathway_tpu_torch import robust
    from pathway_tpu_torch.robust import PARTITION_LOST

    fleet = _PartFleet(enc, 3)
    try:
        assert fleet.fabric.connect() == 3
        whole = fleet.fabric.serve(QUERIES, k=8)
        fleet.workers[0].kill()
        fleet.scheds[0].stop()
        t_end = time.monotonic() + 5
        while fleet.fabric._links[0].up() and time.monotonic() < t_end:
            time.sleep(0.005)
        got = fleet.fabric.serve(QUERIES, k=8)
        assert PARTITION_LOST in got.degraded
        assert list(got.meta["partitions_lost"]) == [fleet.names[0]]
        for want_row, row in zip(whole, got):
            assert row and all(k % 3 != 0 for k, _s in row)
            survivors = [pair for pair in want_row if pair[0] % 3 != 0]
            assert row[: len(survivors)] == survivors
        assert robust.breaker(f"fabric:{fleet.names[0]}").state != "closed"
    finally:
        fleet.stop()
