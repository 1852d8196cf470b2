"""Port parity of the replica-mode serve fabric (``pathway_tpu_torch/serve/fabric.py``)
on the CPU, one counterpart for each test of ``tests/test_fabric.py``, in
its fixture (d 32, 2 layers, 4 heads, max_length 32, vocab 512, f32, its
24 documents and 4 queries), with the reference's encoder weights carried
over through ``models/params.py`` ``params_from_flax``.

Within the port, fabric rows equal the in-process scheduler's bit for bit.
Against the reference's fabric over the same seeded inputs, keys are equal
and f32 scores within 1e-5 (sums in another order), keys swapping only
between scores tied within 1e-5.  The wire is shared: the reference's
front drives the port's workers and back, a wrong session secret is
refused before any unpickle in both packages, and a worker's reply holds
plain host values only.  Also here: the nine ``fabric.*`` / ``partition.*``
knobs against the reference's, field by field, ``ServeResult.with_flags``
against the reference's, and the scheduler's ``__call__``.

Breakers are process-wide and keyed by host name: every fleet gets fresh
names.  Every listener binds port 0.
"""

import itertools
import pickle
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu import config as ref_config
from pathway_tpu.models.encoder import SentenceEncoder as RefEncoder
from pathway_tpu.observe import slo as ref_slo
from pathway_tpu.ops.knn import DeviceKnnIndex as RefKnn
from pathway_tpu.ops.serving import FusedEncodeSearch as RefServe
from pathway_tpu.robust.degrade import ServeResult as RefServeResult
from pathway_tpu.serve import FabricWorker as RefWorker
from pathway_tpu.serve import ServeFabric as RefFabric
from pathway_tpu.serve import ServeScheduler as RefScheduler
from pathway_tpu_torch import config, observe, robust
from pathway_tpu_torch.models.encoder import SentenceEncoder
from pathway_tpu_torch.observe import slo
from pathway_tpu_torch.ops.knn import DeviceKnnIndex
from pathway_tpu_torch.ops.serving import FusedEncodeSearch
from pathway_tpu_torch.parallel.exchange import FramedStream, PeerLost
from pathway_tpu_torch.robust import HOST_FAILOVER, REPLICA_LOST, ServeResult
from pathway_tpu_torch.robust.deadline import Deadline
from pathway_tpu_torch.serve import FabricWorker, ServeFabric, ServeScheduler, fabric_token
from pathway_tpu_torch.serve import fabric as fabric_mod

from .test_torch_ivf import assert_same_ranking

DOCS = {
    i: f"fabric doc {i} about {topic} case {i % 7}"
    for i, topic in enumerate(
        [
            "replica failover", "vector indexes", "rolling restarts",
            "consistent hashing", "circuit breakers", "stream joins",
            "heartbeat liveness", "warm snapshots", "rag retrieval",
            "sharded state", "commit ticks", "key ownership",
        ]
        * 2
    )
}
QUERIES = ["replica failover serving", "consistent hash routing",
           "heartbeat liveness", "warm snapshot restore"]
ENC = dict(dimension=32, n_layers=2, n_heads=4, max_length=32, vocab_size=512)
TOL = 1e-5  # f32 scores across the packages; keys swap only at ties within it
FABRIC_KNOBS = (
    "fabric.heartbeat_s", "fabric.heartbeat_timeout_s", "fabric.hedge_ms", "fabric.affinity_slack",
    "fabric.connect_timeout_s", "fabric.request_timeout_s", "fabric.partitions",
    "partition.gather_timeout_s", "partition.absorb_timeout_s",
)

_ids = itertools.count()


def _host_names(n: int):
    """Fresh names per fleet: breakers are keyed by host name."""
    tag = next(_ids)
    return [f"tfh{tag}-{i}" for i in range(n)]


def _wait_for(pred, timeout: float = 10.0) -> bool:
    t_end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > t_end:
            return False
        time.sleep(0.005)
    return True


def _degraded(reason: str) -> int:
    return observe.counter("pathway_serve_degraded_total", reason=reason).value


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
def stacks():
    """(reference fused, port fused) over the same weights and documents."""
    ref_enc = RefEncoder(dtype=jnp.float32, **ENC)
    tree = jax.tree_util.tree_map(np.asarray, ref_enc.params)
    enc = SentenceEncoder(dtype=torch.float32, device="cpu", params=tree, **ENC)
    keys = sorted(DOCS)
    vecs = np.asarray(ref_enc.encode([DOCS[i] for i in keys]))
    ref_index = RefKnn(dimension=32, metric="cos", initial_capacity=64)
    ref_index.add(keys, vecs)
    index = DeviceKnnIndex(32, metric="cos", initial_capacity=64, device="cpu")
    index.add(keys, vecs)
    ref_fused, fused = RefServe(ref_enc, ref_index, k=8), FusedEncodeSearch(enc, index, k=8)
    ref_fused(QUERIES[:1])
    fused(QUERIES[:1])
    return ref_fused, fused


class _Fleet:
    """N workers of one package, each its own scheduler over the shared
    fused target, and one front of that package."""

    def __init__(self, fused, n=2, token=None, pkg="port"):
        sched_cls, worker_cls, fabric_cls = (
            (ServeScheduler, FabricWorker, ServeFabric) if pkg == "port" else (RefScheduler, RefWorker, RefFabric)
        )
        self.token = token or fabric_token()
        self.names = _host_names(n)
        self.scheds = [
            sched_cls(fused, window_us=0, result_cache=None, name=f"{self.names[i]}-s") for i in range(n)
        ]
        self.workers = [worker_cls(self.scheds[i], token=self.token, name=self.names[i]) for i in range(n)]
        self.fabric = fabric_cls({w.name: w.address for w in self.workers}, self.token, name=f"fab{self.names[0]}")

    def crash(self, i: int) -> None:
        """Unplanned death: listener and streams die with no bye."""
        self.workers[i].kill()
        self.scheds[i].stop()

    def stop(self) -> None:
        self.fabric.stop()
        for w in self.workers:
            w.stop()
        for s in self.scheds:
            s.stop()


# -- bit identity -----------------------------------------------------------------------


def test_fabric_serves_bit_identically_to_in_process(stacks):
    """Port fabric == the port's in-process scheduler bit for bit (solo
    dispatch per query on both sides), and == the reference's fabric
    within 1e-5 with equal keys."""
    ref_fused, fused = stacks
    fleet = _Fleet(fused, n=2)
    ref_fleet = _Fleet(ref_fused, n=2, pkg="ref")
    local = ServeScheduler(fused, window_us=0, result_cache=None)
    try:
        assert fleet.fabric.connect() == 2 and ref_fleet.fabric.connect() == 2
        for q in QUERIES * 2:
            got, want = fleet.fabric.serve([q]), local.serve([q])
            assert list(got) == list(want), q
            assert got.degraded == ()
            assert got.meta["fabric_host"] in fleet.names
            ref_got = ref_fleet.fabric.serve([q])
            assert len(ref_got[0]) == len(got[0]) == 8
            assert_same_ranking(ref_got[0], got[0], tie=TOL, atol=TOL)
        assert fleet.fabric.stats["ok"] == len(QUERIES) * 2
        assert fleet.fabric.stats["failover"] == 0
    finally:
        fleet.stop()
        ref_fleet.stop()
        local.stop()


def test_fabric_ticket_api_parity(stacks):
    _ref_fused, fused = stacks
    fleet = _Fleet(fused, n=1)
    try:
        ticket = fleet.fabric.submit([QUERIES[0]], k=5)
        rows = ticket()
        assert rows and rows[0]
        assert ticket.result(timeout=1.0) is rows  # memoized, as the reference's
        assert all(len(r) <= 5 for r in rows)
    finally:
        fleet.stop()


def test_fabric_affinity_is_sticky_on_healthy_fleet(stacks):
    """The same query text lands on the same host while it is healthy,
    and the port hashes a text to the host index the reference does."""
    ref_fused, fused = stacks
    fleet = _Fleet(fused, n=3)
    ref_fleet = _Fleet(ref_fused, n=3, pkg="ref")
    try:
        assert fleet.fabric.connect() == 3
        hosts = {fleet.fabric.serve([QUERIES[0]]).meta["fabric_host"] for _ in range(6)}
        assert len(hosts) == 1
        for i in range(40):
            q = f"affinity probe {i}"
            assert fleet.fabric._affinity(q) == ref_fleet.fabric._affinity(q)
    finally:
        fleet.stop()
        ref_fleet.stop()


# -- failover -----------------------------------------------------------------------------


def test_kill_host_midflight_flags_failover_never_raises(stacks, monkeypatch):
    """An in-flight request whose host dies re-routes on the waiter's
    thread: rows land flagged ``host_failover``, the breaker is open, no
    exception."""
    monkeypatch.setenv("PATHWAY_FABRIC_HEARTBEAT", "0.05")
    monkeypatch.setenv("PATHWAY_FABRIC_HEARTBEAT_TIMEOUT", "0.4")
    _ref_fused, fused = stacks
    gate = threading.Event()
    entered = threading.Event()

    class _SlowTarget:
        """Duck-typed scheduler: a slow one parks until released (or its
        host dies under it)."""

        def __init__(self, inner, slow):
            self.inner = inner
            self.slow = slow

        def serve(self, texts, k=None, deadline=None, priority=None):
            if self.slow:
                entered.set()
                gate.wait(10)
            return self.inner.serve(texts, k=k, deadline=deadline)

    inner0 = ServeScheduler(fused, window_us=0, result_cache=None)
    inner1 = ServeScheduler(fused, window_us=0, result_cache=None)
    token = fabric_token()
    names = _host_names(2)
    w_slow = FabricWorker(_SlowTarget(inner0, slow=True), token=token, name=names[0])
    w_ok = FabricWorker(_SlowTarget(inner1, slow=False), token=token, name=names[1])
    fab = ServeFabric({w_slow.name: w_slow.address, w_ok.name: w_ok.address}, token, name=f"fab-kill-{names[0]}")
    q = next(q for q in (f"affinity probe {i}" for i in itertools.count()) if fab._affinity(q) == 0)
    failover0 = _degraded(HOST_FAILOVER)
    box = {}
    t = threading.Thread(target=lambda: box.setdefault("result", fab.serve([q])))
    try:
        assert fab.connect() == 2
        t.start()
        assert entered.wait(5), "request never reached the slow host"
        w_slow.kill()  # dies under the in-flight request: no bye, no reply
        t.join(10)
        assert not t.is_alive()
        got = box["result"]
        assert got and got[0], "failover must still serve rows"
        assert HOST_FAILOVER in got.degraded
        assert got.meta["fabric_host"] == w_ok.name
        assert list(got) == list(inner1.serve([q]))
        assert _degraded(HOST_FAILOVER) == failover0 + 1
        assert robust.breaker(f"fabric:{w_slow.name}").state == "open"
        assert fab.stats["failover"] == 1 and fab.stats["lost"] == 0
    finally:
        gate.set()
        fab.stop()
        w_slow.stop()
        w_ok.stop()
        inner0.stop()
        inner1.stop()


def test_fabric_recv_chaos_triple_reroutes_in_flight(stacks, monkeypatch):
    """``fabric.recv`` (``serve/fabric.py``) armed, as the reference's
    ``tests/test_robust.py`` test of that name arms it: ``raise`` abandons
    the in-flight attempt (its host's breaker fed) and the same call
    re-routes to the survivor, rows equal to that host's scheduler and
    flagged ``host_failover``; ``delay`` only delays; ``hang`` under a
    spent deadline is released by the deadline and degrades.

    The oracle counts, it does not time: each breaker's ``opens`` (the
    reference test reads ``state == "open"``, which reverts to half-open
    after the breaker's cool-down of one heartbeat timeout, 2 s, so a
    re-routed serve slower than that under load sees no open breaker), and
    which exception ended each firing of the site (a ``hang`` released by
    its 600 s ``hang_s`` would raise ``FaultInjected``, one released by
    the deadline ``DeadlineExceeded``)."""
    _ref_fused, fused = stacks
    ended = []
    fire = fabric_mod.inject.fire

    def spy(site, deadline=None):
        try:
            fire(site, deadline=deadline)
        except BaseException as exc:
            ended.append((site, type(exc).__name__))
            raise
        if site == "fabric.recv":
            ended.append((site, None))

    monkeypatch.setattr(fabric_mod.inject, "fire", spy)
    fleet = _Fleet(fused, n=2)
    breakers = [robust.breaker(f"fabric:{name}") for name in fleet.names]

    def opens():
        return [b.stats["opens"] for b in breakers]

    try:
        assert fleet.fabric.connect() == 2
        failover0, opens0 = _degraded(HOST_FAILOVER), opens()
        with robust.inject.armed("fabric.recv", "raise", times=1):
            got = fleet.fabric.serve([QUERIES[0]])
        assert ended == [("fabric.recv", "FaultInjected")]
        assert got[0], "recv chaos must re-route, not fail the request"
        assert HOST_FAILOVER in got.degraded and _degraded(HOST_FAILOVER) == failover0 + 1
        survivor = fleet.names.index(got.meta["fabric_host"])
        # exactly one host took the fall: the other one answered
        assert [b - a for a, b in zip(opens0, opens())] == [int(i != survivor) for i in range(2)]
        assert list(got) == list(fleet.scheds[survivor].serve([QUERIES[0]]))
        for b in breakers:
            b.reset()
        ended.clear()
        opens0 = opens()
        with robust.inject.armed("fabric.recv", "delay", delay_s=0.02):
            got = fleet.fabric.serve([QUERIES[0]])
        assert ended == [("fabric.recv", None)]
        assert got.degraded == () and got[0] and opens() == opens0
        ended.clear()
        with robust.inject.armed("fabric.recv", "hang", hang_s=600.0):
            got = fleet.fabric.serve([QUERIES[0]], deadline=Deadline(0.0))
        assert ended == [("fabric.recv", "DeadlineExceeded")]
        assert isinstance(got, ServeResult) and got.degraded and list(got) == [[]]
    finally:
        fleet.stop()


def test_bye_drain_reroutes_cleanly(stacks):
    """A planned stop (bye) re-routes new admissions to the survivor."""
    _ref_fused, fused = stacks
    fleet = _Fleet(fused, n=2)
    try:
        assert fleet.fabric.connect() == 2
        fleet.workers[0].stop()
        fleet.scheds[0].stop()
        assert _wait_for(lambda: not fleet.fabric._links[0].up(), 5)
        assert fleet.fabric._links[0].down_reason == "bye"
        for q in QUERIES:
            got = fleet.fabric.serve([q])
            assert got and got[0], q
            assert got.meta["fabric_host"] == fleet.names[1]
        assert fleet.fabric.stats["lost"] == 0
    finally:
        fleet.stop()


def test_exhausted_fleet_degrades_to_replica_lost(stacks):
    """Every host dead: an empty result flagged ``replica_lost``, counted,
    never an exception."""
    _ref_fused, fused = stacks
    fleet = _Fleet(fused, n=2)
    try:
        assert fleet.fabric.connect() == 2
        for i in range(2):
            fleet.crash(i)
        assert _wait_for(lambda: not any(link.up() for link in fleet.fabric._links), 5)
        lost0 = _degraded(REPLICA_LOST)
        got = fleet.fabric.serve(QUERIES[:2])
        assert list(got) == [[], []]
        assert got.degraded == (REPLICA_LOST,)
        assert got.meta["fabric"] == "no_healthy_host"
        assert _degraded(REPLICA_LOST) == lost0 + 1
        assert fleet.fabric.stats["lost"] == 1
    finally:
        fleet.stop()


def test_kill_during_the_handshake_closes_that_stream(stacks, monkeypatch):
    """A front's ``connect()`` returns once it has sent its token, before
    the worker has authenticated and registered the stream.  A worker
    killed inside that window must close the stream it was authenticating
    too: a dead worker that kept it would answer pings, and its link
    would never go down."""
    _ref_fused, fused = stacks
    entered, release = threading.Event(), threading.Event()
    accept = FramedStream.accept

    def held_accept(conn, token, timeout=10.0):
        entered.set()
        release.wait(30)
        return accept(conn, token, timeout)

    monkeypatch.setattr(FramedStream, "accept", staticmethod(held_accept))
    fleet = _Fleet(fused, n=1)
    try:
        assert fleet.fabric.connect() == 1
        assert entered.wait(10)
        fleet.crash(0)
        release.set()
        assert _wait_for(lambda: not fleet.fabric._links[0].up(), 5)
        assert fleet.fabric._links[0].down_reason == "disconnect"
        assert fleet.workers[0]._streams == []
    finally:
        release.set()
        fleet.stop()


def test_heartbeat_silence_trips_the_breaker(stacks, monkeypatch):
    """A host that stops answering pings (socket still open) is marked
    down within one heartbeat timeout."""
    monkeypatch.setenv("PATHWAY_FABRIC_HEARTBEAT", "0.05")
    monkeypatch.setenv("PATHWAY_FABRIC_HEARTBEAT_TIMEOUT", "0.25")
    _ref_fused, fused = stacks
    fleet = _Fleet(fused, n=2)
    release = threading.Event()
    try:
        assert fleet.fabric.connect() == 2
        orig_gen = fabric_mod._generation_of
        wedged = fleet.scheds[0]

        def wedge(target):
            if target is wedged:
                release.wait(30)
            return orig_gen(target)

        monkeypatch.setattr(fabric_mod, "_generation_of", wedge)
        assert _wait_for(lambda: not fleet.fabric._links[0].up(), 3), "silence must mark down"
        assert fleet.fabric._links[0].down_reason == "heartbeat_silence"
        got = fleet.fabric.serve([QUERIES[0]])
        assert got and got[0]
        assert got.meta["fabric_host"] == fleet.names[1]
    finally:
        release.set()
        fleet.stop()


# -- rolling restart ----------------------------------------------------------------------


def test_rolling_restart_zero_downtime(stacks, monkeypatch):
    """Bounce every worker in turn under continuous load: every request
    returns rows, no exception, and each bounced worker re-joins (breaker
    cool-down = one heartbeat timeout) before the next goes down.  Waits
    on the fleet's own state, never on a fixed sleep; the 1 s heartbeat
    timeout keeps a pong delayed by CPU contention from downing the
    survivor."""
    monkeypatch.setenv("PATHWAY_FABRIC_HEARTBEAT", "0.05")
    monkeypatch.setenv("PATHWAY_FABRIC_HEARTBEAT_TIMEOUT", "1.0")
    _ref_fused, fused = stacks
    fleet = _Fleet(fused, n=2)
    stop_serving = threading.Event()
    ramped = threading.Event()
    failures: list = []
    served = itertools.count(1)

    def caller(qi: int):
        while not stop_serving.is_set():
            try:
                got = fleet.fabric.serve([QUERIES[qi % len(QUERIES)]])
                if not (len(got) == 1 and got[0]):
                    failures.append(("empty", list(got), got.degraded))
            except Exception as exc:  # the contract: never an exception
                failures.append(("raise", repr(exc)))
            if next(served) >= 50:
                ramped.set()
            time.sleep(0.002)

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(4)]
    try:
        assert fleet.fabric.connect() == 2
        for t in threads:
            t.start()
        for i in range(2):
            link = fleet.fabric._links[i]
            old = fleet.workers[i]
            port = old.port
            old.stop()
            fleet.scheds[i].stop()
            assert _wait_for(lambda: not link.up(), 5), "the bye never reached the front"
            fleet.scheds[i] = ServeScheduler(fused, window_us=0, result_cache=None, name=f"{fleet.names[i]}-s2")
            t0 = time.monotonic()
            while True:  # a restarting process retries the bind until the port clears
                try:
                    fleet.workers[i] = FabricWorker(
                        fleet.scheds[i], host="127.0.0.1", port=port, token=fleet.token, name=fleet.names[i]
                    )
                    break
                except OSError:
                    assert time.monotonic() - t0 < 10
                    time.sleep(0.05)
            # the probe re-picks its text each round: the affinity hash
            # moves with the fleet generation the pongs report
            probes = (f"rejoin probe {j}" for j in itertools.count())

            def rejoined() -> bool:
                q = next(q for q in probes if fleet.fabric._affinity(q) == i)
                return fleet.fabric.serve([q]).meta.get("fabric_host") == fleet.names[i]

            assert _wait_for(rejoined, 10), f"worker {i} never re-joined the fabric"
        assert ramped.wait(30), "the drive never ramped"
        stop_serving.set()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
        assert failures == [], failures[:5]
        assert robust.breaker(f"fabric:{fleet.names[0]}").state == "closed"
        assert robust.breaker(f"fabric:{fleet.names[1]}").state == "closed"
    finally:
        stop_serving.set()
        fleet.stop()


def test_request_pinned_to_a_draining_survivor_reroutes_to_a_rejoined_host(stacks, monkeypatch):
    """A request admitted while host 0 was down holds host 1 only; host 0
    re-joins, then host 1 drains under the request: the fleet is not
    exhausted, so the request is served by host 0 (``host_failover``),
    not answered ``replica_lost``."""
    monkeypatch.setenv("PATHWAY_FABRIC_HEARTBEAT", "0.05")
    monkeypatch.setenv("PATHWAY_FABRIC_HEARTBEAT_TIMEOUT", "0.3")
    _ref_fused, fused = stacks
    gate, entered = threading.Event(), threading.Event()

    class _Gate:
        def __init__(self, inner):
            self.inner = inner

        def serve(self, texts, k=None, deadline=None, priority=None):
            if not entered.is_set():  # the first request parks; later ones pass
                entered.set()
                gate.wait(10)
            return self.inner.serve(texts, k=k, deadline=deadline)

    token = fabric_token()
    names = _host_names(2)
    scheds = [ServeScheduler(fused, window_us=0, result_cache=None) for _ in range(3)]
    w0 = FabricWorker(scheds[0], token=token, name=names[0])
    w1 = FabricWorker(_Gate(scheds[1]), token=token, name=names[1])
    fab = ServeFabric({w0.name: w0.address, w1.name: w1.address}, token, name=f"fab-pin-{names[0]}")
    box = {}
    t = threading.Thread(target=lambda: box.setdefault("result", fab.serve([QUERIES[2]])))
    workers = [w0, w1]
    try:
        assert fab.connect() == 2
        port0 = w0.port
        w0.stop()
        assert _wait_for(lambda: not fab._links[0].up(), 5)
        t.start()
        assert entered.wait(10), "the request never reached host 1"
        workers.append(FabricWorker(scheds[2], host="127.0.0.1", port=port0, token=token, name=names[0]))
        assert _wait_for(lambda: robust.breaker(f"fabric:{names[0]}").state != "open", 5)
        probes = (q for q in (f"pin probe {j}" for j in itertools.count()) if fab._affinity(q) == 0)
        assert _wait_for(lambda: fab.serve([next(probes)]).meta.get("fabric_host") == names[0], 10)
        w1.stop()  # host 1 drains under the pinned request
        t.join(10)
        assert not t.is_alive()
        got = box["result"]
        assert got and got[0] and got.degraded == (HOST_FAILOVER,)
        assert got.meta["fabric_host"] == names[0]
        assert list(got) == list(scheds[0].serve([QUERIES[2]]))
        assert fab.stats["lost"] == 0
    finally:
        gate.set()
        fab.stop()
        for w in workers:
            w.stop()
        for s in scheds:
            s.stop()


def test_reconnect_restarts_the_liveness_clock_before_publishing(stacks):
    """The heartbeat reads a link's stream, then its clock: a reconnect
    that published the stream before restarting the clock could be downed
    for the silence of the stream it replaced."""
    _ref_fused, fused = stacks
    ages = []

    class _Watched(fabric_mod._HostLink):
        @property
        def _stream(self):
            return self.__dict__.get("_watched")

        @_stream.setter
        def _stream(self, value):
            if value is not None:
                ages.append(time.monotonic() - self.last_pong)
            self.__dict__["_watched"] = value

    sched = ServeScheduler(fused, window_us=0, result_cache=None)
    token = fabric_token()
    worker = FabricWorker(sched, token=token, name=_host_names(1)[0])
    link = _Watched(worker.name, *worker.address, token)
    try:
        link.last_pong = time.monotonic() - 100.0  # the clock of a stream long gone
        assert link.ensure() is not None
        assert ages and ages[-1] < 5.0
        link.heartbeat(1.0, time.monotonic(), 0.0)
        assert link.up() and link.down_reason is None
    finally:
        link.close()
        worker.stop()
        sched.stop()


def test_a_stalled_front_restarts_the_silence_clock(monkeypatch):
    """A heartbeat tick that comes late by more than half a timeout means
    the front itself stalled: it restarts the silence clock instead of
    downing a host it could not hear; a host that stays silent past a
    timeout of regular ticks after that is still downed."""
    monkeypatch.setenv("PATHWAY_FABRIC_HEARTBEAT", "3600")  # the loop sleeps; the test ticks by hand
    monkeypatch.setenv("PATHWAY_FABRIC_HEARTBEAT_TIMEOUT", "0.5")
    token = fabric_token()
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    mute = []  # a host that authenticates the front and never answers a ping
    acceptor = threading.Thread(target=lambda: mute.append(FramedStream.accept(listener.accept()[0], token)))
    acceptor.start()
    name = _host_names(1)[0]
    fab = ServeFabric({name: listener.getsockname()}, token, name=f"fab-stall-{name}")
    monkeypatch.setenv("PATHWAY_FABRIC_HEARTBEAT", "0.1")
    try:
        assert fab.connect() == 1
        acceptor.join(5)
        link = fab._links[0]
        t0 = time.monotonic()
        link.last_pong = t0 - 10.0  # no pong for 10 s ...
        fab._last_tick = t0 - 10.0  # ... while this front did not tick for 10 s
        fab._tick(t0)
        assert link.up() and fab.stats["stalled_ticks"] == 1
        for i in range(1, 6):
            fab._tick(t0 + 0.1 * i)
        assert link.up() and fab.stats["stalled_ticks"] == 1
        fab._tick(t0 + 0.6)
        assert not link.up() and link.down_reason == "heartbeat_silence"
    finally:
        fab.stop()
        for stream in mute:
            stream.close()
        listener.close()


# -- scrape surface -----------------------------------------------------------------------


def test_fabric_metrics_reach_the_scrape_surface(stacks):
    _ref_fused, fused = stacks
    fleet = _Fleet(fused, n=2)
    try:
        assert fleet.fabric.connect() == 2
        fleet.fabric.serve([QUERIES[0]])
        snap = observe.snapshot()
        names = "\n".join(list(snap["counters"]) + list(snap["gauges"]))
        for family in ("pathway_fabric_requests_total", "pathway_fabric_host_up", "pathway_fabric_inflight"):
            assert family in names
        ok = [v for key, v in snap["counters"].items()
              if key.startswith("pathway_fabric_requests_total") and f'fabric="{fleet.fabric.name}"' in key
              and 'outcome="ok"' in key]
        assert ok == [1]
    finally:
        fleet.stop()


# -- the wire -------------------------------------------------------------------------------

_UNPICKLED = threading.Event()


def _mark_unpickled():
    _UNPICKLED.set()
    return "boom"


class _Boom:
    """A frame whose unpickle has a side effect."""

    def __reduce__(self):
        return (_mark_unpickled, ())


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_worker_rejects_bad_token(stacks, pkg):
    """A client with the wrong secret is dropped before any unpickle (a
    frame whose unpickle would fire a side effect is never parsed); the
    worker keeps serving authenticated fronts.  Both packages."""
    ref_fused, fused = stacks
    fleet = _Fleet(fused if pkg == "port" else ref_fused, n=1, pkg=pkg)
    _UNPICKLED.clear()
    try:
        raw = socket.create_connection(fleet.workers[0].address, timeout=5)
        payload = pickle.dumps({"op": "serve", "texts": [_Boom()], "req_id": 1})
        raw.sendall(fabric_token() + len(payload).to_bytes(8, "big") + payload)
        raw.settimeout(5)
        try:
            assert raw.recv(1) == b""  # closed at the token check
        except ConnectionResetError:
            pass
        raw.close()
        intruder = FramedStream.connect(*fleet.workers[0].address, fabric_token(), timeout=2.0)
        with pytest.raises(PeerLost):
            t_end = time.monotonic() + 5
            while time.monotonic() < t_end:
                try:
                    intruder.send({"op": "serve", "texts": ["x"], "req_id": 1})
                    intruder.recv(timeout=0.2)
                except socket.timeout:
                    continue
        intruder.close()
        assert not _UNPICKLED.is_set()
        got = fleet.fabric.serve([QUERIES[0]])
        assert got and got[0]
    finally:
        fleet.stop()


def _is_plain(value) -> bool:
    if isinstance(value, dict):
        return all(isinstance(k, str) and _is_plain(v) for k, v in value.items())
    if isinstance(value, (list, tuple)):
        return all(_is_plain(v) for v in value)
    return value is None or type(value) in (bool, int, float, str)


def test_reply_frames_carry_plain_host_values(stacks):
    """What crosses the wire: rows of ``(int, float)`` tuples and a meta
    of Python values, whatever the scheduler returned (numpy scalars, a
    tensor in meta), read off the frame itself."""
    _ref_fused, fused = stacks

    class _NumpyTarget:
        def serve(self, texts, k=None, deadline=None, priority=None):
            return ServeResult(
                [[(np.int64(7), np.float32(0.5)), (np.uint64(9), np.float32(0.25))] for _ in texts],
                meta={"index_generation": np.int64(3), "probe": torch.arange(3), "view": np.arange(2)},
            )

    sched = ServeScheduler(fused, window_us=0, result_cache=None)
    token = fabric_token()
    names = _host_names(2)
    workers = [FabricWorker(sched, token=token, name=names[0]),
               FabricWorker(_NumpyTarget(), token=token, name=names[1])]
    try:
        for w, want_gen in zip(workers, (1, 3)):
            stream = FramedStream.connect(*w.address, token)
            try:
                stream.send({"op": "serve", "texts": QUERIES[:2], "k": 5, "req_id": 11})
                reply = stream.recv(timeout=30)
            finally:
                stream.close()
            assert reply["op"] == "result" and reply["req_id"] == 11
            assert len(reply["rows"]) == 2 and all(reply["rows"])
            for row in reply["rows"]:
                assert all(type(pair) is tuple and type(pair[0]) is int and type(pair[1]) is float for pair in row)
            assert _is_plain(reply["meta"]) and reply["meta"]["index_generation"] == want_gen
        assert reply["meta"]["probe"] == [0, 1, 2] and reply["rows"][0] == [(7, 0.5), (9, 0.25)]
    finally:
        for w in workers:
            w.stop()
        sched.stop()


def test_reference_front_drives_port_workers_and_back(stacks):
    """The frames are shared: the reference's ``ServeFabric`` in front of
    the port's workers returns the port front's rows, and the port's
    front in front of the reference's workers the reference front's."""
    ref_fused, fused = stacks
    port_fleet = _Fleet(fused, n=2)
    ref_fleet = _Fleet(ref_fused, n=2, pkg="ref")
    hosts = {w.name: w.address for w in port_fleet.workers}
    ref_front = RefFabric(hosts, port_fleet.token, name=f"xref-{port_fleet.names[0]}")
    ref_hosts = {w.name: w.address for w in ref_fleet.workers}
    port_front = ServeFabric(ref_hosts, ref_fleet.token, name=f"xport-{ref_fleet.names[0]}")
    try:
        assert ref_front.connect() == 2 and port_front.connect() == 2
        for q in QUERIES:
            got = ref_front.serve([q], k=5)
            assert got.degraded == () and got.meta["fabric_host"] in port_fleet.names
            assert list(got) == list(port_fleet.fabric.serve([q], k=5)), q
            got = port_front.serve([q], k=5)
            assert got.degraded == () and got.meta["fabric_host"] in ref_fleet.names
            assert list(got) == list(ref_fleet.fabric.serve([q], k=5)), q
    finally:
        ref_front.stop()
        port_front.stop()
        port_fleet.stop()
        ref_fleet.stop()


# -- the pieces the fabric brings ---------------------------------------------------------------


@pytest.mark.parametrize("key", FABRIC_KNOBS)
def test_fabric_knobs_match_the_reference(key, monkeypatch):
    mine, theirs = config.registry()[key], ref_config.registry()[key]
    for field in ("env", "kind", "default", "lo", "hi", "choices", "mutability", "site_prefix"):
        assert getattr(mine, field) == getattr(theirs, field), field
    for raw in ("0.3", "7", "-1", "1e9", "junk"):
        monkeypatch.setenv(mine.env, raw)
        assert config.get(key) == ref_config.get(key), raw


@pytest.mark.parametrize(
    "flags, meta",
    [((), None), (("host_failover",), {"fabric_host": "h1"}),
     (("rerank_skipped", "host_failover", "host_failover"), {"hedged": True, "degraded_reasons": ["stale"]})],
)
def test_with_flags_matches_the_reference(flags, meta):
    rows = [[(1, 0.5)], []]
    for start in ((), ("rerank_skipped",)):
        got = ServeResult(rows, degraded=start, meta={"index_generation": 4}).with_flags(flags, meta)
        want = RefServeResult(rows, degraded=start, meta={"index_generation": 4}).with_flags(flags, meta)
        assert list(got) == list(want)
        assert got.degraded == want.degraded
        assert got.meta == want.meta
        assert got.meta.get("degraded_reasons", []) == list(got.degraded)


def test_scheduler_is_callable_as_the_reference_is(stacks):
    """The schedulers' aliases are the reference's: ``ServeScheduler`` is
    called as ``serve``, ``SharedBatcher`` as ``score``, and both close
    as they stop."""
    from pathway_tpu.serve import SharedBatcher as RefBatcher
    from pathway_tpu_torch.serve import SharedBatcher

    for port_cls, ref_cls in ((ServeScheduler, RefScheduler), (SharedBatcher, RefBatcher)):
        for alias in ("__call__", "close"):
            want = getattr(ref_cls, alias).__name__
            assert getattr(port_cls, alias).__name__ == want, (port_cls.__name__, alias)
    _ref_fused, fused = stacks
    sched = ServeScheduler(fused, window_us=0, result_cache=None)
    batcher = SharedBatcher(lambda items: lambda: np.asarray([len(t) for t in items], np.float32), window_us=0)
    try:
        assert list(sched([QUERIES[1]], k=3)) == list(sched.serve([QUERIES[1]], k=3))
        assert batcher(["ab", "c"]).tolist() == [2.0, 1.0]
    finally:
        sched.close()
        batcher.close()
    assert sched._thread is None and batcher._thread is None
