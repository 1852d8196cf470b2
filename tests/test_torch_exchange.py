"""The port's engine exchange plane (``pathway_tpu_torch/parallel/
exchange.py`` ``ExchangePlane``) on the CPU.

Three in-process ranks meet over a local ``torch.distributed.TCPStore``
(the control plane's store, as ``get_plane`` uses it): ``all_to_all``,
``gather`` and ``broadcast`` keyed by (edge, round), out-of-order rounds,
a payload of many pickler chunks, a clean ``__bye__`` against a lost peer,
a connection with a bad token dropped before anything is unpickled, and
the ``pathway_exchange_*`` samples.  The three cases of
``tests/test_exchange_heartbeat.py`` run against the port's plane: slow
serialization and slow deserialization (the background heartbeat thread
starved) are not a lost peer, and a peer that goes silent still is.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch.distributed as tdist

from pathway_tpu_torch import observe
from pathway_tpu_torch.parallel import exchange
from pathway_tpu_torch.parallel.exchange import ExchangePlane, PeerLost


class _Store:
    """Per-rank clients of one local ``TCPStore``, as the kv pair of
    ``parallel/distributed.py`` reads it."""

    def __init__(self):
        self.master = tdist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
        self.port = self.master.port

    def client(self):
        store = tdist.TCPStore("127.0.0.1", self.port, is_master=False)

        def kv_get(key):
            store.wait([key])
            return store.get(key).decode()

        return store.set, kv_get


def _mesh(n, namespace, classes=None, before=None):
    """``n`` planes built in threads; ``before(store)`` runs once rank 0
    has published its address and before the others start."""
    store = _Store()
    planes, errs = {}, []
    classes = classes or {}

    def build(rank):
        try:
            kv_set, kv_get = store.client()
            planes[rank] = classes.get(rank, ExchangePlane)(rank, n, kv_set, kv_get, namespace=namespace)
        except BaseException as exc:  # noqa: BLE001 - surfaced below
            errs.append(exc)

    threads = [threading.Thread(target=build, args=(0,))]
    threads[0].start()
    if before is not None:
        before(store)
    for r in range(1, n):
        threads.append(threading.Thread(target=build, args=(r,)))
        threads[-1].start()
    for t in threads:
        t.join(60)
    assert not errs and sorted(planes) == list(range(n)), errs
    return planes


def _on_ranks(planes, fn):
    """``fn(rank, plane)`` on every rank at once; results by rank."""
    out, errs = {}, []

    def one(r):
        try:
            out[r] = fn(r, planes[r])
        except BaseException as exc:  # noqa: BLE001 - surfaced below
            errs.append((r, exc))

    threads = [threading.Thread(target=one, args=(r,)) for r in planes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs, errs
    return out


def test_collectives_over_three_ranks():
    planes = _mesh(3, "coll")
    try:
        got = _on_ranks(planes, lambda r, p: p.all_to_all("e1", 0, [f"{r}->{j}" for j in range(3)], timeout=20))
        for r in range(3):
            assert got[r] == [f"{j}->{r}" for j in range(3)]
        got = _on_ranks(planes, lambda r, p: p.gather("e2", 0, {"rank": r}, root=1, timeout=20))
        assert got[1] == [{"rank": j} for j in range(3)] and got[0] is None and got[2] is None
        got = _on_ranks(planes, lambda r, p: p.broadcast("e3", 0, ("tick", 7) if r == 2 else None, root=2, timeout=20))
        assert all(v == ("tick", 7) for v in got.values())

        # rounds keyed by (edge, round): the senders send round 1 before
        # round 0; the root's round-1 frames park in the inbox until asked
        def rounds(r, p):
            if r == 0:
                return [p.gather("e4", 0, (0, r), root=0, timeout=20), p.gather("e4", 1, (1, r), root=0, timeout=20)]
            p.gather("e4", 1, (1, r), root=0, timeout=20)
            return p.gather("e4", 0, (0, r), root=0, timeout=20)

        got = _on_ranks(planes, rounds)
        assert got[0] == [[(0, j) for j in range(3)], [(1, j) for j in range(3)]]

        # a payload of many pickler chunks (well past one 64 KiB frame),
        # whose array the pickler hands over as one PickleBuffer
        big = np.arange(3 << 18, dtype=np.float32)  # 3 MiB
        got = _on_ranks(planes, lambda r, p: p.gather("big", 0, [big + r, list(range(20_000))], root=0, timeout=20))
        for j, (arr, ints) in enumerate(got[0]):
            np.testing.assert_array_equal(arr, big + j)
            assert ints == list(range(20_000))
        assert planes[1]._chunks_out[0] >= 1 and planes[0]._bytes_in[1] > big.nbytes

        text = "\n".join(observe.render_prometheus())
        plane_id = planes[0]._observe_id
        for family in ("pathway_exchange_peer_up", "pathway_exchange_bytes_total", "pathway_exchange_chunks_total",
                       "pathway_exchange_heartbeat_silence_seconds", "pathway_exchange_heartbeat_timeout_seconds"):
            assert family in text, family
        assert f'pathway_exchange_peer_up{{peer="1",plane="{plane_id}",rank="0"}} 1' in text
    finally:
        for p in planes.values():
            p.close()


def test_bye_fails_a_waiting_collective_without_poisoning_the_plane():
    """A rank that leaves on purpose says ``__bye__``: a collective still
    waiting on it fails at once, naming the clean close, and the plane is
    not declared dead; a rank whose sockets just drop is a lost peer."""
    planes = _mesh(3, "bye")
    try:
        planes[2].close()
        with pytest.raises(PeerLost, match="closed cleanly"):
            planes[0].gather("after-bye", 0, None, root=0, timeout=20)
        assert planes[0]._dead is None
        # ranks 0 and 1 still exchange with each other
        got = _on_ranks({0: planes[0], 1: planes[1]}, lambda r, p: (p.broadcast("pair", 0, "ok", root=0, timeout=20)
                                                                    if r == 0 else p._wait("pair", 0, [0], 20)[0]))
        assert got == {0: "ok", 1: "ok"}
        # rank 1 vanishes without a goodbye: rank 0's plane is dead
        for s in planes[1]._send.values():
            s.close()
        planes[1]._listener.close()
        deadline = time.monotonic() + 20
        while planes[0]._dead is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert isinstance(planes[0]._dead, PeerLost)
        with pytest.raises(PeerLost, match="disconnected"):
            planes[0].gather("never", 0, None, root=0, timeout=20)
    finally:
        for p in planes.values():
            p.close()


class _Planted:
    """Unpickling this records that a frame was parsed."""

    parsed = []

    def __reduce__(self):
        return (_Planted.parsed.append, ("unpickled",))


def test_a_connection_with_a_bad_token_is_dropped_before_any_unpickling():
    """A connection that presents a wrong session token is closed before a
    byte of its frame is parsed, and takes no rank's slot."""
    rogue = {}

    def intrude(store):
        kv_set, kv_get = store.client()
        host, port = kv_get("pathway_tpu/exch/rogue/0").rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=10)
        payload = pickle.dumps(("edge", 0, _Planted()))
        s.sendall(struct.pack("!Q", 1) + b"\0" * exchange._TOKEN_LEN + struct.pack("!Q", len(payload)) + payload)
        rogue["sock"] = s

    _Planted.parsed.clear()
    planes = _mesh(2, "rogue", before=intrude)
    try:
        s = rogue["sock"]
        s.settimeout(10)
        try:
            closed = s.recv(1) == b""
        except ConnectionResetError:
            closed = True
        assert closed, "the listener kept a connection with a bad token"
        got = _on_ranks(planes, lambda r, p: p.all_to_all("after", 0, [r] * 2, timeout=20))
        assert got == {0: [0, 1], 1: [0, 1]}
        assert _Planted.parsed == []
    finally:
        rogue["sock"].close()
        for p in planes.values():
            p.close()


# -- the heartbeat cases of tests/test_exchange_heartbeat.py ------------------------


class _StarvedHeartbeatPlane(ExchangePlane):
    """A plane whose background heartbeat thread never runs: only the
    inline ticks of the serializing (or deserializing) thread can prove
    this rank's liveness."""

    def _heartbeat_loop(self):  # pragma: no cover - intentionally inert
        return


class _SlowChunk:
    """Pickles to 64 KiB after a stall."""

    def __init__(self, delay: float):
        self.delay = delay

    def __reduce__(self):
        time.sleep(self.delay)
        return (bytes, (b"\0" * 65536,))


def _slow_load(delay: float, data: bytes) -> bytes:
    time.sleep(delay)
    return data


class _SlowLoadChunk:
    """Pickles at once (64 KiB of payload) but stalls when unpickled."""

    def __init__(self, delay: float):
        self.delay = delay
        self.data = b"\0" * 65536

    def __reduce__(self):
        return (_slow_load, (self.delay, self.data))


def _hb_mesh(monkeypatch, namespace, classes=None):
    monkeypatch.setenv("PATHWAY_EXCHANGE_HEARTBEAT", "0.2")
    monkeypatch.setenv("PATHWAY_EXCHANGE_HEARTBEAT_TIMEOUT", "1.0")
    return _mesh(2, namespace, classes)


def test_slow_serialization_is_not_declared_peer_lost(monkeypatch):
    planes = _hb_mesh(monkeypatch, "hb-ser", {0: _StarvedHeartbeatPlane})
    try:
        # ~2.5 s of serialization stalls against a 1.0 s heartbeat timeout
        payload = [_SlowChunk(0.05) for _ in range(50)]
        got = _on_ranks(planes, lambda r, p: p.gather("slow", 0, payload if r == 0 else None, root=1, timeout=60))
        assert len(got[1]) == 2 and len(got[1][0]) == 50
        assert planes[1]._dead is None, planes[1]._dead
    finally:
        for p in planes.values():
            p.close()


def test_slow_deserialization_is_not_declared_peer_lost(monkeypatch):
    planes = _hb_mesh(monkeypatch, "hb-de", {1: _StarvedHeartbeatPlane})
    try:
        payload = [_SlowLoadChunk(0.05) for _ in range(50)]

        def side(r, p):
            if r == 0:
                p.gather("slowload", 0, payload, root=1, timeout=60)
                # rank 0 now waits on rank 1 while it deserializes
                return p.gather("after", 1, "r0", root=0, timeout=60)
            got = p.gather("slowload", 0, None, root=1, timeout=60)
            p.gather("after", 1, "r1", root=0, timeout=60)
            return got

        got = _on_ranks(planes, side)
        assert got[0] == ["r0", "r1"]
        assert len(got[1]) == 2 and len(got[1][0]) == 50
        assert planes[0]._dead is None and planes[1]._dead is None
    finally:
        for p in planes.values():
            p.close()


def test_hung_peer_is_still_detected(monkeypatch):
    planes = _hb_mesh(monkeypatch, "hb-hung")
    try:
        planes[0].close()  # rank 0 vanishes without sending
        with pytest.raises(PeerLost):
            planes[1].gather("never", 0, None, root=1, timeout=30)
    finally:
        for p in planes.values():
            p.close()
