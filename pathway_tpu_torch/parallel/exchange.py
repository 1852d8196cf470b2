"""Host-side exchange of the port (counterpart of
``pathway_tpu/parallel/exchange.py``): the engine's ``ExchangePlane`` and
the serve fabric's ``FramedStream``.

``ExchangePlane`` carries the host dataflow engine's records between the
``PATHWAY_PROCESSES`` ranks: connector reads are split across processes
and rows must reach the process that owns their key (reference
``reshard`` after ingest, src/engine/dataflow.rs:3314).  It is a full TCP
mesh carrying pickled ``Delta`` shards as BSP collectives.  Every rank
executes the SAME sequence of collective calls per commit tick (the engine
sweeps operators in one global topological order — engine/graph.py), so
each call is identified by an ``(edge, seq)`` pair and deadlock is
structurally impossible; out-of-order arrivals park in an inbox keyed by
that pair.  The device data plane stays on ``torch.distributed``
(``parallel/distributed.py``).

Rendezvous rides the control plane's ``TCPStore`` (``distributed.kv_set``
/ ``kv_get``, the counterpart of the reference's coordination KV), so no
extra ports need configuring: each rank publishes its listen address once
at startup.

A peer dying mid-stream surfaces as a broken connection; a peer that HANGS
(SIGSTOP, network partition with the socket still open) is caught by the
heartbeat: every rank pings every peer each ``PATHWAY_EXCHANGE_HEARTBEAT``
seconds (default 2), and a collective waiting on a peer that has been silent
for ``PATHWAY_EXCHANGE_HEARTBEAT_TIMEOUT`` seconds (default 8) raises
``PeerLost`` instead of stalling for the full collective timeout.  Every
blocked collective then raises, aborting this rank's run too — the analog of
the reference's worker-panic propagation (src/engine/dataflow.rs:5667-5676).
Recovery is a cluster restart from persisted snapshots (per-rank input logs
+ offsets, ``internals/run.py`` ``_rank_scoped``).

Transport hardening: the listener binds ONLY the advertised interface
(loopback for single-host clusters), and every connection must open with a
32-byte session secret minted by rank 0 and distributed over the store —
frames are pickled, so an unauthenticated listener would hand
arbitrary-code-execution to anyone who could reach the port.

``FramedStream`` is one token-authenticated, length-prefixed pickle
stream over one TCP connection, the serve fabric's point-to-point wire:
the same 8-byte big-endian length (``_HDR``) before each pickled frame and
the same 32-byte session secret (``_TOKEN_LEN``), which the accepting side
reads first and checks with ``hmac.compare_digest`` BEFORE it parses any
frame.  Any thread may ``send`` (one send lock keeps frames whole); exactly
one thread should ``recv``.  A broken or closed connection surfaces as
``PeerLost``; a ``recv`` timeout with no frame started surfaces as
``socket.timeout`` so a caller can poll.  Its frames carry the same dicts
as the reference's (``serve``, ``result``, ``error``, ``ping``, ``pong``,
``absorb``, ``absorb_ack``, ``bye``), so a reference front can drive a port
worker and back.
"""

from __future__ import annotations

import errno
import hmac
import pickle
import secrets
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from .. import config, observe
from ..robust import RetryPolicy, inject

__all__ = ["ExchangePlane", "FramedStream", "PeerLost", "close_plane", "gather_table_rows", "get_plane"]

_HDR = struct.Struct("!Q")
_TOKEN_LEN = 32
_HB_EDGE = "__hb__"
# clean-shutdown control frame: a rank leaving on purpose announces it,
# so its disconnect is goodbye, not PeerLost
_BYE_EDGE = "__bye__"

# socket errors that mean "try the same write again", NOT "the peer is
# gone": interrupted syscalls and transient kernel buffer exhaustion.
# Anything else (ECONNRESET, EPIPE, ...) stays fatal for the stream.
_TRANSIENT_ERRNOS = frozenset(
    {errno.EINTR, errno.EAGAIN, errno.EWOULDBLOCK, errno.ENOBUFS, errno.ENOMEM}
)
# pre-frame send retries (fault site "exchange.send"): safe only before
# the first byte of a frame is on the wire
_SEND_RETRY = RetryPolicy(attempts=3, base_delay_s=0.005, max_delay_s=0.1)


def _hb_interval() -> float:
    return config.get("parallel.exchange_heartbeat_s")


def _hb_timeout() -> float:
    return config.get("parallel.exchange_heartbeat_timeout_s")


class PeerLost(RuntimeError):
    """A cluster peer disconnected (crashed, exited early or closed the
    stream)."""


class FramedStream:
    """One authenticated duplex frame stream (see the module docstring)."""

    __slots__ = ("_sock", "_send_lock", "_closed")

    def __init__(self, sock: socket.socket):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._send_lock = threading.Lock()
        self._closed = False

    @classmethod
    def connect(cls, host: str, port: int, token: bytes, timeout: float = 5.0) -> "FramedStream":
        """Dial a listener and present the session secret (client side)."""
        s = socket.create_connection((host, port), timeout=timeout)
        try:
            s.sendall(token)
        except OSError as exc:
            s.close()
            raise PeerLost(f"fabric connect to {host}:{port} failed: {exc!r}")
        s.settimeout(None)
        return cls(s)

    @classmethod
    def accept(cls, conn: socket.socket, token: bytes, timeout: float = 10.0) -> "FramedStream":
        """Authenticate one accepted connection (server side): the first
        ``_TOKEN_LEN`` bytes must equal the session secret, or the
        connection is closed before any frame is parsed."""
        try:
            conn.settimeout(timeout)
            offered = _recv_exact(conn, _TOKEN_LEN)
            if not hmac.compare_digest(offered, token):
                raise PermissionError("bad fabric token")
            conn.settimeout(None)
        except BaseException:
            try:
                conn.close()
            except OSError:
                pass
            raise
        return cls(conn)

    def send(self, obj: Any) -> None:
        """Pickle, frame and write ``obj`` (thread-safe)."""
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        frame = _HDR.pack(len(payload)) + payload
        try:
            with self._send_lock:
                self._sock.sendall(frame)
        except OSError as exc:
            raise PeerLost(f"fabric send failed: {exc!r}") from exc

    def recv(self, timeout: Optional[float] = None) -> Any:
        """The next frame, unpickled.  ``socket.timeout`` when ``timeout``
        elapses before a frame starts; ``PeerLost`` on disconnect."""
        try:
            self._sock.settimeout(timeout)
            hdr = _recv_exact(self._sock, _HDR.size)
            # once a header has landed the frame is in flight: the poll
            # timeout must not cut a slow payload short
            self._sock.settimeout(None)
            (length,) = _HDR.unpack(hdr)
            return pickle.loads(_recv_exact(self._sock, length))
        except socket.timeout:
            raise
        except (OSError, ConnectionError, EOFError) as exc:
            raise PeerLost(f"fabric recv failed: {exc!r}") from exc

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class ExchangePlane:
    """Full-mesh TCP exchange among ``nproc`` ranks with BSP semantics."""

    def __init__(self, rank: int, nproc: int, kv_set, kv_get, namespace: str = "0"):
        self.rank = rank
        self.nproc = nproc
        self._send: Dict[int, socket.socket] = {}
        self._send_locks: Dict[int, threading.Lock] = {}
        self._inbox: Dict[Tuple[str, int, int], Any] = {}
        self._cv = threading.Condition()
        self._dead: Optional[BaseException] = None
        self._closed = False
        # peers that announced clean shutdown (__bye__): their later
        # disconnect is expected, not PeerLost — but a collective still
        # WAITING on one of them fails immediately with a clear message
        self._peer_closed: Set[int] = set()
        self._recv_threads: List[threading.Thread] = []
        self._last_recv: Dict[int, float] = {}
        # flight-recorder accounting: per-peer wire traffic counters
        # (bumped inline on the send/recv paths — plain int adds) and
        # liveness gauges sampled at scrape time (pathway_exchange_*)
        self._bytes_in: Dict[int, int] = {}
        self._bytes_out: Dict[int, int] = {}
        self._chunks_in: Dict[int, int] = {}
        self._chunks_out: Dict[int, int] = {}
        self._observe_id = observe.next_id()
        observe.register_provider(self)

        # session secret: rank 0 mints it, everyone reads it from the
        # control plane's store (which only cluster members share).
        # Connections that cannot present it are dropped before any
        # pickle.loads runs.
        if rank == 0:
            self._token = secrets.token_bytes(_TOKEN_LEN)
            kv_set(f"pathway_tpu/exch/{namespace}/token", self._token.hex())
        else:
            self._token = bytes.fromhex(
                kv_get(f"pathway_tpu/exch/{namespace}/token")
            )

        # rendezvous: publish my listen addr, read everyone else's.  Bind
        # ONLY the advertised interface (loopback for single-host clusters,
        # the NIC that routes to the coordinator for multi-host) — frames
        # are pickled, so the listener must not face the open network.
        host = _advertise_host()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, 0))
        self._listener.listen(nproc)
        _, port = self._listener.getsockname()
        kv_set(f"pathway_tpu/exch/{namespace}/{rank}", f"{host}:{port}")
        addrs: Dict[int, Tuple[str, int]] = {}
        for peer in range(nproc):
            if peer == self.rank:
                continue
            raw = kv_get(f"pathway_tpu/exch/{namespace}/{peer}")
            h, p = raw.rsplit(":", 1)
            addrs[peer] = (h, int(p))

        # accept loop (peers dial me), started before dialing out.  Junk or
        # unauthenticated connections are closed and do not consume a slot.
        accepted: Dict[int, socket.socket] = {}
        accept_done = threading.Event()

        def _accept():
            deadline = time.monotonic() + 60
            try:
                while len(accepted) < nproc - 1 and time.monotonic() < deadline:
                    conn, _ = self._listener.accept()
                    try:
                        conn.settimeout(10)
                        peer_rank = _HDR.unpack(_recv_exact(conn, _HDR.size))[0]
                        offered = _recv_exact(conn, _TOKEN_LEN)
                        if not hmac.compare_digest(offered, self._token):
                            raise PermissionError("bad exchange token")
                        conn.settimeout(None)
                        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                        accepted[int(peer_rank)] = conn
                    except Exception:
                        try:
                            conn.close()
                        except OSError:
                            pass
            finally:
                accept_done.set()

        acceptor = threading.Thread(target=_accept, daemon=True, name="exch-accept")
        acceptor.start()
        for peer, (h, p) in addrs.items():
            s = socket.create_connection((h, p), timeout=60)
            # the 60s is a CONNECT timeout only: a permanent per-op timeout
            # would misread any >60s stall (peer inside a long kernel build
            # with full TCP buffers) as peer death and abort a healthy cluster
            s.settimeout(None)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.sendall(_HDR.pack(self.rank) + self._token)
            self._send[peer] = s
            self._send_locks[peer] = threading.Lock()
        if not accept_done.wait(timeout=60):  # pragma: no cover - rendezvous hang
            raise RuntimeError("exchange plane rendezvous timed out")
        acceptor.join()
        if len(accepted) != nproc - 1:  # pragma: no cover
            raise RuntimeError(
                f"exchange plane rendezvous incomplete: {sorted(accepted)}"
            )
        # the recv threads tick heartbeats inline from _deserialize, so the
        # ping frame and tick clock must exist BEFORE the first frame can
        # arrive — assigning them after the thread starts races an early
        # sender into an AttributeError-turned-PeerLost at startup
        ping = pickle.dumps((_HB_EDGE, 0, None), protocol=pickle.HIGHEST_PROTOCOL)
        self._ping_frame = _HDR.pack(len(ping)) + ping
        self._last_tick = time.monotonic()
        now = time.monotonic()
        for peer, conn in accepted.items():
            self._last_recv[peer] = now
            t = threading.Thread(
                target=self._recv_loop, args=(peer, conn), daemon=True,
                name=f"exch-recv-{peer}",
            )
            t.start()
            self._recv_threads.append(t)
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True, name="exch-heartbeat"
        )
        self._hb_thread.start()

    # -- wire ---------------------------------------------------------------
    def _recv_loop(self, peer: int, conn: socket.socket) -> None:
        def alive() -> None:
            # refresh per CHUNK, not per frame: a frame larger than the
            # link can carry in hb_timeout seconds must still count as
            # liveness, or slow bulk transfers would read as a hung peer
            self._last_recv[peer] = time.monotonic()

        try:
            while True:
                hdr = _recv_exact(conn, _HDR.size, on_chunk=alive)
                (length,) = _HDR.unpack(hdr)
                payload = _recv_exact(conn, length, on_chunk=alive)
                self._bytes_in[peer] = (
                    self._bytes_in.get(peer, 0) + _HDR.size + length
                )
                self._chunks_in[peer] = self._chunks_in.get(peer, 0) + 1
                edge, seq, obj = self._deserialize(peer, payload)
                with self._cv:
                    self._last_recv[peer] = time.monotonic()
                    if edge == _BYE_EDGE:
                        # clean shutdown announced: the disconnect that
                        # follows is goodbye, not peer death
                        self._peer_closed.add(peer)
                    elif edge != _HB_EDGE:
                        self._inbox[(edge, seq, peer)] = obj
                    self._cv.notify_all()
        except BaseException as exc:  # noqa: BLE001 - any failure kills the run
            with self._cv:
                if (
                    not self._closed
                    and peer not in self._peer_closed
                    and self._dead is None
                ):
                    self._dead = PeerLost(
                        f"exchange peer {peer} disconnected: {exc!r}"
                    )
                self._cv.notify_all()

    def _send_to(self, peer: int, edge: str, seq: int, obj: Any) -> None:
        parts = self._serialize(edge, seq, obj)
        total = sum(len(p) for p in parts)
        # chaos fault site, fired before the first byte of the frame is
        # on the wire — the only point where a retry cannot desync the
        # stream.  Injected faults retry with backoff under _SEND_RETRY;
        # REAL transient socket errors are handled separately inside
        # _send_frame's slice loop (this site has no real work of its
        # own, so it deliberately bypasses retry_call — its retry
        # counters must never suggest production sends were retried
        # here).  An exhausted budget is a send failure: PeerLost.
        for attempt in range(_SEND_RETRY.attempts):
            try:
                inject.fire("exchange.send")
                break
            except Exception as exc:
                if attempt + 1 >= _SEND_RETRY.attempts:
                    raise PeerLost(
                        f"send to exchange peer {peer} failed: {exc!r}"
                    ) from exc
                time.sleep(_SEND_RETRY.delay_s("exchange.send", attempt + 1))
        try:
            with self._send_locks[peer]:
                # header + chunks as sequential writes under the one lock:
                # never joins the multi-hundred-MB payload into a single
                # buffer (the old dumps+concat peaked at ~3x payload RSS)
                self._send_frame(peer, _HDR.pack(total))
                for part in parts:
                    self._send_frame(peer, part)
                # one wire MESSAGE sent — the unit the receiver counts
                # too (_recv_loop's chunks_in), so in/out stay
                # comparable; under the send lock like the ping-path
                # increments, so concurrent senders cannot lose counts
                self._chunks_out[peer] = self._chunks_out.get(peer, 0) + 1
        except OSError as exc:
            raise PeerLost(f"send to exchange peer {peer} failed: {exc!r}") from exc

    def _serialize(self, edge: str, seq: int, obj: Any) -> List[bytes]:
        """Chunked pickling with INLINE heartbeat ticks.

        ``pickle.dumps`` of a multi-hundred-MB shard is one GIL-holding C
        call: the heartbeat thread cannot run for its whole duration, so a
        HEALTHY rank serializing for longer than the heartbeat timeout went
        silent and got declared PeerLost by its peers (a false positive
        that aborts a healthy cluster).  Streaming the
        pickle through a Python sink bounds each GIL-held stretch to one
        pickler frame (~64 KB) / one large-bytes write, and every chunk
        boundary pings the peers directly from THIS thread — liveness no
        longer depends on the starved heartbeat thread being scheduled.
        Returns the chunk list unjoined; ``_send_to`` streams it."""
        sink = _ChunkSink(self._hb_tick)
        pickle.Pickler(sink, protocol=pickle.HIGHEST_PROTOCOL).dump(
            (edge, seq, obj)
        )
        return sink.parts()

    def _deserialize(self, peer: int, payload: bytes) -> Any:
        """Recv-side mirror of ``_serialize`` (the same false
        positive): one C-level ``pickle.loads`` of a multi-hundred-MB frame
        holds the GIL past the heartbeat timeout, so a healthy RECEIVING
        rank went silent mid-load and got declared PeerLost.  Unpickling
        through a Python source bounds each GIL-held stretch to one read;
        every read both pings the peers inline (from this recv thread) and
        refreshes the sending peer's liveness clock — its frame is still
        being processed, so the peer was alive when the bytes arrived and
        queued pings behind this frame must not read as its silence."""

        def tick() -> None:
            self._last_recv[peer] = time.monotonic()
            self._hb_tick()

        return pickle.Unpickler(_ChunkSource(payload, tick)).load()

    def _hb_tick(self) -> None:
        """Best-effort heartbeat pings issued inline from a busy thread
        (serialization chunk boundaries); rate-limited to half the
        heartbeat interval.  Skips peers whose send lock is held — an
        in-flight send to them already proves our liveness."""
        now = time.monotonic()
        if now - self._last_tick < _hb_interval() / 2:
            return
        self._last_tick = now
        with self._cv:
            if self._closed or self._dead is not None:
                return
        for peer, lock in self._send_locks.items():
            if lock.acquire(blocking=False):
                try:
                    if self._send_frame(peer, self._ping_frame, best_effort=True):
                        self._chunks_out[peer] = (
                            self._chunks_out.get(peer, 0) + 1
                        )
                except PeerLost as exc:
                    # a ping partially written and then stalled against a
                    # silent peer: the byte stream to it is corrupt past
                    # repair — surface it exactly like _heartbeat_loop
                    # does instead of letting the next send desync the
                    # receiver
                    with self._cv:
                        if not self._closed and self._dead is None:
                            self._dead = exc
                        self._cv.notify_all()
                    return
                except OSError:
                    pass  # recv loop surfaces the death with context
                finally:
                    lock.release()

    def _send_frame(self, peer: int, frame: bytes, best_effort: bool = False) -> bool:
        """Chunked send with stall detection (caller holds the send lock).

        A plain ``sendall`` with no timeout would block forever on a hung
        receiver with full TCP buffers — BEFORE this rank ever reaches
        ``_wait``'s heartbeat check.  Send in timed slices instead; a slice
        that makes no progress while the peer has ALSO been silent past the
        heartbeat timeout means the peer is hung, not merely slow (a slow
        but healthy peer keeps heartbeating us the whole time).

        ``best_effort`` (heartbeat pings): give up quietly if the socket
        won't take the first byte — data is queued, which proves our
        liveness to the peer anyway.  The first-byte probe is NON-blocking
        (inline ticks run on the serializing thread; one congested peer
        must not stall it for a socket timeout per tick).  Once a frame is
        partially written it MUST complete or the stream would corrupt."""
        s = self._send[peer]
        hb_timeout = _hb_timeout()
        view = memoryview(frame)
        ping_deadline: Optional[float] = None
        s.settimeout(max(0.5, _hb_interval()))
        try:
            if best_effort:
                s.settimeout(0.0)
                try:
                    sent = s.send(view)
                except (BlockingIOError, InterruptedError):
                    return False  # full buffer: skip this ping
                view = view[sent:]
                s.settimeout(max(0.5, _hb_interval()))
                if view:
                    # a data frame to a slow-but-alive peer may legitimately
                    # take long, but a peer that cannot drain a ping-sized
                    # frame for a whole heartbeat timeout has a wedged
                    # receive side even if ITS pings keep arriving — without
                    # this bound the half-written ping pins the calling
                    # (serializing) thread for as long as the peer stays
                    # congested
                    ping_deadline = time.monotonic() + hb_timeout
            transient = 0
            while view:
                try:
                    sent = s.send(view)
                except socket.timeout:
                    now = time.monotonic()
                    if now - self._last_recv.get(peer, 0.0) > hb_timeout:
                        raise PeerLost(
                            f"send to exchange peer {peer} stalled >{hb_timeout}s "
                            "with no heartbeat from it (hung or partitioned)"
                        )
                    if ping_deadline is not None and now > ping_deadline:
                        raise PeerLost(
                            f"exchange peer {peer} took none of a "
                            f"{len(frame)}-byte heartbeat frame for "
                            f">{hb_timeout}s (receive side wedged); the "
                            "partially written stream is unrecoverable"
                        )
                    continue
                except OSError as exc:
                    # TRANSIENT socket errors (EINTR, EAGAIN, ENOBUFS...)
                    # retry the SAME slice with a short backoff — they
                    # mean the kernel hiccuped, not that the peer died.
                    # The peer-silence bound above still applies: a peer
                    # that has ALSO stopped heartbeating is genuinely
                    # gone and the retry loop must not mask that.
                    if exc.errno not in _TRANSIENT_ERRNOS:
                        raise
                    transient += 1
                    now = time.monotonic()
                    if now - self._last_recv.get(peer, 0.0) > hb_timeout:
                        raise PeerLost(
                            f"send to exchange peer {peer} failing "
                            f"transiently ({exc!r}) with no heartbeat from "
                            f"it for >{hb_timeout}s (hung or partitioned)"
                        ) from exc
                    time.sleep(min(0.001 * (2.0 ** transient), 0.05))
                    continue
                view = view[sent:]
            self._bytes_out[peer] = self._bytes_out.get(peer, 0) + len(frame)
            return True
        finally:
            try:
                s.settimeout(None)
            except OSError:
                pass

    def _heartbeat_loop(self) -> None:
        """Ping every peer each interval so silence means the PEER stalled,
        not that traffic happens to be idle.  A busy data socket is fine:
        any frame (data or ping) refreshes the receiver's liveness clock.
        Skips peers whose send lock is held — a large in-flight send already
        proves this side is alive to them."""
        interval = _hb_interval()
        frame = self._ping_frame
        while True:
            time.sleep(interval)
            with self._cv:
                if self._closed or self._dead is not None:
                    return
            for peer, lock in self._send_locks.items():
                if lock.acquire(blocking=False):
                    try:
                        if self._send_frame(peer, frame, best_effort=True):
                            self._chunks_out[peer] = (
                                self._chunks_out.get(peer, 0) + 1
                            )
                    except PeerLost as exc:
                        # a ping that got partially written and then stalled
                        # against a silent peer: surface it to the engine
                        with self._cv:
                            if not self._closed and self._dead is None:
                                self._dead = exc
                            self._cv.notify_all()
                        return
                    except OSError:
                        pass  # recv loop surfaces the death with context
                    finally:
                        lock.release()

    def _wait(self, edge: str, seq: int, peers: List[int], timeout: float) -> Dict[int, Any]:
        out: Dict[int, Any] = {}
        hb_timeout = _hb_timeout()
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                # drain BEFORE checking for death: a peer that sent its
                # final frame and exited cleanly must not abort a
                # collective whose data already arrived (TCP delivers the
                # frame before the EOF, so the inbox is authoritative)
                for p in peers:
                    if p not in out and (edge, seq, p) in self._inbox:
                        out[p] = self._inbox.pop((edge, seq, p))
                if len(out) == len(peers):
                    return out
                if self._dead is not None:
                    raise self._dead
                closed = [
                    p for p in peers if p not in out and p in self._peer_closed
                ]
                if closed:
                    # clean shutdown is NOT peer death — but a peer that
                    # said goodbye before sending this collective's part
                    # will never send it; fail this wait immediately and
                    # clearly WITHOUT poisoning the whole plane (other
                    # collectives may already hold their data)
                    raise PeerLost(
                        f"exchange {edge!r}#{seq}: peers {closed} closed "
                        "cleanly before sending (shutdown mid-collective)"
                    )
                now = time.monotonic()
                stalled = [
                    p
                    for p in peers
                    if p not in out and now - self._last_recv[p] > hb_timeout
                ]
                if stalled:
                    # hung-not-dead peer (SIGSTOP, partition with open
                    # socket): heartbeats stopped but TCP never reset.
                    # PeerLost (not TimeoutError) so run.py hard-aborts
                    # instead of unwinding into a shutdown that waits on
                    # the lost peer.
                    self._dead = PeerLost(
                        f"exchange {edge!r}#{seq}: peers {stalled} silent for "
                        f">{hb_timeout}s (heartbeat lost; stalled or partitioned)"
                    )
                    self._cv.notify_all()
                    raise self._dead
                if now >= deadline:
                    raise PeerLost(
                        f"exchange {edge!r}#{seq}: timed out waiting for "
                        f"{[p for p in peers if p not in out]}"
                    )
                self._cv.wait(timeout=min(1.0, hb_timeout / 4))

    # -- collectives --------------------------------------------------------
    def all_to_all(
        self, edge: str, seq: int, parts: List[Any], timeout: float = 600.0
    ) -> List[Any]:
        """Send ``parts[j]`` to rank j; return the nproc parts addressed to
        me (my own part included at position ``rank``)."""
        for peer in range(self.nproc):
            if peer != self.rank:
                self._send_to(peer, edge, seq, parts[peer])
        got = self._wait(
            edge, seq, [p for p in range(self.nproc) if p != self.rank], timeout
        )
        got[self.rank] = parts[self.rank]
        return [got[p] for p in range(self.nproc)]

    def gather(
        self, edge: str, seq: int, obj: Any, root: int = 0, timeout: float = 600.0
    ) -> Optional[List[Any]]:
        """Everyone sends to ``root``; root returns all parts, others None."""
        if self.rank != root:
            self._send_to(root, edge, seq, obj)
            return None
        got = self._wait(
            edge, seq, [p for p in range(self.nproc) if p != root], timeout
        )
        got[root] = obj
        return [got[p] for p in range(self.nproc)]

    def broadcast(
        self, edge: str, seq: int, obj: Any = None, root: int = 0, timeout: float = 600.0
    ) -> Any:
        if self.rank == root:
            for peer in range(self.nproc):
                if peer != root:
                    self._send_to(peer, edge, seq, obj)
            return obj
        return self._wait(edge, seq, [root], timeout)[root]

    def observe_metrics(self):
        """Scrape-time ``pathway_exchange_*`` samples (flight-recorder
        provider): per-peer liveness (``peer_up`` mirrors the heartbeat
        verdict: 1 while the peer has been heard from within the
        heartbeat timeout), silence age (seconds since the peer's last
        frame — the liveness clock ``_wait`` checks), and wire traffic
        counters.  The ``plane`` id label uniquifies concurrent planes
        (tests open several per process)."""
        base = {"rank": str(self.rank), "plane": str(self._observe_id)}
        now = time.monotonic()
        down = self._closed or self._dead is not None
        hb_timeout = _hb_timeout()
        for peer in sorted(self._send):
            labels = {**base, "peer": str(peer)}
            last = self._last_recv.get(peer)
            silence = max(0.0, now - last) if last is not None else None
            up = int(
                not down
                and peer not in self._peer_closed
                and silence is not None
                and silence <= hb_timeout
            )
            yield ("gauge", "pathway_exchange_peer_up", labels, up)
            if silence is not None:
                yield (
                    "gauge",
                    "pathway_exchange_heartbeat_silence_seconds",
                    labels,
                    silence,
                )
            for direction, store in (
                ("in", self._bytes_in),
                ("out", self._bytes_out),
            ):
                yield (
                    "counter",
                    "pathway_exchange_bytes_total",
                    {**labels, "direction": direction},
                    store.get(peer, 0),
                )
            for direction, store in (
                ("in", self._chunks_in),
                ("out", self._chunks_out),
            ):
                yield (
                    "counter",
                    "pathway_exchange_chunks_total",
                    {**labels, "direction": direction},
                    store.get(peer, 0),
                )
        yield (
            "gauge",
            "pathway_exchange_heartbeat_timeout_seconds",
            base,
            hb_timeout,
        )

    def close(self) -> None:
        """Clean shutdown: announce ``__bye__`` to every peer (so this
        rank's disconnect reads as goodbye, not ``PeerLost``), then close
        the sockets.  Idempotent; best-effort — a peer that is already
        gone just misses a goodbye it no longer needs."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        bye = pickle.dumps(
            (_BYE_EDGE, 0, None), protocol=pickle.HIGHEST_PROTOCOL
        )
        frame = _HDR.pack(len(bye)) + bye
        for peer, s in self._send.items():
            lock = self._send_locks[peer]
            # a short bounded wait: never let one wedged peer stall the
            # whole shutdown, and never interleave into an in-flight frame
            if not lock.acquire(timeout=1.0):
                continue
            try:
                s.settimeout(1.0)
                s.sendall(frame)
            except OSError:
                pass
            finally:
                lock.release()
        for s in self._send.values():
            try:
                s.close()
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:
            pass


class _ChunkSink:
    """File-like pickle sink collecting frames; calls ``tick`` at every
    chunk boundary so a long serialization keeps servicing heartbeats from
    the serializing thread itself (see ``ExchangePlane._serialize``)."""

    __slots__ = ("_parts", "_tick")

    def __init__(self, tick) -> None:
        self._parts: List[bytes] = []
        self._tick = tick

    def write(self, b) -> int:
        # the C pickler may hand a memoryview into its internal frame
        # buffer (copy before the buffer is reused), or a PickleBuffer over
        # a large array's memory, which has no len(): count the copy
        part = bytes(b)
        self._parts.append(part)
        self._tick()
        return len(part)

    def parts(self) -> List[bytes]:
        return self._parts


class _ChunkSource:
    """File-like pickle source over a received frame; calls ``tick`` at
    every read so a long deserialization keeps servicing heartbeats from
    the receiving thread itself (see ``ExchangePlane._deserialize``)."""

    __slots__ = ("_view", "_pos", "_tick")

    def __init__(self, payload, tick) -> None:
        self._view = memoryview(payload)
        self._pos = 0
        self._tick = tick

    def read(self, n: int = -1) -> bytes:
        self._tick()
        pos = self._pos
        end = (
            len(self._view)
            if n is None or n < 0
            else min(pos + n, len(self._view))
        )
        self._pos = end
        return bytes(self._view[pos:end])

    def readline(self) -> bytes:
        # HIGHEST_PROTOCOL frames never hold newline-terminated opcodes,
        # but the Unpickler requires the method to exist
        self._tick()
        pos = self._pos
        nl = bytes(self._view[pos:]).find(b"\n")
        end = len(self._view) if nl < 0 else pos + nl + 1
        self._pos = end
        return bytes(self._view[pos:end])


def _advertise_host() -> str:
    """The address peers should dial for this rank's exchange listener.
    PATHWAY_EXCHANGE_HOST overrides; otherwise use the local interface that
    routes toward the cluster coordinator (loopback for single-host
    clusters, the reachable NIC for multi-host ones)."""
    override = config.get("parallel.exchange_host")
    if override:
        return override
    coord = config.get("parallel.coordinator_address")
    host = coord.rsplit(":", 1)[0] if ":" in coord else coord
    if host in ("", "localhost", "127.0.0.1", "0.0.0.0"):
        return "127.0.0.1"
    try:
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            probe.connect((host, 9))  # no packets sent; just picks the route
            return probe.getsockname()[0]
        finally:
            probe.close()
    except OSError:
        return socket.gethostbyname(socket.gethostname())


def _recv_exact(conn: socket.socket, n: int, on_chunk=None) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("exchange connection closed")
        buf += chunk
        if on_chunk is not None:
            on_chunk()
    return bytes(buf)


_plane: Optional[ExchangePlane] = None
_plane_lock = threading.Lock()
_plane_gen = 0


def get_plane() -> Optional[ExchangePlane]:
    """The process-wide exchange plane (created on first use when running
    distributed; None in single-process mode).  Its rendezvous keys live
    in the control plane's store (``distributed.kv_set`` / ``kv_get``)."""
    global _plane, _plane_gen
    from . import distributed

    if not distributed.is_distributed():
        return None
    with _plane_lock:
        if _plane is None:
            gen = _plane_gen
            _plane_gen += 1
            _plane = ExchangePlane(
                distributed.process_id(),
                distributed.process_count(),
                kv_set=distributed.kv_set,
                kv_get=lambda k: distributed.kv_get(k, 60_000),
                namespace=str(gen),
            )
        return _plane


def close_plane() -> None:
    global _plane
    with _plane_lock:
        if _plane is not None:
            _plane.close()
            _plane = None


_user_seq = 0


def gather_table_rows(table):
    """Union of every rank's local rows for ``table`` — the cross-rank
    materialize (each rank holds only its shard of a distributed table's
    rows; reference users see the union through per-worker output
    connectors).  SPMD: every rank must call this in the same order.
    Single-process: identical to ``table._materialize()``."""
    global _user_seq
    keys, columns = table._materialize()
    plane = get_plane()
    if plane is None:
        return keys, columns
    seq = _user_seq
    _user_seq += 1
    got = plane.all_to_all(
        "gather_table", seq, [(keys, columns)] * plane.nproc
    )
    import numpy as np

    all_keys = np.concatenate([k for k, _c in got])
    names = list(columns.keys())
    merged = {}
    for n in names:
        cols = [c[n] for _k, c in got]
        if any(getattr(c, "dtype", None) == object for c in cols):
            cols = [np.asarray(c, dtype=object) for c in cols]
        merged[n] = np.concatenate(cols) if cols else columns[n]
    return all_keys, merged
