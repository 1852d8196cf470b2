"""Multi-host serve fabric (counterpart of ``pathway_tpu/serve/fabric.py``):
replica groups with failover and hedging, and partitioned scatter-gather
with owner-routed absorb.

``ServeScheduler`` coalesces requests inside one process; this module is
the tier above it.  Each host runs a ``FabricWorker``, a TCP endpoint in
front of its own scheduler; a ``ServeFabric`` front routes admission
across the hosts with the failure semantics of the degradation ladder
(``robust/degrade.py``):

- **Routing.**  Least-loaded across healthy hosts, with consistent-hash
  affinity by the ``cache/keys.py`` query key: the same query text (at
  the fleet's index generation) lands on the same host while that host
  is healthy and carries at most ``fabric.affinity_slack`` in-flight
  requests over the fleet minimum, so per-host caches stay hot.
- **Wire.**  Frames over ``parallel/exchange.FramedStream``: length-
  prefixed pickles behind a 32-byte session secret checked before any
  unpickle, one muxed connection per host carrying requests, replies (by
  ``req_id``), heartbeats and the ``bye`` drain frame.  A worker replies
  with plain host values only, ``(int key, float score)`` rows and a
  meta of Python scalars and containers: no tensor and no view into a
  buffer the next batch reuses ever crosses.  The frames are the
  reference's, so either package's front drives either package's
  workers.
- **Failure.**  Per-host circuit breakers (``robust.breaker``, one
  failure trips, reset = one heartbeat timeout): heartbeat silence past
  ``fabric.heartbeat_timeout_s``, a ``bye`` or a broken stream marks the
  host down, fails its in-flight tickets, and the waiting serves re-route
  to a survivor, flagged ``host_failover``.  A dead host never raises out
  of a serve call; only an exhausted fleet degrades to an empty
  ``replica_lost`` result.  ``fabric.hedge_ms`` > 0 mirrors a slow
  request to a second host; the first reply wins (``meta["hedged"]``).
  Two races of the reference's are closed here: a reconnect restarts the
  liveness clock before it publishes the stream (else the heartbeat can
  down it for the silence of the stream it replaced), and a request
  whose admission-time candidates run dry routes once more over the
  hosts usable now (a host that re-joined meanwhile), so a rolling
  restart never answers ``replica_lost`` while a host is healthy.  And a
  front that was itself stalled (a tick late by half a timeout) restarts
  every silence clock rather than downing hosts it could not hear.
- **Fault sites** (``robust/inject.py``): ``fabric.route`` (affinity
  falls back to least-loaded, flagged), ``fabric.send`` /
  ``fabric.recv`` (failover, breaker fed).
- **Partitioned mode** (``fabric.partitions`` > 0 or ``partitions=``):
  host ``i`` owns ``doc_key % H == i`` (``parallel/shards.py``
  ``FleetPartitionMap``).  A serve scatters the batch to every partition
  (booked 1 logical + H physical dispatches, ``fabric.scatter``), each
  host answers its sorted top-K over owned documents only, and the front
  gathers and merges through ``ops/topk.tree_merge_topk_host``,
  re-emitting the owners' exact ``(doc, score)`` pairs, so H hosts serve
  bit-identically to one on the clean path.  A dead or slow partition
  degrades to ``partition_lost``: the survivors' merge is served.
  ``absorb()`` / ``connector()`` route committed documents to their
  owner's ``LiveIngestRunner`` only, the arrival stamp of the connector
  commit riding the wire; ``index_generation()`` is the per-partition
  generation vector, so a front scheduler's dedup and result-cache keys
  change when any partition absorbs.  Sites ``fabric.scatter`` (that
  partition is lost), ``fabric.gather`` (stop waiting, serve the
  resolved partitions) and ``partition.absorb`` (that routed batch is
  dropped and counted; it is re-committable).

A replacement worker restores the writer's warm state
(``serve/warmstate.py``) before it joins, per partition in partitioned
mode.
"""

# pathway: serve-path  (hidden-sync lint applies: no implicit host round trips)
from __future__ import annotations

import hashlib
import itertools
import secrets
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config, observe
from ..cache.keys import query_key
from ..ops.dispatch_counter import record_dispatch, record_fetch
from ..ops.topk import tree_merge_topk_host
from ..parallel.exchange import _TOKEN_LEN, FramedStream, PeerLost
from ..parallel.shards import FleetPartitionMap
from ..robust import breaker as robust_breaker
from ..robust import inject, log_once
from ..robust.deadline import Deadline
from ..robust.degrade import HOST_FAILOVER, PARTITION_LOST, REPLICA_LOST, ServeResult, record_degraded

__all__ = ["FabricWorker", "ServeFabric", "fabric_token"]


def fabric_token() -> bytes:
    """One fabric session secret (shared across the group out of band)."""
    return secrets.token_bytes(_TOKEN_LEN)


def _generation_of(target) -> int:
    """Index generation of a serve target: its ``index_generation``
    hook, or that of the target it wraps (``.target``), else 0."""
    seen = set()
    while target is not None and id(target) not in seen:
        seen.add(id(target))
        gen_fn = getattr(target, "index_generation", None)
        if callable(gen_fn):
            try:
                return int(gen_fn())
            except Exception:  # noqa: BLE001 - a generation probe never fails a pong
                return 0
        target = getattr(target, "target", None)
    return 0


def _plain(value: Any) -> Any:
    """``value`` as plain host data for the wire: tensors and numpy
    values become Python scalars and lists, containers are rebuilt."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().tolist()
    if isinstance(value, (np.ndarray, np.generic)):
        return value.tolist()
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    return value


def _wire_rows(result) -> List[List[Tuple[int, float]]]:
    return [[(int(key), float(score)) for key, score in row] for row in result]


class FabricWorker:
    """One host's serve endpoint: a TCP listener in front of a local
    scheduler (``ServeScheduler``, or anything with ``serve(texts, k=,
    deadline=, priority=) -> ServeResult``).

    Per connection one reader thread answers ``ping`` inline (the pong
    carries the index generation and the in-flight count) and hands each
    ``serve`` or ``absorb`` frame to a handler thread of its own, so the
    local scheduler's window coalesces concurrent riders as it does in
    process, within the 2 + 2 per-batch budget.  ``ingest`` (a
    ``LiveIngestRunner``, or anything with ``ingest_routed(docs,
    connector=)``) takes the partitioned fleet's owner-routed ``absorb``
    frames.  ``stop()`` drains: a ``bye`` on every live connection tells
    the fronts to re-route; ``kill()`` dies abruptly."""

    def __init__(self, scheduler, host: str = "127.0.0.1", port: int = 0, token: Optional[bytes] = None,
                 name: Optional[str] = None, ingest=None):
        self.scheduler = scheduler
        self.ingest = ingest
        self.token = token if token is not None else fabric_token()
        if len(self.token) != _TOKEN_LEN:
            raise ValueError(f"fabric token must be {_TOKEN_LEN} bytes")
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(16)
        self.host, self.port = self._listener.getsockname()[:2]
        self.name = name or f"{self.host}:{self.port}"
        self._lock = threading.Lock()
        self._streams: List[FramedStream] = []
        self._stopping = False
        self._inflight = 0
        self.stats: Dict[str, int] = {"requests": 0, "pings": 0, "errors": 0, "absorbs": 0}
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True, name=f"fabric-acc-{self.name}")
        self._accept_thread.start()

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            if self._stopping:
                try:
                    conn.close()
                except OSError:
                    pass
                return
            try:
                stream = FramedStream.accept(conn, self.token)
            except Exception:  # noqa: BLE001 - junk or a wrong token: dropped before any unpickle
                continue
            with self._lock:
                # a kill() during the handshake did not see this stream:
                # a dead worker must not keep it open and answer pings
                stopping = self._stopping
                if not stopping:
                    self._streams.append(stream)
            if stopping:
                stream.close()
                return
            threading.Thread(target=self._reader, args=(stream,), daemon=True, name=f"fabric-rd-{self.name}").start()

    def _reader(self, stream: FramedStream) -> None:
        try:
            while True:
                msg = stream.recv()
                op = msg.get("op")
                if op == "ping":
                    self.stats["pings"] += 1
                    stream.send({"op": "pong", "generation": _generation_of(self.scheduler), "inflight": self._inflight})
                elif op == "serve":
                    threading.Thread(target=self._handle, args=(stream, msg), daemon=True,
                                     name=f"fabric-req-{self.name}").start()
                elif op == "absorb":
                    threading.Thread(target=self._handle_absorb, args=(stream, msg), daemon=True,
                                     name=f"fabric-abs-{self.name}").start()
                elif op == "bye":
                    return  # the front drained; the close below is clean
        except Exception:  # noqa: BLE001 - a disconnect ends the reader quietly
            pass
        finally:
            with self._lock:
                if stream in self._streams:
                    self._streams.remove(stream)
            stream.close()

    def _handle(self, stream: FramedStream, msg: Dict[str, Any]) -> None:
        req_id = msg.get("req_id")
        deadline = Deadline.after_ms(float(msg["deadline_ms"])) if msg.get("deadline_ms") is not None else None
        with self._lock:
            self._inflight += 1
            self.stats["requests"] += 1
        try:
            kwargs: Dict[str, Any] = {"deadline": deadline}
            if msg.get("priority") is not None:
                kwargs["priority"] = msg["priority"]
            result = self.scheduler.serve(msg["texts"], k=msg.get("k"), **kwargs)
            reply = {
                "op": "result",
                "req_id": req_id,
                "rows": _wire_rows(result),
                "degraded": [str(f) for f in getattr(result, "degraded", ())],
                "meta": _plain(dict(getattr(result, "meta", {}))),
            }
        except Exception as exc:  # noqa: BLE001 - the scheduler degrades; a raise costs this request a failover upstream
            self.stats["errors"] += 1
            reply = {"op": "error", "req_id": req_id, "error": repr(exc)}
        finally:
            with self._lock:
                self._inflight = max(0, self._inflight - 1)
        try:
            stream.send(reply)
        except PeerLost:
            pass  # the front is gone; its failover covered this request

    def _handle_absorb(self, stream: FramedStream, msg: Dict[str, Any]) -> None:
        """Owner-routed absorb frame: the routed documents, with arrival
        stamps taken at the fleet connector's commit, go to this host's
        ingest runner.  A raise becomes an ``error`` reply (the front
        counts the batch dropped), never silence."""
        req_id = msg.get("req_id")
        try:
            if self.ingest is None:
                raise RuntimeError(f"fabric worker {self.name} has no ingest runner")
            docs = [(int(k), str(t), int(ns)) for k, t, ns in msg.get("docs", ())]
            accepted = self.ingest.ingest_routed(docs, connector=str(msg.get("connector", "fleet")))
            with self._lock:
                self.stats["absorbs"] += 1
            reply: Dict[str, Any] = {"op": "absorb_ack", "req_id": req_id, "accepted": int(accepted)}
        except Exception as exc:  # noqa: BLE001 - answered as an error frame
            with self._lock:
                self.stats["errors"] += 1
            reply = {"op": "error", "req_id": req_id, "error": repr(exc)}
        try:
            stream.send(reply)
        except PeerLost:
            pass  # the front is gone; its absorb timeout counted the drop

    def _close_listener(self) -> None:
        # close() alone frees the fd number, but the accept thread blocked
        # in accept(2) pins the kernel socket: it keeps listening, and a
        # "dead" worker would accept reconnects.  shutdown() tears the
        # socket down under the blocked accept, so the port really closes.
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass

    def kill(self) -> None:
        """Unplanned death: the listener and every stream die abruptly,
        with no ``bye``; in-flight requests are torn mid-reply.  The
        scheduler is the caller's to stop."""
        with self._lock:
            self._stopping = True
            streams = list(self._streams)
        self._close_listener()
        for stream in streams:
            stream.close()

    def stop(self) -> None:
        """Planned drain: ``bye`` every front (their in-flight tickets
        re-route, new admissions go elsewhere), then close.  Idempotent."""
        with self._lock:
            if self._stopping:
                return
            self._stopping = True
            streams = list(self._streams)
        for stream in streams:
            try:
                stream.send({"op": "bye"})
            except PeerLost:
                pass
        self._close_listener()
        for stream in streams:
            stream.close()


class _Pending:
    """One in-flight request on one host link."""

    __slots__ = ("event", "reply")

    def __init__(self):
        self.event = threading.Event()
        self.reply: Optional[Dict[str, Any]] = None

    def resolve(self, reply: Dict[str, Any]) -> None:
        self.reply = reply
        self.event.set()


class _HostLink:
    """The front's side of one host: a muxed ``FramedStream`` with one
    receiver thread dispatching replies by ``req_id``, a circuit breaker,
    and the liveness clock the heartbeat drives."""

    def __init__(self, name: str, host: str, port: int, token: bytes):
        self.name = name
        self.host = host
        self.port = int(port)
        self.token = token
        # one failure trips a host (a host that broke a stream, went
        # silent or said bye is not worth a retry budget: the survivors
        # hold its load), and the cool-down is one heartbeat timeout, so a
        # bounced worker is probed again as soon as it could be back
        self.breaker = robust_breaker(
            f"fabric:{name}", failure_threshold=1, reset_s=config.get("fabric.heartbeat_timeout_s")
        )
        self._stream: Optional[FramedStream] = None
        self._conn_lock = threading.Lock()
        self._plock = threading.Lock()
        self._pending: Dict[int, _Pending] = {}
        self.inflight = 0
        self.last_pong: Optional[float] = None
        self.generation = 0
        self.down_reason: Optional[str] = None

    def ensure(self) -> Optional[FramedStream]:
        """The live stream, connecting if needed; None when the host is
        unreachable (the caller feeds the breaker)."""
        with self._conn_lock:
            if self._stream is not None:
                return self._stream
            try:
                stream = FramedStream.connect(
                    self.host, self.port, self.token, timeout=config.get("fabric.connect_timeout_s")
                )
            except Exception as exc:  # noqa: BLE001 - unreachable is an answer, not an error
                self.down_reason = f"connect: {exc!r}"
                return None
            # the liveness clock starts before the stream is published: the
            # heartbeat reads the stream, then the clock, and a reconnect
            # lands about one heartbeat timeout after the last pong (the
            # breaker's reset), so a stale clock would down it at once
            self.last_pong = time.monotonic()
            self.down_reason = None
            self._stream = stream
            threading.Thread(target=self._receiver, args=(stream,), daemon=True,
                             name=f"fabric-recv-{self.name}").start()
            return stream

    def _receiver(self, stream: FramedStream) -> None:
        try:
            while True:
                msg = stream.recv()
                op = msg.get("op")
                if op == "pong":
                    self.last_pong = time.monotonic()
                    self.generation = int(msg.get("generation", 0))
                elif op in ("result", "error", "absorb_ack"):
                    self.last_pong = time.monotonic()
                    with self._plock:
                        pending = self._pending.pop(msg.get("req_id"), None)
                        if pending is not None:
                            self.inflight = max(0, self.inflight - 1)
                    if pending is not None:
                        pending.resolve(msg)
                elif op == "bye":
                    self.mark_down("bye")
                    return
        except Exception:  # noqa: BLE001 - a disconnect means down
            self.mark_down("disconnect")
        finally:
            with self._conn_lock:
                if self._stream is stream:
                    self._stream = None
            stream.close()

    def mark_down(self, reason: str) -> None:
        """The host is gone (bye, disconnect, heartbeat silence): feed the
        breaker, drop the stream and fail every in-flight ticket, whose
        waiting serves then re-route."""
        with self._conn_lock:
            stream, self._stream = self._stream, None
        if stream is None and self.down_reason is not None:
            # already down: the first reason stands, and the breaker is
            # not fed twice (a stale echo must not reopen a half-open probe)
            return
        self.down_reason = reason
        self.breaker.record_failure()
        if stream is not None:
            stream.close()
        with self._plock:
            pending, self._pending = self._pending, {}
            self.inflight = 0
        for p in pending.values():
            p.resolve({"op": "error", "error": f"host {self.name} {reason}"})

    def up(self) -> bool:
        return self._stream is not None

    def usable(self) -> bool:
        """Routable: the breaker is not open.  Reads ``state``, not
        ``allow()``: listing candidates must not take the one half-open
        probe slot; the launch gates the attempt with ``allow()``."""
        return self.breaker.state != "open"

    def send_request(self, req_id: int, msg: Dict[str, Any], deadline=None) -> _Pending:
        """Register and send one request frame; raises on any failure
        (site ``fabric.send``, a dead stream), and the caller fails over."""
        stream = self.ensure()
        if stream is None:
            raise PeerLost(f"host {self.name} unreachable")
        pending = _Pending()
        with self._plock:
            self._pending[req_id] = pending
            self.inflight += 1
        try:
            inject.fire("fabric.send", deadline=deadline)
            stream.send(msg)
        except BaseException:
            self.cancel(req_id)
            raise
        return pending

    def cancel(self, req_id: int) -> None:
        """Forget a request the caller stopped waiting for (a straggler,
        an absorb timeout): a late reply to it is dropped."""
        with self._plock:
            if self._pending.pop(req_id, None) is not None:
                self.inflight = max(0, self.inflight - 1)

    def heartbeat(self, timeout_s: float, now: float, listening_since: float) -> None:
        """One tick at ``now``: ping if connected; silence past
        ``timeout_s`` marks the host down.  Silence counts from the last
        pong, or from ``listening_since`` (when the front last resumed
        after a stall of its own) if that is later."""
        stream = self._stream
        if stream is None:
            return
        last = self.last_pong
        if last is not None and now - max(last, listening_since) > timeout_s:
            self.mark_down("heartbeat_silence")
            return
        try:
            stream.send({"op": "ping"})
        except PeerLost:
            self.mark_down("disconnect")

    def close(self) -> None:
        with self._conn_lock:
            stream, self._stream = self._stream, None
        if stream is not None:
            try:
                stream.send({"op": "bye"})
            except PeerLost:
                pass
            stream.close()


class ServeFabric:
    """The front: admission routing across a replica group, or
    scatter-gather across partitions.

    ``hosts`` maps a host name to its ``(host, port)`` (or ``"host:port"``);
    every worker shares ``token``.  The serve surface mirrors
    ``ServeScheduler`` (``submit() -> ticket``, ``serve()`` / ``__call__``),
    and a reply is always a ``ServeResult``, possibly flagged
    ``host_failover``, ``replica_lost`` or ``partition_lost``, never an
    exception.  ``partitions`` (default: the ``fabric.partitions`` knob;
    0 = replica mode) makes host ``i`` (insertion order) the owner of
    ``doc_key % H == i``."""

    def __init__(self, hosts: Dict[str, Any], token: bytes, name: Optional[str] = None,
                 partitions: Optional[int] = None):
        if not hosts:
            raise ValueError("ServeFabric needs at least one host")
        self.name = name or "fabric"
        self._links: List[_HostLink] = []
        for host_name, addr in hosts.items():
            h, p = addr.rsplit(":", 1) if isinstance(addr, str) else addr
            self._links.append(_HostLink(str(host_name), h, int(p), token))
        n_parts = int(partitions) if partitions is not None else config.get("fabric.partitions")
        self.partition_map: Optional[FleetPartitionMap] = None
        if n_parts:
            if n_parts != len(self._links):
                raise ValueError(
                    f"fabric.partitions={n_parts} but {len(self._links)} hosts: in partitioned mode every host "
                    "is one partition (partition i = i-th host)"
                )
            self.partition_map = FleetPartitionMap(n_parts)
        self._req_ids = itertools.count(1)
        self.stats: Dict[str, int] = {"requests": 0, "ok": 0, "failover": 0, "hedged": 0, "lost": 0,
                                      "partition_lost": 0, "stalled_ticks": 0}
        # per-partition accounting: lost serves and absorb outcomes
        n_hosts = len(self._links)
        self._part_lost: List[int] = [0] * n_hosts
        self._absorb_docs: List[int] = [0] * n_hosts
        self._absorb_dropped: List[int] = [0] * n_hosts
        self._stats_lock = threading.Lock()
        self._observe_id = observe.next_id()
        observe.register_provider(self)
        self._closed = False
        self._last_tick = self._listening_since = time.monotonic()
        self._hb_thread = threading.Thread(target=self._heartbeat_loop, daemon=True, name=f"{self.name}-hb")
        self._hb_thread.start()

    # -- liveness -------------------------------------------------------------
    def _heartbeat_loop(self) -> None:
        while not self._closed:
            time.sleep(config.get("fabric.heartbeat_s"))
            if self._closed:
                return
            self._tick(time.monotonic())

    def _tick(self, now: float) -> None:
        """One heartbeat tick.  A tick later than half a timeout past its
        interval means this front itself stalled (a collector pass over a
        large heap, a starved interpreter): pongs of that window may sit
        unread, and the hosts of one process stalled with it, so every
        silence clock restarts now instead of downing the whole fleet."""
        timeout_s = config.get("fabric.heartbeat_timeout_s")
        if now - self._last_tick > config.get("fabric.heartbeat_s") + timeout_s / 2:
            self._listening_since = now
            with self._stats_lock:
                self.stats["stalled_ticks"] += 1
        self._last_tick = now
        for link in self._links:
            link.heartbeat(timeout_s, now, self._listening_since)

    def connect(self) -> int:
        """Dial every host now (routing also connects lazily); returns
        how many are reachable."""
        return sum(1 for link in self._links if link.ensure() is not None)

    @property
    def generation(self) -> int:
        """The fleet's index generation by the last pongs (the affinity
        generation)."""
        return max((link.generation for link in self._links), default=0)

    @property
    def partitioned(self) -> bool:
        return self.partition_map is not None

    def index_generation(self):
        """What a front scheduler keys dedup and cache on: in partitioned
        mode the generation vector, one entry per partition, so an absorb
        on any partition changes the key; else the replica scalar."""
        if self.partition_map is not None:
            return tuple(link.generation for link in self._links)
        return self.generation

    def poll_generations(self, timeout_s: float = 1.0):
        """Ping every host, wait for fresh pongs, then return
        ``index_generation()`` (observes an absorb's bump without waiting
        for a heartbeat tick)."""
        marks = []
        for link in self._links:
            marks.append(link.last_pong)
            stream = link.ensure()
            if stream is None:
                continue
            try:
                stream.send({"op": "ping"})
            except PeerLost:
                link.mark_down("disconnect")
        t_end = time.monotonic() + timeout_s
        while time.monotonic() < t_end:
            if all(not link.up() or link.last_pong != mark for link, mark in zip(self._links, marks)):
                break
            time.sleep(0.002)
        return self.index_generation()

    # -- routing --------------------------------------------------------------
    def _affinity(self, text: str) -> int:
        key_text, gen = query_key(text, self.generation)
        digest = hashlib.blake2b(f"{gen}\x00{key_text}".encode(), digest_size=8).digest()
        return int.from_bytes(digest, "big") % len(self._links)

    def _route(self, texts: Sequence[str], deadline=None) -> Tuple[List[int], bool]:
        """Candidate host indices in preference order, and whether routing
        itself degraded (site ``fabric.route``: affinity is an
        optimisation, so a fault falls back to least-loaded, flagged)."""
        degraded = False
        aff: Optional[int] = None
        try:
            inject.fire("fabric.route", deadline=deadline)
            if texts:
                aff = self._affinity(str(texts[0]))
        except Exception as exc:  # noqa: BLE001 - routing degrades, never raises
            degraded = True
            log_once(f"fabric.route:{type(exc).__name__}", "fabric routing degraded (%r); using least-loaded host",
                     exc)
        usable = [i for i, link in enumerate(self._links) if link.usable()]
        order: List[int] = []
        if aff is not None and aff in usable:
            min_inflight = min(self._links[i].inflight for i in usable)
            if self._links[aff].inflight <= min_inflight + config.get("fabric.affinity_slack"):
                order.append(aff)
        order.extend(sorted((i for i in usable if i not in order), key=lambda i: (self._links[i].inflight, i)))
        return order, degraded

    # -- serve surface ----------------------------------------------------------
    def submit(self, texts: Sequence[str], k: Optional[int] = None, deadline: Optional[Deadline] = None,
               priority: Optional[str] = None):
        """Admit one request; the ticket (a zero-arg callable, with
        ``result(timeout)`` for API parity) resolves to the ``ServeResult``.
        Routing, send, hedge and failover all run on the waiter's thread."""
        texts = list(texts)
        box: List[Any] = [None]

        def run() -> ServeResult:
            if box[0] is None:
                box[0] = self._serve_once(texts, k, deadline, priority)
            return box[0]

        class _FabricTicket:
            __slots__ = ()

            def __call__(self) -> ServeResult:
                return run()

            def result(self, timeout: Optional[float] = None) -> ServeResult:
                return run()

        return _FabricTicket()

    def serve(self, texts: Sequence[str], k: Optional[int] = None, deadline: Optional[Deadline] = None,
              priority: Optional[str] = None) -> ServeResult:
        return self._serve_once(list(texts), k, deadline, priority)

    __call__ = serve

    @staticmethod
    def _serve_msg(texts, k, deadline, priority) -> Dict[str, Any]:
        return {
            "op": "serve",
            "texts": texts,
            "k": k,
            "priority": priority,
            "deadline_ms": max(0.0, deadline.remaining_s() * 1e3) if deadline is not None else None,
        }

    def _serve_once(self, texts: List[str], k: Optional[int], deadline: Optional[Deadline],
                    priority: Optional[str]) -> ServeResult:
        if self.partition_map is not None:
            return self._serve_scatter(texts, k, deadline, priority)
        with self._stats_lock:
            self.stats["requests"] += 1
        order, route_degraded = self._route(texts, deadline=deadline)
        failover = route_degraded
        hedged = False
        hedge_s = config.get("fabric.hedge_ms") * 1e-3
        base_msg = self._serve_msg(texts, k, deadline, priority)
        attempts: List[Tuple[_HostLink, _Pending]] = []
        refilled = False

        def launch(idx: int) -> bool:
            link = self._links[idx]
            if not link.breaker.allow():
                return False  # opened since routing, or the probe slot is taken
            req_id = next(self._req_ids)
            try:
                pending = link.send_request(req_id, {**base_msg, "req_id": req_id}, deadline=deadline)
            except BaseException as exc:  # noqa: BLE001 - failover, never raise
                link.breaker.record_failure()
                log_once(f"fabric.send:{link.name}:{type(exc).__name__}",
                         "fabric send to host %s failed (%r); failing over", link.name, exc)
                return False
            attempts.append((link, pending))
            return True

        def refill() -> bool:
            # the admission-time candidates ran dry: route once more over
            # the hosts usable now and not already holding this request.  A
            # request routed while a host was down is pinned to the
            # survivors; when the last of them drains just after that host
            # re-joined (a rolling restart), the fleet is not exhausted and
            # must not answer replica_lost.  A host that failed this
            # request has its breaker open and is not usable.
            nonlocal refilled
            if refilled:
                return False
            refilled = True
            busy = {id(link) for link, _p in attempts}
            queue.extend(sorted(
                (i for i, link in enumerate(self._links) if link.usable() and id(link) not in busy),
                key=lambda i: (self._links[i].inflight, i),
            ))
            return bool(queue)

        def launch_next() -> bool:
            while queue or refill():
                if launch(queue.pop(0)):
                    return True
            return False

        queue = list(order)
        while queue and not attempts:
            if not launch(queue.pop(0)):
                failover = True
        if not attempts:
            return self._lost(texts, route_degraded)

        # wait for the first reply, hedging to the next host when the
        # primary is slow; a failed attempt re-routes to the next candidate
        t_end = time.monotonic() + config.get("fabric.request_timeout_s")
        if deadline is not None:
            t_end = min(t_end, time.monotonic() + max(0.0, deadline.remaining_s()))
        hedge_at = time.monotonic() + hedge_s if hedge_s > 0 and queue else None
        try:
            inject.fire("fabric.recv", deadline=deadline)
        except BaseException as exc:  # noqa: BLE001 - a recv fault is a failover
            failover = True
            for link, _p in attempts:
                link.breaker.record_failure()
            log_once(f"fabric.recv:{type(exc).__name__}", "fabric recv degraded (%r); failing over", exc)
            attempts.clear()
            if not launch_next():
                return self._lost(texts, True)
        while True:
            now = time.monotonic()
            for link, pending in list(attempts):
                if not pending.event.is_set():
                    continue
                reply = pending.reply or {}
                if reply.get("op") == "result":
                    link.breaker.record_success()
                    return self._finish(reply, link, failover, hedged, route_degraded)
                # an error reply (host down, worker bug): drop the attempt
                # and re-route
                attempts.remove((link, pending))
                failover = True
                if reply.get("req_id") is not None:
                    # the WORKER answered with an error (its scheduler
                    # raised): the host is sick though its socket is not,
                    # so its breaker opens.  mark_down()'s errors carry no
                    # req_id and fed the breaker already.
                    link.breaker.record_failure()
                log_once(f"fabric.error:{link.name}", "fabric host %s failed a request (%s); failing over",
                         link.name, reply.get("error", "?"))
            if not attempts:
                if not launch_next():
                    return self._lost(texts, route_degraded)
                continue
            if hedge_at is not None and now >= hedge_at:
                hedge_at = None
                if launch_next():
                    hedged = True
                    with self._stats_lock:
                        self.stats["hedged"] += 1
            if now >= t_end:
                # the fleet is slow past the budget: feed every slow host's
                # breaker and degrade
                for link, _p in attempts:
                    link.breaker.record_failure()
                return self._lost(texts, route_degraded, timeout=True)
            wait_s = min(0.01, max(0.0, t_end - now))
            if hedge_at is not None:
                wait_s = min(wait_s, max(0.0, hedge_at - now))
            attempts[0][1].event.wait(wait_s)

    def _finish(self, reply: Dict[str, Any], link: _HostLink, failover: bool, hedged: bool,
                route_degraded: bool) -> ServeResult:
        result = ServeResult(reply.get("rows", []), degraded=reply.get("degraded", ()), meta=reply.get("meta", {}))
        extra_meta: Dict[str, Any] = {"fabric_host": link.name}
        extra_flags: Tuple[str, ...] = ()
        if failover:
            extra_flags = (HOST_FAILOVER,)
            record_degraded(HOST_FAILOVER)
            with self._stats_lock:
                self.stats["failover"] += 1
        else:
            with self._stats_lock:
                self.stats["ok"] += 1
        if hedged:
            extra_meta["hedged"] = True
        if route_degraded:
            extra_meta["route_degraded"] = True
        return result.with_flags(extra_flags, extra_meta)

    def _lost(self, texts: List[str], route_degraded: bool, timeout: bool = False) -> ServeResult:
        """No healthy host: the fleet is the outage, so an empty flagged
        result (counted), never an exception."""
        record_degraded(REPLICA_LOST)
        with self._stats_lock:
            self.stats["lost"] += 1
        meta: Dict[str, Any] = {"fabric": "fleet_timeout" if timeout else "no_healthy_host"}
        if route_degraded:
            meta["route_degraded"] = True
        return ServeResult([[] for _ in texts], degraded=(REPLICA_LOST,), meta=meta)

    # -- partitioned scatter-gather ---------------------------------------------
    def _serve_scatter(self, texts: List[str], k: Optional[int], deadline: Optional[Deadline],
                       priority: Optional[str]) -> ServeResult:
        """Fan the batch to every partition (one logical dispatch of H
        physical sends), gather each partition's sorted top-K over its
        owned documents, merge on the front.  A partition that cannot be
        reached, answers an error or straggles past the hedge or gather
        budget is lost: the survivors' merge is served, flagged
        ``partition_lost``."""
        with self._stats_lock:
            self.stats["requests"] += 1
        n_parts = len(self._links)
        base_msg = self._serve_msg(texts, k, deadline, priority)
        # the booking rule of the sharded index: 1 logical + H physical
        record_dispatch("fabric.scatter", shards=n_parts)
        pending_by_part: Dict[int, Tuple[int, _Pending]] = {}
        lost: Dict[int, str] = {}
        for part, link in enumerate(self._links):
            if not link.breaker.allow():
                lost[part] = "breaker_open"
                continue
            req_id = next(self._req_ids)
            try:
                inject.fire("fabric.scatter", deadline=deadline)
                pending_by_part[part] = (
                    req_id, link.send_request(req_id, {**base_msg, "req_id": req_id}, deadline=deadline)
                )
            except BaseException as exc:  # noqa: BLE001 - lost, never raise
                link.breaker.record_failure()
                log_once(f"fabric.scatter:{link.name}:{type(exc).__name__}",
                         "fabric scatter to partition %s failed (%r); serving without it", link.name, exc)
                lost[part] = "send"
        replies: Dict[int, Dict[str, Any]] = {}
        gather_fault = False
        try:
            inject.fire("fabric.gather", deadline=deadline)
        except BaseException as exc:  # noqa: BLE001 - stop waiting, serve
            gather_fault = True
            log_once(f"fabric.gather:{type(exc).__name__}",
                     "fabric gather degraded (%r); serving resolved partitions", exc)
        if not gather_fault and pending_by_part:
            hedge_s = config.get("fabric.hedge_ms") * 1e-3
            timeout_s = min(config.get("fabric.request_timeout_s"), config.get("partition.gather_timeout_s"))
            t_end = time.monotonic() + timeout_s
            if deadline is not None:
                t_end = min(t_end, time.monotonic() + max(0.0, deadline.remaining_s()))
            first_t: Optional[float] = None
            while pending_by_part:
                for part, (req_id, pending) in list(pending_by_part.items()):
                    if not pending.event.is_set():
                        continue
                    replies[part] = pending.reply or {}
                    del pending_by_part[part]
                    if first_t is None:
                        first_t = time.monotonic()
                if not pending_by_part:
                    break
                now = time.monotonic()
                if now >= t_end:
                    # the hard straggler bound: a host slow past the fleet's
                    # patience is sick, so its breaker is fed and the next
                    # serve skips it at once
                    for part, (req_id, _p) in pending_by_part.items():
                        self._links[part].breaker.record_failure()
                        self._links[part].cancel(req_id)
                        lost[part] = "timeout"
                    pending_by_part.clear()
                    break
                if hedge_s > 0 and first_t is not None and now >= first_t + hedge_s:
                    # the soft straggler bound (fabric.hedge_ms after the
                    # first answer): serve without the stragglers; slow once
                    # is not sick, so no breaker is fed
                    for part, (req_id, _p) in pending_by_part.items():
                        self._links[part].cancel(req_id)
                        lost[part] = "straggler"
                    pending_by_part.clear()
                    break
                wait_s = min(0.01, max(0.0, t_end - now))
                if hedge_s > 0 and first_t is not None:
                    wait_s = min(wait_s, max(0.0005, first_t + hedge_s - now))
                next(iter(pending_by_part.values()))[1].event.wait(wait_s)
        # a gather fault stops the wait: resolved partitions survive, the
        # rest are lost, and their breakers are not fed (the front's
        # collect path failed, not the hosts)
        for part, (req_id, pending) in list(pending_by_part.items()):
            if pending.event.is_set():
                replies[part] = pending.reply or {}
            else:
                self._links[part].cancel(req_id)
                lost[part] = "gather"
        pending_by_part.clear()
        part_rows: Dict[int, List[Any]] = {}
        gen_vector: List[int] = [link.generation for link in self._links]
        degraded: List[str] = []
        for part in sorted(replies):
            reply = replies[part]
            if reply.get("op") == "result":
                self._links[part].breaker.record_success()
                part_rows[part] = reply.get("rows", [])
                degraded.extend(reply.get("degraded", ()))
                rmeta = reply.get("meta", {})
                if rmeta.get("index_generation") is not None:
                    # the owner's dispatch-time generation: fresher than the
                    # last pong's
                    gen_vector[part] = int(rmeta["index_generation"])
            else:
                if reply.get("req_id") is not None:
                    # the WORKER answered an error: the partition host is
                    # sick though its socket is not
                    self._links[part].breaker.record_failure()
                log_once(f"fabric.partition:{self._links[part].name}",
                         "partition %s failed a scatter request (%s); serving without it",
                         self._links[part].name, reply.get("error", "?"))
                lost[part] = "error"
        record_fetch("fabric.gather", shards=max(1, len(part_rows)))
        rows = self._merge_partitions(texts, part_rows, k)
        meta: Dict[str, Any] = {"fabric_partitions": n_parts, "index_generation": tuple(gen_vector)}
        if lost:
            record_degraded(PARTITION_LOST, len(lost))
            degraded.append(PARTITION_LOST)
            meta["partitions_lost"] = {self._links[p].name: why for p, why in sorted(lost.items())}
        with self._stats_lock:
            if lost:
                self.stats["partition_lost"] += 1
                for part in lost:
                    self._part_lost[part] += 1
            if part_rows:
                self.stats["ok"] += 1
            else:
                self.stats["lost"] += 1
        return ServeResult(rows, degraded=degraded, meta=meta)

    def _merge_partitions(self, texts: List[str], part_rows: Dict[int, List[Any]],
                          k: Optional[int]) -> List[List[Any]]:
        """Merge the partitions' sorted top-K rows through
        ``ops/topk.tree_merge_topk_host``: scores order the merge, then
        the owners' own ``(doc, score)`` pairs are re-emitted.  The merge
        only picks, never recomputes, so H hosts equal one bit for bit on
        the clean path."""
        if not part_rows:
            return [[] for _ in texts]
        parts = sorted(part_rows)
        b = len(texts)
        k_cap = max((len(row) for p in parts for row in part_rows[p]), default=0)
        k_out = int(k) if k else k_cap
        if k_cap == 0 or k_out == 0:
            return [[] for _ in texts]
        s = len(parts)
        # [S, B, K] merge inputs: scores order; (owner, position) name the
        # pair to re-emit; absent slots (a partition with fewer than K
        # rows) stay -inf and are dropped
        scores = np.full((s, b, k_cap), -np.inf, dtype=np.float64)
        pos = np.zeros((s, b, k_cap), dtype=np.int64)
        owner = np.zeros((s, b, k_cap), dtype=np.int64)
        for si, p in enumerate(parts):
            owner[si] = si
            rows = part_rows[p]
            for qi in range(b):
                row = rows[qi] if qi < len(rows) else []
                for j, pair in enumerate(row[:k_cap]):
                    scores[si, qi, j] = float(pair[1])
                    pos[si, qi, j] = j
        m_scores, m_owner, m_pos = tree_merge_topk_host(scores, owner, pos, k_out)
        out: List[List[Any]] = []
        for qi in range(b):
            out.append([
                part_rows[parts[int(m_owner[qi, j])]][qi][int(m_pos[qi, j])]
                for j in range(m_scores.shape[1])
                if np.isfinite(m_scores[qi, j])
            ])
        return out

    # -- owner-routed absorb ------------------------------------------------------
    def connector(self, name: Optional[str] = None) -> "_FleetConnector":
        """A fleet-side ingest connector (``serve/ingest.IngestConnector``'s
        surface): buffer keyed rows, stamp them at ``commit()``, then route
        each document to its owning partition only."""
        if self.partition_map is None:
            raise RuntimeError("connector() requires a partitioned fabric")
        return _FleetConnector(self, name or f"{self.name}-connector")

    def absorb(self, docs: Sequence[Tuple[int, str, int]], deadline: Optional[Deadline] = None,
               connector: str = "fleet") -> int:
        """Route ``(key, text, t_arrival_ns)`` documents to their owning
        partitions only and wait for the owners' acks.  A partition that
        faults (site ``partition.absorb``), is unreachable, answers an
        error or misses ``partition.absorb_timeout_s`` has its batch
        counted dropped (re-committable); this never raises.  Returns the
        number accepted."""
        if self.partition_map is None:
            raise RuntimeError("absorb() requires a partitioned fabric")
        docs = [(int(kk), str(t), int(ns)) for kk, t, ns in docs]
        if not docs:
            return 0
        buckets = self.partition_map.route([d[0] for d in docs])
        acks: List[Tuple[int, int, List[Tuple[int, str, int]], _Pending]] = []
        for part in sorted(buckets):
            batch = [docs[i] for i in buckets[part]]
            link = self._links[part]
            try:
                inject.fire("partition.absorb", deadline=deadline)
                if not link.breaker.allow():
                    raise PeerLost(f"partition {link.name} breaker open")
                req_id = next(self._req_ids)
                pending = link.send_request(
                    req_id, {"op": "absorb", "req_id": req_id, "docs": batch, "connector": connector},
                    deadline=deadline,
                )
            except BaseException as exc:  # noqa: BLE001 - dropped, never raise
                with self._stats_lock:
                    self._absorb_dropped[part] += len(batch)
                log_once(f"partition.absorb:{link.name}:{type(exc).__name__}",
                         "absorb route to partition %s failed (%r); batch dropped (re-committable)", link.name, exc)
                continue
            acks.append((part, req_id, batch, pending))
        t_end = time.monotonic() + config.get("partition.absorb_timeout_s")
        if deadline is not None:
            t_end = min(t_end, time.monotonic() + max(0.0, deadline.remaining_s()))
        accepted = 0
        for part, req_id, batch, pending in acks:
            pending.event.wait(max(0.0, t_end - time.monotonic()))
            reply = pending.reply or {}
            if pending.event.is_set() and reply.get("op") == "absorb_ack":
                n = int(reply.get("accepted", len(batch)))
                accepted += n
                self._links[part].breaker.record_success()
                with self._stats_lock:
                    self._absorb_docs[part] += n
                continue
            self._links[part].cancel(req_id)
            if pending.event.is_set() and reply.get("req_id") is not None:
                # the OWNER answered an error (no runner, a runner bug):
                # that host is sick
                self._links[part].breaker.record_failure()
            with self._stats_lock:
                self._absorb_dropped[part] += len(batch)
            log_once(f"partition.absorb_ack:{self._links[part].name}",
                     "partition %s did not ack an absorb batch (%s); batch dropped (re-committable)",
                     self._links[part].name, reply.get("error", "timeout"))
        return accepted

    # -- flight recorder ------------------------------------------------------------
    def observe_metrics(self):
        base = {"fabric": self.name, "id": str(self._observe_id)}
        for outcome in ("ok", "failover", "hedged", "lost"):
            yield ("counter", "pathway_fabric_requests_total", {**base, "outcome": outcome}, self.stats[outcome])
        for link in self._links:
            labels = {**base, "host": link.name}
            yield ("gauge", "pathway_fabric_host_up", labels, int(link.up()))
            yield ("gauge", "pathway_fabric_inflight", labels, link.inflight)
        if self.partition_map is not None:
            yield ("gauge", "pathway_partition_count", base, self.partition_map.n_partitions)
            for part, link in enumerate(self._links):
                pl = {**base, "partition": str(part), "host": link.name}
                yield ("counter", "pathway_partition_lost_total", pl, self._part_lost[part])
                yield ("counter", "pathway_partition_absorb_docs_total", pl, self._absorb_docs[part])
                yield ("counter", "pathway_partition_absorb_dropped_total", pl, self._absorb_dropped[part])

    def stop(self) -> None:
        """Close every link (``bye`` frames, best effort).  Idempotent."""
        if self._closed:
            return
        self._closed = True
        for link in self._links:
            link.close()


class _FleetConnector:
    """Fleet-side twin of ``serve/ingest.IngestConnector``: the same
    buffer and commit surface, but ``commit()`` owner-routes the batch
    over the fabric.  The arrival stamp is taken here, at the commit, as
    the single-host connector takes it, and rides the wire, so the owner's
    freshness covers the routing hop."""

    def __init__(self, fabric: ServeFabric, name: str):
        self._fabric = fabric
        self.name = str(name)
        self._buf: List[Tuple[int, str]] = []
        self._lock = threading.Lock()

    def insert(self, key: int, text: str) -> None:
        with self._lock:
            self._buf.append((int(key), str(text)))

    def insert_rows(self, rows) -> None:
        rows = [(int(k), str(t)) for k, t in rows]
        with self._lock:
            self._buf.extend(rows)

    def commit(self, deadline: Optional[Deadline] = None) -> int:
        """Commit the buffered rows to their owning partitions; returns how
        many the owners accepted (a dead partition's batch is counted
        dropped and is re-committable; commit never raises)."""
        with self._lock:
            rows, self._buf = self._buf, []
        if not rows:
            return 0
        t = time.perf_counter_ns()
        return self._fabric.absorb([(k, txt, t) for k, txt in rows], deadline=deadline, connector=self.name)

    def close(self) -> None:
        pass
