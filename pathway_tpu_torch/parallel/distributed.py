"""Cross-process control plane of the port (counterpart of
``pathway_tpu/parallel/distributed.py``), on ``torch.distributed``.

Execution model, as in the reference: every process runs the same
program (SPMD) and holds the same host data; device-resident state is
split over one mesh that lists every process's devices
(``parallel/mesh.py``), each process addressing only its own blocks.

Topology comes from the port's copies of the reference's knobs, under
the same environment names:

  PATHWAY_PROCESSES            total process count (default 1: no-op)
  PATHWAY_PROCESS_ID           this process's rank
  PATHWAY_COORDINATOR_ADDRESS  host:port of the coordinator's store
  PATHWAY_FIRST_PORT           else ``127.0.0.1:<first port>``

Two planes:

- **Control plane** (``barrier``, ``broadcast_obj``): a
  ``torch.distributed.TCPStore`` hosted by rank 0 plays the part of the
  reference's coordination-service key-value store.  A broadcast is a
  keyed set on the coordinator (key ``pathway_tpu/bcast/{name}``; a
  reused name fails loudly) and a blocking get with a timeout elsewhere;
  a barrier is a counter in the store.  Both degrade as the reference's
  do: a fault at the ``dist.barrier`` / ``dist.broadcast`` site, a
  timeout or a store error is counted on
  ``pathway_dist_degraded_total{site=...}`` and answered locally (False;
  the local ``obj``), never raised and never hung past a spent deadline.
  ``kv_set`` / ``kv_get`` are the store's plain key-value pair, the
  counterpart of the reference's coordination-service
  ``key_value_set`` / ``blocking_key_value_get``: the engine's exchange
  plane (``parallel/exchange.py``) publishes its session token and listen
  addresses through them.  They raise on a timeout: a rendezvous has no
  local-only answer.
- **Data plane** (``all_gather``, ``broadcast``): the default process
  group, whose backend is chosen from the topology at ``maybe_initialize``
  and nowhere else: ``nccl`` when every rank owns a distinct CUDA device,
  ``gloo`` otherwise (on the CPU, and when ranks share one card, where
  NCCL refuses two ranks on one device).  The choice is printed, and is
  never swapped after a failure.  Under gloo a CUDA tensor is staged
  through host memory and copied back.
"""

from __future__ import annotations

import pickle
import socket
import sys
import threading
from datetime import timedelta
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as tdist

from .. import config, observe
from ..robust import inject, log_once

__all__ = [
    "all_gather",
    "barrier",
    "broadcast",
    "broadcast_obj",
    "data_backend",
    "gather_obj",
    "is_coordinator",
    "is_distributed",
    "kv_get",
    "kv_set",
    "maybe_initialize",
    "process_count",
    "process_id",
    "shutdown",
    "topology_from_env",
]

# how long a rank waits for the others to join the store or a gather
_JOIN_TIMEOUT_S = 300.0

_lock = threading.Lock()
_store: Optional[tdist.TCPStore] = None
_rank = 0
_world = 1
_backend: Optional[str] = None
_gathers = 0  # sequence number of ``gather_obj`` calls (SPMD: equal on every rank)


def topology_from_env() -> Tuple[int, int, Optional[str]]:
    """``(processes, process_id, coordinator_address)`` from the
    ``parallel.*`` knobs."""
    processes = config.get("parallel.processes")
    pid = config.get("parallel.process_id")
    addr = config.get("parallel.coordinator_address") or None
    if addr is None:
        first_port = config.get("parallel.first_port")
        if first_port:
            addr = f"127.0.0.1:{first_port}"
    return processes, pid, addr


def _rank_device(rank: int) -> Optional[torch.device]:
    """The CUDA device a rank owns on its host (``rank % device count``),
    or None without CUDA."""
    if not torch.cuda.is_available():
        return None
    return torch.device("cuda", rank % torch.cuda.device_count())


def maybe_initialize() -> bool:
    """Join the process cluster when ``PATHWAY_PROCESSES`` > 1: connect
    to the coordinator's store, choose the data-plane backend and start
    the default process group.  Idempotent; returns True when running
    distributed after the call."""
    global _store, _rank, _world, _backend
    with _lock:
        if _store is not None:
            return True
        processes, pid, addr = topology_from_env()
        if processes <= 1:
            return False
        if addr is None:
            raise RuntimeError(
                "PATHWAY_PROCESSES > 1 but no PATHWAY_COORDINATOR_ADDRESS / PATHWAY_FIRST_PORT: "
                "set the topology env vars explicitly"
            )
        host, port = addr.rsplit(":", 1)
        store = tdist.TCPStore(
            host, int(port), processes, is_master=(pid == 0), timeout=timedelta(seconds=_JOIN_TIMEOUT_S)
        )
        dev = _rank_device(pid)
        me = f"{socket.gethostname()}|{'' if dev is None else dev.index}"
        store.set(f"pathway_tpu/topology/{pid}", me)
        places = [store.get(f"pathway_tpu/topology/{r}").decode() for r in range(processes)]
        on_cards = all(not p.endswith("|") for p in places)
        backend = "nccl" if on_cards and len(set(places)) == processes else "gloo"
        why = (
            "every rank owns a distinct CUDA device" if backend == "nccl"
            else "ranks share a CUDA device" if on_cards else "no CUDA device"
        )
        if backend == "nccl":
            torch.cuda.set_device(dev)
        tdist.init_process_group(
            backend, store=tdist.PrefixStore("pathway_tpu/pg", store), rank=pid, world_size=processes
        )
        _store, _rank, _world, _backend = store, pid, processes, backend
        print(
            f"pathway_tpu_torch.distributed: rank {pid}/{processes} joined via {addr}; "
            f"data-plane backend {backend} ({why})",
            file=sys.stderr, flush=True,
        )
        return True


def shutdown() -> None:
    """Leave the cluster: destroy the process group and drop the store."""
    global _store, _rank, _world, _backend, _gathers
    with _lock:
        if _store is None:
            return
        tdist.destroy_process_group()
        _store, _rank, _world, _backend, _gathers = None, 0, 1, None, 0


def is_distributed() -> bool:
    return _world > 1


def process_id() -> int:
    return _rank


def process_count() -> int:
    return _world


def is_coordinator() -> bool:
    return _rank == 0


def data_backend() -> Optional[str]:
    """The data-plane backend chosen at init (None single-process)."""
    return _backend


_degraded_counters: Dict[str, observe.Counter] = {}


def _count_degraded(site: str) -> None:
    c = _degraded_counters.get(site)
    if c is None:
        c = _degraded_counters[site] = observe.counter("pathway_dist_degraded_total", site=site)
    c.inc()


def barrier(name: str, timeout_ms: int = 60_000, deadline=None) -> bool:
    """Control-plane barrier: True when every process reached it, False
    when it degraded (site ``dist.barrier`` armed, timeout, store error),
    counted on ``pathway_dist_degraded_total{site="barrier"}``.  A name
    may be reused: each round of ``process_count()`` arrivals is its own
    barrier."""
    try:
        inject.fire("dist.barrier", deadline=deadline)
        if not is_distributed():
            return True
        key = f"pathway_tpu/barrier/{name}"
        n = _store.add(key, 1)
        done = f"{key}/{(n - 1) // _world}"
        if n % _world == 0:
            _store.set(done, "1")
        _store.wait([done], timedelta(milliseconds=timeout_ms))
        return True
    except Exception as exc:  # noqa: BLE001 - a degraded control plane is flagged, never raised
        _count_degraded("barrier")
        log_once(
            f"dist.barrier:{type(exc).__name__}",
            "control-plane barrier %r degraded (%r); proceeding local-only", name, exc,
        )
        return False


def broadcast_obj(obj: Any = None, *, name: str, timeout_ms: int = 60_000, deadline=None) -> Any:
    """The coordinator's picklable ``obj`` on every process (pass it on
    the coordinator, None elsewhere).  ``name`` is unique per broadcast:
    reusing it on the coordinator raises inside and degrades.  Degraded
    (site ``dist.broadcast`` armed, timeout, store error): the LOCAL
    ``obj``, counted on ``pathway_dist_degraded_total{site="broadcast"}``."""
    try:
        inject.fire("dist.broadcast", deadline=deadline)
        if not is_distributed():
            return obj
        key = f"pathway_tpu/bcast/{name}"
        if is_coordinator():
            if _store.add(f"{key}/writers", 1) != 1:
                raise RuntimeError(f"broadcast name {name!r} was used before")
            _store.set(key, pickle.dumps(obj))
            return obj
        _store.wait([key], timedelta(milliseconds=timeout_ms))
        return pickle.loads(_store.get(key))
    except Exception as exc:  # noqa: BLE001 - a degraded control plane is flagged, never raised
        _count_degraded("broadcast")
        log_once(
            f"dist.broadcast:{type(exc).__name__}",
            "control-plane broadcast %r degraded (%r); serving local value", name, exc,
        )
        return obj


def gather_obj(obj: Any) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order (a collective: every
    rank calls it in the same order).  Raises on a timeout: callers use
    it to agree on topology, which has no local-only answer."""
    global _gathers
    if not is_distributed():
        return [obj]
    with _lock:
        _gathers += 1
        seq = _gathers
    key = f"pathway_tpu/gather/{seq}"
    _store.set(f"{key}/{_rank}", pickle.dumps(obj))
    keys = [f"{key}/{r}" for r in range(_world)]
    _store.wait(keys, timedelta(seconds=_JOIN_TIMEOUT_S))
    return [pickle.loads(_store.get(k)) for k in keys]


def kv_set(key: str, value: str) -> None:
    """Publish ``value`` under ``key`` in the cluster's store."""
    _store.set(key, value)


def kv_get(key: str, timeout_ms: int = 60_000) -> str:
    """The value under ``key``, waiting up to ``timeout_ms`` for a peer to
    publish it; raises on a timeout."""
    _store.wait([key], timedelta(milliseconds=timeout_ms))
    return _store.get(key).decode()


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend can read it: host memory under gloo, and
    bool as uint8."""
    t = t.contiguous()
    if _backend == "gloo" and t.is_cuda:
        t = t.cpu()
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """``[process_count(), *t.shape]``: every rank's ``t`` (same shape
    and dtype on all), in rank order, on ``t``'s device."""
    if not is_distributed():
        return t[None]
    src = _staged(t)
    parts = [torch.empty_like(src) for _ in range(_world)]
    tdist.all_gather(parts, src)
    return torch.stack(parts).to(t.device, t.dtype)


def broadcast(t: torch.Tensor, src: int) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, written into ``t``."""
    if not is_distributed():
        return t
    staged = _staged(t)
    tdist.broadcast(staged, src)
    if staged is not t:
        t.copy_(staged)
    return t
