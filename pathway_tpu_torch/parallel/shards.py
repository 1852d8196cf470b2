"""Serve-shard device groups (counterpart of
``pathway_tpu/parallel/shards.py``): placement, the routing rule and
per-shard health.

The sharded serve tier partitions the index by DOCUMENT across a device
group and fans each coalesced stage-1 batch out to every shard:

- ``ShardGroup`` maps ``n_shards`` logical shards onto ``torch.device``s
  (round-robin when shards outnumber devices: 8 shards on one card are
  8 resident partitions, 8 search launches and one merge per batch) and
  owns the one routing rule, ``owner_of(key) = key % n_shards``, that
  the sharded IVF index (``ops/ivf.py``) and the sharded forward index
  (``index/forward.py``) both use, so a document's postings and its
  token rows live on the same shard;
- per-shard ``CircuitBreaker``s: a shard that keeps failing its stage-1
  dispatch is skipped (rung ``shard_skipped``: recall on its partition
  is lost, the request is not) and probed back in on the breaker's
  half-open schedule;
- skips and breaker state are scraped as ``pathway_serve_shard_count``,
  ``pathway_serve_shard_skips_total{shard}`` and
  ``pathway_serve_shard_breaker_open{shard}``.

``FleetPartitionMap`` is the same modulo rule at fleet scope (which host
owns a document); it holds no device.

``devices=None`` means every visible CUDA device; without CUDA the group
raises, as ``resolve_device`` does, and never falls back to the CPU.
Tests pass ``devices=[torch.device("cpu")]``.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import torch

from .. import config, observe
from ..observe import trace
from ..robust import CircuitBreaker

__all__ = ["FleetPartitionMap", "ShardGroup", "serve_shards"]


def serve_shards(default: int = 0) -> int:
    """Shard count from ``serve.shards``, else ``default`` (0 = one
    shard per device)."""
    return config.get("serve.shards", fallback=default)


def _route(owner_of, keys: Sequence[int]):
    """Positions of ``keys`` grouped by owner (iterate ``sorted(...)``
    for deterministic per-owner batches)."""
    buckets: dict = {}
    for i, key in enumerate(keys):
        buckets.setdefault(owner_of(int(key)), []).append(i)
    return buckets


class FleetPartitionMap:
    """``doc_key % n_partitions`` names the host that owns a document,
    as ``ShardGroup.owner_of`` names the shard inside one host; both
    levels spell the same modulo rule, so placement needs no
    coordination."""

    def __init__(self, n_partitions: int):
        if int(n_partitions) < 1:
            raise ValueError(f"FleetPartitionMap needs >= 1 partition, got {n_partitions}")
        self.n_partitions = int(n_partitions)

    def __len__(self) -> int:
        return self.n_partitions

    def owner_of(self, key: int) -> int:
        return int(key) % self.n_partitions

    def route(self, keys: Sequence[int]):
        return _route(self.owner_of, keys)


def _visible_cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass devices=[torch.device('cpu')] explicitly "
            "to run a shard group on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class ShardGroup:
    """``n_shards`` logical shards over ``devices`` (round-robin), the
    document -> shard rule and per-shard breakers.  One group is shared
    by every sharded structure serving one corpus, so co-partitioned
    data stays co-resident."""

    def __init__(
        self,
        n_shards: Optional[int] = None,
        devices: Optional[Sequence] = None,
        name: Optional[str] = None,
    ):
        devs = _visible_cuda_devices() if devices is None else [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("ShardGroup needs at least one device")
        self.devices = devs
        self.n_shards = max(1, int(n_shards or serve_shards() or len(devs)))
        self.name = name or f"shards-{observe.next_id()}"
        self._lock = threading.Lock()
        self._breakers: List[CircuitBreaker] = [
            CircuitBreaker(f"{self.name}.shard{s}") for s in range(self.n_shards)
        ]
        self.skips: List[int] = [0] * self.n_shards
        observe.register_provider(self)

    def __len__(self) -> int:
        return self.n_shards

    def device(self, shard: int) -> torch.device:
        """The device hosting ``shard`` (round-robin past the device
        count)."""
        return self.devices[shard % len(self.devices)]

    @property
    def spans_devices(self) -> int:
        """Distinct devices the shards actually occupy."""
        return len({self.device(s) for s in range(self.n_shards)})

    def owner_of(self, key: int) -> int:
        """Owning shard of a document key: THE routing rule."""
        return int(key) % self.n_shards

    def route(self, keys: Sequence[int]):
        """Positions of ``keys`` grouped by owning shard."""
        return _route(self.owner_of, keys)

    def breaker(self, shard: int) -> CircuitBreaker:
        return self._breakers[shard]

    def record_skip(self, shard: int) -> None:
        with self._lock:
            self.skips[shard] += 1
        t = trace.current()
        if t is not None:
            t.add_event("shard.skip", shard=int(shard))

    def observe_metrics(self):
        labels = {"group": self.name}
        yield ("gauge", "pathway_serve_shard_count", labels, self.n_shards)
        for s in range(self.n_shards):
            shard_labels = {**labels, "shard": str(s)}
            yield ("counter", "pathway_serve_shard_skips_total", shard_labels, self.skips[s])
            yield ("gauge", "pathway_serve_shard_breaker_open", shard_labels,
                   0.0 if self._breakers[s].state == "closed" else 1.0)
