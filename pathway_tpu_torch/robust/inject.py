"""Deterministic fault injection for the port's serve path (counterpart
of ``pathway_tpu/robust/inject.py``).

Named sites, the reference's: ``serve.dispatch``, ``serve.fetch``,
``ivf.dispatch``, ``rerank.dispatch``, ``cross_encoder.dispatch``,
``cross_encoder.fetch``, ``forward.gather``, ``forward.gather.fetch``,
``cache.get``, ``cache.put``, ``trace.record``, ``trace.export``,
``slo.evaluate``, and the sharded-serve family ``shard.dispatch`` /
``shard.merge`` / ``shard.absorb``, each also addressable per shard as
``<site>.<n>`` (``shard.dispatch.3`` kills exactly shard 3 of a group),
the serve fabric's replica triple ``fabric.route`` (affinity falls back
to least-loaded, flagged) / ``fabric.send`` / ``fabric.recv`` (failover
to a survivor, flagged ``host_failover``, breaker fed) and its
partitioned triple ``fabric.scatter`` (that partition is lost, flagged
``partition_lost``) / ``fabric.gather`` (stop waiting, serve the
resolved partitions) / ``partition.absorb`` (that routed batch is
dropped, counted on ``pathway_partition_absorb_dropped_total`` and
re-committable), all in ``serve/fabric.py``, and the S3 snapshot-backend
triple ``s3.get`` / ``s3.put`` / ``s3.list`` (``persistence/backends.py``:
a transient object-store error retries with the seeded-jitter backoff),
and ``config.load`` (``config.py``: a reload serves the last-good knob
values, counted on ``pathway_config_load_failures_total``).
A test or an operator arms a site to

- ``raise`` a ``FaultInjected``,
- ``delay`` the call (capped at the caller's remaining deadline), or
- ``hang`` until the caller's deadline, a disarm, or ``hang_s``,

through ``arm`` / ``armed`` or the ``robust.faults`` spec
(``PATHWAY_FAULTS="ivf.dispatch=raise:p=0.01:seed=7;cache.get=delay:ms=50"``).
A probability below 1 draws from a ``random.Random`` seeded by
``(seed, site)``, so a run replays identically; the registry is
thread-safe, and ``fire`` on a disarmed registry is one integer compare.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .. import config, observe
from .deadline import Deadline, DeadlineExceeded

__all__ = ["FaultInjected", "any_armed", "arm", "armed", "disarm", "fire", "fired_count", "load_env"]

_MODES = ("raise", "delay", "hang")

_fired_counters: Dict[Tuple[str, str], observe.Counter] = {}


def _fired_counter(site: str, mode: str) -> observe.Counter:
    c = _fired_counters.get((site, mode))
    if c is None:
        c = _fired_counters[(site, mode)] = observe.counter(
            "pathway_robust_faults_fired_total", site=site, mode=mode
        )
    return c


class FaultInjected(RuntimeError):
    """The error an armed ``raise`` site throws."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at {site!r}")
        self.site = site


class _Site:
    __slots__ = ("mode", "times", "p", "delay_s", "hang_s", "rng", "fired", "disarmed")

    def __init__(self, site: str, mode: str, times: Optional[int], p: float,
                 delay_s: float, hang_s: float, seed: int):
        if mode not in _MODES:
            raise ValueError(f"unknown fault mode {mode!r} (want {_MODES})")
        self.mode = mode
        self.times = times  # None = unlimited
        self.p = float(p)
        self.delay_s = float(delay_s)
        self.hang_s = float(hang_s)
        self.rng = random.Random(f"{seed}:{site}")
        self.fired = 0
        self.disarmed = threading.Event()


_lock = threading.Lock()
_sites: Dict[str, _Site] = {}
_armed_count = 0  # fire() is a no-op while this is 0
_env_loaded = False


def arm(site: str, mode: str = "raise", *, times: Optional[int] = None, p: float = 1.0,
        delay_s: float = 0.0, hang_s: float = 30.0, seed: int = 0) -> None:
    """Arm ``site``: ``times`` bounds how often it triggers (None = every
    eligible call), ``p`` is the seeded per-call probability, ``hang_s``
    caps a ``hang`` for a caller without a deadline."""
    global _armed_count
    spec = _Site(site, mode, times, p, delay_s, hang_s, seed)
    with _lock:
        old = _sites.get(site)
        if old is not None:
            old.disarmed.set()
        else:
            _armed_count += 1
        _sites[site] = spec


def disarm(site: Optional[str] = None) -> None:
    """Disarm one site (every site when None); releases hung calls."""
    global _armed_count
    with _lock:
        for name in [site] if site is not None else list(_sites):
            spec = _sites.pop(name, None)
            if spec is not None:
                spec.disarmed.set()
                _armed_count -= 1


@contextlib.contextmanager
def armed(site: str, mode: str = "raise", **kwargs: Any) -> Iterator[None]:
    """``with inject.armed("ivf.dispatch", times=1): ...``; disarms on exit."""
    arm(site, mode, **kwargs)
    try:
        yield
    finally:
        disarm(site)


def fired_count(site: str) -> int:
    with _lock:
        spec = _sites.get(site)
        return spec.fired if spec is not None else 0


def any_armed() -> bool:
    if not _env_loaded:
        load_env()
    return _armed_count != 0


def fire(site: str, deadline: Optional[Deadline] = None) -> None:
    """The instrumentation point: no-op unless ``site`` is armed.
    ``raise`` -> ``FaultInjected``; ``delay`` -> sleep ``delay_s``
    (capped at the deadline's remaining time); ``hang`` -> block until
    the deadline (``DeadlineExceeded``), a disarm, or ``hang_s``
    (``FaultInjected``)."""
    if not _env_loaded:
        load_env()
    if _armed_count == 0:
        return
    with _lock:
        spec = _sites.get(site)
        if spec is None:
            return
        if spec.times is not None and spec.fired >= spec.times:
            return
        if spec.p < 1.0 and spec.rng.random() >= spec.p:
            return
        spec.fired += 1
        mode, delay_s, hang_s, disarmed = spec.mode, spec.delay_s, spec.hang_s, spec.disarmed
    _fired_counter(site, mode).inc()
    if mode == "raise":
        raise FaultInjected(site)
    if mode == "delay":
        if deadline is not None:
            delay_s = min(delay_s, max(0.0, deadline.remaining_s()) + 0.01)
        time.sleep(delay_s)
        return
    t_end = time.monotonic() + hang_s
    while True:
        if deadline is not None and deadline.expired():
            raise DeadlineExceeded(site)
        if disarmed.wait(timeout=0.01):
            return
        if time.monotonic() >= t_end:
            raise FaultInjected(site)


def load_env(value: Optional[str] = None) -> List[str]:
    """Arm the sites of a spec string (``robust.faults`` when None):
    ``;``- or ``,``-separated ``site=mode[:key=val...]`` entries with keys
    ``p``, ``times``, ``ms`` (delay, or hang cap for ``hang``),
    ``hang_ms``, ``seed``.  Returns the armed site names."""
    global _env_loaded
    _env_loaded = True
    raw = config.get("robust.faults") if value is None else value
    armed_sites: List[str] = []
    for entry in raw.replace(",", ";").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        site, _, rest = entry.partition("=")
        parts = rest.split(":") if rest else ["raise"]
        mode = parts[0].strip() or "raise"
        kwargs: Dict[str, Any] = {}
        for opt in parts[1:]:
            k, _, v = opt.partition("=")
            k = k.strip()
            if k == "p":
                kwargs["p"] = float(v)
            elif k == "times":
                kwargs["times"] = int(v)
            elif k == "ms":
                kwargs["hang_s" if mode == "hang" else "delay_s"] = float(v) * 1e-3
            elif k == "hang_ms":
                kwargs["hang_s"] = float(v) * 1e-3
            elif k == "seed":
                kwargs["seed"] = int(v)
        arm(site.strip(), mode, **kwargs)
        armed_sites.append(site.strip())
    return armed_sites
