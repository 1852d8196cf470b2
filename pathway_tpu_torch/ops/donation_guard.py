"""In-place-write tripwire (counterpart of ``pathway_tpu/ops/donation_guard.py``,
rebuilt for a port that writes in place where the reference donates).

The reference's absorb and commit kernels donate their buffers, and its
guard poisons the consumed references.  The port has no donation: it
writes device state in place — the IVF absorb's ``index_copy_`` /
``index_fill_`` into the slabs and bias (and the host live mask), the
forward index's commit into its row buckets, the slot pool's K/V writes
of every prefill, step and verify.  What such a write can break is a
reference the port handed out as a *snapshot*: a serve's dispatch-time
``keys_by_slot``, a warm-state array taken in, a prefix block captured
from the pool.  The port keeps those snapshots apart with copies; this
module checks that it does.  ``PATHWAY_DONATION_GUARD=1`` arms it:

- ``stamp(site, *refs)`` records, for each snapshot reference, torch's
  version counter (``tensor._version``, which views share with their
  base) and the write count of its storage;
- ``note_write(site, *refs)`` is called by every in-place site after
  its write and bumps the write count of each written storage (keyed by
  the storage's data pointer, so a numpy array and a tensor that share
  memory share a count);
- a stamped reference whose storage was written since is a violation
  when it reaches a guarded call (``guard(site, *refs)``) or when
  ``check(ref)`` probes it.  **Strict mode** (pytest, or
  ``PATHWAY_DONATION_GUARD_STRICT=1``) raises :class:`DonationViolation`
  naming the writing site and the using site; **production mode** logs
  once, counts ``pathway_donation_violations_total{site}``, and the
  guarded call takes its copying path (``guard`` returns False).

Off (the default) each of these costs one flag read.  Stamps are
dropped when their reference is collected, so a recycled address never
inherits a dead snapshot's stamp.  ``pathway_donation_poisoned_total{site}``
counts the recorded in-place writes per writing site.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import config

__all__ = [
    "DonationViolation",
    "check",
    "enabled",
    "guard",
    "note_write",
    "stamp",
    "stats",
    "strict_mode",
]


class DonationViolation(RuntimeError):
    """A snapshot reference was used after an in-place write reached
    its storage."""


def enabled() -> bool:
    return config.get("ops.donation_guard")


def strict_mode() -> bool:
    """Raise on a violation instead of log + count: explicitly via
    ``PATHWAY_DONATION_GUARD_STRICT``, on under pytest when unset."""
    return config.get("ops.donation_guard_strict")


_lock = threading.Lock()
# storage data pointer -> (writes recorded, last writing site)
_writes: Dict[int, Tuple[int, str]] = {}
# id(ref) -> (stamping site, version at stamp or None, storage pointer,
# writes at stamp, finalizer)
_stamps: Dict[int, Tuple[str, Optional[int], int, int, Any]] = {}
_written_total: Dict[str, int] = {}
_violations_total: Dict[str, int] = {}
_sites: Dict[str, None] = {}


class _Provider:
    """Both families for every known site (zeros stay visible)."""

    def observe_metrics(self):
        with _lock:
            sites = list(_sites)
            written = dict(_written_total)
            violations = dict(_violations_total)
        for site in sites:
            labels = {"site": site}
            yield ("counter", "pathway_donation_poisoned_total", labels, written.get(site, 0))
            yield ("counter", "pathway_donation_violations_total", labels, violations.get(site, 0))


_provider = _Provider()


def _register_site(site: str) -> None:
    with _lock:
        first = not _sites
        _sites.setdefault(site, None)
    if first:
        from .. import observe

        observe.register_provider(_provider)


def _storage_ptr(ref: Any) -> Optional[int]:
    """Start of the memory ``ref`` lives in: the storage of a tensor, the
    base buffer of a numpy array (views resolve to their base)."""
    ptr = None
    if isinstance(ref, torch.Tensor):
        ptr = ref.untyped_storage().data_ptr()
    elif isinstance(ref, np.ndarray):
        while isinstance(ref.base, np.ndarray):
            ref = ref.base
        ptr = ref.__array_interface__["data"][0]
    return ptr or None  # an empty tensor has no memory to write


def _version(ref: Any) -> Optional[int]:
    return ref._version if isinstance(ref, torch.Tensor) else None


def _forget(ref_id: int) -> None:
    with _lock:
        _stamps.pop(ref_id, None)


def stamp(site: str, *refs: Any) -> None:
    """Record ``refs`` as snapshots handed out (or taken in) at ``site``:
    memory the port promises not to write while they live.  A reference
    stamped again keeps its first stamp."""
    if not enabled():
        return
    _register_site(site)
    for ref in refs:
        ptr = _storage_ptr(ref)
        if ptr is None or id(ref) in _stamps:
            continue  # a snapshot is never written: its first stamp stands
        fin = weakref.finalize(ref, _forget, id(ref))
        with _lock:
            _stamps[id(ref)] = (site, _version(ref), ptr, _writes.get(ptr, (0, ""))[0], fin)


def note_write(site: str, *refs: Any) -> None:
    """Record an in-place write by ``site`` into each of ``refs``."""
    if not enabled():
        return
    _register_site(site)
    with _lock:
        for ref in refs:
            ptr = _storage_ptr(ref)
            if ptr is None:
                continue
            _writes[ptr] = (_writes.get(ptr, (0, ""))[0] + 1, site)
            _written_total[site] = _written_total.get(site, 0) + 1


def check(ref: Any) -> Optional[str]:
    """The site whose in-place write reached the stamped ``ref`` since
    its stamp, or None while it is intact (or was never stamped)."""
    with _lock:
        entry = _stamps.get(id(ref))
        if entry is None:
            return None
        _site, version, ptr, writes0, _fin = entry
        writes, writer = _writes.get(ptr, (0, ""))
    if writes != writes0:
        return writer
    if version is not None and _version(ref) != version:
        return "an in-place write outside the recorded sites"
    return None


def _violation(writer: str, use_site: str) -> None:
    with _lock:
        _violations_total[use_site] = _violations_total.get(use_site, 0) + 1
    msg = (
        f"use-after-write: a snapshot reference was written in place by {writer!r} and then used by "
        f"{use_site!r}; copy it before the write or take it again after"
    )
    if strict_mode():
        raise DonationViolation(msg)
    from ..robust import log_once

    log_once(f"donation_guard:{writer}->{use_site}", "[donation_guard] %s", msg)


def guard(site: str, *refs: Any) -> bool:
    """Check the snapshot references a call at ``site`` is about to use.
    True when they are intact (or the guard is off); a violation raises
    in strict mode and returns False in production mode, where the
    caller takes its copying path."""
    if not enabled():
        return True
    _register_site(site)
    clean = True
    for ref in refs:
        writer = check(ref)
        if writer is not None:
            _violation(writer, site)
            clean = False
    return clean


def stats() -> dict:
    """Counters of the guard: sites, live stamps, writes, violations."""
    with _lock:
        return {
            "sites": list(_sites),
            "tracked": len(_stamps),
            "written": dict(_written_total),
            "violations": dict(_violations_total),
        }


def _reset_for_tests() -> None:
    with _lock:
        for entry in _stamps.values():
            entry[4].detach()
        _stamps.clear()
        _writes.clear()
        _written_total.clear()
        _violations_total.clear()
        _sites.clear()
