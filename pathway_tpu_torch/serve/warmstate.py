"""Durable warm-state snapshots: replica bring-up without re-ingest
(counterpart of ``pathway_tpu/serve/warmstate.py``).

A replica's warm state is what its cold path would recompute before
serving: the IVF layout (``ops/ivf.py`` ``warm_state``), the forward
index's row buckets (``index/forward.py``) and the result / embedding
cache tiers.  ``WarmStateManager`` writes generation-stamped snapshots
of those components to a persistence backend and restores them at
bring-up.  The snapshot format is the reference's: a snapshot written by
either package restores into the other.

- Chunked, CRC-framed blobs: each section pickles to one byte string,
  split into ``warmstate.chunk_bytes`` chunks, each framed
  (``persistence/framing.py``); a torn write or bit rot fails the scan
  on restore and is never installed.
- Manifest last: section blobs first, then the ``MANIFEST`` key (chunk
  counts, byte totals, per-section generations); without it a snapshot
  is invisible.  Pruning deletes the manifest first.
- Degrade, never fail: a faulted snapshot (site ``warmstate.snapshot``,
  backend error) is a skipped cadence counted on
  ``pathway_warmstate_snapshot_skipped_total``.  A failed restore (site
  ``warmstate.restore``, CRC, truncation, missing blob, unpickle,
  install mismatch) is counted per kind on
  ``pathway_warmstate_restore_failures_total{kind}`` and falls back to
  the next-older snapshot, then to a flagged cold start.
- Bit identity: a restored component carries the writer's generation
  and layout, so it serves what the writer served.

``agree_generation`` runs the coordinator's generation through
``parallel/distributed.broadcast_obj`` (single-process in the port); a
faulted broadcast is flagged local-only agreement, never a hung bring-up.
"""

from __future__ import annotations

import gc
import io
import pickle
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import config, observe
from ..cache.keys import normalize_generation
from ..parallel import distributed as dist
from ..persistence.framing import ViewStream, frame, frame_all, scan, scan_views
from ..robust import inject, log_once

__all__ = ["RestoreReport", "WarmStateManager"]

_MANIFEST = "MANIFEST"

# counter caches (tiny label sets, same idiom as robust/retry.py)
_restore_fail_counters: Dict[str, observe.Counter] = {}


def _count_restore_failure(kind: str) -> None:
    c = _restore_fail_counters.get(kind)
    if c is None:
        c = _restore_fail_counters[kind] = observe.counter(
            "pathway_warmstate_restore_failures_total", kind=kind
        )
    c.inc()


_snapshots_total = observe.counter("pathway_warmstate_snapshots_total")
_snapshot_skipped = observe.counter("pathway_warmstate_snapshot_skipped_total")
_restores_warm = observe.counter(
    "pathway_warmstate_restores_total", outcome="warm"
)
_restores_cold = observe.counter(
    "pathway_warmstate_restores_total", outcome="cold"
)


class RestoreReport:
    """What a bring-up restore actually did — the FLAG half of the
    degrade-never-fail contract.  ``restored`` False means cold start:
    the caller re-ingests (and the failure kinds were counted)."""

    __slots__ = ("restored", "snapshot", "generations", "sections", "reasons")

    def __init__(
        self,
        restored: bool,
        snapshot: Optional[str],
        generations: Dict[str, int],
        sections: Dict[str, str],
        reasons: Tuple[str, ...],
    ):
        self.restored = restored
        self.snapshot = snapshot  # key prefix of the snapshot installed
        self.generations = generations  # section -> restored generation
        self.sections = sections  # section -> "restored" | "failed:<kind>"
        self.reasons = reasons  # degradation reasons, deduped, ordered

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"RestoreReport(restored={self.restored}, "
            f"snapshot={self.snapshot!r}, sections={self.sections})"
        )


class WarmStateManager:
    """Snapshot and restore of named components.

    ``components`` maps a section name to any object exposing the
    warm-state pair — ``warm_state() -> dict`` (picklable) and
    ``load_warm_state(state)`` (raises on mismatch).  The IVF index,
    the forward index, and both cache tiers all implement it; a serve
    stack registers whichever subset it owns::

        mgr = WarmStateManager(backend, name="replica0", components={
            "ivf": index, "forward": fwd, "result_cache": rc,
        })
        mgr.snapshot()            # on the maintenance cadence
        report = mgr.restore()    # at bring-up; .restored False = cold

    Thread-safety: one lock serializes snapshot/restore/prune — the
    cadence thread and an operator-triggered snapshot must not
    interleave their key writes.
    """

    def __init__(
        self,
        backend,
        *,
        name: str = "default",
        prefix: str = "warmstate",
        components: Optional[Dict[str, Any]] = None,
        chunk_bytes: Optional[int] = None,
        interval_s: Optional[float] = None,
        keep: Optional[int] = None,
    ):
        self.backend = backend
        self.name = str(name)
        self.prefix = str(prefix).strip("/")
        self.components: Dict[str, Any] = dict(components or {})
        self.chunk_bytes = int(
            chunk_bytes
            if chunk_bytes is not None
            else config.get("warmstate.chunk_bytes")
        )
        self.interval_s = float(
            interval_s
            if interval_s is not None
            else config.get("warmstate.interval_s")
        )
        self.keep = int(
            keep if keep is not None else config.get("warmstate.keep")
        )
        self._lock = threading.Lock()
        self._last_snapshot_mono: Optional[float] = None
        self.stats: Dict[str, int] = {
            "snapshots": 0,
            "snapshot_skipped": 0,
            "restores_warm": 0,
            "restores_cold": 0,
            "pruned": 0,
        }

    # -- key layout ----------------------------------------------------------
    def _root(self) -> str:
        return f"{self.prefix}/{self.name}"

    def _snap_prefix(self, seq: int) -> str:
        return f"{self._root()}/snap-{seq:012d}"

    def _list_seqs(self) -> List[int]:
        """Committed snapshot sequence numbers (manifest present),
        ascending.  Uncommitted snapshot directories are invisible."""
        root = self._root() + "/"
        seqs = []
        for key in self.backend.list_keys(root):
            rel = key[len(root):]
            parts = rel.split("/")
            if len(parts) == 2 and parts[1] == _MANIFEST:
                snap = parts[0]
                if snap.startswith("snap-"):
                    try:
                        seqs.append(int(snap[len("snap-"):]))
                    except ValueError:
                        continue
        return sorted(set(seqs))

    # -- snapshot ------------------------------------------------------------
    def snapshot(self, deadline=None) -> Optional[str]:
        """Write one generation-stamped snapshot of every registered
        component.  Returns the snapshot key prefix, or None when the
        cadence was SKIPPED (chaos site ``warmstate.snapshot``, backend
        error) — counted, logged once, never raised: durability must
        not fail a serve tier."""
        with self._lock:
            try:
                inject.fire("warmstate.snapshot", deadline=deadline)
                return self._snapshot_locked()
            except Exception as exc:
                _snapshot_skipped.inc()
                self.stats["snapshot_skipped"] += 1
                log_once(
                    f"warmstate.snapshot:{type(exc).__name__}",
                    "warm-state snapshot skipped (%r); next cadence retries",
                    exc,
                )
                return None

    def _snapshot_locked(self) -> str:
        seqs = self._list_seqs()
        seq = (seqs[-1] + 1) if seqs else 0
        prefix = self._snap_prefix(seq)
        manifest: Dict[str, Any] = {"seq": seq, "sections": {}}
        for section, component in self.components.items():
            state = component.warm_state()
            payload = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
            view = memoryview(payload)  # chunks without copies of the payload
            chunks = [
                view[o: o + self.chunk_bytes]
                for o in range(0, max(len(payload), 1), self.chunk_bytes)
            ]
            blob = frame_all(chunks)
            self.backend.put(f"{prefix}/{section}", blob)
            manifest["sections"][section] = {
                "chunks": len(chunks),
                "bytes": len(payload),
                "generation": (
                    int(state["generation"])
                    if isinstance(state, dict) and "generation" in state
                    else None
                ),
            }
        # manifest LAST: its presence is the commit marker — a crash
        # before this put leaves the snapshot invisible to restore
        self.backend.put(
            f"{prefix}/{_MANIFEST}",
            frame(pickle.dumps(manifest, protocol=pickle.HIGHEST_PROTOCOL)),
        )
        _snapshots_total.inc()
        self.stats["snapshots"] += 1
        self._last_snapshot_mono = time.monotonic()
        self._prune_locked()
        return prefix

    def maybe_snapshot(self, deadline=None) -> Optional[str]:
        """Cadence entry (call from a maintenance loop): snapshots when
        ``PATHWAY_WARMSTATE_INTERVAL_S`` has elapsed since the last one
        (0 = manual only)."""
        if self.interval_s <= 0:
            return None
        last = self._last_snapshot_mono
        if last is not None and time.monotonic() - last < self.interval_s:
            return None
        return self.snapshot(deadline=deadline)

    def _prune_locked(self) -> None:
        """Best-effort: drop all but the newest ``keep`` committed
        snapshots (manifest deleted FIRST so a partially pruned snapshot
        is invisible, mirroring the commit order)."""
        seqs = self._list_seqs()
        for seq in seqs[: max(0, len(seqs) - self.keep)]:
            prefix = self._snap_prefix(seq)
            self.backend.delete(f"{prefix}/{_MANIFEST}")
            for key in self.backend.list_keys(prefix + "/"):
                self.backend.delete(key)
            self.stats["pruned"] += 1

    # -- restore ---------------------------------------------------------------
    def restore(self, deadline=None) -> RestoreReport:
        """Bring-up: install the newest intact snapshot into the
        registered components.  Walks snapshots newest→oldest; every
        failure (CRC, truncation, missing section, unpickle, install
        mismatch, chaos site ``warmstate.restore``) is counted on
        ``pathway_warmstate_restore_failures_total{kind}`` and falls
        back to the next-older snapshot.  When none restores, the
        report degrades to a FLAGGED cold start (``restored=False``) —
        the caller re-ingests; a wrong index is never installed.

        An install failure mid-snapshot may leave earlier sections
        installed; the next-older attempt re-installs EVERY section, so
        any successful restore is internally consistent.  Only the
        terminal cold-start path can leave a partial install, and there
        the caller's re-ingest rebuilds all components anyway."""
        reasons: List[str] = []
        try:
            inject.fire("warmstate.restore", deadline=deadline)
        except Exception as exc:
            _count_restore_failure("injected")
            reasons.append("warm_restore_failed")
            log_once(
                f"warmstate.restore:{type(exc).__name__}",
                "warm-state restore degraded to cold start (%r)",
                exc,
            )
            _restores_cold.inc()
            self.stats["restores_cold"] += 1
            return RestoreReport(False, None, {}, {}, tuple(reasons))
        with self._lock:
            for seq in reversed(self._list_seqs()):
                prefix = self._snap_prefix(seq)
                ok, generations, sections = self._restore_one(prefix)
                if ok:
                    _restores_warm.inc()
                    self.stats["restores_warm"] += 1
                    return RestoreReport(
                        True, prefix, generations, sections, tuple(reasons)
                    )
                reasons.append("warm_restore_failed")
        _restores_cold.inc()
        self.stats["restores_cold"] += 1
        if not reasons:
            # nothing durable yet — a first boot is a clean cold start,
            # not a failure (nothing counted)
            return RestoreReport(False, None, {}, {}, ())
        return RestoreReport(False, None, {}, {}, tuple(dict.fromkeys(reasons)))

    def _restore_one(
        self, prefix: str
    ) -> Tuple[bool, Dict[str, int], Dict[str, str]]:
        """Try one committed snapshot: decode EVERY section first (CRC +
        chunk count + unpickle), install second — a corrupt blob is
        rejected before any component mutates."""
        manifest = self._read_manifest(prefix)
        if manifest is None:
            _count_restore_failure("manifest")
            return False, {}, {}
        # the decode makes many objects and no cycles: a paused collector
        # spares the full collections over the live heap it would trigger
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            return self._decode_install(prefix, manifest)
        finally:
            if gc_was_on:
                gc.enable()

    def _decode_install(
        self, prefix: str, manifest: Dict[str, Any]
    ) -> Tuple[bool, Dict[str, int], Dict[str, str]]:
        sections: Dict[str, str] = {}
        generations: Dict[str, int] = {}
        decoded: Dict[str, Any] = {}
        for section in self.components:
            entry = manifest["sections"].get(section)
            if entry is None:
                _count_restore_failure("missing")
                sections[section] = "failed:missing"
                return False, {}, sections
            blob = self.backend.get_view(f"{prefix}/{section}")
            if blob is None:
                _count_restore_failure("missing")
                sections[section] = "failed:missing"
                return False, {}, sections
            payloads, intact = scan_views(blob)
            if not intact or len(payloads) != int(entry["chunks"]):
                _count_restore_failure("crc" if not intact else "truncated")
                sections[section] = "failed:crc"
                return False, {}, sections
            if sum(len(p) for p in payloads) != int(entry["bytes"]):
                _count_restore_failure("truncated")
                sections[section] = "failed:truncated"
                return False, {}, sections
            try:
                # unpickled across the chunk views: no joined copy of the payload
                decoded[section] = pickle.load(io.BufferedReader(ViewStream(payloads), 1 << 20))
            except Exception:
                _count_restore_failure("unpickle")
                sections[section] = "failed:unpickle"
                return False, {}, sections
        for section, component in self.components.items():
            try:
                component.load_warm_state(decoded[section])
            except Exception as exc:
                _count_restore_failure("install")
                sections[section] = "failed:install"
                log_once(
                    f"warmstate.install:{section}:{type(exc).__name__}",
                    "warm-state install failed for %r (%r); "
                    "trying older snapshot",
                    section,
                    exc,
                )
                return False, {}, sections
            sections[section] = "restored"
            gen = manifest["sections"][section].get("generation")
            if gen is not None:
                generations[section] = int(gen)
        return True, generations, sections

    def _read_manifest(self, prefix: str) -> Optional[Dict[str, Any]]:
        blob = self.backend.get(f"{prefix}/{_MANIFEST}")
        if blob is None:
            return None
        payloads, intact = scan(blob)
        if not intact or len(payloads) != 1:
            return None
        try:
            manifest = pickle.loads(payloads[0])
        except Exception:
            return None
        if not isinstance(manifest, dict) or "sections" not in manifest:
            return None
        return manifest

    # -- cross-host agreement --------------------------------------------------
    def agree_generation(
        self, local_gen, *, tag: str, deadline=None
    ):
        """Replica-group index-generation agreement: the coordinator's
        generation broadcast to every host (``name`` is unique per
        bring-up ``tag``).  Returns ``(generation, agreed)`` —
        ``agreed`` False means the control plane DEGRADED (counted on
        ``pathway_dist_degraded_total{site="broadcast"}``) and this
        host proceeds on its local generation, flagged by the caller;
        bring-up is never hung on the coordination service.

        ``local_gen`` may be a scalar (replica fleet) or a generation
        VECTOR — one entry per partition (``cache/keys.py``
        ``normalize_generation`` spells both) — so a partitioned fleet
        agrees on every partition's generation at once and front-side
        cache keys derived from the agreed vector stay sound fleet-wide."""
        local = normalize_generation(local_gen)
        value = dist.broadcast_obj(
            local if dist.is_coordinator() else None,
            name=f"warmstate/{self.name}/gen/{tag}",
            deadline=deadline,
        )
        if value is None:
            return local, False
        value = normalize_generation(value)
        return value, bool(value == local)
