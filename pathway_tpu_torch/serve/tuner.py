"""The online knob tuner (counterpart of ``pathway_tpu/serve/tuner.py``):
a small controller that turns the knobs the observe plane's signals
describe, bounded by the knob table (``pathway_tpu_torch/config.py``).

- ``serve.coalesce_us`` — from queue wait against SLO headroom: a fast
  burn shrinks the window, ample headroom with the window binding (mean
  wait at least half the window) grows it;
- ``decode.step_bucket`` — from the generator's pack occupancy
  (``pathway_serve_pack_rows_total{site="generator"}``): mostly idle
  chunks halve the bucket, saturated ones double it.  The engine reads
  the knob when it is built, as the reference's does;
- ``cache.{result,embed,kv}_bytes`` — from each live tier's marginal hit
  rate (``cache/store.py`` ``live_tiers``): a tier evicting while hits
  climb grows, an idle tier well under budget shrinks; the new budget is
  written to the knob and to the live tier;
- ``observe.profile_sample`` — from the profiler's sample cost: above 1%
  of the tick's wall the fraction halves, below 0.1% it doubles back.

Every write goes through ``config.set`` (clamped; a ``static`` knob is
vetoed and counted), is journaled, and ``revert()`` restores the
environment / default layer, the profiler's live stride and the live
tier budgets.  The
``tuner.adjust`` fault site fires inside each tick: a fault reverts
everything and freezes the tuner.  The ``pathway_tuner_*`` families
count adjustments, vetoes and faults and gauge each knob's value.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

from .. import config, observe
from ..config import StaticKnobError
from ..robust import inject

__all__ = ["Tuner", "tuner_from_env"]

# knob the tuner writes for each cache tier name (store.py labels)
_TIER_KNOB = {
    "result": "cache.result_bytes",
    "embedding": "cache.embed_bytes",
    "generator_kv": "cache.kv_bytes",
}

_GROW = 1.25
_SHRINK = 0.8
_OCC_LOW = 0.5       # decode chunk occupancy below this: bucket too wide
_OCC_HIGH = 0.85     # above this: bucket saturating, room to widen
_PROFILE_OVERHEAD_HIGH = 0.01   # sampling cost > 1% of wall: back off
_PROFILE_OVERHEAD_LOW = 0.001   # < 0.1%: cheap enough to sample more
_PROFILE_SAMPLE_COST_S = 5e-6   # per-sample bookkeeping estimate


class Tuner:
    """Background controller over the table's ``dynamic`` knobs.
    ``tick()`` is the whole control loop; ``start()`` runs it on a daemon
    thread every ``interval_s``."""

    def __init__(self, interval_s: Optional[float] = None):
        if interval_s is None:
            interval_s = config.get("tuner.interval_s")
        self.interval_s = float(interval_s)
        # (knob, had_override, previous_override) in apply order
        self._journal: List[Tuple[str, bool, Any]] = []
        self._journaled: set = set()
        self._tier_bytes0: Dict[int, Tuple[Any, int]] = {}
        self._frozen = False
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # last-tick signal snapshots (deltas drive the controllers)
        self._last: Dict[str, Any] = {}
        self.stats = {"ticks": 0, "adjustments": 0, "vetoes": 0, "faults": 0}

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Tuner":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, name="pathway-tuner", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.interval_s + 5.0)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()

    @property
    def frozen(self) -> bool:
        return self._frozen

    # -- the control loop ----------------------------------------------------
    def tick(self) -> int:
        """One pass over every controller; returns adjustments applied.
        Never raises: a fault reverts every adjustment and freezes the
        tuner."""
        if self._frozen:
            return 0
        self.stats["ticks"] += 1
        try:
            inject.fire("tuner.adjust")
            n = self._tune_coalesce()
            n += self._tune_step_bucket()
            n += self._tune_cache_budgets()
            n += self._tune_profile_sample()
            return n
        except Exception:  # noqa: BLE001 - degrade, never fail: static config is the fallback
            self.stats["faults"] += 1
            observe.counter("pathway_tuner_faults_total").inc()
            self.revert()
            self._frozen = True
            return 0

    def propose(self, knob: str, value: Any, direction: str) -> bool:
        """The one write path of the controllers: clamp through
        ``config.set``, journal, count.  A ``static`` knob is vetoed
        (counted, False)."""
        try:
            current = config.overrides()
            had, before = knob in current, current.get(knob)
            applied = config.set(knob, value)
        except StaticKnobError:
            self.stats["vetoes"] += 1
            observe.counter("pathway_tuner_vetoed_total", knob=knob).inc()
            return False
        with self._lock:
            if knob not in self._journaled:
                self._journaled.add(knob)
                self._journal.append((knob, had, before))
        self.stats["adjustments"] += 1
        observe.counter("pathway_tuner_adjustments_total", knob=knob, direction=direction).inc()
        observe.gauge("pathway_tuner_value", knob=knob).set(float(applied))
        return True

    def revert(self) -> None:
        """Unwind every journaled override (newest first), put the
        profiler's live stride back on its knob, and put live tier
        budgets back to their original ``max_bytes``."""
        with self._lock:
            journal = list(reversed(self._journal))
            self._journal.clear()
            self._journaled.clear()
            tier_bytes0 = dict(self._tier_bytes0)
            self._tier_bytes0.clear()
        for knob, had, before in journal:
            if had:
                config.set(knob, before)
            else:
                config.clear_override(knob)
        if any(knob == "observe.profile_sample" for knob, _had, _before in journal):
            from ..observe import profile

            profile.set_sample(config.get("observe.profile_sample"))  # the live stride follows the knob back
        for ref, max_bytes in tier_bytes0.values():
            tier = ref()
            if tier is not None:
                tier.max_bytes = max_bytes

    # -- signals -------------------------------------------------------------
    def _delta(self, key: str, current: float) -> float:
        prev = self._last.get(key, 0.0)
        self._last[key] = current
        return current - prev

    def _queue_wait_mean_s(self) -> Optional[float]:
        """Mean serve queue wait over the last tick (histogram delta), or
        None when no request landed."""
        _, sum_ns, n = observe.histogram("pathway_serve_queue_wait_seconds").snapshot()
        d_sum = self._delta("qw_sum_ns", float(sum_ns))
        d_n = self._delta("qw_n", float(n))
        if d_n <= 0:
            return None
        return (d_sum / d_n) * 1e-9

    def _slo_fast_burn(self) -> float:
        """Worst fast-window burn rate across the objectives with events."""
        from ..observe import slo

        try:
            report = slo.engine().evaluate()
        except Exception:  # noqa: BLE001 - an unreadable SLO reads as headroom
            return 0.0
        worst = 0.0
        for row in (report.get("slos") or {}).values():
            fast = (row.get("windows") or {}).get("fast") or {}
            if fast.get("events"):
                worst = max(worst, float(fast.get("burn_rate") or 0.0))
        return worst

    def _occupancy(self, site: str) -> Optional[float]:
        """real / padded pack rows of ``site`` over the last tick."""
        real = observe.counter("pathway_serve_pack_rows_total", site=site, kind="real").value
        padded = observe.counter("pathway_serve_pack_rows_total", site=site, kind="padded").value
        d_real = self._delta(f"occ_real_{site}", float(real))
        d_padded = self._delta(f"occ_padded_{site}", float(padded))
        if d_padded <= 0:
            return None
        return d_real / d_padded

    # -- controllers ---------------------------------------------------------
    def _tune_coalesce(self) -> int:
        window_us = float(config.get("serve.coalesce_us"))
        mean_wait = self._queue_wait_mean_s()
        burn = self._slo_fast_burn()
        if burn >= 1.0:
            # the latency budget burns: trade batching for latency,
            # floored at 50 us (below it coalescing is off in practice)
            if window_us <= 50.0:
                return 0
            return int(self.propose("serve.coalesce_us", max(window_us * 0.7, 50.0), "down"))
        if mean_wait is not None and burn < 0.5 and window_us > 0 and mean_wait * 1e6 >= 0.5 * window_us:
            # headroom, and the window itself is the binding wait
            return int(self.propose("serve.coalesce_us", max(window_us * 1.3, 100.0), "up"))
        return 0

    def _tune_step_bucket(self) -> int:
        occ = self._occupancy("generator")
        if occ is None:
            return 0
        bucket = int(config.get("decode.step_bucket"))
        if occ < _OCC_LOW and bucket > 1:
            return int(self.propose("decode.step_bucket", bucket // 2, "down"))
        if occ > _OCC_HIGH:
            return int(self.propose("decode.step_bucket", bucket * 2, "up"))
        return 0

    def _tune_cache_budgets(self) -> int:
        from ..cache.store import live_tiers

        n = 0
        for tier in live_tiers():
            knob = _TIER_KNOB.get(tier.tier)
            if knob is None:
                continue
            tag = f"tier_{tier.labels.get('id', tier.tier)}"
            d_hits = self._delta(f"{tag}_hits", float(tier.stats["hits"]))
            d_evict = self._delta(f"{tag}_evict", float(tier.stats["evictions"]))
            d_miss = self._delta(f"{tag}_miss", float(tier.stats["misses"]))
            budget = int(config.get(knob))
            direction = None
            if d_evict > 0 and d_hits > 0:
                # evicting while hits climb: the budget binds
                direction, factor = "up", _GROW
            elif d_hits <= 0 and d_miss <= 0 and tier.bytes < budget // 2 and budget > 1 << 20:
                # an idle tier holding a large budget: give it back
                direction, factor = "down", _SHRINK
            if direction is None:
                continue
            if self.propose(knob, int(budget * factor), direction):
                key = id(tier)
                if key not in self._tier_bytes0:
                    self._tier_bytes0[key] = (weakref.ref(tier), tier.max_bytes)
                tier.max_bytes = int(config.get(knob))
                n += 1
        return n

    def _tune_profile_sample(self) -> int:
        from ..observe import profile

        samples = sum(float(row.get("samples", 0)) for row in profile.profile_stats().values())
        d_samples = self._delta("profile_samples", samples)
        overhead = (d_samples * _PROFILE_SAMPLE_COST_S) / max(self.interval_s, 1e-3)
        fraction = float(config.get("observe.profile_sample"))
        if overhead > _PROFILE_OVERHEAD_HIGH and fraction > 0.0:
            if self.propose("observe.profile_sample", fraction * 0.5, "down"):
                profile.set_sample(config.get("observe.profile_sample"))
                return 1
        elif 0.0 < overhead < _PROFILE_OVERHEAD_LOW and d_samples > 0 and fraction < 1.0:
            if self.propose("observe.profile_sample", min(fraction * 2.0, 1.0), "up"):
                profile.set_sample(config.get("observe.profile_sample"))
                return 1
        return 0


def tuner_from_env() -> Optional[Tuner]:
    """A started background tuner when ``PATHWAY_TUNER=1`` (interval from
    ``PATHWAY_TUNER_INTERVAL_S``); None otherwise (static config)."""
    if not config.get("tuner.enabled"):
        return None
    return Tuner().start()
