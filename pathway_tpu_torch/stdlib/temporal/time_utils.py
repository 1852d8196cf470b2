"""Wall-clock utilities: live "now" stream and inactivity detection
(counterpart of ``pathway_tpu/stdlib/temporal/time_utils.py``; reference: python/pathway/stdlib/temporal/time_utils.py — utc_now:31,
inactivity_detection:52-130).
"""

from __future__ import annotations

import datetime
import time
from typing import Optional, Tuple

from ...internals import api_reducers as reducers
from ...internals.expression import ApplyExpression
from ...internals.schema import Schema
from ...internals.table import Table
from ...internals.thisclass import this

__all__ = ["utc_now", "inactivity_detection"]


class TimestampSchema(Schema):
    timestamp_utc: datetime.datetime


def utc_now(
    refresh_rate: datetime.timedelta = datetime.timedelta(seconds=60),
    max_ticks: Optional[int] = None,
) -> Table:
    """A live single-row table holding the current UTC time, refreshed every
    ``refresh_rate`` (reference: utc_now, time_utils.py:31).  ``max_ticks``
    bounds the stream (used by tests and bounded runs — the engine's batch
    mode drains when all sources finish)."""
    from ...io.python import ConnectorSubject, read

    class _NowSubject(ConnectorSubject):
        def run(self) -> None:
            n = 0
            while max_ticks is None or n < max_ticks:
                now = datetime.datetime.now(datetime.timezone.utc)
                self.next(timestamp_utc=now)
                n += 1
                if max_ticks is not None and n >= max_ticks:
                    break
                time.sleep(refresh_rate.total_seconds())

    return read(_NowSubject(), schema=TimestampSchema, name="utc_now")


def inactivity_detection(
    event_time_column,
    allowed_inactivity_period: datetime.timedelta,
    refresh_rate: datetime.timedelta = datetime.timedelta(seconds=1),
    instance=None,
    *,
    _now_table: Optional[Table] = None,
) -> Tuple[Table, Table]:
    """Flags inactivity gaps longer than ``allowed_inactivity_period`` and
    the first event resuming activity after each gap (reference:
    inactivity_detection, time_utils.py:52).

    Returns ``(inactivities, resumed_activities)``: tables with
    ``inactive_t`` / ``resumed_t`` (+ ``instance``) columns.  ``_now_table``
    overrides the clock stream (tests inject a deterministic one)."""
    events = event_time_column.table
    if instance is not None:
        events_t = events.select(t=event_time_column, instance=instance)
    else:
        events_t = events.select(
            t=event_time_column,
            instance=ApplyExpression(lambda _t: 0, None, args=(event_time_column,)),
        )

    now_t = _now_table if _now_table is not None else utc_now(refresh_rate)

    latest_t = events_t.groupby(this.instance).reduce(
        instance=this.instance, latest_t=reducers.max(this.t)
    )
    # every clock tick inspects the then-current latest event time; results
    # never retract (asof-now contract) so past alerts stay emitted
    joined = now_t.asof_now_join(latest_t).select(
        timestamp_utc=now_t.timestamp_utc,
        instance=latest_t.instance,
        latest_t=latest_t.latest_t,
    )
    import numpy as np

    # engine datetime columns are np.datetime64[ns]; plain timedelta doesn't
    # add to them, so normalise the allowed period once
    p64 = np.timedelta64(
        int(allowed_inactivity_period.total_seconds() * 1e9), "ns"
    )
    inactivities = (
        joined.filter(
            ApplyExpression(
                lambda latest, now, p=p64: (
                    latest is not None and latest + p < now
                ),
                None,
                args=(this.latest_t, this.timestamp_utc),
            )
        )
        .groupby(this.latest_t, this.instance)
        .reduce(instance=this.instance, inactive_t=this.latest_t)
    )

    latest_inactivity = inactivities.groupby(this.instance).reduce(
        instance=this.instance, inactive_t=reducers.latest(this.inactive_t)
    )
    resumed_activities = (
        events_t.asof_now_join(
            latest_inactivity, events_t.instance == latest_inactivity.instance
        )
        .select(
            t=events_t.t,
            instance=events_t.instance,
            inactive_t=latest_inactivity.inactive_t,
        )
        .filter(
            ApplyExpression(
                lambda t, inact: inact is not None and t > inact,
                None,
                args=(this.t, this.inactive_t),
            )
        )
        .groupby(this.inactive_t, this.instance)
        .reduce(instance=this.instance, resumed_t=reducers.min(this.t))
    )
    return inactivities, resumed_activities
