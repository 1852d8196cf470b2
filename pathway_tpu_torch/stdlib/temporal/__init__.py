"""pw.temporal of the port — windows, temporal joins, behaviors
(counterpart of ``pathway_tpu/stdlib/temporal``; reference: python/pathway/stdlib/temporal/ — _window.py:42-865,
_interval_join.py, _asof_join.py, _window_join.py, temporal_behavior.py).

Windows desugar to key extension + groupby (the reference's own lowering:
window instance becomes part of the group key, _window.py:865).  Interval and
window joins desugar to bucket-explosion (flatten) + equi-join + bound filter
— fully incremental because each stage is.
"""

from __future__ import annotations

import datetime
import math
from dataclasses import dataclass
from typing import Any, Optional, Union

from ...internals import dtype as dt
from ...internals.expression import (
    ApplyExpression,
    ColumnExpression,
    MethodCallExpression,
    smart_coerce,
)
from ...internals.table import JoinMode, Table
from ...internals.thisclass import this
from .temporal_behavior import Behavior, CommonBehavior, ExactlyOnceBehavior, common_behavior, exactly_once_behavior

__all__ = [
    "Window",
    "tumbling",
    "sliding",
    "session",
    "intervals_over",
    "windowby",
    "interval",
    "interval_join",
    "interval_join_inner",
    "interval_join_left",
    "interval_join_right",
    "interval_join_outer",
    "asof_join",
    "asof_join_left",
    "asof_join_right",
    "asof_join_outer",
    "asof_now_join",
    "window_join",
    "window_join_inner",
    "window_join_left",
    "Behavior",
    "CommonBehavior",
    "ExactlyOnceBehavior",
    "common_behavior",
    "exactly_once_behavior",
]


def _num(v: Any) -> float:
    if isinstance(v, datetime.timedelta):
        return v.total_seconds()
    if isinstance(v, (datetime.datetime,)):
        return v.timestamp()
    return v


class Window:
    pass


@dataclass
class TumblingWindow(Window):
    duration: Any
    origin: Any = None

    def assign(self, t: Any):
        d = _num(self.duration)
        o = _num(self.origin) if self.origin is not None else 0.0
        start = math.floor((_num(t) - o) / d) * d + o
        return [(start, start + d)]


@dataclass
class SlidingWindow(Window):
    hop: Any
    duration: Optional[Any] = None
    ratio: Optional[int] = None
    origin: Any = None

    def assign(self, t: Any):
        hop = _num(self.hop)
        dur = _num(self.duration) if self.duration is not None else hop * self.ratio
        o = _num(self.origin) if self.origin is not None else 0.0
        tv = _num(t)
        out = []
        # windows [s, s+dur) with s = o + k*hop containing tv, largest k first
        k = math.floor((tv - o) / hop)
        while True:
            s = o + k * hop
            if s + dur <= tv:
                break
            out.append((s, s + dur))
            k -= 1
        return list(reversed(out))


@dataclass
class SessionWindow(Window):
    predicate: Optional[Any] = None
    max_gap: Optional[Any] = None


@dataclass
class IntervalsOverWindow(Window):
    at: Any
    lower_bound: Any
    upper_bound: Any
    is_outer: bool = True


def tumbling(duration: Any, origin: Any = None) -> TumblingWindow:
    """(reference: _window.py tumbling)"""
    return TumblingWindow(duration=duration, origin=origin)


def sliding(
    hop: Any, duration: Optional[Any] = None, ratio: Optional[int] = None, origin: Any = None
) -> SlidingWindow:
    return SlidingWindow(hop=hop, duration=duration, ratio=ratio, origin=origin)


def session(*, predicate=None, max_gap=None) -> SessionWindow:
    return SessionWindow(predicate=predicate, max_gap=max_gap)


def intervals_over(*, at, lower_bound, upper_bound, is_outer: bool = True) -> IntervalsOverWindow:
    return IntervalsOverWindow(at, lower_bound, upper_bound, is_outer)


def _apply_behavior(flat, behavior):
    """Desugar a window behavior into a time gate on the flattened
    (window-assigned) rows (reference lowering: _window.py behaviors →
    buffer/forget engine ops, time_column.rs:380,677):

    - ``CommonBehavior.delay d``   — hold each row until the stream clock
      passes ``window_start + d`` (postpone).
    - ``CommonBehavior.cutoff c``  — drop rows once the clock passed
      ``window_end + c`` (ignore_late); the paired sweeper forgets group
      state past the same threshold, and with ``keep_results=False`` also
      retracts the frozen result rows.
    - ``ExactlyOnceBehavior(shift s)`` — release == expire ==
      ``window_end + s``: every window emits exactly once, then freezes.

    Returns (gated_table, gate_operator | None, expire_of(group_values) | None).
    """
    if behavior is None:
        return flat, None, None
    if isinstance(behavior, ExactlyOnceBehavior):
        shift = _num(behavior.shift) if behavior.shift is not None else 0.0
        thr = ApplyExpression(
            lambda e, s=shift: e + s, dt.FLOAT, args=(this._pw_window_end,)
        )
        gated, gate = flat._time_gate(this._pw_time, thr, thr)
        return gated, gate, (lambda end, s=shift: end + s)
    if isinstance(behavior, CommonBehavior):
        release = expire = expire_of = None
        if behavior.delay is not None:
            d = _num(behavior.delay)
            release = ApplyExpression(
                lambda st, d=d: st + d, dt.FLOAT, args=(this._pw_window_start,)
            )
        if behavior.cutoff is not None:
            c = _num(behavior.cutoff)
            expire = ApplyExpression(
                lambda e, c=c: e + c, dt.FLOAT, args=(this._pw_window_end,)
            )
            expire_of = lambda end, c=c: end + c  # noqa: E731
        if release is None and expire is None:
            return flat, None, None
        gated, gate = flat._time_gate(this._pw_time, release, expire)
        return gated, gate, expire_of
    raise TypeError(f"unsupported window behavior: {behavior!r}")


def _window_end_index(gop) -> int:
    """Position of the window-end value inside the groupby's group-values
    tuple — the reduce lowering may fold/rename grouping columns, so locate
    it by the underlying column reference, not by position."""
    from ...internals.expression import ColumnReference

    for i, (name, e) in enumerate(gop.grouping_expressions.items()):
        if name == "_pw_window_end" or (
            isinstance(e, ColumnReference) and e.name == "_pw_window_end"
        ):
            return i
    raise RuntimeError(
        "windowed groupby lost its _pw_window_end grouping column"
    )


def _groupby_sweeper(gop, expire_of, retract: bool):
    """Sweep hook forgetting expired window groups (reference
    Graph::forget/freeze, src/engine/graph.rs:776-812).  State for windows
    whose expiry the (lagged) clock passed is dropped — streaming state stays
    bounded — and with ``retract`` the frozen results are withdrawn too
    (keep_results=False)."""
    from ...engine.delta import Delta

    end_idx = _window_end_index(gop)

    def sweep(clock):
        expired = [
            gk
            for gk, entry in gop._groups.items()
            if expire_of(entry[1][end_idx]) <= clock
        ]
        if not expired:
            return None
        rows = []
        for gk in expired:
            del gop._groups[gk]
            if retract:
                old = gop.output.store.get(gk)
                if old is not None:
                    rows.append((gk, -1, old))
        if not rows:
            return None
        return (gop.output, Delta.from_rows(gop.output.column_names, rows))

    return sweep


class WindowedTable:
    """Result of windowby(): a GroupedTable whose group key includes the
    window instance; exposes _pw_window_start/_pw_window_end columns."""

    def __init__(self, table: Table, key_expr, window: Window, instance=None, behavior=None):
        self.table = table
        self.key_expr = key_expr
        self.window = window
        self.instance = instance
        self.behavior = behavior

    def reduce(self, *args, **kwargs) -> Table:
        win = self.window
        if isinstance(win, (TumblingWindow, SlidingWindow)):
            flat = self.table.with_columns(
                _pw_window=ApplyExpression(
                    win.assign, dt.ANY, args=(self.key_expr,)
                ),
                _pw_time=self.key_expr,
            ).flatten(this._pw_window)
            flat = flat.with_columns(
                _pw_window_start=ApplyExpression(
                    lambda w: w[0], dt.FLOAT, args=(this._pw_window,)
                ),
                _pw_window_end=ApplyExpression(
                    lambda w: w[1], dt.FLOAT, args=(this._pw_window,)
                ),
            )
            flat, gate, expire_of = _apply_behavior(flat, self.behavior)
            grouping = [flat._pw_window_start, flat._pw_window_end]
            if self.instance is not None:
                inst = self.instance
                if isinstance(inst, ColumnExpression):
                    grouping.append(inst)
            grouped = flat.groupby(*grouping)
            out = grouped.reduce(*args, **kwargs)
            if gate is not None and expire_of is not None:
                gate.sweep_hooks.append(
                    _groupby_sweeper(
                        out._engine_table.producer,
                        expire_of,
                        retract=isinstance(self.behavior, CommonBehavior)
                        and not self.behavior.keep_results,
                    )
                )
            return out
        if isinstance(win, SessionWindow):
            return self._reduce_session(*args, **kwargs)
        if isinstance(win, IntervalsOverWindow):
            return self._reduce_intervals_over(*args, **kwargs)
        raise NotImplementedError(type(win))

    def _reduce_session(self, *args, **kwargs) -> Table:
        from .session_windows import reduce_session

        return reduce_session(self, *args, **kwargs)

    def _reduce_intervals_over(self, *args, **kwargs) -> Table:
        win = self.window
        lb, ub = _num(win.lower_bound), _num(win.upper_bound)
        at_table_refs = [
            r for r in smart_coerce(win.at)._column_refs() if isinstance(r.table, Table)
        ]
        if not at_table_refs:
            raise ValueError("intervals_over: `at` must be a column reference")
        at_table = at_table_refs[0].table
        # data rows join at-locations via bucket explosion of the at side
        B = ub - lb if ub > lb else 1.0

        def buckets_of_at(t):
            t = _num(t)
            lo = math.floor((t + lb) / B)
            hi = math.floor((t + ub) / B)
            return [b for b in range(lo, hi + 1)]

        def bucket_of_data(t):
            return math.floor(_num(t) / B)

        at_flat = at_table.select(_pw_at=smart_coerce(win.at)).with_columns(
            _pw_bucket=ApplyExpression(buckets_of_at, dt.ANY, args=(this._pw_at,))
        ).flatten(this._pw_bucket)
        data = self.table.with_columns(
            _pw_bucket=ApplyExpression(bucket_of_data, dt.INT, args=(self.key_expr,)),
            _pw_key=self.key_expr,
        )
        # inner-join + exact bound filter: aggregates only see real rows
        joined = at_flat.join(data, at_flat._pw_bucket == data._pw_bucket)
        cols = {n: getattr(data, n) for n in self.table.column_names}
        sel = joined.select(
            _pw_window_location=at_flat._pw_at, _pw_key=data._pw_key, **cols
        )
        filtered = sel.filter(
            ApplyExpression(
                lambda at, t: t is not None
                and _num(at) + lb <= _num(t) <= _num(at) + ub,
                dt.BOOL,
                args=(this._pw_window_location, this._pw_key),
            )
        )
        grouped = filtered.groupby(filtered._pw_window_location)
        matched = grouped.reduce(*args, **kwargs)
        if not win.is_outer:
            return matched
        # outer: at-locations with no data still appear, aggregates = None
        # (reference intervals_over is_outer semantics, _window.py)
        at_keyed = at_table.select(_pw_at=smart_coerce(win.at)).with_id_from(
            this._pw_at
        )
        empty = at_keyed.difference(matched)
        out_exprs: dict = {}
        for arg in args:
            out_exprs[arg.name] = arg
        out_exprs.update(kwargs)
        from ...internals.expression import ColumnConstExpression, ColumnReference

        padded_exprs = {}
        for name, e in out_exprs.items():
            if isinstance(e, ColumnReference) and e.name == "_pw_window_location":
                padded_exprs[name] = empty._pw_at
            else:
                padded_exprs[name] = ColumnConstExpression(None)
        padded = empty.select(**padded_exprs)
        return matched.concat(padded)


def windowby(
    table: Table,
    time_expr,
    *,
    window: Window,
    instance=None,
    behavior: Optional[Behavior] = None,
    **kwargs,
) -> WindowedTable:
    """(reference: _window.py:865 windowby)"""
    return WindowedTable(table, smart_coerce(time_expr), window, instance, behavior)


# ---------------------------------------------------------------------------
# interval joins (reference: _interval_join.py)
# ---------------------------------------------------------------------------
@dataclass
class Interval:
    lower_bound: Any
    upper_bound: Any


def interval(lower_bound, upper_bound) -> Interval:
    return Interval(lower_bound, upper_bound)


def _interval_join_impl(
    left: Table,
    right: Table,
    left_time,
    right_time,
    itv: Interval,
    *on,
    how: str = JoinMode.INNER,
    behavior: Optional[Behavior] = None,
) -> "IntervalJoinResult":
    return IntervalJoinResult(
        left, right, left_time, right_time, itv, on, how, behavior=behavior
    )


class IntervalJoinResult:
    """left.t + lb <= right.t <= left.t + ub
    — bucket-explode left over the buckets covering its interval, equi-join on
    bucket (+ extra on conditions), filter exact bounds; LEFT/RIGHT/OUTER pad
    unmatched rows with None via key-difference against the matched set
    (reference: stdlib/temporal/_interval_join.py)."""

    def __init__(self, left, right, left_time, right_time, itv, on, how, behavior=None):
        from ...internals.expression import IdExpression

        lb, ub = _num(itv.lower_bound), _num(itv.upper_bound)
        if ub < lb:
            raise ValueError("interval: upper bound below lower bound")
        B = max(ub - lb, 1e-9)

        def left_buckets(t):
            t = _num(t)
            lo = math.floor((t + lb) / B)
            hi = math.floor((t + ub) / B)
            return list(range(lo, hi + 1))

        def right_bucket(t):
            return math.floor(_num(t) / B)

        lflat = left.with_columns(
            _pw_lbuckets=ApplyExpression(left_buckets, dt.ANY, args=(left_time,)),
            _pw_lt=smart_coerce(left_time),
            _pw_lid=IdExpression(None),
        ).flatten(this._pw_lbuckets)
        rtab = right.with_columns(
            _pw_rbucket=ApplyExpression(right_bucket, dt.INT, args=(right_time,)),
            _pw_rt=smart_coerce(right_time),
            _pw_rid=IdExpression(None),
        )
        self._gated = False
        if behavior is not None:
            gated_pair = self._gate_sides(lflat, rtab, behavior, lb, ub)
            self._gated = gated_pair != (lflat, rtab)
            lflat, rtab = gated_pair
        conds = [lflat._pw_lbuckets == rtab._pw_rbucket]
        for cond in on:
            lref, rref = cond._left, cond._right
            conds.append(getattr(lflat, lref.name) == getattr(rtab, rref.name))
        self._join = lflat.join(rtab, *conds, how=JoinMode.INNER)
        self._lflat = lflat
        self._rtab = rtab
        self._left = left
        self._right = right
        self._lb, self._ub = lb, ub
        self._how = how

    @staticmethod
    def _gate_sides(lflat, rtab, behavior, lb, ub):
        """Behavior on an interval join: both inputs share one clock
        (reference: the global input frontier); ``delay`` holds a row until
        clock >= t + delay, ``cutoff`` drops a row once it can no longer
        match any on-time opposite row — left expires at t + ub + cutoff,
        right at t - lb + cutoff (reference _interval_join.py behavior
        thresholds over time_column.rs buffers)."""
        if not isinstance(behavior, CommonBehavior):
            raise TypeError(
                f"interval_join supports common_behavior only, got {behavior!r}"
            )
        from ...engine.operators.time_gate import SharedClock

        d = _num(behavior.delay) if behavior.delay is not None else None
        c = _num(behavior.cutoff) if behavior.cutoff is not None else None
        if d is None and c is None:
            return lflat, rtab
        clock = SharedClock()

        def gate(tab, tref, expire_offset):
            time_e = ApplyExpression(lambda t: _num(t), dt.FLOAT, args=(tref,))
            rel = (
                ApplyExpression(
                    lambda t, d=d: _num(t) + d, dt.FLOAT, args=(tref,)
                )
                if d is not None
                else None
            )
            exp = (
                ApplyExpression(
                    lambda t, o=expire_offset: _num(t) + o,
                    dt.FLOAT,
                    args=(tref,),
                )
                if c is not None
                else None
            )
            gated, _op = tab._time_gate(time_e, rel, exp, clock=clock)
            return gated

        lflat = gate(lflat, this._pw_lt, (ub + c) if c is not None else None)
        rtab = gate(rtab, this._pw_rt, (c - lb) if c is not None else None)
        return lflat, rtab

    def select(self, *args, **kwargs) -> Table:
        lb, ub = self._lb, self._ub
        exprs = {}
        for arg in args:
            exprs[arg.name] = arg
        exprs.update(kwargs)
        out_names = list(exprs.keys())
        remapped = {
            name: _remap(
                e, {id(self._left): self._lflat, id(self._right): self._rtab}
            )
            for name, e in exprs.items()
        }
        full = self._join.select(
            _pw_lt2=self._lflat._pw_lt,
            _pw_rt2=self._rtab._pw_rt,
            _pw_lid2=self._lflat._pw_lid,
            _pw_rid2=self._rtab._pw_rid,
            **remapped,
        )
        matched = full.filter(
            ApplyExpression(
                lambda lt, rt: _num(lt) + lb <= _num(rt) <= _num(lt) + ub,
                dt.BOOL,
                args=(this._pw_lt2, this._pw_rt2),
            )
        )
        helper = ["_pw_lt2", "_pw_rt2", "_pw_lid2", "_pw_rid2"]
        parts = [matched.without(*helper)]
        if self._how in (JoinMode.LEFT, JoinMode.OUTER):
            matched_left_keys = matched.select(_pw_m=this._pw_lid2).with_id(
                this._pw_m
            )
            # pad only rows that SURVIVED the behavior gate: a cutoff-dropped
            # or still-buffered row must not leak out as an unmatched pad
            left_alive = self._left
            if self._gated:
                gated_ids = self._lflat.select(_pw_m=this._pw_lid).with_id(
                    this._pw_m
                )
                left_alive = self._left.intersect(gated_ids)
            unmatched = left_alive.difference(matched_left_keys)
            parts.append(
                unmatched.select(
                    **{
                        name: _remap(
                            e,
                            {id(self._left): unmatched},
                            null_tables={id(self._right), id(self._rtab)},
                        )
                        for name, e in exprs.items()
                    }
                )
            )
        if self._how in (JoinMode.RIGHT, JoinMode.OUTER):
            matched_right_keys = matched.select(_pw_m=this._pw_rid2).with_id(
                this._pw_m
            )
            right_alive = self._right
            if self._gated:
                gated_rids = self._rtab.select(_pw_m=this._pw_rid).with_id(
                    this._pw_m
                )
                right_alive = self._right.intersect(gated_rids)
            unmatched = right_alive.difference(matched_right_keys)
            parts.append(
                unmatched.select(
                    **{
                        name: _remap(
                            e,
                            {id(self._right): unmatched},
                            null_tables={id(self._left), id(self._lflat)},
                        )
                        for name, e in exprs.items()
                    }
                )
            )
        if len(parts) == 1:
            return parts[0]
        return parts[0].concat_reindex(*parts[1:])


def _remap(expr, table_map, null_tables=None):
    """Rebind column references from original tables onto derived tables;
    references to tables in ``null_tables`` become None constants (used to
    pad the missing side of outer temporal joins)."""
    from ...internals.expression import ColumnConstExpression, ColumnReference

    null_tables = null_tables or set()
    if isinstance(expr, ColumnReference):
        if id(expr.table) in null_tables:
            return ColumnConstExpression(None)
        t = table_map.get(id(expr.table))
        if t is not None:
            return getattr(t, expr.name)
        return expr
    if not isinstance(expr, ColumnExpression):
        return expr
    # rebuild by shallow-copying and remapping deps
    import copy

    new = copy.copy(expr)
    for attr, value in list(vars(new).items()):
        if isinstance(value, ColumnExpression):
            setattr(new, attr, _remap(value, table_map, null_tables))
        elif isinstance(value, tuple) and any(
            isinstance(v, ColumnExpression) for v in value
        ):
            setattr(
                new,
                attr,
                tuple(
                    _remap(v, table_map, null_tables)
                    if isinstance(v, ColumnExpression)
                    else v
                    for v in value
                ),
            )
    new._deps = tuple(
        _remap(d, table_map, null_tables) if isinstance(d, ColumnExpression) else d
        for d in new._deps
    )
    return new


def _refuse_unknown(name: str, kw) -> None:
    if kw:
        raise TypeError(f"{name}() got unexpected keyword arguments {sorted(kw)}")


def interval_join(left, right, left_time, right_time, itv, *on, behavior=None, how=JoinMode.INNER):
    return _interval_join_impl(
        left, right, left_time, right_time, itv, *on, how=how, behavior=behavior
    )


def interval_join_inner(left, right, left_time, right_time, itv, *on, behavior=None, **kw):
    _refuse_unknown("interval_join_inner", kw)
    return _interval_join_impl(
        left, right, left_time, right_time, itv, *on,
        how=JoinMode.INNER, behavior=behavior,
    )


def interval_join_left(left, right, left_time, right_time, itv, *on, behavior=None, **kw):
    _refuse_unknown("interval_join_left", kw)
    return _interval_join_impl(
        left, right, left_time, right_time, itv, *on,
        how=JoinMode.LEFT, behavior=behavior,
    )


def interval_join_right(left, right, left_time, right_time, itv, *on, behavior=None, **kw):
    _refuse_unknown("interval_join_right", kw)
    return _interval_join_impl(
        left, right, left_time, right_time, itv, *on,
        how=JoinMode.RIGHT, behavior=behavior,
    )


def interval_join_outer(left, right, left_time, right_time, itv, *on, behavior=None, **kw):
    _refuse_unknown("interval_join_outer", kw)
    return _interval_join_impl(
        left, right, left_time, right_time, itv, *on,
        how=JoinMode.OUTER, behavior=behavior,
    )


# ---------------------------------------------------------------------------
# asof joins (reference: _asof_join.py:1107)
# ---------------------------------------------------------------------------
class AsofJoinResult:
    """For each left row, match the latest right row with right.t <= left.t
    (direction configurable).  Implemented as groupby-side accumulation: the
    right side is reduced to sorted tuples per join key, and each left row
    binary-searches at select time — incremental because the sorted tuple is."""

    def __init__(self, left, right, left_time, right_time, on, how, direction="backward"):
        from ...internals import api_reducers as reducers
        from ...internals.thisclass import left as left_ph
        from ...internals.thisclass import right as right_ph

        self._how = how

        def side_of(e):
            for ref in smart_coerce(e)._column_refs():
                if ref.table is left or ref.table is left_ph:
                    return "left"
                if ref.table is right or ref.table is right_ph:
                    return "right"
            return None

        lkeys, rkeys = [], []
        for c in on:
            a, b = c._left, c._right
            if side_of(a) == "right" or side_of(b) == "left":
                a, b = b, a
            lkeys.append(a)
            rkeys.append(b)

        rt = right.with_columns(_pw_rt=smart_coerce(right_time))
        # packed columns named after the LEFT key names so select-time join
        # conditions line up regardless of differing column names
        if rkeys:
            grouped = rt.groupby(*[getattr(rt, k.name) for k in rkeys])
            gcols = {
                lk.name: getattr(rt, rk.name) for lk, rk in zip(lkeys, rkeys)
            }
        else:
            grouped = rt.groupby()
            gcols = {}
        packed = grouped.reduce(
            **gcols,
            _pw_rows=reducers.sorted_tuple(
                ApplyExpression(
                    lambda t, *vals: (_num(t), vals),
                    dt.ANY,
                    args=(rt._pw_rt, *[getattr(rt, c) for c in right.column_names]),
                )
            ),
        )
        self._left = left
        self._right = right
        self._packed = packed
        self._left_time = left_time
        self._lkeys = lkeys
        self._direction = direction
        self._right_names = list(right.column_names)

    def select(self, *args, **kwargs) -> Table:
        import bisect

        direction = self._direction
        right_names = self._right_names

        def lookup(rows, t):
            if rows is None:
                return None
            t = _num(t)
            times = [r[0] for r in rows]
            if direction in ("backward",):
                i = bisect.bisect_right(times, t) - 1
                return rows[i][1] if i >= 0 else None
            else:
                i = bisect.bisect_left(times, t)
                return rows[i][1] if i < len(rows) else None

        left = self._left
        if self._lkeys:
            conds = [
                getattr(left, lk.name) == getattr(self._packed, lk.name)
                for lk in self._lkeys
            ]
        else:
            # keyless asof: every left row joins the single global packed row
            conds = [smart_coerce(0) == smart_coerce(0)]
        jr = left.join(self._packed, *conds, how=JoinMode.LEFT)
        matched = jr.select(
            *[getattr(left, c) for c in left.column_names],
            _pw_match=ApplyExpression(
                lookup, dt.ANY, args=(self._packed._pw_rows, self._left_time)
            ),
        )
        exprs = {}
        for arg in args:
            exprs[arg.name] = arg
        exprs.update(kwargs)
        out_exprs = {}
        for name, e in exprs.items():
            out_exprs[name] = _remap_asof(e, left, matched, right_names)
        result = matched.select(**out_exprs)
        if self._how == JoinMode.INNER:
            # refilter unmatched
            keep = matched.filter(
                ApplyExpression(lambda m: m is not None, dt.BOOL, args=(this._pw_match,))
            )
            result = result.restrict(keep)
        return result


def _remap_asof(expr, left, matched, right_names):
    from ...internals.expression import ColumnReference

    if isinstance(expr, ColumnReference):
        if expr.name in right_names and (
            not isinstance(expr.table, Table) or expr.table is not left
        ):
            idx = right_names.index(expr.name)
            return ApplyExpression(
                lambda m, _i=idx: m[_i] if m is not None else None,
                dt.ANY,
                args=(getattr(matched, "_pw_match"),),
            )
        if isinstance(expr.table, Table) and expr.table is not left:
            idx = right_names.index(expr.name)
            return ApplyExpression(
                lambda m, _i=idx: m[_i] if m is not None else None,
                dt.ANY,
                args=(getattr(matched, "_pw_match"),),
            )
        return getattr(matched, expr.name)
    if not isinstance(expr, ColumnExpression):
        return expr
    import copy

    new = copy.copy(expr)
    for attr, value in list(vars(new).items()):
        if isinstance(value, ColumnExpression):
            setattr(new, attr, _remap_asof(value, left, matched, right_names))
        elif isinstance(value, tuple) and any(
            isinstance(v, ColumnExpression) for v in value
        ):
            setattr(
                new,
                attr,
                tuple(
                    _remap_asof(v, left, matched, right_names)
                    if isinstance(v, ColumnExpression)
                    else v
                    for v in value
                ),
            )
    new._deps = tuple(
        _remap_asof(d, left, matched, right_names)
        if isinstance(d, ColumnExpression)
        else d
        for d in new._deps
    )
    return new


def _refuse_asof(name, how, direction, defaults, behavior, kw) -> None:
    """The asof join matches backward or forward, for every left row (LEFT)
    or the matched ones (INNER).  The reference runs ``direction="nearest"``
    as ``"forward"`` and OUTER or RIGHT as LEFT, and drops ``defaults`` and
    ``behavior``: wrong rows without an error.  The port refuses them."""
    _refuse_unknown(name, kw)
    if direction not in ("backward", "forward"):
        raise NotImplementedError(
            f"{name}: direction={direction!r} is not implemented (only 'backward' and 'forward')"
        )
    if how not in (JoinMode.LEFT, JoinMode.INNER):
        raise NotImplementedError(f"{name}: how={how!r} is not implemented (only LEFT and INNER)")
    if defaults:
        raise NotImplementedError(f"{name}: defaults= is not implemented (unmatched right columns are None)")
    if behavior is not None:
        raise NotImplementedError(f"{name}: behavior= is not implemented")


def asof_join(left, right, left_time, right_time, *on, how=JoinMode.LEFT, direction="backward", defaults=None, behavior=None):
    _refuse_asof("asof_join", how, direction, defaults, behavior, {})
    return AsofJoinResult(left, right, left_time, right_time, on, how, direction)


def asof_join_left(left, right, left_time, right_time, *on, direction="backward", defaults=None, behavior=None, **kw):
    _refuse_asof("asof_join_left", JoinMode.LEFT, direction, defaults, behavior, kw)
    return AsofJoinResult(left, right, left_time, right_time, on, JoinMode.LEFT, direction)


def asof_join_right(left, right, left_time, right_time, *on, direction="backward", defaults=None, behavior=None, **kw):
    _refuse_asof("asof_join_right", JoinMode.LEFT, direction, defaults, behavior, kw)
    return AsofJoinResult(right, left, right_time, left_time, on, JoinMode.LEFT, direction)


def asof_join_outer(left, right, left_time, right_time, *on, direction="backward", defaults=None, behavior=None, **kw):
    _refuse_asof("asof_join_outer", JoinMode.OUTER, direction, defaults, behavior, kw)  # raises: OUTER


def asof_now_join(left, right, *on, how=JoinMode.INNER, id=None, **kw):
    _refuse_unknown("asof_now_join", kw)
    return left.asof_now_join(right, *on, how=how, id=id)


# ---------------------------------------------------------------------------
# window joins (reference: _window_join.py:1217)
# ---------------------------------------------------------------------------
class WindowJoinResult:
    def __init__(self, left, right, left_time, right_time, window, on, how):
        win = window
        if not isinstance(win, (TumblingWindow, SlidingWindow)):
            raise NotImplementedError("window_join supports tumbling/sliding windows")

        def assign(t):
            return [w[0] for w in win.assign(t)]

        lflat = left.with_columns(
            _pw_lw=ApplyExpression(assign, dt.ANY, args=(left_time,))
        ).flatten(this._pw_lw)
        rflat = right.with_columns(
            _pw_rw=ApplyExpression(assign, dt.ANY, args=(right_time,))
        ).flatten(this._pw_rw)
        conds = [lflat._pw_lw == rflat._pw_rw]
        for cond in on:
            conds.append(
                getattr(lflat, cond._left.name) == getattr(rflat, cond._right.name)
            )
        self._join = lflat.join(rflat, *conds, how=how)
        self._lflat, self._rflat = lflat, rflat
        self._left, self._right = left, right

    def select(self, *args, **kwargs) -> Table:
        exprs = {}
        for arg in args:
            exprs[arg.name] = arg
        exprs.update(kwargs)
        remapped = {
            name: _remap(e, {id(self._left): self._lflat, id(self._right): self._rflat})
            for name, e in exprs.items()
        }
        return self._join.select(**remapped)


def window_join(left, right, left_time, right_time, window, *on, how=JoinMode.INNER):
    return WindowJoinResult(left, right, left_time, right_time, window, on, how)


def window_join_inner(left, right, left_time, right_time, window, *on):
    return WindowJoinResult(left, right, left_time, right_time, window, on, JoinMode.INNER)


def window_join_left(left, right, left_time, right_time, window, *on):
    return WindowJoinResult(left, right, left_time, right_time, window, on, JoinMode.LEFT)


from . import session_windows, time_utils  # noqa: E402
from .time_utils import inactivity_detection, utc_now  # noqa: E402
