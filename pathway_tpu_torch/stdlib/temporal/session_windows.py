"""Session window reduction (counterpart of
``pathway_tpu/stdlib/temporal/session_windows.py``).

Sessions can't desugar to a static key (membership depends on neighbors), so
they reduce via a sorted-tuple accumulation per instance followed by a host
session-splitting pass — incremental at the granularity of the instance
(reference session window machinery: stdlib/temporal/_window.py SessionWindow).
"""

from __future__ import annotations

import math
from typing import Any

from ...internals import api_reducers as reducers
from ...internals import dtype as dt
from ...internals.expression import ApplyExpression, ReducerExpression, smart_coerce
from ...internals.table import Table
from ...internals.thisclass import this


def _num(v: Any) -> float:
    import datetime

    if isinstance(v, datetime.timedelta):
        return v.total_seconds()
    if isinstance(v, datetime.datetime):
        return v.timestamp()
    return v


def reduce_session(windowed, *args, **kwargs) -> Table:
    win = windowed.window
    table = windowed.table
    key_expr = windowed.key_expr
    if win.max_gap is not None:
        gap = _num(win.max_gap)
        belong = lambda a, b: (_num(b) - _num(a)) <= gap
    elif win.predicate is not None:
        belong = win.predicate
    else:
        raise ValueError("session window needs max_gap or predicate")

    # pack (time, row_key) tuples per instance
    grouping = []
    if windowed.instance is not None:
        grouping.append(windowed.instance)
    aug = table.with_columns(_pw_t=key_expr)

    # Behaviors (NOTE: the reference silently IGNORES behaviors on session
    # windows — SessionWindow._apply takes `behavior` and never reads it,
    # python/pathway/stdlib/temporal/_window.py:111-146.
    # Here CommonBehavior is supported with row-time semantics: delay holds
    # a row until clock >= t+delay; cutoff drops rows arriving after clock
    # passed t+cutoff; keep_results=False additionally PRUNES rows past the
    # cutoff from the per-instance accumulation, which both bounds state and
    # retracts the frozen sessions via recompute.  keep_results=True keeps
    # every surviving row in the instance accumulation (results must stay
    # even if the instance later recomputes), so per-instance state is
    # bounded only by the cutoff-surviving row count.)
    gate = None
    cutoff_c = None
    keep_results = True
    behavior = windowed.behavior
    if behavior is not None:
        from .temporal_behavior import CommonBehavior, ExactlyOnceBehavior

        if isinstance(behavior, ExactlyOnceBehavior):
            raise NotImplementedError(
                "exactly-once is not defined for merging session windows; "
                "use common_behavior(delay, cutoff, keep_results)"
            )
        if not isinstance(behavior, CommonBehavior):
            raise TypeError(f"unsupported window behavior: {behavior!r}")
        release = expire = None
        if behavior.delay is not None:
            d = _num(behavior.delay)
            release = ApplyExpression(
                lambda t, d=d: _num(t) + d, dt.FLOAT, args=(this._pw_t,)
            )
        if behavior.cutoff is not None:
            cutoff_c = _num(behavior.cutoff)
            expire = ApplyExpression(
                lambda t, c=cutoff_c: _num(t) + c, dt.FLOAT, args=(this._pw_t,)
            )
        keep_results = behavior.keep_results
        if release is not None or expire is not None:
            aug, gate = aug._time_gate(this._pw_t, release, expire)
    grouped = aug.groupby(*[_rebind(g, table, aug) for g in grouping]) if grouping else aug.groupby()
    packed_cols = {}
    if grouping:
        for gi, g in enumerate(grouping):
            name = g.name if hasattr(g, "name") else f"_pw_instance_{gi}"
            packed_cols[name] = _rebind(g, table, aug)
    packed = grouped.reduce(
        **packed_cols,
        _pw_sessions=reducers.sorted_tuple(
            ApplyExpression(
                lambda t, *vals: (_num(t), vals),
                dt.ANY,
                args=(aug._pw_t, *[getattr(aug, c) for c in table.column_names]),
            )
        ),
    )

    def split_sessions(rows):
        sessions = []
        current = []
        prev_t = None
        for t, vals in rows:
            if prev_t is not None and not belong(prev_t, t):
                sessions.append(current)
                current = []
            current.append((t, vals))
            prev_t = t
        if current:
            sessions.append(current)
        return [
            ((s[0][0], s[-1][0]), tuple(s)) for s in sessions
        ]

    exploded = packed.with_columns(
        _pw_split=ApplyExpression(split_sessions, dt.ANY, args=(packed._pw_sessions,))
    ).flatten(this._pw_split)
    exploded = exploded.with_columns(
        _pw_window_start=ApplyExpression(lambda s: s[0][0], dt.FLOAT, args=(this._pw_split,)),
        _pw_window_end=ApplyExpression(lambda s: s[0][1], dt.FLOAT, args=(this._pw_split,)),
        _pw_rows=ApplyExpression(lambda s: s[1], dt.ANY, args=(this._pw_split,)),
    )
    # now evaluate requested reducers over the packed rows per session
    out_exprs = {}
    col_names = list(table.column_names)
    for arg in args:
        out_exprs[arg.name] = arg
    out_exprs.update(kwargs)

    final_exprs = {}
    for name, e in out_exprs.items():
        final_exprs[name] = _session_expr(e, exploded, col_names)
    out = exploded.select(**final_exprs)
    if gate is not None and cutoff_c is not None and not keep_results:
        gop = packed._engine_table.producer
        gate.sweep_hooks.append(_session_state_pruner(gop, cutoff_c))
    return out


def _session_state_pruner(gop, cutoff: float):
    """Sweep hook (keep_results=False): drop rows past the cutoff from the
    per-instance sorted-tuple accumulation and re-emit the packed rows — the
    downstream session split recomputes without them, retracting the frozen
    sessions AND keeping state bounded (the session analog of
    _groupby_sweeper's `del gop._groups[gk]`)."""
    si = next(
        i
        for i, spec in enumerate(gop.reducer_specs)
        if spec.out_name == "_pw_sessions"
    )

    def sweep(clock):
        touched = {}
        for gk, entry in list(gop._groups.items()):
            state = entry[2][si]
            expired = [
                h
                for h, (cnt, val) in state.items()
                if _num(val[0]) + cutoff <= clock
            ]
            if not expired:
                continue
            removed = 0
            for h in expired:
                cnt, _val = state[h]
                removed += cnt
                del state[h]
            entry[0] -= removed
            touched[gk] = None
        if not touched:
            return None
        delta = gop._emit(touched, list(gop.grouping_expressions.keys()))
        if delta is None:
            return None
        return (gop.output, delta)

    return sweep


def _rebind(expr, old_table, new_table):
    from ...internals.expression import ColumnReference

    if isinstance(expr, ColumnReference) and expr.table is old_table:
        return getattr(new_table, expr.name)
    return expr


def _session_expr(e, exploded, col_names):
    """Translate reducers/refs into host computations over the packed rows."""
    from ...internals.expression import ColumnReference

    if isinstance(e, ReducerExpression):
        reducer = e._reducer()
        arg_exprs = list(e._args)

        def agg(rows, _reducer=reducer, _arg_exprs=arg_exprs):
            state = _reducer.init_state()
            for i, (t, vals) in enumerate(rows):
                row_map = dict(zip(col_names, vals))
                if _reducer.n_args == 0:
                    value = None
                elif len(_arg_exprs) == 1:
                    value = _scalar_eval(_arg_exprs[0], row_map)
                else:
                    value = tuple(_scalar_eval(a, row_map) for a in _arg_exprs)
                if getattr(e, "_needs_key_order", False):
                    value = (value, i)
                state = _reducer.update(state, value, 1, i, 0)
            result = _reducer.result(state)
            post = getattr(e, "_post", None)
            return post(result) if post else result

        return ApplyExpression(agg, dt.ANY, args=(exploded._pw_rows,))
    if isinstance(e, ColumnReference):
        if e.name in ("_pw_window_start", "_pw_window_end", "_pw_window_location"):
            return getattr(exploded, e.name if e.name != "_pw_window_location" else "_pw_window_start")
        if e.name in col_names:
            # take the value from the first row of the session
            idx = col_names.index(e.name)
            return ApplyExpression(
                lambda rows, _i=idx: rows[0][1][_i], dt.ANY, args=(exploded._pw_rows,)
            )
        return getattr(exploded, e.name)
    return e


def _scalar_eval(expr, row_map):
    """Evaluate an expression for a single row given a name->value map."""
    import numpy as np

    from ...internals.expression import EvalContext

    columns = {}
    for (tid_name), v in (()):  # pragma: no cover
        pass
    # build a 1-row context: map every (table_id, name) the expr references
    ctx_cols = {}
    for ref in expr._column_refs():
        ctx_cols[(id(ref.table), ref.name)] = np.array([row_map.get(ref.name)], dtype=object)
    ctx = EvalContext(ctx_cols, np.zeros(1, dtype=np.uint64))
    return expr._eval(ctx)[0]
