"""The port's temporal stdlib, ``ordered`` and ``statistical`` against the
reference.

Each case is one builder run through ``pathway_tpu`` and through
``pathway_tpu_torch`` on the same rows.  Batch cases (the cases of
``tests/test_temporal.py``) run with ``pw.run`` and compare keyed rows and
the ``(key, row, diff)`` stream tick by tick.  Streaming cases (the cases
of ``tests/test_temporal_behavior.py`` and more) feed hand-driven input
sessions and step the executor once per commit, so every tick is
deterministic: they compare the keyed rows after every step, any probe of
operator state, and the whole update stream.
"""

import datetime
import importlib

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.io import _connector as ref_connector
from pathway_tpu_torch.io import _connector as port_connector

from .test_torch_table import _plain, _run

PACKAGES = (pathway_tpu, pathway_tpu_torch)


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setattr(ref_connector, "_source_counter", [0])
    monkeypatch.setattr(port_connector, "_source_counter", [0])
    for pw in PACKAGES:
        pw.reset()
    yield
    for pw in PACKAGES:
        pw.reset()


def _both(build):
    ref, port = (_run(pw, build) for pw in PACKAGES)
    assert port == ref
    return port


# -- batch cases: tests/test_temporal.py ------------------------------------------


def _md(pw, text):
    return pw.debug.table_from_markdown(text)


def build_tumbling_window(pw):
    t = _md(pw, """
      | t  | v
    1 | 1  | 10
    2 | 3  | 20
    3 | 11 | 5
    4 | 12 | 7
    """)
    return pw.temporal.windowby(t, t.t, window=pw.temporal.tumbling(duration=10)).reduce(
        start=pw.this._pw_window_start, s=pw.reducers.sum(pw.this.v), c=pw.reducers.count()
    )


def build_sliding_window(pw):
    t = _md(pw, """
      | t | v
    1 | 5 | 1
    """)
    return pw.temporal.windowby(t, t.t, window=pw.temporal.sliding(hop=2, duration=4)).reduce(
        start=pw.this._pw_window_start, c=pw.reducers.count()
    )


def build_session_window(pw):
    t = _md(pw, """
      | t  | v
    1 | 1  | 1
    2 | 2  | 2
    3 | 10 | 3
    4 | 11 | 4
    """)
    return pw.temporal.windowby(t, t.t, window=pw.temporal.session(max_gap=3)).reduce(
        start=pw.this._pw_window_start, end=pw.this._pw_window_end, s=pw.reducers.sum(pw.this.v)
    )


def _ij_tables(pw):
    left = _md(pw, """
      | t | a
    1 | 10 | x
    2 | 20 | y
    3 | 50 | z
    """)
    right = _md(pw, """
      | t | b
    1 | 9  | p
    2 | 12 | q
    3 | 25 | s
    4 | 70 | u
    """)
    return left, right


def build_interval_join_inner(pw):
    left, right = _ij_tables(pw)
    return pw.temporal.interval_join(left, right, left.t, right.t, pw.temporal.interval(-2, 2)).select(
        left.a, right.b
    )


def build_interval_join_left_pads(pw):
    left, right = _ij_tables(pw)
    return pw.temporal.interval_join_left(left, right, left.t, right.t, pw.temporal.interval(-2, 2)).select(
        left.a, right.b
    )


def build_interval_join_right_and_outer(pw):
    left, right = _ij_tables(pw)
    itv = pw.temporal.interval(-2, 6)
    return (
        pw.temporal.interval_join_right(left, right, left.t, right.t, itv).select(left.a, right.b),
        pw.temporal.interval_join_outer(left, right, left.t, right.t, itv).select(lt=left.t, a=left.a, b=right.b),
    )


def build_asof_join(pw):
    trades = _md(pw, """
      | t  | px
    1 | 10 | 100
    2 | 20 | 105
    """)
    quotes = _md(pw, """
      | t  | bid
    1 | 5  | 99
    2 | 15 | 103
    3 | 30 | 110
    """)
    return pw.temporal.asof_join(trades, quotes, trades.t, quotes.t).select(trades.px, quotes.bid)


def build_asof_join_with_key_different_names(pw):
    trades = _md(pw, """
      | sym | t  | px
    1 | A   | 10 | 1
    2 | B   | 10 | 2
    """)
    quotes = _md(pw, """
      | ticker | t | bid
    1 | A      | 5 | 50
    2 | B      | 6 | 60
    """)
    return pw.temporal.asof_join(trades, quotes, trades.t, quotes.t, trades.sym == quotes.ticker).select(
        trades.px, quotes.bid
    )


def build_window_join(pw):
    left = _md(pw, """
      | t | a
    1 | 1 | x
    2 | 11 | y
    """)
    right = _md(pw, """
      | t | b
    1 | 2 | p
    2 | 19 | q
    """)
    return pw.temporal.window_join(left, right, left.t, right.t, pw.temporal.tumbling(10)).select(left.a, right.b)


def build_window_join_left_sliding(pw):
    left = _md(pw, """
      | t  | a
    1 | 1  | x
    2 | 11 | y
    3 | 40 | w
    """)
    right = _md(pw, """
      | t | b
    1 | 2 | p
    2 | 9 | q
    """)
    return pw.temporal.window_join_left(
        left, right, left.t, right.t, pw.temporal.sliding(hop=5, duration=10)
    ).select(left.a, right.b)


def build_intervals_over(pw):
    data = _md(pw, """
      | t | v
    1 | 1 | 10
    2 | 2 | 20
    3 | 9 | 30
    """)
    probes = _md(pw, """
      | at
    1 | 2
    2 | 100
    """)
    return pw.temporal.windowby(
        data, data.t, window=pw.temporal.intervals_over(at=probes.at, lower_bound=-2, upper_bound=2, is_outer=True)
    ).reduce(loc=pw.this._pw_window_location, s=pw.reducers.sum(pw.this.v))


def build_diff(pw):
    t = _md(pw, """
      | t | v
    1 | 1 | 10
    2 | 2 | 13
    3 | 3 | 20
    """)
    return pw.stdlib.ordered.diff(t, t.t, t.v)


def build_diff_by_instance(pw):
    t = _md(pw, """
      | k | t | v  | w
    1 | a | 3 | 10 | 1.5
    2 | a | 1 | 13 | 2.5
    3 | b | 2 | 20 | 0.0
    4 | b | 7 | 26 | 4.0
    5 | a | 9 | 11 | 1.0
    """)
    return pw.ordered.diff(t, t.t, t.v, t.w, instance=t.k)


def build_interpolate(pw):
    # object columns keep None (a float column holds NaN, which interpolate leaves)
    t = pw.debug.table_from_rows(
        pw.schema_from_types(t=int, v=object, w=object),
        [(1, 1.0, None), (2, None, 4.0), (4, None, None), (5, 7.0, 10.0), (6, None, None), (3, 3.0, None)],
    )
    return pw.statistical.interpolate(t, t.t, t.v, t.w, mode=pw.statistical.InterpolateMode.LINEAR)


def build_sliding_ratio_and_origin(pw):
    t = _md(pw, """
      | t  | v | k
    1 | 1  | 1 | a
    2 | 4  | 2 | b
    3 | 7  | 3 | a
    4 | 13 | 4 | b
    5 | 8  | 5 | a
    """)
    return pw.temporal.windowby(
        t, t.t, window=pw.temporal.sliding(hop=3, ratio=2, origin=1), instance=pw.this.k
    ).reduce(
        start=pw.this._pw_window_start, end=pw.this._pw_window_end, s=pw.reducers.sum(pw.this.v),
        n=pw.reducers.count(),
    )


def build_windowby_top_level(pw):
    """The free functions of ``pw`` (``pw.windowby``, ``pw.interval_join``,
    ``pw.asof_join``, ``pw.window_join``) are the temporal stdlib's."""
    left, right = _ij_tables(pw)
    return (
        pw.windowby(left, left.t, window=pw.temporal.tumbling(duration=20)).reduce(
            start=pw.this._pw_window_start, n=pw.reducers.count()
        ),
        pw.interval_join(left, right, left.t, right.t, pw.temporal.interval(-5, 5)).select(left.a, right.b),
        pw.asof_join(left, right, left.t, right.t).select(left.a, right.b),
        pw.window_join(left, right, left.t, right.t, pw.temporal.tumbling(20)).select(left.a, right.b),
    )


BATCH = [
    build_tumbling_window, build_sliding_window, build_session_window, build_interval_join_inner,
    build_interval_join_left_pads, build_interval_join_right_and_outer, build_asof_join,
    build_asof_join_with_key_different_names, build_window_join, build_window_join_left_sliding,
    build_intervals_over, build_diff, build_diff_by_instance, build_interpolate, build_sliding_ratio_and_origin,
    build_windowby_top_level,
]


@pytest.mark.parametrize("build", BATCH, ids=lambda f: f.__name__[len("build_"):])
def test_batch_equals_reference(build):
    streams = _both(build)
    assert all(rows for _stream, rows in streams)


# -- streaming cases: hand-driven sessions, one executor step per commit -------------


class _Engine:
    """One package's engine parts for hand-driven streams."""

    def __init__(self, pw):
        base = pw.__name__
        self.pw = pw
        self.Executor = importlib.import_module(f"{base}.engine.executor").Executor
        io = importlib.import_module(f"{base}.engine.operators.io")
        self.InputSession, self.SourceOperator = io.InputSession, io.SourceOperator
        self.dt = importlib.import_module(f"{base}.internals.dtype")
        self.Table = importlib.import_module(f"{base}.internals.table").Table
        self.Universe = importlib.import_module(f"{base}.internals.universe").Universe
        self.key = importlib.import_module(f"{base}.internals.keys").ref_scalar
        self.temporal = importlib.import_module(f"{base}.stdlib.temporal")
        self.sessions = []

    def stream(self, **types):
        names = list(types)
        dtypes = {k: self.dt.wrap(v) for k, v in types.items()}
        session = self.InputSession(upsert=True)
        graph = self.pw.G.engine_graph
        et = graph.add_table(names, "stream")
        graph.add_operator(self.SourceOperator(et, session, dtypes, name="stream"))
        self.sessions.append(session)
        return self.Table(et, dtypes, self.Universe(), short_name="stream"), session

    def put(self, session, key, row):
        session.insert(int(self.key(key)), row)


END = "end"  # close every session and run the executor to its end (flushes buffers)


def _rows_of(table):
    keys, cols = table._materialize()
    return sorted((int(k), tuple((c, _plain(cols[c][i])) for c in sorted(cols))) for i, k in enumerate(keys))


def _drive(pw, scenario):
    """Run ``scenario(engine) -> (outputs, steps, probe)`` by hand; returns
    the rows after each step (and ``probe()``), and each output's update
    stream as one sorted list per tick."""
    eng = _Engine(pw)
    outputs, steps, probe = scenario(eng)
    streams = []
    for table in outputs:
        events = []

        def on_change(key, row, time, is_addition, events=events):
            events.append((time, int(key), tuple((k, _plain(v)) for k, v in sorted(row.items())), 1 if is_addition else -1))

        pw.io.subscribe(table, on_change=on_change)
        streams.append(events)
    ex = eng.Executor(pw.G.engine_graph)
    pw.G.engine_graph.finalize()
    seen = []
    for step in steps:
        if step == END:
            for session in eng.sessions:
                session.close()
            ex.run()
        else:
            if step is not None:
                step()
            ex.step()
        seen.append((tuple(_rows_of(t) for t in outputs), probe() if probe else None))
    ticks = []
    for events in streams:
        by_time = {}
        for time, key, row, diff in events:
            by_time.setdefault(time, []).append((key, row, diff))
        ticks.append([sorted(by_time[t], key=repr) for t in sorted(by_time)])
    return seen, ticks


def _both_driven(scenario):
    ref, port = (_drive(pw, scenario) for pw in PACKAGES)
    assert port == ref
    return port


def _window_counts(e, behavior, window=None, **types):
    t, s = e.stream(**(types or {"t": float}))
    out = e.temporal.windowby(t, t.t, window=window or e.temporal.tumbling(duration=10.0), behavior=behavior).reduce(
        start=e.pw.this._pw_window_start, c=e.pw.reducers.count()
    )
    return t, s, out


def scenario_delay_buffers_until_clock_passes(e):
    _t, s, out = _window_counts(e, e.temporal.common_behavior(delay=5.0))
    return (out,), [lambda: e.put(s, 1, (3.0,)), lambda: e.put(s, 2, (6.0,))], None


def scenario_delay_flushes_on_stream_end(e):
    _t, s, out = _window_counts(e, e.temporal.common_behavior(delay=100.0))
    return (out,), [lambda: (e.put(s, 1, (3.0,)), e.put(s, 2, (4.0,))), END], None


def scenario_cutoff_drops_late_rows_and_shrinks_state(e):
    _t, s, out = _window_counts(e, e.temporal.common_behavior(cutoff=2.0))
    gop = out._engine_table.producer
    steps = [lambda: e.put(s, 1, (5.0,)), lambda: e.put(s, 2, (25.0,)), lambda: e.put(s, 3, (5.5,)), None, None,
             lambda: e.put(s, 4, (26.0,))]
    return (out,), steps, lambda: len(gop._groups)


def scenario_cutoff_keep_results_false_retracts_frozen_windows(e):
    _t, s, out = _window_counts(e, e.temporal.common_behavior(cutoff=2.0, keep_results=False))
    return (out,), [lambda: e.put(s, 1, (5.0,)), lambda: e.put(s, 2, (25.0,)), None], None


def scenario_exactly_once_emits_one_final_result(e):
    _t, s, out = _window_counts(e, e.temporal.exactly_once_behavior())
    steps = [lambda: e.put(s, 1, (1.0,)), lambda: e.put(s, 2, (5.0,)), lambda: e.put(s, 3, (11.0,)),
             lambda: e.put(s, 4, (7.0,)), None]
    return (out,), steps, None


def scenario_delay_with_updates_before_release(e):
    t, s = e.stream(t=float, v=int)
    out = e.temporal.windowby(
        t, t.t, window=e.temporal.tumbling(duration=10.0), behavior=e.temporal.common_behavior(delay=5.0)
    ).reduce(start=e.pw.this._pw_window_start, c=e.pw.reducers.count(), s=e.pw.reducers.sum(e.pw.this.v))
    steps = [lambda: e.put(s, 1, (3.0, 100)), lambda: e.put(s, 1, (3.0, 200)), lambda: e.put(s, 2, (6.0, 1))]
    return (out,), steps, None


def _ij_streams(e, behavior, how=None, itv=(-2.0, 2.0)):
    lt_, ls = e.stream(t=float, a=str)
    rt_, rs = e.stream(t=float, b=str)
    kwargs = {} if how is None else {"how": how}
    out = e.temporal.interval_join(
        lt_, rt_, lt_.t, rt_.t, e.temporal.interval(*itv), behavior=behavior, **kwargs
    ).select(lt_t=lt_.t, a=lt_.a, b=rt_.b)
    return out, ls, rs


def scenario_interval_join_cutoff_drops_late_rows(e):
    out, ls, rs = _ij_streams(e, e.temporal.common_behavior(cutoff=1.0))
    steps = [lambda: (e.put(ls, "l1", (10.0, "x")), e.put(rs, "r1", (11.0, "p"))),
             lambda: e.put(rs, "r2", (100.0, "q")), lambda: e.put(rs, "r3", (10.5, "late"))]
    return (out,), steps, None


def scenario_interval_join_delay_buffers(e):
    out, ls, rs = _ij_streams(e, e.temporal.common_behavior(delay=5.0))
    steps = [lambda: (e.put(ls, "l1", (10.0, "x")), e.put(rs, "r1", (11.0, "p"))),
             lambda: e.put(rs, "r2", (16.0, "z"))]
    return (out,), steps, None


def scenario_interval_join_left_cutoff_no_padded_leak(e):
    JoinMode = importlib.import_module(f"{e.pw.__name__}.internals.table").JoinMode
    out, ls, rs = _ij_streams(e, e.temporal.common_behavior(cutoff=1.0), how=JoinMode.LEFT, itv=(-0.5, 0.5))
    steps = [lambda: (e.put(ls, "l1", (100.0, "x")), e.put(rs, "r1", (100.0, "p"))),
             lambda: e.put(ls, "l2", (1.0, "late")), None, lambda: e.put(ls, "l3", (101.0, "solo"))]
    return (out,), steps, None


def _session_counts(e, behavior, max_gap):
    t, s = e.stream(t=float)
    out = e.temporal.windowby(t, t.t, window=e.temporal.session(max_gap=max_gap), behavior=behavior).reduce(
        start=e.pw.this._pw_window_start, c=e.pw.reducers.count()
    )
    return s, out


def scenario_session_delay_buffers_rows(e):
    s, out = _session_counts(e, e.temporal.common_behavior(delay=5.0), 2.0)
    steps = [lambda: e.put(s, 1, (1.0,)), lambda: e.put(s, 2, (7.0,)), lambda: e.put(s, 3, (13.0,))]
    return (out,), steps, None


def scenario_session_cutoff_drops_late_rows(e):
    s, out = _session_counts(e, e.temporal.common_behavior(cutoff=3.0), 1.0)
    steps = [lambda: (e.put(s, 1, (1.0,)), e.put(s, 2, (10.0,))), lambda: e.put(s, 3, (2.0,)),
             lambda: e.put(s, 4, (10.5,))]
    return (out,), steps, None


def scenario_session_cutoff_keep_results_false_retracts_frozen(e):
    s, out = _session_counts(e, e.temporal.common_behavior(cutoff=2.0, keep_results=False), 1.0)
    steps = [lambda: e.put(s, 1, (1.0,)), lambda: e.put(s, 2, (20.0,)), lambda: e.put(s, 3, (21.0,))]
    return (out,), steps, None


BEHAVIOR = [
    scenario_delay_buffers_until_clock_passes, scenario_delay_flushes_on_stream_end,
    scenario_cutoff_drops_late_rows_and_shrinks_state, scenario_cutoff_keep_results_false_retracts_frozen_windows,
    scenario_exactly_once_emits_one_final_result, scenario_delay_with_updates_before_release,
    scenario_interval_join_cutoff_drops_late_rows, scenario_interval_join_delay_buffers,
    scenario_interval_join_left_cutoff_no_padded_leak, scenario_session_delay_buffers_rows,
    scenario_session_cutoff_drops_late_rows, scenario_session_cutoff_keep_results_false_retracts_frozen,
]


@pytest.mark.parametrize("scenario", BEHAVIOR, ids=lambda f: f.__name__[len("scenario_"):])
def test_behavior_equals_reference(scenario):
    seen, ticks = _both_driven(scenario)
    assert any(rows for rows, _probe in seen) and any(ticks)


def test_session_exactly_once_rejected_in_both():
    for pw in PACKAGES:
        e = _Engine(pw)
        t, _s = e.stream(t=float)
        with pytest.raises(NotImplementedError):
            e.temporal.windowby(
                t, t.t, window=e.temporal.session(max_gap=1.0), behavior=e.temporal.exactly_once_behavior()
            ).reduce(c=pw.reducers.count())
        with pytest.raises(TypeError):
            e.temporal.interval_join(
                t, t, t.t, t.t, e.temporal.interval(-1.0, 1.0), behavior=e.temporal.exactly_once_behavior()
            )
        pw.reset()


# -- more streaming cases: several commits, datetimes, every behavior, the asof directions --

_T0 = datetime.datetime(2026, 3, 1, 8, 0)


def _at(minutes):
    return _T0 + datetime.timedelta(minutes=minutes)


def _stream_commits(e, s, rows_per_commit, first_key=0):
    """One step per commit: commit i inserts ``rows_per_commit[i]``; a row
    ``None`` in place of a tuple removes the key of that slot."""
    steps, key = [], first_key
    for rows in rows_per_commit:
        batch = []
        for row in rows:
            batch.append((key, row))
            key += 1
        steps.append(lambda batch=batch: [e.put(s, k, r) for k, r in batch])
    return steps


def _time_rows(seed, n_commits, per_commit, scale, jitter, start=0.0):
    """Rows ``(t, v, k)`` in commits: times mostly rising, some late."""
    rng = np.random.default_rng(seed)
    commits, now = [], start
    for _ in range(n_commits):
        rows = []
        for _ in range(per_commit):
            now += float(rng.uniform(0, scale))
            late = float(rng.uniform(0, jitter)) if rng.random() < 0.3 else 0.0
            rows.append((round(now - late, 3), int(rng.integers(0, 50)), f"k{int(rng.integers(0, 3))}"))
        commits.append(rows)
    return commits


# how a case gives its times: plain numbers, naive datetimes in an object
# column, or the datetimes' seconds
_TIME_TYPES = {"numeric": float, "seconds": float, "datetime": object}


def _time(times, minutes):
    if times == "numeric":
        return minutes
    return _at(minutes).timestamp() if times == "seconds" else _at(minutes)


def _duration(times, minutes):
    if times == "numeric":
        return minutes
    return minutes * 60.0 if times == "seconds" else datetime.timedelta(minutes=minutes)


def _behaviors(e, times):
    def unit(x):
        return _duration(times, x)

    return {
        "none": None,
        "delay": e.temporal.common_behavior(delay=unit(6)),
        "cutoff": e.temporal.common_behavior(cutoff=unit(4)),
        "cutoff_forget": e.temporal.common_behavior(delay=unit(2), cutoff=unit(4), keep_results=False),
        "exactly_once": e.temporal.exactly_once_behavior(shift=unit(1)),
    }


_WINDOWS = {
    "tumbling": lambda e, u: e.temporal.tumbling(duration=u(10)),
    "sliding": lambda e, u: e.temporal.sliding(hop=u(5), duration=u(15)),
    "session": lambda e, u: e.temporal.session(max_gap=u(3)),
}


def _windows_scenario(window, behavior, times):
    def scenario(e):
        t, s = e.stream(t=_TIME_TYPES[times], v=int, k=str)
        out = e.temporal.windowby(
            t, t.t, window=_WINDOWS[window](e, lambda x: _duration(times, x)),
            behavior=_behaviors(e, times)[behavior], instance=None if window == "session" else e.pw.this.k,
        ).reduce(
            start=e.pw.this._pw_window_start, end=e.pw.this._pw_window_end, n=e.pw.reducers.count(),
            s=e.pw.reducers.sum(e.pw.this.v),
        )
        commits = [[(_time(times, x), v, k) for x, v, k in rows] for rows in _time_rows(0, 6, 5, 4.0, 12.0)]
        return (out,), _stream_commits(e, s, commits) + [None, END], None

    return scenario


# sessions refuse exactly-once in both packages (test_session_exactly_once_rejected_in_both)
_WINDOW_BEHAVIORS = [
    (w, b) for w in sorted(_WINDOWS) for b in ("none", "delay", "cutoff", "cutoff_forget", "exactly_once")
    if (w, b) != ("session", "exactly_once")
]


# both packages gate a behavior's time in the column's own values, so
# datetimes run without a behavior, and with one as their seconds
_WINDOW_CASES = [(w, b, times) for times in ("numeric", "seconds") for w, b in _WINDOW_BEHAVIORS] + [
    (w, "none", "datetime") for w in sorted(_WINDOWS)
]


@pytest.mark.parametrize("window,behavior,times", _WINDOW_CASES)
def test_streamed_windows_equal_reference(window, behavior, times):
    """Windows over 6 commits of 5 rows with late rows among them, each
    behavior, per instance: window bounds, row ids and the update stream
    come out equal."""
    seen, _ticks = _both_driven(_windows_scenario(window, behavior, times))
    assert seen[-1][0][0]


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
@pytest.mark.parametrize("behavior", ["none", "delay", "cutoff"])
def test_streamed_interval_joins_equal_reference(how, behavior):
    """Interval joins over 5 commits to both sides, by key, each join
    mode, with delay and cutoff on a shared clock."""

    def scenario(e):
        JoinMode = importlib.import_module(f"{e.pw.__name__}.internals.table").JoinMode
        lt_, ls = e.stream(t=float, v=int, k=str)
        rt_, rs = e.stream(t=float, v=int, k=str)
        beh = _behaviors(e, "numeric")[behavior]
        out = e.temporal.interval_join(
            lt_, rt_, lt_.t, rt_.t, e.temporal.interval(-3.0, 2.0), lt_.k == rt_.k, behavior=beh,
            how={"inner": JoinMode.INNER, "left": JoinMode.LEFT, "right": JoinMode.RIGHT, "outer": JoinMode.OUTER}[how],
        ).select(lt=lt_.t, rt=rt_.t, lv=lt_.v, rv=rt_.v)
        lsteps = _stream_commits(e, ls, _time_rows(1, 5, 4, 3.0, 8.0))
        rsteps = _stream_commits(e, rs, _time_rows(2, 5, 4, 3.0, 8.0), first_key=1000)
        steps = [lambda a=a, b=b: (a(), b()) for a, b in zip(lsteps, rsteps)]
        return (out,), steps + [None, END], None

    seen, _ticks = _both_driven(scenario)
    assert seen[-1][0][0]


_TRADES = _time_rows(3, 4, 4, 5.0, 6.0)
_QUOTES = _time_rows(4, 4, 3, 6.0, 6.0)
_UPSERTS = {"quotes": (500, (0.5, 999, "k0")), "trades": (1, (7.5, 77, "k1"))}


def _asof_loop(drive, other, direction, inner):
    """For each ``(t, value, key)`` row of ``drive``: the row of ``other``
    with the same key that is latest at or before ``t`` (backward) or
    earliest at or after it (forward), equal times ordered by the rows'
    values.  ``None`` where none matches (the row dropped when ``inner``)."""
    out = []
    for t, v, k in drive:
        cands = [r for r in other if r[2] == k and (r[0] <= t if direction == "backward" else r[0] >= t)]
        match = (max if direction == "backward" else min)(cands) if cands else None
        if match is not None or not inner:
            out.append(((t, v, k), match))
    return out


@pytest.mark.parametrize("direction", ["backward", "forward"])
@pytest.mark.parametrize("how", ["left", "inner", "right"])
def test_streamed_asof_joins_equal_reference(direction, how):
    """Asof joins over commits to both sides with upserts among them, by
    key, each direction and each mode the port implements: equal to the
    reference at every tick, and the last rows equal to a plain loop over
    the last inputs."""

    def scenario(e):
        JoinMode = importlib.import_module(f"{e.pw.__name__}.internals.table").JoinMode
        trades, ts = e.stream(t=float, px=int, sym=str)
        quotes, qs = e.stream(t=float, bid=int, ticker=str)
        if how == "right":
            joined = e.temporal.asof_join_right(
                trades, quotes, trades.t, quotes.t, trades.sym == quotes.ticker, direction=direction
            )
        else:
            joined = e.temporal.asof_join(
                trades, quotes, trades.t, quotes.t, trades.sym == quotes.ticker,
                how=JoinMode.LEFT if how == "left" else JoinMode.INNER, direction=direction,
            )
        out = joined.select(t=trades.t, sym=trades.sym, px=trades.px, bid=quotes.bid)
        tsteps = _stream_commits(e, ts, _TRADES)
        qsteps = _stream_commits(e, qs, _QUOTES, first_key=500)
        steps = [lambda a=a, b=b: (a(), b()) for a, b in zip(tsteps, qsteps)]
        (qk, qrow), (tk, trow) = _UPSERTS["quotes"], _UPSERTS["trades"]
        steps.append(lambda: (e.put(qs, qk, qrow), e.put(ts, tk, trow)))
        return (out,), steps, None

    seen, _ticks = _both_driven(scenario)
    trades = dict(enumerate(r for rows in _TRADES for r in rows))
    quotes = dict(enumerate((r for rows in _QUOTES for r in rows), start=500))
    for name, rows in (("trades", trades), ("quotes", quotes)):
        key, row = _UPSERTS[name]
        rows[key] = row
    if how == "right":
        want = [(m[0], m[2], m[1], q[1]) if m else (None, None, None, q[1])
                for q, m in _asof_loop(quotes.values(), trades.values(), direction, False)]
    else:
        want = [(tr[0], tr[2], tr[1], m[1] if m else None)
                for tr, m in _asof_loop(trades.values(), quotes.values(), direction, how == "inner")]
    got = [tuple(dict(row)[c] for c in ("t", "sym", "px", "bid")) for _key, row in seen[-1][0][0]]
    assert want and sorted(got, key=repr) == sorted(want, key=repr)


def _port_join_mode():
    return importlib.import_module("pathway_tpu_torch.internals.table").JoinMode


_REFUSED = {
    "nearest": lambda tp, a, b: tp.asof_join(a, b, a.t, b.t, direction="nearest"),
    "defaults": lambda tp, a, b: tp.asof_join(a, b, a.t, b.t, defaults={b.v: -1}),
    "behavior": lambda tp, a, b: tp.asof_join(a, b, a.t, b.t, behavior=tp.common_behavior(cutoff=1.0)),
    "how_outer": lambda tp, a, b: tp.asof_join(a, b, a.t, b.t, how=_port_join_mode().OUTER),
    "how_right": lambda tp, a, b: tp.asof_join(a, b, a.t, b.t, how=_port_join_mode().RIGHT),
    "outer": lambda tp, a, b: tp.asof_join_outer(a, b, a.t, b.t),
    "right_defaults": lambda tp, a, b: tp.asof_join_right(a, b, a.t, b.t, defaults={a.v: 0}),
    "left_unknown_keyword": lambda tp, a, b: tp.asof_join_left(a, b, a.t, b.t, left_instance=a.v),
    "interval_unknown_keyword": lambda tp, a, b: tp.interval_join_left(a, b, a.t, b.t, tp.interval(-1, 1), how=None),
    "asof_now_unknown_keyword": lambda tp, a, b: tp.asof_now_join(a, b, a.v == b.v, defaults={b.v: 0}),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_port_refuses_temporal_joins_it_cannot_match(case):
    """The reference runs ``direction="nearest"`` as forward, OUTER and
    RIGHT as LEFT, and drops ``defaults``, ``behavior`` and unknown
    keywords: wrong rows without an error.  The port raises instead:
    ``NotImplementedError`` for an option, ``TypeError`` for an unknown
    keyword."""
    e = _Engine(pathway_tpu_torch)
    a, _ = e.stream(t=float, v=int)
    b, _ = e.stream(t=float, v=int)
    with pytest.raises(TypeError if case.endswith("unknown_keyword") else NotImplementedError, match=r"\w"):
        _REFUSED[case](e.temporal, a, b)


def test_streamed_window_join_and_diff_equal_reference():
    def scenario(e):
        lt_, ls = e.stream(t=float, v=int, k=str)
        rt_, rs = e.stream(t=float, v=int, k=str)
        joined = e.temporal.window_join(lt_, rt_, lt_.t, rt_.t, e.temporal.tumbling(6.0), lt_.k == rt_.k).select(
            lv=lt_.v, rv=rt_.v
        )
        diffs = e.pw.stdlib.ordered.diff(lt_, lt_.t, lt_.v, instance=lt_.k)
        lsteps = _stream_commits(e, ls, _time_rows(5, 4, 5, 2.0, 4.0))
        rsteps = _stream_commits(e, rs, _time_rows(6, 4, 5, 2.0, 4.0), first_key=1000)
        steps = [lambda a=a, b=b: (a(), b()) for a, b in zip(lsteps, rsteps)]
        return (joined, diffs), steps, None

    seen, _ticks = _both_driven(scenario)
    assert all(seen[-1][0])


def test_inactivity_detection_equals_reference():
    """Events and an injected clock, one step per instant: the port flags
    the same inactivity and the same resumed activity as the reference."""

    def scenario(e):
        events, es = e.stream(t=datetime.datetime)
        clock, cs = e.stream(timestamp_utc=datetime.datetime)
        inact, resumed = e.temporal.inactivity_detection(
            events.t, allowed_inactivity_period=datetime.timedelta(seconds=30), _now_table=clock
        )

        def at(seconds):
            return _T0 + datetime.timedelta(seconds=seconds)

        steps = [
            lambda: (e.put(es, 1, (at(0),)), e.put(es, 2, (at(5),))),
            lambda: e.put(cs, 100, (at(65),)),
            lambda: e.put(es, 3, (at(120),)),
            lambda: e.put(cs, 101, (at(125),)),
            lambda: e.put(cs, 102, (at(200),)),
            lambda: e.put(es, 4, (at(260),)),
        ]
        return (inact, resumed), steps, None

    seen, _ticks = _both_driven(scenario)
    inact_rows, resumed_rows = seen[-1][0]
    assert len(inact_rows) == 2 and len(resumed_rows) == 2


def test_utc_now_ticks_equal_reference():
    """``utc_now(max_ticks=3)`` runs on the wall clock: the same row ids in
    both packages, each value a time inside the run."""
    got = []
    for pw in PACKAGES:
        pw.reset()
        t0 = datetime.datetime.now(datetime.timezone.utc)
        now = pw.temporal.utc_now(refresh_rate=datetime.timedelta(milliseconds=5), max_ticks=3)
        pw.run(monitoring_level=None)
        t1 = datetime.datetime.now(datetime.timezone.utc)
        keys, cols = now._materialize()
        values = sorted(
            v.astype("datetime64[us]").item() if isinstance(v, np.datetime64) else v.replace(tzinfo=None)
            for v in cols["timestamp_utc"]
        )
        assert len(values) == 3
        assert t0.replace(tzinfo=None) <= values[0] <= values[-1] <= t1.replace(tzinfo=None)
        got.append(len(set(keys.tolist())))
    assert got == [3, 3]


def test_interpolate_modes_are_the_reference():
    assert [m.value for m in pathway_tpu_torch.statistical.InterpolateMode] == [
        m.value for m in pathway_tpu.stdlib.statistical.InterpolateMode
    ]
