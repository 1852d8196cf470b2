"""Interactive mode (``pw.enable_interactive_mode``, ``pw.LiveTable``) and
``pw.viz`` of the port against the reference.

``LiveTable`` runs its table's graph on a background thread and shows the
current rows: both packages' snapshots, text, pandas frames and HTML must
be equal.  ``viz.live_plot`` serves a live page and the rows' JSON while a
stream runs: both packages must show a partial state mid-run and end at
the same rows.  ``viz.plot`` uses bokeh, else matplotlib, else raises
``ImportError``: bokeh is installed nowhere here, so with matplotlib
hidden both packages raise, and with it both draw the same points; a
``plotting_function`` (a bokeh callback) the reference's matplotlib
snapshot drops makes the port raise.
Values are ints and floats computed the same way, compared exactly.
"""

import importlib
import json
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.io import _connector as ref_connector
from pathway_tpu_torch.io import _connector as port_connector

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


@pytest.fixture()
def interactive(monkeypatch):
    """Each package's interactive module with no controller; a controller
    a test starts is stopped (its run thread joined) afterwards."""
    mods = [importlib.import_module(f"{pw.__name__}.internals.interactive") for pw in PACKAGES]
    for mod in mods:
        monkeypatch.setattr(mod, "_controller", None)
    yield mods
    for mod in mods:
        if mod._controller is not None and mod._controller._thread is not None:
            mod._controller._thread.join(timeout=30)


def test_live_table_without_interactive_mode_raises_as_the_reference(interactive):
    for pw in PACKAGES:
        t = pw.debug.table_from_markdown("""
          | a
        1 | 1
        """)
        with pytest.raises(RuntimeError, match="interactive mode is not enabled"):
            pw.LiveTable.create(t)
        assert not importlib.import_module(f"{pw.__name__}.internals.interactive").is_interactive_mode_enabled()


def test_live_table_snapshot_equals_the_reference(interactive):
    """``tests/test_api_parity.py``'s case, with seeded rows: the
    background run reaches every row, and every view of it is equal."""
    rows = [(int(a),) for a in np.random.default_rng(8).integers(0, 100, 6)]
    got = []
    for pw in PACKAGES:
        t = pw.debug.table_from_rows(pw.schema_from_types(a=int), rows)
        doubled = t.select(b=pw.this.a * 2)
        controller = pw.enable_interactive_mode()
        assert pw.enable_interactive_mode() is controller
        live = pw.LiveTable.create(doubled)
        deadline = time.time() + 10
        while time.time() < deadline and len(live.snapshot()[0]) < len(rows):
            time.sleep(0.05)
        controller._thread.join(timeout=30)
        keys, cols = live.snapshot()
        frame = live.to_pandas()
        got.append((sorted(zip((int(k) for k in keys), (int(b) for b in cols["b"]))), str(live),
                    [int(v) for v in frame["b"]], [int(k) for k in frame.index], live._repr_html_()))
    assert got[1] == got[0]
    assert sorted(b for _k, b in got[1][0]) == sorted(2 * a for (a,) in rows)


def _live_plot_run(pw):
    class Row(pw.Schema):
        t: int = pw.column_definition(primary_key=True)
        v: float

    class Subj(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(5):
                self.next(t=i, v=float(i * i))
                time.sleep(0.3)

    src = pw.io.python.read(Subj(), schema=Row)
    server = pw.viz.live_plot(src, x="t", y="v")
    done = threading.Event()

    def run():
        pw.run(monitoring_level=None, commit_duration_ms=50)
        done.set()

    threading.Thread(target=run).start()
    mid = None  # the page shows a partial state mid-run (live, not post hoc)
    deadline = time.time() + 30
    while time.time() < deadline:
        snap = json.loads(urllib.request.urlopen(server.url + "data", timeout=5).read())
        if 0 < len(snap["rows"]) < 5:
            mid = snap
            break
        time.sleep(0.05)
    page = urllib.request.urlopen(server.url, timeout=5).read().decode()
    assert done.wait(20)
    final = json.loads(urllib.request.urlopen(server.url + "data", timeout=5).read())
    assert server.snapshot()["rows"] == final["rows"]
    server.close()
    return mid, page, final


def test_live_plot_streams_updates_as_the_reference():
    """``tests/test_viz_live.py``'s case through both packages."""
    got = [_live_plot_run(pw) for pw in PACKAGES]
    for mid, page, final in got:
        assert mid is not None and mid["time"] > 0, "never observed a partial live snapshot"
        assert "<svg" in page and 'fetch("/data")' in page
        assert sorted(r["v"] for r in final["rows"]) == [0.0, 1.0, 4.0, 9.0, 16.0]
    assert sorted(map(str, got[1][2]["rows"])) == sorted(map(str, got[0][2]["rows"]))


def _plot_table(pw):
    rng = np.random.default_rng(12)
    rows = [(int(x), float(y)) for x, y in zip(rng.permutation(8), rng.random(8))]
    t = pw.debug.table_from_rows(pw.schema_from_types(x=int, y=float), rows)
    pw.run(monitoring_level=None)
    return t


def test_plot_without_bokeh_or_matplotlib_raises_as_the_reference(monkeypatch):
    for name in ("bokeh", "bokeh.plotting", "matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)
    for pw in PACKAGES:
        t = _plot_table(pw)
        with pytest.raises(ImportError, match="needs bokeh"):
            pw.viz.plot(t, x="x", y="y", sorting_col="x")
        pw.reset()


def test_plot_falls_back_to_matplotlib_as_the_reference(monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.setitem(sys.modules, "bokeh", None)
    monkeypatch.setitem(sys.modules, "bokeh.plotting", None)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    got = []
    for pw in PACKAGES:
        fig = pw.viz.plot(_plot_table(pw), x="x", y="y", sorting_col="x")
        (line,) = fig.axes[0].lines
        got.append((line.get_xydata().tolist(), fig.axes[0].get_xlabel(), fig.axes[0].get_ylabel()))
        plt.close(fig)
        pw.reset()
    assert got[1] == got[0]
    assert [x for x, _y in got[1][0]] == list(range(8)) and got[1][1:] == ("x", "y")


def test_plot_refuses_a_plotting_function_without_bokeh(monkeypatch):
    """``plotting_function`` takes a bokeh source: without bokeh the
    reference's matplotlib snapshot drops it, the port raises."""
    pytest.importorskip("matplotlib")
    monkeypatch.setitem(sys.modules, "bokeh", None)
    monkeypatch.setitem(sys.modules, "bokeh.plotting", None)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    called = []
    fig = pathway_tpu.viz.plot(_plot_table(pathway_tpu), called.append, x="x", y="y")
    assert called == [] and fig.axes[0].lines
    plt.close(fig)
    with pytest.raises(ImportError, match="plotting_function=.*needs bokeh"):
        pathway_tpu_torch.viz.plot(_plot_table(pathway_tpu_torch), called.append, x="x", y="y")
