"""pw.viz of the port — live table visualization (counterpart of
``pathway_tpu/stdlib/viz``;
reference: python/pathway/stdlib/viz/ — bokeh/panel streaming plots wired
to the update stream, plus Table._repr_mimebundle_ for notebooks).

The LIVE surface here is ``live_plot``: a zero-dependency dashboard —
a subscribe callback maintains the table's current state, a loopback HTTP
server serves a self-contained HTML page whose inline JS polls the JSON
snapshot and redraws an SVG chart while ``pw.run`` streams.  This is the
reference's bokeh/panel capability rebuilt for a headless host where
those libraries are not bundled; ``plot``/``show`` additionally fall back
to matplotlib/text snapshots so notebook and script code stays importable
either way."""

from __future__ import annotations

import json
import threading
from typing import Any, Callable, Optional

__all__ = ["plot", "show", "table_snapshot", "live_plot", "LivePlotServer"]


def table_snapshot(table, limit: int = 20):
    """Current rows of a table as a list of dicts (post-run)."""
    keys, cols = table._materialize()
    names = list(cols)
    out = []
    for i, k in enumerate(keys[:limit]):
        row = {"id": int(k)}
        row.update({n: cols[n][i] for n in names})
        out.append(row)
    return out


def show(table, include_id: bool = True, limit: int = 20) -> None:
    """Print a snapshot of the table (reference: pw.Table.show / viz.show;
    with panel installed the reference renders a live widget — here a text
    table, which is what a headless host can always do)."""
    rows = table_snapshot(table, limit)
    if not rows:
        print("<empty table>")
        return
    names = [n for n in rows[0] if include_id or n != "id"]
    widths = {
        n: max(len(str(n)), *(len(str(r[n])) for r in rows)) for n in names
    }
    header = " | ".join(str(n).ljust(widths[n]) for n in names)
    print(header)
    print("-" * len(header))
    for r in rows:
        print(" | ".join(str(r[n]).ljust(widths[n]) for n in names))


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>pathway live plot</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 1.5rem; }}
 svg {{ border: 1px solid #ccc; background: #fafafa; }}
 table {{ border-collapse: collapse; margin-top: 1rem; font-size: 0.85rem; }}
 td, th {{ border: 1px solid #ddd; padding: 2px 8px; }}
 #meta {{ color: #666; font-size: 0.8rem; }}
</style></head>
<body>
<h3>{title}</h3>
<div id="meta"></div>
<svg id="chart" width="640" height="360" viewBox="0 0 640 360"></svg>
<table id="rows"></table>
<script>
const XCOL = {xcol!r}, YCOL = {ycol!r};
async function tick() {{
  try {{
    const resp = await fetch("/data");
    const body = await resp.json();
    render(body);
  }} catch (e) {{}}
  setTimeout(tick, 500);
}}
function render(body) {{
  const rows = body.rows;
  document.getElementById("meta").textContent =
    rows.length + " rows, updated " + new Date().toLocaleTimeString() +
    " (time " + body.time + ")";
  const svg = document.getElementById("chart");
  svg.innerHTML = "";
  const pts = rows
    .map(r => [Number(r[XCOL]), Number(r[YCOL])])
    .filter(p => isFinite(p[0]) && isFinite(p[1]))
    .sort((a, b) => a[0] - b[0]);
  if (pts.length) {{
    const xs = pts.map(p => p[0]), ys = pts.map(p => p[1]);
    const x0 = Math.min(...xs), x1 = Math.max(...xs) || x0 + 1;
    const y0 = Math.min(...ys), y1 = Math.max(...ys) || y0 + 1;
    const sx = v => 40 + 580 * (v - x0) / ((x1 - x0) || 1);
    const sy = v => 330 - 300 * (v - y0) / ((y1 - y0) || 1);
    let d = "";
    pts.forEach((p, i) => {{
      d += (i ? "L" : "M") + sx(p[0]).toFixed(1) + "," + sy(p[1]).toFixed(1);
      const c = document.createElementNS("http://www.w3.org/2000/svg", "circle");
      c.setAttribute("cx", sx(p[0])); c.setAttribute("cy", sy(p[1]));
      c.setAttribute("r", 3); c.setAttribute("fill", "#2563eb");
      svg.appendChild(c);
    }});
    const path = document.createElementNS("http://www.w3.org/2000/svg", "path");
    path.setAttribute("d", d); path.setAttribute("stroke", "#93c5fd");
    path.setAttribute("fill", "none");
    svg.insertBefore(path, svg.firstChild);
  }}
  // build via textContent, never innerHTML: streamed string cells may carry
  // markup (user-supplied documents) and must not execute in the dashboard
  const tbl = document.getElementById("rows");
  tbl.replaceChildren();
  const names = rows.length ? Object.keys(rows[0]) : [];
  const head = document.createElement("tr");
  names.forEach(n => {{
    const th = document.createElement("th"); th.textContent = n;
    head.appendChild(th);
  }});
  tbl.appendChild(head);
  rows.slice(0, 25).forEach(r => {{
    const tr = document.createElement("tr");
    names.forEach(n => {{
      const td = document.createElement("td");
      td.textContent = String(r[n]);
      tr.appendChild(td);
    }});
    tbl.appendChild(tr);
  }});
}}
tick();
</script></body></html>
"""


class LivePlotServer:
    """Streams a table's CURRENT state to a browser: a subscribe callback
    maintains the snapshot incrementally (insertions/retractions), a
    loopback HTTP server serves / (self-contained SVG page) and /data
    (JSON).  The analog of the reference's bokeh streaming figure
    (stdlib/viz/), with zero extra dependencies."""

    def __init__(self, table, x: Optional[str], y: Optional[str], port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from ...io._connector import jsonable
        from ...io._subscribe import subscribe

        names = table.column_names
        self.xcol = x or (names[0] if names else "")
        self.ycol = y or (names[1] if len(names) > 1 else self.xcol)
        self._lock = threading.Lock()
        self._rows: dict = {}
        self._time = 0

        def on_change(key, row, time, is_addition):
            with self._lock:
                if is_addition:
                    self._rows[int(key)] = {
                        n: jsonable(row[n]) for n in names
                    }
                else:
                    self._rows.pop(int(key), None)
                self._time = time

        subscribe(table, on_change=on_change)
        page = _PAGE.format(
            title=f"{table._short_name}: {self.ycol} over {self.xcol}",
            xcol=self.xcol,
            ycol=self.ycol,
        ).encode()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/data":
                    with outer._lock:
                        body = json.dumps(
                            {
                                "time": outer._time,
                                "rows": list(outer._rows.values()),
                            }
                        ).encode()
                    ctype = "application/json"
                elif self.path == "/":
                    body, ctype = page, "text/html"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        # loopback-bound, like the metrics server (round-1 advice)
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="live-plot"
        ).start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/"

    def snapshot(self) -> dict:
        with self._lock:
            return {"time": self._time, "rows": list(self._rows.values())}

    def close(self) -> None:
        self._httpd.shutdown()


def live_plot(
    table, *, x: Optional[str] = None, y: Optional[str] = None, port: int = 0
) -> LivePlotServer:
    """Serve a live-updating plot of ``table`` at the returned server's
    ``.url`` while the pipeline runs (reference: viz.plot + panel's
    streaming widget)."""
    return LivePlotServer(table, x, y, port)


def plot(
    table,
    plotting_function: Optional[Callable[..., Any]] = None,
    *,
    x: Optional[str] = None,
    y: Optional[str] = None,
    sorting_col: Optional[str] = None,
):
    """Plot a table column pair (reference: viz.plot wires a bokeh figure to
    the live update stream).  Uses bokeh when importable, else matplotlib
    (static snapshot), else raises with guidance."""
    rows = None
    try:
        import bokeh.plotting  # type: ignore  # pragma: no cover - not bundled

        have_bokeh = True
    except ImportError:
        have_bokeh = False
    if have_bokeh:  # pragma: no cover - bokeh not bundled in this image
        rows = table_snapshot(table, limit=10**6)
        if sorting_col:
            rows.sort(key=lambda r: r[sorting_col])
        if plotting_function is not None:
            # errors here (e.g. pandas missing) must surface — silently
            # dropping the user's plotting_function would be worse
            import pandas as pd

            from bokeh.models import ColumnDataSource

            return plotting_function(ColumnDataSource(pd.DataFrame(rows)))
        fig = bokeh.plotting.figure()
        names = [n for n in (rows[0] if rows else {}) if n != "id"]
        xcol = x or (names[0] if names else None)
        ycol = y or (names[1] if len(names) > 1 else xcol)
        if rows and xcol is not None:
            fig.scatter([r[xcol] for r in rows], [r[ycol] for r in rows])
        return fig
    if plotting_function is not None:
        # it takes a bokeh ColumnDataSource: the reference's matplotlib
        # snapshot drops it without a word
        raise ImportError("pw.viz.plot(plotting_function=...) needs bokeh, which is not installed")
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "pw.viz.plot needs bokeh (live) or matplotlib (snapshot); "
            "neither is installed"
        ) from e
    if rows is None:
        rows = table_snapshot(table, limit=10**6)
        if sorting_col:
            rows.sort(key=lambda r: r[sorting_col])
    names = [n for n in (rows[0] if rows else {}) if n != "id"]
    xcol = x or (names[0] if names else None)
    ycol = y or (names[1] if len(names) > 1 else xcol)
    fig, ax = plt.subplots()
    if rows and xcol is not None:
        ax.plot([r[xcol] for r in rows], [r[ycol] for r in rows], marker="o")
        ax.set_xlabel(xcol)
        ax.set_ylabel(ycol)
    return fig
