"""Prometheus/OpenMetrics scrape endpoint of the port (counterpart of
``pathway_tpu/internals/metrics.py``; reference: src/engine/
http_server.rs:21-130 — per-process metrics server on port
20000+process_id exposing connector latencies and input/output stats).

Serves ``GET /metrics`` (plus ``/status`` and ``/serve_stats`` JSON) from a
daemon thread; gauges and counters are computed at scrape time from the
live engine graph, so there is no per-tick bookkeeping beyond the
rows_in/rows_out/process_ns counters the scheduler already maintains.

This is the ONE metrics surface: alongside the engine/connector series,
``/metrics`` renders the port's serve-path flight recorder
(``pathway_tpu_torch/observe`` — ``pathway_serve_*`` stage histograms,
``pathway_ivf_*`` index gauges, ``pathway_recompile_*`` compile census),
``/serve_stats`` serves the same recorder as a JSON summary (histogram
quantile estimates + the recent-event ring), ``/traces`` serves the
tail-sampled per-request span trees (``observe/trace.py``; ``?limit=N``
caps the payload), and ``/slo`` serves the burn-rate document from the
declarative SLO engine (``observe/slo.py`` — per-objective
fast/slow-window burn rates, alert state, and the advisory shed
verdict).  The port's recorder renders no exemplars: the OpenMetrics
form differs from the classic one only in its counter TYPE lines and
the closing ``# EOF``.

Scrape consistency: the engine graph's operator/table collections are
snapshotted (and each operator's counters read once) BEFORE any line is
formatted, so a scrape racing a commit tick sees one coherent view
instead of a list mutating mid-iteration.  Uptime is stamped at
``MetricsServer.start()`` — module import time is not a server lifetime.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .config import get_config

__all__ = ["start_metrics_server", "render_metrics", "MetricsServer"]

_started_at = time.time()


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def render_metrics(
    graph,
    started_at: Optional[float] = None,
    openmetrics: bool = False,
) -> str:
    """Render the engine graph's state in Prometheus text exposition
    format.  ``started_at`` is the serving process's start stamp (the
    MetricsServer passes its own); defaults to module import time for
    direct callers.  ``openmetrics=True`` (negotiated via the Accept
    header) renders the OpenMetrics counter TYPE lines and the
    terminating ``# EOF``."""
    # SNAPSHOT before rendering: fix the operator/table lists and read
    # each operator's counters exactly once, so a scrape racing a commit
    # tick cannot see a list mutating under iteration or one operator's
    # counters torn across two lines
    operators = list(graph.operators)
    tables = list(graph.tables)
    op_stats = [
        (
            _sanitize(op.name),
            op.id,
            op.rows_in,
            op.rows_out,
            op.process_ns,
            op.last_tick_ns,
        )
        for op in operators
    ]
    total_rows = sum(len(table.store) for table in tables)
    started = started_at if started_at is not None else _started_at
    lines = [
        "# TYPE pathway_uptime_seconds gauge",
        f"pathway_uptime_seconds {time.time() - started:.3f}",
        "# TYPE pathway_operators gauge",
        f"pathway_operators {len(operators)}",
        "# TYPE pathway_resident_rows gauge",
        f"pathway_resident_rows {total_rows}",
    ]
    # every family's samples stay CONTIGUOUS under its TYPE line: a
    # strict OpenMetrics parser treats a family's sample appearing after
    # another family opened as a clashing duplicate and fails the whole
    # scrape (this bit in practice whenever a GC-lingering connector
    # monitor put samples under the old interleaved block layout)
    op_in: list = []
    op_out: list = []
    op_proc: list = []
    op_tick: list = []
    for name, op_id, rows_in, rows_out, process_ns, last_tick_ns in op_stats:
        label = f'operator="{name}",id="{op_id}"'
        op_in.append(f"pathway_operator_rows_in_total{{{label}}} {rows_in}")
        op_out.append(f"pathway_operator_rows_out_total{{{label}}} {rows_out}")
        op_proc.append(
            f"pathway_operator_process_seconds_total{{{label}}} "
            f"{process_ns / 1e9:.6f}"
        )
        op_tick.append(
            f"pathway_operator_last_tick_seconds{{{label}}} "
            f"{last_tick_ns / 1e9:.6f}"
        )
    lines.append("# TYPE pathway_operator_rows_in_total counter")
    lines.extend(op_in)
    lines.append("# TYPE pathway_operator_rows_out_total counter")
    lines.extend(op_out)
    lines.append("# TYPE pathway_operator_process_seconds_total counter")
    lines.extend(op_proc)
    lines.append("# TYPE pathway_operator_last_tick_seconds gauge")
    lines.extend(op_tick)
    # per-connector ingestion/lag stats (reference: ConnectorMonitor,
    # src/connectors/monitoring.rs:237 scraped by http_server.rs)
    from ..io._offsets import connector_monitors

    conn_rows: list = []
    conn_lag: list = []
    conn_parts: list = []
    for mon in connector_monitors():
        stats = mon.stats()
        # id uniquifies the series: two sources may share a display name, and
        # duplicate label sets would fail the whole Prometheus scrape
        label = f'connector="{_sanitize(stats["name"])}",id="{mon.id}"'
        conn_rows.append(
            f"pathway_connector_rows_total{{{label},kind=\"insert\"}} "
            f"{stats['rows_inserted']}"
        )
        conn_rows.append(
            f"pathway_connector_rows_total{{{label},kind=\"delete\"}} "
            f"{stats['rows_deleted']}"
        )
        if stats["lag_seconds"] is not None:
            conn_lag.append(
                f"pathway_connector_lag_seconds{{{label}}} "
                f"{stats['lag_seconds']:.3f}"
            )
        conn_parts.append(
            f"pathway_connector_partitions{{{label}}} {stats['partitions']}"
        )
    lines.append("# TYPE pathway_connector_rows_total counter")
    lines.extend(conn_rows)
    lines.append("# TYPE pathway_connector_lag_seconds gauge")
    lines.extend(conn_lag)
    lines.append("# TYPE pathway_connector_partitions gauge")
    lines.extend(conn_parts)
    # serve-path flight recorder (observe/): stage histograms, IVF and
    # recompile series — the same scrape covers engine, connectors, and
    # the ML hot path
    from .. import observe

    lines.extend(observe.render_prometheus(openmetrics=openmetrics))
    if openmetrics:
        # OpenMetrics counter semantics: the FAMILY name must not carry
        # the `_total` suffix — the sample does (`# TYPE x counter` +
        # `x_total 3`).  The classic rendering declares `# TYPE x_total
        # counter`, which a strict OM parser rejects as a clashing
        # name, failing the whole scrape — exactly what the content
        # negotiation exists to prevent.
        lines = [_om_type_line(line) for line in lines]
        lines.append("# EOF")
    lines.append("")
    return "\n".join(lines)


def _om_type_line(line: str) -> str:
    """Rewrite one classic `# TYPE <x>_total counter` declaration into
    its OpenMetrics form (`# TYPE <x> counter`); everything else passes
    through untouched."""
    if line.startswith("# TYPE ") and line.endswith(" counter"):
        name = line[len("# TYPE "):-len(" counter")]
        if name.endswith("_total"):
            return f"# TYPE {name[:-len('_total')]} counter"
    return line


class MetricsServer:
    def __init__(
        self, graph, port: Optional[int] = None, host: Optional[str] = None
    ):
        cfg = get_config()
        self.graph = graph
        # loopback by default (the reference binds 127.0.0.1 too,
        # http_server.rs:98); set PATHWAY_METRICS_HOST=0.0.0.0 for external
        # scraping
        self.host = host or getattr(cfg, "metrics_host", "127.0.0.1")
        self.port = (
            port
            if port is not None
            else cfg.metrics_port + cfg.process_id
        )
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started_at = time.time()  # re-stamped at start()

    def start(self) -> "MetricsServer":
        graph = self.graph
        # uptime means THIS server's lifetime, not module import time
        self._started_at = started_at = time.time()

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path.startswith("/metrics"):
                    # content negotiation: a classic scraper gets the
                    # plain rendering it can parse
                    accept = self.headers.get("Accept", "") or ""
                    om = "application/openmetrics-text" in accept
                    body = render_metrics(
                        graph, started_at=started_at, openmetrics=om
                    ).encode()
                    ctype = (
                        "application/openmetrics-text; version=1.0.0; "
                        "charset=utf-8"
                        if om
                        else "text/plain; version=0.0.4"
                    )
                elif self.path.startswith("/serve_stats"):
                    from .. import observe

                    body = json.dumps(observe.snapshot()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/slo"):
                    # declarative SLO burn-rate document (observe/slo.py):
                    # per-objective multi-window burn rates + alert state.
                    # The chaos contract inside evaluate() makes this
                    # stale-on-fault, never a 500.
                    from ..observe import slo as _slo

                    body = json.dumps(_slo.evaluate()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/traces"):
                    # kept (tail-sampled) per-request span trees
                    from ..observe import trace as _trace

                    limit = None
                    query = urlparse(self.path).query
                    raw = parse_qs(query).get("limit")
                    if raw:
                        try:
                            limit = int(raw[0])
                        except ValueError:
                            limit = None
                    body = json.dumps(_trace.snapshot_traces(limit)).encode()
                    ctype = "application/json"
                elif self.path.startswith("/status"):
                    body = json.dumps(
                        {
                            "operators": len(list(graph.operators)),
                            "resident_rows": sum(
                                len(t.store) for t in list(graph.tables)
                            ),
                            "uptime_s": time.time() - started_at,
                        }
                    ).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # pragma: no cover
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="pw-metrics"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None


_server: Optional[MetricsServer] = None


def start_metrics_server(graph, port: Optional[int] = None) -> MetricsServer:
    global _server
    if _server is not None:
        _server.stop()
    _server = MetricsServer(graph, port).start()
    return _server
