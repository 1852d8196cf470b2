"""The port's OTLP telemetry (``pathway_tpu_torch/internals/telemetry.py``,
its wiring in ``pw.run`` and in ``observe.recorder.emit_span``) against
the reference's, over a fake ``opentelemetry`` injected into
``sys.modules``: the SDK's providers, processors and OTLP exporters are
recording stand-ins, so nothing leaves the process.

With an endpoint set (``pw.set_monitoring_config``) both packages send
the same ``pathway.run`` span with the graph's ``operators`` and
``tables`` counts, export ``emit_span``'s span with its attributes, hand
the endpoint to both exporters and shut the providers down; without an
endpoint, with observe switched off, or without ``opentelemetry``, no
span is sent and the run is unchanged."""

from __future__ import annotations

import contextlib
import importlib
import sys
import types

import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.io import _connector as ref_connector
from pathway_tpu_torch.io import _connector as port_connector

PACKAGES = (pathway_tpu, pathway_tpu_torch)
ENDPOINT = "http://collector:4317"


class Recorder:
    """What the fake SDK saw: spans ``(tracer, name, attributes)``,
    exporters' endpoints, resources, instruments and shutdowns."""

    def __init__(self):
        self.spans, self.endpoints, self.resources, self.instruments, self.shutdowns = [], [], [], [], []


def fake_opentelemetry(rec: Recorder) -> dict:
    """The modules of a recording ``opentelemetry`` SDK, by name."""

    class Span:
        def __init__(self, attrs):
            self.attrs = attrs

        def set_attribute(self, key, value):
            self.attrs[key] = value

    class Tracer:
        def __init__(self, name):
            self.name = name

        @contextlib.contextmanager
        def start_as_current_span(self, name):
            span = Span({})
            yield span
            rec.spans.append((self.name, name, dict(span.attrs)))

    class Meter:
        def create_observable_gauge(self, name, callbacks, description=""):
            rec.instruments.append(("gauge", name, [cb(None) for cb in callbacks]))

        def create_observable_counter(self, name, callbacks, description=""):
            rec.instruments.append(("counter", name, [cb(None) for cb in callbacks]))

    class Provider:
        def __init__(self, kind, resource=None, metric_readers=()):
            self.kind = kind
            rec.resources.append(dict(resource.attrs))

        def add_span_processor(self, processor):
            pass

        def get_tracer(self, name):
            return Tracer(name)

        def get_meter(self, name):
            return Meter()

        def shutdown(self):
            rec.shutdowns.append(self.kind)

    class Exporter:
        def __init__(self, kind, endpoint):
            rec.endpoints.append((kind, endpoint))

    def module(name, **attrs):
        mod = types.ModuleType(name)
        mod.__dict__.update(attrs)
        return mod

    resources = module("opentelemetry.sdk.resources", Resource=types.SimpleNamespace(
        create=lambda attrs: types.SimpleNamespace(attrs=attrs)))
    trace = module("opentelemetry.trace", get_tracer=Tracer)
    metrics = module("opentelemetry.metrics", get_meter=lambda name: Meter(),
                     Observation=lambda value, attributes=None: (value, attributes))
    mods = {
        "opentelemetry": module("opentelemetry", trace=trace, metrics=metrics),
        "opentelemetry.trace": trace,
        "opentelemetry.metrics": metrics,
        "opentelemetry.sdk": module("opentelemetry.sdk"),
        "opentelemetry.sdk.resources": resources,
        "opentelemetry.sdk.trace": module("opentelemetry.sdk.trace", TracerProvider=lambda resource: Provider(
            "trace", resource)),
        "opentelemetry.sdk.trace.export": module("opentelemetry.sdk.trace.export", BatchSpanProcessor=lambda e: e),
        "opentelemetry.sdk.metrics": module("opentelemetry.sdk.metrics", MeterProvider=lambda resource,
                                            metric_readers: Provider("metrics", resource, metric_readers)),
        "opentelemetry.sdk.metrics.export": module("opentelemetry.sdk.metrics.export",
                                                   PeriodicExportingMetricReader=lambda e, export_interval_millis: e),
        "opentelemetry.exporter.otlp.proto.grpc.trace_exporter": module(
            "opentelemetry.exporter.otlp.proto.grpc.trace_exporter",
            OTLPSpanExporter=lambda endpoint: Exporter("trace", endpoint)),
        "opentelemetry.exporter.otlp.proto.grpc.metric_exporter": module(
            "opentelemetry.exporter.otlp.proto.grpc.metric_exporter",
            OTLPMetricExporter=lambda endpoint: Exporter("metrics", endpoint)),
    }
    for name in ("opentelemetry.exporter", "opentelemetry.exporter.otlp", "opentelemetry.exporter.otlp.proto",
                 "opentelemetry.exporter.otlp.proto.grpc"):
        mods[name] = module(name)
    return mods


def _recorder_of(pw):
    return importlib.import_module(f"{pw.__name__}.observe.recorder")


@pytest.fixture
def otel(monkeypatch):
    """A fresh recording SDK in ``sys.modules``, the endpoint unset and
    ``emit_span``'s cached exporter dropped in both packages (restored
    after)."""
    rec = Recorder()
    for name, mod in fake_opentelemetry(rec).items():
        monkeypatch.setitem(sys.modules, name, mod)
    for pw in PACKAGES:
        monkeypatch.setattr(pw.get_config(), "monitoring_server", None)
        monkeypatch.setattr(_recorder_of(pw), "_spans_on", None)
        monkeypatch.setattr(_recorder_of(pw), "_telemetry", None)
    monkeypatch.setattr(ref_connector, "_source_counter", [0])
    monkeypatch.setattr(port_connector, "_source_counter", [0])
    yield rec
    for pw in PACKAGES:
        pw.reset()


def _pipeline_run(pw):
    """A small graph (a filter and a reduce over a markdown table, one
    subscriber) run to its end; returns the rows."""
    pw.reset()
    t = pw.debug.table_from_markdown(
        """
        word  | cnt
        alpha | 1
        beta  | 2
        alpha | 3
        """
    )
    out = t.filter(t.cnt > 1).groupby(pw.this.word).reduce(pw.this.word, total=pw.reducers.sum(pw.this.cnt))
    rows = []
    pw.io.subscribe(out, on_change=lambda key, row, time, is_addition: rows.append((row["word"], row["total"])))
    pw.run(monitoring_level=None)
    return sorted(rows)


def _graph_counts(pw):
    g = importlib.import_module(f"{pw.__name__}.internals.parse_graph").G.engine_graph
    return {"operators": len(g.operators), "tables": len(g.tables)}


def test_run_span_and_exporters_equal_the_reference(otel):
    seen = []
    for pw in PACKAGES:
        pw.set_monitoring_config(server_endpoint=ENDPOINT)
        rows = _pipeline_run(pw)
        seen.append((rows, [(name, attrs) for _tracer, name, attrs in otel.spans], list(otel.endpoints),
                     [(kind, name) for kind, name, _obs in otel.instruments], list(otel.shutdowns),
                     _graph_counts(pw)))
        assert otel.spans[-1][0] == ("pathway_tpu" if pw is pathway_tpu else "pathway_tpu_torch")
        assert otel.resources[-1]["service.name"] == ("pathway-tpu" if pw is pathway_tpu else "pathway-tpu-torch")
        otel.__init__()
    ref, port = seen
    assert port == ref
    rows, spans, endpoints, instruments, shutdowns, counts = port
    assert rows == [("alpha", 3), ("beta", 2)]
    assert spans == [("pathway.run", counts)]
    assert endpoints == [("trace", ENDPOINT), ("metrics", ENDPOINT)]
    assert instruments == [("gauge", "pathway.resident_rows"), ("counter", "pathway.operator.rows_in")]
    assert shutdowns == ["trace", "metrics"]


def test_emit_span_exports_equal_the_reference(otel):
    got = []
    for pw in PACKAGES:
        pw.set_monitoring_config(server_endpoint=ENDPOINT)
        _recorder_of(pw).emit_span("serve.batch", batch=64, stage="rescore", queue_ms=1.5)
        _recorder_of(pw).emit_span("serve.batch", batch=3, stage="encode", queue_ms=0.25)
        got.append([(name, attrs) for _tracer, name, attrs in otel.spans])
        otel.__init__()
    assert got[1] == got[0] == [("serve.batch", {"batch": 64, "stage": "rescore", "queue_ms": 1.5}),
                                ("serve.batch", {"batch": 3, "stage": "encode", "queue_ms": 0.25})]


def test_no_endpoint_no_span(otel):
    """Without an endpoint telemetry is a no-op in both packages: the run's
    rows are the same and no span, exporter or provider is made."""
    rows = []
    for pw in PACKAGES:
        rows.append(_pipeline_run(pw))
        _recorder_of(pw).emit_span("serve.batch", batch=1)
        telemetry = importlib.import_module(f"{pw.__name__}.internals.telemetry")
        assert isinstance(telemetry.maybe_telemetry(), telemetry.NoopTelemetry)
    assert rows[1] == rows[0] == [("alpha", 3), ("beta", 2)]
    assert (otel.spans, otel.endpoints, otel.resources, otel.shutdowns) == ([], [], [], [])


def test_observe_off_exports_no_span(otel):
    """``emit_span`` is gated on the observe switch, as every record call
    is: switched off, nothing is exported in either package."""
    for pw in PACKAGES:
        pw.set_monitoring_config(server_endpoint=ENDPOINT)
        recorder = _recorder_of(pw)
        was = recorder.enabled() if callable(getattr(recorder, "enabled", None)) else None
        recorder.set_enabled(False)
        try:
            recorder.emit_span("serve.batch", batch=1)
        finally:
            recorder.set_enabled(True if was is None else was)
    assert otel.spans == []


def test_without_opentelemetry_the_run_goes_on(otel, monkeypatch, caplog):
    """An endpoint but no ``opentelemetry``: both packages warn once per
    run and run without telemetry."""
    monkeypatch.setitem(sys.modules, "opentelemetry", None)
    rows = []
    for pw in PACKAGES:
        pw.set_monitoring_config(server_endpoint=ENDPOINT)
        with caplog.at_level("WARNING"):
            rows.append(_pipeline_run(pw))
        telemetry = importlib.import_module(f"{pw.__name__}.internals.telemetry")
        assert isinstance(telemetry.maybe_telemetry(), telemetry.NoopTelemetry)
    assert rows[1] == rows[0] == [("alpha", 3), ("beta", 2)]
    warned = {r.name for r in caplog.records if "opentelemetry is unavailable" in r.getMessage()}
    assert warned == {"pathway_tpu.internals.telemetry", "pathway_tpu_torch.internals.telemetry"}
    assert otel.spans == []
