"""OpenTelemetry traces + metrics for engine runs (counterpart of
``pathway_tpu/internals/telemetry.py``; reference:
src/engine/telemetry.rs:78-405 — OTLP traces with graph spans,
process/stats gauges, opt-in via the monitoring server config; python side
graph_runner/__init__.py:146-172 wraps build/run in spans with graph stats
as attributes).

Opt-in: set ``PATHWAY_MONITORING_SERVER`` (an OTLP endpoint), call
``pw.set_monitoring_config(server_endpoint=...)``, or pass ``endpoint`` to
``maybe_telemetry``.  Without the opentelemetry packages or an endpoint,
every hook degrades to a no-op — pipelines never depend on it.  ``pw.run``
wraps the run in a ``pathway.run`` span carrying the graph's operator and
table counts; ``observe.recorder.emit_span`` exports serve spans through
the same object.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Iterator, Optional

from .config import get_config

logger = logging.getLogger(__name__)

__all__ = ["NoopTelemetry", "Telemetry", "maybe_telemetry"]


class Telemetry:
    """Span + gauge emitter bound to one engine run."""

    def __init__(self, endpoint: str, service_name: str = "pathway-tpu-torch"):
        from opentelemetry import metrics, trace
        from opentelemetry.sdk.resources import Resource

        resource = Resource.create(
            {
                "service.name": service_name,
                "process.id": get_config().process_id,
            }
        )
        self._tracer_provider = None
        self._meter_provider = None
        try:
            from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
                OTLPSpanExporter,
            )
            from opentelemetry.sdk.trace import TracerProvider
            from opentelemetry.sdk.trace.export import BatchSpanProcessor

            provider = TracerProvider(resource=resource)
            provider.add_span_processor(
                BatchSpanProcessor(OTLPSpanExporter(endpoint=endpoint))
            )
            self._tracer_provider = provider
            self.tracer = provider.get_tracer("pathway_tpu_torch")
        except Exception:  # pragma: no cover - exporter wiring is env-specific
            self.tracer = trace.get_tracer("pathway_tpu_torch")
        try:
            from opentelemetry.exporter.otlp.proto.grpc.metric_exporter import (
                OTLPMetricExporter,
            )
            from opentelemetry.sdk.metrics import MeterProvider
            from opentelemetry.sdk.metrics.export import (
                PeriodicExportingMetricReader,
            )

            reader = PeriodicExportingMetricReader(
                OTLPMetricExporter(endpoint=endpoint), export_interval_millis=5000
            )
            mp = MeterProvider(resource=resource, metric_readers=[reader])
            self._meter_provider = mp
            meter = mp.get_meter("pathway_tpu_torch")
        except Exception:  # pragma: no cover
            meter = metrics.get_meter("pathway_tpu_torch")
        self._graph = None
        self._rows_gauge = meter.create_observable_gauge(
            "pathway.resident_rows",
            callbacks=[self._observe_rows],
            description="rows resident across engine table stores",
        )
        self._ops_counter = meter.create_observable_counter(
            "pathway.operator.rows_in",
            callbacks=[self._observe_rows_in],
            description="delta rows consumed per operator",
        )

    # -- gauge callbacks --------------------------------------------------
    def _observe_rows(self, options):
        from opentelemetry.metrics import Observation

        if self._graph is None:
            return []
        return [
            Observation(sum(len(t.store) for t in self._graph.tables))
        ]

    def _observe_rows_in(self, options):
        from opentelemetry.metrics import Observation

        if self._graph is None:
            return []
        return [
            Observation(op.rows_in, {"operator": op.name, "id": op.id})
            for op in self._graph.operators
        ]

    # -- run wiring -------------------------------------------------------
    def attach(self, graph) -> None:
        self._graph = graph

    @contextlib.contextmanager
    def span(self, name: str, **attributes: Any) -> Iterator[Any]:
        with self.tracer.start_as_current_span(name) as s:
            for k, v in attributes.items():
                s.set_attribute(k, v)
            yield s

    def shutdown(self) -> None:
        for p in (self._tracer_provider, self._meter_provider):
            if p is not None:
                try:
                    p.shutdown()
                except Exception:  # pragma: no cover
                    pass


class _NoopSpan:
    def set_attribute(self, *a, **k):
        pass


class NoopTelemetry:
    def attach(self, graph) -> None:
        pass

    @contextlib.contextmanager
    def span(self, name: str, **attributes: Any) -> Iterator[Any]:
        yield _NoopSpan()

    def shutdown(self) -> None:
        pass


def maybe_telemetry(endpoint: Optional[str] = None):
    """Telemetry bound to the configured OTLP endpoint, or a no-op
    (reference: maybe_run_telemetry_thread, telemetry.rs:407)."""
    endpoint = endpoint or get_config().monitoring_server
    if not endpoint:
        return NoopTelemetry()
    try:
        return Telemetry(endpoint)
    except Exception:
        logger.warning(
            "telemetry requested (%s) but opentelemetry is unavailable; "
            "continuing without it",
            endpoint,
        )
        return NoopTelemetry()
