"""The port's serve-path flight recorder (counterpart of
``pathway_tpu/observe``): stage histograms, counters, gauges and
providers under the reference's family names (``recorder.py``),
per-request span trees with tail sampling (``trace.py``) and the SLO
burn-rate engine behind the scheduler's shed probe (``slo.py``).  The
registry is the port's own; ``PATHWAY_OBSERVE=0`` or
``set_enabled(False)`` reduces every record call to a flag check.

The reference's device-time profiler and HBM ledger wait for a later
slice of the port.
"""

from . import slo, trace
from .histogram import N_BUCKETS, EventRing, LatencyHistogram, bucket_bounds_s
from .recorder import (
    Counter,
    Gauge,
    counter,
    emit_span,
    gauge,
    histogram,
    next_id,
    record_event,
    record_occupancy,
    register_provider,
    render_prometheus,
    reset,
    set_enabled,
    snapshot,
)

__all__ = [
    "Counter",
    "EventRing",
    "Gauge",
    "LatencyHistogram",
    "N_BUCKETS",
    "bucket_bounds_s",
    "counter",
    "emit_span",
    "gauge",
    "histogram",
    "next_id",
    "record_event",
    "record_occupancy",
    "register_provider",
    "render_prometheus",
    "reset",
    "set_enabled",
    "slo",
    "snapshot",
    "trace",
]
