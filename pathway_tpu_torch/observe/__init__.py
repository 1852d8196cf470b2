"""The port's serve-path flight recorder (counterpart of
``pathway_tpu/observe``): stage histograms, counters, gauges and
providers under the reference's family names (``recorder.py``),
per-request span trees with tail sampling (``trace.py``) and the SLO
burn-rate engine behind the scheduler's shed probe (``slo.py``), the
per-callable device-time profiler (``profile.py``: sampled calls timed
submit -> ready by CUDA events on a completer thread) and the pull-based
device-memory ledger (``hbm.py``).  The registry is the port's own;
``PATHWAY_OBSERVE=0`` or ``set_enabled(False)`` reduces every record
call to a flag check.  ``snapshot()`` carries ``profile`` and ``hbm``
columns beside the series.
"""

from . import hbm, profile, slo, trace
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
    "hbm",
    "histogram",
    "next_id",
    "profile",
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
