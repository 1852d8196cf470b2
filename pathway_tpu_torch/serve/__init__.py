"""The port's serve front (counterpart of ``pathway_tpu/serve``):
``ServeScheduler`` coalesces concurrent serve calls into shared,
double-buffered device batches over ``RetrieveRerankPipeline`` or
``FusedEncodeSearch``; ``SharedBatcher`` does the same for flat scoring
calls; ``ContinuousDecoder`` batches generator decode at token
granularity over a slot pool.  Its maintenance plane:
``LiveIngestRunner`` absorbs ``IngestConnector`` commits into the live
IVF and forward indexes under serve traffic, with the freshness plane
(``ingest.py``); ``WarmStateManager`` snapshots and restores the indexes
and cache tiers (``warmstate.py``).  The reference's tuner and fabric
wait for later slices of the port."""

from .decode import ContinuousDecoder, DecodeResult, decode_slots
from .ingest import IngestConnector, LiveIngestRunner, ingest_runners
from .scheduler import ServeScheduler, SharedBatcher, coalesce_window_s, max_batch_queries
from .warmstate import RestoreReport, WarmStateManager

__all__ = [
    "ContinuousDecoder",
    "DecodeResult",
    "IngestConnector",
    "LiveIngestRunner",
    "RestoreReport",
    "ServeScheduler",
    "SharedBatcher",
    "WarmStateManager",
    "coalesce_window_s",
    "decode_slots",
    "ingest_runners",
    "max_batch_queries",
]
