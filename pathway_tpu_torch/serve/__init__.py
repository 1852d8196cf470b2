"""The port's serve front (counterpart of ``pathway_tpu/serve``):
``ServeScheduler`` coalesces concurrent serve calls into shared,
double-buffered device batches over ``RetrieveRerankPipeline`` or
``FusedEncodeSearch``; ``SharedBatcher`` does the same for flat scoring
calls; ``ContinuousDecoder`` batches generator decode at token
granularity over a slot pool.  Its maintenance plane:
``LiveIngestRunner`` absorbs ``IngestConnector`` commits into the live
IVF and forward indexes under serve traffic, with the freshness plane
(``ingest.py``); ``WarmStateManager`` snapshots and restores the indexes
and cache tiers (``warmstate.py``).  ``Tuner`` moves the dynamic knobs
online from the observe plane's signals; ``tuner_from_env`` starts one
when ``PATHWAY_TUNER=1`` (``tuner.py``).  The reference's fabric waits
for a later slice of the port."""

from .decode import ContinuousDecoder, DecodeResult, decode_slots
from .ingest import IngestConnector, LiveIngestRunner, ingest_runners
from .scheduler import ServeScheduler, SharedBatcher, coalesce_window_s, max_batch_queries
from .tuner import Tuner, tuner_from_env
from .warmstate import RestoreReport, WarmStateManager

__all__ = [
    "ContinuousDecoder",
    "DecodeResult",
    "IngestConnector",
    "LiveIngestRunner",
    "RestoreReport",
    "ServeScheduler",
    "SharedBatcher",
    "Tuner",
    "WarmStateManager",
    "coalesce_window_s",
    "decode_slots",
    "ingest_runners",
    "max_batch_queries",
    "tuner_from_env",
]
