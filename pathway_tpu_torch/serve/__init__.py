"""The port's serve front (counterpart of ``pathway_tpu/serve``):
``ServeScheduler`` coalesces concurrent serve calls into shared,
double-buffered device batches over ``RetrieveRerankPipeline`` or
``FusedEncodeSearch``; ``SharedBatcher`` does the same for flat scoring
calls; ``ContinuousDecoder`` batches generator decode at token
granularity over a slot pool.  The reference's tuner, live ingest, warm
state and fabric wait for later slices of the port."""

from .decode import ContinuousDecoder, DecodeResult, decode_slots
from .scheduler import ServeScheduler, SharedBatcher, coalesce_window_s, max_batch_queries

__all__ = [
    "ContinuousDecoder",
    "DecodeResult",
    "ServeScheduler",
    "SharedBatcher",
    "coalesce_window_s",
    "decode_slots",
    "max_batch_queries",
]
