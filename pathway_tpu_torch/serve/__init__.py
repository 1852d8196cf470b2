"""The port's serve front (counterpart of ``pathway_tpu/serve``):
``ServeScheduler`` coalesces concurrent serve calls into shared,
double-buffered device batches over ``RetrieveRerankPipeline`` or
``FusedEncodeSearch``; ``SharedBatcher`` does the same for flat scoring
calls.  The reference's decoder, tuner, live ingest, warm state and
fabric wait for later slices of the port."""

from .scheduler import ServeScheduler, SharedBatcher, coalesce_window_s, max_batch_queries

__all__ = ["ServeScheduler", "SharedBatcher", "coalesce_window_s", "max_batch_queries"]
