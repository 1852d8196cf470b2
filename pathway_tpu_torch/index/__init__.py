"""Device-resident forward index of the port (counterpart of
``pathway_tpu/index``): compressed per-document token rows stored at
ingest, gathered and MaxSim-scored at serve time, on one device or
sharded by document over a ``ShardGroup``."""

from .forward import (
    ForwardIndex,
    ForwardUnavailable,
    ShardedForwardIndex,
    forward_quant_mode,
    forward_tokens_per_doc,
)

__all__ = [
    "ForwardIndex",
    "ForwardUnavailable",
    "ShardedForwardIndex",
    "forward_quant_mode",
    "forward_tokens_per_doc",
]
