"""Device-resident forward index of the port (counterpart of
``pathway_tpu/index``): compressed per-document token rows stored at
ingest, gathered and MaxSim-scored at serve time."""

from .forward import ForwardIndex, ForwardUnavailable

__all__ = ["ForwardIndex", "ForwardUnavailable"]
