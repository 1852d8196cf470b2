"""Control plane of the port (counterpart of the reference's
``pathway_tpu/parallel/distributed.py``), single-process subset."""

from .distributed import broadcast_obj, is_coordinator

__all__ = ["broadcast_obj", "is_coordinator"]
