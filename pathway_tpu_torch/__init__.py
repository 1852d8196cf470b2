"""PyTorch/CUDA port of the pathway_tpu retrieval serve path.

The JAX package ``pathway_tpu`` is the reference; this package mirrors
its module layout (``models/``, ``ops/``) so each counterpart is easy to
find, and never imports it.  Entry points run on the CUDA device unless
the caller passes ``device="cpu"`` explicitly (see ``device.py``).

Slices covered: host tokenizer -> ``TransformerEncoder`` forward + masked
mean pool + L2 normalize -> exact (``DeviceKnnIndex``) or IVF
(``IvfKnnIndex``, with background absorb and retrain) stage-1 search ->
packed int32 result, served through ``FusedEncodeSearch`` -> the rerank
tier of ``RetrieveRerankPipeline``: MaxSim over the device-resident
``index.ForwardIndex`` and/or the packed ``models.cross_encoder`` -> the
serve front ``serve.ServeScheduler`` (coalescing, the ``cache/`` result
and embedding tiers, the ``robust/`` retry, breaker and fault-injection
layer, the ``observe/`` recorder, traces and SLO shedding, and the knob
table ``config.py``).  The IVF shortlist rescore is a hand-written CUDA
kernel (``csrc/ivf_rescore.cu``).
"""

from .device import DEFAULT_DTYPE, resolve_device

__all__ = ["DEFAULT_DTYPE", "resolve_device"]
