"""DEPRECATED alias of :mod:`pathway_tpu_torch.internals.udfs` (counterpart
of ``pathway_tpu/asynchronous.py``).

The reference keeps ``pathway.asynchronous`` as a deprecated re-export of the
``udfs`` helpers (reference python/pathway/asynchronous.py) for code written
against the pre-``pw.udfs`` API; same here.
"""

from __future__ import annotations

from warnings import warn

from .internals.udfs import (  # noqa: F401
    AsyncRetryStrategy,
    CacheStrategy,
    DefaultCache,
    DiskCache,
    ExponentialBackoffRetryStrategy,
    FixedDelayRetryStrategy,
    InMemoryCache,
    NoRetryStrategy,
    async_options,
    coerce_async,
    with_capacity,
    with_timeout,
)

warn(
    "pathway_tpu_torch.asynchronous is deprecated; use pathway_tpu_torch.udfs instead",
    DeprecationWarning,
    stacklevel=2,
)
