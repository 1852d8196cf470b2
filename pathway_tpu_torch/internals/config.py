"""Environment-first configuration of the port (counterpart of
``pathway_tpu/internals/config.py``; reference: python/pathway/internals/
config.py:58-80 — PathwayConfig env fields).

The fields are the ones the port reads: persistence (``internals/run.py``
builds a persistence config from them when ``pw.run`` is given none) and
the metrics server's port and host, offset by ``process_id``
(``internals/metrics.py``).  Env parsing goes through the port's knob
table (``pathway_tpu_torch/config.py``) — field defaults are
``default_factory`` thunks, so each ``PathwayConfig()`` construction
reads the CURRENT knob values instead of whatever the env held at
class-definition time.  The reference's engine, monitoring and license
fields come with the slices that read them."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .. import config

__all__ = ["PathwayConfig", "get_config", "local_config"]


@dataclass
class PathwayConfig:
    # persistence
    persistence_mode: str = field(
        default_factory=lambda: config.get("persistence.mode")
    )
    replay_storage: Optional[str] = field(
        default_factory=lambda: config.get("persistence.replay_storage") or None
    )
    persistent_storage: Optional[str] = field(
        default_factory=lambda: config.get("persistence.storage") or None
    )
    snapshot_interval_ms: int = field(
        default_factory=lambda: config.get("persistence.snapshot_interval_ms")
    )
    # observability
    metrics_port: int = field(
        default_factory=lambda: config.get("observe.metrics_port")
    )
    metrics_host: str = field(
        default_factory=lambda: config.get("observe.metrics_host")
    )

    @property
    def process_id(self) -> int:
        return config.get("parallel.process_id")


_config = PathwayConfig()


def get_config() -> PathwayConfig:
    return _config


class local_config:
    def __init__(self, **overrides):
        self.overrides = overrides
        self._saved = {}

    def __enter__(self):
        for k, v in self.overrides.items():
            self._saved[k] = getattr(_config, k)
            setattr(_config, k, v)
        return _config

    def __exit__(self, *exc):
        for k, v in self._saved.items():
            setattr(_config, k, v)
        return False
