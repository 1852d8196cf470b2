"""Environment-first configuration of the port (counterpart of
``pathway_tpu/internals/config.py``; reference: python/pathway/internals/
config.py:58-80 — PathwayConfig env fields).

The fields are the ones the port reads: persistence (``internals/run.py``
builds a persistence config from them when ``pw.run`` is given none), the
metrics server's port and host, offset by ``process_id``
(``internals/metrics.py``), and the monitoring endpoint and license key
that ``pw.set_monitoring_config`` / ``pw.set_license_key`` write.  Env
parsing goes through the port's knob table
(``pathway_tpu_torch/config.py``) — field defaults are
``default_factory`` thunks, so each ``PathwayConfig()`` construction
reads the CURRENT knob values instead of whatever the env held at
class-definition time.  The fields are the reference's, one for one."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .. import config

__all__ = ["PathwayConfig", "get_config", "set_license_key", "set_monitoring_config", "local_config"]


@dataclass
class PathwayConfig:
    # device meshes (the mesh axes' size overrides)
    mesh_data_axis: int = field(
        default_factory=lambda: config.get("parallel.data_shards")
    )
    mesh_model_axis: int = field(
        default_factory=lambda: config.get("parallel.model_shards")
    )
    # engine
    commit_duration_ms: int = field(
        default_factory=lambda: config.get("engine.commit_duration_ms")
    )
    terminate_on_error: bool = field(
        default_factory=lambda: config.get("engine.terminate_on_error")
    )
    runtime_typechecking: bool = field(
        default_factory=lambda: config.get("engine.runtime_typechecking")
    )
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
    monitoring_server: Optional[str] = field(
        default_factory=lambda: config.get("observe.monitoring_server") or None
    )
    metrics_port: int = field(
        default_factory=lambda: config.get("observe.metrics_port")
    )
    metrics_host: str = field(
        default_factory=lambda: config.get("observe.metrics_host")
    )
    # licensing: this framework is fully open — accepted and ignored
    license_key: Optional[str] = field(
        default_factory=lambda: config.get("license.key") or None
    )

    @property
    def process_id(self) -> int:
        return config.get("parallel.process_id")

    @property
    def processes(self) -> int:
        return config.get("parallel.processes")


_config = PathwayConfig()


def get_config() -> PathwayConfig:
    return _config


def set_license_key(key: Optional[str]) -> None:
    """Reference-compat no-op: the framework has no license gating
    (reference: license.rs:31 gates >8 workers)."""
    _config.license_key = key


def set_monitoring_config(*, server_endpoint: Optional[str]) -> None:
    """Set (or clear) the OTLP monitoring endpoint (reference
    internals/config.py:144 ``set_monitoring_config``; no license gating)."""
    _config.monitoring_server = server_endpoint


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
