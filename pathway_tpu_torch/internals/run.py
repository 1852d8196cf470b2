"""``pw.run()`` — execute the built dataflow (counterpart of
``pathway_tpu/internals/run.py``; reference: python/pathway/internals/
run.py:12 → GraphRunner → run_with_new_graph; here the graph is already
lowered, so run = drive the Executor until sources finish or termination
is requested).

The port runs the engine in one process.  ``with_http_server=True``
starts the metrics server (``internals/metrics.py``).  A cluster topology
(``PATHWAY_PROCESSES`` > 1) and a persistence config are later slices
(``ROADMAP.md``): asking for one raises ``NotImplementedError`` rather
than running without it."""

from __future__ import annotations

import logging
import threading
from typing import Optional

from .. import config
from ..engine.executor import Executor
from .parse_graph import G

__all__ = ["run", "run_all"]

_current_executor: Optional[Executor] = None
_executor_lock = threading.Lock()


def current_executor() -> Optional[Executor]:
    return _current_executor


def terminate() -> None:
    """Request termination of the currently running graph (used by servers /
    signal handlers)."""
    with _executor_lock:
        if _current_executor is not None:
            _current_executor.terminate()


def _refuse_unported(persistence_config) -> None:
    from ..parallel.distributed import topology_from_env

    processes, _pid, _addr = topology_from_env()
    if processes > 1:
        raise NotImplementedError(
            f"pw.run() across {processes} processes needs the multi-process engine "
            "over the port's exchange plane, a later slice (ROADMAP.md, framework slice 4)"
        )
    if persistence_config is not None or config.get("persistence.storage"):
        raise NotImplementedError(
            "engine persistence (persistence/engine_state.py) is a later slice "
            "(ROADMAP.md, framework slice 2)"
        )


def run(
    *,
    commit_duration_ms: int = 100,
    monitoring_level=None,
    with_http_server: bool = False,
    debug: bool = False,
    persistence_config=None,
    **kwargs,
) -> None:
    global _current_executor
    _refuse_unported(persistence_config)
    # Incremental-run support: operators added after a previous run() are
    # bootstrapped with snapshot deltas of their already-populated inputs
    # (the eager-building analog of the reference's tree-shaken re-runs,
    # graph_runner/__init__.py:129-150).
    bootstrap = []
    if G.ran:
        new_ops = [
            op for op in G.engine_graph.operators if op.id not in G.ran_ops
        ]
        if not new_ops and G.hooks_started >= len(G.pre_run_hooks):
            return
        for op in new_ops:
            for port, t in enumerate(op.inputs):
                if (
                    t.producer is None or t.producer.id in G.ran_ops
                ) and len(t.store):
                    bootstrap.append((op, port, t.store.to_delta()))
    G.ran = True
    executor = Executor(G.engine_graph, commit_duration_ms)
    with _executor_lock:
        _current_executor = executor
    if monitoring_level is not None and str(monitoring_level) not in ("MonitoringLevel.NONE", "none"):
        from .monitoring import StatsMonitor

        executor.on_tick = StatsMonitor(G.engine_graph).on_tick
    if with_http_server:
        from .metrics import start_metrics_server

        try:
            start_metrics_server(G.engine_graph)
        except OSError as exc:  # the port is taken: the run goes on without /metrics, as the reference's
            logging.getLogger(__name__).warning("metrics server not started: %s", exc)
    for hook in G.pre_run_hooks[G.hooks_started :]:
        hook()
    G.hooks_started = len(G.pre_run_hooks)
    try:
        executor.run(bootstrap=bootstrap)
        G.ran_ops.update(op.id for op in G.engine_graph.operators)
    finally:
        for hook in G.post_run_hooks:
            try:
                hook()
            except Exception:
                pass
        with _executor_lock:
            _current_executor = None


def run_all(**kwargs) -> None:
    run(**kwargs)
