"""``pw.run()`` — execute the built dataflow (counterpart of
``pathway_tpu/internals/run.py``; reference: python/pathway/internals/
run.py:12 → GraphRunner → run_with_new_graph; here the graph is already
lowered, so run = drive the Executor until sources finish or termination
is requested).

``with_http_server=True`` starts the metrics server
(``internals/metrics.py``).  A persistence config (``persistence_config=``,
or ``PATHWAY_PERSISTENT_STORAGE`` / ``PATHWAY_PERSISTENCE_MODE`` /
``PATHWAY_SNAPSHOT_INTERVAL_MS`` through ``get_config()``) attaches a
``PersistenceManager`` before the connectors start: it replays the input
log (or restores operator snapshots), records new events and commits on
the snapshot interval and at the end; a final commit that fails is
logged, not raised, as the reference does.

Under a cluster topology (``PATHWAY_PROCESSES`` > 1, as ``python -m
pathway_tpu_torch.cli spawn`` sets it) ``pw.run`` first joins the
cluster (``parallel.distributed.maybe_initialize``); the executor runs the
distributed tick over the exchange plane, which is closed when the run
ends.  Each rank persists under its own ``rank{N}/`` root
(``_rank_scoped``), and a rank that loses its peer (``PeerLost``) exits
the process with status 70 at once: recovery is a restart of the whole
cluster from the per-rank snapshots."""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

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
    # Join the process cluster first (no-op unless PATHWAY_PROCESSES > 1, set
    # by `cli spawn` — the reference consumes the same topology vars in
    # Config::from_env, src/engine/dataflow/config.rs:104-121).
    from ..parallel import distributed

    distributed.maybe_initialize()
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
    if persistence_config is None:
        persistence_config = _persistence_config_from_env()
    if (
        persistence_config is not None
        and persistence_config.backend is not None
        and distributed.is_distributed()
    ):
        # one snapshot namespace per rank: each process persists ITS OWN
        # input log + offsets (atomic per-rank commits are what make the
        # cluster's replay compose into global exactly-once; reference:
        # per-worker persisted frontiers, src/persistence/tracker.rs:49)
        persistence_config = _rank_scoped(persistence_config, distributed.process_id())
    tick_hooks = []
    manager = None
    if persistence_config is not None and persistence_config.backend is not None:
        from ..persistence.engine_state import PersistenceManager

        manager = PersistenceManager(persistence_config)
        manager.attach(G.engine_graph)
        tick_hooks.append(manager.on_tick)
    G.ran = True
    executor = Executor(G.engine_graph, commit_duration_ms)
    with _executor_lock:
        _current_executor = executor
    if monitoring_level is not None and str(monitoring_level) not in ("MonitoringLevel.NONE", "none"):
        from .monitoring import StatsMonitor

        tick_hooks.append(StatsMonitor(G.engine_graph).on_tick)
    if tick_hooks:
        executor.on_tick = (
            tick_hooks[0]
            if len(tick_hooks) == 1
            else (lambda ts: [h(ts) for h in tick_hooks])
        )
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
        try:
            executor.run(bootstrap=bootstrap)
        except BaseException as exc:
            from ..parallel.exchange import PeerLost

            if isinstance(exc, PeerLost):
                # a cluster peer died: this worker cannot make progress
                # and must not linger (an orderly exit would wait on the
                # lost peer).  Hard-abort like the reference's worker-panic
                # propagation (src/engine/dataflow.rs:5667-5676); recovery
                # is a full cluster restart from the last persisted commits.
                logging.getLogger(__name__).critical("aborting worker: %s", exc)
                os._exit(70)
            raise
        G.ran_ops.update(op.id for op in G.engine_graph.operators)
    finally:
        if manager is not None:
            try:
                manager.finalize(executor.current_ts)
            except Exception:
                logging.getLogger(__name__).exception(
                    "final persistence commit failed — events since the last "
                    "interval snapshot were NOT persisted"
                )
        for hook in G.post_run_hooks:
            try:
                hook()
            except Exception:
                pass
        with _executor_lock:
            _current_executor = None
        if distributed.is_distributed():
            from ..parallel.exchange import close_plane

            close_plane()


def _rank_scoped(config, rank: int):
    """Copy a persistence Config with the backend rooted under rank{N}/."""
    import dataclasses

    backend = config.backend
    if backend.path is not None:
        backend = dataclasses.replace(backend, path=os.path.join(backend.path, f"rank{rank}"))
    return dataclasses.replace(config, backend=backend)


def _persistence_config_from_env():
    """PATHWAY_PERSISTENT_STORAGE / PATHWAY_PERSISTENCE_MODE — set by
    ``python -m pathway_tpu_torch.cli spawn --record`` / ``replay``
    (reference: env-first PathwayConfig, internals/config.py:58-80)."""
    from .config import get_config

    cfg = get_config()
    if not cfg.persistent_storage:
        return None
    from .. import persistence as pp

    mode = pp.PersistenceMode.PERSISTING
    raw = (cfg.persistence_mode or "").strip().lower()
    if raw:
        aliases = {
            "batch": pp.PersistenceMode.BATCH,
            "speedrun": pp.PersistenceMode.SPEEDRUN_REPLAY,
            "speedrun_replay": pp.PersistenceMode.SPEEDRUN_REPLAY,
            "realtime_replay": pp.PersistenceMode.REALTIME_REPLAY,
            "persisting": pp.PersistenceMode.PERSISTING,
            "operator_persisting": pp.PersistenceMode.OPERATOR_PERSISTING,
        }
        mode = aliases.get(raw, pp.PersistenceMode.PERSISTING)
    return pp.Config.simple_config(
        pp.Backend.filesystem(cfg.persistent_storage),
        persistence_mode=mode,
        snapshot_interval_ms=cfg.snapshot_interval_ms,
    )


def run_all(**kwargs) -> None:
    run(**kwargs)
