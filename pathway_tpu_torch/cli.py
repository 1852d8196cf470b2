"""``python -m pathway_tpu_torch.cli`` — the port's command line
(counterpart of ``pathway_tpu/cli.py``; reference: python/pathway/cli.py:
53-260 — ``pathway spawn`` / ``pathway replay`` / ``pathway
spawn-from-env``, plus ``run`` for the YAML templates).

``run TEMPLATE [--host H] [--port P] [--device {cuda,cpu}]`` loads a
template (``internals/yaml_loader.py``) and serves it through
``serve_config``; ``--device`` (default ``cuda``) sets the process
default device before any template object is built, and ``cuda`` on a
machine without a card raises.  ``spawn`` / ``spawn-from-env`` launch
the same program once per process with the topology environment
(PATHWAY_PROCESS_ID / PATHWAY_PROCESSES / PATHWAY_FIRST_PORT /
PATHWAY_COORDINATOR_ADDRESS) that the port's ``parallel/distributed.py``
reads; the port's ``pw.run`` itself runs one process (the multi-process
engine is a later slice).  ``replay`` needs the engine's persistence, a
later slice, and raises.
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

from . import config

__all__ = ["main", "run_template", "serve_config", "spawn_program"]


def _topology_env(
    process_id: int,
    processes: int,
    first_port: int,
    base: Optional[Dict[str, str]] = None,
) -> Dict[str, str]:
    env = dict(os.environ if base is None else base)
    env["PATHWAY_PROCESS_ID"] = str(process_id)
    env["PATHWAY_PROCESSES"] = str(processes)
    env["PATHWAY_FIRST_PORT"] = str(first_port)
    # read by parallel/distributed.py: process 0 hosts the control-plane
    # store here
    env["PATHWAY_COORDINATOR_ADDRESS"] = f"127.0.0.1:{first_port}"
    return env


def spawn_program(
    program: str,
    arguments: Sequence[str],
    *,
    processes: int = 1,
    first_port: int = 10000,
    env_extra: Optional[Dict[str, str]] = None,
    timeout: Optional[float] = None,
) -> int:
    """Launch ``processes`` copies of ``program``; returns the first
    non-zero exit code observed (the teardown cause), or 0 if all succeed.
    A failing process tears the others down (the reference's
    all-pods-must-be-present model, SURVEY §5.3).  ``timeout`` (seconds):
    kill anything still running then; returns 124 only when the timeout is
    the first failure (an earlier member's non-zero code wins)."""
    handles: List[subprocess.Popen] = []
    try:
        for pid in range(processes):
            env = _topology_env(pid, processes, first_port)
            if env_extra:
                env.update(env_extra)
            handles.append(
                subprocess.Popen([program, *arguments], env=env)
            )
        # wait on ANY process: a crashed member must tear the others down
        # immediately, even while lower-index members are still running
        import time as _time

        deadline = _time.time() + timeout if timeout else None
        exit_code = 0
        live = list(handles)
        terminated = False
        while live:
            progressed = False
            for h in list(live):
                rc = h.poll()
                if rc is None:
                    continue
                live.remove(h)
                progressed = True
                if rc != 0 and not terminated:
                    exit_code = rc
                    terminated = True
                    for other in live:
                        if other.poll() is None:
                            other.send_signal(signal.SIGTERM)
            if live and deadline is not None and _time.time() > deadline:
                for h in live:
                    if h.poll() is None:
                        h.kill()
                for h in live:
                    h.wait()
                # keep an already-observed failure code as the cause; 124
                # only when the timeout itself is the first failure
                return exit_code or 124
            if live and not progressed:
                _time.sleep(0.05)
        return exit_code
    except KeyboardInterrupt:
        for h in handles:
            if h.poll() is None:
                h.send_signal(signal.SIGINT)
        for h in handles:
            h.wait()
        return 130


def serve_config(cfg, host: Optional[str] = None, port: Optional[int] = None) -> int:
    """Serve a loaded template config: a ``question_answerer`` gets the
    QA REST routes, a bare ``document_store`` the retrieval routes, and a
    plain pipeline just runs.  Blocks until the engine stops."""
    if not isinstance(cfg, dict):
        raise SystemExit(f"a template config must be a mapping, got {type(cfg)}")
    host = host or cfg.get("host", "127.0.0.1")
    port = port or int(cfg.get("port", 8000))

    qa = cfg.get("question_answerer")
    if qa is not None:
        qa.build_server(host=host, port=port)
        print(f"serving QA endpoints at http://{host}:{port}", flush=True)
        qa.run_server(with_cache=False)
        return 0
    store = cfg.get("document_store")
    if store is not None:
        from .xpacks.llm.servers import DocumentStoreServer

        server = DocumentStoreServer(host, port, store)
        print(f"serving DocumentStore at http://{host}:{port}", flush=True)
        server.run(with_cache=False)
        return 0
    from .internals.run import run

    run()
    return 0


def run_template(
    template: str,
    host: Optional[str] = None,
    port: Optional[int] = None,
    device: str = "cuda",
) -> int:
    """Load a YAML template app (the L7 surface — reference template apps,
    docs/2.developers/7.templates/) on ``device`` and serve it."""
    from .device import set_default_device
    from .internals.yaml_loader import load_yaml

    set_default_device(device)
    with open(template) as f:
        cfg = load_yaml(f)
    if not isinstance(cfg, dict):
        raise SystemExit(f"template {template} must be a mapping, got {type(cfg)}")
    return serve_config(cfg, host=host, port=port)


def _persistence_env(args) -> Dict[str, str]:
    env: Dict[str, str] = {}
    if getattr(args, "record", False) or getattr(args, "mode", None):
        path = getattr(args, "record_path", None) or "./record"
        env["PATHWAY_PERSISTENT_STORAGE"] = path
    if getattr(args, "mode", None):
        env["PATHWAY_PERSISTENCE_MODE"] = args.mode.upper()
    return env


def _add_spawn_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "-n",
        "--processes",
        type=int,
        default=1,
        help="number of host processes to launch",
    )
    p.add_argument(
        "--first-port",
        type=int,
        default=10000,
        help="port of the coordination service hosted by process 0",
    )
    p.add_argument("program")
    p.add_argument("arguments", nargs=argparse.REMAINDER)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pathway_tpu_torch.cli", description=__doc__.splitlines()[0]
    )
    sub = parser.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("spawn", help="run a program on N coordinated processes")
    _add_spawn_args(sp)
    sp.add_argument(
        "--record", action="store_true", help="record input connector data"
    )
    sp.add_argument(
        "--record-path", default=None, help="snapshot storage location"
    )

    rp = sub.add_parser("replay", help="re-run a program from recorded data")
    _add_spawn_args(rp)
    rp.add_argument(
        "--record-path", default="./record", help="snapshot storage location"
    )
    rp.add_argument(
        "--mode",
        choices=["batch", "speedrun"],
        default="batch",
        help="replay timing: batch (collapse) or speedrun (original pacing)",
    )

    se = sub.add_parser(
        "spawn-from-env",
        help="spawn with arguments taken from $PATHWAY_SPAWN_ARGS",
    )
    se.add_argument("program", nargs="?", default=None)
    se.add_argument("arguments", nargs=argparse.REMAINDER)

    rn = sub.add_parser(
        "run", help="run a YAML template app (see templates/)"
    )
    rn.add_argument("template", help="path to a template YAML")
    rn.add_argument("--host", default=None, help="override the template host")
    rn.add_argument(
        "--port", type=int, default=None, help="override the template port"
    )
    rn.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="device of the template's models and indexes (cuda raises without a card)",
    )

    args = parser.parse_args(argv)

    if args.command == "run":
        return run_template(args.template, host=args.host, port=args.port, device=args.device)

    if args.command == "replay":
        raise NotImplementedError(
            "replay needs the engine's persistence (persistence/engine_state.py), a later "
            "slice (ROADMAP.md, framework slice 2)"
        )

    if args.command == "spawn-from-env":
        spawn_args = shlex.split(config.get("cli.spawn_args"))
        extra = [args.program] if args.program else []
        return main(["spawn", *spawn_args, *extra, *args.arguments])

    env_extra = _persistence_env(args)
    return spawn_program(
        args.program,
        args.arguments,
        processes=args.processes,
        first_port=args.first_port,
        env_extra=env_extra,
    )


if __name__ == "__main__":
    sys.exit(main())
