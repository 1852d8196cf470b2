"""pw.io.airbyte — Airbyte sources via the Airbyte protocol (counterpart
of ``pathway_tpu/io/airbyte``; reference: python/pathway/io/airbyte/__init__.py + vendored
airbyte_serverless — 300+ SaaS sources through connector images).

The Airbyte protocol itself is just JSONL on stdout: a source process emits
``{"type": "RECORD", ...}`` / ``{"type": "STATE", ...}`` messages.  This
connector runs any source — a docker image (``docker run -i <image> read
...``), a pip-installed ``source-<name>`` entry point, or an arbitrary
``exec_command`` — and turns RECORD messages into rows and STATE messages
into committed offsets (so persistence resumes incremental syncs).  No
vendored runner library needed.  ``env_vars`` reach a docker image only:
with ``exec_command`` they raise, as do keyword arguments the reference
takes and never reads."""

from __future__ import annotations

import json
import os
import shlex
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence

from ...internals.schema import schema_from_types
from ...internals.table import Table
from .._connector import SessionWriter, refuse_dropped, register_source

__all__ = ["read"]


def _source_command(
    config_path: str,
    catalog_path: str,
    state_path: Optional[str],
    *,
    image: Optional[str],
    exec_command: Optional[str],
    env_vars: Optional[Dict[str, str]],
) -> List[str]:
    if exec_command:
        cmd = shlex.split(exec_command)
    elif image:
        if shutil.which("docker") is None:
            raise RuntimeError(
                "pw.io.airbyte with a connector image needs docker on PATH; "
                "alternatively pass exec_command for a locally installed "
                "source"
            )
        mounts = []
        for p in (config_path, catalog_path, state_path):
            if p:
                mounts += ["-v", f"{os.path.abspath(p)}:{os.path.abspath(p)}:ro"]
        envs = []
        for k, v in (env_vars or {}).items():
            envs += ["-e", f"{k}={v}"]
        cmd = ["docker", "run", "--rm", "-i", *mounts, *envs, image]
    else:
        raise ValueError("pw.io.airbyte needs `image` or `exec_command`")
    # absolute paths: a docker container resolves relative paths against its
    # own workdir, not the host cwd the mounts were built from
    cmd += [
        "read",
        "--config", os.path.abspath(config_path),
        "--catalog", os.path.abspath(catalog_path),
    ]
    if state_path:
        cmd += ["--state", os.path.abspath(state_path)]
    return cmd


def _configured_catalog(streams: Sequence[str]) -> dict:
    return {
        "streams": [
            {
                "stream": {
                    "name": s,
                    "json_schema": {},
                    "supported_sync_modes": ["full_refresh", "incremental"],
                },
                "sync_mode": "incremental",
                "destination_sync_mode": "append",
            }
            for s in streams
        ]
    }


def read(
    config: Optional[dict] = None,
    streams: Optional[List[str]] = None,
    *,
    config_file_path: Optional[str] = None,
    image: Optional[str] = None,
    exec_command: Optional[str] = None,
    env_vars: Optional[Dict[str, str]] = None,
    mode: str = "streaming",
    refresh_interval_ms: int = 60000,
    name: str = "airbyte",
    persistent_id: Optional[str] = None,
    **kwargs,
) -> Table:
    """Rows: ``stream`` (str), ``data`` (the record JSON).

    ``config``/``config_file_path``: the source's connection config.
    ``image``: an Airbyte source docker image (e.g.
    ``airbyte/source-github``); ``exec_command``: a locally installed source
    binary instead.  STATE messages commit as offsets, so incremental syncs
    resume across restarts under a persistence config."""
    refuse_dropped("pw.io.airbyte.read", kwargs)
    if not streams:
        raise ValueError("pw.io.airbyte requires the list of streams to sync")
    if env_vars and exec_command:
        raise ValueError("pw.io.airbyte: env_vars with exec_command are not supported (they reach a docker image "
                         "only; the reference accepts and ignores them)")
    schema = schema_from_types(stream=str, data=dict)

    def runner(writer: SessionWriter):
        # mkdtemp is 0700; removed in the finally so source credentials in
        # config.json never outlive the run
        workdir = tempfile.mkdtemp(prefix="pw-airbyte-")
        try:
            _run_source(writer, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)

    def _run_source(writer: SessionWriter, workdir: str):
        from ...internals.keys import ref_scalar

        config_path = config_file_path
        if config_path is None:
            config_path = os.path.join(workdir, "config.json")
            with open(config_path, "w") as f:
                json.dump(config or {}, f)
        catalog_path = os.path.join(workdir, "catalog.json")
        with open(catalog_path, "w") as f:
            json.dump(_configured_catalog(streams), f)

        pers = writer.persistence
        state = (pers.offsets() or {}).get("state") if pers else None
        while True:
            state_path = None
            if state is not None:
                state_path = os.path.join(workdir, "state.json")
                with open(state_path, "w") as f:
                    json.dump(state, f)
            cmd = _source_command(
                config_path,
                catalog_path,
                state_path,
                image=image,
                exec_command=exec_command,
                env_vars=env_vars,
            )
            proc = subprocess.Popen(
                cmd,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
            assert proc.stdout is not None

            # drain stderr concurrently: a chatty source would fill the OS
            # pipe buffer and deadlock against our stdout read
            err_tail: List[str] = []

            def _drain(stream=proc.stderr):
                for err_line in stream:
                    err_tail.append(err_line)
                    del err_tail[:-50]

            drainer = threading.Thread(target=_drain, daemon=True)
            drainer.start()
            for line in proc.stdout:
                line = line.strip()
                if not line:
                    continue
                try:
                    message = json.loads(line)
                except json.JSONDecodeError:
                    continue  # sources also log plain text to stdout
                mtype = message.get("type")
                if mtype == "RECORD":
                    record = message.get("record", {})
                    stream_name = record.get("stream", "")
                    data = record.get("data", {})
                    # content-derived key + upsert session: a full-refresh
                    # source re-emitting its dataset each cycle lands on the
                    # same keys instead of duplicating rows every refresh
                    key = int(
                        ref_scalar(
                            stream_name, json.dumps(data, sort_keys=True)
                        )
                    )
                    writer.insert(
                        {"stream": stream_name, "data": data}, key=key
                    )
                elif mtype == "STATE":
                    state = message.get("state")
                    writer.commit_offsets({"state": state})
            rc = proc.wait()
            drainer.join(timeout=5)
            if rc != 0:
                err = "".join(err_tail)[-2000:]
                raise RuntimeError(f"airbyte source exited rc={rc}:\n{err}")
            if mode == "static":
                return
            time.sleep(refresh_interval_ms / 1000.0)

    def dist_runner(writer: SessionWriter) -> None:
        # distributed: ONE rank runs the external source (a docker/exec
        # Airbyte connector per rank would duplicate reads and side
        # effects); rows are disjoint-by-construction and re-scatter to
        # their key owners via the partitioned source exchange
        from ...parallel.distributed import topology_from_env

        processes, pid, _addr = topology_from_env()
        if processes > 1 and pid != 0:
            return
        runner(writer)

    return register_source(
        schema,
        dist_runner,
        mode=mode,
        upsert=True,
        name=name,
        persistent_id=persistent_id,
        dist_mode="partitioned",
    )
