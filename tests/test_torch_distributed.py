"""The port's multi-process plane against the reference, on the CPU.

Two ranks of ``tests/torch_dist_worker.py`` (torch only, gloo) join one
cluster through ``parallel/distributed.py``: the control plane is
checked as ``tests/test_distributed.py``
``test_control_plane_barrier_and_broadcast`` and
``tests/test_robust.py`` (faults at ``dist.barrier`` /
``dist.broadcast``) check the reference's; a 2 x 4 shard mesh must give
the port's 1 x 8 mesh bit for bit and the reference's
``knn_scenario(make_mesh())`` keys and scores (``tests/test_distributed.py``
rounds them to 4 places).  Each spawn has its own timeout: a hung rank
fails its test and is killed.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pathway_tpu_torch.parallel import distributed as port_dist
from pathway_tpu_torch.parallel.mesh import Mesh, gather_shards, is_multiprocess, local_shards, make_mesh

from .dist_worker import knn_scenario
from .torch_dist_worker import ENCODER_TEXTS, port_encoder, port_knn_scenario

_ROOT = Path(__file__).resolve().parents[1]
_WORKER = Path(__file__).resolve().with_name("torch_dist_worker.py")
_SPAWN_TIMEOUT_S = 120.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers; torch's default of one thread
    per core would crowd the timing-sensitive tests of the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(scenario: str, processes: int = 2, timeout: float = _SPAWN_TIMEOUT_S):
    """Run ``processes`` ranks of the worker; each rank's RESULT, by
    rank.  Past ``timeout`` every rank is killed and the test fails with
    their output."""
    port = _free_port()
    procs = []
    for pid in range(processes):
        env = dict(os.environ)
        env.update(
            PATHWAY_PROCESSES=str(processes),
            PATHWAY_PROCESS_ID=str(pid),
            PATHWAY_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            PYTHONPATH=str(_ROOT),
            OMP_NUM_THREADS="1",
        )
        procs.append(subprocess.Popen(
            [sys.executable, str(_WORKER), scenario], cwd=_ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    deadline = time.monotonic() + timeout
    results, failures = [], []
    for pid, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            status = f"rc={proc.returncode}"
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            out, err = proc.communicate()
            status = "TIMEOUT"
        payload = next((json.loads(line[7:]) for line in out.splitlines() if line.startswith("RESULT ")), None)
        if status != "rc=0" or payload is None:
            failures.append(f"rank {pid} {status}\nstdout:\n{out[-2000:]}\nstderr:\n{err[-3000:]}")
        results.append((payload, err))
    assert not failures, "\n\n".join(failures)
    return results


def test_control_plane_two_ranks():
    results = _spawn("control_plane")
    outs = [r for r, _ in results]
    assert [o["proc"] for o in outs] == [0, 1]
    for o, (_, err) in zip(outs, results):
        assert o["joined"] and o["nproc"] == 2 and not o["jax_loaded"]
        # the chosen backend is printed, and is gloo on the CPU
        assert o["backend"] == "gloo" and "data-plane backend gloo (no CUDA device)" in err
        assert o["start"] and o["again"] and o["end"]
        assert o["payload"] == {"commit_ts": 123456, "mode": "persisting"}
        # faults answer locally and are counted, as tests/test_robust.py:1664-1705 asserts
        assert o["faulted_bcast"] == {"rank": o["proc"]} and o["faulted_barrier"] is False
        assert o["hung_bcast"] == 44 and o["degraded"] == [1, 2]
        assert o["agree_same"] == [7, True]
    assert outs[0]["agree_diff"] == [7, True] and outs[1]["agree_diff"] == [7, False]
    # a faulted broadcast answers the local value, as the reference's: the
    # coordinator's own generation (agreed), None on a follower (flagged)
    assert outs[0]["agree_faulted"] == [9, True] and outs[1]["agree_faulted"] == [9, False]
    assert outs[0]["reused"] == {"x": 1} and outs[0]["reused_degraded"] == 1


def test_mesh_two_by_four_equals_one_by_eight_and_reference():
    results = _spawn("mesh")
    outs = [r for r, _ in results]
    for o in outs:
        assert o["shape"] == {"data": 8, "model": 1} and o["owners"] == [0] * 4 + [1] * 4
        assert o["multiprocess"] and o["local"] == list(range(4 * o["proc"], 4 * o["proc"] + 4))
        assert not o["jax_loaded"]
    assert outs[0]["res"] == outs[1]["res"], "ranks disagree"

    # the port's one-process 8-shard mesh: bit for bit
    one = port_knn_scenario(make_mesh(8, 1, devices=["cpu"] * 8))
    assert outs[0]["res"] == one
    # the reference's knn_scenario on its 8-device CPU mesh: keys and rounded scores
    from pathway_tpu.parallel import make_mesh as ref_make_mesh

    ref = knn_scenario(ref_make_mesh())
    assert [[[k, s] for k, s, _ in row] for row in outs[0]["res"]] == ref

    # the encoder's rows over the 2 x 4 mesh: equal on both ranks, and
    # equal to the unsharded encoder within the f32 trunk tolerance
    rows = [np.asarray(o["rows"], np.uint32).view(np.float32) for o in outs]
    assert np.array_equal(rows[0], rows[1])
    want = port_encoder().encode(ENCODER_TEXTS)
    np.testing.assert_allclose(rows[0], want, atol=1e-5)


def test_single_process_defaults():
    """Without the topology env the control plane is a no-op, as the
    reference's is before ``jax.distributed.initialize``."""
    assert port_dist.topology_from_env()[0] == 1 and port_dist.maybe_initialize() is False
    assert not port_dist.is_distributed() and port_dist.process_id() == 0 and port_dist.process_count() == 1
    assert port_dist.is_coordinator() and port_dist.data_backend() is None
    assert port_dist.barrier("solo") is True and port_dist.broadcast_obj(5, name="solo") == 5
    assert port_dist.gather_obj("x") == ["x"]
    t = torch.arange(6.0).view(2, 3)
    assert torch.equal(port_dist.all_gather(t), t[None]) and port_dist.broadcast(t, 0) is t
    mesh = make_mesh(4, 1, devices=["cpu"] * 4)
    assert mesh.owners == [0] * 4 and not is_multiprocess(mesh) and local_shards(mesh) == [0, 1, 2, 3]
    assert gather_shards(mesh, t) is t


def test_topology_env_names(monkeypatch):
    monkeypatch.setenv("PATHWAY_PROCESSES", "3")
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "2")
    monkeypatch.setenv("PATHWAY_FIRST_PORT", "4567")
    assert port_dist.topology_from_env() == (3, 2, "127.0.0.1:4567")
    monkeypatch.setenv("PATHWAY_COORDINATOR_ADDRESS", "10.0.0.1:999")
    assert port_dist.topology_from_env() == (3, 2, "10.0.0.1:999")
    from pathway_tpu.parallel import distributed as ref_dist

    assert port_dist.topology_from_env() == ref_dist.topology_from_env()
    monkeypatch.delenv("PATHWAY_COORDINATOR_ADDRESS")
    monkeypatch.delenv("PATHWAY_FIRST_PORT")
    with pytest.raises(RuntimeError, match="COORDINATOR_ADDRESS"):
        port_dist.maybe_initialize()


def test_mesh_shapes_and_owners():
    mesh = Mesh([["cpu"] * 2] * 3, owners=[0, 0, 0])
    assert mesh.shape == {"data": 3, "model": 2} and mesh.axis_devices("model") == [torch.device("cpu")] * 2
    ring = Mesh(["cpu"] * 8, axis_names=("sp",))
    assert ring.shape == {"sp": 8} and ring.data_device(7) == torch.device("cpu")
    # a mesh another rank co-owns: only this rank's blocks are placed
    split = Mesh([["cpu"]] * 4, owners=[0, 0, 1, 1])
    assert is_multiprocess(split) and local_shards(split) == [0, 1]
    from pathway_tpu_torch.parallel.mesh import global_zeros, host_to_global

    blocks = host_to_global(np.arange(8, dtype=np.int32), split)
    assert [b is None for b in blocks] == [False, False, True, True]
    assert blocks[1].tolist() == [2, 3]
    assert [z is None for z in global_zeros((8, 2), torch.float32, split)] == [False, False, True, True]
    with pytest.raises(ValueError, match="unequal"):
        Mesh([["cpu"]] * 3, owners=[0, 0, 1])
