"""Entry point of one rank of the port's multi-process tests.

``tests/test_torch_distributed.py`` starts it N times with the topology
environment (``PATHWAY_PROCESSES``, ``PATHWAY_PROCESS_ID``,
``PATHWAY_COORDINATOR_ADDRESS``); ``maybe_initialize`` joins the ranks
over a store and a gloo process group on the CPU.  The worker imports
the port and torch only (it checks that no JAX module was loaded) and
prints one ``RESULT <json>`` line.

Usage: python tests/torch_dist_worker.py <scenario>
"""

from __future__ import annotations

import json
import sys

import numpy as np


def port_knn_scenario(mesh) -> list:
    """The workload of the reference's ``tests/dist_worker.py``
    ``knn_scenario`` on the port's index: grow, remove, upsert, search.
    Returns per-query ``[key, score rounded to 4 places, score bits]``."""
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex

    rng = np.random.default_rng(7)
    dim = 16
    index = DeviceKnnIndex(dimension=dim, metric="cos", initial_capacity=32, mesh=mesh, device="cpu")
    vectors = rng.normal(size=(100, dim)).astype(np.float32)
    index.add(list(range(1, 101)), vectors)  # forces a grow past 64
    index.remove(list(range(1, 11)))
    index.add([5], vectors[:1] * 0.5)  # re-add after remove (upsert path)
    queries = rng.normal(size=(7, dim)).astype(np.float32)
    rows = index.search(queries, k=5)
    return [[[int(k), round(float(s), 4), np.float32(s).view(np.uint32).item()] for k, s in row] for row in rows]


ENCODER_TEXTS = [f"doc {i} " + " ".join(["stream", "join", "window", "index"][: 1 + i % 4]) for i in range(13)]


def port_encoder(mesh=None):
    """A small f32 encoder (the same seeded weights with or without a
    mesh)."""
    import torch

    from pathway_tpu_torch.models.encoder import SentenceEncoder

    return SentenceEncoder(
        dimension=32, n_layers=1, n_heads=4, max_length=32, vocab_size=512, seed=3,
        dtype=torch.float32, device="cpu", mesh=mesh,
    )


def scenario_control_plane() -> dict:
    """barrier + coordinator broadcast, their faults, agree_generation."""
    from pathway_tpu_torch import observe
    from pathway_tpu_torch.parallel import distributed as dist
    from pathway_tpu_torch.persistence import MemoryBackend
    from pathway_tpu_torch.robust import Deadline, inject
    from pathway_tpu_torch.serve.warmstate import WarmStateManager

    def degraded(site):
        return observe.counter("pathway_dist_degraded_total", site=site).value

    joined = dist.maybe_initialize()
    out = {"joined": joined, "proc": dist.process_id(), "nproc": dist.process_count(),
           "backend": dist.data_backend()}
    out["start"] = dist.barrier("start")
    payload = {"commit_ts": 123456, "mode": "persisting"} if dist.is_coordinator() else None
    out["payload"] = dist.broadcast_obj(payload, name="tick0")
    out["again"] = dist.barrier("start")  # a reused barrier name is a new round
    # faults: every rank proceeds on its local value, counted
    b0, c0 = degraded("barrier"), degraded("broadcast")
    local = {"rank": dist.process_id()}
    with inject.armed("dist.broadcast", "raise", times=1):
        out["faulted_bcast"] = dist.broadcast_obj(local, name="bc-raise")
    with inject.armed("dist.barrier", "raise", times=1):
        out["faulted_barrier"] = dist.barrier("bar-raise")
    with inject.armed("dist.broadcast", "hang", hang_s=30.0):
        out["hung_bcast"] = dist.broadcast_obj(44, name="bc-hang", deadline=Deadline(0.0))
    out["degraded"] = [degraded("barrier") - b0, degraded("broadcast") - c0]
    # warm-state generation agreement over the store
    mgr = WarmStateManager(MemoryBackend(), name="agree")
    out["agree_same"] = list(mgr.agree_generation(7, tag="same"))
    out["agree_diff"] = list(mgr.agree_generation(7 + dist.process_id(), tag="diff"))
    with inject.armed("dist.broadcast", "raise", times=1):
        out["agree_faulted"] = list(mgr.agree_generation(9, tag="faulted"))
    out["end"] = dist.barrier("end")
    if dist.is_coordinator():
        # a reused name fails loudly on the coordinator: local value, counted
        c1 = degraded("broadcast")
        out["reused"] = dist.broadcast_obj({"x": 1}, name="tick0")
        out["reused_degraded"] = degraded("broadcast") - c1
    return out


def scenario_mesh() -> dict:
    """2 x 4 logical CPU shards: the reference's knn workload on a
    ``DeviceKnnIndex`` and an encoder batch split over the mesh."""
    from pathway_tpu_torch.parallel import distributed as dist
    from pathway_tpu_torch.parallel.mesh import is_multiprocess, local_shards, make_mesh

    dist.maybe_initialize()
    mesh = make_mesh(devices=["cpu"] * 4)
    res = port_knn_scenario(mesh)
    rows = port_encoder(mesh).encode(ENCODER_TEXTS)
    dist.barrier("mesh_done")
    return {
        "proc": dist.process_id(),
        "shape": mesh.shape,
        "owners": mesh.owners,
        "local": local_shards(mesh),
        "multiprocess": is_multiprocess(mesh),
        "res": res,
        "rows": rows.view(np.uint32).tolist(),
    }


SCENARIOS = {"control_plane": scenario_control_plane, "mesh": scenario_mesh}


def main() -> int:
    out = SCENARIOS[sys.argv[1]]()
    out["jax_loaded"] = any(m == "jax" or m.startswith(("jax.", "flax", "pathway_tpu.")) for m in sys.modules)
    from pathway_tpu_torch.parallel import distributed

    distributed.shutdown()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
