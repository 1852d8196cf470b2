"""Entry point of one rank of the port's multi-process tests.

``tests/test_torch_distributed.py`` and ``tests/test_torch_cluster.py``
start it N times with the topology environment (``PATHWAY_PROCESSES``,
``PATHWAY_PROCESS_ID``, ``PATHWAY_COORDINATOR_ADDRESS``);
``maybe_initialize`` joins the ranks over a store and a gloo process
group on the CPU (``pw.run`` joins by itself).  The engine scenarios are
the reference's ``tests/dist_worker.py`` ones on the port's ``pw``, plus
a ``DataIndex`` over IVF and over a mesh index spanning the ranks.  The
worker imports the port and torch only (it checks that no JAX module was
loaded) and prints one ``RESULT <json>`` line.

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


# -- the engine over the exchange plane ----------------------------------------

WORDCOUNT_MD = """
    word  | cnt
    alpha | 1
    beta  | 2
    alpha | 3
    gamma | 4
    beta  | 5
    """


def wordcount(pw):
    """The reference's engine scenario's graph: a sum per word."""
    table = pw.debug.table_from_markdown(WORDCOUNT_MD)
    return table.groupby(table.word).reduce(table.word, total=pw.reducers.sum(table.cnt))


def scenario_engine() -> dict:
    """``pw.run()`` joins the cluster by itself; each rank reduces its
    owned groups, and the union (``gather_table_rows``) is the whole
    wordcount."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.parallel import distributed as dist
    from pathway_tpu_torch.parallel import gather_table_rows

    result = wordcount(pw)
    pw.run(monitoring_level=None)
    lkeys, _ = result._materialize()
    keys, columns = gather_table_rows(result)
    rows = sorted((str(columns["word"][i]), int(columns["total"][i])) for i in range(len(keys)))
    return {"proc": dist.process_id(), "nproc": dist.process_count(), "rows": rows, "local_rows": len(lkeys)}


def scenario_live_stream() -> dict:
    """A watched csv directory read by partitioned readers, rows
    exchanged to their key owners, a sharded groupby-count and one csv
    sink on rank 0; rank 0 stops the cluster once the sink has counted
    ``DIST_EXPECTED_TOTAL`` rows (the reference's scenario)."""
    import os
    import threading

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.run import terminate
    from pathway_tpu_torch.parallel import distributed as dist
    from pathway_tpu_torch.parallel.distributed import topology_from_env

    _nproc, rank, _addr = topology_from_env()
    data_dir = os.environ["DIST_DATA_DIR"]
    out_csv = os.environ["DIST_OUT"]
    expected_total = int(os.environ["DIST_EXPECTED_TOTAL"])

    class Row(pw.Schema):
        word: str

    docs = pw.io.csv.read(data_dir, schema=Row, mode="streaming", poll_interval_s=0.05, persistent_id="dist_wc")
    counts = docs.groupby(docs.word).reduce(word=docs.word, count=pw.reducers.count())
    pw.io.csv.write(counts, out_csv)
    latest: dict = {}
    lock = threading.Lock()

    def on_change(key, row, time, is_addition):
        with lock:
            if is_addition:
                latest[row["word"]] = int(row["count"])

    def on_time_end(time):
        with lock:
            total = sum(latest.values())
        if total >= expected_total:
            terminate()

    if rank == 0:
        pw.io.subscribe(counts, on_change=on_change, on_time_end=on_time_end)
    else:
        pw.io.subscribe(counts, on_change=None, on_time_end=None)
    pw.run(monitoring_level=None, commit_duration_ms=50)
    return {"proc": dist.process_id(), "nproc": dist.process_count(), "stopped": True}


def scenario_rest() -> dict:
    """Rank 0 binds the REST front; the query rows go to every rank by
    broadcast, the answers gather back to rank 0 (the reference's
    scenario).  Rank 1 reports whether it bound a socket."""
    import os

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.internals.run import terminate
    from pathway_tpu_torch.parallel import distributed as dist
    from pathway_tpu_torch.parallel.distributed import topology_from_env

    _nproc, rank, _addr = topology_from_env()
    port = int(os.environ["DIST_REST_PORT"])
    expected = int(os.environ["DIST_REST_EXPECTED"])

    class Q(pw.Schema):
        value: int

    queries, writer = pw.io.http.rest_connector(host="127.0.0.1", port=port, schema=Q, delete_completed_queries=True)
    responses = queries.select(result=pw.this.value * 2)
    writer(responses)
    served: set = set()
    linger = [0]

    def on_change(key, row, time, is_addition):
        if is_addition:
            served.add(row["result"])

    def on_time_end(time):
        if len(served) >= expected:
            linger[0] += 1
            if linger[0] >= 3:
                terminate()

    if rank == 0:
        pw.io.subscribe(responses, on_change=on_change, on_time_end=on_time_end)
    else:
        pw.io.subscribe(responses, on_change=None, on_time_end=None)
    from pathway_tpu_torch.io.http import PathwayWebserver

    servers = sum(isinstance(getattr(h, "__self__", None), PathwayWebserver) for h in G.pre_run_hooks)
    pw.run(monitoring_level=None, commit_duration_ms=50)
    return {"proc": dist.process_id(), "served": len(served), "servers": servers}


class _Doubled:
    """The reference's ``AsyncTransformer`` case: ``invoke`` doubles."""

    @staticmethod
    def build(pw):
        class Out(pw.Schema):
            word: str
            doubled: int

        class Doubler(pw.AsyncTransformer):
            output_schema = Out

            async def invoke(self, word, cnt):
                return {"word": word, "doubled": cnt * 2}

        table = pw.debug.table_from_markdown(
            """
            word  | cnt
            alpha | 1
            beta  | 2
            gamma | 3
            delta | 4
            eps   | 5
            """
        )
        return Doubler(input_table=table).successful


def scenario_async_transformer() -> dict:
    """``invoke`` runs once per row cluster-wide (the input gathers to
    rank 0) and the results go back to their key owners through the
    partitioned loop-back source."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.parallel import distributed as dist
    from pathway_tpu_torch.parallel import gather_table_rows

    result = _Doubled.build(pw)
    pw.run(monitoring_level=None, commit_duration_ms=50)
    lkeys, _ = result._materialize()
    keys, cols = gather_table_rows(result)
    rows = sorted((str(cols["word"][i]), int(cols["doubled"][i])) for i in range(len(keys)))
    return {"proc": dist.process_id(), "rows": rows, "local_rows": len(lkeys)}


TEMPORAL_MD = """
    t  | v
    1  | 1
    3  | 2
    5  | 3
    7  | 4
    11 | 5
    13 | 6
    """


def windowed(pw):
    events = pw.debug.table_from_markdown(TEMPORAL_MD)
    return pw.temporal.windowby(events, events.t, window=pw.temporal.tumbling(duration=4)).reduce(
        start=pw.this._pw_window_start, total=pw.reducers.sum(pw.this.v)
    )


def scenario_temporal() -> dict:
    """A tumbling-window sum: window keys shard like any group key."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.parallel import distributed as dist
    from pathway_tpu_torch.parallel import gather_table_rows

    result = windowed(pw)
    pw.run(monitoring_level=None)
    keys, cols = gather_table_rows(result)
    rows = sorted((int(cols["start"][i]), int(cols["total"][i])) for i in range(len(keys)))
    return {"proc": dist.process_id(), "rows": rows}


INDEX_DIM = 16
INDEX_DOCS = 120
INDEX_QUERIES = 12


def index_tables(pw):
    """Seeded documents and queries for the ``DataIndex`` scenario."""
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((INDEX_DOCS, INDEX_DIM)).astype(np.float32)
    qv = rng.standard_normal((INDEX_QUERIES, INDEX_DIM)).astype(np.float32)
    docs = pw.debug.table_from_rows(
        pw.schema_from_types(name=str, vec=np.ndarray), [(f"d{i}", vecs[i]) for i in range(INDEX_DOCS)]
    )
    queries = pw.debug.table_from_rows(pw.schema_from_types(qname=str, qv=np.ndarray),
                                       [(f"q{i}", qv[i]) for i in range(INDEX_QUERIES)])
    return docs, queries


def index_answers(pw, factory, docs, queries, k: int = 5):
    """``query_as_of_now`` over ``factory``: the answers table with the
    query's name, the hits' names and their scores."""
    index = pw.stdlib.indexing.DataIndex(
        docs, pw.stdlib.indexing.InnerIndex(data_column=docs.vec, factory=factory, dimension=INDEX_DIM)
    )
    result = index.query_as_of_now(queries.qv, number_of_matches=k)
    return result.select(qname=queries.qname, names=docs.name, scores=result.score)


def captured(pw, table, rank: int) -> dict:
    """The table's rows as a sink on rank 0 sees them (``qname`` ->
    names and score bits)."""
    rows: dict = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            rows[row["qname"]] = [list(row["names"]), [np.float32(s).view(np.uint32).item() for s in row["scores"]]]

    pw.io.subscribe(table, on_change=on_change if rank == 0 else None)
    return rows


SERVE_TEXTS = [f"query {i} " + " ".join(["stream", "join", "window", "index"][: 1 + i % 4]) for i in range(9)]


def fused_mesh_serve(mesh) -> tuple:
    """``FusedEncodeSearch`` (exact, fused) over a ``DeviceKnnIndex`` on
    ``mesh``: the rows (key, score bits) and the dispatches + fetches of
    each serve."""
    from pathway_tpu_torch.ops.dispatch_counter import DispatchCounter
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch

    encoder = port_encoder()
    index = DeviceKnnIndex(32, metric="cos", initial_capacity=16, mesh=mesh, device="cpu")
    index.add(list(range(1000, 1000 + len(ENCODER_TEXTS))), encoder.encode(ENCODER_TEXTS))
    serve = FusedEncodeSearch(encoder, index, k=4)
    with DispatchCounter() as c:
        rows = serve(SERVE_TEXTS)
    return ([[[int(k), np.float32(s).view(np.uint32).item()] for k, s in r] for r in rows],
            [c.dispatches, c.fetches])


def scenario_data_index() -> dict:
    """Two ``DataIndex``es over the same documents: a full-probe IVF
    (each rank holds every row; the rescore's plain version on the CPU)
    and a ``TpuKnnFactory`` index over a mesh of 4 CPU shards per rank
    (8 in all, spanning the ranks); then the fused serve path over the
    cross-process mesh."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.parallel import distributed as dist
    from pathway_tpu_torch.parallel.distributed import topology_from_env
    from pathway_tpu_torch.parallel.mesh import make_mesh

    _nproc, rank, _addr = topology_from_env()
    dist.maybe_initialize()
    mesh = make_mesh(devices=["cpu"] * 4)
    docs, queries = index_tables(pw)
    ivf = pw.stdlib.indexing.IvfKnnFactory(dimension=INDEX_DIM, n_clusters=4, n_probe=4, device="cpu")
    tpu = pw.stdlib.indexing.TpuKnnFactory(dimension=INDEX_DIM, mesh=mesh)
    got_ivf = captured(pw, index_answers(pw, ivf, docs, queries), rank)
    got_mesh = captured(pw, index_answers(pw, tpu, docs, queries), rank)
    pw.run(monitoring_level=None)
    from pathway_tpu_torch.engine.operators.external_index import ExternalIndexOperator
    from pathway_tpu_torch.internals.parse_graph import G

    ops = [op for op in G.engine_graph.operators if isinstance(op, ExternalIndexOperator)]
    sizes = [len(op.index.index) for op in ops]
    serve_rows, serve_counts = fused_mesh_serve(mesh)
    return {"proc": dist.process_id(), "ivf": got_ivf, "mesh": got_mesh, "index_rows": sizes,
            "serve": serve_rows, "serve_counts": serve_counts}


SCENARIOS = {
    "control_plane": scenario_control_plane,
    "mesh": scenario_mesh,
    "engine": scenario_engine,
    "live_stream": scenario_live_stream,
    "rest": scenario_rest,
    "async_transformer": scenario_async_transformer,
    "temporal": scenario_temporal,
    "data_index": scenario_data_index,
}


def main() -> int:
    out = SCENARIOS[sys.argv[1]]()
    out["jax_loaded"] = any(m == "jax" or m.startswith(("jax.", "flax", "pathway_tpu.")) for m in sys.modules)
    from pathway_tpu_torch.parallel import distributed

    distributed.shutdown()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
