"""Port parity of the sharded top-k (``pathway_tpu_torch/ops/topk.py``)
and the mesh helpers (``parallel/mesh.py``) against ``pathway_tpu`` on
the CPU: the same seeded inputs, with planted ties and ``-inf`` pads,
give integer-equal ids (rows, shard ids, candidate ids) and equal scores
in ``jax.lax.top_k``'s tie order; the reference runs on the 8 CPU
devices ``tests/conftest.py`` forces, the port on 8 logical shards of
``cpu``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import topk as ref_topk
from pathway_tpu.parallel.mesh import make_mesh as ref_make_mesh
from pathway_tpu_torch.ops import topk
from pathway_tpu_torch.parallel import mesh as port_mesh


def _lists(S, B, K, seed, ties=True, pads=True):
    """Per-shard candidate lists sorted descending, as the shard kernels
    emit them: rounded scores (ties across and within shards), -inf pads
    at the tail of some lists, random ids."""
    rng = np.random.default_rng(seed)
    scores = np.round(rng.standard_normal((S, B, K)), 1 if ties else 7).astype(np.float32)
    if pads:
        scores[0, 0, K // 2 :] = -np.inf
        scores[S - 1, B - 1, 1:] = -np.inf
    scores = -np.sort(-scores, axis=2, kind="stable")
    shard_ids = np.broadcast_to(np.arange(S, dtype=np.int32)[:, None, None], scores.shape).copy()
    ids = rng.integers(-1, 1000, scores.shape).astype(np.int32)
    return scores, shard_ids, ids


@pytest.mark.parametrize("S", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("k", [1, 5, 6])
def test_tree_merge_matches_reference_and_host(S, k):
    scores, shard_ids, ids = _lists(S, 4, 6, seed=S * 10 + k)
    want = [np.asarray(a) for a in jax.jit(lambda s, h, i: ref_topk.tree_merge_topk(s, h, i, k))(scores, shard_ids, ids)]
    got = [t.numpy() for t in topk.tree_merge_topk(*(torch.from_numpy(a) for a in (scores, shard_ids, ids)), k)]
    host = topk.tree_merge_topk_host(scores, shard_ids, ids, k)
    ref_host = ref_topk.tree_merge_topk_host(scores, shard_ids, ids, k)
    for g, w, h, rh in zip(got, want, host, ref_host):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(h, rh)
    # the tree's candidates and order equal the host merge's: the score
    # rows exactly, and the ids wherever the scores are distinct
    np.testing.assert_array_equal(got[0], host[0])


@pytest.mark.parametrize("S,kk,k", [(1, 4, 4), (3, 5, 7), (8, 3, 10)])
def test_merge_topk_matches_reference(S, kk, k):
    scores, _, ids = _lists(S, 5, kk, seed=S)
    ids = np.abs(ids)
    offsets = (np.arange(S) * 37).astype(np.int32)
    ws, wi = ref_topk.merge_topk(jnp.asarray(scores), jnp.asarray(ids), jnp.asarray(offsets), k)
    gs, gi = topk.merge_topk(torch.from_numpy(scores), torch.from_numpy(ids).long(), torch.from_numpy(offsets), k)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def _rows(N, d, seed):
    """Rows with duplicates (tied scores) and every 5th row invalid."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((N, d)).astype(np.float32)
    m[1::4] = m[0]  # the same row many times: exact score ties
    valid = np.ones(N, bool)
    valid[::5] = False
    return m, valid


@pytest.mark.parametrize("metric", ["dot", "cos", "l2sq"])
@pytest.mark.parametrize("N,k", [(24, 6), (5, 9)])  # k past N pads with -inf and row 0
def test_local_score_topk_matches_reference(metric, N, k):
    m, valid = _rows(N, 8, seed=N)
    q = np.random.default_rng(1).standard_normal((3, 8)).astype(np.float32)
    ws, wi = ref_topk.local_score_topk(jnp.asarray(q), jnp.asarray(m), jnp.asarray(valid), k, metric=metric)
    gs, gi = topk.local_score_topk(torch.from_numpy(q), torch.from_numpy(m), torch.from_numpy(valid), k, metric=metric)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_sharded_topk_matches_reference_and_dense(n_shards):
    N, d, k = n_shards * 16, 8, 7
    m, valid = _rows(N, d, seed=n_shards)
    q = np.random.default_rng(2).standard_normal((4, d)).astype(np.float32)
    ref_mesh = ref_make_mesh(n_shards, 1, devices=jax.devices()[:n_shards])
    ws, wi = jax.jit(lambda qq, mm, vv: ref_topk.sharded_topk(ref_mesh, qq, mm, vv, k))(q, m, valid)
    mesh = port_mesh.make_mesh(n_shards, 1, devices=["cpu"] * n_shards)
    blocks = port_mesh.host_to_global(m, mesh)
    valids = port_mesh.host_to_global(valid, mesh)
    gs, gi = topk.sharded_topk(mesh, torch.from_numpy(q), blocks, valids, k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6, atol=1e-6)
    # and the dense top-k over the whole matrix, ties in lax.top_k's order
    ds, di = topk.local_score_topk(torch.from_numpy(q), torch.from_numpy(m), torch.from_numpy(valid), k)
    np.testing.assert_array_equal(gi.numpy(), di.numpy())


def test_mesh_helpers():
    cpu = torch.device("cpu")
    mesh = port_mesh.make_mesh(4, 2, devices=[cpu] * 8)
    assert mesh.shape == {"data": 4, "model": 2} and mesh.data_device(3) == cpu
    assert port_mesh.data_axis_size(mesh) == 4 and not port_mesh.is_multiprocess(mesh)
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        port_mesh.make_mesh(8, 2, devices=[cpu] * 8)
    zeros = port_mesh.global_zeros((16, 3), torch.float32, mesh)
    assert [tuple(z.shape) for z in zeros] == [(4, 3)] * 4
    rows = port_mesh.host_to_global(np.arange(8, dtype=np.int32), mesh)
    assert [r.tolist() for r in rows] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    copies = port_mesh.host_to_global(np.arange(3), mesh, rows=False)
    assert len(copies) == 4 and all(c.tolist() == [0, 1, 2] for c in copies)
    port_mesh.set_mesh(mesh)
    try:
        assert port_mesh.current_mesh() is mesh and port_mesh.data_axis_size() == 4
    finally:
        port_mesh.set_mesh(None)
    assert port_mesh.current_mesh(create=False) is None


def test_mesh_axis_knobs(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_MODEL_SHARDS", "2")
    monkeypatch.setenv("PATHWAY_TPU_DATA_SHARDS", "3")
    mesh = port_mesh.make_mesh(devices=["cpu"] * 8)
    assert mesh.shape == {"data": 3, "model": 2}
