"""Ring attention and the trunk's sequence-parallel branch in the port,
against dense attention and against the reference (``ops/ring_attention.py``
over a virtual 8-device CPU mesh, as ``tests/test_ring_attention.py``
runs it).  Tolerance: f32 atol 2e-5, as the reference's own test (the
online softmax sums in another order than one softmax).

Across processes: two ranks of ``tests/torch_dist_worker.py ring`` (gloo
on the CPU) each hold 4 of the 8 sequence blocks of a ``("sp",)`` mesh
spanning the ranks; every rank's whole output is held against the
one-process ring and dense attention on that rank, and against the
reference's ``ring_attention_sharded`` on a 2-device host mesh within
1e-5 in f32, full and causal; the sequence-parallel trunk over that
mesh against the reference's trunk."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh

from pathway_tpu.models._params import unbox
from pathway_tpu.models.transformer import TransformerConfig as RefConfig, TransformerEncoder as RefEncoder
from pathway_tpu.ops.ring_attention import ring_attention_sharded as ref_ring
from pathway_tpu_torch.models.params import params_from_flax
from pathway_tpu_torch.models.transformer import TransformerConfig, TransformerEncoder
from pathway_tpu_torch.ops.ring_attention import dense_attention, ring_attention_blocks, ring_attention_sharded
from pathway_tpu_torch.parallel.mesh import Mesh

from .test_torch_cluster import _spawn
from .torch_dist_worker import ring_inputs

ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers; torch's default of one thread
    per core would crowd the timing-sensitive tests of the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_mesh():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices (conftest sets host platform count)")
    return RefMesh(np.array(devs[:8]), axis_names=("sp",))


def _port_mesh():
    return Mesh(["cpu"] * 8, axis_names=("sp",))


_qkv = ring_inputs


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_dense_and_reference(causal):
    arrays = _qkv()
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    got = ring_attention_sharded(_port_mesh(), *t, causal=causal)
    dense = dense_attention(*t, causal=causal)
    assert got.shape == dense.shape == (2, 64, 4, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=ATOL)
    want = ref_ring(_ref_mesh(), *(jnp.asarray(a) for a in arrays), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_ring_block_shapes_and_fully_masked_rows():
    """Each device holds L / n of the sequence; uniform values attend to
    v everywhere; a query with no allowed key gives 0, as dense after the
    NaN cleanup."""
    B, L, H, Dh, n = 1, 256, 2, 8, 8
    devices = [torch.device("cpu")] * n
    ones = torch.ones(B, L // n, H, Dh)
    mask = torch.ones(B, L // n, dtype=torch.bool)
    pos = [torch.arange(i * L // n, (i + 1) * L // n)[None] for i in range(n)]
    blocks = ring_attention_blocks(devices, [ones] * n, [ones] * n, [ones] * n, [mask] * n, pos)
    assert [tuple(b.shape) for b in blocks] == [(B, L // n, H, Dh)] * n
    assert all(b.device == d for b, d in zip(blocks, devices))
    np.testing.assert_allclose(torch.cat(blocks, 1).numpy(), np.ones((B, L, H, Dh)), atol=1e-5)
    # causal with the first keys masked: the first queries see no key
    q, k, v, _, positions = (torch.from_numpy(np.ascontiguousarray(a)) for a in _qkv(B=1, L=32))
    kv_mask = torch.arange(32)[None] >= 5
    got = ring_attention_sharded(_port_mesh(), q, k, v, kv_mask, positions, causal=True)
    assert torch.all(got[:, :5] == 0)
    np.testing.assert_allclose(got.numpy(), dense_attention(q, k, v, kv_mask, positions, True).numpy(), atol=ATOL)
    with pytest.raises(ValueError, match="does not split"):
        ring_attention_sharded(_port_mesh(), q[:, :30], k[:, :30], v[:, :30], kv_mask[:, :30], positions[:, :30])


def test_ring_bf16_keeps_the_working_type():
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in _qkv()]
    q16, k16, v16 = (x.to(torch.bfloat16) for x in t[:3])
    got = ring_attention_sharded(_port_mesh(), q16, k16, v16, t[3], t[4])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), dense_attention(q16, k16, v16, t[3], t[4]).numpy(), atol=3e-2)


def _trunk_kw(causal, pool):
    return dict(vocab_size=512, d_model=32, n_heads=4, n_layers=2, d_ff=128, max_len=64, pool=pool, causal=causal)


def _trunk_pair(causal, pool):
    mesh = _ref_mesh()
    L = 64
    kw = _trunk_kw(causal, pool)
    ref = RefEncoder(RefConfig(dtype=jnp.float32, mesh=mesh, sequence_axis="sp", **kw))
    rng = np.random.default_rng(3)
    ids = rng.integers(8, 512, size=(2, L)).astype(np.int32)
    lens = np.array([L, 41])
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    ids[mask == 0] = 0
    plain = RefEncoder(RefConfig(dtype=jnp.float32, **kw))
    params = unbox(plain.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))["params"])
    cfg = TransformerConfig(dtype=torch.float32, mesh=_port_mesh(), sequence_axis="sp", **kw)
    port = TransformerEncoder(cfg)
    port.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return ref, params, port, ids, mask


@pytest.mark.parametrize("causal,pool", [(False, "mean"), (True, "none")])
def test_sequence_parallel_trunk_matches_reference(causal, pool):
    ref, params, port, ids, mask = _trunk_pair(causal, pool)
    want = np.asarray(ref.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)), np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask)).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_sequence_parallel_trunk_refuses_packed_segments():
    ref, params, port, ids, mask = _trunk_pair(False, "mean")
    segments = np.where(mask > 0, 1, 0).astype(np.int32)
    positions = np.broadcast_to(np.arange(ids.shape[1])[None], ids.shape).astype(np.int32)
    with pytest.raises(AssertionError, match="packed"):
        ref.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask), segments=jnp.asarray(segments),
                  positions=jnp.asarray(positions), n_segments=1)
    with pytest.raises(ValueError, match="packed"), torch.no_grad():
        port(torch.from_numpy(ids), torch.from_numpy(mask), segments=torch.from_numpy(segments),
             positions=torch.from_numpy(positions), n_segments=1)


TRUNK_CASES = [(False, "mean"), (True, "none")]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two ranks of the ``ring`` scenario, with the trunk's
    seeded weights of both ``TRUNK_CASES`` (the reference's parameters
    carried into the port) saved for the ranks to load.  Returns
    ``(ranks' results, the reference's trunk outputs)``."""
    saved, want = [], []
    for causal, pool in TRUNK_CASES:
        ref, params, port, ids, mask = _trunk_pair(causal, pool)
        want.append(np.asarray(ref.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)), np.float32))
        saved.append({"kw": _trunk_kw(causal, pool), "state": port.state_dict(), "ids": torch.from_numpy(ids), "mask": torch.from_numpy(mask)})
    path = str(tmp_path_factory.mktemp("ring") / "trunk.pt")
    torch.save(saved, path)
    return _spawn("ring", env_extra={"RING_TRUNK": path}), want


@pytest.mark.parametrize("causal", [False, True])
def test_ring_across_processes_matches_one_process_dense_and_reference(two_ranks, causal):
    results, _ = two_ranks
    arrays = _qkv()
    want = np.asarray(_ref_ring_2(arrays, causal))
    name = "causal" if causal else "full"
    for r, got in enumerate(results):
        assert got["proc"] == r and got["multiprocess"] and got["backend"] == "gloo"
        assert got["owners"] == [0] * 4 + [1] * 4 and got["local"] == list(range(4 * r, 4 * r + 4))
        f32, bf16 = got[f"f32_{name}"], got[f"bf16_{name}"]
        assert f32["shape"] == bf16["shape"] == [2, 64, 4, 16]
        assert (f32["dtype"], bf16["dtype"]) == ("torch.float32", "torch.bfloat16")
        assert f32["vs_one"] <= 1e-6 and f32["vs_dense"] <= ATOL
        assert bf16["vs_one"] <= 1e-2 and bf16["vs_dense"] <= 3e-2
        np.testing.assert_allclose(np.asarray(f32["out"], np.float32), want, atol=1e-5, rtol=0)


def _ref_ring_2(arrays, causal):
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs 2 virtual devices (conftest sets host platform count)")
    return ref_ring(RefMesh(np.array(devs[:2]), axis_names=("sp",)), *(jnp.asarray(a) for a in arrays), causal=causal)


def test_ring_across_processes_raises_on_a_failed_shift(two_ranks):
    """An armed ``dist.shift`` raises on each rank (no rank answers with
    its own block), and the next call is exact again."""
    results, _ = two_ranks
    for got in results:
        assert got["shift_fault"] == "injected fault at 'dist.shift'"
        assert got["after_fault_vs_dense"] <= ATOL


@pytest.mark.parametrize("case", range(len(TRUNK_CASES)))
def test_sequence_parallel_trunk_across_processes_matches_reference(two_ranks, case):
    results, want = two_ranks
    for got in results:
        out = np.asarray(got["trunk"][case], np.float32)
        assert out.shape == want[case].shape and np.isfinite(out).all()
        np.testing.assert_allclose(out, want[case], atol=1e-5, rtol=0)


def test_ring_shift_needs_a_process_group():
    from pathway_tpu_torch.parallel import distributed

    with pytest.raises(RuntimeError, match="process group"):
        distributed.ring_shift([torch.zeros(2)])
