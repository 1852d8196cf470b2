"""Port parity: the IVF rescore and ``IvfKnnIndex`` of ``pathway_tpu_torch``
against the reference.

- ``ivf_rescore_reference`` (the plain version beside the CUDA kernel)
  against the Pallas kernel run in interpret mode and against the
  reference's XLA slab gather; f32 atol 1e-4 (summation order differs),
  and the -inf pattern must be identical.
- The port's own k-means + balanced layout must give the reference's
  ``slot_of_key`` on well-separated blobs (integers: exact).
- After ``load_warm_state(reference.warm_state())`` the port's search must
  return the reference's keys (hence slots: the slot maps are equal),
  allowing a swap only between scores tied within 1e-5; scores within
  1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops.ivf import IvfKnnIndex as RefIvf
from pathway_tpu.ops.ivf_pallas import ivf_rescore, rescore_shortlist as ref_rescore
from pathway_tpu_torch.ops.ivf import IvfKnnIndex
from pathway_tpu_torch.ops.ivf_rescore import ivf_rescore_reference, rescore_shortlist


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers; torch's default of one thread
    per core would crowd the timing-sensitive tests of the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TIE = 1e-5
SCORE_ATOL = 1e-4


def assert_same_ranking(want, got, tie=TIE, atol=SCORE_ATOL):
    """``want``/``got``: [(key, score), ...] rows sorted by score.  Keys
    must agree position by position, except between scores tied within
    ``tie`` (a tie may break either way)."""
    assert len(got) == len(want)
    ws = [s for _, s in want]
    for j, ((wk, wsc), (gk, gsc)) in enumerate(zip(want, got)):
        assert abs(wsc - gsc) <= atol, (j, wsc, gsc)
        if wk != gk:
            tied = any(
                abs(ws[i] - wsc) <= tie for i in (j - 1, j + 1) if 0 <= i < len(ws)
            )
            assert tied and abs(wsc - gsc) <= tie, (j, want, got)


def _rescore_case(B, p, C, M, d, seed=3, inf_frac=0.2):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, d)).astype(np.float32)
    slabs = rng.normal(size=(C, M, d)).astype(np.float32)
    bias = np.where(rng.random((C, M)) < inf_frac, -np.inf, 0.0).astype(np.float32)
    if p == C:
        probe = np.stack([rng.permutation(C) for _ in range(B)]).astype(np.int32)
    else:
        probe = rng.integers(0, C, size=(B, p)).astype(np.int32)
    return probe, q, slabs, bias


def _assert_scores(got, want):
    assert (np.isneginf(got) == np.isneginf(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(np.where(fin, got, 0.0), np.where(fin, want, 0.0), atol=SCORE_ATOL)


@pytest.mark.parametrize(
    "B,p,C,M,d",
    [
        (8, 4, 16, 128, 128),  # the Pallas kernel's own test shape
        (3, 5, 16, 128, 128),  # B not a multiple of 8
        (8, 16, 16, 128, 128),  # p = C
    ],
)
def test_plain_rescore_matches_pallas_interpret(B, p, C, M, d):
    probe, q, slabs, bias = _rescore_case(B, p, C, M, d)
    got = ivf_rescore_reference(
        torch.from_numpy(probe), torch.from_numpy(q), torch.from_numpy(slabs), torch.from_numpy(bias)
    ).numpy()
    # the Pallas kernel needs B % 8 == 0: pad as rescore_shortlist does
    B8 = ((B + 7) // 8) * 8
    pq = np.concatenate([q, np.zeros((B8 - B, d), np.float32)])
    pp = np.concatenate([probe, np.zeros((B8 - B, p), np.int32)])
    pallas = np.asarray(
        ivf_rescore(jnp.asarray(pp), jnp.asarray(pq), jnp.asarray(slabs), jnp.asarray(bias), interpret=True)
    )[:B]
    xla = np.asarray(
        ref_rescore(jnp.asarray(probe), jnp.asarray(q), jnp.asarray(slabs), jnp.asarray(bias), use_pallas=False)
    )
    assert got.shape == (B, p, M)
    _assert_scores(got, pallas)
    _assert_scores(got, xla)


@pytest.mark.parametrize("B,p,C,M,d", [(3, 7, 7, 200, 96), (5, 3, 9, 33, 99)])
def test_plain_rescore_odd_shapes_and_bf16(B, p, C, M, d):
    """M and d not multiples of 128, C not a multiple of 8, bf16 slabs
    (compared against the reference fed the same bf16 slabs)."""
    probe, q, slabs, bias = _rescore_case(B, p, C, M, d, seed=5)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        s_t = torch.from_numpy(slabs).to(tdt)
        got = rescore_shortlist(torch.from_numpy(probe), torch.from_numpy(q), s_t, torch.from_numpy(bias))
        want = ref_rescore(
            jnp.asarray(probe), jnp.asarray(q), jnp.asarray(slabs, jdt), jnp.asarray(bias), use_pallas=False
        )
        _assert_scores(got.numpy(), np.asarray(want))


def _blobs(n_blobs=16, per=128, dim=32, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_blobs, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    data = np.repeat(centers, per, axis=0) + 0.05 * rng.normal(size=(n_blobs * per, dim)).astype(np.float32)
    keys = [int(k) for k in rng.permutation(10 * n_blobs * per)[: n_blobs * per] * 7919 + 3]
    return keys, data.astype(np.float32), rng


def test_port_build_gives_reference_slots():
    keys, data, _ = _blobs()
    ref = RefIvf(dimension=32, n_clusters=16, seed=1)
    ref.add(keys, data)
    ref.build()
    port = IvfKnnIndex(dimension=32, n_clusters=16, seed=1, device="cpu")
    port.add(keys, data)
    port.build()
    assert port._slot_of_key == ref._slot_of_key
    assert (port._M_pad, port._d_pad) == (ref._M_pad, ref._d_pad)
    np.testing.assert_array_equal(port._keys_by_slot, ref._keys_by_slot)
    np.testing.assert_array_equal(port._bias.numpy(), np.asarray(ref._bias))
    np.testing.assert_allclose(port._slabs.numpy(), np.asarray(ref._slabs), atol=1e-6)


def test_port_build_from_matrix_gives_reference_slots():
    keys, data, _ = _blobs(seed=2)
    ref = RefIvf(dimension=32, n_clusters=16, seed=4)
    ref.build_from_matrix(keys, jnp.asarray(data))
    port = IvfKnnIndex(dimension=32, n_clusters=16, seed=4, device="cpu")
    port.build_from_matrix(keys, torch.from_numpy(data))
    assert port._slot_of_key == ref._slot_of_key
    np.testing.assert_allclose(port._slabs.numpy(), np.asarray(ref._slabs), atol=1e-6)
    assert len(port) == len(ref) == len(keys)


@pytest.mark.parametrize("slab_dtype", ["f32", "bf16"])
def test_search_after_warm_state_matches_reference(slab_dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[slab_dtype]
    keys, data, rng = _blobs(seed=6)
    ref = RefIvf(dimension=32, n_clusters=16, seed=1, dtype=jdt)
    ref.add(keys, data)
    ref.build()
    # a few rows after the build ride the exact tail; one upsert, one removal
    fresh = rng.normal(size=(5, 32)).astype(np.float32)
    ref.add([1, 2, 3, 4, keys[0]], fresh)
    ref.remove([keys[1]])
    port = IvfKnnIndex(dimension=32, n_clusters=16, seed=1, dtype=tdt, device="cpu")
    port.load_warm_state(ref.warm_state())
    assert port._slot_of_key == ref._slot_of_key and len(port) == len(ref)
    queries = np.concatenate([data[::97] + 0.01, fresh[:2]])
    for n_probe in (None, 16):
        want = ref.search(queries, k=10, n_probe=n_probe)
        got = port.search(queries, k=10, n_probe=n_probe)
        for w, g in zip(want, got):
            assert_same_ranking(w, g)
    assert all(keys[1] not in {k for k, _ in row} for row in got)
