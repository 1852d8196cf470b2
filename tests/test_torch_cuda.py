"""Port tests that need an NVIDIA GPU and nvcc: the CUDA rescore kernels
against their plain version, the IVF serve path through them, an absorb
and a background retrain on the card, the forward-index gather (against
the NumPy MaxSim, and without a device-to-host sync) and the packed
cross-encoder against the unpacked one.  They skip
without a card.  This file imports neither JAX nor the reference, so on
a machine without JAX it runs as

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import time

import numpy as np
import pytest
import torch

from pathway_tpu_torch.ops.ivf_rescore import ivf_rescore_reference, rescore_shortlist

# (B, p, C, M, d): the Pallas kernel's test shape, B not a multiple of 8,
# p = C, M / d / C off the TPU tiling, d off the 16-byte vector width
# (the non-TMA path), B = 1, B = 130 (a cluster probed by more queries
# than one pass of the kernel takes), M = 33 with a TMA-aligned d, and a
# C whose counters do not fit in shared memory
_SHAPES = [
    (8, 4, 16, 128, 128),
    (3, 5, 16, 128, 128),
    (8, 16, 16, 128, 128),
    (5, 7, 7, 200, 96),
    (4, 3, 9, 33, 99),
    (1, 6, 40, 256, 384),
    (130, 8, 12, 96, 64),
    (6, 4, 10, 33, 128),
    (4, 5, 30000, 33, 64),
]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _case(B, p, C, M, d, dev, seed=3, probe=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, d)).astype(np.float32)
    slabs = rng.normal(size=(C, M, d)).astype(np.float32)
    bias = np.where(rng.random((C, M)) < 0.2, -np.inf, 0.0).astype(np.float32)
    if probe is None and p == C:
        probe = np.stack([rng.permutation(C) for _ in range(B)])
    elif probe is None:
        probe = rng.integers(0, C, size=(B, p))
    return [torch.from_numpy(np.asarray(a)).to(dev) for a in (probe.astype(np.int32), q, slabs, bias)]


def _assert_matches_plain(probe, q, slabs, bias, plain_probe=None):
    """-inf pattern identical; finite values within 1e-3 (f32 sums in
    another order; bf16 slabs are fed to both versions).  Returns the
    kernel's output."""
    got = rescore_shortlist(probe, q, slabs, bias)
    want = ivf_rescore_reference(probe if plain_probe is None else plain_probe, q, slabs, bias)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    assert float((got[fin] - want[fin]).abs().max()) <= 1e-3
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("slab_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _SHAPES)
def test_cuda_rescore_matches_plain(shape, slab_dtype):
    """-inf pattern identical; finite values within 1e-3 (f32 sums in
    another order; bf16 slabs are fed to both versions)."""
    dev = _cuda()
    probe, q, slabs, bias = _case(*shape, dev)
    slabs = slabs.to(slab_dtype)
    before = rescore_shortlist.launches
    got = _assert_matches_plain(probe, q, slabs, bias)
    assert rescore_shortlist.launches == before + 1
    assert got.shape == (shape[0], shape[1], shape[3])


@pytest.mark.cuda
@pytest.mark.parametrize("slab_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["one_cluster", "duplicates", "out_of_range"])
def test_cuda_rescore_probe_table_edges(case, slab_dtype):
    """Every probe on one cluster (p = 1, all equal); duplicate probes
    within a row; ids outside [0, C) clamp to the edge clusters, as the
    reference's gather does."""
    dev = _cuda()
    B, p, C, M, d = {"one_cluster": (64, 1, 9, 128, 384), "duplicates": (7, 6, 11, 96, 128),
                     "out_of_range": (5, 4, 8, 64, 96)}[case]
    rng = np.random.default_rng(11)
    if case == "one_cluster":
        probe = np.full((B, p), 4)
    elif case == "duplicates":
        probe = np.repeat(rng.integers(0, C, size=(B, p // 2)), 2, axis=1)
    else:
        probe = rng.integers(-3, C + 3, size=(B, p))
    probe, q, slabs, bias = _case(B, p, C, M, d, dev, probe=probe)
    slabs = slabs.to(slab_dtype)
    _assert_matches_plain(probe, q, slabs, bias, plain_probe=probe.clamp(0, C - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("slab_dtype", [torch.float32, torch.bfloat16])
def test_cuda_rescore_bitwise_repeatable_without_sync(slab_dtype):
    """Main-path widths: two launches give bitwise-equal output (the pair
    order inside a cluster comes from atomics and must not matter), and
    the call makes no device-to-host sync."""
    dev = _cuda()
    probe, q, slabs, bias = _case(64, 69, 300, 256, 384, dev)
    slabs = slabs.to(slab_dtype)
    first = _assert_matches_plain(probe, q, slabs, bias)
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = rescore_shortlist(probe, q, slabs, bias)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.cuda
def test_cuda_rescore_rejects_bad_inputs():
    dev = _cuda()
    probe, q, slabs, bias = _case(4, 3, 9, 33, 99, dev)
    with pytest.raises(TypeError):
        rescore_shortlist(probe.long(), q, slabs, bias)
    with pytest.raises(ValueError):
        rescore_shortlist(probe, q[:, :50], slabs, bias)
    with pytest.raises(ValueError):
        rescore_shortlist(probe, q.cpu(), slabs, bias)


@pytest.mark.cuda
def test_cuda_ivf_serve_goes_through_kernel():
    dev = _cuda()
    from pathway_tpu_torch.models.encoder import SentenceEncoder
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch

    enc = SentenceEncoder(dimension=64, n_layers=2, n_heads=4, max_length=32, vocab_size=4096)
    docs = [f"document {i} about topic {i % 37} and item {i % 11}" for i in range(2000)]
    vecs = torch.cat([enc.encode_to_device(docs[i : i + 256]) for i in range(0, 2000, 256)])
    exact = DeviceKnnIndex(64, initial_capacity=2000)
    exact.add_from_device(list(range(2000)), vecs)
    ivf = IvfKnnIndex(64, device=dev)
    ivf.build_from_matrix(list(range(2000)), exact._matrix[:2000])
    ivf.n_probe = ivf._centroids.shape[0]  # full probe: equals exact
    before = rescore_shortlist.launches
    got = FusedEncodeSearch(enc, ivf)(docs[:64:3])
    want = FusedEncodeSearch(enc, exact)(docs[:64:3])
    assert rescore_shortlist.launches == before + 1
    for w, g in zip(want, got):
        assert [k for k, _ in g][:1] == [k for k, _ in w][:1]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=1e-4)


@pytest.mark.cuda
def test_cuda_ivf_absorb_writes_slabs_in_place():
    """Rows added past ``absorb_threshold`` land in free slots through the
    in-place slab and bias writes on the card; a full-probe search then
    ranks each absorbed row first."""
    dev = _cuda()
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex

    rng = np.random.default_rng(4)
    centers = rng.normal(size=(16, 64)).astype(np.float32)
    data = np.repeat(centers, 64, axis=0) + 0.05 * rng.normal(size=(1024, 64)).astype(np.float32)
    ivf = IvfKnnIndex(64, n_clusters=16, absorb_threshold=32, device=dev)
    ivf.build_from_matrix(list(range(1024)), torch.from_numpy(data).to(dev))
    slabs_ptr = ivf._slabs.data_ptr()
    fresh = data[::16] + 0.01 * rng.normal(size=(64, 64)).astype(np.float32)
    ivf.add(list(range(10_000, 10_064)), fresh)
    for _ in range(6000):
        if not ivf._absorbing:
            break
        time.sleep(0.01)
    assert not ivf._absorbing and ivf.stats["absorbs"] == 1 and not ivf._tail
    assert ivf._slabs.data_ptr() == slabs_ptr  # updated in place
    ivf.n_probe = ivf._centroids.shape[0]
    got = ivf.search(fresh, k=3)
    assert [row[0][0] for row in got] == list(range(10_000, 10_064))


def _forward_stack(dev):
    from pathway_tpu_torch.index import ForwardIndex
    from pathway_tpu_torch.models.encoder import SentenceEncoder

    enc = SentenceEncoder(dimension=64, n_layers=2, n_heads=4, max_length=32, vocab_size=4096, dtype=torch.float32)
    docs = [f"document {i} about topic {i % 37} and item {i % 11} " + "word " * (i % 19) for i in range(300)]
    fwd = ForwardIndex(enc, tokens_per_doc=8, initial_capacity=64)
    for i in range(0, 300, 128):  # grows past the initial capacity
        fwd.add(range(i, min(i + 128, 300)), docs[i : i + 128])
    queries = docs[:16:3]
    qtok, _, _ = enc.encode_token_states(queries)
    ids, qmask = enc.tokenizer.encode_batch(queries)
    qmask = np.concatenate([qmask, np.zeros((8 - len(queries), qmask.shape[1]), qmask.dtype)])
    qtok = torch.cat([qtok[: len(queries), : ids.shape[1]], qtok.new_zeros((8 - len(queries), ids.shape[1], 64))])
    cands = [[(i * 7 + j * 13) % 320 for j in range(20)] for i in range(len(queries))]  # keys >= 300 absent
    return fwd, qtok, qmask, cands


@pytest.mark.cuda
def test_cuda_gather_matches_numpy_maxsim():
    _cuda()
    from pathway_tpu_torch.ops.maxsim import maxsim_scores_host

    fwd, qtok, qmask, cands = _forward_stack(torch.device("cuda"))
    done, missing = fwd.gather_submit(qtok, qmask, cands, 10, width=24)
    scores, perm = done()
    tok = fwd._tok.float().cpu().numpy() * fwd._scales.cpu().numpy()[:, None, :]
    nvalid = fwd._nvalid.cpu().numpy()
    q = qtok.cpu().numpy()
    for qi, row in enumerate(cands):
        assert missing[qi] == [j for j, key in enumerate(row) if key >= 300]
        slots = [fwd._slot_of_key.get(key, -1) for key in row]
        want = np.full(len(row), -np.inf, np.float32)
        live = [j for j, s in enumerate(slots) if s >= 0]
        want[live] = maxsim_scores_host(q[qi], qmask[qi], tok[[slots[j] for j in live]], nvalid[[slots[j] for j in live]])
        order = np.argsort(-want, kind="stable")[:10]
        np.testing.assert_allclose(scores[qi], want[order], atol=1e-4)
        assert sorted(perm[qi].tolist()) == sorted(order.tolist())


@pytest.mark.cuda
def test_cuda_gather_makes_no_host_sync():
    _cuda()
    fwd, qtok, qmask, cands = _forward_stack(torch.device("cuda"))
    fwd.gather_submit(qtok, qmask, cands, 10, width=24)[0]()  # warm the allocator
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        done, _ = fwd.gather_submit(qtok, qmask, cands, 10, width=24)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert done()[0].shape == (len(cands), 10)


@pytest.mark.cuda
def test_cuda_cross_encoder_packed_matches_unpacked():
    _cuda()
    from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel

    ce = CrossEncoderModel(dimension=64, n_layers=2, n_heads=4, max_length=128, vocab_size=4096)
    rng = np.random.default_rng(5)
    words = "stream join window index vector query tensor kernel shard replica".split()
    pairs = [
        (" ".join(rng.choice(words, size=4)), " ".join(rng.choice(words, size=int(rng.integers(1, 90)))))
        for _ in range(70)
    ]
    np.testing.assert_allclose(ce.predict(pairs), ce.predict(pairs, packed=False), atol=3e-2)


@pytest.mark.cuda
def test_cuda_ivf_background_retrain():
    """Rows past ``rebuild_fraction`` retrain the layout on the card; each
    added row is then its own nearest neighbour at full probe."""
    dev = _cuda()
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex

    rng = np.random.default_rng(6)
    data = rng.normal(size=(2048, 64)).astype(np.float32)
    ivf = IvfKnnIndex(64, absorb_threshold=10**6, device=dev)
    ivf.add(range(1536), data[:1536])
    ivf.build()
    ivf.add(range(1536, 2048), data[1536:])
    for _ in range(6000):
        if not ivf._retraining:
            break
        time.sleep(0.01)
    assert ivf.stats["retrains"] == 1 and not ivf._tail and ivf._built_n == 2048
    ivf.n_probe = ivf._centroids.shape[0]
    got = ivf.search(data[1536::16], k=1)
    assert [row[0][0] for row in got] == list(range(1536, 2048, 16))
