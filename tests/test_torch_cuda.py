"""Port tests that need an NVIDIA GPU and nvcc: the CUDA rescore kernel
against its plain version, and the IVF serve path through it.  They skip
without a card.  This file imports neither JAX nor the reference, so on
a machine without JAX it runs as

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pathway_tpu_torch.ops.ivf_rescore import ivf_rescore_reference, rescore_shortlist

# (B, p, C, M, d): the Pallas kernel's test shape, B not a multiple of 8,
# p = C, M / d / C off the TPU tiling, d off the 16-byte vector width
_SHAPES = [
    (8, 4, 16, 128, 128),
    (3, 5, 16, 128, 128),
    (8, 16, 16, 128, 128),
    (5, 7, 7, 200, 96),
    (4, 3, 9, 33, 99),
]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _case(B, p, C, M, d, dev, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, d)).astype(np.float32)
    slabs = rng.normal(size=(C, M, d)).astype(np.float32)
    bias = np.where(rng.random((C, M)) < 0.2, -np.inf, 0.0).astype(np.float32)
    if p == C:
        probe = np.stack([rng.permutation(C) for _ in range(B)])
    else:
        probe = rng.integers(0, C, size=(B, p))
    return [torch.from_numpy(a).to(dev) for a in (probe.astype(np.int32), q, slabs, bias)]


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
    got = rescore_shortlist(probe, q, slabs, bias)
    want = ivf_rescore_reference(probe, q, slabs, bias)
    torch.cuda.synchronize()
    assert rescore_shortlist.launches == before + 1
    assert got.shape == want.shape == (shape[0], shape[1], shape[3])
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    assert float((got[fin] - want[fin]).abs().max()) <= 1e-3


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
