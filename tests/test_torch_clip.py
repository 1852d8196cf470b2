"""Port parity of ``ClipModel`` on the CPU: the reference's
``pathway_tpu.models.clip.ClipModel`` parameters carried over by
``clip_params_from_flax``, the same texts and images through both.

Tolerances: 3e-2 at the default bf16 (a bf16 trunk rounds at other
points than XLA's on the same graph), 1e-5 for an f32 twin of the same
weights.  Images cover the cases the reference's batcher handles: exact
size, larger than the model's (cropped), smaller (zero-padded), 2-D
grayscale (stacked to three channels).  Also: the ``clip.dispatch``
retry, the histograms, the occupancy records and the tripwire keys; the
port's seeded init and an IVF index of image rows searched by text rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models.clip import ClipModel as RefClip
from pathway_tpu.robust import inject as ref_inject
from pathway_tpu_torch import observe
from pathway_tpu_torch.models.clip import ClipModel
from pathway_tpu_torch.models.params import clip_params_from_flax
from pathway_tpu_torch.ops.ivf import IvfKnnIndex
from pathway_tpu_torch.robust import inject

KW = dict(dimension=32, proj_dim=16, n_layers=2, n_heads=4, image_size=32, patch=16, max_length=16, vocab_size=512)
TEXTS = ["a cat on a mat", "streaming vector index", "", "the quick brown fox jumps over the lazy dog"]


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    inject.disarm()
    ref_inject.disarm()


def _images(seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.random((32, 32, 3)).astype(np.float32),
        rng.random((48, 40, 3)).astype(np.float32),  # cropped
        rng.random((20, 12, 3)).astype(np.float32),  # zero-padded
        rng.random((32, 32)).astype(np.float32),  # grayscale
        rng.random((7, 50)).astype(np.float32),  # grayscale, padded and cropped
    ]


@pytest.fixture(scope="module", params=["bf16", "f32"])
def pair(request):
    jdt, tdt, tol = {"bf16": (jnp.bfloat16, torch.bfloat16, 3e-2), "f32": (jnp.float32, torch.float32, 1e-5)}[
        request.param
    ]
    ref = RefClip(dtype=jdt, **KW)
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    return ref, ClipModel(dtype=tdt, device="cpu", params=tree, **KW), tol


def test_encode_text_matches_reference(pair):
    ref, clip, tol = pair
    want, got = ref.encode_text(TEXTS), clip.encode_text(TEXTS)
    assert got.dtype == np.float32 and got.shape == (len(TEXTS), 16)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert clip.encode_text([]).shape == (0, 16) and clip.get_embedding_dimension() == 16


def test_encode_image_matches_reference(pair):
    ref, clip, tol = pair
    images = _images()
    want, got = ref.encode_image(images), clip.encode_image(images)
    assert got.dtype == np.float32 and got.shape == (len(images), 16)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    # the batcher: grayscale stacked, oversized cropped, small zero-padded
    batch = clip.image_batch(images)
    assert batch.shape == (16, 32, 32, 3)
    assert np.array_equal(batch[3], np.stack([images[3]] * 3, axis=-1))
    assert np.array_equal(batch[1], images[1][:32, :32])
    assert np.array_equal(batch[2, :20, :12], images[2]) and not batch[2, 20:].any() and not batch[2, :, 12:].any()
    assert np.array_equal(batch[4, :7, :32, 0], images[4][:, :32]) and not batch[4, 7:].any()
    assert clip.encode_image([]).shape == (0, 16)


def test_bridge_layouts():
    """Conv kernel ``[kh, kw, in, out]`` -> ``[out, in, kh, kw]``; Dense
    kernels transposed; every tensor of the port's module filled."""
    ref = RefClip(dtype=jnp.float32, **KW)
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    clip = ClipModel(dtype=torch.float32, device="cpu", params=tree, **KW)
    sd = clip_params_from_flax(tree, clip.config)
    assert set(sd) == set(clip.module.state_dict())
    kernel = tree["image"]["patchify"]["kernel"]
    assert sd["image.patchify.weight"].shape == (32, 3, 16, 16)
    assert sd["image.patchify.weight"][5, 2, 3, 7] == kernel[3, 7, 2, 5]
    assert torch.equal(sd["text_proj.weight"], torch.from_numpy(tree["text_proj"]["kernel"].T.copy()))


def test_clip_dispatch_retried_and_observed(pair, monkeypatch):
    ref, clip, _ = pair
    want_t, want_i = clip.encode_text(TEXTS), clip.encode_image(_images())
    retries = observe.counter("pathway_robust_retries_total", site="clip.dispatch")
    h_text = observe.histogram("pathway_serve_model_seconds", model="clip_text")
    h_image = observe.histogram("pathway_serve_model_seconds", model="clip_image")
    before = (retries.value, h_text.count, h_image.count)
    monkeypatch.setenv("PATHWAY_RETRY_BASE_MS", "0")
    with inject.armed("clip.dispatch", "raise", times=1):
        got_t = clip.encode_text(TEXTS)
    with inject.armed("clip.dispatch", "raise", times=1):
        got_i = clip.encode_image(_images())
    with ref_inject.armed("clip.dispatch", "raise", times=1):
        ref.encode_text(TEXTS)  # the reference retries the same site
    assert np.array_equal(got_t, want_t) and np.array_equal(got_i, want_i)
    assert (retries.value, h_text.count, h_image.count) == (before[0] + 2, before[1] + 1, before[2] + 1)
    sigs = clip._tripwire._sigs
    assert ("text", 4, 16) in sigs and ("image", 16) in sigs


def test_seeded_init_and_image_index_searched_by_text():
    a = ClipModel(device="cpu", **KW)
    b = ClipModel(device="cpu", **KW)
    c = ClipModel(device="cpu", seed=4, **KW)
    images = _images(1) * 4
    assert np.array_equal(a.encode_image(images), b.encode_image(images))
    assert not np.array_equal(a.encode_image(images), c.encode_image(images))
    # the multimodal path: image rows in an IVF index, text rows as queries
    rng = np.random.default_rng(2)
    imgs = [rng.random((32, 32, 3)).astype(np.float32) for _ in range(64)]
    rows = a.encode_image(imgs)
    ivf = IvfKnnIndex(16, n_clusters=4, device="cpu")
    ivf.add(range(64), rows)
    ivf.build()
    ivf.n_probe = 4
    got = ivf.search(a.encode_text(TEXTS), 5)
    want = np.argsort(-(a.encode_text(TEXTS) @ rows.T), axis=1, kind="stable")[:, :5]
    assert [[k for k, _ in row] for row in got] == want.tolist()
