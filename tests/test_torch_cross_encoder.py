"""Port parity of the packed cross-encoder on the CPU: the packing
layout (``models/packing.py``, integer for integer), the packed trunk
forward (block-diagonal segment attention, per-segment mean pool) and
``CrossEncoderModel`` packed and unpacked scores of ``pathway_tpu_torch``
against ``pathway_tpu``, with the reference's Flax weights carried over
by the bridge.  Tolerances: f32 atol 1e-5, bf16 atol 3e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import packing as ref_packing
from pathway_tpu.models._params import unbox
from pathway_tpu.models.cross_encoder import CrossEncoderModel as RefCrossEncoder
from pathway_tpu.models.transformer import TransformerConfig as RefConfig
from pathway_tpu.models.transformer import TransformerEncoder as RefTrunk
from pathway_tpu_torch.models import packing
from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel
from pathway_tpu_torch.models.params import params_from_flax
from pathway_tpu_torch.models.transformer import TransformerConfig, TransformerEncoder

from .test_torch_forward import corpus


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
CE = dict(dimension=32, n_layers=2, n_heads=4, max_length=64, vocab_size=512)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_rows_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n, L = int(rng.integers(1, 60)), 64
    lens = rng.integers(2, L + 1, size=n)
    ids_b = rng.integers(1, 500, size=(n, L)).astype(np.int32)
    want = ref_packing.pack_rows(ids_b, lens, L)
    got = packing.pack_rows(ids_b, lens, L)
    for w, g in zip(want[:4], got[:4]):
        np.testing.assert_array_equal(g, w)
    assert got[4:] == want[4:]  # doc_slots, n_seg
    for w, g in zip(ref_packing.pad_packed_rows(*want[:1], *want[2:4], 16), packing.pad_packed_rows(*got[:1], *got[2:4], 16)):
        np.testing.assert_array_equal(g, w)
    for m in range(1, 40):
        assert packing.seg_bucket(m) == ref_packing.seg_bucket(m)
    for longest in range(1, 600, 7):
        assert packing.row_length_bucket(longest, 256) == ref_packing.row_length_bucket(longest, 256)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_trunk_matches_reference(dtype):
    """Packed rows of several sequences, a pad row, absent segments: the
    per-segment pooled states equal the reference's."""
    jdt, tdt, atol = DTYPES[dtype]
    kw = dict(vocab_size=300, d_model=32, n_heads=4, n_layers=2, d_ff=128, max_len=64)
    ref = RefTrunk(RefConfig(dtype=jdt, **kw))
    rng = np.random.default_rng(4)
    lens = rng.integers(3, 30, size=9)
    ids_b = rng.integers(8, 300, size=(9, 64)).astype(np.int32)
    ids, _mask, segments, positions, _slots, n_seg = packing.pack_rows(ids_b, lens, 64)
    ids, segments, positions = packing.pad_packed_rows(ids, segments, positions, ids.shape[0] + 1)
    S = packing.seg_bucket(n_seg)
    params = unbox(ref.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(segments > 0))["params"])
    want = ref.apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(segments > 0),
        segments=jnp.asarray(segments), positions=jnp.asarray(positions), n_segments=S,
    )
    cfg = TransformerConfig(dtype=tdt, **kw)
    port = TransformerEncoder(cfg)
    port.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params), cfg))
    t = [torch.from_numpy(a) for a in (ids, segments, positions)]
    with torch.no_grad():
        got = port(t[0], t[1] > 0, segments=t[1], positions=t[2], n_segments=S)
    assert got.shape == (ids.shape[0], S, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=atol)
    assert not got[-1].any()  # the pad row: every segment absent


def _models(dtype):
    jdt, tdt, atol = DTYPES[dtype]
    ref = RefCrossEncoder(dtype=jdt, **CE)
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    return ref, CrossEncoderModel(dtype=tdt, device="cpu", params=tree, **CE), atol


def _pairs(n=21):
    queries = corpus(4, seed=8, lo=2, hi=8)
    docs = corpus(n, seed=9, lo=1, hi=70)  # some pairs cut at max_length
    return [(queries[i % 4], docs[i]) for i in range(n)]


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_encoder_scores_match_reference(dtype, packed):
    ref, port, atol = _models(dtype)
    pairs = _pairs()
    want = ref.predict(pairs, packed=packed)
    got = port.predict(pairs, packed=packed)
    assert got.shape == (len(pairs),) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_equals_unpacked_within_port(dtype):
    _, port, atol = _models(dtype)
    pairs = _pairs(30)
    np.testing.assert_allclose(port.predict(pairs), port.predict(pairs, packed=False), atol=atol)
    assert port.predict([]).shape == (0,)
