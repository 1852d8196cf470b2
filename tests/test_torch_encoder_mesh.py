"""``SentenceEncoder(mesh=...)`` in the port: against the reference's
encoder over its 8-device CPU mesh and against the port unsharded, on
the same seeded weights.  Tolerances as the trunk's: f32 atol 1e-5, bf16
atol 3e-2 (a row's block has another batch size than the whole batch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models.encoder import SentenceEncoder as RefEncoder
from pathway_tpu.parallel import make_mesh as ref_make_mesh
from pathway_tpu_torch.models.encoder import SentenceEncoder
from pathway_tpu_torch.parallel.mesh import make_mesh

_ENC = dict(dimension=32, n_layers=2, n_heads=4, max_length=32, vocab_size=1024, seed=0)
_WORDS = "stream join window index vector query tensor kernel shard replica commit offset".split()
_TOL = {"f32": 1e-5, "bf16": 3e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(_WORDS, size=int(rng.integers(2, 20)))) + f" item {i}" for i in range(n)]


@pytest.fixture(scope="module", params=["f32", "bf16"])
def encoders(request):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[request.param]
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (conftest sets host platform count)")
    ref = RefEncoder(dtype=jdt, mesh=ref_make_mesh(), **_ENC)
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    mesh = make_mesh(8, 1, devices=["cpu"] * 8)
    sharded = SentenceEncoder(dtype=tdt, device="cpu", params=tree, mesh=mesh, **_ENC)
    plain = SentenceEncoder(dtype=tdt, device="cpu", params=tree, **_ENC)
    return request.param, ref, sharded, plain


@pytest.mark.parametrize("n", [16, 61, 64])
def test_mesh_encoder_matches_reference_and_unsharded(encoders, n):
    name, ref, sharded, plain = encoders
    texts = _texts(n)
    got = sharded.encode(texts)
    assert got.shape == (n, _ENC["dimension"]) and np.isfinite(got).all()
    np.testing.assert_allclose(got, plain.encode(texts), atol=_TOL[name])
    np.testing.assert_allclose(got, np.asarray(ref.encode(texts), np.float32), atol=_TOL[name])


def test_mesh_encoder_blocks_use_batch_buckets(encoders):
    """Blocks are padded to the encoder's batch buckets: 64 texts over 8
    shards are blocks of 8 rows padded to 16; the tripwire sees that
    block shape."""
    _, _, sharded, _ = encoders
    sharded.encode(_texts(64))
    assert any(key[:2] == ("block", 16) for key in sharded._tripwire._sigs)
    assert len(sharded._replicas) == 1  # eight shards on one device share one replica
