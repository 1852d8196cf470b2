"""Port parity: the generator's sampling RNG (``pathway_tpu_torch/models/
prng.py``) against ``jax.random`` with ``jax_threefry_partitionable``.

Keys, splits, random bits and uniforms are compared bit for bit;
categorical draws token for token (the gumbel noise goes through
``log`` twice, where torch and XLA may differ by an ulp, so a draw could
flip only on a near tie of ``logits + gumbel``: none occurs on these
inputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu_torch.models import prng

_SEEDS = [0, 1, 2, 42, 123456789, -1, -(2**31), 2**31 - 1, 2**33 + 5]


def _jkey(seed):
    return np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)


def test_partitionable_threefry_is_the_reference_mode():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", _SEEDS)
def test_key_and_split_bit_exact(seed):
    assert (prng.key(seed) == _jkey(seed)).all()
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed))).astype(np.int64)
    got = prng.split(torch.from_numpy(prng.key(seed))).numpy()
    assert (got == want).all()
    # a chain of splits, as a decode lane walks it
    k_j, k_t = jax.random.PRNGKey(seed), torch.from_numpy(prng.key(seed))
    for _ in range(5):
        k_j, sub_j = jax.random.split(k_j)
        pair = prng.split(k_t)
        k_t = pair[0]
        assert (pair[1].numpy() == np.asarray(sub_j).astype(np.int64)).all()


def test_vmapped_split_bit_exact():
    keys = np.stack([_jkey(s) for s in range(7)])
    want = np.asarray(jax.vmap(jax.random.split)(jnp.asarray(keys.astype(np.uint32)))).astype(np.int64)
    got = prng.split(torch.from_numpy(keys)).numpy()
    assert got.shape == (7, 2, 2) and (got == want).all()


@pytest.mark.parametrize("shape", [(1,), (3, 7), (1000,), (2, 3, 5)])
def test_random_bits_bit_exact(shape):
    k = jax.random.PRNGKey(7)
    want = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
    got = prng.random_bits(torch.from_numpy(prng.key(7)), shape).numpy()
    assert got.shape == want.shape and (got == want).all()


def test_lane_bits_are_vmapped_bits():
    keys = np.stack([_jkey(s) for s in (3, 9, 27)])
    want = np.asarray(
        jax.vmap(lambda k: jax.random.bits(k, (300,), jnp.uint32))(jnp.asarray(keys.astype(np.uint32)))
    ).astype(np.int64)
    got = prng.random_bits(torch.from_numpy(keys), (300,)).numpy()
    assert (got == want).all()


def test_uniform_bit_exact():
    tiny = float(np.finfo(np.float32).tiny)
    for seed in (0, 5, 11):
        k = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.uniform(k, (4, 513), minval=tiny))
        got = prng.uniform(torch.from_numpy(prng.key(seed)), (4, 513), minval=tiny).numpy()
        assert got.dtype == np.float32 and (got.view(np.int32) == want.view(np.int32)).all()


@pytest.mark.parametrize("temperature", [0.3, 0.8, 1.5])
def test_categorical_matches_reference(temperature):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(6, 512)) / temperature).astype(np.float32)
    for seed in (0, 3, 8):
        want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed), logits))
        got = prng.categorical(torch.from_numpy(prng.key(seed)), torch.from_numpy(logits)).numpy()
        assert (got == want).all()
    keys = np.stack([_jkey(s) for s in range(6)])
    want = np.asarray(jax.vmap(jax.random.categorical)(jnp.asarray(keys.astype(np.uint32)), logits))
    got = prng.categorical(torch.from_numpy(keys), torch.from_numpy(logits)).numpy()
    assert (got == want).all()


def test_lane_draw_independent_of_batch_mates():
    """A lane's draw depends on its own key only: alone, or among other
    lanes in any order, it is the same token."""
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.normal(size=(5, 512)).astype(np.float32))
    keys = torch.from_numpy(np.stack([_jkey(s) for s in (4, 5, 6, 7, 8)]))
    together = prng.categorical(keys, logits)
    perm = [3, 0, 4, 2, 1]
    permuted = prng.categorical(keys[perm], logits[perm])
    for j in range(5):
        alone = prng.categorical(keys[j : j + 1], logits[j : j + 1])
        assert int(alone[0]) == int(together[j]) == int(permuted[perm.index(j)])


def test_argmax_takes_the_lowest_index_among_ties():
    logits = torch.zeros(3, 64)
    logits[0, [5, 9, 40]] = 2.0
    logits[1, [63, 1]] = 1.0
    logits[2] = -1.0
    assert torch.argmax(logits, dim=-1).tolist() == [5, 1, 0]
    assert np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), axis=-1)).tolist() == [5, 1, 0]
