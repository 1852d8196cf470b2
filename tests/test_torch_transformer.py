"""Port parity: the torch encoder trunk against the Flax reference, with
the reference's ``module.init`` parameters carried over by
``params_from_flax``.

Tolerances: f32 at atol 1e-5 (same math, different summation order);
bf16 at atol 3e-2, about one bf16 ulp at |x| in [2, 4): the port rounds
at the reference's points (GELU op for op), but tanh, matmul and
reduction kernels still differ in the last bit now and then."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from dataclasses import replace

from pathway_tpu.models._params import unbox
from pathway_tpu.models.transformer import (
    TransformerConfig as RefConfig,
    TransformerEncoder as RefEncoder,
    normalized_token_states as ref_token_states,
)
from pathway_tpu_torch.models.params import init_encoder_, params_from_flax
from pathway_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerEncoder,
    normalized_token_states,
    token_state_trunk,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers; torch's default of one thread
    per core would crowd the timing-sensitive tests of the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(seed=0, B=5, L=16, vocab=512):
    rng = np.random.default_rng(seed)
    ids = rng.integers(8, vocab, size=(B, L)).astype(np.int32)
    lens = np.array([L, 9, 3, 1, 0][:B])  # last row fully masked (a pad row)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    ids[mask == 0] = 0
    return ids, mask


def _pair(dtype_name, pool="mean"):
    jdt, tdt, _ = _DTYPES[dtype_name]
    rcfg = RefConfig(vocab_size=512, d_model=64, n_heads=4, n_layers=2, d_ff=256,
                     max_len=32, dtype=jdt, pool=pool)
    ref = RefEncoder(rcfg)
    ids, mask = _inputs()
    params = unbox(ref.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))["params"])
    tree = jax.tree_util.tree_map(np.asarray, params)
    cfg = TransformerConfig(vocab_size=512, d_model=64, n_heads=4, n_layers=2, d_ff=256,
                            max_len=32, dtype=tdt, pool=pool)
    port = TransformerEncoder(cfg)
    port.load_state_dict(params_from_flax(tree, cfg))
    return ref, params, port, ids, mask


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("pool", ["mean", "cls", "none"])
def test_pooled_and_hidden_match_reference(pool, dtype_name):
    ref, params, port, ids, mask = _pair(dtype_name, pool)
    want = np.asarray(ref.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)), np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask)).float().numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=_DTYPES[dtype_name][2], rtol=0)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_normalized_token_states_match_reference(dtype_name):
    ref, params, port, ids, mask = _pair(dtype_name)
    ref_trunk = RefEncoder(replace(ref.config, pool="none"))
    hidden = ref_trunk.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    want = np.asarray(ref_token_states(hidden, jnp.asarray(mask)))
    trunk = token_state_trunk(port.config)
    trunk.load_state_dict(port.state_dict())
    with torch.no_grad():
        got = normalized_token_states(
            trunk(torch.from_numpy(ids), torch.from_numpy(mask)), torch.from_numpy(mask)
        ).numpy()
    np.testing.assert_allclose(got, want, atol=_DTYPES[dtype_name][2], rtol=0)
    assert (got[mask == 0] == 0).all()


def test_fully_masked_rows_stay_finite():
    """A batch bucket's pad rows have no real token: the finfo.min fill
    gives them a finite uniform softmax (an -inf fill would give NaN)."""
    _, _, port, ids, _ = _pair("bf16")
    mask = np.zeros_like(ids)
    with torch.no_grad():
        out = port(torch.from_numpy(ids), torch.from_numpy(mask))
    assert torch.isfinite(out).all()


def test_seeded_init_is_deterministic_with_flax_distributions():
    cfg = TransformerConfig(vocab_size=512, d_model=64, n_heads=4, n_layers=2, d_ff=256,
                            max_len=32, dtype=torch.float32)
    a, b = TransformerEncoder(cfg), TransformerEncoder(cfg)
    init_encoder_(a, torch.Generator().manual_seed(3))
    init_encoder_(b, torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    w = a.blocks[0].mlp.fc0.weight  # xavier-uniform limit sqrt(6 / (64 + 256))
    assert w.abs().max() <= np.sqrt(6 / 320) and w.std() > 0.5 * np.sqrt(2 / 320)
    assert abs(float(a.tok_embed.weight.detach().std()) - 0.02) < 2e-3
    assert torch.count_nonzero(a.blocks[1].attn.out.bias) == 0
