"""The decode path's row kernels on the CPU (``ops/decode_rows.py``): the
plain version of the fused residual add + LayerNorm is bit for bit the
add followed by the plain LayerNorm, in f32 and bf16; the wrappers take
the plain versions for CPU tensors without counting a launch; and
``kv_forward`` runs every LayerNorm of a forward through the fused entry
(2 per block + 1), so a forward launches no separate residual add.  The
kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from pathway_tpu_torch.models import transformer
from pathway_tpu_torch.models.generator import TextGenerator
from pathway_tpu_torch.ops.decode_rows import (
    add_layer_norm_reference,
    add_layer_norm_rows,
    layer_norm_reference,
    layer_norm_rows,
    tied_readout,
    tied_readout_reference,
)


def _case(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 3).to(dtype)
    delta = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, size=d).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=d).astype(np.float32) * 0.1)
    return x, delta, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 1, 256), (16, 32, 256), (3, 5, 99), (1, 1, 1536)])
def test_fused_reference_equals_add_then_layer_norm(dtype, shape):
    x, delta, w, b = _case(shape, dtype, seed=sum(shape))
    for out_dtype in (torch.float32, torch.bfloat16):
        s, y = add_layer_norm_reference(x, delta, w, b, out_dtype)
        assert s.dtype == dtype and y.dtype == out_dtype
        assert torch.equal(s, x + delta)
        assert torch.equal(y, layer_norm_reference(x + delta, w, b, out_dtype))


def test_cpu_tensors_take_the_plain_versions_without_a_launch():
    x, delta, w, b = _case((4, 2, 64), torch.bfloat16, seed=1)
    table = torch.from_numpy(np.random.default_rng(2).normal(size=(300, 64)).astype(np.float32))
    counts = (layer_norm_rows.launches, add_layer_norm_rows.launches, tied_readout.launches)
    s, y = add_layer_norm_rows(x, delta, w, b, torch.bfloat16)
    assert torch.equal(s, x + delta) and torch.equal(y, layer_norm_reference(s, w, b, torch.bfloat16))
    assert torch.equal(layer_norm_rows(x, w, b, torch.float32), layer_norm_reference(x, w, b, torch.float32))
    assert torch.equal(tied_readout(y[:, 0], table), tied_readout_reference(y[:, 0], table))
    assert (layer_norm_rows.launches, add_layer_norm_rows.launches, tied_readout.launches) == counts


@pytest.mark.parametrize("layers", [None, 1])
def test_kv_forward_fuses_every_residual_add(monkeypatch, layers):
    """One step of a 3-layer trunk: 2 * layers + 1 fused calls, and the
    result bit for bit the unfused sequence (``x + delta``, then the
    LayerNorm)."""
    gen = TextGenerator(dimension=32, n_layers=3, n_heads=4, max_length=64, vocab_size=512,
                        device="cpu", dtype=torch.bfloat16, kv_cache=None, eos_id=None)
    cfg = gen.config
    S, T, hd = 4, 16, cfg.d_model // cfg.n_heads
    rng = np.random.default_rng(5)
    pool = torch.from_numpy(rng.normal(size=(S, cfg.n_layers, T, cfg.n_heads, hd)).astype(np.float32))
    tok = torch.from_numpy(rng.integers(1, 512, size=(S, 1)))
    pos = torch.tensor([[3], [0], [7], [15]])

    def run():
        k, v = pool.to(torch.bfloat16), (pool * 0.5).to(torch.bfloat16)
        return transformer.kv_forward(gen.module, tok, pos, k, v, pos[:, 0], pos, layers=layers)

    calls = []
    real = transformer.add_layer_norm_rows

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(transformer, "add_layer_norm_rows", counted)
    fused, k_f, v_f = run()
    n = cfg.n_layers if layers is None else layers
    assert len(calls) == 2 * n + 1

    def unfused(x, delta, w, b, out_dtype):
        s = x + delta
        return s, layer_norm_reference(s, w, b, out_dtype)

    monkeypatch.setattr(transformer, "add_layer_norm_rows", unfused)
    want, k_w, v_w = run()
    assert torch.equal(fused, want) and torch.equal(k_f, k_w) and torch.equal(v_f, v_w)
