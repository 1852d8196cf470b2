"""Port parity: the generator decode tier of ``pathway_tpu_torch`` (the
KV and slot twins, ``ops/kv_quant.py``, ``TextGenerator``, the prefix
cache keys, ``ContinuousDecoder``) against the JAX package, at the size
of the reference's decode tests (d 32, 2 layers, 4 heads, max_len 64,
vocab 512), on the reference's own parameters through
``generator_params_from_flax``.

Tolerances: hidden states and K/V buffers at atol 1e-5 in f32 (same
math, other summation order); int8 scales at 1e-6 relative; quantized
values bit-equal on the same f32 inputs.  Tokens are compared exactly
in f32, greedy and sampled (the port's threefry chains are the
reference's bit for bit).  In bf16 the trunks agree only at 3e-2, so
the bf16 test compares token by token up to the first divergence and
fails only if the reference's top-2 logit margin there exceeds 2 x 3e-2.
The int8 engine is compared with live reference output, never with
``tests/goldens/int8_decode.json``."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.cache import PrefixKVCache as RefPrefix
from pathway_tpu.cache.keys import block_chain_keys as ref_block_chain_keys
from pathway_tpu.models.generator import TextGenerator as RefGen
from pathway_tpu.models.transformer import KVTransformerDecoder as RefKV
from pathway_tpu.models.transformer import SlotKVDecoder as RefSlot
from pathway_tpu.ops import kv_quant as ref_kv_quant
from pathway_tpu.serve import ContinuousDecoder as RefDecoder
from pathway_tpu_torch.cache import PrefixKVCache, block_chain_keys
from pathway_tpu_torch.models.generator import TextGenerator
from pathway_tpu_torch.models.params import generator_params_from_flax
from pathway_tpu_torch.models.transformer import KVTransformerDecoder, SlotKVDecoder
from pathway_tpu_torch.ops import kv_quant
from pathway_tpu_torch.serve import ContinuousDecoder

_CFG = dict(dimension=32, n_layers=2, n_heads=4, max_length=64, vocab_size=512)
PROMPTS = [
    "hello world",
    "the quick brown fox jumps over",
    "alpha beta gamma delta",
    "continuous batching decode engine",
    "one more prompt to decode",
    "short",
    "retrieval augmented generation serving",
    "slot pool join leave",
]
_SHARED = (
    "system prompt answer strictly from the retrieved context "
    "chunk one about dataflow chunk two about serving "
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dtype="f32", **kw):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    args = dict(_CFG, eos_id=None)
    args.update(kw)
    ref_cache = args.pop("ref_cache", None)
    port_cache = args.pop("port_cache", None)
    ref = RefGen(**args, dtype=jdt, kv_cache=ref_cache)
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    port = TextGenerator(**args, dtype=tdt, kv_cache=port_cache, device="cpu", params=tree)
    return ref, port, tree


@pytest.fixture(scope="module")
def pair32():
    return _pair()


def _ids(rendered):
    return [int(t.strip("<>")) for t in str(rendered).split()]


# -- parameters, scales, twins ---------------------------------------------------


def test_generator_bridge_is_the_trunk_tree(pair32):
    ref, port, tree = pair32
    sd = generator_params_from_flax(tree, port.config)
    for k, v in port.module.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(ValueError):
        generator_params_from_flax({**tree, "head_out": {}}, port.config)


def test_kv_pool_scales_and_quantize_match_reference(pair32):
    ref, port, _ = pair32
    rk, rv = (np.array(s) for s in ref.kv_pool_scales())
    pk, pv = (s.numpy() for s in port.kv_pool_scales())
    assert pk.shape == rk.shape == (2, 4, 8)
    np.testing.assert_allclose(pk, rk, rtol=1e-6, atol=0)
    np.testing.assert_allclose(pv, rv, rtol=1e-6, atol=0)
    x = (np.random.default_rng(0).normal(size=(3, 2, 16, 4, 8)) * 0.05).astype(np.float32)
    x[0, 0, 0, 0, :4] = [1e3, -1e3, 0.5 * rk[0, 0, 0], -1.5 * rk[0, 0, 1]]  # clip and ties
    want = np.asarray(ref_kv_quant.quantize_kv(jnp.asarray(x), jnp.asarray(rk)))
    got = kv_quant.quantize_kv(torch.from_numpy(x), torch.from_numpy(rk)).numpy()
    assert got.dtype == np.int8 and (got == want).all()
    back = kv_quant.dequantize_kv(torch.from_numpy(got), torch.from_numpy(rk)).numpy()
    assert (back == np.asarray(ref_kv_quant.dequantize_kv(jnp.asarray(want), jnp.asarray(rk)))).all()
    # idempotent: what the int8 warm join relies on
    assert (kv_quant.quantize_kv(torch.from_numpy(back), torch.from_numpy(rk)).numpy() == got).all()


def _twin_inputs(B, T, L_pre, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 512, size=(B, L_pre)).astype(np.int32)
    pos = np.broadcast_to(np.arange(L_pre, dtype=np.int32)[None], (B, L_pre)).copy()
    return ids, pos


@pytest.mark.parametrize("quant", [False, True])
def test_kv_twin_matches_reference(pair32, quant):
    ref, port, tree = pair32
    cfg = port.config
    B, T, L_pre = 3, 24, 10
    ids, pos = _twin_inputs(B, T, L_pre)
    rmod = RefKV(ref.config, quant=quant)
    tmod = KVTransformerDecoder(cfg, quant=quant)
    tmod.load_state_dict(generator_params_from_flax(tree, cfg))
    jdt = jnp.int8 if quant else jnp.float32
    tdt = torch.int8 if quant else torch.float32
    rk = jnp.zeros((B, 2, T, 4, 8), jdt)
    rv = jnp.zeros_like(rk)
    tk = torch.zeros((B, 2, T, 4, 8), dtype=tdt)
    tv = torch.zeros_like(tk)
    rsc = ref.kv_pool_scales() if quant else (None, None)
    tsc = port.kv_pool_scales() if quant else (None, None)
    wp = np.zeros(B, np.int32)
    # prefill, then two single-token steps at per-row positions
    steps = [(ids, pos, wp, pos)]
    p1 = np.array([L_pre, L_pre, 4], np.int32)
    steps.append((ids[:, :1] + 1, p1[:, None], p1, p1[:, None]))
    steps.append((ids[:, 1:2] + 2, (p1 + 1)[:, None], p1 + 1, (p1 + 1)[:, None]))
    for x, positions, write_pos, q_pos in steps:
        rh, rk, rv = rmod.apply(
            {"params": ref.params}, jnp.asarray(x), jnp.asarray(positions), rk, rv,
            jnp.asarray(write_pos), jnp.asarray(q_pos), *rsc,
        )
        with torch.no_grad():
            th, tk, tv = tmod(
                torch.from_numpy(x.astype(np.int64)), torch.from_numpy(positions.astype(np.int64)), tk, tv,
                torch.from_numpy(write_pos.astype(np.int64)), torch.from_numpy(q_pos.astype(np.int64)), *tsc,
            )
        np.testing.assert_allclose(th.numpy(), np.asarray(rh), atol=1e-5, rtol=0)
        if quant:
            # quantization of values 1e-7 apart may round one step apart
            assert np.abs(tk.numpy().astype(int) - np.asarray(rk).astype(int)).max() <= 1
            assert (tk.numpy() != np.asarray(rk)).mean() < 1e-3
        else:
            np.testing.assert_allclose(tk.numpy(), np.asarray(rk), atol=1e-5, rtol=0)
            np.testing.assert_allclose(tv.numpy(), np.asarray(rv), atol=1e-5, rtol=0)


@pytest.mark.parametrize("layers", [None, 1])
def test_slot_twin_matches_reference_and_freezes_inactive_lanes(pair32, layers):
    ref, port, tree = pair32
    cfg = port.config
    S, T = 4, 20
    D = 2 if layers is None else layers
    rng = np.random.default_rng(5)
    pool = rng.normal(size=(S, D, T, 4, 8)).astype(np.float32)
    rmod = RefSlot(ref.config, layers=layers)
    tmod = SlotKVDecoder(cfg, layers=layers)
    tmod.load_state_dict(generator_params_from_flax(tree, cfg))
    tok = rng.integers(3, 512, size=(S, 1))
    pos = np.array([3, 7, 0, 12])
    active = np.array([True, False, True, True])
    rh, rk, rv = rmod.apply(
        {"params": ref.params}, jnp.asarray(tok, jnp.int32), jnp.asarray(pos[:, None], jnp.int32),
        jnp.asarray(pool), jnp.asarray(pool), jnp.asarray(pos, jnp.int32), jnp.asarray(pos[:, None], jnp.int32),
        jnp.asarray(active),
    )
    tk, tv = torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy())
    with torch.no_grad():
        th, tk, tv = tmod(
            torch.from_numpy(tok), torch.from_numpy(pos[:, None]), tk, tv, torch.from_numpy(pos),
            torch.from_numpy(pos[:, None]), torch.from_numpy(active),
        )
    np.testing.assert_allclose(th.numpy()[active], np.asarray(rh)[active], atol=1e-5, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(rk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), atol=1e-5, rtol=0)
    assert (tk.numpy()[1] == pool[1]).all() and (tv.numpy()[1] == pool[1]).all()  # bit-frozen


def test_slot_twin_clamps_the_write_window_at_the_pool_end(pair32):
    """A verify of k positions from pos = T - 2 writes the window the
    reference's ``dynamic_update_slice`` clamps to, [T - k, T)."""
    ref, port, tree = pair32
    cfg = port.config
    S, T, k = 2, 16, 4
    rng = np.random.default_rng(9)
    pool = rng.normal(size=(S, 2, T, 4, 8)).astype(np.float32)
    toks = rng.integers(3, 512, size=(S, k))
    pos = np.array([T - 2, 5])
    positions = np.minimum(pos[:, None] + np.arange(k)[None], 63)
    active = np.array([True, True])
    rh, rk, rv = RefSlot(ref.config).apply(
        {"params": ref.params}, jnp.asarray(toks, jnp.int32), jnp.asarray(positions, jnp.int32),
        jnp.asarray(pool), jnp.asarray(pool), jnp.asarray(pos, jnp.int32), jnp.asarray(positions, jnp.int32),
        jnp.asarray(active),
    )
    tmod = SlotKVDecoder(cfg)
    tmod.load_state_dict(generator_params_from_flax(tree, cfg))
    with torch.no_grad():
        th, tk, tv = tmod(
            torch.from_numpy(toks), torch.from_numpy(positions), torch.from_numpy(pool.copy()),
            torch.from_numpy(pool.copy()), torch.from_numpy(pos), torch.from_numpy(positions), torch.from_numpy(active),
        )
    np.testing.assert_allclose(tk.numpy(), np.asarray(rk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), atol=1e-5, rtol=0)
    # the clamped lane rewrote [T - k, T) and left [0, T - k) alone
    assert (tk.numpy()[0, :, : T - k] == pool[0, :, : T - k]).all()
    assert not (tk.numpy()[0, :, T - k :] == pool[0, :, T - k :]).all()


# -- solo decode paths ------------------------------------------------------------


@pytest.mark.parametrize("use_kv", [True, False])
@pytest.mark.parametrize("temperature,seeds", [(0.0, (0,)), (0.7, (0, 3, 11)), (1.3, (0, 3, 11))])
def test_generate_tokens_match_reference(pair32, use_kv, temperature, seeds):
    ref, port, _ = pair32
    for seed in seeds:
        want = ref.generate(PROMPTS[:5], max_new_tokens=9, temperature=temperature, seed=seed, use_kv=use_kv)
        got = port.generate(PROMPTS[:5], max_new_tokens=9, temperature=temperature, seed=seed, use_kv=use_kv)
        assert got == want, (use_kv, temperature, seed)


@pytest.mark.parametrize("use_kv", [True, False])
def test_eos_decode_matches_reference(pair32, use_kv, monkeypatch):
    monkeypatch.setenv("PATHWAY_DECODE_STEP_BUCKET", "4")
    ref, port, _ = pair32
    base = ref.generate(PROMPTS[:2], max_new_tokens=16, use_kv=False)
    eos = _ids(base[0])[2]
    for temperature in (0.0, 0.9):
        want = ref.generate(PROMPTS[:2], max_new_tokens=16, use_kv=use_kv, eos_id=eos, temperature=temperature)
        got = port.generate(PROMPTS[:2], max_new_tokens=16, use_kv=use_kv, eos_id=eos, temperature=temperature)
        assert got == want
        assert port.last_decode_steps == ref.last_decode_steps


def test_prefix_warm_and_cold_match_reference():
    rkv, pkv = RefPrefix(block=8), PrefixKVCache(block=8)
    ref, port, _ = _pair(max_length=96, ref_cache=rkv, port_cache=pkv)
    p1 = _SHARED + "what is incremental computation"
    p2 = _SHARED + "how does the scheduler coalesce"
    cold = [g.generate([p2], max_new_tokens=6, temperature=0.8, seed=4)[0] for g in (ref, port)]
    for kv in (rkv, pkv):
        kv.clear()
        kv.stats_tokens.update(reused=0, computed=0)
    for g in (ref, port):
        g.generate([p1], max_new_tokens=6)
    warm = [g.generate([p2], max_new_tokens=6, temperature=0.8, seed=4)[0] for g in (ref, port)]
    assert cold[1] == cold[0] and warm[1] == warm[0] and warm[1] == cold[1]
    assert pkv.stats_tokens == rkv.stats_tokens and pkv.stats_tokens["reused"] > 0
    assert len(pkv) == len(rkv)
    # both caches hold the same blocks under the same keys, within f32 noise
    ids, mask = port.tokenizer.encode_batch([p2], max_length=90)
    rm, pm = rkv.match(ids[0], int(mask.sum())), pkv.match(ids[0], int(mask.sum()))
    assert rm[0] == pm[0] > 0 and rm[2] == pm[2]
    for (rk, rv), (pk, pv) in zip(rm[1], pm[1]):
        np.testing.assert_allclose(pk.numpy(), np.asarray(rk), atol=1e-5, rtol=0)
        np.testing.assert_allclose(pv.numpy(), np.asarray(rv), atol=1e-5, rtol=0)


def test_block_chain_keys_byte_equal():
    rng = np.random.default_rng(3)
    for n_blocks, block in ((0, 8), (1, 8), (5, 16), (3, 32)):
        row = rng.integers(0, 32768, size=n_blocks * block + 5).astype(np.int32)
        assert block_chain_keys(row, n_blocks, block) == ref_block_chain_keys(row, n_blocks, block)
    r, p = RefPrefix(block=16), PrefixKVCache(block=16)
    for n in range(0, 200, 7):
        assert p.cacheable_blocks(n) == r.cacheable_blocks(n)
        assert p.bucket_tokens(n) == r.bucket_tokens(n)


# -- the engine -------------------------------------------------------------------


@pytest.mark.parametrize("spec_k,kv_quant", [(0, "bf16"), (3, "bf16"), (4, "bf16"), (0, "int8"), (3, "int8")])
def test_engine_matches_reference(pair32, spec_k, kv_quant):
    ref, port, _ = pair32
    cases = [(p, 0.0 if i % 2 == 0 else 0.7 + 0.1 * (i % 3), i) for i, p in enumerate(PROMPTS)]
    outs = []
    for gen, cls in ((ref, RefDecoder), (port, ContinuousDecoder)):
        eng = cls(gen, slots=3, step_bucket=4, spec_k=spec_k, kv_quant=kv_quant)
        try:
            tickets = []
            for i, (p, temp, seed) in enumerate(cases):
                tickets.append(eng.submit(p, max_new_tokens=8, temperature=temp, seed=seed))
                if i in (2, 5):
                    time.sleep(0.02)  # staggered joins
            outs.append([str(t()) for t in tickets])
        finally:
            eng.stop()
        if spec_k:
            assert eng.pool_stats["spec_rounds"] > 0 and eng.pool_stats["spec_fallbacks"] == 0
    assert outs[1] == outs[0]
    if kv_quant == "bf16":  # an f32 pool: every request is its solo generate
        solo = [port.generate([p], max_new_tokens=8, temperature=t, seed=s)[0] for p, t, s in cases]
        assert outs[1] == solo


def test_engine_eos_and_prefix_match_reference():
    rkv, pkv = RefPrefix(block=8), PrefixKVCache(block=8)
    ref, port, _ = _pair(max_length=96, ref_cache=rkv, port_cache=pkv)
    eos = _ids(ref.generate(["hello world"], max_new_tokens=8)[0])[1]
    rkv.clear()
    rkv.stats_tokens.update(reused=0, computed=0)
    seq = [_SHARED + "what is incremental computation", "hello world", _SHARED + "how does the scheduler coalesce"]
    outs = []
    for gen, cls in ((ref, RefDecoder), (port, ContinuousDecoder)):
        eng = cls(gen, slots=1, step_bucket=4, spec_k=3)
        try:
            outs.append([str(eng.submit(p, max_new_tokens=8, eos_id=eos)()) for p in seq])
        finally:
            eng.stop()
    assert outs[1] == outs[0]
    assert pkv.stats_tokens == rkv.stats_tokens and pkv.stats_tokens["reused"] > 0


def test_shape_census_matches_reference():
    """The bucketing contract: the port's engine and solo KV decode use
    the reference's shapes (join batch a power of 4, suffix 16 * 2^n,
    prefix split a power-of-two block multiple), one step shape per
    engine, over prompts with and without a cached shared prefix."""
    ref, port, _ = _pair(max_length=128, ref_cache=RefPrefix(block=8), port_cache=PrefixKVCache(block=8))
    prompts = PROMPTS + [_SHARED * 2 + f"question {i}" for i in range(4)] + [_SHARED + "tail"]
    keys = []
    for gen, cls in ((ref, RefDecoder), (port, ContinuousDecoder)):
        gen._fns.clear()
        eng = cls(gen, slots=2, step_bucket=4)
        try:
            for i, p in enumerate(prompts):
                eng.submit(p, max_new_tokens=3 + (i % 3))()
        finally:
            eng.stop()
        gen.generate(prompts[8:11], max_new_tokens=4)
        keys.append({k for k in gen._fns if isinstance(k, tuple) and str(k[0]) in ("kv", "slot_step", "slot_prefill")})
    assert keys[1] == keys[0]
    assert len([k for k in keys[1] if k[0] == "slot_step"]) == 1
    prefixes = set()
    for _, _S, _T, B, L_sfx, P in (k for k in keys[1] if k[0] == "slot_prefill"):
        assert (B & (B - 1)) == 0 and L_sfx % 16 == 0 and (P == 0 or (P & (P - 1)) == 0)
        prefixes.add(P)
    assert len(prefixes) > 1  # the prefix split took more than one bucket


# -- bf16: the margin rule --------------------------------------------------------


def test_bf16_tokens_follow_reference_up_to_a_near_tie():
    ref, port, _ = _pair("bf16")
    emb = jnp.asarray(ref.params["tok_embed"]["embedding"], jnp.float32)
    checked = 0
    for p in PROMPTS:
        want = _ids(ref.generate([p], max_new_tokens=12)[0])
        got = _ids(port.generate([p], max_new_tokens=12)[0])
        if got == want:
            checked += len(want)
            continue
        j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        # the reference's top-2 margin where the two first diverge
        ids, mask = ref.tokenizer.encode_batch([p], max_length=64 - 12)
        n = int(mask.sum())
        seq = np.concatenate([ids[0, :n], np.asarray(want[:j], np.int32)])[None]
        hidden = ref.module.apply({"params": ref.params}, jnp.asarray(seq), jnp.ones_like(jnp.asarray(seq)))
        logits = np.asarray(hidden[0, -1].astype(jnp.float32) @ emb.T)
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] <= 2 * 3e-2, (p, j, top2)
        checked += j
    assert checked > 0
