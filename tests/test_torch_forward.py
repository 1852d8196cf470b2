"""Port parity of the late-interaction tier on the CPU: the token-state
export, the forward index (pool + int8 quantization, ingest bookkeeping,
gather) and MaxSim of ``pathway_tpu_torch`` against ``pathway_tpu``, on
the same seeded inputs and the same encoder weights (bridge).

Tolerances: f32 atol 1e-5 (bf16 3e-2) for token states; fed the SAME
token states, the pool gives equal int8 rows, ``nvalid`` and slots, with
scales within 1e-6; MaxSim scores within 1e-5 and permutations equal
integer for integer (ties keep the lower candidate index in both).
Through the two encoders the token states differ in the last f32 bits,
so a stored int8 entry may sit one quantization step apart where the
scaled value falls on a rounding boundary: at most 1 in 1,000 entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.index import ForwardIndex as RefForward
from pathway_tpu.models.encoder import SentenceEncoder as RefEncoder
from pathway_tpu.ops.knn import DeviceKnnIndex as RefKnn
from pathway_tpu.ops.maxsim import build_maxsim_kernel, maxsim_scores_host as ref_scores_host
from pathway_tpu.ops.serving import FusedEncodeSearch as RefServe
from pathway_tpu_torch.index import ForwardIndex, ForwardUnavailable
from pathway_tpu_torch.index.forward import audit_quant_error, pool_token_states
from pathway_tpu_torch.models.encoder import SentenceEncoder
from pathway_tpu_torch.ops.knn import DeviceKnnIndex
from pathway_tpu_torch.ops.maxsim import maxsim_scores_host, maxsim_topk
from pathway_tpu_torch.ops.serving import FusedEncodeSearch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ENC = dict(dimension=32, n_layers=2, n_heads=4, max_length=32, vocab_size=512)
T_DOC = 8
_WORDS = (
    "stream join window index vector query tensor kernel shard replica commit "
    "offset snapshot schema tokenizer encoder cluster probe slab rescore"
).split()


def corpus(n, seed=0, lo=1, hi=28):
    """Documents of lo..hi words: some shorter than T_DOC tokens, some
    cut at max_length."""
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(_WORDS, size=int(rng.integers(lo, hi)))) + f" d{i}" for i in range(n)]


def encoders(dtype="f32"):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = RefEncoder(dtype=jdt, **ENC)
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    return ref, SentenceEncoder(dtype=tdt, device="cpu", params=tree, **ENC)


@pytest.fixture(scope="module")
def pair():
    return encoders()


@pytest.mark.parametrize("dtype,atol", [("f32", 1e-5), ("bf16", 3e-2)])
def test_token_states_match_reference(dtype, atol):
    ref, port = encoders(dtype)
    texts = corpus(6) + [""]
    want, want_mask, want_n = ref.encode_token_states(texts)
    got, mask, n = port.encode_token_states(texts)
    assert n == want_n == 7 and got.shape == want.shape == (16, ENC["max_length"], 32)
    np.testing.assert_array_equal(mask, np.asarray(want_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=atol)


def test_query_export_matches_reference_and_keeps_z(pair):
    """The stage-1 handle carries the reference's query token states
    (device) and mask (host); within the port the embedding is
    bit-identical with the export on and off, and so are the results."""
    ref_enc, enc = pair
    docs = corpus(60, seed=1)
    keys = list(range(100, 160))
    vecs = ref_enc.encode(docs)
    ref_index = RefKnn(32, initial_capacity=64)
    ref_index.add(keys, vecs)
    index = DeviceKnnIndex(32, initial_capacity=64, device="cpu")
    index.add(keys, vecs)
    queries = docs[:5]
    want = RefServe(ref_enc, ref_index, k=6, export_query_tokens=True, embed_cache=None).submit(queries)
    on = FusedEncodeSearch(enc, index, k=6, export_query_tokens=True)
    off = FusedEncodeSearch(enc, index, k=6)
    got = on.submit(queries)
    assert got.n_queries == 5 and off.submit(queries).query_tokens is None
    np.testing.assert_array_equal(got.query_mask, np.asarray(want.query_mask))
    np.testing.assert_allclose(got.query_tokens.numpy(), np.asarray(want.query_tokens), atol=1e-5)
    ids, mask = enc.tokenizer.encode_batch(queries)
    z_on, qtok = on._embed(ids, mask)
    z_off, none = off._embed(ids, mask)
    assert none is None and torch.equal(z_on, z_off)
    assert got() == off(queries) and [r[0][0] for r in got()] == keys[:5]


@pytest.mark.parametrize("quant", [True, False])
def test_pool_matches_reference_on_identical_token_states(pair, quant):
    ref_enc, _ = pair
    fwd = RefForward(ref_enc, tokens_per_doc=T_DOC, quant="int8" if quant else "none")
    tok, mask, _ = ref_enc.encode_token_states(corpus(13, seed=2))
    want = [np.asarray(a) for a in fwd._pool_fn(tok.shape[0], tok.shape[1])(tok, jnp.asarray(mask))]
    got = [a.numpy() for a in pool_token_states(torch.from_numpy(np.asarray(tok)), torch.from_numpy(mask), T_DOC, quant)]
    q, scales, nvalid, pooled = got
    assert q.dtype == (np.int8 if quant else np.float32)
    if quant:
        np.testing.assert_array_equal(q, want[0])
    else:
        np.testing.assert_allclose(q, want[0], atol=1e-6)
    np.testing.assert_allclose(scales, want[1], atol=1e-6)
    np.testing.assert_array_equal(nvalid, want[2])
    np.testing.assert_allclose(pooled, want[3], atol=1e-6)
    assert set(nvalid.tolist()) >= {2, T_DOC}  # short (empty pad docs) and full docs
    if quant:
        want_err = float(fwd._audit_fn(tok.shape[0])(*[jnp.asarray(a) for a in (want[3], want[0], want[1], want[2])]))
        got_err = float(audit_quant_error(*[torch.from_numpy(a) for a in (pooled, q, scales, nvalid)], quant=True))
        assert abs(got_err - want_err) <= 1e-6 and got_err > 0


def _maxsim_case(B=5, Lq=12, Kc=9, N=20, T=T_DOC, d=16, seed=3):
    """Query tokens with pad tokens (one query all pad), int8 rows with
    scales, nvalid with zeros, slot tables with -1 entries."""
    rng = np.random.default_rng(seed)
    qtok = rng.normal(size=(B, Lq, d)).astype(np.float32)
    qmask = (np.arange(Lq)[None, :] < rng.integers(1, Lq + 1, size=(B, 1))).astype(np.float32)
    qmask[-1] = 0.0
    tok = rng.integers(-127, 128, size=(N, T, d)).astype(np.int8)
    scales = rng.uniform(0.001, 0.01, size=(N, d)).astype(np.float32)
    nvalid = rng.integers(0, T + 1, size=N).astype(np.int32)
    nvalid[:3] = 0
    slots = rng.integers(0, N, size=(B, Kc)).astype(np.int32)
    slots[rng.random((B, Kc)) < 0.25] = -1
    slots[0, :3] = [0, 1, 2]  # candidates with no valid row
    return qtok, qmask, tok, scales, nvalid, slots


@pytest.mark.parametrize("quant", [True, False])
def test_maxsim_topk_matches_reference(quant):
    qtok, qmask, tok, scales, nvalid, slots = _maxsim_case()
    if not quant:
        tok = (tok.astype(np.float32) * scales[:, None, :]).astype(np.float32)
    B, Lq, _ = qtok.shape
    Kc, k_out = slots.shape[1], 6
    want = np.asarray(
        build_maxsim_kernel(B, Lq, Kc, T_DOC, k_out, quant)(*[jnp.asarray(a) for a in (qtok, qmask, tok, scales, nvalid, slots)])
    )
    got = maxsim_topk(*[torch.from_numpy(a) for a in (qtok, qmask, tok, scales, nvalid, slots)], k_out, quant).numpy()
    np.testing.assert_array_equal(got[:, k_out:], want[:, k_out:])  # permutations
    gs, ws = got[:, :k_out].view(np.float32), want[:, :k_out].view(np.float32)
    assert (np.isneginf(gs) == np.isneginf(ws)).all() and np.isneginf(gs).any()
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], atol=1e-5)
    np.testing.assert_array_equal(gs[-1][np.isfinite(gs[-1])], 0.0)  # an all-pad query sums to 0
    deq = tok.astype(np.float32) * scales[:, None, :] if quant else tok
    for b in range(B):
        live = slots[b] >= 0
        host = np.full(Kc, -np.inf, np.float32)
        host[live] = maxsim_scores_host(qtok[b], qmask[b], deq[slots[b][live]], nvalid[slots[b][live]])
        np.testing.assert_allclose(host[live], ref_scores_host(qtok[b], qmask[b], deq[slots[b][live]], nvalid[slots[b][live]]), atol=1e-6)
        if not qmask[b].any():
            continue  # an all-pad query: the kernel sums to 0, the host oracle says -inf
        perm = got[b, k_out:]
        top = gs[b]
        np.testing.assert_allclose(top[np.isfinite(top)], host[perm][np.isfinite(top)], atol=1e-4)


def _assert_same_forward(port, ref):
    """Slots, free list, versions and bookkeeping equal; rows equal but
    for rare one-step int8 rounding (see module docstring)."""
    assert port._slot_of_key == ref._slot_of_key
    assert port._free == ref._free and port._next_slot == ref._next_slot
    assert port._key_version == ref._key_version and port._capacity == ref._capacity
    np.testing.assert_array_equal(port._nvalid_host, ref._nvalid_host)
    np.testing.assert_array_equal(port._ntok_by_slot, ref._ntok_by_slot)
    np.testing.assert_array_equal(port._nvalid.numpy(), np.asarray(ref._nvalid))
    assert (port._tokens_stored, port._raw_tokens_live) == (ref._tokens_stored, ref._raw_tokens_live)
    live = sorted(ref._slot_of_key.values())
    if port.quant == "int8":
        a = port._tok.numpy()[live].astype(np.int32)
        b = np.asarray(ref._tok)[live].astype(np.int32)
        assert np.abs(a - b).max() <= 1 and (a != b).mean() <= 1e-3
    else:
        np.testing.assert_allclose(port._tok.numpy()[live], np.asarray(ref._tok)[live], atol=1e-5)
    np.testing.assert_allclose(port._scales.numpy()[live], np.asarray(ref._scales)[live], atol=1e-6)
    assert port.hbm_bytes() == ref.hbm_bytes()
    assert abs(port.compression_ratio() - ref.compression_ratio()) < 1e-12


@pytest.mark.parametrize("quant", ["int8", "none"])
def test_forward_index_ingest_matches_reference(pair, quant):
    """Adds with growth past the initial capacity, an upsert, a key twice
    in one batch, removals and slot reuse: equal to the reference."""
    ref_enc, enc = pair
    ref = RefForward(ref_enc, tokens_per_doc=T_DOC, quant=quant, initial_capacity=64)
    port = ForwardIndex(enc, tokens_per_doc=T_DOC, quant=quant, initial_capacity=64)
    docs = corpus(110, seed=4)
    for ix in (ref, port):
        assert ix.add(range(70), docs[:70]) == 70
        assert ix.add([5, 200, 201, 200], ["upserted text", "a", "b", "dup twice"]) == 4
        ix.remove([1, 2, 3, 999])
        assert ix.add(range(70, 110), docs[70:]) == 40  # reuses freed slots, grows to 128
    assert len(port) == len(ref) == 109 and 200 in port and 2 not in port
    _assert_same_forward(port, ref)


def test_gather_matches_reference_with_missing_and_width(pair):
    """Both packages serve from the reference's stored rows (loaded from
    its warm state): equal permutations and missing positions, scores
    within 1e-5; the candidate grid is pinned to ``width``."""
    ref_enc, enc = pair
    ref = RefForward(ref_enc, tokens_per_doc=T_DOC, initial_capacity=64)
    docs = corpus(40, seed=5)
    ref.add(range(40), docs)
    ref.remove([7])
    port = ForwardIndex(enc, tokens_per_doc=T_DOC)
    port.load_warm_state(ref.warm_state())
    _assert_same_forward(port, ref)
    queries = docs[:3]
    qtok, _, _ = ref_enc.encode_token_states(queries)
    ids, qmask = ref_enc.tokenizer.encode_batch(queries)
    qtok = np.asarray(qtok)[:4, : ids.shape[1]]  # a bucketed stage-1 batch
    qmask = np.concatenate([qmask, np.zeros((1, qmask.shape[1]), qmask.dtype)])
    cands = [[0, 7, 5, 1000, 12], [3, 4], [9, 8, 7, 6, 5, 4, 3]]
    w_done, w_missing = ref.gather_submit(jnp.asarray(qtok), qmask, cands, 4, width=10)
    g_done, g_missing = port.gather_submit(torch.from_numpy(qtok), qmask, cands, 4, width=10)
    assert g_missing == w_missing == [[1, 3], [], [2]]
    (ws, wp), (gs, gp) = w_done(), g_done()
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_allclose(gs, ws, atol=1e-5)
    assert port.stats["gathers"] == 1 and port.stats["gather_missing"] == 3


def test_gather_unavailable_when_nothing_resident(pair):
    _, enc = pair
    port = ForwardIndex(enc, tokens_per_doc=T_DOC)
    qtok = torch.zeros((1, 4, 32))
    with pytest.raises(ForwardUnavailable):
        port.gather_submit(qtok, np.ones((1, 4)), [[1, 2]], 2)
    port.add([1], ["one doc"])
    with pytest.raises(ForwardUnavailable):
        port.gather_submit(qtok, np.ones((1, 4)), [[5, 6]], 2)
    with pytest.raises(ForwardUnavailable):
        port.gather_submit(None, np.ones((1, 4)), [[1]], 2)


def test_warm_state_roundtrips_into_reference(pair):
    ref_enc, enc = pair
    port = ForwardIndex(enc, tokens_per_doc=T_DOC, initial_capacity=64)
    port.add(range(20), corpus(20, seed=6))
    port.remove([4])
    ref = RefForward(ref_enc, tokens_per_doc=T_DOC)
    ref.load_warm_state(port.warm_state())
    assert ref._slot_of_key == port._slot_of_key and ref.generation == port.generation
    np.testing.assert_array_equal(np.asarray(ref._tok), port._tok.numpy())
