"""Port tests that need an NVIDIA GPU and nvcc: the CUDA rescore kernels
against their plain version, the IVF serve path through them, an absorb
and a background retrain on the card, the forward-index gather (against
the NumPy MaxSim, and without a device-to-host sync), the packed
cross-encoder against the unpacked one, and the decode path's row
kernels (readout row invariance at every row count, the fused residual
add + LayerNorm equal to the two steps), the profiler's event-timed
samples on the stream a call launched on, the device-memory
ledger's delta against the allocator's, the real-weights path (HF
BERT embedder and cross-encoder, CLIP) on the card against the CPU, and
the sharded serve tier (8 logical shards against 1 through the rescore
kernel, the mesh-sharded exact index, the sharded forward table), ring
attention against dense, and the encoder over 8 logical shards against
one; and the framework on the card: a batched UDF returning a CUDA tensor
through the engine, and the default ``DocumentStore`` (``TpuKnnFactory``
over ``TpuEmbedder()``) with an IVF store beside it through the kernel;
and one QA answer over the port's REST server equal to the direct calls;
and a persisted pipeline whose rows carry CUDA tensors, snapshotted on the
card and restarted in a process that sees no card; and a windowed
``DataIndex`` whose expired windows leave the IVF on the card; and
``chip_smoke.py``'s async retrieval path (``pw.AsyncTransformer`` over the
serve scheduler) at 1,024 documents.
They skip
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


@pytest.mark.cuda
def test_cuda_ivf_serve_after_a_tail_change_makes_no_host_sync():
    """Live ingest changes the exact tail between serves: the next serve
    uploads it again without a device-to-host sync."""
    dev = _cuda()
    from pathway_tpu_torch.models.encoder import SentenceEncoder
    from pathway_tpu_torch.ops.ivf import IvfKnnIndex
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch

    enc = SentenceEncoder(dimension=64, n_layers=2, n_heads=4, max_length=32, vocab_size=4096)
    docs = [f"document {i} about topic {i % 37} and item {i % 11}" for i in range(1200)]
    ivf = IvfKnnIndex(64, device=dev)
    ivf.build_from_matrix(list(range(1000)), enc.encode_to_device(docs[:1000]).float())
    serve = FusedEncodeSearch(enc, ivf, k=5)
    for i in range(1000, 1200, 100):
        ivf.add(list(range(i, i + 100)), enc.encode(docs[i : i + 100]))
        serve(docs[:4])  # warm every shape and the allocator
    ivf.add([5000], enc.encode(["a fresh tail row"]))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        done = serve.submit(docs[:4])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ivf.stats["tail_cache_misses"] >= 3 and len(done()) == 4


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


def _decode_prompts(n=8):
    shared = "rerank the following passages for the query about incremental dataflow serving "
    return [(shared if i % 2 == 0 else "standalone question about ") + f"topic {i} variant {i}" for i in range(n)]


@pytest.mark.cuda
def test_cuda_decode_rows_match_plain_and_are_row_invariant():
    dev = _cuda()
    from pathway_tpu_torch.ops.decode_rows import (
        layer_norm_reference, layer_norm_rows, tied_readout, tied_readout_reference,
    )

    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.rand(256, generator=g, device=dev) + 0.5
    b = torch.randn(256, generator=g, device=dev) * 0.1
    table = torch.randn(32768, 256, generator=g, device=dev) * 0.02
    for rows in (1, 16, 256, 13):
        x = (torch.randn(rows, 256, generator=g, device=dev) * 3).to(torch.bfloat16)
        got = layer_norm_rows(x, w, b, torch.float32)
        torch.testing.assert_close(got, layer_norm_reference(x, w, b, torch.float32), atol=1e-5, rtol=0)
        assert torch.equal(layer_norm_rows(x[:1], w, b, torch.float32)[0], got[0])
        logits = tied_readout(x, table)
        torch.testing.assert_close(logits, tied_readout_reference(x, table), atol=1e-4, rtol=0)
        assert torch.equal(tied_readout(x[:1], table)[0], logits[0])


@pytest.mark.cuda
@pytest.mark.parametrize("d,V", [(256, 32768), (99, 4099), (1536, 1000)])
def test_cuda_tied_readout_rows_invariant_at_every_row_count(d, V):
    """The tiled readout against its plain version at M = 1 / 13 / 16 /
    32 / 256, f32 and bf16 rows, V not a multiple of the tile, d off the
    16-byte width (99) and at the widest row (1536); the first and the
    last row of every call equal the same row computed alone."""
    dev = _cuda()
    from pathway_tpu_torch.ops.decode_rows import tied_readout, tied_readout_reference

    g = torch.Generator(device=dev).manual_seed(d)
    table = torch.randn(V, d, generator=g, device=dev) * 0.02
    for M in (1, 13, 16, 32, 256):
        for dtype in (torch.bfloat16, torch.float32):
            h = torch.randn(M, d, generator=g, device=dev).to(dtype)
            got = tied_readout(h, table)
            torch.testing.assert_close(got, tied_readout_reference(h, table), atol=1e-4, rtol=0)
            for r in {0, M - 1}:
                assert torch.equal(tied_readout(h[r : r + 1], table)[0], got[r]), (M, dtype, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(16, 1, 256), (16, 32, 256), (3, 5, 99), (2, 1, 1536)])
def test_cuda_add_layer_norm_equals_add_then_layer_norm(dtype, shape):
    dev = _cuda()
    from pathway_tpu_torch.ops.decode_rows import add_layer_norm_rows, layer_norm_reference, layer_norm_rows

    g = torch.Generator(device=dev).manual_seed(sum(shape))
    d = shape[-1]
    x = (torch.randn(*shape, generator=g, device=dev) * 3).to(dtype)
    delta = torch.randn(*shape, generator=g, device=dev).to(dtype)
    w = torch.rand(d, generator=g, device=dev) + 0.5
    b = torch.randn(d, generator=g, device=dev) * 0.1
    for out_dtype in (torch.bfloat16, torch.float32):
        s, y = add_layer_norm_rows(x, delta, w, b, out_dtype)
        assert torch.equal(s, x + delta)
        assert torch.equal(y, layer_norm_rows(x + delta, w, b, out_dtype))
    torch.testing.assert_close(y, layer_norm_reference(s, w, b, torch.float32), atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_cuda_row_wrappers_refuse_strided_tensors():
    dev = _cuda()
    from pathway_tpu_torch.ops.decode_rows import add_layer_norm_rows, layer_norm_rows, tied_readout

    x = torch.randn(16, 512, device=dev)[:, ::2]
    w, b = torch.ones(256, device=dev), torch.zeros(256, device=dev)
    with pytest.raises(ValueError):
        tied_readout(x, torch.randn(64, 256, device=dev))
    with pytest.raises(ValueError):
        layer_norm_rows(x, w, b, torch.float32)
    with pytest.raises(ValueError):
        add_layer_norm_rows(x, x, w, b, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("spec_k", [0, 8])
def test_cuda_engine_requests_equal_solo_generate(spec_k):
    _cuda()
    from pathway_tpu_torch.cache import PrefixKVCache
    from pathway_tpu_torch.models.generator import TextGenerator
    from pathway_tpu_torch.serve import ContinuousDecoder

    gen = TextGenerator(kv_cache=PrefixKVCache(block=16), eos_id=None)
    cases = [(p, 0.0 if i % 2 == 0 else 0.8, i) for i, p in enumerate(_decode_prompts())]
    want = [gen.generate([p], max_new_tokens=24, temperature=t, seed=s)[0] for p, t, s in cases]
    eng = ContinuousDecoder(gen, slots=4, step_bucket=8, kv_width=96, spec_k=spec_k)
    try:
        got = [str(t()) for t in [eng.submit(p, max_new_tokens=24, temperature=t, seed=s) for p, t, s in cases]]
        again = [str(t()) for t in [eng.submit(p, max_new_tokens=24, temperature=t, seed=s) for p, t, s in cases]]
    finally:
        eng.stop()
    assert got == want and again == want


@pytest.mark.cuda
def test_cuda_int8_engine_spec_invariant():
    _cuda()
    from pathway_tpu_torch.models.generator import TextGenerator
    from pathway_tpu_torch.serve import ContinuousDecoder

    gen = TextGenerator(kv_cache=None, eos_id=None)
    outs = []
    for spec_k in (0, 8):
        eng = ContinuousDecoder(gen, slots=8, step_bucket=8, kv_width=96, spec_k=spec_k, kv_quant="int8")
        try:
            outs.append([str(o) for o in eng.generate(_decode_prompts(), max_new_tokens=24)])
        finally:
            eng.stop()
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_cuda_decode_step_loop_makes_no_host_sync():
    _cuda()
    import warnings

    from pathway_tpu_torch.models.generator import TextGenerator
    from pathway_tpu_torch.serve import ContinuousDecoder

    gen = TextGenerator(kv_cache=None, eos_id=None)
    eng = ContinuousDecoder(gen, slots=8, step_bucket=8, kv_width=96, spec_k=8)
    try:
        eng.generate(_decode_prompts(), max_new_tokens=16)  # warm
        torch.cuda.set_sync_debug_mode(1)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                tickets = [eng.submit(p, max_new_tokens=16, temperature=0.5 * (i % 2), seed=i)
                           for i, p in enumerate(_decode_prompts())]
                [t() for t in tickets]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    finally:
        eng.stop()
    assert not [w for w in caught if "synchroniz" in str(w.message).lower()]


@pytest.mark.cuda
def test_cuda_profiler_times_samples_on_the_launching_stream():
    """A sampled call records its event on the stream it launched on (a
    side stream here) and returns at once; the completer books submit ->
    ready, so a 20 ms device sleep shows in the sample and not on the
    calling thread."""
    dev = _cuda()
    from pathway_tpu_torch.observe import profile

    stride0 = profile.sample_stride()
    profile.set_sample(1.0)
    try:
        side = torch.cuda.Stream()
        probe_start, probe_end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            probe_start.record()
            torch.cuda._sleep(20_000_000)
            probe_end.record()
        probe_end.synchronize()
        cycles = int(20_000_000 * 20.0 / probe_start.elapsed_time(probe_end))  # ~20 ms of sleep

        def sleepy():
            torch.cuda._sleep(cycles)
            return torch.empty(1, device=dev)

        fn = profile.wrap("test.cuda_side_stream", sleepy)
        with torch.cuda.stream(side):
            t0 = time.perf_counter()
            fn()
            call_ms = (time.perf_counter() - t0) * 1e3
        assert profile.drain(10.0)
        row = profile.profile_stats()["test.cuda_side_stream"]
        assert row["samples"] == 1
        assert row["device_s"] >= 0.015, row  # the default stream was idle: a wrong stream reads ~0
        assert call_ms < 10.0, call_ms  # no wait on the calling thread
    finally:
        profile.set_sample(1.0 / stride0 if stride0 else 0.0)


@pytest.mark.cuda
def test_cuda_ledger_delta_agrees_with_the_allocator():
    """Building a tracked structure after warm-up moves the ledger and
    ``torch.cuda.memory_allocated`` by the same bytes within 10%."""
    dev = _cuda()
    import gc

    from pathway_tpu_torch.observe import hbm
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex

    DeviceKnnIndex(256, initial_capacity=64, device=dev)
    gc.collect()
    torch.cuda.synchronize()
    ledger0, device0 = hbm.sample()["total_bytes"], hbm.device_bytes()
    index = DeviceKnnIndex(256, initial_capacity=16384, device=dev)
    torch.cuda.synchronize()
    ledger1, device1 = hbm.sample()["total_bytes"], hbm.device_bytes()
    d_ledger, d_device = ledger1 - ledger0, device1 - device0
    assert d_ledger >= 16384 * 256 * 4
    assert abs(d_device - d_ledger) / d_ledger < 0.10, (d_ledger, d_device)
    del index
    gc.collect()
    assert hbm.sample()["total_bytes"] <= ledger0


def _bert_dir(tmp_path, n_labels=None):
    """A seeded MiniLM-shaped BERT (384 wide, 12 heads of 32, 2 layers,
    a 512-token vocab) written with the port's own safetensors writer."""
    from pathway_tpu_torch.models.hf_import import BertConfig, write_bert_checkpoint

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"w{i}" for i in range(507)]
    d = str(tmp_path / ("cross" if n_labels else "bert"))
    write_bert_checkpoint(d, BertConfig(512, 384, 2, 12, 1536, 512), vocab, seed=1, n_labels=n_labels)
    texts = [" ".join(f"w{(7 * i + j) % 507}" for j in range(3 + i % 40)) for i in range(40)]
    return d, texts


@pytest.mark.cuda
def test_cuda_hf_encoder_equals_cpu(tmp_path):
    """The HF trunk on the card, in the checkpoint's f32 with TF32 off:
    equal to the CPU within 1e-4 on the plain and the (fallback) packed
    encode."""
    dev = _cuda()
    from pathway_tpu_torch.models.encoder import SentenceEncoder

    d, texts = _bert_dir(tmp_path)
    cpu = SentenceEncoder(checkpoint_path=d, device="cpu").encode(texts)
    card = SentenceEncoder(checkpoint_path=d, device=dev)
    np.testing.assert_allclose(card.encode(texts), cpu, atol=1e-4, rtol=0)
    np.testing.assert_allclose(card.encode_packed_to_device(texts).cpu().numpy(), cpu, atol=1e-4, rtol=0)
    assert all(p.dtype == torch.float32 and p.device.type == "cuda" for p in card.module.parameters())


@pytest.mark.cuda
def test_cuda_hf_cross_encoder_equals_cpu(tmp_path):
    dev = _cuda()
    from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel

    d, texts = _bert_dir(tmp_path, n_labels=1)
    pairs = [(texts[i], texts[-1 - i]) for i in range(20)]
    cpu = CrossEncoderModel(checkpoint_path=d, device="cpu").predict(pairs)
    np.testing.assert_allclose(CrossEncoderModel(checkpoint_path=d, device=dev).predict(pairs), cpu, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_cuda_clip_equals_cpu():
    """The default ``ClipModel`` (bf16) on the card against the CPU with
    the same seeded weights, within 3e-2."""
    dev = _cuda()
    from pathway_tpu_torch.models.clip import ClipModel

    rng = np.random.default_rng(0)
    images = [rng.random((64, 64, 3)).astype(np.float32) for _ in range(6)] + [rng.random((30, 80)).astype(np.float32)]
    texts = ["a photo of a cat", "stream kernel", ""]
    cpu, card = ClipModel(device="cpu"), ClipModel(device=dev)
    np.testing.assert_allclose(card.encode_image(images), cpu.encode_image(images), atol=3e-2, rtol=0)
    np.testing.assert_allclose(card.encode_text(texts), cpu.encode_text(texts), atol=3e-2, rtol=0)


def _sharded_stack(n_docs=1200):
    from pathway_tpu_torch.models.encoder import SentenceEncoder

    enc = SentenceEncoder(dimension=64, n_layers=2, n_heads=4, max_length=32, vocab_size=4096, dtype=torch.float32)
    docs = [f"document {i} about topic {i % 37} and item {i % 11}" for i in range(n_docs)]
    return enc, docs, enc.encode(docs)


@pytest.mark.cuda
def test_cuda_sharded_serve_equals_one_shard_through_the_kernel():
    """8 logical shards over the visible cards against 1 at full probe:
    bit-identical rows at matched composition, one rescore launch per
    shard per serve, the device merge equal to the host merge, and a
    steady-state submit without a device-to-host sync."""
    dev = _cuda()
    from pathway_tpu_torch.ops.ivf import ShardedIvfIndex
    from pathway_tpu_torch.ops.serving import FusedEncodeSearch
    from pathway_tpu_torch.serve import ServeScheduler

    enc, docs, vecs = _sharded_stack()
    serves = []
    for n in (1, 8):
        idx = ShardedIvfIndex(64, n_shards=n, n_probe=10 ** 6)
        assert all(c.device.type == "cuda" for c in idx.shards)
        idx.add(range(len(docs)), vecs)
        idx.build()
        serves.append(FusedEncodeSearch(enc, idx, k=10))
    queries = docs[:48:3]
    rows = []
    for serve in serves:
        with ServeScheduler(serve, window_us=0) as sched:
            rows.append(list(sched.serve(queries, k=10)))
    assert rows[0] == rows[1]
    before = rescore_shortlist.launches
    device = serves[1](queries)
    assert rescore_shortlist.launches == before + 8
    serves[1].shard_host_merge = True
    assert list(serves[1](queries)) == list(device)
    serves[1].shard_host_merge = False
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        done = serves[1].submit(queries)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert list(done()) == list(device)


@pytest.mark.cuda
def test_cuda_mesh_exact_equals_unsharded():
    """The mesh-sharded exact index (8 row blocks on the card) against the
    unsharded one: scores within 1e-6, keys equal except between scores
    tied within 1e-6 (cuBLAS may order a block's sums otherwise)."""
    dev = _cuda()
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex
    from pathway_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(5000, 64)).astype(np.float32)
    one = DeviceKnnIndex(64, initial_capacity=1024, device=dev)
    mesh = DeviceKnnIndex(64, initial_capacity=1024, mesh=make_mesh(8, 1, devices=[dev] * 8))
    for index in (one, mesh):
        index.add(range(5000), vecs)  # grows past the initial capacity
        index.remove(range(100, 200))
    assert len(mesh) == len(one) == 4900  # slots follow each capacity rounding: compared by key below
    q = rng.normal(size=(16, 64)).astype(np.float32)
    for w, g in zip(one.search(q, 10), mesh.search(q, 10)):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=1e-6)
        for j, ((wk, ws), (gk, _)) in enumerate(zip(w, g)):
            assert wk == gk or any(abs(w[i][1] - ws) <= 1e-6 for i in (j - 1, j + 1) if 0 <= i < len(w))


@pytest.mark.cuda
def test_cuda_sharded_forward_table_equals_unsharded():
    """The sharded forward index's merged table on the card equals one
    unsharded index holding every row, float for float."""
    dev = _cuda()
    from pathway_tpu_torch.index import ForwardIndex, ShardedForwardIndex

    fwd, qtok, qmask, cands = _forward_stack(dev)
    sharded = ShardedForwardIndex(fwd.encoder, n_shards=8, tokens_per_doc=8, initial_capacity=64)
    docs = [f"document {i} about topic {i % 37} and item {i % 11} " + "word " * (i % 19) for i in range(300)]
    sharded.add(range(300), docs)
    one = ForwardIndex(fwd.encoder, tokens_per_doc=8, initial_capacity=64)
    one.add(range(300), docs)
    d8, m8 = sharded.gather_submit(qtok, qmask, cands, 10, width=20)
    d1, m1 = one.gather_submit(qtok, qmask, cands, 10, width=20)
    (s8, p8), (s1, p1) = d8(), d1()
    np.testing.assert_array_equal(s8.view(np.int32), s1.view(np.int32))
    np.testing.assert_array_equal(p8, p1)
    assert m8 == m1


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_cuda_ring_attention_equals_dense(causal, dtype, atol):
    from pathway_tpu_torch.ops.ring_attention import dense_attention, ring_attention_sharded
    from pathway_tpu_torch.parallel.mesh import Mesh

    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(2, 1024, 4, 64, generator=gen, device=dev).to(dtype) for _ in range(3))
    kv_mask = torch.rand(2, 1024, generator=gen, device=dev) > 0.2
    positions = torch.arange(1024, device=dev).expand(2, 1024)
    got = ring_attention_sharded(Mesh([dev] * 8, axis_names=("sp",)), q, k, v, kv_mask, positions, causal=causal)
    assert got.dtype == dtype and got.device.type == "cuda"
    want = dense_attention(q, k, v, kv_mask, positions, causal=causal)
    assert float((got.float() - want).abs().max()) <= atol


@pytest.mark.cuda
def test_cuda_mesh_encoder_equals_unsharded():
    from pathway_tpu_torch.models.encoder import SentenceEncoder
    from pathway_tpu_torch.parallel.mesh import make_mesh

    dev = _cuda()
    kw = dict(dimension=64, n_layers=2, n_heads=4, max_length=32, vocab_size=1024, seed=1, dtype=torch.float32)
    texts = [f"doc {i} " + "stream join window " * (i % 5) for i in range(61)]
    sharded = SentenceEncoder(mesh=make_mesh(8, 1, devices=[dev] * 8), **kw).encode(texts)
    plain = SentenceEncoder(**kw).encode(texts)
    np.testing.assert_allclose(sharded, plain, atol=1e-5)


@pytest.mark.cuda
def test_cuda_batched_udf_tensor_comes_to_host():
    """A batched UDF may return a CUDA tensor: the engine brings it to
    host (``np.asarray`` of a CUDA tensor fails)."""
    dev = _cuda()
    import pathway_tpu_torch as pw

    pw.reset()

    @pw.udf(batched=True)
    def vec(v):
        return torch.ones(len(v), 3, device=dev) * torch.as_tensor(np.asarray(v, np.float32), device=dev)[:, None]

    t = pw.debug.table_from_rows(pw.schema_from_types(x=float), [(float(i),) for i in range(5)])
    out = t.select(y=vec(pw.this.x))
    pw.run()
    _keys, cols = out._materialize()
    assert sorted(c.tolist() for c in cols["y"]) == [[float(i)] * 3 for i in range(5)]
    pw.reset()


@pytest.mark.cuda
def test_cuda_document_store_default_and_ivf_on_the_card():
    """The default store (``TpuKnnFactory(embedder=TpuEmbedder())``) and an
    IVF store at full probe run on the card: each document's own text puts
    it first, the index tensors are on ``cuda``, the IVF store launches the
    rescore kernel, and its answers equal the exact store's."""
    dev = _cuda()
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.operators.external_index import ExternalIndexOperator
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.embedders import TpuEmbedder

    pw.reset()
    rng = np.random.default_rng(0)
    words = "stream join window index vector query tensor kernel shard replica commit".split()
    texts = [" ".join(rng.choice(words, size=12)) + f" doc{i}" for i in range(512)]
    docs = pw.debug.table_from_rows(
        pw.schema_from_types(data=str, _metadata=dict), [(t, {"path": f"{i}.txt"}) for i, t in enumerate(texts)]
    )
    default = DocumentStore(docs)
    emb = TpuEmbedder(dimension=64, n_layers=2, n_heads=4, max_length=32, vocab_size=4096)
    ivf = DocumentStore(docs, retriever_factory=pw.stdlib.indexing.IvfKnnFactory(
        dimension=64, embedder=emb, n_probe=1 << 30), splitter=None)
    exact = DocumentStore(docs, retriever_factory=pw.stdlib.indexing.BruteForceKnnFactory(
        dimension=64, embedder=emb), splitter=None)
    queries = pw.debug.table_from_rows(DocumentStore.RetrieveQuerySchema, [(texts[i], 3, None, None) for i in range(0, 512, 16)])
    outs = [store.retrieve_query(queries) for store in (default, ivf, exact)]
    before = rescore_shortlist.launches
    pw.run()
    assert rescore_shortlist.launches > before
    for op in pw.G.engine_graph.operators:
        if isinstance(op, ExternalIndexOperator):
            index = op.index.inner.index
            tensor = index._slabs if hasattr(index, "_slabs") else index._mats[0]
            assert tensor.device.type == "cuda"
    results = []
    for out in outs:
        keys, cols = out._materialize()
        results.append({int(k): cols["result"][i] for i, k in enumerate(keys)})
    q_keys, q_cols = queries._materialize()
    for i, qk in enumerate(q_keys):
        want = f"{texts.index(q_cols['query'][i])}.txt"
        assert results[0][int(qk)][0]["metadata"]["path"] == want
        assert results[2][int(qk)][0]["metadata"]["path"] == want
        got_ivf = [(r["metadata"]["path"], r["dist"]) for r in results[1][int(qk)]]
        got_exact = [(r["metadata"]["path"], r["dist"]) for r in results[2][int(qk)]]
        assert [p for p, _ in got_ivf] == [p for p, _ in got_exact]
        np.testing.assert_allclose([d for _, d in got_ivf], [d for _, d in got_exact], atol=1e-4)
    pw.reset()


@pytest.mark.cuda
def test_cuda_qa_answer_over_http_equals_the_direct_call():
    """One QA answer over the port's REST server on the card: the context
    docs carry the cross-encoder's own scores, and the response equals
    ``TextGenerator.generate`` of the chat's rendering of the QA prompt,
    greedy, called directly;
    the decode row kernels and the IVF rescore launched."""
    dev = _cuda()
    import json
    import socket
    import threading
    import urllib.request

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.run import terminate
    from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel
    from pathway_tpu_torch.models.generator import TextGenerator
    from pathway_tpu_torch.ops import decode_rows
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.embedders import TpuEmbedder
    from pathway_tpu_torch.xpacks.llm.llms import TpuChat, _messages_to_prompt
    from pathway_tpu_torch.xpacks.llm.prompts import prompt_qa
    from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker

    pw.reset()
    rng = np.random.default_rng(1)
    words = "stream join window index vector query tensor kernel shard replica commit".split()
    texts = [" ".join(rng.choice(words, size=10)) + f" doc{i}" for i in range(256)]
    docs = pw.debug.table_from_rows(
        pw.schema_from_types(data=str, _metadata=dict), [(t, {"path": f"{i}.txt"}) for i, t in enumerate(texts)]
    )
    emb = TpuEmbedder(dimension=64, n_layers=2, n_heads=4, max_length=32, vocab_size=4096)
    store = DocumentStore(docs, retriever_factory=pw.stdlib.indexing.IvfKnnFactory(
        dimension=64, embedder=emb, n_probe=1 << 30), splitter=None)
    ce = CrossEncoderModel(dimension=64, n_layers=2, n_heads=4, max_length=128, vocab_size=4096)
    gen = TextGenerator(dimension=64, n_layers=2, n_heads=4, max_length=256, vocab_size=4096)
    chat = TpuChat(generator=gen, max_new_tokens=8, continuous=True)
    rag = BaseRAGQuestionAnswerer(chat, store, search_topk=3, reranker=CrossEncoderReranker(cross_encoder=ce))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rag.build_server(host="127.0.0.1", port=port)
    thread = rag.run_server(threaded=True)
    before = (rescore_shortlist.launches, decode_rows.tied_readout.launches,
              decode_rows.add_layer_norm_rows.launches)
    try:
        question = texts[7]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/pw_ai_answer",
            data=json.dumps({"prompt": question, "return_context_docs": True}).encode(),
            headers={"Content-Type": "application/json"},
        )
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(req, timeout=120) as resp:
                    got = json.loads(resp.read())
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.2)
    finally:
        terminate()
        thread.join(timeout=60)
        chat._decoder.stop()
    after = (rescore_shortlist.launches, decode_rows.tied_readout.launches, decode_rows.add_layer_norm_rows.launches)
    assert all(a > b for a, b in zip(after, before)), (before, after)
    from pathway_tpu_torch.engine.operators.external_index import ExternalIndexOperator

    index = next(op.index.inner.index for op in pw.G.engine_graph.operators if isinstance(op, ExternalIndexOperator))
    assert index._slabs.device.type == "cuda"
    ctx = [d["text"] for d in got["context_docs"]]
    scores = ce.predict([(question, d) for d in ctx])
    np.testing.assert_allclose(scores, [d["rerank_score"] for d in got["context_docs"]], atol=1e-2)
    assert len(ctx) == 3 and set(ctx) <= set(texts)
    # the chat renders the QA prompt as one user message
    rendered = _messages_to_prompt([{"role": "user", "content": prompt_qa(question, ctx)}])
    assert got["response"] == gen.generate([rendered], max_new_tokens=8)[0]
    pw.reset()


_PERSIST_SCRIPT = """
import os, sys
import numpy as np
import torch
import pathway_tpu_torch as pw

root, expect_cuda = sys.argv[1], sys.argv[2] == "1"
assert torch.cuda.is_available() == expect_cuda
dev = torch.device("cuda" if expect_cuda else "cpu")


class KV(pw.Schema):
    k: str
    v: int


@pw.udf(batched=True)
def emb(v):
    return torch.as_tensor(np.asarray(v, np.float32), device=dev)[:, None] * torch.ones(len(v), 3, device=dev)


t = pw.io.csv.read(os.path.join(root, "in"), schema=KV, mode="static", persistent_id="t")
rows = t.select(pw.this.k, pw.this.v, e=emb(pw.this.v))
counts = rows.groupby(pw.this.k).reduce(k=pw.this.k, n=pw.reducers.count(), total=pw.reducers.sum(pw.this.v))
out = []
pw.io.subscribe(counts, on_change=lambda key, row, time, is_addition: out.append(
    (row["k"], int(row["n"]), int(row["total"]), is_addition)))
pw.run(persistence_config=pw.persistence.Config.simple_config(
    pw.persistence.Backend.filesystem(os.path.join(root, "snap")), snapshot_interval_ms=1,
    persistence_mode=pw.PersistenceMode.OPERATOR_PERSISTING))
print("RESULT", sorted(r for r in out if r[3]))
"""


@pytest.mark.cuda
def test_cuda_snapshot_restores_in_a_process_without_a_card(tmp_path):
    """Rows that carry CUDA tensors (a batched UDF's output) under
    OPERATOR_PERSISTING: the snapshot written on the card holds numpy
    arrays only, and a process that sees no card restores from it and
    folds a new file into the restored state."""
    import os
    import pickle
    import subprocess
    import sys

    _cuda()
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "one.csv").write_text("k,v\na,1\nb,2\na,3\n")
    script = tmp_path / "persist.py"
    script.write_text(_PERSIST_SCRIPT)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    first = subprocess.run([sys.executable, str(script), str(tmp_path), "1"], env=env, capture_output=True,
                           text=True, timeout=300)
    assert first.returncode == 0, first.stderr[-3000:]
    assert "RESULT [('a', 2, 4, True), ('b', 1, 2, True)]" in first.stdout
    for base, _dirs, files in os.walk(tmp_path / "snap"):
        for f in files:
            if os.path.basename(base) in ("operators", "tables"):
                blob = open(os.path.join(base, f), "rb").read()
                assert b"torch" not in blob
                pickle.loads(blob)
    (tmp_path / "in" / "two.csv").write_text("k,v\nb,5\n")
    second = subprocess.run([sys.executable, str(script), str(tmp_path), "0"],
                            env=dict(env, CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True, timeout=300)
    assert second.returncode == 0, second.stderr[-3000:]
    assert "RESULT [('b', 2, 7, True)]" in second.stdout


def windowed_index_run(device=None, hours=8, per_hour=64, dim=32, k=5):
    """A windowed ``DataIndex`` stepped by hand: documents with an event
    time go through ``windowby(tumbling(10), instance=doc,
    common_behavior(cutoff=20, keep_results=False))`` into a full-probe IVF
    index; after each commit (and the tick whose lagged sweep retracts the
    expired windows) 8 queries are answered.  Returns, per commit, the
    index's rows, the alive documents, the answers as [(doc, score)] and
    the exact top-``k`` over the alive documents' vectors; and the IVF."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.executor import Executor
    from pathway_tpu_torch.engine.operators.external_index import ExternalIndexOperator
    from pathway_tpu_torch.engine.operators.io import InputSession, SourceOperator
    from pathway_tpu_torch.internals import dtype as dt
    from pathway_tpu_torch.internals.keys import ref_scalar
    from pathway_tpu_torch.internals.table import Table
    from pathway_tpu_torch.internals.universe import Universe

    pw.reset()
    vecs = np.random.default_rng(5).standard_normal((hours * per_hour, dim)).astype(np.float32)
    queries = np.random.default_rng(6).standard_normal((hours * 8, dim)).astype(np.float32)

    def stream(**types):
        dtypes = {name: dt.wrap(t) for name, t in types.items()}
        session = InputSession()
        et = pw.G.engine_graph.add_table(list(types), "stream")
        pw.G.engine_graph.add_operator(SourceOperator(et, session, dtypes, name="stream"))
        return Table(et, dtypes, Universe(), short_name="stream"), session

    docs, ds = stream(doc=int, t=float, vec=np.ndarray)
    qs, qsess = stream(q=int, qv=np.ndarray)
    alive = pw.temporal.windowby(
        docs, docs.t, window=pw.temporal.tumbling(10.0), instance=pw.this.doc,
        behavior=pw.temporal.common_behavior(cutoff=20.0, keep_results=False),
    ).reduce(doc=pw.this.doc, vec=pw.reducers.any(pw.this.vec))
    index = pw.stdlib.indexing.DataIndex(alive, pw.stdlib.indexing.InnerIndex(
        data_column=alive.vec, dimension=dim,
        factory=pw.stdlib.indexing.IvfKnnFactory(dimension=dim, n_probe=1 << 30, device=device)))
    res = index.query_as_of_now(qs.qv, number_of_matches=k)
    out = res.select(q=qs.q, docs=alive.doc, scores=res.score)
    (op,) = [o for o in pw.G.engine_graph.operators if isinstance(o, ExternalIndexOperator)]
    ivf = op.index.index
    ex = Executor(pw.G.engine_graph)
    pw.G.engine_graph.finalize()
    commits = []
    for h in range(hours):
        for j in range(per_hour):
            i = h * per_hour + j
            ds.insert(int(ref_scalar(i)), (i, h * 10.0 + j * 10.0 / per_hour, vecs[i]))
        ex.step()
        ex.step()  # the time gate's sweep lags one tick
        live = sorted(range(max(0, h - 2) * per_hour, (h + 1) * per_hour))
        rows = len(ivf)
        for b in range(8):
            qsess.insert(int(ref_scalar(("q", h * 8 + b))), (h * 8 + b, queries[h * 8 + b]))
        ex.step()
        _keys, cols = out._materialize()
        got = {int(q): [(int(d), float(s)) for d, s in zip(ds_, ss)]
               for q, ds_, ss in zip(cols["q"], cols["docs"], cols["scores"]) if int(q) // 8 == h}
        mat = vecs[live] / np.linalg.norm(vecs[live], axis=1, keepdims=True)
        qn = queries[h * 8 : h * 8 + 8] / np.linalg.norm(queries[h * 8 : h * 8 + 8], axis=1, keepdims=True)
        sims = qn @ mat.T
        want = {h * 8 + b: [(live[j], float(sims[b, j])) for j in np.argsort(-sims[b], kind="stable")[:k]]
                for b in range(8)}
        commits.append({"rows": rows, "live": live, "got": got, "want": want})
    return commits, ivf


@pytest.mark.cuda
def test_cuda_windowed_index_removes_retracted_rows():
    """Windows past the cutoff are retracted, and their rows leave the IVF
    on the card (``-inf`` bias in the slabs the rescore kernel reads):
    after every commit the index holds the alive rows only, and each
    answer equals an exact search over them (ties within 1e-5)."""
    _cuda()
    before = rescore_shortlist.launches
    commits, ivf = windowed_index_run()
    assert rescore_shortlist.launches > before and ivf._slabs.device.type == "cuda"
    for c in commits:
        assert c["rows"] == len(c["live"])
        assert sorted(c["got"]) == sorted(c["want"])
        for q, want in c["want"].items():
            got = c["got"][q]
            np.testing.assert_allclose([s for _d, s in got], [s for _d, s in want], atol=1e-4)
            for j, ((gd, gs), (wd, ws)) in enumerate(zip(got, want)):
                assert gd == wd or any(abs(ws - want[i][1]) <= 1e-5 for i in (j - 1, j + 1) if 0 <= i < len(want))
            assert all(d in set(c["live"]) for d, _s in got)


@pytest.mark.cuda
def test_cuda_async_transformer_retrieval_equals_a_direct_search():
    """Phase 23 of ``chip_smoke.py`` at 1,024 documents: 1,024 queries in
    16 commits through a ``pw.AsyncTransformer`` whose ``invoke`` awaits a
    ``ServeScheduler`` ticket over the full-probe IVF on the card.  Every
    row arrives, the run returns, each row equals a direct search of its
    query (scores within 2e-2, bf16), the rescore kernel launched, and
    ``pw.sql``, a ``pw.transformer`` and export / import over the answers
    equal plain loops (the phase raises on any difference)."""
    import importlib.util
    import os

    import pathway_tpu_torch as pw

    dev = _cuda()
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    pw.reset()
    try:
        report = chip_smoke.hostapi_retrieval(pw, chip_smoke._ps_embedder(), chip_smoke.corpus(1024), dev)
    finally:
        pw.reset()
    assert report["launches"] > 0 and report["ivf"]._slabs.device.type == "cuda"
    assert report["hits"] == 1024 * chip_smoke.K


@pytest.mark.cuda
def test_cuda_cdc_feed_into_a_live_index_equals_an_exact_search():
    """Phase 25 of ``chip_smoke.py`` at 1,024 documents on the card: the
    S3 bulk load, the debezium CDC commits and the Kafka queries over fake
    clients into a full-probe IVF ``DataIndex``; every answer equals an
    exact search over the alive documents, the sinks equal a plain loop,
    the rescore kernel launched (the phase raises on any difference)."""
    import importlib.util
    import os

    import pathway_tpu_torch as pw

    dev = _cuda()
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    pw.reset()
    try:
        report, ivf = chip_smoke.connectors_retrieval(pw, chip_smoke._ps_embedder(), chip_smoke.corpus(1024), dev)
    finally:
        pw.reset()
    assert report["launches"] > 0 and ivf._slabs.device.type == "cuda"
    assert report["alive_end"] == 1024 - report["deletes"]
