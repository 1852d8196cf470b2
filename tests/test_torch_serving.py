"""Port parity for the whole slice on the CPU: tokenizer -> encoder ->
exact and IVF ``FusedEncodeSearch`` of ``pathway_tpu_torch`` against the
reference's, with the reference's encoder parameters and index state
carried over.  f32 throughout: keys equal (a swap allowed only between
scores tied within 1e-5), scores within 1e-4.

Also: the port imports neither JAX, Flax nor the reference package, and
its entry points refuse to run without CUDA unless asked for the CPU."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models.encoder import SentenceEncoder as RefEncoder
from pathway_tpu.ops.ivf import IvfKnnIndex as RefIvf
from pathway_tpu.ops.knn import DeviceKnnIndex as RefKnn
from pathway_tpu.ops.serving import FusedEncodeSearch as RefServe
from pathway_tpu_torch.index import ForwardIndex
from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel
from pathway_tpu_torch.models.encoder import SentenceEncoder
from pathway_tpu_torch.ops.ivf import IvfKnnIndex
from pathway_tpu_torch.ops.knn import DeviceKnnIndex
from pathway_tpu_torch.ops.serving import FusedEncodeSearch

from .test_torch_ivf import assert_same_ranking


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers; torch's default of one thread
    per core would crowd the timing-sensitive tests of the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ROOT = pathlib.Path(__file__).resolve().parent.parent
_WORDS = (
    "stream join window index vector query tensor kernel shard replica "
    "commit offset snapshot schema tokenizer encoder cluster probe slab "
    "rescore latency batch device host cache ingest update serve"
).split()
_ENC = dict(dimension=64, n_layers=2, n_heads=4, max_length=32, vocab_size=4096, seed=0)


def _corpus(n, seed=0):
    rng = np.random.default_rng(seed)
    return [
        " ".join(rng.choice(_WORDS, size=int(rng.integers(4, 20)))) + f" item {i}"
        for i in range(n)
    ]


@pytest.fixture(scope="module")
def slice_pair():
    ref_enc = RefEncoder(dtype=jnp.float32, **_ENC)
    tree = jax.tree_util.tree_map(np.asarray, ref_enc.params)
    enc = SentenceEncoder(dtype=torch.float32, device="cpu", params=tree, **_ENC)
    docs = _corpus(1500)
    vecs = np.concatenate([ref_enc.encode(docs[i : i + 256]) for i in range(0, len(docs), 256)])
    keys = [int(i) * 2654435761 + (1 << 40) for i in range(len(docs))]  # use the hi plane
    return ref_enc, enc, docs, vecs, keys


def test_encoder_matches_reference(slice_pair):
    ref_enc, enc, docs, vecs, _ = slice_pair
    np.testing.assert_allclose(enc.encode(docs[:300]), vecs[:300], atol=1e-5)


def _compare_serves(ref_serve, port_serve, queries, k=10):
    want = ref_serve(queries, k=k)
    got = port_serve(queries, k=k)
    assert len(got) == len(want) == len(queries)
    for w, g in zip(want, got):
        assert_same_ranking(w, g)
    return want, got


@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
def test_exact_index_matches_reference(metric):
    """add (with capacity growth), upsert and remove, then host search."""
    rng = np.random.default_rng(1)
    vecs = rng.normal(size=(300, 16)).astype(np.float32)
    keys = [int(k) for k in rng.permutation(1 << 20)[:300]] + [(1 << 63) + 5]
    vecs = np.concatenate([vecs, vecs[:1] * 2])
    ref = RefKnn(16, metric=metric, initial_capacity=16)
    port = DeviceKnnIndex(16, metric=metric, initial_capacity=16, device="cpu")
    for index in (ref, port):
        index.add(keys[:200], vecs[:200])
        index.add(keys[150:], vecs[150:] + 0.5)  # upsert 50, grow past 256
        index.remove(keys[10:20])
    assert len(port) == len(ref) == len(keys) - 10
    assert port.key_to_slot == ref.key_to_slot
    queries = rng.normal(size=(7, 16)).astype(np.float32)
    for w, g in zip(ref.search(queries, k=12), port.search(queries, k=12)):
        assert_same_ranking(w, g)
        assert not {k for k, _ in g} & set(keys[10:20])


def test_exact_serve_matches_reference(slice_pair):
    ref_enc, enc, docs, vecs, keys = slice_pair
    ref_index = RefKnn(64, initial_capacity=len(docs))
    ref_index.add(keys, vecs)
    index = DeviceKnnIndex(64, initial_capacity=len(docs), device="cpu")
    index.add(keys, vecs)
    queries = docs[::23][:64]
    want, got = _compare_serves(
        RefServe(ref_enc, ref_index, embed_cache=None), FusedEncodeSearch(enc, index), queries
    )
    # self-retrieval: each query IS a document
    assert [row[0][0] for row in got] == [keys[i] for i in range(0, len(docs), 23)][:64]
    # 5 queries: a non-bucket batch size, padded with fully masked rows
    _compare_serves(
        RefServe(ref_enc, ref_index, embed_cache=None), FusedEncodeSearch(enc, index), docs[:5], k=7
    )


@pytest.mark.parametrize("n_probe", [None, 1])
def test_ivf_serve_matches_reference(slice_pair, n_probe):
    ref_enc, enc, docs, vecs, keys = slice_pair
    ref_index = RefIvf(64, n_probe=n_probe, seed=2)
    ref_index.add(keys, vecs)
    ref_index.build()
    # rows after the build: served from the exact tail
    fresh = _corpus(6, seed=9)
    ref_index.add([7, 8, 9, 10, 11, keys[3]], ref_enc.encode(fresh))
    index = IvfKnnIndex(64, n_probe=n_probe, seed=2, device="cpu")
    index.load_warm_state(ref_index.warm_state())
    queries = docs[::29][:50] + fresh
    _compare_serves(RefServe(ref_enc, ref_index, embed_cache=None), FusedEncodeSearch(enc, index), queries)


def test_ivf_full_probe_equals_exact(slice_pair):
    """Within the port: probing every cluster rescores every row, so the
    IVF top-k is the exact top-k."""
    _, enc, docs, vecs, keys = slice_pair
    exact = DeviceKnnIndex(64, initial_capacity=len(docs), device="cpu")
    exact.add_from_device(keys, torch.from_numpy(vecs))
    ivf = IvfKnnIndex(64, device="cpu")
    ivf.build_from_matrix(keys, exact._matrix[: len(keys)])
    ivf.n_probe = ivf._centroids.shape[0]
    queries = docs[::31]
    want = FusedEncodeSearch(enc, exact)(queries)
    got = FusedEncodeSearch(enc, ivf)(queries)
    for w, g in zip(want, got):
        assert_same_ranking(w, g)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_flax_or_reference():
    files = sorted((_ROOT / "pathway_tpu_torch").rglob("*.py")) + [_ROOT / "chip_smoke.py"]
    names = {str(f.relative_to(_ROOT / "pathway_tpu_torch")) for f in files[:-1]}
    assert {
        "index/forward.py",
        "models/cross_encoder.py",
        "models/packing.py",
        "ops/dispatch_counter.py",
        "ops/maxsim.py",
        "ops/retrieve_rerank.py",
        "robust.py",
    } <= names
    bad = [
        (str(f.relative_to(_ROOT)), name)
        for f in files
        for name in _imports(f)
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "pathway_tpu")
    ]
    assert bad == []


def test_entry_points_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (
        lambda: SentenceEncoder(dimension=8, n_layers=1, n_heads=2, vocab_size=64),
        lambda: DeviceKnnIndex(8),
        lambda: IvfKnnIndex(8),
        lambda: CrossEncoderModel(dimension=8, n_layers=1, n_heads=2, vocab_size=64),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # the forward index and the pipeline run where their encoder runs
    enc = SentenceEncoder(dimension=8, n_layers=1, n_heads=2, vocab_size=64, device="cpu")
    assert ForwardIndex(enc).device.type == "cpu"
