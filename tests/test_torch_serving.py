"""Port parity for the whole slice on the CPU: tokenizer -> encoder ->
exact and IVF ``FusedEncodeSearch`` of ``pathway_tpu_torch`` against the
reference's, with the reference's encoder parameters and index state
carried over.  f32 throughout: keys equal (a swap allowed only between
scores tied within 1e-5), scores within 1e-4.

Also: the port imports neither JAX, Flax nor the reference package (nor
``transformers``, ``safetensors`` or ``orbax``), and its entry points refuse to run without CUDA unless asked for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

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
from pathway_tpu_torch.models.clip import ClipModel
from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel
from pathway_tpu_torch.models.encoder import SentenceEncoder
from pathway_tpu_torch.models.generator import TextGenerator
from pathway_tpu_torch.ops.ivf import IvfKnnIndex, ShardedIvfIndex
from pathway_tpu_torch.ops.knn import DeviceKnnIndex
from pathway_tpu_torch.ops.serving import FusedEncodeSearch
from pathway_tpu_torch.parallel import ShardGroup, make_mesh

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


# JAX and the reference package, and what the card's machine lacks: the HF
# runtime, the safetensors package and orbax
_FORBIDDEN = ("jax", "jaxlib", "flax", "pathway_tpu", "transformers", "safetensors", "orbax")


def test_port_imports_no_jax_flax_or_reference():
    files = sorted((_ROOT / "pathway_tpu_torch").rglob("*.py"))
    names = {str(f.relative_to(_ROOT / "pathway_tpu_torch")) for f in files}
    # the script and the multi-process tests' rank worker run without JAX too
    files += [_ROOT / "chip_smoke.py", _ROOT / "tests" / "torch_dist_worker.py"]
    assert {
        "cache/embedding.py",
        "cache/keys.py",
        "cache/prefix.py",
        "cache/result.py",
        "cache/store.py",
        "config.py",
        "debug/__init__.py",
        "engine/delta.py",
        "engine/executor.py",
        "engine/graph.py",
        "engine/operators/external_index.py",
        "index/forward.py",
        "internals/keys.py",
        "internals/run.py",
        "internals/table.py",
        "io/_connector.py",
        "io/python/__init__.py",
        "io/_offsets.py",
        "kernels/build.py",
        "models/clip.py",
        "models/cross_encoder.py",
        "models/generator.py",
        "models/hf_import.py",
        "models/packing.py",
        "models/prng.py",
        "models/safetensors.py",
        "models/tokenizer.py",
        "models/wordpiece.py",
        "observe/hbm.py",
        "observe/histogram.py",
        "observe/profile.py",
        "observe/recorder.py",
        "observe/slo.py",
        "observe/trace.py",
        "ops/decode_rows.py",
        "ops/dispatch_counter.py",
        "ops/donation_guard.py",
        "ops/kv_quant.py",
        "ops/maxsim.py",
        "ops/recompile_guard.py",
        "ops/retrieve_rerank.py",
        "ops/ring_attention.py",
        "ops/topk.py",
        "parallel/distributed.py",
        "parallel/exchange.py",
        "parallel/mesh.py",
        "parallel/shards.py",
        "persistence/__init__.py",
        "persistence/backends.py",
        "persistence/engine_state.py",
        "persistence/framing.py",
        "persistence/host_pickle.py",
        "persistence/object_cache.py",
        "demo/__init__.py",
        "io/null/__init__.py",
        "io/sqlite/__init__.py",
        "stdlib/indexing/bm25.py",
        "stdlib/indexing/hybrid_index.py",
        "stdlib/indexing/retrievers.py",
        "stdlib/indexing/vector_document_index.py",
        "stdlib/ml/__init__.py",
        "stdlib/ml/_knn_lsh.py",
        "stdlib/ml/classifiers.py",
        "stdlib/ml/index.py",
        "stdlib/stateful/__init__.py",
        "robust/deadline.py",
        "robust/degrade.py",
        "robust/inject.py",
        "robust/retry.py",
        "serve/decode.py",
        "serve/fabric.py",
        "serve/ingest.py",
        "serve/scheduler.py",
        "serve/tuner.py",
        "serve/warmstate.py",
        "stdlib/indexing/data_index.py",
        "stdlib/indexing/nearest_neighbors.py",
        "xpacks/llm/document_store.py",
        "xpacks/llm/embedders.py",
        "xpacks/llm/evals.py",
        "xpacks/llm/llms.py",
        "xpacks/llm/parsers.py",
        "xpacks/llm/prompts.py",
        "xpacks/llm/question_answering.py",
        "xpacks/llm/rerankers.py",
        "xpacks/llm/servers.py",
        "xpacks/llm/vector_store.py",
        "io/fs/__init__.py",
        "io/csv/__init__.py",
        "io/jsonlines/__init__.py",
        "io/plaintext/__init__.py",
        "io/http/__init__.py",
        "internals/config.py",
        "internals/metrics.py",
        "internals/yaml_loader.py",
        "cli.py",
        "internals/iterate.py",
        "stdlib/temporal/__init__.py",
        "stdlib/temporal/session_windows.py",
        "stdlib/temporal/temporal_behavior.py",
        "stdlib/temporal/time_utils.py",
        "stdlib/indexing/sorting.py",
        "stdlib/ordered/__init__.py",
        "stdlib/statistical/__init__.py",
        "stdlib/graphs/__init__.py",
        "stdlib/graphs/bellman_ford.py",
        "stdlib/graphs/common.py",
        "stdlib/graphs/graph.py",
        "stdlib/graphs/louvain_communities.py",
        "stdlib/graphs/pagerank.py",
        "asynchronous.py",
        "internals/export_import.py",
        "internals/interactive.py",
        "internals/row_transformer.py",
        "internals/sql.py",
        "stdlib/ml/hmm.py",
        "stdlib/ml/smart_table_ops.py",
        "stdlib/utils/__init__.py",
        "stdlib/utils/async_transformer.py",
        "stdlib/utils/col.py",
        "stdlib/utils/pandas_transformer.py",
        "stdlib/viz/__init__.py",
        "internals/telemetry.py",
        "io/_gated.py",
        *(f"io/{name}/__init__.py" for name in (
            "airbyte", "bigquery", "debezium", "deltalake", "elasticsearch", "gdrive", "kafka", "logstash", "minio",
            "mongodb", "nats", "postgres", "pubsub", "pyfilesystem", "redpanda", "s3", "s3_csv", "sharepoint",
            "slack")),
    } <= names
    bad = [
        (str(f.relative_to(_ROOT)), name)
        for f in files
        for name in _imports(f)
        if name.split(".")[0] in _FORBIDDEN
    ]
    assert bad == []
    # the port builds its own native code; it never loads the reference's library
    sources = files + sorted((_ROOT / "pathway_tpu_torch" / "csrc").rglob("*.c*"))
    assert [str(f) for f in sources if "libpathway_native" in f.read_text() or "native/build" in f.read_text()] == []


@pytest.mark.parametrize(
    "module",
    [
        "pathway_tpu_torch",
        "pathway_tpu_torch.xpacks.llm.document_store",
        "pathway_tpu_torch.stdlib.indexing",
        "pathway_tpu_torch.xpacks.llm",
        "pathway_tpu_torch.cli",
        "pathway_tpu_torch.internals.metrics",
        "pathway_tpu_torch.persistence.engine_state",
        "pathway_tpu_torch.stdlib.ml",
        "pathway_tpu_torch.demo",
        "pathway_tpu_torch.stdlib.utils",
        "pathway_tpu_torch.stdlib.viz",
        "pathway_tpu_torch.parallel.exchange",
    ],
)
def test_framework_import_loads_no_jax_xxhash_or_pandas(module):
    """The framework's entry modules, imported in a fresh interpreter, load
    neither JAX, Flax nor the reference package, nor ``xxhash``,
    ``pandas``, ``aiohttp`` or ``requests`` (the card's machine has none of
    them), nor PyYAML (``load_yaml`` imports it when called)."""
    script = (
        f"import sys, {module}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pathway_tpu', 'xxhash', 'pandas', 'aiohttp', 'requests', 'yaml'))\n"
        "print('loaded', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=_ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "loaded []"


def test_port_import_leaves_reference_registries_unchanged():
    """Importing every module of the port (in a fresh interpreter, after
    the reference's registries exist) adds no knob to
    ``pathway_tpu.config`` and no family or provider to
    ``pathway_tpu.observe``."""
    modules = sorted(
        "pathway_tpu_torch." + ".".join(f.relative_to(_ROOT / "pathway_tpu_torch").with_suffix("").parts)
        for f in (_ROOT / "pathway_tpu_torch").rglob("*.py")
        if f.name != "__init__.py"
    )
    script = textwrap.dedent(
        f"""
        import importlib
        from pathway_tpu import config, observe
        from pathway_tpu.observe import recorder

        def state():
            return (
                sorted(config.registry()),
                {{n: sorted(s) for n, s in recorder._hists.items()}},
                {{n: sorted(s) for n, s in recorder._counters.items()}},
                {{n: sorted(s) for n, s in recorder._gauges.items()}},
                len(recorder._providers),
            )

        before = state()
        for name in {modules!r}:
            importlib.import_module(name)
        assert state() == before, "the port changed a registry of the reference"
        print("ok", len(before[0]))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=_ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0 and out.stdout.startswith("ok"), out.stderr[-2000:]


def test_entry_points_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (
        lambda: SentenceEncoder(dimension=8, n_layers=1, n_heads=2, vocab_size=64),
        lambda: DeviceKnnIndex(8),
        lambda: IvfKnnIndex(8),
        lambda: CrossEncoderModel(dimension=8, n_layers=1, n_heads=2, vocab_size=64),
        lambda: TextGenerator(dimension=8, n_layers=1, n_heads=2, vocab_size=64, kv_cache=None),
        lambda: ClipModel(dimension=8, proj_dim=8, n_layers=1, n_heads=2, image_size=16, patch=8, vocab_size=64),
        lambda: ShardGroup(),
        lambda: ShardedIvfIndex(8, n_shards=2),
        lambda: make_mesh(),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # the forward index and the pipeline run where their encoder runs
    enc = SentenceEncoder(dimension=8, n_layers=1, n_heads=2, vocab_size=64, device="cpu")
    assert ForwardIndex(enc).device.type == "cpu"
