"""The port's DocumentStore against the reference.

First with the reference test's ``FakeEmbedder`` in both packages: equal
``retrieve_query`` / ``statistics_query`` / ``inputs_query`` results,
the glob filter included.  Then with ``TpuEmbedder``: the reference
encoder's seeded Flax parameters carried into the port, f32 on both sides
at a small width (2 layers, 64 wide), equal retrieved texts and scores
within 1e-5.  The port runs on the CPU here (``device="cpu"``).
"""

import fnmatch
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.io import _connector as ref_connector
from pathway_tpu.models import encoder as ref_encoder_mod
from pathway_tpu.xpacks.llm.document_store import DocumentStore as RefStore
from pathway_tpu.xpacks.llm.embedders import BaseEmbedder as RefBase
from pathway_tpu.xpacks.llm.embedders import TpuEmbedder as RefTpuEmbedder
from pathway_tpu_torch.internals.keys import sequential_keys
from pathway_tpu_torch.io import _connector as port_connector
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore as PortStore
from pathway_tpu_torch.xpacks.llm.embedders import BaseEmbedder as PortBase
from pathway_tpu_torch.xpacks.llm.embedders import TpuEmbedder

from .test_xpack_llm import FakeEmbedder

TOL = 1e-5
_ENC = dict(dimension=64, n_layers=2, max_length=32)
_ENC_EXTRA = dict(n_heads=4, vocab_size=4096, seed=0)
_WORDS = "cat dog fish bird tree rock sun moon stream index vector query kernel".split()


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setattr(ref_connector, "_source_counter", [0])
    monkeypatch.setattr(port_connector, "_source_counter", [0])
    pathway_tpu.reset()
    pathway_tpu_torch.reset()
    yield
    pathway_tpu.reset()
    pathway_tpu_torch.reset()


def _fake(base):
    """The reference test's FakeEmbedder as an embedder of ``base``'s package."""
    fake = FakeEmbedder()

    class Fake(base):
        def __init__(self):
            super().__init__(fake.func, batched=True)

        def get_embedding_dimension(self, **kwargs):
            return 8

    return Fake()


def _docs(pw, n=24, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        text = " ".join(rng.choice(_WORDS, size=int(rng.integers(3, 9)))) + f" doc{i}."
        rows.append((text, {"path": f"d{i % 3}/{i}.{'md' if i % 4 == 0 else 'txt'}", "modified_at": 100 + i}))
    return pw.debug.table_from_rows(pw.schema_from_types(data=str, _metadata=dict), rows), rows


def _factory(pw, kind, embedder, dimension):
    extra = {"device": "cpu"} if pw is pathway_tpu_torch else {}
    if kind == "brute":
        return pw.stdlib.indexing.BruteForceKnnFactory(dimension=dimension, embedder=embedder, **extra)
    return pw.stdlib.indexing.IvfKnnFactory(dimension=dimension, embedder=embedder, n_clusters=2, n_probe=2, **extra)


_QUERIES = [
    ("cat dog", 3, None, None),
    ("fish moon", 4, None, "*.md"),
    ("tree rock sun", 2, None, "d1/*"),
    ("kernel vector", 5, "modified_at > 110", None),
    ("bird", 1, None, None),
]


def _fake_run(pw, Store, base, kind):
    docs, _rows = _docs(pw)
    store = Store(docs, retriever_factory=_factory(pw, kind, _fake(base), 8), splitter=None)
    queries = pw.debug.table_from_rows(Store.RetrieveQuerySchema, _QUERIES)
    stats_q = pw.debug.table_from_rows(Store.StatisticsQuerySchema, [()])
    inputs_q = pw.debug.table_from_rows(Store.InputsQuerySchema, [(None, None), (None, "*.md"), ("modified_at > 118", None)])
    outs = [store.retrieve_query(queries), store.statistics_query(stats_q), store.inputs_query(inputs_q)]
    pw.run(monitoring_level=None)
    result = []
    for out in outs:
        keys, cols = out._materialize()
        result.append({int(k): cols["result"][i] for i, k in enumerate(keys)})
    return result


def _assert_same_documents(want, got, tie=1e-6):
    """Documents agree position by position with dists within ``TOL``; a
    position may hold another document only at an equal dist (within
    ``tie``): the marker-word counts of the fake embedder tie often, also
    at the k-th place, and a tie may break either way."""
    assert len(got) == len(want)
    assert len({r["text"] for r in got}) == len(got)
    for j, (w, g) in enumerate(zip(want, got)):
        assert abs(w["dist"] - g["dist"]) <= TOL, (j, want, got)
        if (w["text"], w["metadata"]) != (g["text"], g["metadata"]):
            assert abs(w["dist"] - g["dist"]) <= tie, (j, want, got)


@pytest.mark.parametrize("kind", ["brute", "ivf"])
def test_fake_embedder_store_equals_reference(kind):
    ref = _fake_run(pathway_tpu, RefStore, RefBase, kind)
    pathway_tpu.reset()
    port = _fake_run(pathway_tpu_torch, PortStore, PortBase, kind)
    ref_retrieve, ref_stats, ref_inputs = ref
    port_retrieve, port_stats, port_inputs = port
    assert sorted(port_retrieve) == sorted(ref_retrieve)
    for qk, want in ref_retrieve.items():
        _assert_same_documents(want, port_retrieve[qk])
    assert port_stats == ref_stats
    assert {k: sorted(v, key=lambda r: r["path"]) for k, v in port_inputs.items()} == {
        k: sorted(v, key=lambda r: r["path"]) for k, v in ref_inputs.items()
    }
    # the glob arms returned only matching paths (a static table's row i
    # has key sequential_keys(0, n)[i])
    qkeys = [int(k) for k in sequential_keys(0, len(_QUERIES))]
    for (_text, _k, _flt, glob), qk in zip(_QUERIES, qkeys):
        if glob is not None:
            assert port_retrieve[qk] and all(fnmatch.fnmatch(r["metadata"]["path"], glob) for r in port_retrieve[qk])


@pytest.fixture(scope="module")
def embedders():
    """The reference's TpuEmbedder with its encoder in f32, and the port's
    TpuEmbedder over the same Flax parameters."""
    orig = ref_encoder_mod.SentenceEncoder
    ref_encoder_mod.SentenceEncoder = functools.partial(orig, dtype=jnp.float32, **_ENC_EXTRA)
    try:
        ref = RefTpuEmbedder(**_ENC)
    finally:
        ref_encoder_mod.SentenceEncoder = orig
    tree = jax.tree_util.tree_map(np.asarray, ref._encoder.params)
    port = TpuEmbedder(**_ENC, **_ENC_EXTRA, device="cpu", dtype=torch.float32, params=tree)
    return ref, port


def test_tpu_embedder_vectors_equal_reference(embedders):
    ref, port = embedders
    _docs_t, rows = _docs(pathway_tpu_torch, n=40)
    texts = np.array([r[0] for r in rows], dtype=object)
    np.testing.assert_allclose(port.func(texts), ref.func(texts), atol=TOL)
    assert port.get_embedding_dimension() == ref.get_embedding_dimension() == 64
    assert port._encoder.device == torch.device("cpu")


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "plain"])
def test_tpu_embedder_paths_agree(embedders, packed):
    _ref, port = embedders
    enc = port._encoder
    plain = TpuEmbedder(**_ENC, **_ENC_EXTRA, device="cpu", dtype=torch.float32, packed=packed)
    plain._encoder.module.load_state_dict(enc.module.state_dict())
    texts = np.array([f"{w} query {i}" for i, w in enumerate(_WORDS)], dtype=object)
    np.testing.assert_allclose(plain.func(texts), enc.encode(list(texts)), atol=TOL)


def _tpu_run(pw, Store, embedder, kind):
    docs, _rows = _docs(pw, n=60, seed=3)
    store = Store(docs, retriever_factory=_factory(pw, kind, embedder, 64), splitter=None)
    queries = pw.debug.table_from_rows(Store.RetrieveQuerySchema, _QUERIES)
    out = store.retrieve_query(queries)
    pw.run(monitoring_level=None)
    keys, cols = out._materialize()
    return {int(k): cols["result"][i] for i, k in enumerate(keys)}


@pytest.mark.parametrize("kind", ["brute", "ivf"])
def test_tpu_embedder_store_equals_reference(embedders, kind):
    ref_emb, port_emb = embedders
    ref = _tpu_run(pathway_tpu, RefStore, ref_emb, kind)
    pathway_tpu.reset()
    port = _tpu_run(pathway_tpu_torch, PortStore, port_emb, kind)
    assert sorted(port) == sorted(ref)
    for qk, want in ref.items():
        got = port[qk]
        assert [r["text"] for r in got] == [r["text"] for r in want]
        np.testing.assert_allclose([r["dist"] for r in got], [r["dist"] for r in want], atol=TOL)
    assert all(port.values())


def test_default_store_runs_on_the_card():
    """The default retriever is ``TpuKnnFactory(embedder=TpuEmbedder())``:
    on a machine without CUDA it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    docs, _rows = _docs(pathway_tpu_torch, n=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PortStore(docs)


@pytest.mark.parametrize(
    "name", ["SentenceTransformerEmbedder", "OpenAIEmbedder", "LiteLLMEmbedder", "GeminiEmbedder"]
)
def test_embedders_without_their_package_or_card_raise(name):
    """Ported in full now: the seeded ``SentenceTransformerEmbedder`` runs
    on the card (it raises without one), and each hosted-API embedder
    imports its client package at first call and raises ``ImportError``
    without it, as the reference's does."""
    import asyncio

    from pathway_tpu.xpacks.llm import embedders as ref_embedders
    from pathway_tpu_torch.xpacks.llm import embedders

    if name == "SentenceTransformerEmbedder":
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            embedders.SentenceTransformerEmbedder()
        return
    for module in (ref_embedders, embedders):
        emb = getattr(module, name)()
        with pytest.raises(ImportError, match=name):
            asyncio.run(emb.func("a text"))


def test_parse_utf8_and_splitter_equal_reference():
    from pathway_tpu.xpacks.llm.parsers import ParseUtf8 as RefParse
    from pathway_tpu.xpacks.llm.splitters import TokenCountSplitter as RefSplit
    from pathway_tpu_torch.xpacks.llm.parsers import ParseUtf8
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    text = "One sentence here. " * 30 + "a tail without a stop"
    assert ParseUtf8().func(text.encode()) == RefParse().func(text.encode())
    assert TokenCountSplitter(min_tokens=5, max_tokens=20).func(text) == RefSplit(min_tokens=5, max_tokens=20).func(text)
