"""Question answering and chat of the port (``xpacks/llm``: prompts,
rerankers, llms, question_answering, evals, and the rest of the embedders
and parsers) against the reference.

Both packages run on the same seeded inputs: the reference's Flax
parameters (``module.init`` at a seed) are carried into the port by
``models/params.py``; both sides compute in f32 at a small width
(encoder and generator 64 wide, 2 layers; cross-encoder 64 wide,
2 layers), the port on the CPU.  Sources read with ``atomic_batches``.

Tolerances: greedy answers, prompts, retrieved and reranked texts and
their metadata (``seen_at``, each package's own read clock, apart) are
compared exactly; retrieval distances and rerank scores within 1e-5 (f32,
another summation order).  A rerank order may differ only between two
documents whose scores agree within 1e-5 (a tie may break either way).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.io import _connector as ref_connector
from pathway_tpu.models import encoder as ref_encoder_mod
from pathway_tpu.models.cross_encoder import CrossEncoderModel as RefCrossEncoder
from pathway_tpu.models.generator import TextGenerator as RefGen
from pathway_tpu.robust import CircuitBreaker as RefBreaker
from pathway_tpu.xpacks.llm import evals as ref_evals
from pathway_tpu.xpacks.llm import llms as ref_llms
from pathway_tpu.xpacks.llm import prompts as ref_prompts
from pathway_tpu.xpacks.llm import question_answering as ref_qa
from pathway_tpu.xpacks.llm import rerankers as ref_rerankers
from pathway_tpu.xpacks.llm.document_store import DocumentStore as RefStore
from pathway_tpu.xpacks.llm.embedders import TpuEmbedder as RefTpuEmbedder
from pathway_tpu_torch.io import _connector as port_connector
from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel
from pathway_tpu_torch.models.generator import TextGenerator
from pathway_tpu_torch.robust import CircuitBreaker
from pathway_tpu_torch.xpacks.llm import evals, llms, prompts, question_answering, rerankers
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore as PortStore
from pathway_tpu_torch.xpacks.llm.embedders import TpuEmbedder

from .utils import REPO_ROOT

TOL = 1e-5
_ENC = dict(dimension=64, n_layers=2, max_length=32)
_ENC_EXTRA = dict(n_heads=4, vocab_size=4096, seed=0)
_GEN = dict(dimension=64, n_layers=2, n_heads=4, max_length=256, vocab_size=4096)
_CE = dict(dimension=64, n_layers=2, n_heads=4, max_length=128, vocab_size=4096)
_MAX_NEW = 8

PKG = {
    "ref": dict(pw=pathway_tpu, Store=RefStore, qa=ref_qa, llms=ref_llms, rerankers=ref_rerankers,
                evals=ref_evals, Breaker=RefBreaker),
    "port": dict(pw=pathway_tpu_torch, Store=PortStore, qa=question_answering, llms=llms,
                 rerankers=rerankers, evals=evals, Breaker=CircuitBreaker),
}


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setattr(ref_connector, "_source_counter", [0])
    monkeypatch.setattr(port_connector, "_source_counter", [0])
    pathway_tpu.reset()
    pathway_tpu_torch.reset()
    yield
    pathway_tpu.reset()
    pathway_tpu_torch.reset()


@pytest.fixture(scope="module")
def models():
    """Each model of the QA path in both packages, f32, the port's over
    the reference's parameters."""
    orig = ref_encoder_mod.SentenceEncoder
    ref_encoder_mod.SentenceEncoder = functools.partial(orig, dtype=jnp.float32, **_ENC_EXTRA)
    try:
        ref_emb = RefTpuEmbedder(**_ENC)
    finally:
        ref_encoder_mod.SentenceEncoder = orig
    tree = jax.tree_util.tree_map(np.asarray, ref_emb._encoder.params)
    port_emb = TpuEmbedder(**_ENC, **_ENC_EXTRA, device="cpu", dtype=torch.float32, params=tree)
    ref_gen = RefGen(**_GEN, dtype=jnp.float32, kv_cache=None, eos_id=None)
    port_gen = TextGenerator(**_GEN, dtype=torch.float32, kv_cache=None, eos_id=None, device="cpu",
                             params=jax.tree_util.tree_map(np.asarray, ref_gen.params))
    ref_ce = RefCrossEncoder(dtype=jnp.float32, **_CE)
    port_ce = CrossEncoderModel(dtype=torch.float32, device="cpu",
                                params=jax.tree_util.tree_map(np.asarray, ref_ce.params), **_CE)
    return {
        "ref": dict(emb=ref_emb, gen=ref_gen, ce=ref_ce),
        "port": dict(emb=port_emb, gen=port_gen, ce=port_ce),
    }


@pytest.fixture(scope="module")
def fact_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("facts")
    cases = ref_evals.make_fact_corpus(str(d), n_docs=12, seed=3)
    return d, cases


def _store(side, models, fact_dir):
    p = PKG[side]
    pw = p["pw"]
    d, _cases = fact_dir
    docs = pw.io.fs.read(str(d), format="plaintext_by_file", with_metadata=True, mode="static")
    extra = {"device": "cpu"} if side == "port" else {}
    factory = pw.stdlib.indexing.BruteForceKnnFactory(dimension=64, embedder=models[side]["emb"], **extra)
    return p["Store"](docs, retriever_factory=factory, splitter=None)


def _chat(side, models, kind):
    p = PKG[side]
    if kind == "extractive":
        return p["evals"].ExtractiveReaderChat()
    return p["llms"].TpuChat(generator=models[side]["gen"], max_new_tokens=_MAX_NEW,
                             continuous=kind == "tpu_continuous")


def _meta(doc):
    """A retrieved document's metadata without ``seen_at``, the clock at
    the moment each package read the file."""
    meta = dict(doc["metadata"])
    assert meta.pop("seen_at") > 0
    return meta


def _stop(chat):
    decoder = getattr(chat, "_decoder", None)
    if decoder is not None:
        decoder.stop()


def _questions(fact_dir, n=6):
    _d, cases = fact_dir
    return [c.question for c in cases[:n]] + ["What do cats do?"]


def _answers(side, models, fact_dir, answerer, chat_kind, return_docs=False, **qa_kw):
    """Answers by question text from one package's answerer over the fact
    corpus."""
    p = PKG[side]
    pw, qa = p["pw"], p["qa"]
    store = _store(side, models, fact_dir)
    chat = None if answerer == "deck" else _chat(side, models, chat_kind)
    try:
        if answerer == "base":
            rag = qa.BaseRAGQuestionAnswerer(chat, store, search_topk=3, **qa_kw)
        elif answerer == "adaptive":
            rag = qa.AdaptiveRAGQuestionAnswerer(chat, store, n_starting_documents=1, factor=2, max_iterations=3,
                                                 **qa_kw)
        else:
            rag = qa.DeckRetriever(store, search_topk=3)
        schema = rag.AnswerQuerySchema
        qs = _questions(fact_dir)
        if answerer == "deck":
            rows = [(q, None) for q in qs]
        else:
            rows = [(q, None, None, return_docs) for q in qs]
        queries = pw.debug.table_from_rows(schema, rows)
        out = rag.answer_query(queries)
        pw.run(monitoring_level=None)
        keys, cols = out._materialize()
        qkeys, qcols = queries._materialize()
        text_of = {int(k): qcols["prompt"][i] for i, k in enumerate(qkeys)}
        return {text_of[int(k)]: cols["result"][i] for i, k in enumerate(keys)}, rag
    finally:
        if chat is not None:
            _stop(chat)


# -- prompts ---------------------------------------------------------------------


@pytest.mark.parametrize("name", ["prompt_qa", "prompt_qa_geometric_rag", "prompt_summarize", "prompt_short_qa"])
def test_prompts_are_byte_equal(name):
    docs = ["Cats purr.", "Dogs bark.\n\nTwice.", "", "unicode: naïve café ✓"]
    for q in ("What do cats do?", "", "why\nnot"):
        for n in range(len(docs) + 1):
            args = (docs[:n],) if name == "prompt_summarize" else (q, docs[:n])
            assert getattr(prompts, name)(*args) == getattr(ref_prompts, name)(*args)
    assert prompts.prompt_qa("q", ["d"], information_not_found_response="none") == ref_prompts.prompt_qa(
        "q", ["d"], information_not_found_response="none"
    )


def test_chat_message_rendering_is_equal():
    msgs = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"}, {"content": "x"}]
    assert llms._messages_to_prompt(msgs) == ref_llms._messages_to_prompt(msgs)
    assert llms._messages_to_prompt("plain") == ref_llms._messages_to_prompt("plain")
    assert llms.prompt_chat_single_qa("q?") == ref_llms.prompt_chat_single_qa("q?")


# -- rerank_topk_filter and the geometric strategy ---------------------------------------


def _topk_rows(side, k):
    pw = PKG[side]["pw"]
    t = pw.debug.table_from_rows(
        pw.schema_from_types(docs=tuple, scores=tuple),
        [(("a", "b", "c", "d"), (0.1, 0.9, 0.5, 0.9)), (("x",), (2.0,)), ((), ())],
    )
    out = t.select(r=PKG[side]["rerankers"].rerank_topk_filter(pw.this.docs, pw.this.scores, k=k))
    pw.run(monitoring_level=None)
    keys, cols = out._materialize()
    return {int(key): cols["r"][i] for i, key in enumerate(keys)}


@pytest.mark.parametrize("k", [1, 2, 5])
def test_rerank_topk_filter_equals_reference(k):
    ref = _topk_rows("ref", k)
    pathway_tpu.reset()
    port = _topk_rows("port", k)
    assert port == ref
    # the tie at 0.9 keeps the input order (a stable sort) in both
    assert any(r and r[0][:2] == ("b", "d")[: min(k, 2)] for r in port.values())


class _CountingChat:
    """A chat whose answer depends only on the prompt: it answers when the
    keyword's source is in the context, else the no-answer phrase."""

    batched = False

    def __init__(self, keyword):
        self.calls = []
        self.keyword = keyword
        self.func = self._reply

    def _reply(self, messages):
        prompt = messages[-1]["content"]
        self.calls.append(prompt)
        return f"answer about {self.keyword}" if self.keyword in prompt else "No information found."


@pytest.mark.parametrize("where", [0, 1, 3, 7, None])
def test_geometric_strategy_equals_reference(where):
    docs = [f"story {i}" for i in range(8)]
    if where is not None:
        docs[where] = "the cat story"
    got, want = _CountingChat("cat"), _CountingChat("cat")
    a = question_answering.answer_with_geometric_rag_strategy("who?", docs, got, 1, 2, 4)
    b = ref_qa.answer_with_geometric_rag_strategy("who?", docs, want, 1, 2, 4)
    assert a == b and got.calls == want.calls


# -- the answerers -------------------------------------------------------------------------


_CASES = [
    ("base", "extractive"),
    ("base", "tpu"),
    ("base", "tpu_continuous"),
    ("adaptive", "extractive"),
    ("adaptive", "tpu"),
    ("adaptive", "tpu_continuous"),
    ("deck", None),
]


@pytest.mark.parametrize("answerer,chat", _CASES, ids=[f"{a}-{c}" for a, c in _CASES])
def test_answerers_equal_reference(models, fact_dir, answerer, chat):
    want, _ = _answers("ref", models, fact_dir, answerer, chat)
    pathway_tpu.reset()
    got, _ = _answers("port", models, fact_dir, answerer, chat)
    assert sorted(got) == sorted(want)
    if answerer == "deck":
        for q, w in want.items():
            g = got[q]
            assert [(d["text"], _meta(d)) for d in g] == [(d["text"], _meta(d)) for d in w]
            np.testing.assert_allclose([d["dist"] for d in g], [d["dist"] for d in w], atol=TOL)
        return
    assert got == want
    if chat == "extractive":
        # the fact corpus's reader answers some questions and refuses others
        assert any(a != "No information found." for a in got.values())
    else:
        assert all(a.startswith("<") for a in got.values())  # rendered token ids


def test_tpu_chat_call_level_equals_continuous(models):
    """The port's TpuChat gives one answer per prompt whether it decodes
    call-level or through the ContinuousDecoder."""
    gen = models["port"]["gen"]
    texts = [prompts.prompt_qa("q?", ["a doc"]), "hello world", "x" * 40]
    arr = np.empty(len(texts), dtype=object)
    arr[:] = [[{"role": "user", "content": t}] for t in texts]
    plain = llms.TpuChat(generator=gen, max_new_tokens=_MAX_NEW, continuous=False)
    pooled = llms.TpuChat(generator=gen, max_new_tokens=_MAX_NEW, continuous=True)
    try:
        rendered = [f"user: {t}" for t in texts]
        assert list(plain.func(arr)) == list(pooled.func(arr)) == gen.generate(rendered, max_new_tokens=_MAX_NEW)
    finally:
        _stop(pooled)


def _context_run(side, models, fact_dir, coalesce, packed=None):
    ce = models[side]["ce"]
    reranker = PKG[side]["rerankers"].CrossEncoderReranker(cross_encoder=ce, packed=packed)
    answers, rag = _answers(side, models, fact_dir, "base", "extractive", return_docs=True, reranker=reranker,
                            coalesce_rerank=coalesce)
    if rag._rerank_batcher is not None:
        rag._rerank_batcher.stop()
    return answers


def _assert_same_reranked(want_docs, got_docs):
    assert len(got_docs) == len(want_docs)
    for j, (w, g) in enumerate(zip(want_docs, got_docs)):
        assert abs(w["rerank_score"] - g["rerank_score"]) <= TOL, (j, w, g)
        if (w["text"], _meta(w)) != (g["text"], _meta(g)):
            # a swap only between equal scores
            assert abs(w["rerank_score"] - g["rerank_score"]) <= TOL, (j, w, g)
        else:
            assert abs(w["dist"] - g["dist"]) <= TOL


@pytest.mark.parametrize("packed", [None, False], ids=["packed", "unpacked"])
def test_context_docs_and_rerank_order_equal_reference(models, fact_dir, packed):
    want = _context_run("ref", models, fact_dir, coalesce=False, packed=packed)
    pathway_tpu.reset()
    got = _context_run("port", models, fact_dir, coalesce=False, packed=packed)
    assert sorted(got) == sorted(want)
    for q, w in want.items():
        g = got[q]
        assert set(g) == set(w) == {"response", "context_docs"}
        assert len(g["context_docs"]) == 3
        _assert_same_reranked(w["context_docs"], g["context_docs"])
        if [d["text"] for d in g["context_docs"]] == [d["text"] for d in w["context_docs"]]:
            assert g["response"] == w["response"]
    # the reranked order follows the cross-encoder's own scores, stable on ties
    for q, g in got.items():
        scores = [d["rerank_score"] for d in g["context_docs"]]
        assert scores == sorted(scores, reverse=True)
        pairs = [(q, d["text"]) for d in g["context_docs"]]
        np.testing.assert_allclose(models["port"]["ce"].predict(pairs), scores, atol=TOL)


def test_coalesced_rerank_equals_uncoalesced(models, fact_dir):
    off = _context_run("port", models, fact_dir, coalesce=False)
    pathway_tpu_torch.reset()
    on = _context_run("port", models, fact_dir, coalesce=True)
    assert sorted(on) == sorted(off)
    for q, w in off.items():
        _assert_same_reranked(w["context_docs"], on[q]["context_docs"])
        assert on[q]["response"] == w["response"]


def _breaker_run(side, models, fact_dir):
    p = PKG[side]
    pw, qa = p["pw"], p["qa"]
    store = _store(side, models, fact_dir)
    chat = _chat(side, models, "extractive")
    rag = qa.BaseRAGQuestionAnswerer(chat, store, search_topk=2)
    # an open breaker of the test's own, not the shared "generator" one
    rag._llm_breaker = p["Breaker"](f"test-generator-{side}", failure_threshold=1, reset_s=3600.0)
    rag._llm_breaker.record_failure()
    assert rag._llm_breaker.state == "open"
    qs = _questions(fact_dir, n=3)
    queries = pw.debug.table_from_rows(rag.AnswerQuerySchema, [(q, None, None, True) for q in qs])
    out = rag.answer_query(queries)
    pw.run(monitoring_level=None)
    _keys, cols = out._materialize()
    return sorted((r["response"], tuple(r["degraded"]), tuple(d["text"] for d in r["context_docs"]))
                  for r in cols["result"]), chat.calls


def test_open_generator_breaker_answers_extractively_in_both(models, fact_dir):
    want, ref_calls = _breaker_run("ref", models, fact_dir)
    pathway_tpu.reset()
    got, port_calls = _breaker_run("port", models, fact_dir)
    assert got == want
    assert all(flags == ("extractive_answer",) for _r, flags, _d in got)
    assert ref_calls == port_calls == 0  # the chat was never called
    assert all(r for r, _f, _d in got)


def _eval_run(side, models, fact_dir):
    p = PKG[side]
    _d, cases = fact_dir
    pw, qa = p["pw"], p["qa"]
    store = _store(side, models, fact_dir)
    rag = qa.BaseRAGQuestionAnswerer(p["evals"].ExtractiveReaderChat(), store, search_topk=4)
    queries = pw.debug.table_from_rows(rag.AnswerQuerySchema, [(c.question, None, None, False) for c in cases])
    out = rag.answer_query(queries)
    pw.run(monitoring_level=None)
    keys, cols = out._materialize()
    qkeys, qcols = queries._materialize()
    text_of = {int(k): qcols["prompt"][i] for i, k in enumerate(qkeys)}
    answers = {text_of[int(k)]: cols["result"][i] for i, k in enumerate(keys)}
    result = p["evals"].run_eval(answers.__getitem__, cases)
    corpus = {}
    for f in sorted(_d.iterdir()):
        corpus[f.name] = f.read_text()

    def retrieve(question, k):
        words = set(question.lower().strip("?").split())
        ranked = sorted(corpus.values(), key=lambda t: (-len(words & set(t.lower().split())), t))
        return ranked[:k]

    curve = p["evals"].accuracy_vs_doc_count(retrieve, p["evals"].ExtractiveReaderChat(), cases)
    return result, curve


def test_run_eval_accuracy_equals_reference(models, fact_dir, tmp_path):
    ref_result, ref_curve = _eval_run("ref", models, fact_dir)
    pathway_tpu.reset()
    result, curve = _eval_run("port", models, fact_dir)
    assert (result.accuracy, result.correct, result.cases) == (ref_result.accuracy, ref_result.correct,
                                                                ref_result.cases)
    assert result.records == ref_result.records
    assert curve == ref_curve
    assert 0.0 < result.accuracy
    # the corpus writer itself is the reference's, byte for byte
    cases = evals.make_fact_corpus(str(tmp_path), n_docs=12, seed=3)
    d, ref_cases = fact_dir
    assert [(c.question, c.label, c.file) for c in cases] == [(c.question, c.label, c.file) for c in ref_cases]
    assert all((tmp_path / f.name).read_bytes() == f.read_bytes() for f in d.iterdir())


@pytest.mark.parametrize("text,label", [("Fredville", "Fredville"), ("It is fredville.", "Fredville"),
                                        ("No information found.", ""), ("Osterburg", "Fredville")])
def test_score_answer_equals_reference(text, label):
    assert evals.score_answer(text, label) == ref_evals.score_answer(text, label)


# -- rerankers and chats outside the answerers ---------------------------------------------


def test_cross_encoder_reranker_scores_equal_reference(models):
    docs = np.array(["the cat sat on the mat.", "a dog chased the ball.", "fish swim in the sea."] * 2, dtype=object)
    queries = np.array(["where is the cat"] * 3 + ["what swims"] * 3, dtype=object)
    for packed in (None, True, False):
        port = rerankers.CrossEncoderReranker(cross_encoder=models["port"]["ce"], packed=packed)
        ref = ref_rerankers.CrossEncoderReranker(cross_encoder=models["ref"]["ce"], packed=packed)
        assert port._predict_packed == ref._predict_packed
        np.testing.assert_allclose(port.func(docs, queries), ref.func(docs, queries), atol=TOL)


def test_encoder_reranker_scores_equal_reference(models):
    docs = np.array(["alpha beta", "gamma", "delta epsilon zeta"], dtype=object)
    queries = np.array(["alpha", "gamma", "zeta"], dtype=object)
    port = rerankers.EncoderReranker(models["port"]["emb"])
    ref = ref_rerankers.EncoderReranker(models["ref"]["emb"])
    np.testing.assert_allclose(port.func(docs, queries), ref.func(docs, queries), atol=TOL)


def test_llm_reranker_and_answerer_rules_equal_reference(models, fact_dir):
    chat = _CountingChat("cat")
    chat.func = lambda m: np.array(["I'd say 4 out of 5"] * len(m), dtype=object)
    assert rerankers.LLMReranker(chat).func("doc", "q") == ref_rerankers.LLMReranker(chat).func("doc", "q") == 4.0
    store = _store("port", models, fact_dir)
    with pytest.raises(ValueError, match="predict"):
        question_answering.BaseRAGQuestionAnswerer(chat, store, reranker=object())
    rag = question_answering.BaseRAGQuestionAnswerer(chat, store, search_topk=2,
                                                     reranker=models["port"]["ce"])
    assert rag.rerank_candidates == 8 and rag._rerank_packed is None


@pytest.mark.parametrize("name", ["FlashRankReranker", "ParseUnstructured", "HFPipelineChat"])
def test_gated_classes_raise_without_their_package(name):
    from pathway_tpu_torch.xpacks.llm import parsers

    cls = getattr(rerankers, name, None) or getattr(parsers, name, None) or getattr(llms, name)
    with pytest.raises(ImportError):
        cls()


@pytest.mark.parametrize("name", ["OpenAIChat", "LiteLLMChat", "CohereChat"])
def test_api_chats_raise_at_first_call_without_their_package(name):
    import asyncio

    for module in (ref_llms, llms):
        chat = getattr(module, name)()
        with pytest.raises(ImportError, match=name):
            asyncio.run(chat.func([{"role": "user", "content": "hi"}]))


def test_tpu_chat_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llms.TpuChat()


# -- the rest of the embedders and the parsers ------------------------------------------------

_CLIP = dict(dimension=32, proj_dim=16, n_layers=2, n_heads=4, image_size=32, patch=16, max_length=16, vocab_size=512)
_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + "the a cat dog sat on mat fish swim sea ##s".split()


@pytest.fixture(scope="module")
def clips():
    from pathway_tpu.models.clip import ClipModel as RefClip
    from pathway_tpu_torch.models.clip import ClipModel

    ref = RefClip(dtype=jnp.float32, **_CLIP)
    port = ClipModel(dtype=torch.float32, device="cpu", params=jax.tree_util.tree_map(np.asarray, ref.params), **_CLIP)
    return ref, port


def test_sentence_transformer_embedder_reads_an_hf_directory(tmp_path):
    """An HF text checkpoint directory goes through the port's
    ``models/hf_import.py``: the reference's encoder over the same
    directory gives the same rows (f32, 1e-5)."""
    from pathway_tpu.models.encoder import SentenceEncoder as RefEncoder
    from pathway_tpu_torch.models.hf_import import BertConfig, write_bert_checkpoint
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    d = str(tmp_path / "bert")
    write_bert_checkpoint(d, BertConfig(len(_VOCAB), 32, 2, 4, 64, 64), _VOCAB, seed=3)
    texts = np.array(["the cat sat on the mat", "fish swim", "dogs"], dtype=object)
    for kw in (dict(model=d), dict(checkpoint_path=d)):
        emb = SentenceTransformerEmbedder(device="cpu", **kw)
        np.testing.assert_allclose(emb.func(texts), RefEncoder(checkpoint_path=d).encode(list(texts)), atol=TOL)
        assert emb.get_embedding_dimension() == 32


@pytest.mark.parametrize("side", ["text", "image"])
def test_clip_embedders_equal_reference(clips, side):
    from pathway_tpu.xpacks.llm import embedders as ref_embedders
    from pathway_tpu_torch.xpacks.llm import embedders

    ref, port = clips
    name = "ClipTextEmbedder" if side == "text" else "ClipImageEmbedder"
    rng = np.random.default_rng(5)
    if side == "text":
        values = np.array(["a red square", "a blue circle", ""], dtype=object)
    else:
        values = np.empty(2, dtype=object)
        values[:] = [rng.random((32, 32, 3)).astype(np.float32), rng.random((40, 24, 3)).astype(np.float32)]
    got = getattr(embedders, name)(clip_model=port)
    want = getattr(ref_embedders, name)(clip_model=ref)
    np.testing.assert_allclose(got.func(values), want.func(values), atol=TOL)
    assert got.get_embedding_dimension() == want.get_embedding_dimension() == 16


_MARKDOWN = "intro line\n# Title\nbody one\n\n## Sub\nbody two\n#\nlast"


def _pdf_bytes():
    with open(os.path.join(REPO_ROOT, "templates", "sample_slides", "deck.pdf"), "rb") as f:
        return f.read()


@pytest.mark.parametrize(
    "name,kwargs,payload",
    [
        ("ParseMarkdown", {}, _MARKDOWN.encode()),
        ("PdfParser", {}, None),
        ("PdfParser", {"apply_text_cleanup": False}, None),
        ("PypdfParser", {}, None),
        ("SlideParser", {}, None),
        ("OpenParse", {}, None),
    ],
)
def test_text_parsers_equal_reference(name, kwargs, payload):
    from pathway_tpu.xpacks.llm import parsers as ref_parsers
    from pathway_tpu_torch.xpacks.llm import parsers

    data = payload if payload is not None else _pdf_bytes()
    got = getattr(parsers, name)(**kwargs).func(data)
    assert got == getattr(ref_parsers, name)(**kwargs).func(data)
    assert got and all(text for text, _meta in got)


def test_pdf_scanners_equal_reference():
    from pathway_tpu.xpacks.llm import parsers as ref_parsers
    from pathway_tpu_torch.xpacks.llm import parsers

    data = _pdf_bytes()
    assert parsers._pdf_extract_text(data) == ref_parsers._pdf_extract_text(data)
    got = list(parsers._pdf_slide_scan(data))
    assert got == list(ref_parsers._pdf_slide_scan(data))
    assert {kind for kind, _s, _p in got} == {"text", "image"}
    assert parsers._pdf_literal_string(rb"a\(b\)\\c\101\n") == ref_parsers._pdf_literal_string(rb"a\(b\)\\c\101\n")


def _image_parse(parsers_mod, clip, labels, path):
    with open(path, "rb") as f:
        data = f.read()
    return parsers_mod.ImageParser(downsize_to=32, labels=labels, clip_model=clip).func(data)


@pytest.mark.parametrize("labels", [None, ["red square", "blue circle", "green stripes"]], ids=["plain", "labels"])
@pytest.mark.parametrize("image", ["red_square.png", "blue_circle.png"])
def test_image_parser_equals_reference(clips, labels, image):
    """The decoded array is the reference's (PIL decode, resize, /255); the
    zero-shot labels come from the carried-over CLIP in f32."""
    from pathway_tpu.xpacks.llm import parsers as ref_parsers
    from pathway_tpu_torch.xpacks.llm import parsers

    ref, port = clips
    path = os.path.join(REPO_ROOT, "templates", "sample_images", image)
    (want_text, want_meta), = _image_parse(ref_parsers, ref, labels, path)
    (got_text, got_meta), = _image_parse(parsers, port, labels, path)
    np.testing.assert_array_equal(got_meta.pop("image"), want_meta.pop("image"))
    assert (got_text, got_meta) == (want_text, want_meta)


def test_slide_parser_with_clip_labels_equals_reference(clips):
    from pathway_tpu.xpacks.llm import parsers as ref_parsers
    from pathway_tpu_torch.xpacks.llm import parsers

    ref, port = clips
    labels = ["revenue chart", "team photo", "data table"]
    data = _pdf_bytes()
    got = parsers.SlideParser(labels=labels, clip_model=port, downsize_to=32, top_k_labels=2).func(data)
    want = ref_parsers.SlideParser(labels=labels, clip_model=ref, downsize_to=32, top_k_labels=2).func(data)
    assert got == want and any("labels" in meta for _t, meta in got)
    with pytest.raises(ValueError, match="parse_images"):
        parsers.OpenParse(parse_images=True)
    got = parsers.OpenParse(parse_images=True, labels=labels, clip_model=port, downsize_to=32).func(data)
    assert got == ref_parsers.OpenParse(parse_images=True, labels=labels, clip_model=ref, downsize_to=32).func(data)
