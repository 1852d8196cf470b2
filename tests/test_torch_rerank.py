"""Port parity of the retrieve -> rerank pipeline on the CPU:
``RetrieveRerankPipeline`` of ``pathway_tpu_torch`` against
``pathway_tpu`` in the MaxSim, MaxSim -> cross-encoder cascade and
cross-encoder modes, over the exact and the IVF stage 1, with the same
encoder and cross-encoder weights (bridge) and the same documents.

Keys are compared position by position, a swap allowed only between
scores tied within 1e-5; scores within 1e-4 (f32 throughout).  The
reference's edge cases are held alike in both packages: candidates
missing from the forward index backfilled, an empty forward index
flagged ``late_interaction_skipped``, a cold forward index whose cascade
falls through to the cross-encoder, an incapable retriever refused at
construction, missing document text, a spent deadline.  Within the
port, a MaxSim serve books 2 dispatches + 2 fetches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.index import ForwardIndex as RefForward
from pathway_tpu.models.cross_encoder import CrossEncoderModel as RefCrossEncoder
from pathway_tpu.ops.ivf import IvfKnnIndex as RefIvf
from pathway_tpu.ops.knn import DeviceKnnIndex as RefKnn
from pathway_tpu.ops.retrieve_rerank import RetrieveRerankPipeline as RefPipeline
from pathway_tpu.ops.serving import FusedEncodeSearch as RefServe
from pathway_tpu.robust import Deadline as RefDeadline
from pathway_tpu_torch.index import ForwardIndex
from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel
from pathway_tpu_torch.ops import dispatch_counter
from pathway_tpu_torch.ops.ivf import IvfKnnIndex
from pathway_tpu_torch.ops.knn import DeviceKnnIndex
from pathway_tpu_torch.ops.retrieve_rerank import CrossEncoderStage, RetrieveRerankPipeline
from pathway_tpu_torch.ops.serving import FusedEncodeSearch
from pathway_tpu_torch.robust import Deadline

from .test_torch_forward import T_DOC, corpus, encoders
from .test_torch_ivf import assert_same_ranking


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_DOCS = 48
DOCS = dict(enumerate(corpus(N_DOCS, seed=11, lo=3, hi=26)))
QUERIES = [" ".join(DOCS[i].split()[::2]) for i in (3, 17, 30)] + ["kernel shard probe"]
CE = dict(dimension=32, n_layers=2, n_heads=4, max_length=64, vocab_size=512)


@pytest.fixture(scope="module")
def stack():
    ref_enc, enc = encoders()
    keys = sorted(DOCS)
    texts = [DOCS[k] for k in keys]
    vecs = ref_enc.encode(texts)
    ref_index = RefKnn(32, initial_capacity=64)
    ref_index.add(keys, vecs)
    index = DeviceKnnIndex(32, initial_capacity=64, device="cpu")
    index.add(keys, vecs)
    ref_fwd = RefForward(ref_enc, tokens_per_doc=T_DOC, initial_capacity=64)
    ref_fwd.add(keys, texts)
    fwd = ForwardIndex(enc, tokens_per_doc=T_DOC, initial_capacity=64)
    fwd.add(keys, texts)
    ref_ce = RefCrossEncoder(dtype=jnp.float32, **CE)
    ce = CrossEncoderModel(
        dtype=torch.float32, device="cpu", params=jax.tree_util.tree_map(np.asarray, ref_ce.params), **CE
    )
    return {
        "ref": (ref_enc, ref_index, ref_fwd, ref_ce),
        "port": (enc, index, fwd, ce),
    }


def _pipes(stack, mode, docs=DOCS, forward=None, ref_forward=None, **kw):
    """The reference's and the port's pipeline of one mode over the
    exact stage 1."""
    out = []
    for side, serve_cls, pipe_cls in (("ref", RefServe, RefPipeline), ("port", FusedEncodeSearch, RetrieveRerankPipeline)):
        enc, index, fwd, ce = stack[side]
        given = ref_forward if side == "ref" else forward
        fwd = fwd if given is None else given
        sk = {"embed_cache": None} if side == "ref" else {}
        args = {"k": 5, "candidates": 16, **kw}
        if mode in ("maxsim", "cascade"):
            args["forward_index"] = fwd
        if mode == "cascade":
            args.setdefault("cascade", 8)
        out.append(pipe_cls(serve_cls(enc, index, k=8, **sk), ce, docs, **args))
    return out


def assert_same_serve(want, got):
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert_same_ranking(list(w), list(g))
    assert got.degraded == want.degraded
    for key in ("forward_missing", "missing_docs", "degraded_reasons"):
        assert sorted(got.meta.get(key, ())) == sorted(want.meta.get(key, ())), key


@pytest.mark.parametrize("mode", ["maxsim", "cascade", "cross_encoder"])
def test_pipeline_matches_reference(stack, mode):
    ref, port = _pipes(stack, mode)
    want, got = ref(QUERIES), port(QUERIES)
    assert got.ok and all(len(row) == 5 for row in got)
    assert_same_serve(want, got)
    # k wider than the final stage's pool: every candidate, reranked
    assert_same_serve(ref(QUERIES[:1], k=64), port(QUERIES[:1], k=64))


def test_maxsim_over_ivf_matches_reference(stack):
    """The main path's shape: IVF stage 1 (the rescore kernel's plain
    version here) with the query token export, then MaxSim."""
    (ref_enc, _, ref_fwd, _), (enc, _, fwd, _) = stack["ref"], stack["port"]
    keys = sorted(DOCS)
    ref_ivf = RefIvf(32, n_clusters=4, seed=3)
    ref_ivf.add(keys, ref_enc.encode([DOCS[k] for k in keys]))
    ref_ivf.build()
    ivf = IvfKnnIndex(32, n_clusters=4, seed=3, device="cpu")
    ivf.load_warm_state(ref_ivf.warm_state())
    ref = RefPipeline(RefServe(ref_enc, ref_ivf, k=8, embed_cache=None), doc_text=DOCS, k=5, candidates=12, forward_index=ref_fwd)
    port = RetrieveRerankPipeline(FusedEncodeSearch(enc, ivf, k=8), doc_text=DOCS, k=5, candidates=12, forward_index=fwd)
    assert_same_serve(ref(QUERIES), port(QUERIES))


def test_missing_docs_backfilled_as_reference(stack):
    """Half the documents in the forward index: resident candidates lead
    (MaxSim-ranked), the others backfill in stage-1 order; no rung."""
    (ref_enc, _, _, _), (enc, _, _, _) = stack["ref"], stack["port"]
    resident = sorted(DOCS)[::2]
    half_ref = RefForward(ref_enc, tokens_per_doc=T_DOC, initial_capacity=64)
    half_ref.add(resident, [DOCS[k] for k in resident])
    half = ForwardIndex(enc, tokens_per_doc=T_DOC, initial_capacity=64)
    half.add(resident, [DOCS[k] for k in resident])
    ref, port = _pipes(stack, "maxsim", forward=half, ref_forward=half_ref)
    want, got = ref(QUERIES, k=14), port(QUERIES, k=14)
    assert got.ok and got.meta["forward_missing"]
    assert_same_serve(want, got)
    missing = set(got.meta["forward_missing"])
    keys = [k for k, _ in got[0]]
    first = min(i for i, k in enumerate(keys) if k in missing)
    assert all(k in missing for k in keys[first:]) and not missing & set(resident)


def test_empty_forward_index_flagged_as_reference(stack):
    (ref_enc, _, _, _), (enc, _, _, _) = stack["ref"], stack["port"]
    ref, port = _pipes(
        stack, "maxsim", forward=ForwardIndex(enc, tokens_per_doc=T_DOC),
        ref_forward=RefForward(ref_enc, tokens_per_doc=T_DOC),
    )
    want, got = ref(QUERIES), port(QUERIES)
    assert got.degraded == ("late_interaction_skipped",)
    assert got.meta["degraded_reasons"] == ["late_interaction_skipped"]
    assert_same_serve(want, got)
    assert got == [list(row[:5]) for row in port.retriever(QUERIES, port.candidates)]


def test_cold_forward_cascade_falls_through_as_reference(stack):
    (ref_enc, _, _, _), (enc, _, _, _) = stack["ref"], stack["port"]
    ref, port = _pipes(
        stack, "cascade", forward=ForwardIndex(enc, tokens_per_doc=T_DOC),
        ref_forward=RefForward(ref_enc, tokens_per_doc=T_DOC), k=4,
    )
    want, got = ref(QUERIES), port(QUERIES)
    assert got.degraded == ("late_interaction_skipped",)
    assert_same_serve(want, got)
    _, ce_only = _pipes(stack, "cross_encoder", k=4, candidates=8)
    assert [list(r) for r in got] == [list(r) for r in ce_only(QUERIES)]
    # the same cascade tail through an explicit stage list
    enc, index, _, ce = stack["port"]
    explicit = RetrieveRerankPipeline(
        FusedEncodeSearch(enc, index, k=8), ce, DOCS, k=4, stages=[CrossEncoderStage(candidates=8)]
    )
    assert explicit.candidates == 8 and explicit(QUERIES) == ce_only(QUERIES)


def test_incapable_retriever_refused(stack):
    _, _, fwd, _ = stack["port"]

    class DuckRetriever:
        def submit(self, texts, k):
            raise AssertionError("never served")

    with pytest.raises(ValueError, match="query token states"):
        RetrieveRerankPipeline(DuckRetriever(), doc_text=DOCS, forward_index=fwd)
    with pytest.raises(ValueError, match="cross_encoder"):
        RetrieveRerankPipeline(DuckRetriever(), doc_text=DOCS)


def test_missing_doc_text_and_spent_deadline_as_reference(stack):
    ref, port = _pipes(stack, "cross_encoder", docs={k: v for k, v in DOCS.items() if k % 3}, k=3)
    want, got = ref(QUERIES), port(QUERIES)
    assert got.ok and got.meta["missing_docs"]
    assert_same_serve(want, got)
    # a deadline already spent: stage 1 refuses, empty rows flagged
    want = ref(QUERIES, deadline=RefDeadline(0.0))
    got = port(QUERIES, deadline=Deadline(0.0))
    assert got.degraded == want.degraded == ("retrieval_failed",)
    assert got == want == [[] for _ in QUERIES]
    _, spent = _pipes(stack, "cross_encoder", deadline_ms=1e-6)  # the pipeline's own budget
    assert spent(QUERIES).degraded == ("retrieval_failed",)
    ref_p, port_p = _pipes(stack, "maxsim")
    assert ref_p([]) == port_p([]) == []


def test_dispatch_budget_and_pipelining(stack):
    """Within the port: a MaxSim serve is 2 dispatches + 2 fetches, the
    cascade one more of each; overlapped handles serve what sequential
    calls serve."""
    _, pipe = _pipes(stack, "maxsim")
    with dispatch_counter.DispatchCounter() as counter:
        got = pipe(QUERIES)
    assert got.ok and (counter.dispatches, counter.fetches) == (2, 2), counter.events
    assert [tag for _, tag in counter.events] == ["serve_exact", "serve_exact", "rerank_maxsim", "rerank_maxsim"]
    _, cascade = _pipes(stack, "cascade")
    with dispatch_counter.DispatchCounter() as counter:
        cascade(QUERIES)
    assert (counter.dispatches, counter.fetches) == (3, 3), counter.events
    handles = [pipe.submit([q]) for q in QUERIES]
    for h in handles:
        h.advance()
    assert [h() for h in handles] == [pipe([q]) for q in QUERIES]
