"""RAG question answering of the port (counterpart of
``pathway_tpu/xpacks/llm/question_answering.py``; reference:
xpacks/llm/question_answering.py — BaseRAGQuestionAnswerer :314,
AdaptiveRAGQuestionAnswerer :622, answer_with_geometric_rag_strategy
:97/:162 — geometric document-count growth bounds LLM token cost).

The answerers run over the port's ``DocumentStore``, its rerankers and
chat models; ``RAGClient`` speaks HTTP through ``urllib.request``."""

from __future__ import annotations

import asyncio
import inspect
import json
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from ...internals import dtype as dt
from ...internals.expression import ApplyExpression
from ...internals.schema import Schema, column_definition
from ...internals.table import Table
from ...internals.thisclass import this
from ...robust import (
    EXTRACTIVE_ANSWER,
    RERANK_SKIPPED,
    RetryPolicy,
    breaker as robust_breaker,
    extractive_answer,
    inject,
    log_once,
    record_degraded,
    retry_call,
)

# the wrapped reranker's predict() owns its own dispatch retries when it
# is a CrossEncoderModel (the "cross_encoder.dispatch" site): one outer
# attempt keeps the "qa.rerank" breaker gate + fault site without
# multiplying attempt budgets or triple-counting breaker failures
_QA_RERANK_RETRY = RetryPolicy(attempts=1)
from ...io.http import post_json
from .document_store import DocumentStore
from .prompts import prompt_qa, prompt_qa_geometric_rag, prompt_summarize

__all__ = [
    "BaseQuestionAnswerer",
    "BaseRAGQuestionAnswerer",
    "AdaptiveRAGQuestionAnswerer",
    "DeckRetriever",
    "RAGClient",
    "answer_with_geometric_rag_strategy",
    "answer_with_geometric_rag_strategy_from_index",
]

NO_ANSWER = "No information found."


def _call_chat(llm, prompt) -> str:
    """Call a chat UDF's underlying function synchronously — ``prompt`` is
    either a plain string or a prepared messages list (vision parsers pass
    multi-part content through here too)."""
    fn = llm.func
    messages = (
        prompt
        if isinstance(prompt, list)
        else [{"role": "user", "content": prompt}]
    )
    if inspect.iscoroutinefunction(fn):
        return str(asyncio.run(fn(messages)))
    if getattr(llm, "batched", False):
        arr = np.empty(1, dtype=object)
        arr[0] = messages
        return str(fn(arr)[0])
    return str(fn(messages))


def answer_with_geometric_rag_strategy(
    question: str,
    documents: Sequence[str],
    llm,
    n_starting_documents: int = 2,
    factor: int = 2,
    max_iterations: int = 4,
    strict_prompt: bool = False,
) -> str:
    """Ask with 2, 4, 8, ... docs until the model finds an answer
    (reference: question_answering.py:97 — the Adaptive RAG loop giving ~4x
    token-cost reduction, docs/.adaptive-rag/article.py:28)."""
    documents = list(documents)
    n = n_starting_documents
    for _ in range(max_iterations):
        docs = documents[:n]
        prompt = prompt_qa_geometric_rag(
            question, docs, information_not_found_response=NO_ANSWER
        )
        answer = _call_chat(llm, prompt)
        if answer and NO_ANSWER.lower() not in answer.lower():
            return answer
        if n >= len(documents):
            break
        n *= factor
    return NO_ANSWER


def answer_with_geometric_rag_strategy_from_index(
    question_column,
    index,
    documents_column_name: str,
    llm,
    n_starting_documents: int = 2,
    factor: int = 2,
    max_iterations: int = 4,
    **kwargs,
):
    """(reference: question_answering.py:162) — retrieve max docs once, then
    run the geometric loop per row."""
    max_docs = n_starting_documents * factor ** (max_iterations - 1)
    result = index.query_as_of_now(question_column, number_of_matches=max_docs)
    docs_table = result.select(
        _pw_question=question_column,
        _pw_docs=getattr(index.data_table, documents_column_name),
    )
    return docs_table.select(
        result=ApplyExpression(
            lambda q, docs: answer_with_geometric_rag_strategy(
                q, list(docs or ()), llm, n_starting_documents, factor, max_iterations
            ),
            dt.STR,
            args=(this._pw_question, this._pw_docs),
        )
    )


class BaseQuestionAnswerer:
    AnswerQuerySchema: type
    RetrieveQuerySchema: type
    StatisticsQuerySchema: type
    InputsQuerySchema: type


class BaseRAGQuestionAnswerer(BaseQuestionAnswerer):
    """(reference: question_answering.py:314) — answer/summarize/retrieve
    endpoints over a DocumentStore + chat model."""

    class AnswerQuerySchema(Schema):
        prompt: str
        filters: Optional[str] = column_definition(default_value=None)
        model: Optional[str] = column_definition(default_value=None)
        return_context_docs: bool = column_definition(default_value=False)

    class SummarizeQuerySchema(Schema):
        text_list: Any
        model: Optional[str] = column_definition(default_value=None)

    RetrieveQuerySchema = DocumentStore.RetrieveQuerySchema
    StatisticsQuerySchema = DocumentStore.StatisticsQuerySchema
    InputsQuerySchema = DocumentStore.InputsQuerySchema

    def __init__(
        self,
        llm,
        indexer: DocumentStore,
        *,
        default_llm_name: Optional[str] = None,
        search_topk: int = 6,
        prompt_template: Callable[[str, Sequence[str]], str] = prompt_qa,
        reranker=None,
        rerank_candidates: Optional[int] = None,
        coalesce_rerank: Optional[bool] = None,
    ):
        """``reranker`` plugs a second ranking stage between retrieval and
        the LLM prompt (the multi-stage ranking architecture from
        PAPERS.md): a ``CrossEncoderModel`` (or anything with
        ``predict(pairs) -> scores``, e.g. a sentence_transformers
        CrossEncoder) or a ``CrossEncoderReranker`` UDF.  Retrieval then
        over-fetches ``rerank_candidates`` docs (default 4x ``search_topk``)
        and the reranker's packed pair scoring keeps the best
        ``search_topk`` — the same retrieve→rerank shape the fused
        ``ops.RetrieveRerankPipeline`` serves at two device round trips.

        ``coalesce_rerank`` (default: ``PATHWAY_QA_RERANK_COALESCE`` env,
        off) routes the per-row pair scoring through a
        ``serve.SharedBatcher``: concurrent QA rows' (question, doc)
        pairs coalesce into ONE packed cross-encoder dispatch inside the
        ``PATHWAY_SERVE_COALESCE_US`` window instead of each row paying
        its own device round trip — the same continuous cross-request
        batching the serve scheduler applies to retrieval."""
        self.llm = llm
        self.indexer = indexer
        self.search_topk = search_topk
        self.prompt_template = prompt_template
        self.reranker = reranker
        # resolve the predict-capable object ONCE: a constructor-time error
        # beats an AttributeError per row deep inside the dataflow UDF
        if reranker is None:
            self._rerank_model = None
        else:
            model = (
                reranker
                if callable(getattr(reranker, "predict", None))
                else getattr(reranker, "_model", None)
            )
            if not callable(getattr(model, "predict", None)):
                raise ValueError(
                    "reranker must expose predict(pairs) -> scores (a "
                    "CrossEncoderModel, a sentence_transformers "
                    "CrossEncoder, or a CrossEncoderReranker wrapping one)"
                    f"; got {type(reranker).__name__}"
                )
            self._rerank_model = model
        # a CrossEncoderReranker carries an explicit packed= choice; honor
        # it here too, not just on its own dataflow scoring path (non-None
        # only when the wrapped model's predict takes packed)
        self._rerank_packed = getattr(reranker, "_predict_packed", None)
        # cross-request rerank coalescing: concurrent QA rows share one
        # packed cross-encoder dispatch through a SharedBatcher fronting
        # the model's submit/complete contract
        if coalesce_rerank is None:
            from ... import config

            coalesce_rerank = config.get("qa.rerank_coalesce")
        self._rerank_batcher = None
        if (
            coalesce_rerank
            and self._rerank_model is not None
            and callable(getattr(self._rerank_model, "submit", None))
        ):
            from ... import observe
            from ...serve import SharedBatcher

            model = self._rerank_model
            packed = self._rerank_packed
            if packed is None:
                submit_fn = model.submit
            else:
                def submit_fn(items, deadline=None, _m=model, _p=packed):
                    return _m.submit(items, packed=_p, deadline=deadline)

            # per-instance name: two QA answerers must not collide into
            # one Prometheus label set (duplicate samples fail the scrape)
            self._rerank_batcher = SharedBatcher(
                submit_fn, name=f"qa-rerank-{observe.next_id()}"
            )
        # without a reranker there is no second stage to over-fetch for:
        # retrieval stays at search_topk even if rerank_candidates is set
        self.rerank_candidates = (
            (rerank_candidates or 4 * search_topk)
            if reranker is not None
            else search_topk
        )
        # per-model circuit breakers (robust/retry.py), shared process-
        # wide: the "cross_encoder" breaker is the same one the fused
        # RetrieveRerankPipeline feeds, so a reranker persistently down
        # under EITHER surface fast-paths both to the rerank_skipped
        # rung; the "generator" breaker gates the LLM chat calls
        self._rerank_breaker = robust_breaker("cross_encoder")
        self._llm_breaker = robust_breaker("generator")
        self.server = None

    def _rerank_docs(
        self,
        question: str,
        docs: list,
        keep: Optional[int] = None,
        flags: Optional[list] = None,
    ) -> list:
        """Reorder retrieved doc dicts by cross-encoder pair score and keep
        the best ``keep`` (default ``search_topk``); no-op without a
        reranker.

        Degradation ladder: a reranker failure (after its retry budget,
        or an open circuit) serves the RETRIEVAL ordering instead —
        flagged through ``flags``, counted on
        ``pathway_serve_degraded_total{reason="rerank_skipped"}`` — and
        never sinks the answer."""
        if self._rerank_model is None or not docs:
            return docs
        model = self._rerank_model
        pairs = [(question, str(d.get("text", ""))) for d in docs]
        try:
            if self._rerank_batcher is not None:
                # coalesced path: this row's pairs ride a shared packed
                # dispatch with every other row in the window (a batch
                # failure re-raises here and lands on the same ladder)
                raw = retry_call(
                    "qa.rerank", self._rerank_batcher.score, pairs,
                    policy=_QA_RERANK_RETRY,
                    breaker=self._rerank_breaker,
                )
            elif self._rerank_packed is None:
                raw = retry_call(
                    "qa.rerank", model.predict, pairs,
                    policy=_QA_RERANK_RETRY,
                    breaker=self._rerank_breaker,
                )
            else:
                raw = retry_call(
                    "qa.rerank", model.predict, pairs,
                    packed=self._rerank_packed,
                    policy=_QA_RERANK_RETRY,
                    breaker=self._rerank_breaker,
                )
            scores = np.asarray(raw, dtype=np.float64)
        except Exception as exc:
            log_once(
                f"qa.rerank:{type(exc).__name__}",
                "QA reranker failed (%r); serving retrieval order flagged "
                "rerank_skipped",
                exc,
            )
            record_degraded(RERANK_SKIPPED)
            if flags is not None:
                flags.append(RERANK_SKIPPED)
            return docs[: keep or self.search_topk]
        order = np.argsort(-scores, kind="stable")[: keep or self.search_topk]
        out = []
        for j in order:
            d = dict(docs[int(j)])
            d["rerank_score"] = float(scores[int(j)])
            out.append(d)
        return out

    def _chat_or_extract(
        self, question: str, doc_texts: Sequence[str], chat, flags=None
    ) -> str:
        """Run ``chat()`` (the LLM call) under the "generator" circuit
        breaker.  Generator down / circuit open ⇒ the ladder's last
        answer-bearing rung: an extractive answer from the top retrieved
        passages, flagged + counted — the QA surface keeps answering
        with grounded text instead of erroring."""
        b = self._llm_breaker
        if b.allow():
            try:
                inject.fire("generator.chat")
                response = chat()
            except Exception as exc:
                b.record_failure()
                log_once(
                    f"generator.chat:{type(exc).__name__}",
                    "LLM chat failed (%r); answering extractively from the "
                    "retrieved passages",
                    exc,
                )
            else:
                b.record_success()
                return response
        record_degraded(EXTRACTIVE_ANSWER)
        if flags is not None:
            flags.append(EXTRACTIVE_ANSWER)
        return extractive_answer(question, list(doc_texts))

    # -- dataflow endpoints -------------------------------------------------
    def answer_query(self, queries: Table) -> Table:
        """prompt -> retrieve -> (rerank) -> build prompt -> chat -> answer."""
        topk = self.rerank_candidates
        store = self.indexer
        enriched = queries.select(
            query=this.prompt,
            k=ApplyExpression(lambda *_: topk, dt.INT, args=()),
            metadata_filter=this.filters,
            filepath_globpattern=ApplyExpression(lambda *_: None, dt.ANY, args=()),
        )
        retrieved = store.retrieve_query(enriched)
        llm = self.llm
        template = self.prompt_template
        rerank = self._rerank_docs
        chat_or_extract = self._chat_or_extract

        def answer(prompt, docs, return_docs):
            flags: list = []
            docs = rerank(prompt, list(docs or []), flags=flags)
            doc_texts = [d["text"] for d in docs]
            response = chat_or_extract(
                prompt,
                doc_texts,
                lambda: _call_chat(llm, template(prompt, doc_texts)),
                flags=flags,
            )
            if return_docs:
                out = {"response": response, "context_docs": docs}
                if flags:
                    # ladder visibility: which degraded rungs served this
                    # answer (rerank_skipped / extractive_answer)
                    out["degraded"] = flags
                return out
            return response

        combined = queries.select(
            _pw_prompt=this.prompt,
            _pw_return=this.return_context_docs,
            _pw_docs=retrieved.result,
        )
        return combined.select(
            result=ApplyExpression(
                answer, dt.ANY, args=(this._pw_prompt, this._pw_docs, this._pw_return)
            )
        )

    def summarize_query(self, queries: Table) -> Table:
        llm = self.llm

        def summarize(text_list):
            if isinstance(text_list, str):
                text_list = [text_list]
            return _call_chat(llm, prompt_summarize(list(text_list or [])))

        return queries.select(
            result=ApplyExpression(summarize, dt.STR, args=(this.text_list,))
        )

    def retrieve(self, queries: Table) -> Table:
        return self.indexer.retrieve_query(queries)

    def statistics(self, queries: Table) -> Table:
        return self.indexer.statistics_query(queries)

    def list_documents(self, queries: Table) -> Table:
        return self.indexer.inputs_query(queries)

    # -- serving ------------------------------------------------------------
    def build_server(self, host: str, port: int, **kwargs) -> None:
        """(reference: question_answering.py build_server)"""
        from .servers import QASummaryRestServer

        self.server = QASummaryRestServer(host, port, self, **kwargs)

    def run_server(self, threaded: bool = False, with_cache: bool = True, **kwargs):
        if self.server is None:
            raise RuntimeError("call build_server(host, port) first")
        return self.server.run(threaded=threaded, with_cache=with_cache, **kwargs)


class AdaptiveRAGQuestionAnswerer(BaseRAGQuestionAnswerer):
    """(reference: question_answering.py:622) — geometric context growth."""

    def __init__(
        self,
        llm,
        indexer: DocumentStore,
        *,
        n_starting_documents: int = 2,
        factor: int = 2,
        max_iterations: int = 4,
        strict_prompt: bool = False,
        **kwargs,
    ):
        super().__init__(llm, indexer, **kwargs)
        self.n_starting_documents = n_starting_documents
        self.factor = factor
        self.max_iterations = max_iterations
        self.strict_prompt = strict_prompt

    def answer_query(self, queries: Table) -> Table:
        max_docs = self.n_starting_documents * self.factor ** (
            self.max_iterations - 1
        )
        store = self.indexer
        enriched = queries.select(
            query=this.prompt,
            k=ApplyExpression(lambda *_: max_docs, dt.INT, args=()),
            metadata_filter=this.filters,
            filepath_globpattern=ApplyExpression(lambda *_: None, dt.ANY, args=()),
        )
        retrieved = store.retrieve_query(enriched)
        llm = self.llm
        n0, factor, iters = self.n_starting_documents, self.factor, self.max_iterations
        rerank = self._rerank_docs
        chat_or_extract = self._chat_or_extract

        def answer(prompt, docs):
            # rerank BEFORE the geometric loop: adaptive RAG answers from
            # the first n docs, so cross-encoder ordering directly buys
            # one-round answers (reorder only — the loop needs the full
            # candidate list to grow into)
            docs = rerank(prompt, list(docs or []), keep=len(docs or []))
            doc_texts = [d["text"] for d in docs]
            return chat_or_extract(
                prompt,
                doc_texts,
                lambda: answer_with_geometric_rag_strategy(
                    prompt, doc_texts, llm, n0, factor, iters
                ),
            )

        combined = queries.select(
            _pw_prompt=this.prompt, _pw_docs=retrieved.result
        )
        return combined.select(
            result=ApplyExpression(
                answer, dt.STR, args=(this._pw_prompt, this._pw_docs)
            )
        )


class DeckRetriever(BaseQuestionAnswerer):
    """Slide-deck search server (reference: question_answering.py:738) —
    ``answer_query`` returns the top slides for a prompt instead of an LLM
    answer; serves the same QA REST surface so clients and templates treat
    it like any question answerer."""

    excluded_response_metadata = ["b64_image", "image"]

    class AnswerQuerySchema(Schema):
        prompt: str
        filters: Optional[str] = column_definition(default_value=None)

    RetrieveQuerySchema = DocumentStore.RetrieveQuerySchema
    StatisticsQuerySchema = DocumentStore.StatisticsQuerySchema
    InputsQuerySchema = DocumentStore.InputsQuerySchema

    def __init__(self, indexer: DocumentStore, *, search_topk: int = 6):
        self.indexer = indexer
        self.search_topk = search_topk
        self.server = None

    def answer_query(self, queries: Table) -> Table:
        """Return slides matching the prompt (no LLM in the loop)."""
        topk = self.search_topk
        store = self.indexer
        enriched = queries.select(
            query=this.prompt,
            k=ApplyExpression(lambda *_: topk, dt.INT, args=()),
            metadata_filter=this.filters,
            filepath_globpattern=ApplyExpression(lambda *_: None, dt.ANY, args=()),
        )
        retrieved = store.retrieve_query(enriched)
        drop = set(self.excluded_response_metadata)

        def strip(docs):
            out = []
            for d in docs or []:
                d = dict(d)
                meta = d.get("metadata")
                if isinstance(meta, dict):
                    d["metadata"] = {
                        k: v for k, v in meta.items() if k not in drop
                    }
                out.append(d)
            return out

        return retrieved.select(
            result=ApplyExpression(strip, dt.ANY, args=(this.result,))
        )

    def retrieve(self, queries: Table) -> Table:
        return self.indexer.retrieve_query(queries)

    def statistics(self, queries: Table) -> Table:
        return self.indexer.statistics_query(queries)

    def list_documents(self, queries: Table) -> Table:
        return self.indexer.inputs_query(queries)

    def build_server(self, host: str, port: int, **kwargs) -> None:
        from .servers import QARestServer

        self.server = QARestServer(host, port, self, **kwargs)

    def run_server(self, threaded: bool = False, with_cache: bool = True, **kwargs):
        if self.server is None:
            raise RuntimeError("call build_server(host, port) first")
        return self.server.run(threaded=threaded, with_cache=with_cache, **kwargs)


class RAGClient:
    """HTTP client for the QA servers (reference: question_answering.py RAGClient)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000, url: Optional[str] = None):
        self.url = url or f"http://{host}:{port}"

    def _post(self, route: str, payload: dict):
        return post_json(self.url + route, payload, timeout=120)

    def answer(self, prompt: str, filters: Optional[str] = None, **kwargs):
        return self._post(
            "/v1/pw_ai_answer", {"prompt": prompt, "filters": filters, **kwargs}
        )

    pw_ai_answer = answer

    def summarize(self, text_list: List[str], **kwargs):
        return self._post("/v1/pw_ai_summary", {"text_list": text_list, **kwargs})

    pw_ai_summary = summarize

    def retrieve(self, query: str, k: int = 3, metadata_filter=None, filepath_globpattern=None):
        return self._post(
            "/v1/retrieve",
            {
                "query": query,
                "k": k,
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
        )

    def statistics(self):
        return self._post("/v1/statistics", {})

    def list_documents(self, metadata_filter=None, filepath_globpattern=None):
        return self._post(
            "/v1/pw_list_documents",
            {
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
        )
