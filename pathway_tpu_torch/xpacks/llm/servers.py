"""REST servers for RAG apps of the port (counterpart of
``pathway_tpu/xpacks/llm/servers.py``; reference: xpacks/llm/
servers.py:16-291 — BaseRestServer, QARestServer, QASummaryRestServer,
DocumentStoreServer, serve_callable), over the port's standard-library
REST connector (``io/http``)."""

from __future__ import annotations

import threading
from typing import Callable, Optional, Type

from ...internals import run as run_mod
from ...internals.schema import Schema
from ...io.http import EndpointDocumentation, PathwayWebserver, rest_connector

__all__ = [
    "BaseRestServer",
    "QARestServer",
    "QASummaryRestServer",
    "DocumentStoreServer",
    "serve_callable",
]


class BaseRestServer:
    def __init__(self, host: str, port: int, with_cors: bool = False, **kwargs):
        self.webserver = PathwayWebserver(host=host, port=port, with_cors=with_cors)

    def serve(
        self,
        route: str,
        schema: Type[Schema],
        handler: Callable,
        documentation: Optional[EndpointDocumentation] = None,
        methods=("POST",),
        **kwargs,
    ) -> None:
        """Wire route -> handler(queries_table) -> response writer
        (reference: servers.py:25-90)."""
        queries, writer = rest_connector(
            webserver=self.webserver,
            route=route,
            schema=schema,
            methods=methods,
            delete_completed_queries=True,
            documentation=documentation,
        )
        writer(handler(queries))

    def run(
        self,
        threaded: bool = False,
        with_cache: bool = True,
        cache_backend=None,
        terminate_on_error: bool = False,
        **kwargs,
    ):
        """Start the engine (and so the server).  threaded=True runs the
        dataflow on a daemon thread (reference: run_server(threaded=True))."""
        if threaded:
            t = threading.Thread(
                target=lambda: run_mod.run(monitoring_level=None), daemon=True
            )
            t.start()
            return t
        run_mod.run(monitoring_level=None)


class QARestServer(BaseRestServer):
    """(reference: servers.py:92) — routes for a BaseRAGQuestionAnswerer."""

    def __init__(self, host: str, port: int, rag_question_answerer, **kwargs):
        super().__init__(host, port, **kwargs)
        self.serve(
            "/v1/pw_ai_answer",
            rag_question_answerer.AnswerQuerySchema,
            rag_question_answerer.answer_query,
            EndpointDocumentation(summary="Answer a question over the live index"),
        )
        self.serve(
            "/v1/retrieve",
            rag_question_answerer.RetrieveQuerySchema,
            rag_question_answerer.retrieve,
            EndpointDocumentation(summary="Retrieve documents"),
        )
        self.serve(
            "/v1/statistics",
            rag_question_answerer.StatisticsQuerySchema,
            rag_question_answerer.statistics,
            EndpointDocumentation(summary="Indexed-document statistics"),
        )
        self.serve(
            "/v1/pw_list_documents",
            rag_question_answerer.InputsQuerySchema,
            rag_question_answerer.list_documents,
            EndpointDocumentation(summary="List indexed input documents"),
        )


class QASummaryRestServer(QARestServer):
    """(reference: servers.py:140) — adds the summarize route."""

    def __init__(self, host: str, port: int, rag_question_answerer, **kwargs):
        super().__init__(host, port, rag_question_answerer, **kwargs)
        self.serve(
            "/v1/pw_ai_summary",
            rag_question_answerer.SummarizeQuerySchema,
            rag_question_answerer.summarize_query,
            EndpointDocumentation(summary="Summarize a list of texts"),
        )


class DocumentStoreServer(BaseRestServer):
    """(reference: servers.py:193) — REST facade over a DocumentStore."""

    def __init__(self, host: str, port: int, document_store, **kwargs):
        super().__init__(host, port, **kwargs)
        self.serve(
            "/v1/retrieve",
            document_store.RetrieveQuerySchema,
            document_store.retrieve_query,
            EndpointDocumentation(summary="Retrieve documents"),
        )
        self.serve(
            "/v1/statistics",
            document_store.StatisticsQuerySchema,
            document_store.statistics_query,
            EndpointDocumentation(summary="Index statistics"),
        )
        self.serve(
            "/v1/inputs",
            document_store.InputsQuerySchema,
            document_store.inputs_query,
            EndpointDocumentation(summary="List input documents"),
        )


def serve_callable(
    route: str,
    schema: Type[Schema],
    host: str = "0.0.0.0",
    port: int = 8080,
    callable_func: Optional[Callable] = None,
    **kwargs,
):
    """Expose an ad-hoc python callable as a REST endpoint
    (reference: servers.py:227).  Use as a decorator or pass callable_func."""

    def decorate(func: Callable):
        from ...internals import udfs
        from ...internals.thisclass import this

        server = BaseRestServer(host, port, **kwargs)
        udf_obj = udfs.udf(func)

        def handler(queries):
            cols = {c: getattr(this, c) for c in schema.column_names()}
            return queries.select(result=udf_obj(**cols))

        server.serve(route, schema, handler)
        return server

    if callable_func is not None:
        return decorate(callable_func)
    return decorate
