"""pw.xpacks.llm of the port — the LLM/RAG extension pack (counterpart of
``pathway_tpu/xpacks/llm``; reference inventory: python/pathway/xpacks/
llm/ — SURVEY.md §2.10): ``DocumentStore`` retrieval, embedders,
parsers, splitters, chat models (``llms.TpuChat`` over the port's
decode), rerankers, prompts, the RAG answerers (``question_answering``),
their REST servers (``servers``), ``VectorStoreServer`` /
``VectorStoreClient`` and the offline evaluation harness (``evals``)."""

from . import (
    embedders,
    evals,
    llms,
    parsers,
    prompts,
    question_answering,
    rerankers,
    servers,
    splitters,
)
from .document_store import DocumentStore
from .vector_store import VectorStoreClient, VectorStoreServer

__all__ = [
    "embedders",
    "evals",
    "llms",
    "parsers",
    "prompts",
    "question_answering",
    "rerankers",
    "servers",
    "splitters",
    "DocumentStore",
    "VectorStoreServer",
    "VectorStoreClient",
]
