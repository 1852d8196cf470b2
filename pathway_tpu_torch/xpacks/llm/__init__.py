"""pw.xpacks.llm of the port (counterpart of ``pathway_tpu/xpacks/llm``).

Ported: ``DocumentStore`` retrieval, ``embedders.TpuEmbedder``,
``splitters`` and ``parsers.ParseUtf8``.  Question answering, LLM chat,
rerankers, prompts, servers and the vector-store client are the next
slice (``ROADMAP.md``)."""

from . import embedders, parsers, splitters
from .document_store import DocumentStore

__all__ = ["embedders", "parsers", "splitters", "DocumentStore"]
