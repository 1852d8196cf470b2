"""VectorStoreServer of the port — self-contained
docs->parse->split->embed->KNN server (counterpart of
``pathway_tpu/xpacks/llm/vector_store.py``; reference:
xpacks/llm/vector_store.py:38-747 — VectorStoreServer with /v1/retrieve,
/v1/statistics, /v1/inputs endpoints, VectorStoreClient,
Langchain/LlamaIndex adapters).  ``VectorStoreClient`` speaks HTTP
through ``urllib.request``."""

from __future__ import annotations

from typing import List, Optional

from ...internals.table import Table
from ...io.http import post_json
from ...stdlib.indexing.nearest_neighbors import TpuKnnFactory
from .document_store import DocumentStore
from .servers import DocumentStoreServer

__all__ = ["VectorStoreServer", "VectorStoreClient"]


class VectorStoreServer:
    def __init__(
        self,
        *docs: Table,
        embedder=None,
        parser=None,
        splitter=None,
        doc_post_processors=None,
        index_factory=None,
    ):
        if embedder is None and index_factory is None:
            from .embedders import TpuEmbedder

            embedder = TpuEmbedder()
        if index_factory is None:
            index_factory = TpuKnnFactory(
                dimension=embedder.get_embedding_dimension(), embedder=embedder
            )
        self.document_store = DocumentStore(
            list(docs),
            retriever_factory=index_factory,
            parser=parser,
            splitter=splitter,
            doc_post_processors=doc_post_processors,
            embedder=embedder,
        )
        self._server: Optional[DocumentStoreServer] = None

    @classmethod
    def from_langchain_components(
        cls, *docs, embedder=None, splitter=None, **kwargs
    ) -> "VectorStoreServer":
        """(reference: vector_store.py:418) — langchain embeddings/splitters."""
        parser = None
        sp = None
        if splitter is not None:
            from ...internals.udfs import UDF

            sp = UDF(lambda text: [(chunk, {}) for chunk in splitter.split_text(text)])
        emb = None
        if embedder is not None:
            import numpy as np

            from .embedders import BaseEmbedder

            class _LCEmbedder(BaseEmbedder):
                def __init__(self):
                    def embed(texts):
                        vectors = embedder.embed_documents([str(t) for t in texts])
                        return np.asarray(vectors, dtype=np.float32)

                    super().__init__(embed, batched=True)

            emb = _LCEmbedder()
        return cls(*docs, embedder=emb, parser=parser, splitter=sp, **kwargs)

    @classmethod
    def from_llamaindex_components(cls, *docs, transformations=None, **kwargs):
        """(reference: vector_store.py:456)"""
        raise NotImplementedError(
            "llamaindex adapter: wrap your embed_model as a batched UDF and "
            "pass it as `embedder`"
        )

    def run_server(
        self,
        host: str = "0.0.0.0",
        port: int = 8000,
        threaded: bool = False,
        with_cache: bool = True,
        cache_backend=None,
        **kwargs,
    ):
        """(reference: vector_store.py:629)"""
        self._server = DocumentStoreServer(host, port, self.document_store)
        return self._server.run(threaded=threaded, with_cache=with_cache, **kwargs)


class VectorStoreClient:
    """(reference: vector_store.py client class)"""

    def __init__(
        self,
        host: Optional[str] = None,
        port: Optional[int] = None,
        url: Optional[str] = None,
        timeout: int = 60,
    ):
        self.url = url or f"http://{host or '127.0.0.1'}:{port or 8000}"
        self.timeout = timeout

    def query(
        self,
        query: str,
        k: int = 3,
        metadata_filter: Optional[str] = None,
        filepath_globpattern: Optional[str] = None,
    ) -> List[dict]:
        return post_json(
            self.url + "/v1/retrieve",
            {
                "query": query,
                "k": k,
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
            timeout=self.timeout,
        )

    __call__ = query

    def get_vectorstore_statistics(self) -> dict:
        return post_json(self.url + "/v1/statistics", {}, timeout=self.timeout)

    def get_input_files(self, metadata_filter=None, filepath_globpattern=None):
        return post_json(
            self.url + "/v1/inputs",
            {
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
            timeout=self.timeout,
        )
