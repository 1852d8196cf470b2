"""DocumentStore — live document ingestion + retrieval pipeline of the
port (counterpart of ``pathway_tpu/xpacks/llm/document_store.py``;
reference: xpacks/llm/document_store.py:32 DocumentStore, :286
build_pipeline, :426 retrieve_query; query schemas mirror the REST API of
the reference's DocumentStoreServer).  The default retriever is
``TpuKnnFactory`` over ``TpuEmbedder()``, both on the CUDA device."""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ...internals import dtype as dt
from ...internals.expression import ApplyExpression, ColumnReference
from ...internals.schema import Schema, column_definition, schema_from_dict
from ...internals.table import Table
from ...internals.thisclass import this
from ...internals.udfs import UDF
from ...stdlib.indexing.data_index import DataIndex, InnerIndex
from ...stdlib.indexing.nearest_neighbors import TpuKnnFactory
from .parsers import ParseUtf8
from .splitters import null_splitter

__all__ = ["DocumentStore", "SlidesDocumentStore"]


from ...stdlib.indexing.embedding_adapter import EmbeddingIndexAdapter


class DocumentStore:
    """Ingest documents (bytes + metadata) -> parse -> post-process -> split
    -> index; answer retrieval/statistics/inputs queries."""

    class RetrieveQuerySchema(Schema):
        query: str
        k: int = column_definition(default_value=3)
        metadata_filter: Optional[str] = column_definition(default_value=None)
        filepath_globpattern: Optional[str] = column_definition(default_value=None)

    class StatisticsQuerySchema(Schema):
        pass

    class InputsQuerySchema(Schema):
        metadata_filter: Optional[str] = column_definition(default_value=None)
        filepath_globpattern: Optional[str] = column_definition(default_value=None)

    def __init__(
        self,
        docs: Union[Table, Sequence[Table]],
        retriever_factory=None,
        parser: Optional[UDF] = None,
        splitter: Optional[UDF] = None,
        doc_post_processors: Optional[Sequence[Callable[[str, dict], Tuple[str, dict]]]] = None,
        embedder: Optional[UDF] = None,
        dimensions: Optional[int] = None,
    ):
        if isinstance(docs, Table):
            docs_list = [docs]
        else:
            docs_list = list(docs)
        self.docs = docs_list[0] if len(docs_list) == 1 else docs_list[0].concat_reindex(*docs_list[1:])
        self.parser = parser or ParseUtf8()
        self.splitter = splitter
        self.doc_post_processors = list(doc_post_processors or [])
        if retriever_factory is None:
            from .embedders import TpuEmbedder

            embedder = embedder or TpuEmbedder()
            retriever_factory = TpuKnnFactory(
                dimension=embedder.get_embedding_dimension(), embedder=embedder
            )
        self.retriever_factory = retriever_factory
        self.embedder = embedder or getattr(retriever_factory, "embedder", None)
        self.dimensions = dimensions or getattr(retriever_factory, "dimension", None)
        self.build_pipeline()

    # ------------------------------------------------------------------
    def build_pipeline(self) -> None:
        """(reference: document_store.py:286)"""
        docs = self.docs
        # normalise input columns: data + _metadata
        cols = docs.column_names
        data_col = "data" if "data" in cols else cols[0]
        has_meta = "_metadata" in cols

        parser = self.parser
        post = list(self.doc_post_processors)
        splitter = self.splitter

        def full_parse(data, meta):
            base_meta = dict(meta) if isinstance(meta, dict) else {}
            chunks = parser.func(data)
            out = []
            for text, cmeta in chunks:
                merged = {**base_meta, **(cmeta or {})}
                for proc in post:
                    text, merged = proc(text, merged)
                if splitter is not None:
                    for stext, smeta in splitter.func(text):
                        out.append((stext, {**merged, **(smeta or {})}))
                else:
                    out.append((text, merged))
            return tuple(out)

        meta_expr = (
            ColumnReference(docs, "_metadata")
            if has_meta
            else ApplyExpression(lambda d: {}, dt.JSON, args=(ColumnReference(docs, data_col),))
        )
        parsed = docs.select(
            _pw_chunks=ApplyExpression(
                full_parse,
                dt.ANY,
                args=(ColumnReference(docs, data_col), meta_expr),
            )
        ).flatten(this._pw_chunks)
        chunks = parsed.select(
            text=ApplyExpression(lambda c: c[0], dt.STR, args=(this._pw_chunks,)),
            metadata=ApplyExpression(lambda c: c[1], dt.JSON, args=(this._pw_chunks,)),
        )
        self.parsed_docs = chunks

        factory_embedder = getattr(self.retriever_factory, "embedder", None)
        embedder = factory_embedder or self.embedder
        factory = self.retriever_factory
        if embedder is not None and factory_embedder is None:
            # factories carrying their own embedder already wrap themselves
            # (stdlib/indexing/nearest_neighbors.py build_inner_index)
            base_factory = factory

            class _WrappedFactory:
                def build_inner_index(self, dimension=None):
                    dim = dimension or getattr(base_factory, "dimension", None)
                    if dim is None:
                        dim = embedder.get_embedding_dimension()
                    inner = base_factory.build_inner_index(dim)
                    return EmbeddingIndexAdapter(inner, embedder)

            factory = _WrappedFactory()
        if embedder is not None:
            dim = getattr(self.retriever_factory, "dimension", None) or (
                embedder.get_embedding_dimension()
            )
        else:
            dim = self.dimensions
        self.index = DataIndex(
            chunks,
            InnerIndex(
                data_column=chunks.text,
                metadata_column=chunks.metadata,
                factory=factory,
                dimension=dim,
            ),
        )

    # ------------------------------------------------------------------
    @staticmethod
    def merge_filters(metadata_filter, globpattern) -> Optional[str]:
        """Combine a metadata filter with a path glob (reference:
        document_store.py filter merging)."""
        parts = []
        if metadata_filter:
            parts.append(f"({metadata_filter})")
        if globpattern:
            parts.append(f"globmatch('{globpattern}', path)")
        return " && ".join(parts) if parts else None

    def retrieve_query(self, queries: Table) -> Table:
        """(reference: document_store.py:426) — returns a ``result`` column
        with a list of {text, metadata, dist} dicts per query."""
        merged = queries.select(
            query=this.query,
            k=this.k,
            _pw_filter=ApplyExpression(
                DocumentStore.merge_filters,
                dt.ANY,
                args=(this.metadata_filter, this.filepath_globpattern),
            ),
        )
        result = self.index.query_as_of_now(
            merged.query,
            number_of_matches=merged.k,
            metadata_filter=merged._pw_filter,
        )
        chunks = self.parsed_docs
        docs_out = result.select(
            _pw_texts=chunks.text,
            _pw_metas=chunks.metadata,
            _pw_scores=result.score,
        )

        def pack(texts, metas, scores):
            out = []
            for t, m, s in zip(texts or (), metas or (), scores or ()):
                out.append({"text": t, "metadata": m, "dist": -float(s)})
            return out

        return docs_out.select(
            result=ApplyExpression(
                pack, dt.JSON, args=(this._pw_texts, this._pw_metas, this._pw_scores)
            )
        )

    def statistics_query(self, info_queries: Table) -> Table:
        """(reference: document_store.py statistics endpoint)"""
        chunks_store = self.parsed_docs._engine_table.store
        meta_idx = self.parsed_docs._engine_table.column_names.index(
            self.parsed_docs._column_mapping["metadata"]
        )

        def stats(*_args):
            count = 0
            last_modified = None
            last_indexed = None
            for _key, row in chunks_store.items():
                count += 1
                md = row[meta_idx] or {}
                if isinstance(md, dict):
                    m = md.get("modified_at")
                    if m is not None:
                        last_modified = max(last_modified or 0, m)
                    s = md.get("seen_at")
                    if s is not None:
                        last_indexed = max(last_indexed or 0, s)
            return {
                "file_count": count,
                "last_modified": last_modified,
                "last_indexed": last_indexed,
            }

        return info_queries.select(result=ApplyExpression(stats, dt.JSON, args=()))

    def inputs_query(self, input_queries: Table) -> Table:
        """(reference: document_store.py inputs endpoint)"""
        from ...stdlib.indexing.filters import compile_filter

        chunks_store = self.parsed_docs._engine_table.store
        meta_idx = self.parsed_docs._engine_table.column_names.index(
            self.parsed_docs._column_mapping["metadata"]
        )

        def inputs(metadata_filter, globpattern):
            combined = DocumentStore.merge_filters(metadata_filter, globpattern)
            accept = compile_filter(combined) if combined else None
            seen = {}
            for _key, row in chunks_store.items():
                md = row[meta_idx] or {}
                if not isinstance(md, dict):
                    continue
                if accept is not None and not accept(md):
                    continue
                path = md.get("path", "<memory>")
                seen[path] = {
                    "path": path,
                    "modified_at": md.get("modified_at"),
                    "seen_at": md.get("seen_at"),
                }
            return list(seen.values())

        return input_queries.select(
            result=ApplyExpression(
                inputs, dt.JSON, args=(this.metadata_filter, this.filepath_globpattern)
            )
        )

    @property
    def index_table(self) -> Table:
        return self.parsed_docs


class SlidesDocumentStore(DocumentStore):
    """(reference: document_store.py SlidesDocumentStore variant)"""
