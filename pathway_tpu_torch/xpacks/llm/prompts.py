"""Prompt templates of the port (counterpart of
``pathway_tpu/xpacks/llm/prompts.py``; reference: xpacks/llm/prompts.py:447).
The strings are byte-identical to the reference's: greedy answers depend
on them."""

from __future__ import annotations

from typing import Sequence

__all__ = [
    "prompt_qa",
    "prompt_qa_geometric_rag",
    "prompt_summarize",
    "prompt_short_qa",
]


def prompt_qa(
    query: str,
    docs: Sequence[str],
    information_not_found_response: str = "No information found.",
) -> str:
    context = "\n\n".join(str(d) for d in docs)
    return (
        "Use the below context documents to answer the question. If the "
        f"answer is not in the documents, reply exactly: "
        f"{information_not_found_response}\n\n"
        f"Context:\n{context}\n\nQuestion: {query}\nAnswer:"
    )


def prompt_qa_geometric_rag(
    query: str,
    docs: Sequence[str],
    information_not_found_response: str = "No information found.",
) -> str:
    """(reference: the adaptive-RAG prompt used by
    answer_with_geometric_rag_strategy, question_answering.py:97)"""
    context = "\n\n".join(f"Source {i + 1}: {d}" for i, d in enumerate(docs))
    return (
        "Answer the question based ONLY on the sources below. Keep the "
        "answer short. If the sources do not contain the answer, reply "
        f"exactly: {information_not_found_response}\n\n"
        f"{context}\n\nQuestion: {query}\nAnswer:"
    )


def prompt_summarize(texts: Sequence[str]) -> str:
    joined = "\n\n".join(str(t) for t in texts)
    return f"Summarize the following texts concisely:\n\n{joined}\n\nSummary:"


def prompt_short_qa(query: str, docs: Sequence[str]) -> str:
    context = " ".join(str(d) for d in docs)
    return f"Context: {context}\nQ: {query}\nA (one sentence):"
