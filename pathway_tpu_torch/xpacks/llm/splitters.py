"""Text splitters of the port (counterpart of
``pathway_tpu/xpacks/llm/splitters.py``; reference: xpacks/llm/
splitters.py:13-121 — TokenCountSplitter over tiktoken, null_splitter).
Token counting uses the port's offline hashing tokenizer (tiktoken
requires downloads)."""

from __future__ import annotations

from typing import Dict, List, Tuple

from ...internals.udfs import UDF
from ...models.tokenizer import HashTokenizer

__all__ = ["TokenCountSplitter", "NullSplitter", "null_splitter"]

Chunk = Tuple[str, Dict]


def null_splitter(txt: str) -> List[Chunk]:
    """(reference: splitters.py:13)"""
    return [(txt, {})]


class NullSplitter(UDF):
    def __init__(self, **kwargs):
        super().__init__(lambda txt: [(txt, {})], **kwargs)


class TokenCountSplitter(UDF):
    """Split into chunks of min..max tokens, preferring sentence/punctuation
    boundaries (reference: splitters.py:34)."""

    def __init__(
        self,
        min_tokens: int = 50,
        max_tokens: int = 500,
        encoding_name: str = "cl100k_base",
        **kwargs,
    ):
        self.min_tokens = min_tokens
        self.max_tokens = max_tokens
        tokenizer = HashTokenizer()
        _PUNCT = ".?!\n"

        def split(txt: str) -> List[Chunk]:
            words = str(txt).split()
            if not words:
                return []
            chunks: List[Chunk] = []
            current: List[str] = []
            for word in words:
                current.append(word)
                if len(current) >= max_tokens:
                    chunks.append((" ".join(current), {}))
                    current = []
                elif len(current) >= min_tokens and word and word[-1] in _PUNCT:
                    chunks.append((" ".join(current), {}))
                    current = []
            if current:
                if chunks and len(current) < min_tokens:
                    last_text, meta = chunks[-1]
                    chunks[-1] = (last_text + " " + " ".join(current), meta)
                else:
                    chunks.append((" ".join(current), {}))
            return chunks

        super().__init__(split, **kwargs)
