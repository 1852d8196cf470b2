"""Document parsers of the port (counterpart of
``pathway_tpu/xpacks/llm/parsers.py``; reference: xpacks/llm/
parsers.py:53-928).  Parsers map raw bytes -> list[(text, metadata)].

Ported: ``ParseUtf8``.  The markdown, unstructured, PDF, image and slide
parsers come with the question-answering slice (``ROADMAP.md``); their
names raise ``NotImplementedError``."""

from __future__ import annotations

from typing import Any, Dict, Tuple

from ...internals.udfs import UDF

__all__ = [
    "ParseUtf8",
    "Utf8Parser",
    "ParseUnstructured",
    "UnstructuredParser",
    "PdfParser",
    "PypdfParser",
    "ImageParser",
    "SlideParser",
    "OpenParse",
    "ParseMarkdown",
]

Chunk = Tuple[str, Dict]


def _to_text(contents: Any) -> str:
    if isinstance(contents, bytes):
        return contents.decode("utf-8", errors="replace")
    return str(contents)


class ParseUtf8(UDF):
    """(reference: parsers.py:53)"""

    def __init__(self, **kwargs):
        super().__init__(lambda contents: [(_to_text(contents), {})], **kwargs)


Utf8Parser = ParseUtf8


def _next_slice(name: str):
    class _Unported(UDF):
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"{name} is not ported yet: ROADMAP.md, framework slice 1 (question answering and chat)"
            )

    _Unported.__name__ = _Unported.__qualname__ = name
    return _Unported


ParseMarkdown = _next_slice("ParseMarkdown")
ParseUnstructured = _next_slice("ParseUnstructured")
UnstructuredParser = ParseUnstructured
PdfParser = _next_slice("PdfParser")
PypdfParser = _next_slice("PypdfParser")
ImageParser = _next_slice("ImageParser")
SlideParser = _next_slice("SlideParser")
OpenParse = _next_slice("OpenParse")
