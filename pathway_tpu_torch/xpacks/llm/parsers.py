"""Document parsers of the port (counterpart of
``pathway_tpu/xpacks/llm/parsers.py``; reference: xpacks/llm/
parsers.py:53-928 — ParseUtf8, ParseUnstructured, OpenParse, ImageParser,
SlideParser, PypdfParser).  Parsers map raw bytes -> list[(text, metadata)].

The PDF text and slide scanners are pure Python; images decode through
PIL as in the reference, and the offline image tier labels them with the
port's ``ClipModel`` (on the process default device unless a
``clip_model`` is passed).  ``ParseUnstructured`` needs ``unstructured``
and raises ``ImportError`` without it; ``PypdfParser`` uses ``pypdf``
where it is installed and the pure-Python scanner otherwise."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

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

DEFAULT_VISION_PROMPT = (
    "Describe the contents of this image in detail. If it contains a "
    "table, transcribe the table as markdown."
)


_IMAGE_MAGIC = (
    (b"\x89PNG", "image/png"),
    (b"\xff\xd8\xff", "image/jpeg"),
    (b"GIF8", "image/gif"),
    (b"RIFF", "image/webp"),
    (b"BM", "image/bmp"),
)


def _image_mime(data: bytes) -> str:
    for magic, mime in _IMAGE_MAGIC:
        if data[: len(magic)] == magic:
            return mime
    return "application/octet-stream"


def _call_vision_chat(llm, image_bytes: bytes, prompt: str) -> str:
    """Ask a vision-capable chat model about one image (reference
    parsers.py:235-396 routes tables/images through vision prompts).  The
    message shape is the OpenAI multi-part content form every API chat
    accepts: image_url (base64 data URI, media type sniffed from the
    payload) + text; dispatch delegates to the shared chat invoker."""
    import base64

    from .question_answering import _call_chat

    data = bytes(image_bytes)
    b64 = base64.b64encode(data).decode()
    mime = _image_mime(data)
    messages = [
        {
            "role": "user",
            "content": [
                {
                    "type": "image_url",
                    "image_url": {"url": f"data:{mime};base64,{b64}"},
                },
                {"type": "text", "text": prompt},
            ],
        }
    ]
    return _call_chat(llm, messages)


def _clip_labeler(labels: Optional[List[str]], clip_model, downsize_to: int):
    """Shared zero-shot labeling closure for the offline image tiers:
    returns ``label(img_source) -> (picked_labels, decoded_array | None)``
    with the text-embedding cache inside.  ``img_source`` is raw bytes (or
    an already-decoded float array); undecodable inputs yield ([], None)."""
    clip = clip_model
    if labels and clip is None:
        from ...models.clip import ClipModel

        clip = ClipModel(image_size=downsize_to)
    state: Dict[str, Any] = {"vecs": None}

    def label(img_source, top_k: int):
        import io as _io

        import numpy as np

        if isinstance(img_source, (bytes, bytearray, memoryview)):
            try:
                from PIL import Image

                img = Image.open(_io.BytesIO(img_source)).convert("RGB")
            except Exception:  # noqa: BLE001 - undecodable image
                return [], None
            img = img.resize((downsize_to, downsize_to))
            arr = np.asarray(img, dtype=np.float32) / 255.0
        else:
            arr = img_source
        if not labels:
            return [], arr
        if state["vecs"] is None:
            state["vecs"] = clip.encode_text(list(labels))
        img_vec = clip.encode_image([arr])[0]
        order = (state["vecs"] @ img_vec).argsort()[::-1][:top_k]
        return [labels[i] for i in order], arr

    return label


def _to_text(contents: Any) -> str:
    if isinstance(contents, bytes):
        return contents.decode("utf-8", errors="replace")
    return str(contents)


class ParseUtf8(UDF):
    """(reference: parsers.py:53)"""

    def __init__(self, **kwargs):
        super().__init__(lambda contents: [(_to_text(contents), {})], **kwargs)


Utf8Parser = ParseUtf8


class ParseMarkdown(UDF):
    """Split a markdown document on headings into (section, metadata) chunks."""

    def __init__(self, **kwargs):
        def parse(contents: Any) -> List[Chunk]:
            text = _to_text(contents)
            chunks: List[Chunk] = []
            current: List[str] = []
            heading = ""
            for line in text.splitlines():
                if line.startswith("#"):
                    if current:
                        chunks.append(("\n".join(current).strip(), {"heading": heading}))
                    heading = line.lstrip("# ").strip()
                    current = [line]
                else:
                    current.append(line)
            if current:
                chunks.append(("\n".join(current).strip(), {"heading": heading}))
            return [c for c in chunks if c[0]]

        super().__init__(parse, **kwargs)


class ParseUnstructured(UDF):
    """(reference: parsers.py:79 — unstructured-io; gated on the library)"""

    def __init__(self, mode: str = "single", **kwargs):
        try:
            from unstructured.partition.auto import partition
        except ImportError as e:
            raise ImportError(
                "ParseUnstructured requires the `unstructured` package; use "
                "ParseUtf8 / ParseMarkdown / PypdfParser instead"
            ) from e

        def parse(contents: Any) -> List[Chunk]:
            import io

            elements = partition(file=io.BytesIO(contents))
            if mode == "single":
                return [("\n\n".join(str(e) for e in elements), {})]
            return [(str(e), {"category": e.category}) for e in elements]

        super().__init__(parse, **kwargs)


UnstructuredParser = ParseUnstructured


def _pdf_literal_string(raw: bytes) -> str:
    """Decode a PDF literal string body (backslash escapes, octal)."""
    out = bytearray()
    i = 0
    while i < len(raw):
        c = raw[i]
        if c == 0x5C and i + 1 < len(raw):  # backslash
            n = raw[i + 1]
            mapped = {
                0x6E: 0x0A, 0x72: 0x0D, 0x74: 0x09, 0x62: 0x08, 0x66: 0x0C,
                0x28: 0x28, 0x29: 0x29, 0x5C: 0x5C,
            }.get(n)
            if mapped is not None:
                out.append(mapped)
                i += 2
                continue
            if 0x30 <= n <= 0x37:  # octal escape
                j = i + 1
                digits = b""
                while j < len(raw) and len(digits) < 3 and 0x30 <= raw[j] <= 0x37:
                    digits += bytes([raw[j]])
                    j += 1
                out.append(int(digits, 8) & 0xFF)
                i = j
                continue
            i += 1  # line continuation / unknown escape: drop the backslash
            continue
        out.append(c)
        i += 1
    return out.decode("latin-1")


def _pdf_extract_text(contents: bytes) -> List[str]:
    """Minimal pure-python PDF text extraction: inflate every Flate stream
    and collect the Tj/TJ/'-operator strings of its BT..ET text blocks.
    Handles the simple-font PDFs that text exporters produce; CID/Type0
    composite fonts need a real PDF library."""
    import re
    import zlib

    texts: List[str] = []
    for m in re.finditer(rb"(?<!end)stream\r?\n", contents):
        start = m.end()
        end = contents.find(b"endstream", start)
        if end < 0:
            continue
        data = contents[start:end].rstrip(b"\r\n")
        try:
            data = zlib.decompress(data)
        except zlib.error:
            pass  # uncompressed stream (or an image) — try as-is
        if b"BT" not in data:
            continue
        parts: List[str] = []
        for block in re.findall(rb"BT(.*?)ET", data, re.S):
            # literal strings followed by a show operator; TJ arrays mix
            # strings and kerning numbers
            for sm in re.finditer(
                rb"\((?:[^()\\]|\\.)*\)|<[0-9A-Fa-f\s]+>", block
            ):
                token = sm.group(0)
                tail = block[sm.end(): sm.end() + 24]
                if not re.match(
                    rb"\s*(?:Tj|'|\")|[^\[]*?\]\s*TJ", tail
                ):
                    continue
                if token.startswith(b"("):
                    parts.append(_pdf_literal_string(token[1:-1]))
                else:
                    hexed = re.sub(rb"\s", b"", token[1:-1])
                    try:
                        parts.append(bytes.fromhex(hexed.decode()).decode(
                            "latin-1"
                        ))
                    except ValueError:
                        pass
            parts.append("\n")
        text = "".join(parts).strip()
        if text:
            texts.append(text)
    return texts


class PdfParser(UDF):
    """Pure-python PDF text extraction — no native PDF library in the image
    (reference capability: parsers.py:746 PypdfParser).  Covers simple-font
    Flate PDFs; composite-font documents should go through
    ParseUnstructured/PypdfParser where those libraries are installed."""

    def __init__(self, apply_text_cleanup: bool = True, **kwargs):
        def parse(contents: bytes) -> List[Chunk]:
            out: List[Chunk] = []
            for i, text in enumerate(_pdf_extract_text(bytes(contents))):
                if apply_text_cleanup:
                    text = " ".join(text.split())
                if text:
                    out.append((text, {"page": i}))
            return out

        super().__init__(parse, **kwargs)


class PypdfParser(UDF):
    """(reference: parsers.py:746 — pypdf text extraction; falls back to the
    pure-python PdfParser when pypdf is not installed)"""

    def __init__(self, apply_text_cleanup: bool = True, **kwargs):
        try:
            import pypdf
        except ImportError:
            pypdf = None

        def parse(contents: bytes) -> List[Chunk]:
            import io

            if pypdf is None:
                out: List[Chunk] = []
                for i, text in enumerate(_pdf_extract_text(bytes(contents))):
                    if apply_text_cleanup:
                        text = " ".join(text.split())
                    if text:
                        out.append((text, {"page": i}))
                return out
            reader = pypdf.PdfReader(io.BytesIO(contents))
            out = []
            for i, page in enumerate(reader.pages):
                text = page.extract_text() or ""
                if apply_text_cleanup:
                    text = " ".join(text.split())
                if text:
                    out.append((text, {"page": i}))
            return out

        super().__init__(parse, **kwargs)


class ImageParser(UDF):
    """(reference: parsers.py:396 — vision-LLM image description).  Two
    tiers: when a vision-capable chat ``llm`` is configured, the image is
    described via a vision prompt like the reference does; otherwise the
    offline tier zero-shot classifies it with the LOCAL CLIP model using
    the optional ``labels`` list.  The decoded ndarray always lands in
    metadata for the CLIP image-embedding index path."""

    def __init__(
        self,
        downsize_to: int = 64,
        labels: Optional[List[str]] = None,
        clip_model=None,
        top_k_labels: int = 3,
        llm=None,
        llm_prompt: str = DEFAULT_VISION_PROMPT,
        **kwargs,
    ):
        labeler = _clip_labeler(labels if llm is None else None, clip_model, downsize_to)

        def parse(contents: bytes) -> List[Chunk]:
            import io

            import numpy as np

            try:
                from PIL import Image
            except ImportError as e:
                raise ImportError("ImageParser requires `Pillow`") from e
            img = Image.open(io.BytesIO(contents)).convert("RGB")
            img = img.resize((downsize_to, downsize_to))
            arr = np.asarray(img, dtype=np.float32) / 255.0
            text = ""
            meta: Dict[str, Any] = {"image": arr}
            if llm is not None:
                # vision tier: the ORIGINAL bytes go to the model (the
                # downsized array is only for the CLIP embedding path)
                text = _call_vision_chat(llm, contents, llm_prompt)
            elif labels:
                picked, _ = labeler(arr, top_k_labels)
                text = ", ".join(picked)
                meta["labels"] = picked
            return [(text, meta)]

        super().__init__(parse, **kwargs)


def _pdf_slide_scan(contents: bytes):
    """Walk a PDF's streams in document order, yielding per-slide text and
    embedded JPEG images: ("text", slide_idx, str) and
    ("image", slide_idx, jpeg_bytes).  Slide index advances at each
    text-bearing content stream (one content stream per exported slide is
    how deck exporters write PDFs)."""
    import re
    import zlib

    slide = -1
    for m in re.finditer(rb"(?<!end)stream\r?\n", contents):
        start = m.end()
        end = contents.find(b"endstream", start)
        if end < 0:
            continue
        data = contents[start:end].rstrip(b"\r\n")
        # embedded JPEG (DCTDecode) XObjects pass through undeflated
        if data[:3] == b"\xff\xd8\xff":
            yield ("image", max(slide, 0), data)
            continue
        try:
            inflated = zlib.decompress(data)
        except zlib.error:
            inflated = data
        if inflated[:3] == b"\xff\xd8\xff":
            yield ("image", max(slide, 0), inflated)
            continue
        if b"BT" not in inflated:
            continue
        slide += 1
        texts = _pdf_extract_text(
            b"stream\n" + data + b"\nendstream"
        )
        yield ("text", slide, " ".join(" ".join(t.split()) for t in texts))


class SlideParser(UDF):
    """Slide decks (PDF exports).  Per-slide text chunks come from the
    pure-python PDF extractor; embedded slide images go through the vision
    chat ``llm`` when one is configured (the reference's tier,
    parsers.py:569 — rasterize and ask a vision model), and are otherwise
    zero-shot labeled with the LOCAL CLIP model so image-only slides stay
    searchable fully offline."""

    def __init__(
        self,
        labels: Optional[List[str]] = None,
        clip_model=None,
        top_k_labels: int = 3,
        downsize_to: int = 64,
        llm=None,
        llm_prompt: str = DEFAULT_VISION_PROMPT,
        **kwargs,
    ):
        labeler = _clip_labeler(labels if llm is None else None, clip_model, downsize_to)

        def parse(contents: bytes) -> List[Chunk]:
            slide_text: Dict[int, List[str]] = {}
            slide_labels: Dict[int, List[str]] = {}
            for kind, slide, payload in _pdf_slide_scan(bytes(contents)):
                if kind == "text":
                    if payload:
                        slide_text.setdefault(slide, []).append(payload)
                    continue
                if llm is not None:
                    desc = _call_vision_chat(llm, payload, llm_prompt)
                    if desc:
                        slide_labels.setdefault(slide, []).append(desc)
                    continue
                if not labels:
                    continue
                picked, _arr = labeler(payload, top_k_labels)
                if picked:
                    slide_labels.setdefault(slide, []).extend(picked)
            out: List[Chunk] = []
            for slide in sorted(set(slide_text) | set(slide_labels)):
                text = " ".join(slide_text.get(slide, []))
                picked = slide_labels.get(slide, [])
                if picked:
                    text = (text + " " if text else "") + ", ".join(picked)
                meta: Dict[str, Any] = {"slide": slide}
                if picked:
                    meta["labels"] = picked
                if text:
                    out.append((text, meta))
            return out

        super().__init__(parse, **kwargs)


class OpenParse(UDF):
    """Structured PDF parsing with a vision-LLM tier (reference:
    parsers.py:235 — OpenParse extracts text nodes plus tables/images via
    vision prompts when ``parse_images``/table args are enabled).

    Tiers here: text nodes always come from the pure-python PDF extractor;
    embedded images become their own chunks — described by the vision chat
    ``llm`` when configured (``parse_images=True``), zero-shot labeled by
    the LOCAL CLIP model when only ``labels`` is given, and skipped
    otherwise.  Each chunk carries its page/slide index and node kind in
    metadata."""

    def __init__(
        self,
        llm=None,
        parse_images: bool = False,
        image_prompt: str = DEFAULT_VISION_PROMPT,
        labels: Optional[List[str]] = None,
        clip_model=None,
        top_k_labels: int = 3,
        downsize_to: int = 64,
        **kwargs,
    ):
        if parse_images and llm is None and not labels:
            raise ValueError(
                "OpenParse(parse_images=True) needs a vision `llm` or "
                "CLIP `labels` to turn images into text"
            )
        labeler = _clip_labeler(labels if llm is None else None, clip_model, downsize_to)

        def parse(contents: bytes) -> List[Chunk]:
            out: List[Chunk] = []
            for kind, page, payload in _pdf_slide_scan(bytes(contents)):
                if kind == "text":
                    if payload:
                        out.append((payload, {"page": page, "kind": "text"}))
                    continue
                if not parse_images:
                    continue
                if llm is not None:
                    desc = _call_vision_chat(llm, payload, image_prompt)
                    if desc:
                        out.append(
                            (desc, {"page": page, "kind": "image"})
                        )
                    continue
                picked, _arr = labeler(payload, top_k_labels)
                if picked:
                    out.append(
                        (", ".join(picked), {"page": page, "kind": "image", "labels": picked})
                    )
            return out

        super().__init__(parse, **kwargs)
