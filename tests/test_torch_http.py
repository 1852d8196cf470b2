"""The port's REST surface (``io/http`` on the standard library's HTTP
server, ``xpacks/llm/servers.py``, ``vector_store.py``, ``RAGClient``)
and its metrics server (``internals/metrics.py``) against the
reference's (aiohttp and ``http.server``).

The same requests go to both packages' servers, each run with
``pw.run`` on a thread and stopped with ``terminate``: the status codes
and the parsed JSON bodies must be equal (404 and 405 by status only:
aiohttp answers those in plain text, and so does the port, in its own
words).  Retrieval runs the reference's seeded encoder, carried into the
port, in f32 on the CPU; retrieval distances agree within 1e-5.
"""

import functools
import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.io import _connector as ref_connector
from pathway_tpu.models import encoder as ref_encoder_mod
from pathway_tpu.xpacks.llm.embedders import TpuEmbedder as RefTpuEmbedder
from pathway_tpu_torch.io import _connector as port_connector
from pathway_tpu_torch.xpacks.llm.embedders import TpuEmbedder

from .utils import free_port

TOL = 1e-5
_ENC = dict(dimension=64, n_layers=2, max_length=32)
_ENC_EXTRA = dict(n_heads=4, vocab_size=4096, seed=0)
_DOCS = [
    ("Cats sleep most of the day and hunt at night.", "a/cats.txt", 101),
    ("Dogs bark at the postman every morning.", "a/dogs.txt", 102),
    ("Fish swim in the sea and in rivers.", "b/fish.md", 103),
    ("Birds migrate south when winter comes.", "b/birds.txt", 104),
    ("Dataflow engines process streams of updates.", "c/dataflow.txt", 105),
    ("The capital of Freedonia is Fredville.", "c/facts.md", 106),
]


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setattr(ref_connector, "_source_counter", [0])
    monkeypatch.setattr(port_connector, "_source_counter", [0])
    pathway_tpu.reset()
    pathway_tpu_torch.reset()
    yield
    pathway_tpu.reset()
    pathway_tpu_torch.reset()


@pytest.fixture(scope="module")
def embedders():
    orig = ref_encoder_mod.SentenceEncoder
    ref_encoder_mod.SentenceEncoder = functools.partial(orig, dtype=jnp.float32, **_ENC_EXTRA)
    try:
        ref = RefTpuEmbedder(**_ENC)
    finally:
        ref_encoder_mod.SentenceEncoder = orig
    tree = jax.tree_util.tree_map(np.asarray, ref._encoder.params)
    return {"ref": ref, "port": TpuEmbedder(**_ENC, **_ENC_EXTRA, device="cpu", dtype=torch.float32, params=tree)}


def _pw(side):
    return pathway_tpu if side == "ref" else pathway_tpu_torch


def _call(port, method, path, body=None, headers=None):
    """(status, parsed JSON body or raw text, headers) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
            headers = {"Content-Type": "application/json", **(headers or {})}
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        raw = resp.read()
        ctype = resp.getheader("Content-Type") or ""
        parsed = json.loads(raw) if ctype.startswith("application/json") else raw.decode(errors="replace")
        return resp.status, parsed, dict(resp.getheaders())
    finally:
        conn.close()


class _Running:
    """``pw.run`` of one package on a thread, until ``terminate``.  Up
    means the server answers and every route's connector has its session
    writer: the server starts in a pre-run hook, each connector's writer
    when its source thread starts, and a request before that answers 500
    in both packages."""

    def __init__(self, side, port, webserver):
        self.side, self.port, self.webserver = side, port, webserver

    def _attached(self):
        return all(getattr(h.__self__, "_writer", None) is not None for _r, _m, h, _d in self.webserver._routes)

    def __enter__(self):
        pw = _pw(self.side)
        self.thread = threading.Thread(target=lambda: pw.run(monitoring_level=None), daemon=True)
        self.thread.start()
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                if _call(self.port, "GET", "/_schema")[0] == 200 and self._attached():
                    return self
            except OSError:
                pass
            time.sleep(0.1)
        raise AssertionError(f"the {self.side} server did not come up")

    def __exit__(self, *exc):
        if self.side == "ref":
            from pathway_tpu.internals.run import terminate
        else:
            from pathway_tpu_torch.internals.run import terminate
        terminate()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()
        return False


# -- rest_connector --------------------------------------------------------------


def _validator(payload):
    if isinstance(payload, dict) and payload.get("bad"):
        raise ValueError("bad request: field 'bad' is set")


def _build_calc(side, port, with_cors=False):
    pw = _pw(side)

    class Q(pw.Schema):
        x: int
        name: str = pw.column_definition(default_value="anon")

    ws = pw.io.http.PathwayWebserver(host="127.0.0.1", port=port, with_cors=with_cors)
    queries, writer = pw.io.http.rest_connector(
        webserver=ws, route="/v1/calc", schema=Q, request_validator=_validator,
        documentation=pw.io.http.EndpointDocumentation(summary="ten over x", tags=["calc"]),
    )
    writer(queries.select(result=pw.apply(
        lambda x, name: {"tens": 10 // x, "name": name, "arr": np.arange(3, dtype=np.int64) * x,
                         "f": np.float32(0.5), "tup": (x, name)},
        pw.this.x, pw.this.name)))
    echo, echo_writer = pw.io.http.rest_connector(
        webserver=ws, route="/v1/echo", methods=("GET",), schema=pw.schema_from_types(q=str),
        delete_completed_queries=False,
    )
    echo_writer(echo.select(result=pw.apply(lambda q: (q or "").upper(), pw.this.q)))
    return ws


_REQUESTS = [
    ("POST", "/v1/calc", {"x": 5}),
    ("POST", "/v1/calc", {"x": 4, "name": "bob"}),
    ("POST", "/v1/calc", b"{not json"),
    ("POST", "/v1/calc", {"x": 0}),
    ("POST", "/v1/calc", {"x": 3, "bad": True}),
    ("POST", "/v1/calc", {"x": 7, "extra": 1}),
    ("GET", "/v1/calc", None),
    ("POST", "/v1/echo", {"q": "x"}),
    ("POST", "/nope", {"x": 1}),
    ("GET", "/_schema", None),
    ("GET", "/v1/echo?q=abc&q=def&z=", None),
    ("GET", "/v1/echo", None),
    ("POST", "/v1/calc", b""),
    ("POST", "/v1/calc", {"x": 2}),
]


def _exchange(side):
    port = free_port()
    with _Running(side, port, _build_calc(side, port)):
        return [_call(port, m, path, body)[:2] for m, path, body in _REQUESTS]


def test_rest_connector_answers_equal_reference():
    want = _exchange("ref")
    pathway_tpu.reset()
    got = _exchange("port")
    for (m, path, body), (ws, wb), (gs, gb) in zip(_REQUESTS, want, got):
        assert gs == ws, (m, path, body, want, got)
        if ws not in (404, 405):
            assert gb == wb, (m, path, body, wb, gb)
    statuses = [s for s, _b in got]
    assert statuses == [200, 200, 500, 500, 400, 200, 405, 405, 404, 200, 200, 200, 500, 200]
    assert got[0][1] == {"tens": 2, "name": "anon", "arr": [0, 5, 10], "f": 0.5, "tup": [5, "anon"]}
    assert "error" in got[2][1] and "error" in got[3][1]
    assert got[10][1] == "ABC"


def _cors(side):
    port = free_port()
    with _Running(side, port, _build_calc(side, port, with_cors=True)):
        pre = _call(port, "OPTIONS", "/v1/calc")
        post = _call(port, "POST", "/v1/calc", {"x": 2})
    return pre, post


def test_cors_equals_reference():
    want = _cors("ref")
    pathway_tpu.reset()
    got = _cors("port")
    for (ws, _wb, wh), (gs, _gb, gh) in zip(want, got):
        assert gs == ws == 200
        for h in ("Access-Control-Allow-Origin", "Access-Control-Allow-Headers"):
            assert gh[h] == wh[h] == "*"
    assert got[1][1] == want[1][1]


def test_port_server_survives_a_garbage_body_and_answers_concurrently():
    port = free_port()
    with _Running("port", port, _build_calc("port", port)):
        assert _call(port, "POST", "/v1/calc", b"\xff\xfe garbage")[0] == 500
        results = [None] * 16

        def one(i):
            results[i] = _call(port, "POST", "/v1/calc", {"x": i + 1, "name": f"n{i}"})[:2]

        threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert [r[0] for r in results] == [200] * 16
    assert [r[1]["name"] for r in results] == [f"n{i}" for i in range(16)]
    assert [r[1]["tens"] for r in results] == [10 // (i + 1) for i in range(16)]


def test_port_server_accepts_a_burst_of_connections():
    """64 callers connect at the same moment: none is reset (the listen
    backlog of ``socketserver`` is 5 unless the server raises it)."""
    import socket

    port = free_port()
    with _Running("port", port, _build_calc("port", port)):
        barrier = threading.Barrier(64)
        socks, errors = [None] * 64, []

        def connect(i):
            try:
                barrier.wait(timeout=30)
                socks[i] = socket.create_connection(("127.0.0.1", port), timeout=30)
            except OSError as exc:
                errors.append(exc)

        threads = [threading.Thread(target=connect, args=(i,)) for i in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        try:
            for s in socks:
                if s is not None:
                    body = json.dumps({"x": 3}).encode()
                    s.sendall(b"POST /v1/calc HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                              b"Connection: close\r\nContent-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
            replies = []
            for s in socks:
                if s is not None:
                    chunks = []
                    while True:
                        chunk = s.recv(65536)
                        if not chunk:
                            break
                        chunks.append(chunk)
                    replies.append(b"".join(chunks))
        finally:
            for s in socks:
                if s is not None:
                    s.close()
    from pathway_tpu_torch.io.http import _Server

    # where the kernel resets an overflowing accept queue, the burst
    # needs a backlog of at least the callers
    assert _Server.request_queue_size >= 64
    assert errors == [] and len(replies) == 64
    assert all(r.startswith(b"HTTP/1.1 200") and r.rstrip().endswith(b'"tup": [3, "anon"]}') for r in replies)


def test_rest_connector_refuses_a_cluster(monkeypatch):
    monkeypatch.setenv("PATHWAY_PROCESSES", "2")
    with pytest.raises(NotImplementedError, match="framework slice 4"):
        pathway_tpu_torch.io.http.rest_connector(host="127.0.0.1", port=free_port())


def test_jsonable_takes_torch_tensors():
    from pathway_tpu_torch.io.http import _jsonable

    assert _jsonable({"t": torch.arange(3), "n": np.int32(2), "p": (torch.tensor([1.5]),)}) == {
        "t": [0, 1, 2], "n": 2, "p": [[1.5]]}


# -- the QA and document-store servers -----------------------------------------------


class _Reader:
    """A deterministic chat: the first context line of the prompt."""

    batched = False

    def __init__(self):
        self.func = self._reply

    def _reply(self, messages):
        prompt = messages[-1]["content"]
        lines = [ln for ln in prompt.split("\n") if ln.strip()]
        return lines[2] if len(lines) > 2 else "No information found."


def _docs(pw):
    schema = pw.schema_from_types(data=str, _metadata=dict)
    return pw.debug.table_from_rows(
        schema, [(t, {"path": p, "modified_at": m, "seen_at": 2000 + m}) for t, p, m in _DOCS]
    )


def _factory(side, embedder):
    extra = {"device": "cpu"} if side == "port" else {}
    return _pw(side).stdlib.indexing.BruteForceKnnFactory(dimension=64, embedder=embedder, **extra)


_QA_REQUESTS = [
    ("/v1/retrieve", {"query": "which animal hunts at night", "k": 3}),
    ("/v1/retrieve", {"query": "streams", "k": 2, "filepath_globpattern": "c/*"}),
    ("/v1/retrieve", {"query": "animals", "k": 4, "metadata_filter": "modified_at > 102"}),
    ("/v1/statistics", {}),
    ("/v1/pw_list_documents", {}),
    ("/v1/pw_list_documents", {"filepath_globpattern": "*.md"}),
    ("/v1/pw_ai_answer", {"prompt": "What is the capital of Freedonia?"}),
    ("/v1/pw_ai_answer", {"prompt": "Do fish swim?", "return_context_docs": True}),
    ("/v1/pw_ai_summary", {"text_list": ["cats purr", "dogs bark"]}),
    ("/v1/pw_ai_answer", "garbage"),
    ("/v1/pw_ai_summary", {"text_list": 5}),
    ("/v1/statistics", {}),
]


def _qa_exchange(side, embedders):
    pw = _pw(side)
    if side == "ref":
        from pathway_tpu.xpacks.llm.document_store import DocumentStore
        from pathway_tpu.xpacks.llm.question_answering import BaseRAGQuestionAnswerer
    else:
        from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
        from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer
    store = DocumentStore(_docs(pw), retriever_factory=_factory(side, embedders[side]), splitter=None)
    rag = BaseRAGQuestionAnswerer(_Reader(), store, search_topk=2)
    port = free_port()
    rag.build_server(host="127.0.0.1", port=port)
    with _Running(side, port, rag.server.webserver):
        return [
            _call(port, "POST", route, body if isinstance(body, dict) else body.encode())[:2]
            for route, body in _QA_REQUESTS
        ]


def _same_json(want, got):
    """Equal JSON, floats (retrieval distances) within ``TOL``."""
    if isinstance(want, float):
        assert abs(want - got) <= TOL, (want, got)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (want, got)
        for k in want:
            _same_json(want[k], got[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (want, got)
        for w, g in zip(want, got):
            _same_json(w, g)
    else:
        assert got == want


def test_qa_summary_server_routes_equal_reference(embedders):
    want = _qa_exchange("ref", embedders)
    pathway_tpu.reset()
    got = _qa_exchange("port", embedders)
    for (route, body), (ws, wb), (gs, gb) in zip(_QA_REQUESTS, want, got):
        assert gs == ws, (route, body, wb, gb)
        _same_json(wb, gb)
    # an unreadable body is read as {} (prompt None) and answered; a value
    # that fails inside the pipeline answers 500, and the server stays up
    assert [s for s, _b in got] == [200] * 10 + [500, 200]
    assert "error" in got[10][1]
    assert len(got[0][1]) == 3 and got[3][1]["file_count"] == len(_DOCS)
    assert set(got[7][1]) == {"response", "context_docs"}


def _store_exchange(side, embedders):
    if side == "ref":
        from pathway_tpu.xpacks.llm.document_store import DocumentStore
        from pathway_tpu.xpacks.llm.servers import DocumentStoreServer
    else:
        from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
        from pathway_tpu_torch.xpacks.llm.servers import DocumentStoreServer
    pw = _pw(side)
    store = DocumentStore(_docs(pw), retriever_factory=_factory(side, embedders[side]), splitter=None)
    port = free_port()
    server = DocumentStoreServer("127.0.0.1", port, store)
    with _Running(side, port, server.webserver):
        out = [
            _call(port, "POST", "/v1/retrieve", {"query": "rivers and seas", "k": 2})[:2],
            _call(port, "POST", "/v1/statistics", {})[:2],
            _call(port, "POST", "/v1/inputs", {"metadata_filter": "modified_at >= 104"})[:2],
            _call(port, "GET", "/_schema")[:2],
        ]
    return out


def test_document_store_server_routes_equal_reference(embedders):
    want = _store_exchange("ref", embedders)
    pathway_tpu.reset()
    got = _store_exchange("port", embedders)
    assert [s for s, _b in got] == [s for s, _b in want] == [200] * 4
    for (_ws, wb), (_gs, gb) in zip(want, got):
        _same_json(wb, gb)


def test_vector_store_and_rag_clients_round_trip(embedders):
    """The port's clients (``urllib``) against the port's servers, beside
    the reference's clients against the same servers."""
    from pathway_tpu.xpacks.llm.question_answering import RAGClient as RefRAGClient
    from pathway_tpu.xpacks.llm.vector_store import VectorStoreClient as RefClient
    from pathway_tpu_torch.xpacks.llm import VectorStoreClient, VectorStoreServer
    from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer, RAGClient

    pw = pathway_tpu_torch
    port = free_port()
    server = VectorStoreServer(_docs(pw), embedder=embedders["port"],
                               index_factory=_factory("port", embedders["port"]))
    thread = server.run_server(host="127.0.0.1", port=port, threaded=True)
    try:
        client, ref_client = VectorStoreClient(port=port), RefClient(port=port)
        deadline = time.time() + 60
        while True:
            try:
                got = client.query("cats at night", k=2)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.1)
        assert got == ref_client.query("cats at night", k=2) and len(got) == 2
        assert client("cats at night", k=2) == got
        assert client.get_vectorstore_statistics() == ref_client.get_vectorstore_statistics()
        assert client.get_vectorstore_statistics()["file_count"] == len(_DOCS)
        files = client.get_input_files(filepath_globpattern="a/*")
        assert files == ref_client.get_input_files(filepath_globpattern="a/*")
        assert sorted(f["path"] for f in files) == ["a/cats.txt", "a/dogs.txt"]
    finally:
        from pathway_tpu_torch.internals.run import terminate

        terminate()
        thread.join(timeout=30)

    pw.reset()
    store = server.document_store.__class__(_docs(pw), retriever_factory=_factory("port", embedders["port"]),
                                            splitter=None)
    rag = BaseRAGQuestionAnswerer(_Reader(), store, search_topk=2)
    port = free_port()
    rag.build_server(host="127.0.0.1", port=port)
    thread = rag.run_server(threaded=True)
    try:
        client, ref_client = RAGClient(port=port), RefRAGClient(port=port)
        deadline = time.time() + 60
        while True:
            try:
                stats = client.statistics()
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.1)
        assert stats == ref_client.statistics()
        for call in (
            lambda c: c.answer("Do fish swim?", return_context_docs=True),
            lambda c: c.pw_ai_answer("What is the capital of Freedonia?"),
            lambda c: c.summarize(["a", "b"]),
            lambda c: c.retrieve("birds", k=2),
            lambda c: c.list_documents(filepath_globpattern="b/*"),
        ):
            assert call(client) == call(ref_client)
        assert client.answer("Do fish swim?", return_context_docs=True)["context_docs"]
    finally:
        from pathway_tpu_torch.internals.run import terminate

        terminate()
        thread.join(timeout=30)


# -- the metrics server ------------------------------------------------------------


def _families(text):
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}


def _metrics_run(side):
    pw = _pw(side)
    port = free_port()
    if side == "ref":
        from pathway_tpu.internals import metrics
        from pathway_tpu.internals.config import local_config
    else:
        from pathway_tpu_torch.internals import metrics
        from pathway_tpu_torch.internals.config import local_config
    t = pw.debug.table_from_rows(pw.schema_from_types(k=int, s=str), [(i, f"w{i % 3}") for i in range(30)])
    out = t.groupby(pw.this.s).reduce(pw.this.s, n=pw.reducers.count())
    pw.io.subscribe(out, on_change=lambda **kw: None)
    # the process config is read once at import: the port goes through local_config
    with local_config(metrics_port=port):
        pw.run(monitoring_level=None, with_http_server=True)
    try:
        status, text, headers = _call(port, "GET", "/metrics")
        om = _call(port, "GET", "/metrics", headers={"Accept": "application/openmetrics-text"})
        st = _call(port, "GET", "/status")[1]
        others = [_call(port, "GET", p)[0] for p in ("/serve_stats", "/slo", "/traces?limit=2", "/nothing")]
    finally:
        metrics._server.stop()
        metrics._server = None
    return status, text, headers["Content-Type"], om, st, others


def test_metrics_server_serves_the_reference_families():
    ref = _metrics_run("ref")
    pathway_tpu.reset()
    port = _metrics_run("port")
    (rs, rtext, rtype, rom, rst, rothers), (ps, ptext, ptype, pom, pst, pothers) = ref, port
    assert ps == rs == 200 and ptype == rtype
    engine = {f for f in _families(rtext) if f.startswith(("pathway_operator", "pathway_connector", "pathway_uptime",
                                                           "pathway_resident", "pathway_operators"))}
    assert engine and engine <= _families(ptext)
    assert {k: v for k, v in pst.items() if k != "uptime_s"} == {k: v for k, v in rst.items() if k != "uptime_s"}
    assert pothers == rothers == [200, 200, 200, 404]
    assert pom[0] == rom[0] == 200 and pom[1].rstrip().endswith("# EOF") and rom[1].rstrip().endswith("# EOF")
    rows = [line for line in ptext.splitlines() if line.startswith("pathway_operator_rows_in_total")]
    assert rows and sum(float(line.split()[-1]) for line in rows) > 0
