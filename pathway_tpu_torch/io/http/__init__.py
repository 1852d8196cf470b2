"""pw.io.http of the port — the REST server connector (counterpart of
``pathway_tpu/io/http``; reference: python/pathway/io/http/_server.py:126-624
— PathwayWebserver, rest_connector, EndpointDocumentation; the serving
path of every RAG/QA template).

The server is the standard library's ``http.server.ThreadingHTTPServer``
(one thread per connection; the reference's is aiohttp): a request's
thread puts its query row into the engine and waits on a future that the
response table's subscriber resolves.  The reference's semantics hold:
405 for a wrong method and 404 for an unknown route; a POST/PUT/PATCH
body read as JSON, an unreadable body becoming ``{}``; GET query
parameters; a validator failure answers 400 ``{"error": ...}``, an
``Error`` result 500 ``{"error": ...}``, a 120 s wait 504; ``/_schema``
serves the OpenAPI JSON; ``with_cors`` answers OPTIONS and adds the
CORS headers.  A query row's key comes from a per-connector counter.

One process only: under ``PATHWAY_PROCESSES`` > 1 the connector raises,
as ``pw.run`` does (the multi-process engine is a later slice)."""

from __future__ import annotations

import concurrent.futures
import itertools
import json as _json
import threading
import urllib.request
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Type
from urllib.parse import parse_qsl

import numpy as np
import torch

from ...internals.keys import Pointer
from ...internals.parse_graph import G
from ...internals.schema import Schema, schema_from_types
from ...internals.table import Table
from .._connector import SessionWriter, register_source
from .._subscribe import subscribe

__all__ = [
    "PathwayWebserver",
    "rest_connector",
    "EndpointDocumentation",
    "RestServerSubject",
]

_TIMEOUT_S = 120.0


@dataclass
class EndpointDocumentation:
    """OpenAPI metadata for a route (reference: _server.py:126)."""

    summary: Optional[str] = None
    description: Optional[str] = None
    tags: Optional[Sequence[str]] = None
    method_types: Optional[Sequence[str]] = None


def _jsonable(v: Any) -> Any:
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return v.tolist()
    if isinstance(v, bytes):
        return v.decode(errors="replace")
    if isinstance(v, Pointer):
        return str(v)
    if isinstance(v, tuple):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_jsonable(x) for x in v]
    return v


@dataclass
class Request:
    """One HTTP request as a route handler sees it."""

    method: str
    path: str
    query: Dict[str, str]
    body: bytes

    def json(self) -> Any:
        return _json.loads(self.body.decode("utf-8"))


# a route handler: Request -> (status, JSON-able body)
Handler = Callable[[Request], Tuple[int, Any]]


def post_json(url: str, payload: Mapping[str, Any], timeout: float = 60.0) -> Any:
    """POST ``payload`` as JSON and return the parsed answer; an HTTP
    error status raises ``urllib.error.HTTPError``."""
    req = urllib.request.Request(
        url,
        data=_json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return _json.loads(resp.read())


class _Server(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 resets connections
    # when more callers connect at once (aiohttp listens with 128)
    request_queue_size = 128
    daemon_threads = True


class PathwayWebserver:
    """HTTP server on its own thread (reference: _server.py:329).  Routes
    are added by rest_connector before ``pw.run``; the server starts in a
    pre-run hook and stops in a post-run hook.  ``port=0`` binds a free
    port, read back from ``port`` once started."""

    def __init__(self, host: str = "0.0.0.0", port: int = 8080, with_cors: bool = False):
        self.host = host
        self.port = port
        self.with_cors = with_cors
        self._routes: List[Tuple[str, Sequence[str], Handler, EndpointDocumentation]] = []
        self._httpd: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None
        self._registered_hook = False

    def _register_start_hook(self):
        if not self._registered_hook:
            self._registered_hook = True
            G.pre_run_hooks.append(self.start)
            G.post_run_hooks.append(self.stop)

    def add_route(self, route: str, methods: Sequence[str], handler: Handler, documentation=None):
        self._routes.append(
            (route, methods, handler, documentation or EndpointDocumentation())
        )
        self._register_start_hook()

    def openapi_description_json(self) -> Dict[str, Any]:
        paths: Dict[str, Any] = {}
        for route, methods, _handler, doc in self._routes:
            entry = {}
            for m in methods:
                entry[m.lower()] = {
                    "summary": doc.summary or route,
                    "description": doc.description or "",
                    "tags": list(doc.tags or []),
                    "responses": {"200": {"description": "success"}},
                }
            paths[route] = entry
        return {
            "openapi": "3.0.3",
            "info": {"title": "pathway_tpu app", "version": "1.0"},
            "paths": paths,
        }

    def _table(self) -> Dict[str, Dict[str, Handler]]:
        table: Dict[str, Dict[str, Handler]] = {}
        for route, methods, handler, _doc in self._routes:
            for m in methods:
                table.setdefault(route, {})[m.upper()] = handler
        table.setdefault("/_schema", {}).setdefault(
            "GET", lambda _req: (200, self.openapi_description_json())
        )
        return table

    def start(self) -> None:
        if self._thread is not None:
            return
        routes = self._table()
        with_cors = self.with_cors

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send(self, status: int, body: bytes, ctype: str, extra=()):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if with_cors:
                    self.send_header("Access-Control-Allow-Origin", "*")
                    self.send_header("Access-Control-Allow-Headers", "*")
                for name, value in extra:
                    self.send_header(name, value)
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(body)

            def _dispatch(self):
                path, _, qs = self.path.partition("?")
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n > 0 else b""
                if with_cors and self.command == "OPTIONS":
                    self._send(200, b"", "application/octet-stream")
                    return
                by_method = routes.get(path)
                if by_method is None:
                    self._send(404, b"404: Not Found", "text/plain; charset=utf-8")
                    return
                handler = by_method.get(self.command)
                if handler is None:
                    self._send(
                        405,
                        b"405: Method Not Allowed",
                        "text/plain; charset=utf-8",
                        [("Allow", ",".join(sorted(by_method)))],
                    )
                    return
                query: Dict[str, str] = {}
                for k, v in parse_qsl(qs, keep_blank_values=True):
                    query.setdefault(k, v)
                try:
                    status, obj = handler(Request(self.command, path, query, body))
                    out = _json.dumps(obj).encode()
                except Exception as exc:  # noqa: BLE001 - a failed handler answers 500, the server stays up
                    status, out = 500, _json.dumps({"error": str(exc) or type(exc).__name__}).encode()
                self._send(status, out, "application/json; charset=utf-8")

            do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = do_OPTIONS = do_HEAD = _dispatch

            def log_message(self, *args):  # pragma: no cover
                pass

        httpd = _Server((self.host, self.port), _Handler)
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._thread = threading.Thread(target=httpd.serve_forever, daemon=True, name="webserver")
        self._thread.start()

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        self._thread = None


class RestServerSubject:
    """Bridges HTTP requests into the queries table and resolves responses
    (reference: _server.py:490)."""

    def __init__(
        self,
        webserver: PathwayWebserver,
        route: str,
        methods: Sequence[str],
        schema: Type[Schema],
        delete_completed_queries: bool,
        request_validator=None,
        documentation: Optional[EndpointDocumentation] = None,
    ):
        self.webserver = webserver
        self.route = route
        self.methods = methods
        self.schema = schema
        self.delete_completed_queries = delete_completed_queries
        self.request_validator = request_validator
        self._writer: Optional[SessionWriter] = None
        self._futures: Dict[int, concurrent.futures.Future] = {}
        self._lock = threading.Lock()
        self._seq = itertools.count()
        webserver.add_route(route, methods, self._handle, documentation)

    def attach_writer(self, writer: SessionWriter) -> None:
        self._writer = writer

    def _handle(self, request: Request) -> Tuple[int, Any]:
        if request.method in ("POST", "PUT", "PATCH"):
            try:
                payload = request.json()
            except Exception:
                payload = {}
        else:
            payload = dict(request.query)
        if self.request_validator is not None:
            try:
                self.request_validator(payload)
            except Exception as e:
                return 400, {"error": str(e)}
        columns = list(self.schema.columns().keys())
        defaults = self.schema.default_values()
        values = {}
        for c in columns:
            if c in payload:
                values[c] = payload[c]
            elif c in defaults:
                values[c] = defaults[c]
            else:
                values[c] = None
        assert self._writer is not None
        key = self._writer.key_of({**values, "_request_seq": next(self._seq)})
        future: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            self._futures[int(key)] = future
        self._writer.insert(values, key=key)
        try:
            result = future.result(timeout=_TIMEOUT_S)
        except concurrent.futures.TimeoutError:
            return 504, {"error": "timeout"}
        finally:
            with self._lock:
                self._futures.pop(int(key), None)
            if self.delete_completed_queries:
                self._writer.session.remove(int(key))
        from ...internals.error_value import is_error

        if is_error(result):
            return 500, {"error": getattr(result, "message", "") or "computation failed"}
        return 200, _jsonable(result)

    def resolve(self, key: int, value: Any) -> None:
        with self._lock:
            future = self._futures.get(int(key))
        if future is not None and not future.done():
            try:
                future.set_result(value)
            except concurrent.futures.InvalidStateError:
                pass  # resolved by an earlier emission of the same key


class _ResponseWriter:
    def __init__(self, subject: RestServerSubject):
        self.subject = subject

    def __call__(self, response_table: Table) -> None:
        names = response_table.column_names

        def on_change(key, row, time, is_addition):
            if not is_addition:
                return
            if "result" in row:
                value = row["result"]
            elif len(names) == 1:
                value = row[names[0]]
            else:
                value = row
            self.subject.resolve(int(key), value)

        subscribe(response_table, on_change=on_change)


def rest_connector(
    host: Optional[str] = None,
    port: Optional[int] = None,
    *,
    webserver: Optional[PathwayWebserver] = None,
    route: str = "/",
    schema: Optional[Type[Schema]] = None,
    methods: Sequence[str] = ("POST",),
    autocommit_duration_ms: int = 50,
    keep_queries: Optional[bool] = None,
    delete_completed_queries: bool = True,
    request_validator=None,
    documentation: Optional[EndpointDocumentation] = None,
) -> Tuple[Table, Any]:
    """Expose a REST endpoint as a (queries_table, response_writer) pair
    (reference: io/http/_server.py:624)."""
    from ...parallel.distributed import topology_from_env

    processes, _pid, _addr = topology_from_env()
    if processes > 1:
        raise NotImplementedError(
            f"a REST connector across {processes} processes needs the multi-process engine over "
            "the port's exchange plane, a later slice (ROADMAP.md, framework slice 4)"
        )
    if schema is None:
        schema = schema_from_types(query=str)
    if keep_queries is not None:
        delete_completed_queries = not keep_queries
    stop_event = threading.Event()
    if webserver is None:
        webserver = PathwayWebserver(host=host or "0.0.0.0", port=8080 if port is None else port)
    subject = RestServerSubject(
        webserver,
        route,
        methods,
        schema,
        delete_completed_queries,
        request_validator,
        documentation,
    )

    def runner(writer: SessionWriter):
        subject.attach_writer(writer)
        # keep the session open for the lifetime of the run
        stop_event.wait()

    G.post_run_hooks.append(stop_event.set)
    table = register_source(
        schema,
        runner,
        mode="streaming",
        name=f"rest{route.replace('/', '_')}",
        dist_mode="broadcast",
    )
    return table, _ResponseWriter(subject)
