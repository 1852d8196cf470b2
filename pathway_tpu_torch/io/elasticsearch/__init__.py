"""pw.io.elasticsearch — Elasticsearch output connector (counterpart of
``pathway_tpu/io/elasticsearch``; reference: python/pathway/io/elasticsearch/__init__.py over ElasticSearchWriter,
src/connectors/data_storage.rs).  Implemented over the REST bulk API with
``requests`` — no elasticsearch client library needed.  An auth kind
other than basic or apikey (which the reference's ``headers`` turns into
no header at all) and keyword arguments the reference takes and never
reads raise.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, Optional

from ...internals.table import Table
from .._subscribe import subscribe

__all__ = ["write", "ElasticSearchAuth"]


class ElasticSearchAuth:
    """Auth settings (reference ElasticSearchAuth: basic / apikey / bearer)."""

    def __init__(self, kind: str, **params):
        if kind not in ("basic", "apikey"):
            raise ValueError(f"ElasticSearchAuth kind {kind!r} is not supported (basic or apikey)")
        self.kind = kind
        self.params = params

    @classmethod
    def basic(cls, username: str, password: str) -> "ElasticSearchAuth":
        return cls("basic", username=username, password=password)

    @classmethod
    def apikey(cls, apikey: str) -> "ElasticSearchAuth":
        return cls("apikey", apikey=apikey)

    def headers(self) -> Dict[str, str]:
        if self.kind == "apikey":
            return {"Authorization": f"ApiKey {self.params['apikey']}"}
        return {}

    def requests_auth(self):
        if self.kind == "basic":
            return (self.params["username"], self.params["password"])
        return None


def write(
    table: Table,
    host: str,
    auth: Optional[ElasticSearchAuth] = None,
    index_name: str = "pathway",
    *,
    batch_size: int = 500,
    **kwargs,
) -> None:
    """Index the table's update stream; insertions index documents (doc id =
    row key), deletions delete them — the index converges to the table."""
    refuse_dropped("pw.io.elasticsearch.write", kwargs)
    import requests

    names = table.column_names
    lock = threading.Lock()
    buffer = []
    session = requests.Session()
    if auth is not None:
        session.headers.update(auth.headers())
        a = auth.requests_auth()
        if a:
            session.auth = a

    def flush_locked():
        if not buffer:
            return
        payload = "\n".join(buffer) + "\n"
        del buffer[:]
        resp = session.post(
            f"{host.rstrip('/')}/_bulk",
            data=payload,
            headers={"Content-Type": "application/x-ndjson"},
        )
        resp.raise_for_status()
        # _bulk returns HTTP 200 even when individual items fail
        body = resp.json()
        if body.get("errors"):
            failed = [
                item
                for item in body.get("items", [])
                for op in item.values()
                if op.get("error")
            ]
            raise RuntimeError(
                f"Elasticsearch bulk rejected {len(failed)} item(s): "
                f"{failed[:3]!r}"
            )

    def on_change(key, row, time, is_addition):
        doc_id = str(int(key))
        with lock:
            if is_addition:
                buffer.append(json.dumps({"index": {"_index": index_name, "_id": doc_id}}))
                buffer.append(json.dumps({n: _jsonable(row[n]) for n in names}))
            else:
                buffer.append(json.dumps({"delete": {"_index": index_name, "_id": doc_id}}))
            if len(buffer) >= batch_size:
                flush_locked()

    def on_time_end(ts):
        with lock:
            flush_locked()

    subscribe(table, on_change=on_change, on_time_end=on_time_end,
              on_end=lambda: on_time_end(None))


from .._connector import jsonable as _jsonable, refuse_dropped  # noqa: E402
