"""pw.io.logstash — Logstash output connector (counterpart of
``pathway_tpu/io/logstash``; reference: python/pathway/io/logstash/__init__.py
— posts the update stream to Logstash's http input plugin).  Uses
``requests``.  Keyword arguments the reference takes and never reads raise."""

from __future__ import annotations

import json

from ...internals.table import Table
from .._subscribe import subscribe

__all__ = ["write"]


def write(table: Table, endpoint: str, n_retries: int = 0, **kwargs) -> None:
    refuse_dropped("pw.io.logstash.write", kwargs)
    import requests

    names = table.column_names
    session = requests.Session()

    def on_change(key, row, time, is_addition):
        obj = {n: _plain(row[n]) for n in names}
        obj["time"] = time
        obj["diff"] = 1 if is_addition else -1
        last_err = None
        for _ in range(n_retries + 1):
            try:
                resp = session.post(
                    endpoint,
                    data=json.dumps(obj),
                    headers={"Content-Type": "application/json"},
                )
                resp.raise_for_status()
                return
            except requests.RequestException as e:  # pragma: no cover
                last_err = e
        if last_err is not None:
            raise last_err

    subscribe(table, on_change=on_change)


from .._connector import jsonable as _plain, refuse_dropped  # noqa: E402
