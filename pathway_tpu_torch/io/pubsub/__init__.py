"""pw.io.pubsub — Google Pub/Sub output connector (counterpart of
``pathway_tpu/io/pubsub``; reference: python/pathway/io/pubsub/__init__.py).
Gated on google-cloud-pubsub.  Keyword arguments the reference takes and never reads raise."""

from __future__ import annotations

import json

from ...internals.table import Table
from .._gated import require
from .._subscribe import subscribe

__all__ = ["write"]


def write(table: Table, publisher, project_id: str, topic_id: str, **kwargs) -> None:
    """Publish the update stream; ``publisher`` is a
    google.cloud.pubsub_v1.PublisherClient (passed in, as in the reference)."""
    refuse_dropped("pw.io.pubsub.write", kwargs)
    if publisher is None:
        pubsub = require("google.cloud.pubsub_v1", "pubsub")
        publisher = pubsub.PublisherClient()
    topic_path = publisher.topic_path(project_id, topic_id)
    names = table.column_names
    futures = []

    def on_change(key, row, time, is_addition):
        obj = {n: _plain(row[n]) for n in names}
        attrs = {"time": str(time), "diff": str(1 if is_addition else -1)}
        futures.append(
            publisher.publish(topic_path, json.dumps(obj).encode(), **attrs)
        )

    def flush(ts=None):
        for f in futures:
            f.result()
        del futures[:]

    subscribe(table, on_change=on_change, on_time_end=flush, on_end=flush)


from .._connector import jsonable as _plain, refuse_dropped  # noqa: E402
