"""pw.io.bigquery — BigQuery output connector (counterpart of
``pathway_tpu/io/bigquery``; reference: python/pathway/io/bigquery/__init__.py
— streams the update stream into a table via the google-cloud-bigquery
client, imported at call time).  Keyword arguments the reference takes and never reads raise."""

from __future__ import annotations

from typing import Optional

from ...internals.table import Table
from .._subscribe import subscribe

__all__ = ["write"]


def write(
    table: Table,
    dataset_name: str,
    table_name: str,
    *,
    service_user_credentials_file: Optional[str] = None,
    max_batch_size: int = 500,
    **kwargs,
) -> None:
    refuse_dropped("pw.io.bigquery.write", kwargs)
    from google.cloud import bigquery

    if service_user_credentials_file:
        client = bigquery.Client.from_service_account_json(
            service_user_credentials_file
        )
    else:
        client = bigquery.Client()
    table_ref = f"{client.project}.{dataset_name}.{table_name}"
    names = table.column_names
    buffer = []

    def on_change(key, row, time, is_addition):
        rec = {n: _plain(row[n]) for n in names}
        rec["time"] = time
        rec["diff"] = 1 if is_addition else -1
        buffer.append(rec)
        if len(buffer) >= max_batch_size:
            flush()

    def flush(ts=None):
        if not buffer:
            return
        batch = list(buffer)
        errors = client.insert_rows_json(table_ref, batch)
        if errors:
            # insert_rows_json reports per-row failures; rows not listed were
            # inserted, so keep ONLY the failed rows for the retry — leaving
            # the whole batch buffered would re-insert the successful rows.
            # If any error entry lacks a usable row index (request-level
            # errors), fall back to retrying the whole batch: duplicates beat
            # silent loss (at-least-once).
            idxs = [e.get("index") for e in errors]
            if all(isinstance(i, int) and 0 <= i < len(batch) for i in idxs):
                failed_idx = sorted(set(idxs))
                buffer[:] = [batch[i] for i in failed_idx]
            raise RuntimeError(f"BigQuery insert errors: {errors}")
        del buffer[:]

    subscribe(table, on_change=on_change, on_time_end=flush, on_end=flush)


from .._connector import jsonable as _plain, refuse_dropped  # noqa: E402
