"""pw.io.slack — Slack notifications output (counterpart of
``pathway_tpu/io/slack``; reference: python/pathway/xpacks/connectors/ slack send_alerts usage /
io surface).  Posts one message per insertion via chat.postMessage
(``requests``)."""

from __future__ import annotations

from ...internals.table import Table
from .._subscribe import subscribe

__all__ = ["send_alerts"]


def send_alerts(alerts: Table, slack_channel_id: str, slack_token: str) -> None:
    import requests

    names = alerts.column_names
    message_col = names[0]

    def on_change(key, row, time, is_addition):
        if not is_addition:
            return
        resp = requests.post(
            "https://slack.com/api/chat.postMessage",
            json={"channel": slack_channel_id, "text": str(row[message_col])},
            headers={"Authorization": f"Bearer {slack_token}"},
        )
        resp.raise_for_status()

    subscribe(alerts, on_change=on_change)
