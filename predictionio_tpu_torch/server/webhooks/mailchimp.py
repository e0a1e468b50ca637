"""MailChimp webhook connector (form flavor).

Parity with the reference MailChimpConnector
(data/.../webhooks/mailchimp/MailChimpConnector.scala:32-330): converts
the subscribe/unsubscribe/profile/upemail/cleaned/campaign form payloads
into events keyed on the list member (or list/campaign for
cleaned/campaign).

Port of ``predictionio_tpu/server/webhooks/mailchimp.py``.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Any, Mapping

from predictionio_tpu_torch.server.webhooks import ConnectorError, FormConnector


def _parse_time(s: str) -> str:
    # MailChimp format: "2009-03-26 21:35:57" (UTC)
    try:
        dt = datetime.strptime(s, "%Y-%m-%d %H:%M:%S").replace(tzinfo=timezone.utc)
    except ValueError as e:
        raise ConnectorError(f"cannot parse MailChimp fired_at {s!r}") from e
    return dt.strftime("%Y-%m-%dT%H:%M:%S.000Z")


class MailChimpConnector(FormConnector):
    SUPPORTED = ("subscribe", "unsubscribe", "profile", "upemail", "cleaned", "campaign")

    def to_event_json(self, data: Mapping[str, str]) -> dict[str, Any]:
        event_type = data.get("type")
        if event_type not in self.SUPPORTED:
            raise ConnectorError(
                f"Cannot convert unknown MailChimp type {event_type!r}"
            )
        if "fired_at" not in data:
            raise ConnectorError("MailChimp payload missing fired_at")
        event_time = _parse_time(data["fired_at"])

        def props(*keys: str) -> dict[str, str]:
            return {k.split("[", 1)[1].rstrip("]"): data[k] for k in keys if k in data}

        if event_type in ("subscribe", "unsubscribe", "profile"):
            return {
                "event": event_type,
                "entityType": "user",
                "entityId": data["data[id]"],
                "targetEntityType": "list",
                "targetEntityId": data["data[list_id]"],
                "eventTime": event_time,
                "properties": props(
                    "data[email]",
                    "data[email_type]",
                    "data[merges][FNAME]",
                    "data[merges][LNAME]",
                    "data[ip_opt]",
                    "data[ip_signup]",
                    "data[reason]",
                    "data[campaign_id]",
                ),
            }
        if event_type == "upemail":
            return {
                "event": event_type,
                "entityType": "user",
                "entityId": data["data[new_id]"],
                "targetEntityType": "list",
                "targetEntityId": data["data[list_id]"],
                "eventTime": event_time,
                "properties": props(
                    "data[new_email]", "data[old_email]"
                ),
            }
        if event_type == "cleaned":
            return {
                "event": event_type,
                "entityType": "list",
                "entityId": data["data[list_id]"],
                "eventTime": event_time,
                "properties": props("data[campaign_id]", "data[reason]", "data[email]"),
            }
        # campaign
        return {
            "event": event_type,
            "entityType": "campaign",
            "entityId": data["data[id]"],
            "targetEntityType": "list",
            "targetEntityId": data["data[list_id]"],
            "eventTime": event_time,
            "properties": props(
                "data[subject]", "data[status]", "data[reason]"
            ),
        }
