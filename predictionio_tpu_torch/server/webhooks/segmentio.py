"""Segment.io webhook connector.

Parity with the reference SegmentIOConnector
(data/.../webhooks/segmentio/SegmentIOConnector.scala:24-186): supports
the identify/track/alias/page/screen/group message types, maps
userId-or-anonymousId to the ``user`` entity, carries type-specific
fields plus optional ``context`` into properties, and authenticates with
the shared-secret HTTP basic scheme (SegmentIOAuthSpec).

Port of ``predictionio_tpu/server/webhooks/segmentio.py``.
"""

from __future__ import annotations

from typing import Any, Mapping

from predictionio_tpu_torch.server.webhooks import ConnectorError, JsonConnector


class SegmentIOConnector(JsonConnector):
    def to_event_json(self, data: Mapping[str, Any]) -> dict[str, Any]:
        if "version" not in data:
            raise ConnectorError("Failed to get segment.io API version.")
        msg_type = data.get("type")
        user_id = data.get("userId") or data.get("anonymousId")
        if not user_id:
            raise ConnectorError(
                "there was no `userId` or `anonymousId` in the common fields."
            )

        if msg_type == "identify":
            props: dict[str, Any] = {"traits": data.get("traits")}
        elif msg_type == "track":
            props = {
                "properties": data.get("properties"),
                "event": data.get("event"),
            }
        elif msg_type == "alias":
            props = {"previous_id": data.get("previousId") or data.get("previous_id")}
        elif msg_type == "page":
            props = {"name": data.get("name"), "properties": data.get("properties")}
        elif msg_type == "screen":
            props = {"name": data.get("name"), "properties": data.get("properties")}
        elif msg_type == "group":
            props = {
                "group_id": data.get("groupId") or data.get("group_id"),
                "traits": data.get("traits"),
            }
        else:
            raise ConnectorError(
                f"Cannot convert unknown type {msg_type} to event JSON."
            )

        if data.get("context") is not None:
            props["context"] = data["context"]
        props = {k: v for k, v in props.items() if v is not None}

        event_json: dict[str, Any] = {
            "event": msg_type,
            "entityType": "user",
            "entityId": user_id,
            "properties": props,
        }
        if data.get("timestamp"):
            event_json["eventTime"] = data["timestamp"]
        return event_json
