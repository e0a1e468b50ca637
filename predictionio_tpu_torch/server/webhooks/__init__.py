"""Webhook connectors: third-party payloads -> events.

Parity with the reference webhooks subsystem
(data/.../webhooks/{JsonConnector,FormConnector}.scala:24-25, dispatch in
api/Webhooks.scala, registry in api/WebhooksConnectors.scala). A JSON
connector converts a JSON payload to event JSON; a form connector
converts urlencoded form data. Shipped connectors: Segment.io (JSON, with
shared-secret auth) and MailChimp (form).

Port of ``predictionio_tpu/server/webhooks/__init__.py``.
"""

from __future__ import annotations

import abc
from typing import Any, Mapping


class ConnectorError(ValueError):
    """Raised when a payload cannot be converted (reference
    ConnectorException)."""


class JsonConnector(abc.ABC):
    @abc.abstractmethod
    def to_event_json(self, data: Mapping[str, Any]) -> dict[str, Any]: ...


class FormConnector(abc.ABC):
    @abc.abstractmethod
    def to_event_json(self, data: Mapping[str, str]) -> dict[str, Any]: ...


def default_connectors() -> dict[str, JsonConnector | FormConnector]:
    """Name -> connector registry (reference WebhooksConnectors.scala)."""
    from predictionio_tpu_torch.server.webhooks.mailchimp import MailChimpConnector
    from predictionio_tpu_torch.server.webhooks.segmentio import SegmentIOConnector

    return {
        "segmentio": SegmentIOConnector(),
        "mailchimp": MailChimpConnector(),
    }
