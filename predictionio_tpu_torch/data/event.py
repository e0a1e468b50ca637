"""Canonical event model and validation.

A copy of ``predictionio_tpu/data/event.py`` (the port imports nothing
of the JAX package): the same fields, rules and wire shape, so events
either package writes read the same in the other. Capability parity with the reference event model and validation rules
(data/src/main/scala/org/apache/predictionio/data/storage/Event.scala:42-165):
same fields, same reserved-name semantics ($set/$unset/$delete special
events, ``pio_`` reserved prefix, built-in entity type ``pio_pr``), same
JSON wire shape as the reference Event Server API
(data/.../storage/EventJson4sSupport.scala).
"""

from __future__ import annotations

import json
import uuid
from dataclasses import dataclass, field, replace
from datetime import datetime, timezone
from typing import Any, Mapping

from predictionio_tpu_torch.data.datamap import DataMap

DEFAULT_TIME_ZONE = timezone.utc

SPECIAL_EVENTS = frozenset({"$set", "$unset", "$delete"})
BUILTIN_ENTITY_TYPES = frozenset({"pio_pr"})
BUILTIN_PROPERTIES: frozenset[str] = frozenset()


class EventValidationError(ValueError):
    """Raised when an event violates the canonical validation rules."""


def is_reserved_prefix(name: str) -> bool:
    return name.startswith("$") or name.startswith("pio_")


def is_special_event(name: str) -> bool:
    return name in SPECIAL_EVENTS


def is_builtin_entity_type(name: str) -> bool:
    return name in BUILTIN_ENTITY_TYPES


def _utcnow() -> datetime:
    return datetime.now(tz=DEFAULT_TIME_ZONE)


@dataclass(frozen=True)
class Event:
    """One immutable event.

    Fields mirror the reference's Event case class (Event.scala:42-58).
    ``event_time``/``creation_time`` are timezone-aware datetimes (UTC by
    default).
    """

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: str | None = None
    target_entity_id: str | None = None
    properties: DataMap = field(default_factory=DataMap)
    event_time: datetime = field(default_factory=_utcnow)
    tags: tuple[str, ...] = ()
    pr_id: str | None = None
    creation_time: datetime = field(default_factory=_utcnow)
    event_id: str | None = None

    def __post_init__(self) -> None:
        if not isinstance(self.properties, DataMap):
            object.__setattr__(self, "properties", DataMap(self.properties))
        object.__setattr__(self, "tags", tuple(self.tags))
        object.__setattr__(self, "event_time", _ensure_aware(self.event_time))
        object.__setattr__(self, "creation_time", _ensure_aware(self.creation_time))

    def with_event_id(self, event_id: str) -> "Event":
        return replace(self, event_id=event_id)

    # -- JSON wire format (matches reference API serializer field names) --
    def to_dict(self, for_api: bool = True) -> dict[str, Any]:
        # API output uses millisecond precision (reference
        # DateTimeJson4sSupport); storage (for_api=False) keeps full
        # microseconds so timestamps round-trip exactly
        precision = "ms" if for_api else "us"
        d: dict[str, Any] = {
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
            "properties": self.properties.to_dict(),
            "eventTime": format_time(self.event_time, precision),
        }
        if self.event_id is not None:
            d["eventId"] = self.event_id
        if self.target_entity_type is not None:
            d["targetEntityType"] = self.target_entity_type
        if self.target_entity_id is not None:
            d["targetEntityId"] = self.target_entity_id
        if self.tags:
            d["tags"] = list(self.tags)
        if self.pr_id is not None:
            d["prId"] = self.pr_id
        if not for_api:
            d["creationTime"] = format_time(self.creation_time, precision)
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "Event":
        try:
            event = d["event"]
            entity_type = d["entityType"]
            entity_id = d["entityId"]
        except KeyError as e:
            raise EventValidationError(f"field {e.args[0]} is required") from e
        for name in ("event", "entityType", "entityId"):
            if not isinstance(d[name], str):
                raise EventValidationError(f"field {name} must be a string")
        props = d.get("properties") or {}
        if not isinstance(props, Mapping):
            raise EventValidationError("properties must be a JSON object")
        now = _utcnow()
        return Event(
            event=event,
            entity_type=entity_type,
            entity_id=entity_id,
            target_entity_type=d.get("targetEntityType"),
            target_entity_id=d.get("targetEntityId"),
            properties=DataMap(props),
            event_time=parse_time(d["eventTime"]) if d.get("eventTime") else now,
            tags=tuple(d.get("tags") or ()),
            pr_id=d.get("prId"),
            creation_time=(
                parse_time(d["creationTime"]) if d.get("creationTime") else now
            ),
            event_id=d.get("eventId"),
        )

    @staticmethod
    def from_json(s: str) -> "Event":
        return Event.from_dict(json.loads(s))


def validate(e: Event) -> None:
    """Validate an event; raises EventValidationError on any rule violation.

    Rules mirror EventValidation.validate (Event.scala:112-141).
    """
    _require(bool(e.event), "event must not be empty.")
    _require(bool(e.entity_type), "entityType must not be empty string.")
    _require(bool(e.entity_id), "entityId must not be empty string.")
    _require(
        e.target_entity_type is None or bool(e.target_entity_type),
        "targetEntityType must not be empty string",
    )
    _require(
        e.target_entity_id is None or bool(e.target_entity_id),
        "targetEntityId must not be empty string.",
    )
    _require(
        (e.target_entity_type is None) == (e.target_entity_id is None),
        "targetEntityType and targetEntityId must be specified together.",
    )
    _require(
        not (e.event == "$unset" and e.properties.is_empty()),
        "properties cannot be empty for $unset event",
    )
    _require(
        not is_reserved_prefix(e.event) or is_special_event(e.event),
        f"{e.event} is not a supported reserved event name.",
    )
    _require(
        not is_special_event(e.event)
        or (e.target_entity_type is None and e.target_entity_id is None),
        f"Reserved event {e.event} cannot have targetEntity",
    )
    _require(
        not is_reserved_prefix(e.entity_type) or is_builtin_entity_type(e.entity_type),
        f"The entityType {e.entity_type} is not allowed. "
        "'pio_' is a reserved name prefix.",
    )
    _require(
        e.target_entity_type is None
        or not is_reserved_prefix(e.target_entity_type)
        or is_builtin_entity_type(e.target_entity_type),
        f"The targetEntityType {e.target_entity_type} is not allowed. "
        "'pio_' is a reserved name prefix.",
    )
    for k in e.properties:
        _require(
            not is_reserved_prefix(k) or k in BUILTIN_PROPERTIES,
            f"The property {k} is not allowed. 'pio_' is a reserved name prefix.",
        )


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise EventValidationError(message)


def generate_event_id() -> str:
    return uuid.uuid4().hex


def format_time(dt: datetime, precision: str = "ms") -> str:
    """ISO-8601, e.g. 2026-07-29T00:00:00.000Z.

    ``precision``: "ms" (API parity with the reference's Joda millisecond
    formatter) or "us" (exact round-trip for storage backends). The
    event's original UTC offset is preserved (the reference keeps the
    submitted DateTime's zone through storage and API round-trips,
    storage/EventJson4sSupport.scala); UTC renders as ``Z``.
    """
    dt = _ensure_aware(dt)
    if precision == "us":
        frac = f"{dt.microsecond:06d}"
    else:
        frac = f"{dt.microsecond // 1000:03d}"
    base = dt.strftime("%Y-%m-%dT%H:%M:%S.") + frac
    offset = dt.utcoffset()
    if not offset:
        return base + "Z"
    total = int(offset.total_seconds())
    sign = "+" if total >= 0 else "-"
    total = abs(total)
    out = base + f"{sign}{total // 3600:02d}:{(total % 3600) // 60:02d}"
    if total % 60:  # sub-minute offsets (e.g. LMT zones) must round-trip
        out += f":{total % 60:02d}"
    return out


def parse_time(s: str | datetime) -> datetime:
    if isinstance(s, datetime):
        return _ensure_aware(s)
    text = s.strip()
    if text.endswith("Z"):
        text = text[:-1] + "+00:00"
    try:
        dt = datetime.fromisoformat(text)
    except ValueError as e:
        raise EventValidationError(f"invalid ISO-8601 time: {s!r}") from e
    return _ensure_aware(dt)


def _ensure_aware(dt: datetime) -> datetime:
    if dt.tzinfo is None:
        return dt.replace(tzinfo=DEFAULT_TIME_ZONE)
    return dt
