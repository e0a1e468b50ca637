"""Self-cleaning data source: trailing-window event hygiene.

Port of ``predictionio_tpu/core/self_cleaning.py``, copied whole
with its imports rewritten.

Capability parity with the reference's SelfCleaningDataSource trait
(core/.../core/SelfCleaningDataSource.scala:42-326): an engine data source
can declare an :class:`EventWindow` and get

- **windowing** — events older than the trailing duration are dropped
  (``$set``/``$unset`` property events are always kept so entity state
  survives the window, SelfCleaningDataSource.scala:77-105),
- **property compression** — per-entity ``$set``/``$unset`` streams are
  replayed into a single ``$set`` event carrying the current properties
  (compressPProperties/compress, :107-126,296-319),
- **de-duplication** — events identical up to (eventId, eventTime,
  creationTime) collapse to their earliest occurrence (removePDuplicates,
  :128-152),
- **persisted cleaning** — the cleaned view replaces the stored events:
  new compacted events are inserted, superseded ones deleted
  (cleanPersistedPEvents/wipe, :161-223).

Everything here is a pure host-side fold over time-ordered events (the
reference needed RDD groupBy/subtract; event hygiene is not a TPU hot
path, so plain Python keeps it simple and testable).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone
from typing import Iterable, Sequence

from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import Storage, get_storage

_UNIT_SECONDS = {
    "d": 86400.0, "day": 86400.0, "days": 86400.0,
    "h": 3600.0, "hour": 3600.0, "hours": 3600.0,
    "m": 60.0, "min": 60.0, "minute": 60.0, "minutes": 60.0,
    "s": 1.0, "sec": 1.0, "second": 1.0, "seconds": 1.0,
    "ms": 0.001, "milli": 0.001, "millis": 0.001,
    "millisecond": 0.001, "milliseconds": 0.001,
}

_DURATION_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([a-zA-Z]+)\s*$")


def parse_duration(text: str) -> timedelta:
    """Parse a scala.concurrent.duration-style string ("3 days", "12h",
    "30 seconds") into a timedelta — the EventWindow.duration format
    (SelfCleaningDataSource.scala:81)."""
    m = _DURATION_RE.match(text)
    if not m or m.group(2).lower() not in _UNIT_SECONDS:
        raise ValueError(f"invalid duration: {text!r}")
    return timedelta(seconds=float(m.group(1)) * _UNIT_SECONDS[m.group(2).lower()])


@dataclass(frozen=True)
class EventWindow:
    """Cleanup policy (reference EventWindow case class, :322-326)."""

    duration: str | None = None
    remove_duplicates: bool = False
    compress_properties: bool = False


def _is_property_event(e: Event) -> bool:
    # $delete intentionally excluded (reference isSetEvent, :292-294):
    # deletes pass through compression untouched.
    return e.event in ("$set", "$unset")


def _dedup_key(e: Event) -> str:
    return json.dumps(
        {
            "event": e.event,
            "et": e.entity_type,
            "eid": e.entity_id,
            "tet": e.target_entity_type,
            "teid": e.target_entity_id,
            "props": e.properties.to_dict(),
            "tags": list(e.tags),
            "prId": e.pr_id,
        },
        sort_keys=True,
    )


def _compress_entity(events: Sequence[Event]) -> Event:
    """Replay one entity's time-ordered $set/$unset stream into a single
    $set event holding the current properties (reference compress,
    :296-319 — done here as an ascending replay where later writes win)."""
    props: dict = {}
    for e in events:
        if e.event == "$set":
            props.update(e.properties.to_dict())
        else:  # $unset
            for k in e.properties.keyset():
                props.pop(k, None)
    last = events[-1]
    first = events[0]
    return Event(
        event="$set",
        entity_type=last.entity_type,
        entity_id=last.entity_id,
        properties=DataMap(props),
        event_time=last.event_time,
        creation_time=first.creation_time,
        event_id=None,
    )


def window_events(
    events: Iterable[Event], window: EventWindow, now: datetime | None = None
) -> list[Event]:
    """Drop events older than the trailing window; property events are
    always retained (getCleanedPEvents/getCleanedLEvents, :77-105)."""
    if window.duration is None:
        return list(events)
    now = now or datetime.now(tz=timezone.utc)
    cutoff = now - parse_duration(window.duration)
    return [e for e in events if _is_property_event(e) or e.event_time > cutoff]


def compress_properties(events: Iterable[Event]) -> list[Event]:
    """Collapse each (entityType, entityId)'s $set/$unset events into one
    $set (compressPProperties, :107-117). Non-property events pass through."""
    by_entity: dict[tuple[str, str], list[Event]] = {}
    passthrough: list[Event] = []
    for e in sorted(events, key=lambda ev: ev.event_time):
        if _is_property_event(e):
            by_entity.setdefault((e.entity_type, e.entity_id), []).append(e)
        else:
            passthrough.append(e)
    compacted = [
        # An entity with a single $set is already compact — keep it (and its
        # event id) unchanged so persisted cleaning doesn't churn the store.
        evs[0] if len(evs) == 1 and evs[0].event == "$set" else _compress_entity(evs)
        for evs in by_entity.values()
    ]
    return compacted + passthrough


def remove_duplicates(events: Iterable[Event]) -> list[Event]:
    """Collapse events identical up to (eventId, eventTime, creationTime)
    to their earliest occurrence (removePDuplicates, :128-135)."""
    seen: dict[str, Event] = {}
    for e in sorted(events, key=lambda ev: ev.event_time):
        seen.setdefault(_dedup_key(e), e)
    return list(seen.values())


def clean_events(
    events: Iterable[Event], window: EventWindow | None, now: datetime | None = None
) -> list[Event]:
    """Full cleaning pipeline: window -> compress -> dedup
    (cleanPEvents/cleanLEvents, :231-245,276-289)."""
    evs = list(events)
    if window is None:
        return evs
    evs = window_events(evs, window, now=now)
    if window.compress_properties:
        evs = compress_properties(evs)
    if window.remove_duplicates:
        evs = remove_duplicates(evs)
    return sorted(evs, key=lambda e: e.event_time)


class SelfCleaningDataSource:
    """Mixin for DataSources that want trailing-window hygiene.

    Subclasses set ``app_name`` (and optionally ``channel_name`` /
    ``event_window``); ``read_cleaned_events()`` is the windowed in-memory
    view and ``clean_persisted_events()`` rewrites the store in place.
    """

    app_name: str
    channel_name: str | None = None
    event_window: EventWindow | None = None

    def read_cleaned_events(
        self, storage: Storage | None = None, now: datetime | None = None
    ) -> list[Event]:
        """Cleaned (not persisted) event view (cleanPEvents, :231-245)."""
        events = store.find(
            self.app_name, channel_name=self.channel_name, storage=storage
        )
        return clean_events(events, self.event_window, now=now)

    def clean_persisted_events(
        self, storage: Storage | None = None, now: datetime | None = None
    ) -> tuple[int, int]:
        """Replace stored events with the cleaned view; returns
        (#inserted, #deleted) (cleanPersistedPEvents/wipe, :161-223)."""
        if self.event_window is None:
            return (0, 0)
        storage = storage or get_storage()
        app_id, channel_id = store.app_name_to_id(
            self.app_name, self.channel_name, storage=storage
        )
        events_dao = storage.get_events()
        original = events_dao.find(app_id=app_id, channel_id=channel_id)
        cleaned = clean_events(original, self.event_window, now=now)
        surviving_ids = {e.event_id for e in cleaned if e.event_id is not None}
        inserted = 0
        for e in cleaned:
            if e.event_id is None:  # newly compacted event
                events_dao.insert(e, app_id, channel_id)
                inserted += 1
        deleted = 0
        for e in original:
            if e.event_id is not None and e.event_id not in surviving_ids:
                if events_dao.delete(e.event_id, app_id, channel_id):
                    deleted += 1
        return (inserted, deleted)
