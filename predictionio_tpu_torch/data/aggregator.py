"""Replay of $set/$unset/$delete events into current entity properties.

A copy of ``predictionio_tpu/data/aggregator.py`` for the port.

Capability parity with the reference's LEventAggregator/PEventAggregator
(data/.../storage/LEventAggregator.scala:42, PEventAggregator.scala:198 and
the EventOp/SetProp/UnsetProp/DeleteEntity algebra at :38-196). The replay
is a pure fold over time-ordered events:

- ``$set``    merges properties (later values win),
- ``$unset``  removes the named keys,
- ``$delete`` drops the entity entirely (subsequent ``$set`` recreates it),
- any other event name leaves properties untouched.

first/last updated times track the special events only.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime
from typing import Iterable

from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.propertymap import PropertyMap

AGGREGATOR_EVENT_NAMES = ("$set", "$unset", "$delete")


@dataclass
class _Prop:
    dm: DataMap | None = None
    first_updated: datetime | None = None
    last_updated: datetime | None = None


def _fold(p: _Prop, e: Event) -> _Prop:
    if e.event == "$set":
        dm = e.properties if p.dm is None else p.dm.merge(e.properties)
    elif e.event == "$unset":
        dm = None if p.dm is None else p.dm.remove(e.properties.keyset())
    elif e.event == "$delete":
        dm = None
    else:
        return p
    first = p.first_updated if p.first_updated is not None else e.event_time
    return _Prop(dm=dm, first_updated=first, last_updated=e.event_time)


def aggregate_properties_single(events: Iterable[Event]) -> PropertyMap | None:
    """Replay one entity's events (any order) into its current PropertyMap.

    Returns None when the entity has no surviving properties (never $set,
    or last action deleted it). Mirrors
    LEventAggregator.aggregatePropertiesSingle (:72-92).
    """
    prop = _Prop()
    for e in sorted(events, key=lambda ev: ev.event_time):
        prop = _fold(prop, e)
    if prop.dm is None:
        return None
    assert prop.first_updated is not None and prop.last_updated is not None
    return PropertyMap(prop.dm.to_dict(), prop.first_updated, prop.last_updated)


def aggregate_properties(events: Iterable[Event]) -> dict[str, PropertyMap]:
    """Replay a stream of events into entityId -> current PropertyMap.

    Mirrors LEventAggregator.aggregateProperties (:42-61); the batched/
    distributed variant (PEventAggregator's aggregateByKey) reduces to the
    same pure fold since the host-side event volume is not the device hot path.
    """
    by_entity: dict[str, list[Event]] = {}
    for e in events:
        by_entity.setdefault(e.entity_id, []).append(e)
    out: dict[str, PropertyMap] = {}
    for entity_id, evs in by_entity.items():
        pm = aggregate_properties_single(evs)
        if pm is not None:
            out[entity_id] = pm
    return out
