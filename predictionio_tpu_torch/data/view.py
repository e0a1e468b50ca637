"""Deprecated batch views over the event store.

Port of ``predictionio_tpu/data/view.py``, copied whole
with its imports rewritten.

Parity with the reference's pre-EventStore aggregation views
(data/src/main/scala/org/apache/predictionio/data/view/{LBatchView,
PBatchView,DataView}.scala — all ``@deprecated`` since 0.9.2 in favor of
LEvents/LEventStore). Kept for the same reason the reference keeps them:
old engine templates still import them. New code should use
``predictionio_tpu_torch.data.store`` / ``predictionio_tpu_torch.data.aggregator``.

The L/P split collapses here: both views read the same host-side event
store (there is no RDD substrate to distinguish them), so ``PBatchView``
is an alias that exists for import parity.
"""

from __future__ import annotations

import copy
import warnings
from datetime import datetime
from typing import Any, Callable, Iterable, TypeVar

from predictionio_tpu_torch.data.aggregator import aggregate_properties
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.propertymap import PropertyMap

T = TypeVar("T")

_MSG = "deprecated since the reference's 0.9.2; use data.store / data.aggregator"


def _warn(name: str) -> None:
    warnings.warn(f"{name} is {_MSG}", DeprecationWarning, stacklevel=3)


class ViewPredicates:
    """Event-filter predicate builders (reference ViewPredicates,
    view/LBatchView.scala:31-75)."""

    @staticmethod
    def start_time(start: datetime | None) -> Callable[[Event], bool]:
        _warn("ViewPredicates.start_time")
        if start is None:
            return lambda e: True
        return lambda e: e.event_time >= start

    @staticmethod
    def until_time(until: datetime | None) -> Callable[[Event], bool]:
        _warn("ViewPredicates.until_time")
        if until is None:
            return lambda e: True
        return lambda e: e.event_time < until

    @staticmethod
    def entity_type(entity_type: str | None) -> Callable[[Event], bool]:
        _warn("ViewPredicates.entity_type")
        if entity_type is None:
            return lambda e: True
        return lambda e: e.entity_type == entity_type

    @staticmethod
    def event_name(event: str | None) -> Callable[[Event], bool]:
        _warn("ViewPredicates.event_name")
        if event is None:
            return lambda e: True
        return lambda e: e.event == event


class EventSeq:
    """An in-memory event list with filter / ordered-fold helpers
    (reference EventSeq, view/LBatchView.scala:103-144)."""

    def __init__(self, events: Iterable[Event]):
        self.events: list[Event] = list(events)

    def filter(
        self,
        event_name: str | None = None,
        entity_type: str | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        predicate: Callable[[Event], bool] | None = None,
    ) -> "EventSeq":
        _warn("EventSeq.filter")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            preds = [
                ViewPredicates.event_name(event_name),
                ViewPredicates.entity_type(entity_type),
                ViewPredicates.start_time(start_time),
                ViewPredicates.until_time(until_time),
            ]
        if predicate is not None:
            preds.append(predicate)
        return EventSeq(
            e for e in self.events if all(p(e) for p in preds)
        )

    def aggregate_by_entity_ordered(
        self, init: T, op: Callable[[T, Event], T]
    ) -> dict[str, T]:
        """Fold events per entity id in event-time order (reference
        aggregateByEntityOrdered, view/LBatchView.scala:134-144)."""
        _warn("EventSeq.aggregate_by_entity_ordered")
        by_entity: dict[str, list[Event]] = {}
        for e in self.events:
            by_entity.setdefault(e.entity_id, []).append(e)
        out: dict[str, T] = {}
        for eid, events in by_entity.items():
            # each entity folds from its own copy: a mutable init (e.g. a
            # list the op appends to) must not be shared across entities
            acc = copy.deepcopy(init)
            for e in sorted(events, key=lambda ev: ev.event_time):
                acc = op(acc, e)
            out[eid] = acc
        return out

    def __iter__(self):
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)


class LBatchView:
    """Deprecated whole-app event view (reference LBatchView,
    view/LBatchView.scala:146-200). Reads all events of an app once and
    answers aggregate/filter queries in memory."""

    def __init__(
        self,
        app_id: int,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        storage=None,
    ):
        _warn(type(self).__name__)
        from predictionio_tpu_torch.data.storage import get_storage

        self.app_id = app_id
        s = storage if storage is not None else get_storage()
        events = s.get_events().find(
            app_id, start_time=start_time, until_time=until_time
        )
        self._events = EventSeq(events)

    @property
    def events(self) -> EventSeq:
        return self._events

    def aggregate_properties(
        self, entity_type: str | None = None
    ) -> dict[str, DataMap]:
        """Replay $set/$unset/$delete into current properties per entity
        (reference LBatchView.aggregateProperties:169)."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            seq = self._events.filter(entity_type=entity_type)
        props: dict[str, PropertyMap] = aggregate_properties(seq)
        return {eid: DataMap(dict(pm)) for eid, pm in props.items()}


class PBatchView(LBatchView):
    """Import-parity alias of LBatchView (reference PBatchView,
    view/PBatchView.scala:163 — the RDD flavor; no separate substrate
    here)."""


class DataView:
    """Deprecated typed projection of events (reference DataView.create,
    view/DataView.scala:40-80): map each event through a row function and
    collect non-None results."""

    @staticmethod
    def create(
        events: Iterable[Event], row_fn: Callable[[Event], Any | None]
    ) -> list[Any]:
        _warn("DataView.create")
        out = []
        for e in events:
            row = row_fn(e)
            if row is not None:
                out.append(row)
        return out
