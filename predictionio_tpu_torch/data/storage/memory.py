"""In-memory backend (test mode): every DAO a dict behind a lock.

Port of ``predictionio_tpu/data/storage/memory.py``: apps, access keys,
channels, engine and evaluation instances, models and events.
"""

from __future__ import annotations

import copy
import itertools
import threading
import uuid
from datetime import datetime
from typing import Sequence

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base


class MemoryStorageClient:
    """Holds the shared dicts so all DAOs of one source see the same data."""

    def __init__(self, config: dict | None = None):
        self.config = config or {}
        self.lock = threading.RLock()
        self.apps: dict[int, base.App] = {}
        self.access_keys: dict[str, base.AccessKey] = {}
        self.channels: dict[int, base.Channel] = {}
        self.engine_instances: dict[str, base.EngineInstance] = {}
        self.evaluation_instances: dict[str, base.EvaluationInstance] = {}
        self.models: dict[str, base.Model] = {}
        # (app_id, channel_id) -> event_id -> Event
        self.events: dict[tuple[int, int | None], dict[str, Event]] = {}
        # (app_id, channel_id) -> write counter (Events.change_token)
        self.events_version: dict[tuple[int, int | None], int] = {}
        # (app_id, channel_id) -> [(seq, event_id)] insertion log, seq =
        # the events_version at insert time (Events.tail_events cursor)
        self.tail_logs: dict[tuple[int, int | None], list[tuple[int, str]]] = {}
        self._app_seq = itertools.count(1)
        self._channel_seq = itertools.count(1)
        self._event_seq = itertools.count(1)


class MemoryApps(base.Apps):
    def __init__(self, client: MemoryStorageClient):
        self._c = client

    def insert(self, app: base.App) -> int | None:
        with self._c.lock:
            if app.id != 0:
                app_id = app.id
            else:
                app_id = next(self._c._app_seq)
                while app_id in self._c.apps:
                    app_id = next(self._c._app_seq)
            if app_id in self._c.apps or self.get_by_name(app.name) is not None:
                return None
            self._c.apps[app_id] = base.App(app_id, app.name, app.description)
            return app_id

    def get(self, app_id: int) -> base.App | None:
        with self._c.lock:
            return self._c.apps.get(app_id)

    def get_by_name(self, name: str) -> base.App | None:
        with self._c.lock:
            return next((a for a in self._c.apps.values() if a.name == name), None)

    def get_all(self) -> list[base.App]:
        with self._c.lock:
            return sorted(self._c.apps.values(), key=lambda a: a.id)

    def update(self, app: base.App) -> bool:
        with self._c.lock:
            if app.id not in self._c.apps:
                return False
            self._c.apps[app.id] = app
            return True

    def delete(self, app_id: int) -> bool:
        with self._c.lock:
            return self._c.apps.pop(app_id, None) is not None


class MemoryAccessKeys(base.AccessKeys):
    def __init__(self, client: MemoryStorageClient):
        self._c = client

    def insert(self, access_key: base.AccessKey) -> str | None:
        with self._c.lock:
            key = access_key.key or base.generate_access_key()
            if key in self._c.access_keys:
                return None
            self._c.access_keys[key] = base.AccessKey(
                key, access_key.appid, list(access_key.events)
            )
            return key

    def get(self, key: str) -> base.AccessKey | None:
        with self._c.lock:
            return self._c.access_keys.get(key)

    def get_all(self) -> list[base.AccessKey]:
        with self._c.lock:
            return list(self._c.access_keys.values())

    def get_by_appid(self, appid: int) -> list[base.AccessKey]:
        with self._c.lock:
            return [k for k in self._c.access_keys.values() if k.appid == appid]

    def update(self, access_key: base.AccessKey) -> bool:
        with self._c.lock:
            if access_key.key not in self._c.access_keys:
                return False
            self._c.access_keys[access_key.key] = access_key
            return True

    def delete(self, key: str) -> bool:
        with self._c.lock:
            return self._c.access_keys.pop(key, None) is not None


class MemoryChannels(base.Channels):
    def __init__(self, client: MemoryStorageClient):
        self._c = client

    def insert(self, channel: base.Channel) -> int | None:
        if not base.Channel.is_valid_name(channel.name):
            return None
        with self._c.lock:
            for ch in self._c.channels.values():
                if ch.appid == channel.appid and ch.name == channel.name:
                    return None
            if channel.id != 0:
                channel_id = channel.id
            else:
                channel_id = next(self._c._channel_seq)
                while channel_id in self._c.channels:
                    channel_id = next(self._c._channel_seq)
            if channel_id in self._c.channels:
                return None
            self._c.channels[channel_id] = base.Channel(
                channel_id, channel.name, channel.appid
            )
            return channel_id

    def get(self, channel_id: int) -> base.Channel | None:
        with self._c.lock:
            return self._c.channels.get(channel_id)

    def get_by_appid(self, appid: int) -> list[base.Channel]:
        with self._c.lock:
            return [c for c in self._c.channels.values() if c.appid == appid]

    def delete(self, channel_id: int) -> bool:
        with self._c.lock:
            return self._c.channels.pop(channel_id, None) is not None


class MemoryEngineInstances(base.EngineInstances):
    def __init__(self, client: MemoryStorageClient):
        self._c = client

    def insert(self, instance: base.EngineInstance) -> str:
        with self._c.lock:
            instance_id = instance.id or uuid.uuid4().hex
            instance.id = instance_id
            self._c.engine_instances[instance_id] = copy.deepcopy(instance)
            return instance_id

    def get(self, instance_id: str) -> base.EngineInstance | None:
        with self._c.lock:
            return copy.deepcopy(self._c.engine_instances.get(instance_id))

    def get_all(self) -> list[base.EngineInstance]:
        with self._c.lock:
            return [copy.deepcopy(i) for i in self._c.engine_instances.values()]

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[base.EngineInstance]:
        out = [
            i
            for i in self.get_all()
            if i.status == base.EngineInstanceStatus.COMPLETED
            and i.engine_id == engine_id
            and i.engine_version == engine_version
            and i.engine_variant == engine_variant
        ]
        return sorted(out, key=lambda i: i.start_time, reverse=True)

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> base.EngineInstance | None:
        completed = self.get_completed(engine_id, engine_version, engine_variant)
        return completed[0] if completed else None

    def update(self, instance: base.EngineInstance) -> bool:
        with self._c.lock:
            if instance.id not in self._c.engine_instances:
                return False
            self._c.engine_instances[instance.id] = copy.deepcopy(instance)
            return True

    def delete(self, instance_id: str) -> bool:
        with self._c.lock:
            return self._c.engine_instances.pop(instance_id, None) is not None


class MemoryEvaluationInstances(base.EvaluationInstances):
    def __init__(self, client: MemoryStorageClient):
        self._c = client

    def insert(self, instance: base.EvaluationInstance) -> str:
        with self._c.lock:
            instance_id = instance.id or uuid.uuid4().hex
            instance.id = instance_id
            self._c.evaluation_instances[instance_id] = copy.deepcopy(instance)
            return instance_id

    def get(self, instance_id: str) -> base.EvaluationInstance | None:
        with self._c.lock:
            return copy.deepcopy(self._c.evaluation_instances.get(instance_id))

    def get_all(self) -> list[base.EvaluationInstance]:
        with self._c.lock:
            return [copy.deepcopy(i) for i in self._c.evaluation_instances.values()]

    def get_completed(self) -> list[base.EvaluationInstance]:
        with self._c.lock:
            instances = [copy.deepcopy(i) for i in self._c.evaluation_instances.values()]
        out = [
            i
            for i in instances
            if i.status == base.EvaluationInstanceStatus.EVALCOMPLETED
        ]
        return sorted(out, key=lambda i: i.start_time, reverse=True)

    def update(self, instance: base.EvaluationInstance) -> bool:
        with self._c.lock:
            if instance.id not in self._c.evaluation_instances:
                return False
            self._c.evaluation_instances[instance.id] = copy.deepcopy(instance)
            return True

    def delete(self, instance_id: str) -> bool:
        with self._c.lock:
            return self._c.evaluation_instances.pop(instance_id, None) is not None


class MemoryModels(base.Models):
    def __init__(self, client: MemoryStorageClient):
        self._c = client

    def insert(self, model: base.Model) -> None:
        with self._c.lock:
            self._c.models[model.id] = model

    def get(self, model_id: str) -> base.Model | None:
        with self._c.lock:
            return self._c.models.get(model_id)

    def delete(self, model_id: str) -> bool:
        with self._c.lock:
            return self._c.models.pop(model_id, None) is not None


class MemoryEvents(base.Events):
    def __init__(self, client: MemoryStorageClient):
        self._c = client

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        with self._c.lock:
            self._c.events.setdefault((app_id, channel_id), {})
            return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        with self._c.lock:
            self._bump_locked(app_id, channel_id)
            self._c.tail_logs.pop((app_id, channel_id), None)
            return self._c.events.pop((app_id, channel_id), None) is not None

    def _bump_locked(self, app_id: int, channel_id: int | None) -> None:
        key = (app_id, channel_id)
        self._c.events_version[key] = self._c.events_version.get(key, 0) + 1

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        with self._c.lock:
            table = self._c.events.setdefault((app_id, channel_id), {})
            event_id = event.event_id or f"{next(self._c._event_seq):012x}"
            table[event_id] = event.with_event_id(event_id)
            self._bump_locked(app_id, channel_id)
            self._c.tail_logs.setdefault((app_id, channel_id), []).append(
                (self._c.events_version[(app_id, channel_id)], event_id)
            )
            return event_id

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None:
        with self._c.lock:
            return self._c.events.get((app_id, channel_id), {}).get(event_id)

    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool:
        with self._c.lock:
            table = self._c.events.get((app_id, channel_id), {})
            self._bump_locked(app_id, channel_id)
            return table.pop(event_id, None) is not None

    def change_token(
        self, app_id: int, channel_id: int | None = None
    ) -> object | None:
        with self._c.lock:
            return self._c.events_version.get((app_id, channel_id), 0)

    def tail_end(
        self, app_id: int, channel_id: int | None = None
    ) -> object | None:
        with self._c.lock:
            return self._c.events_version.get((app_id, channel_id), 0)

    def tail_events(
        self,
        app_id: int,
        channel_id: int | None = None,
        after: object | None = None,
        limit: int | None = None,
    ) -> tuple[list[Event], object]:
        """Replay the insertion log past ``after`` (an events_version
        value). Deleted events are skipped; replaced events are returned
        in their CURRENT state (last write wins, like the stores)."""
        cursor = int(after or 0)
        out: list[Event] = []
        with self._c.lock:
            log = self._c.tail_logs.get((app_id, channel_id), [])
            table = self._c.events.get((app_id, channel_id), {})
            for seq, event_id in log:
                if seq <= cursor:
                    continue
                cursor = seq
                e = table.get(event_id)
                if e is not None:
                    out.append(e)
                if limit is not None and limit > 0 and len(out) >= limit:
                    break
        return out, cursor

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type=...,
        target_entity_id=...,
        limit: int | None = None,
        reversed_order: bool = False,
    ) -> list[Event]:
        with self._c.lock:
            events = list(self._c.events.get((app_id, channel_id), {}).values())
        return query_events(
            events, start_time, until_time, entity_type, entity_id, event_names,
            target_entity_type, target_entity_id, limit, reversed_order,
        )


def query_events(
    events: list[Event],
    start_time=None,
    until_time=None,
    entity_type=None,
    entity_id=None,
    event_names=None,
    target_entity_type=...,
    target_entity_id=...,
    limit=None,
    reversed_order=False,
) -> list[Event]:
    """Filter, then a stable sort by event time (LEvents.futureFind): the
    memory, jsonl and partitioned backends' shared query."""

    def keep(e: Event) -> bool:
        return (
            (start_time is None or e.event_time >= start_time)
            and (until_time is None or e.event_time < until_time)
            and (entity_type is None or e.entity_type == entity_type)
            and (entity_id is None or e.entity_id == entity_id)
            and (event_names is None or e.event in event_names)
            and (target_entity_type is ...
                 or e.target_entity_type == target_entity_type)
            and (target_entity_id is ... or e.target_entity_id == target_entity_id)
        )

    out = sorted(filter(keep, events), key=lambda e: e.event_time,
                 reverse=reversed_order)
    if limit is not None and limit >= 0:
        out = out[:limit]
    return out
