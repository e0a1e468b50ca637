"""Storage records and DAO contracts.

Port of ``predictionio_tpu/data/storage/base.py``: the ``App``,
``AccessKey``, ``Channel``, ``EngineInstance``, ``EvaluationInstance``
and ``Model`` records, the columnar ``RatingsBatch``, and the DAO
contracts (reference Apps.scala:32, AccessKeys.scala:35,
Channels.scala:32, EngineInstances.scala:46, EvaluationInstances.scala:42,
Models.scala:33, LEvents.scala:40), with property aggregation,
``Events.change_token``, ``entity_indexed`` and the tails.
"""

from __future__ import annotations

import abc
import base64
import re
import secrets
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Iterable, Sequence

import numpy as np

from predictionio_tpu_torch.data.event import Event


@dataclass
class App:
    """An application namespace for events (reference Apps.scala:32-44)."""

    id: int
    name: str
    description: str | None = None


@dataclass
class AccessKey:
    """Event-server credential, scoped to an app and optionally to specific
    event names (reference AccessKeys.scala:35-50)."""

    key: str
    appid: int
    events: list[str] = field(default_factory=list)


def generate_access_key() -> str:
    """64 random bytes, URL-safe base64 (reference AccessKeys.generateKey).
    Keys never start with ``-``, so they stay safe to pass as positional
    CLI arguments."""
    while True:
        key = base64.urlsafe_b64encode(secrets.token_bytes(48)).decode("ascii").rstrip("=")
        if not key.startswith("-"):
            return key


CHANNEL_NAME_RE = re.compile(r"^[a-zA-Z0-9-]{1,16}$")


@dataclass
class Channel:
    """A named sub-stream of an app's events (reference Channels.scala:32-45);
    names are 1-16 alphanumeric or '-' characters."""

    id: int
    name: str
    appid: int

    @staticmethod
    def is_valid_name(name: str) -> bool:
        return bool(CHANNEL_NAME_RE.match(name))


class EngineInstanceStatus:
    INIT = "INIT"
    TRAINING = "TRAINING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"


@dataclass
class EngineInstance:
    """One training run's metadata (reference EngineInstances.scala:46-97)."""

    id: str
    status: str
    start_time: datetime
    end_time: datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: dict[str, str] = field(default_factory=dict)
    runtime_conf: dict[str, str] = field(default_factory=dict)
    datasource_params: str = "{}"
    preparator_params: str = "{}"
    algorithms_params: str = "[]"
    serving_params: str = "{}"


class EvaluationInstanceStatus:
    INIT = "INIT"
    EVALUATING = "EVALUATING"
    EVALCOMPLETED = "EVALCOMPLETED"
    FAILED = "FAILED"


@dataclass
class EvaluationInstance:
    """One evaluation run's metadata (reference EvaluationInstances.scala:42-81)."""

    id: str
    status: str
    start_time: datetime
    end_time: datetime
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: dict[str, str] = field(default_factory=dict)
    runtime_conf: dict[str, str] = field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


@dataclass
class Model:
    """A serialized trained model blob (reference Models.scala:33-51)."""

    id: str
    models: bytes


class EngineInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EngineInstance) -> str:
        """Insert; empty id means auto-assign. Returns the id."""

    @abc.abstractmethod
    def get(self, instance_id: str) -> EngineInstance | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[EngineInstance]: ...

    @abc.abstractmethod
    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None:
        """Most recent COMPLETED instance for (engineId, version, variant) —
        what ``deploy`` picks (reference commands/Engine.scala:224-230)."""

    @abc.abstractmethod
    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]: ...

    @abc.abstractmethod
    def update(self, instance: EngineInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class EvaluationInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EvaluationInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> EvaluationInstance | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_completed(self) -> list[EvaluationInstance]: ...

    @abc.abstractmethod
    def update(self, instance: EvaluationInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class Models(abc.ABC):
    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Model | None: ...

    @abc.abstractmethod
    def delete(self, model_id: str) -> bool: ...

    def local_path(self, model_id: str) -> str | None:
        """Filesystem path of the stored blob when the backend keeps it
        as a plain local file (localfs), else None. The deploy path maps
        such files in place instead of copying the bytes."""
        return None


class Apps(abc.ABC):
    @abc.abstractmethod
    def insert(self, app: App) -> int | None:
        """Insert; app.id == 0 means auto-assign. Returns the assigned id,
        or None when the id or name is taken."""

    @abc.abstractmethod
    def get(self, app_id: int) -> App | None: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> App | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> bool: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> bool: ...


class AccessKeys(abc.ABC):
    @abc.abstractmethod
    def insert(self, access_key: AccessKey) -> str | None:
        """Insert; an empty key means generate one. Returns the key, or
        None when it is taken."""

    @abc.abstractmethod
    def get(self, key: str) -> AccessKey | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[AccessKey]: ...

    @abc.abstractmethod
    def get_by_appid(self, appid: int) -> list[AccessKey]: ...

    @abc.abstractmethod
    def update(self, access_key: AccessKey) -> bool: ...

    @abc.abstractmethod
    def delete(self, key: str) -> bool: ...


class Channels(abc.ABC):
    @abc.abstractmethod
    def insert(self, channel: Channel) -> int | None:
        """Insert; channel.id == 0 means auto-assign. Returns the id."""

    @abc.abstractmethod
    def get(self, channel_id: int) -> Channel | None: ...

    @abc.abstractmethod
    def get_by_appid(self, appid: int) -> list[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> bool: ...


@dataclass
class RatingsBatch:
    """Columnar (entity, target, value) training triples with dense ids:
    ``entity_ids[rows[i]] -> target_ids[cols[i]]`` carries ``vals[i]``;
    the id lists double as the BiMap (dense index = list position)."""

    entity_ids: list[str]
    target_ids: list[str]
    rows: Any  # np.ndarray [N] int32
    cols: Any  # np.ndarray [N] int32
    vals: Any  # np.ndarray [N] float32

    def __len__(self) -> int:
        return len(self.vals)

    @staticmethod
    def empty() -> "RatingsBatch":
        return RatingsBatch(
            [], [],
            np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0, np.float32),
        )


class Events(abc.ABC):
    """Event CRUD and queries for one backend (reference LEvents.scala:
    40-513, PEvents.scala:38-188): point operations and ``find``, and
    ``scan_ratings``, the columnar bulk read training uses."""

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        """Create the backing table/namespace for an (app, channel)."""

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        """Drop all events of an (app, channel)."""

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        """Insert one event, returning its event id. The (app, channel)
        namespace is created on first insert, and an existing
        ``event_id`` is replaced."""

    @abc.abstractmethod
    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None: ...

    @abc.abstractmethod
    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool: ...

    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None | type(...) = ...,
        target_entity_id: str | None | type(...) = ...,
        limit: int | None = None,
        reversed_order: bool = False,
    ) -> list[Event]:
        """Query events. ``target_entity_type``/``target_entity_id`` take
        ``...`` for "don't care" and ``None`` for "must be absent"
        (LEvents.scala:282-313). ``limit=None`` or ``-1`` means all."""

    def batch_insert(
        self, events: Iterable[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        return [self.insert(e, app_id, channel_id) for e in events]

    # True when find(entity_id=...) is served by an index (SQL btree,
    # server-side filter) rather than a full replay+filter. Serving-time
    # caches use this to choose between per-entity reads (indexed) and
    # one bulk scan that amortizes across entities (replay backends,
    # where a filtered read costs a full replay anyway).
    entity_indexed = False

    def tail_events(
        self,
        app_id: int,
        channel_id: int | None = None,
        after: object | None = None,
        limit: int | None = None,
    ) -> tuple[list[Event], object] | None:
        """Incremental seq-ordered tail: events appended after cursor
        ``after`` in a backend-defined total order, plus the new cursor.

        ``None`` (the default) means the backend has no cheap seq-ordered
        tail, and the realtime tailer falls back to ``change_token``-gated
        full reads. ``after=None`` starts from the beginning of the
        stream. The cursor is opaque to callers (compare/persist only); a
        backend MAY re-deliver events at the cursor boundary -- consumers
        must dedupe by ``event_id``.
        """
        return None

    def tail_end(
        self, app_id: int, channel_id: int | None = None
    ) -> object | None:
        """Current end-of-stream cursor for :meth:`tail_events` (what a
        tailer resets to when it wants "only events from now on"), or
        ``None`` when the backend has no seq-ordered tail."""
        return None

    def change_token(
        self, app_id: int, channel_id: int | None = None
    ) -> object | None:
        """Cheap opaque token that changes whenever this (app, channel)'s
        event set may have changed; compare tokens with ``!=`` only.

        ``None`` means the backend cannot provide one cheaply -- callers
        must then re-read instead of caching. Serving-time business-rule
        caches (the e-commerce template's live seen/unavailable filters)
        key on this so a static store serves from memory while any write
        -- including cross-process ones, for the sqlite backend -- is
        seen immediately. Tokens may over-invalidate (e.g. one app's
        write bumping another's token); they must never under-invalidate.
        """
        return None

    def scan_ratings(
        self,
        app_id: int,
        channel_id: int | None = None,
        *,
        event_names: Sequence[str] | None = None,
        entity_type: str | None = None,
        target_entity_type: str | None = None,
        rating_key: str | None = "rating",
        default_ratings: dict[str, float] | None = None,
        override_ratings: dict[str, float] | None = None,
    ) -> RatingsBatch:
        """Columnar bulk read of (entity -> target, value) training data,
        dense-indexed in scan order. ``default_ratings`` maps event names
        to values used when the ``rating_key`` property is absent or not
        a number; ``override_ratings`` maps event names to FORCED values
        (the reference's ``case "buy" => 4.0``, DataSource.scala:55);
        ``rating_key=None`` takes every event's name default. Backends
        override this with a columnar read; this walks ``find``."""
        user_map: dict[str, int] = {}
        item_map: dict[str, int] = {}
        rows: list[int] = []
        cols: list[int] = []
        vals: list[float] = []
        for e in self.find(
            app_id,
            channel_id,
            entity_type=entity_type,
            event_names=list(event_names) if event_names is not None else None,
            target_entity_type=(
                target_entity_type if target_entity_type is not None else ...
            ),
        ):
            if e.target_entity_id is None:
                continue
            v = (override_ratings or {}).get(e.event)
            if v is None:
                v = (
                    e.properties.to_dict().get(rating_key)
                    if rating_key is not None
                    else None
                )
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    v = (default_ratings or {}).get(e.event)
            if v is None:
                continue
            rows.append(user_map.setdefault(e.entity_id, len(user_map)))
            cols.append(item_map.setdefault(e.target_entity_id, len(item_map)))
            vals.append(float(v))
        return RatingsBatch(
            entity_ids=list(user_map),
            target_ids=list(item_map),
            rows=np.asarray(rows, dtype=np.int32),
            cols=np.asarray(cols, dtype=np.int32),
            vals=np.asarray(vals, dtype=np.float32),
        )

    def aggregate_properties(
        self,
        app_id: int,
        channel_id: int | None = None,
        entity_type: str = "",
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        required: Sequence[str] | None = None,
    ) -> dict[str, Any]:
        """Aggregated entityId -> PropertyMap view (LEvents.scala:373-418):
        the entity type's ``$set`` / ``$unset`` / ``$delete`` events
        replayed in time order (``data/aggregator.py``).

        ``entity_type`` is mandatory (as in the reference API): aggregating
        across entity types would merge unrelated entities sharing an id.
        """
        if not entity_type:
            raise ValueError("aggregate_properties requires entity_type")
        from predictionio_tpu_torch.data.aggregator import (
            AGGREGATOR_EVENT_NAMES,
            aggregate_properties,
        )

        events = self.find(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            event_names=list(AGGREGATOR_EVENT_NAMES),
        )
        result = aggregate_properties(events)
        if required:
            req = set(required)
            result = {k: v for k, v in result.items() if req.issubset(v.keyset())}
        return result

    def close(self) -> None:
        """Release backend resources."""
