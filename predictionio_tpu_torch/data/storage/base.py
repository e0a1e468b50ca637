"""Storage records and DAO contracts for engine instances and models.

Port of the serving subset of ``predictionio_tpu/data/storage/base.py``:
the ``EngineInstance`` and ``Model`` records and their two DAO contracts
(reference EngineInstances.scala:46, Models.scala:33). Apps, access
keys, channels and events come with the training slice.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from datetime import datetime


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
