"""In-memory backend (test mode): engine instances and models in dicts."""

from __future__ import annotations

import copy
import threading
import uuid

from predictionio_tpu_torch.data.storage import base


class MemoryStorageClient:
    """Holds the shared dicts so all DAOs of one source see the same data."""

    def __init__(self, config: dict | None = None):
        self.config = config or {}
        self.lock = threading.RLock()
        self.engine_instances: dict[str, base.EngineInstance] = {}
        self.models: dict[str, base.Model] = {}


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
