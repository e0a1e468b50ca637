"""Storage registry: env-var-driven backend selection and DAO factory.

Port of ``predictionio_tpu/data/storage/__init__.py`` with the same
environment parsing (:222-310), so both packages given one environment
find the same database and model directory:

- sources configured via ``PIO_STORAGE_SOURCES_<NAME>_TYPE`` plus
  per-source properties (``PIO_STORAGE_SOURCES_<NAME>_<KEY>``),
- METADATA / EVENTDATA / MODELDATA repositories bound to sources via
  ``PIO_STORAGE_REPOSITORIES_<REPO>_SOURCE``,
- zero-config default: sqlite ``pio.db`` + localfs ``models/`` under
  ``PIO_FS_BASEDIR`` (default ``~/.pio_tpu``).

The port's backends so far: sqlite and memory (apps, access keys,
channels, engine and evaluation instances, models, events), localfs
(models), and the file-log event stores jsonl and partitioned (events;
``jsonl.py``, ``partitioned.py``, byte-compatible with the JAX package's).
Other backend types -- postgres, http, search, hdfs, s3 -- parse (their
capabilities steer the default bindings exactly as in the JAX package)
but raise :class:`StorageError`, naming the type, when a DAO is asked of
them: an EVENTDATA repository bound to one of them cannot be read by the
port yet.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable

from predictionio_tpu_torch.data.storage.base import (  # noqa: F401 (public re-exports)
    AccessKey,
    AccessKeys,
    App,
    Apps,
    Channel,
    Channels,
    EngineInstance,
    EngineInstanceStatus,
    EngineInstances,
    EvaluationInstance,
    EvaluationInstanceStatus,
    EvaluationInstances,
    Events,
    Model,
    Models,
    RatingsBatch,
    generate_access_key,
)

METADATA = "METADATA"
EVENTDATA = "EVENTDATA"
MODELDATA = "MODELDATA"
REPOSITORIES = (METADATA, EVENTDATA, MODELDATA)


class StorageError(RuntimeError):
    pass


class _Backend:
    """A registered backend type: client factory + DAO factories."""

    def __init__(
        self,
        client_factory: Callable[[dict], Any],
        daos: dict[str, Callable[[Any], Any]],
    ):
        self.client_factory = client_factory
        self.daos = daos


def _sqlite_backend() -> _Backend:
    from predictionio_tpu_torch.data.storage import sqlite as sq

    return _Backend(
        client_factory=lambda cfg: sq.SQLiteStorageClient(cfg),
        daos={
            "Apps": sq.SQLiteApps,
            "AccessKeys": sq.SQLiteAccessKeys,
            "Channels": sq.SQLiteChannels,
            "EngineInstances": sq.SQLiteEngineInstances,
            "EvaluationInstances": sq.SQLiteEvaluationInstances,
            "Models": sq.SQLiteModels,
            "Events": sq.SQLiteEvents,
        },
    )


def _memory_backend() -> _Backend:
    from predictionio_tpu_torch.data.storage import memory as mem

    return _Backend(
        client_factory=lambda cfg: mem.MemoryStorageClient(cfg),
        daos={
            "Apps": mem.MemoryApps,
            "AccessKeys": mem.MemoryAccessKeys,
            "Channels": mem.MemoryChannels,
            "EngineInstances": mem.MemoryEngineInstances,
            "EvaluationInstances": mem.MemoryEvaluationInstances,
            "Models": mem.MemoryModels,
            "Events": mem.MemoryEvents,
        },
    )


def _localfs_backend() -> _Backend:
    from predictionio_tpu_torch.data.storage import localfs as lf

    return _Backend(
        client_factory=lambda cfg: lf.LocalFSStorageClient(cfg),
        daos={"Models": lf.LocalFSModels},
    )


def _jsonl_backend() -> _Backend:
    from predictionio_tpu_torch.data.storage import jsonl as jl

    return _Backend(
        client_factory=lambda cfg: jl.JSONLStorageClient(cfg),
        daos={"Events": jl.JSONLEvents},
    )


def _partitioned_backend() -> _Backend:
    from predictionio_tpu_torch.data.storage import partitioned as pt

    return _Backend(
        client_factory=lambda cfg: pt.PartitionedStorageClient(cfg),
        daos={"Events": pt.PartitionedEvents},
    )


_BACKEND_TYPES: dict[str, Callable[[], _Backend]] = {
    "sqlite": _sqlite_backend,
    "memory": _memory_backend,
    "localfs": _localfs_backend,
    "jsonl": _jsonl_backend,
    "partitioned": _partitioned_backend,
}

# which repositories each backend type can serve -- the JAX package's
# table, kept whole so default bindings agree between the packages
_TYPE_CAPABILITIES: dict[str, tuple[str, ...]] = {
    "sqlite": REPOSITORIES,
    "memory": REPOSITORIES,
    "localfs": (MODELDATA,),
    "jsonl": (EVENTDATA,),
    "partitioned": (EVENTDATA,),
    "hdfs": (MODELDATA,),
    "s3": (MODELDATA,),
    "http": REPOSITORIES,
    "search": REPOSITORIES,
    "postgres": REPOSITORIES,
}


class Storage:
    """The storage registry. Usually used via the module-level singleton."""

    def __init__(self, env: dict[str, str] | None = None):
        self.env = dict(env) if env is not None else dict(os.environ)
        self._lock = threading.RLock()
        self._clients: dict[str, Any] = {}
        self._backends: dict[str, _Backend] = {}
        self._source_types: dict[str, str] = {}
        self._source_configs: dict[str, dict] = {}
        self._repo_to_source: dict[str, str] = {}
        self._parse_config()

    def _parse_config(self) -> None:
        base_dir = os.path.expanduser(
            self.env.get("PIO_FS_BASEDIR", os.path.join("~", ".pio_tpu"))
        )
        prefix = "PIO_STORAGE_SOURCES_"
        sources: dict[str, dict] = {}
        # Source names may contain underscores: anchor on the *_TYPE keys to
        # learn the names, then assign remaining props by longest-name match.
        source_keys = [k for k in self.env if k.startswith(prefix)]
        names = sorted(
            (k[len(prefix):-len("_TYPE")] for k in source_keys if k.endswith("_TYPE")),
            key=len,
            reverse=True,
        )
        for name in names:
            sources[name] = {"type": self.env[f"{prefix}{name}_TYPE"]}
        for k in source_keys:
            if k.endswith("_TYPE"):
                continue
            rest = k[len(prefix):]
            owner = next((n for n in names if rest.startswith(n + "_")), None)
            if owner is None:
                raise StorageError(
                    f"cannot match env var {k} to a configured source "
                    f"(known sources: {sorted(names)}); did you set "
                    f"{prefix}<NAME>_TYPE?"
                )
            prop = rest[len(owner) + 1 :]
            sources[owner][prop.lower()] = self.env[k]
        if not sources:
            sources = {
                "SQLITE": {"type": "sqlite", "path": os.path.join(base_dir, "pio.db")},
                "LOCALFS": {
                    "type": "localfs",
                    "path": os.path.join(base_dir, "models"),
                },
            }
        for name, cfg in sources.items():
            source_type = cfg.pop("type", None)
            if source_type is None:
                raise StorageError(f"source {name} has no TYPE")
            self._source_types[name] = source_type
            self._source_configs[name] = cfg

        def first_capable(repo: str) -> str:
            capable = [
                n
                for n, t in self._source_types.items()
                if repo in _TYPE_CAPABILITIES.get(t, ())
            ]
            if capable:
                # most specialized wins: a models-only source beats the
                # general SQL source for MODELDATA
                return min(
                    capable,
                    key=lambda n: len(
                        _TYPE_CAPABILITIES.get(self._source_types[n], REPOSITORIES)
                    ),
                )
            return next(iter(self._source_types))

        for repo in REPOSITORIES:
            src = self.env.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE")
            if src is None:
                src = first_capable(repo)
            if src not in self._source_types:
                raise StorageError(
                    f"repository {repo} references unknown source {src}"
                )
            self._repo_to_source[repo] = src

    def _backend(self, source_name: str) -> _Backend:
        with self._lock:
            if source_name not in self._backends:
                source_type = self._source_types[source_name]
                if source_type not in _BACKEND_TYPES:
                    raise StorageError(
                        f"storage backend type {source_type} is not ported "
                        f"to the PyTorch package (have: {sorted(_BACKEND_TYPES)})"
                    )
                self._backends[source_name] = _BACKEND_TYPES[source_type]()
            return self._backends[source_name]

    def _client(self, source_name: str) -> Any:
        with self._lock:
            if source_name not in self._clients:
                backend = self._backend(source_name)
                self._clients[source_name] = backend.client_factory(
                    self._source_configs[source_name]
                )
            return self._clients[source_name]

    def _dao(self, repo: str, dao_name: str) -> Any:
        source_name = self._repo_to_source[repo]
        backend = self._backend(source_name)
        if dao_name not in backend.daos:
            raise StorageError(
                f"backend {self._source_types[source_name]} (source {source_name}) "
                f"does not support {dao_name}"
            )
        return backend.daos[dao_name](self._client(source_name))

    def get_metadata_apps(self) -> Apps:
        return self._dao(METADATA, "Apps")

    def get_metadata_access_keys(self) -> AccessKeys:
        return self._dao(METADATA, "AccessKeys")

    def get_metadata_channels(self) -> Channels:
        return self._dao(METADATA, "Channels")

    def get_events(self) -> Events:
        return self._dao(EVENTDATA, "Events")

    def get_metadata_engine_instances(self) -> EngineInstances:
        return self._dao(METADATA, "EngineInstances")

    def get_metadata_evaluation_instances(self) -> EvaluationInstances:
        return self._dao(METADATA, "EvaluationInstances")

    def get_model_data_models(self) -> Models:
        return self._dao(MODELDATA, "Models")

    def verify_all_data_objects(self) -> bool:
        """Instantiate every repository's DAOs (Storage.scala:341-363)."""
        self.get_metadata_apps()
        self.get_metadata_access_keys()
        self.get_metadata_channels()
        self.get_metadata_engine_instances()
        self.get_metadata_evaluation_instances()
        self.get_events()
        self.get_model_data_models()
        return True

    def repository_source(self, repo: str) -> tuple[str, str]:
        """(source name, backend type) bound to a repository."""
        src = self._repo_to_source[repo]
        return src, self._source_types[src]

    def close(self) -> None:
        with self._lock:
            for client in self._clients.values():
                close = getattr(client, "close", None)
                if close:
                    close()
            self._clients.clear()


# -- module-level singleton ------------------------------------------------
_instance: Storage | None = None
_instance_lock = threading.Lock()


def get_storage(refresh: bool = False) -> Storage:
    global _instance
    with _instance_lock:
        if _instance is None or refresh:
            _instance = Storage()
        return _instance


def set_storage(storage: Storage | None) -> None:
    """Install a specific Storage (tests; the test-mode client analog)."""
    global _instance
    with _instance_lock:
        _instance = storage


def test_storage() -> Storage:
    """A fully in-memory Storage (analog of StorageClientConfig.test)."""
    return Storage(
        env={
            "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
        }
    )
