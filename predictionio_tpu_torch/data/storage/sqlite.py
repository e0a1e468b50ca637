"""SQLite backend: the engine-instance and model tables.

Port of the serving subset of ``predictionio_tpu/data/storage/sqlite.py``
with the same schema for ``pio_engine_instances`` and ``pio_models``
(sqlite.py:82-120), so an instance the JAX package trained deploys on
the port and one the port writes reads back in the JAX package. The
other tables (apps, keys, channels, events) are created by whichever
package first needs them.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import uuid
from datetime import datetime, timezone
from pathlib import Path

from predictionio_tpu_torch.data.storage import base


def _ts(dt: datetime) -> float:
    return dt.timestamp()


def _from_ts(ts: float) -> datetime:
    return datetime.fromtimestamp(ts, tz=timezone.utc)


class SQLiteStorageClient:
    """One sqlite database file shared by all DAOs of this source."""

    def __init__(self, config: dict | None = None):
        self.config = config or {}
        path = self.config.get("path", ":memory:")
        if path != ":memory:":
            Path(path).parent.mkdir(parents=True, exist_ok=True)
        self.lock = threading.RLock()
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.conn.execute("PRAGMA journal_mode=WAL")
        with self.lock, self.conn:
            self.conn.executescript(
                """
                CREATE TABLE IF NOT EXISTS pio_engine_instances (
                  id TEXT PRIMARY KEY,
                  status TEXT NOT NULL,
                  starttime REAL NOT NULL,
                  endtime REAL NOT NULL,
                  engineid TEXT NOT NULL,
                  engineversion TEXT NOT NULL,
                  enginevariant TEXT NOT NULL,
                  enginefactory TEXT NOT NULL,
                  batch TEXT,
                  env TEXT,
                  runtimeconf TEXT,
                  datasourceparams TEXT,
                  preparatorparams TEXT,
                  algorithmsparams TEXT,
                  servingparams TEXT);
                CREATE TABLE IF NOT EXISTS pio_models (
                  id TEXT PRIMARY KEY,
                  models BLOB NOT NULL);
                """
            )

    def query(self, sql: str, params: tuple | list = ()) -> list:
        """Locked read, serialized against writers on the shared connection."""
        with self.lock:
            return self.conn.execute(sql, params).fetchall()

    def query_one(self, sql: str, params: tuple | list = ()):
        rows = self.query(sql, params)
        return rows[0] if rows else None

    def close(self) -> None:
        with self.lock:
            self.conn.close()


class SQLiteEngineInstances(base.EngineInstances):
    def __init__(self, client: SQLiteStorageClient):
        self._c = client

    def insert(self, instance: base.EngineInstance) -> str:
        instance_id = instance.id or uuid.uuid4().hex
        instance.id = instance_id
        with self._c.lock, self._c.conn:
            self._c.conn.execute(
                "INSERT OR REPLACE INTO pio_engine_instances VALUES "
                "(?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                self._row(instance),
            )
        return instance_id

    @staticmethod
    def _row(i: base.EngineInstance):
        return (
            i.id,
            i.status,
            _ts(i.start_time),
            _ts(i.end_time),
            i.engine_id,
            i.engine_version,
            i.engine_variant,
            i.engine_factory,
            i.batch,
            json.dumps(i.env),
            json.dumps(i.runtime_conf),
            i.datasource_params,
            i.preparator_params,
            i.algorithms_params,
            i.serving_params,
        )

    @staticmethod
    def _parse(row) -> base.EngineInstance:
        return base.EngineInstance(
            id=row[0],
            status=row[1],
            start_time=_from_ts(row[2]),
            end_time=_from_ts(row[3]),
            engine_id=row[4],
            engine_version=row[5],
            engine_variant=row[6],
            engine_factory=row[7],
            batch=row[8] or "",
            env=json.loads(row[9] or "{}"),
            runtime_conf=json.loads(row[10] or "{}"),
            datasource_params=row[11] or "{}",
            preparator_params=row[12] or "{}",
            algorithms_params=row[13] or "[]",
            serving_params=row[14] or "{}",
        )

    def get(self, instance_id: str) -> base.EngineInstance | None:
        row = self._c.query_one(
            "SELECT * FROM pio_engine_instances WHERE id=?", (instance_id,)
        )
        return self._parse(row) if row else None

    def get_all(self) -> list[base.EngineInstance]:
        rows = self._c.query("SELECT * FROM pio_engine_instances")
        return [self._parse(r) for r in rows]

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[base.EngineInstance]:
        rows = self._c.query(
            "SELECT * FROM pio_engine_instances WHERE status=? AND engineid=? "
            "AND engineversion=? AND enginevariant=? ORDER BY starttime DESC",
            (
                base.EngineInstanceStatus.COMPLETED,
                engine_id,
                engine_version,
                engine_variant,
            ),
        )
        return [self._parse(r) for r in rows]

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> base.EngineInstance | None:
        completed = self.get_completed(engine_id, engine_version, engine_variant)
        return completed[0] if completed else None

    def update(self, instance: base.EngineInstance) -> bool:
        with self._c.lock, self._c.conn:
            cur = self._c.conn.execute(
                "UPDATE pio_engine_instances SET status=?, starttime=?, endtime=?, "
                "engineid=?, engineversion=?, enginevariant=?, enginefactory=?, "
                "batch=?, env=?, runtimeconf=?, datasourceparams=?, "
                "preparatorparams=?, algorithmsparams=?, servingparams=? WHERE id=?",
                self._row(instance)[1:] + (instance.id,),
            )
            return cur.rowcount > 0

    def delete(self, instance_id: str) -> bool:
        with self._c.lock, self._c.conn:
            cur = self._c.conn.execute(
                "DELETE FROM pio_engine_instances WHERE id=?", (instance_id,)
            )
            return cur.rowcount > 0


class SQLiteModels(base.Models):
    def __init__(self, client: SQLiteStorageClient):
        self._c = client

    def insert(self, model: base.Model) -> None:
        with self._c.lock, self._c.conn:
            self._c.conn.execute(
                "INSERT OR REPLACE INTO pio_models (id, models) VALUES (?,?)",
                (model.id, model.models),
            )

    def get(self, model_id: str) -> base.Model | None:
        row = self._c.query_one(
            "SELECT id, models FROM pio_models WHERE id=?", (model_id,)
        )
        return base.Model(row[0], row[1]) if row else None

    def delete(self, model_id: str) -> bool:
        with self._c.lock, self._c.conn:
            cur = self._c.conn.execute(
                "DELETE FROM pio_models WHERE id=?", (model_id,)
            )
            return cur.rowcount > 0

