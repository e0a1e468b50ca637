"""Local-filesystem model store: one file per model id.

Port of ``predictionio_tpu/data/storage/localfs.py``, same file names
(``pio_model_<percent-encoded id>.bin``), so either package finds the
other's models.
"""

from __future__ import annotations

import os
from pathlib import Path
from urllib.parse import quote

from predictionio_tpu_torch import faults
from predictionio_tpu_torch.data.storage import base


class LocalFSStorageClient:
    def __init__(self, config: dict | None = None):
        self.config = config or {}
        self.base_path = Path(self.config.get("path", "~/.pio_tpu/models")).expanduser()
        self.base_path.mkdir(parents=True, exist_ok=True)


class LocalFSModels(base.Models):
    def __init__(self, client: LocalFSStorageClient):
        self._c = client

    def _path(self, model_id: str) -> Path:
        # percent-encoding keeps distinct ids on distinct files (injective)
        safe = quote(model_id, safe="")
        return self._c.base_path / f"pio_model_{safe}.bin"

    def insert(self, model: base.Model) -> None:
        # tmp + fsync + rename: a deploy reading the model mid-write never
        # sees a torn file
        path = self._path(model.id)
        tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
        with open(tmp, "wb") as f:
            f.write(model.models)
            f.flush()
            faults.fault_point("storage.fsync")
            os.fsync(f.fileno())
        faults.fault_point("storage.rename")
        tmp.replace(path)

    def get(self, model_id: str) -> base.Model | None:
        p = self._path(model_id)
        if not p.exists():
            return None
        return base.Model(model_id, p.read_bytes())

    def local_path(self, model_id: str) -> str | None:
        p = self._path(model_id)
        return str(p) if p.exists() else None

    def delete(self, model_id: str) -> bool:
        p = self._path(model_id)
        if p.exists():
            p.unlink()
            return True
        return False
