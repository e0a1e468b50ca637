"""Model persistence: serialize trained models into the MODELDATA repo.

Port of ``predictionio_tpu/core/persistence.py:128-221`` for the model
file format (models/modelfile.py) and ``retrain`` markers. Models are
dataclasses of numpy arrays / BiMaps / JSON values and encode as aligned
blocks; tensor fields are pulled to the host first.

Refused here, with an error, rather than unpickled: the legacy
pickle-manifest blob (written by the JAX package under
``PIO_MODEL_MMAP=0``) and ``pickle`` entries inside a model file. Both
would unpickle the JAX package's classes. Retrain with the model-file
format (the default) to deploy such an instance on the port.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Sequence

import torch

from predictionio_tpu_torch.models import modelfile
from predictionio_tpu_torch.models.modelfile import ModelFileError  # re-export

__all__ = [
    "PersistentModel",
    "RETRAIN",
    "ModelFileError",
    "serialize_models",
    "deserialize_models",
    "deserialize_model_path",
]

logger = logging.getLogger(__name__)


class PersistentModel:
    """Custom save/load contract: ``save`` writes wherever it likes, the
    classmethod ``load`` restores; the framework persists only the
    (class, model_id) manifest."""

    def save(self, model_id: str) -> bool:
        raise NotImplementedError

    @classmethod
    def load(cls, model_id: str) -> "PersistentModel":
        raise NotImplementedError


def _device_to_host(model: Any) -> Any:
    """A model dataclass with its ``torch.Tensor`` fields pulled to host
    numpy (bf16 as ``modelfile.BFLOAT16``). Models that already hold
    numpy -- the usual case -- pass through untouched."""
    if not dataclasses.is_dataclass(model) or isinstance(model, type):
        return model
    changes = {
        f.name: modelfile.tensor_to_numpy(getattr(model, f.name))
        for f in dataclasses.fields(model)
        if isinstance(getattr(model, f.name), torch.Tensor)
    }
    return dataclasses.replace(model, **changes) if changes else model


def _manifest_entries(
    algorithms: Sequence[Any], models: Sequence[Any], model_id: str
) -> list[tuple[str, Any]]:
    entries: list[tuple[str, Any]] = []
    for algo, model in zip(algorithms, models):
        persistable = algo.make_persistent_model(model)
        if persistable is None:
            entries.append(("retrain", None))
        elif isinstance(persistable, PersistentModel):
            cls = type(persistable)
            if not persistable.save(model_id):
                raise RuntimeError(
                    f"{cls.__name__}.save({model_id!r}) returned False"
                )
            entries.append(("persistent", (cls.__module__, cls.__qualname__)))
        else:
            host_model = _device_to_host(persistable)
            if not modelfile.can_encode(host_model):
                raise ModelFileError(
                    f"{type(host_model).__name__} is not a dataclass of "
                    "arrays / BiMaps / JSON values; the port persists only "
                    "the model-file format"
                )
            entries.append(("arrays", host_model))
    return entries


def serialize_models(
    algorithms: Sequence[Any], models: Sequence[Any], model_id: str
) -> bytes:
    """The persisted blob for all algorithm models of one engine
    instance, in the model-file format."""
    return modelfile.serialize(
        _manifest_entries(algorithms, models, model_id), model_id
    )


def _resolve_entries(
    entries: list[tuple[str, Any]],
    algorithms: Sequence[Any],
    model_id: str,
) -> list[Any]:
    if len(entries) != len(algorithms):
        raise ValueError(
            f"model blob has {len(entries)} models but engine has "
            f"{len(algorithms)} algorithms — variant/instance mismatch"
        )
    out: list[Any] = []
    for kind, payload in entries:
        if kind == "arrays":
            out.append(payload)
        elif kind == "pickle":
            raise ModelFileError(
                "model file holds a pickled model, which the PyTorch port "
                "does not load; retrain with the model-file format"
            )
        elif kind == "persistent":
            out.append(modelfile.resolve_class(*payload).load(model_id))
        elif kind == "retrain":
            out.append(RETRAIN)
        else:
            raise ValueError(f"unknown model manifest kind {kind!r}")
    return out


def deserialize_models(
    blob: bytes,
    algorithms: Sequence[Any],
    model_id: str,
) -> list[Any]:
    """Restore per-algorithm models from a model-file blob; ``retrain``
    entries come back as :data:`RETRAIN`. A legacy pickle-manifest blob
    raises :class:`ModelFileError`."""
    if not modelfile.is_modelfile(blob):
        raise ModelFileError(
            f"model {model_id} is a legacy pickle manifest "
            "(PIO_MODEL_MMAP=0), which the PyTorch port does not load; "
            "retrain it with the model-file format (the default)"
        )
    return _resolve_entries(modelfile.deserialize(blob), algorithms, model_id)


def deserialize_model_path(
    path: str | os.PathLike,
    algorithms: Sequence[Any],
    model_id: str,
) -> list[Any] | None:
    """Zero-copy deploy path: mmap the model file at ``path`` (shared
    process-wide). Returns None when mmap loading is off or the file is
    not the flat format -- the caller then reads the bytes."""
    if not modelfile.mmap_enabled():
        return None
    p = os.fspath(path)
    try:
        with open(p, "rb") as f:
            magic = f.read(len(modelfile.MAGIC))
    except OSError:
        return None
    if not modelfile.is_modelfile(magic):
        return None
    return _resolve_entries(modelfile.shared_entries(p), algorithms, model_id)


class _Retrain:
    def __repr__(self) -> str:
        return "<RETRAIN: model must be re-trained on deploy>"


RETRAIN = _Retrain()
