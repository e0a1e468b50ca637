"""Typed JSON wire codec for the client-server storage backend.

The HTTP storage service (server/storage_server.py) and the ``http``
backend (data/storage/httpstorage.py) exchange DAO arguments and results
as JSON with tagged envelopes for the types JSON can't carry: datetimes,
bytes, numpy arrays, Event/PropertyMap, the storage dataclasses, and the
``...`` don't-care sentinel of ``Events.find``. Plays the role JDBC's
SQL type mapping plays for the reference's client-server backend
(storage/jdbc/.../JDBCUtils.scala).

Plain dicts that happen to contain a reserved tag key are escaped as
``{"__dict__": [[k, v], ...]}`` so user property bags round-trip
byte-exactly.

Port of ``predictionio_tpu/data/storage/wire.py``: the same encoding,
so either package decodes what the other encoded. The port's frame codec
(``frame.py``) uses it today; the storage service comes later.
"""

from __future__ import annotations

import base64
from dataclasses import fields, is_dataclass
from datetime import datetime
from typing import Any

import numpy as np

from predictionio_tpu_torch.data.event import Event, parse_time
from predictionio_tpu_torch.data.storage import base as storage_base

# DAO methods beyond the base-class surface that ride the wire when the
# backing implementation has them (403 from the service otherwise) —
# single source of truth for the server allowlist and the client proxies
EXTENSION_METHODS: dict[str, tuple[str, ...]] = {
    "events": ("search",),  # full-text queries of the `search` backend
}

_TAGS = (
    "__dt__", "__b64__", "__nd__", "__event__", "__pm__", "__dc__",
    "__ellipsis__", "__dict__", "__tuple__", "__set__",
)

# dataclasses allowed on the wire, by name (a closed set — the decoder
# must never instantiate arbitrary classes)
_DATACLASSES = {
    cls.__name__: cls
    for cls in (
        storage_base.App,
        storage_base.AccessKey,
        storage_base.Channel,
        storage_base.EngineInstance,
        storage_base.EvaluationInstance,
        storage_base.Model,
        storage_base.RatingsBatch,
    )
}


def _iso(dt: datetime) -> str:
    return dt.isoformat()


def dumps(obj: Any) -> bytes:
    """Typed-codec JSON bytes in one call — the binary frame codec's
    extras column (data/storage/frame.py) and any other caller that
    wants the envelope without hand-rolling json.dumps(encode(...))."""
    import json

    return json.dumps(encode(obj), separators=(",", ":")).encode()


def loads(data: bytes | str) -> Any:
    """Inverse of :func:`dumps`."""
    import json

    return decode(json.loads(data))


def encode(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if obj is ...:
        return {"__ellipsis__": True}
    if isinstance(obj, datetime):
        return {"__dt__": _iso(obj)}
    if isinstance(obj, (bytes, bytearray)):
        return {"__b64__": base64.b64encode(bytes(obj)).decode("ascii")}
    if isinstance(obj, np.ndarray):
        return {
            "__nd__": {
                "dtype": obj.dtype.str,
                "shape": list(obj.shape),
                "data": base64.b64encode(np.ascontiguousarray(obj).tobytes()).decode("ascii"),
            }
        }
    if isinstance(obj, np.generic):  # numpy scalar -> python scalar
        return encode(obj.item())
    if isinstance(obj, Event):
        return {"__event__": obj.to_dict(for_api=False)}
    # PropertyMap before DataMap/dict checks (it subclasses DataMap)
    from predictionio_tpu_torch.data.propertymap import PropertyMap

    if isinstance(obj, PropertyMap):
        return {
            "__pm__": {
                "fields": encode(obj.to_dict()),
                "first": _iso(obj.first_updated),
                "last": _iso(obj.last_updated),
            }
        }
    from predictionio_tpu_torch.data.datamap import DataMap

    if isinstance(obj, DataMap):
        return encode(obj.to_dict())
    if is_dataclass(obj) and type(obj).__name__ in _DATACLASSES:
        return {
            "__dc__": type(obj).__name__,
            "f": {f.name: encode(getattr(obj, f.name)) for f in fields(obj)},
        }
    if isinstance(obj, tuple):
        return {"__tuple__": [encode(v) for v in obj]}
    if isinstance(obj, set):
        return {"__set__": [encode(v) for v in sorted(obj, key=repr)]}
    if isinstance(obj, list):
        return [encode(v) for v in obj]
    if isinstance(obj, dict):
        if any(k in _TAGS for k in obj):
            return {"__dict__": [[encode(k), encode(v)] for k, v in obj.items()]}
        return {str(k): encode(v) for k, v in obj.items()}
    raise TypeError(f"cannot encode {type(obj).__name__} on the storage wire")


def decode(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, list):
        return [decode(v) for v in obj]
    if isinstance(obj, dict):
        if "__ellipsis__" in obj:
            return ...
        if "__dt__" in obj:
            return parse_time(obj["__dt__"])
        if "__b64__" in obj:
            return base64.b64decode(obj["__b64__"])
        if "__nd__" in obj:
            nd = obj["__nd__"]
            arr = np.frombuffer(
                base64.b64decode(nd["data"]), dtype=np.dtype(nd["dtype"])
            )
            return arr.reshape(nd["shape"]).copy()
        if "__event__" in obj:
            return Event.from_dict(obj["__event__"])
        if "__pm__" in obj:
            from predictionio_tpu_torch.data.propertymap import PropertyMap

            pm = obj["__pm__"]
            return PropertyMap(
                decode(pm["fields"]),
                first_updated=parse_time(pm["first"]),
                last_updated=parse_time(pm["last"]),
            )
        if "__dc__" in obj:
            cls = _DATACLASSES.get(obj["__dc__"])
            if cls is None:
                raise ValueError(f"unknown wire dataclass {obj['__dc__']}")
            return cls(**{k: decode(v) for k, v in obj["f"].items()})
        if "__tuple__" in obj:
            return tuple(decode(v) for v in obj["__tuple__"])
        if "__set__" in obj:
            return set(decode(v) for v in obj["__set__"])
        if "__dict__" in obj:
            return {decode(k): decode(v) for k, v in obj["__dict__"]}
        return {k: decode(v) for k, v in obj.items()}
    raise TypeError(f"cannot decode wire value of type {type(obj).__name__}")
