"""DataMap: an immutable, typed property bag over JSON values.

A copy of ``predictionio_tpu/data/datamap.py`` for the port.

Capability parity with the reference's ``DataMap``
(data/src/main/scala/org/apache/predictionio/data/storage/DataMap.scala:45-200):
required/optional typed getters, merge (``++``), key removal (``--``), and
JSON (de)serialization. Values are plain JSON-compatible Python values
(str, int, float, bool, None, list, dict).
"""

from __future__ import annotations

import json
from typing import Any, Iterable, Iterator, Mapping


class DataMapError(KeyError):
    """Raised when a required field is missing or has the wrong type."""


class DataMap(Mapping[str, Any]):
    """Immutable mapping of property name -> JSON value."""

    __slots__ = ("_fields",)

    def __init__(self, fields: Mapping[str, Any] | None = None):
        self._fields: dict[str, Any] = dict(fields or {})

    # -- Mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._fields[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, key: object) -> bool:
        return key in self._fields

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(json.dumps(self._fields, sort_keys=True, default=str))

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"

    # -- typed getters ----------------------------------------------------
    # Note: ``get`` keeps the standard Mapping contract (returns default on
    # missing); the reference's raising ``get[T]`` is ``get_required`` here.
    def get_required(self, key: str, expected_type: type | None = None) -> Any:
        """Required getter: raises DataMapError if absent or null."""
        if key not in self._fields or self._fields[key] is None:
            raise DataMapError(f"The field {key} is required.")
        value = self._fields[key]
        if expected_type is not None:
            value = _coerce(key, value, expected_type)
        return value

    def get_opt(self, key: str, expected_type: type | None = None, default: Any = None) -> Any:
        """Optional getter: returns ``default`` when absent or null."""
        value = self._fields.get(key)
        if value is None:
            return default
        if expected_type is not None:
            value = _coerce(key, value, expected_type)
        return value

    def get_string(self, key: str) -> str:
        return self.get_required(key, str)

    def get_double(self, key: str) -> float:
        return self.get_required(key, float)

    def get_int(self, key: str) -> int:
        return self.get_required(key, int)

    def get_string_list(self, key: str) -> list[str]:
        v = self.get_required(key)
        if not isinstance(v, list) or not all(isinstance(x, str) for x in v):
            raise DataMapError(f"The field {key} is not a list of strings.")
        return v

    def get_double_list(self, key: str) -> list[float]:
        v = self.get_required(key)
        if not isinstance(v, list):
            raise DataMapError(f"The field {key} is not a list.")
        return [float(x) for x in v]

    # -- algebra ----------------------------------------------------------
    def merge(self, other: "DataMap | Mapping[str, Any]") -> "DataMap":
        """``this ++ that``: right-hand side wins on key conflicts."""
        merged = dict(self._fields)
        merged.update(dict(other))
        return DataMap(merged)

    def remove(self, keys: Iterable[str]) -> "DataMap":
        """``this -- keys``."""
        drop = set(keys)
        return DataMap({k: v for k, v in self._fields.items() if k not in drop})

    def is_empty(self) -> bool:
        return not self._fields

    def keyset(self) -> set[str]:
        return set(self._fields)

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return dict(self._fields)

    def to_json(self) -> str:
        return json.dumps(self._fields, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "DataMap":
        obj = json.loads(s)
        if not isinstance(obj, dict):
            raise DataMapError("DataMap JSON must be an object")
        return DataMap(obj)


def _coerce(key: str, value: Any, expected_type: type) -> Any:
    if expected_type is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise DataMapError(f"The field {key} is not a number.")
        return float(value)
    if expected_type is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise DataMapError(f"The field {key} is not an integer.")
        return value
    if expected_type is bool:
        if not isinstance(value, bool):
            raise DataMapError(f"The field {key} is not a boolean.")
        return value
    if expected_type is str:
        if not isinstance(value, str):
            raise DataMapError(f"The field {key} is not a string.")
        return value
    if not isinstance(value, expected_type):
        raise DataMapError(f"The field {key} is not a {expected_type.__name__}.")
    return value
