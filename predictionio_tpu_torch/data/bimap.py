"""BiMap: immutable bidirectional map, used for string id <-> dense index.

Capability parity with the reference's BiMap
(data/.../storage/BiMap.scala:28-110): ``string_int``/``string_long``
constructors assign each distinct key a dense index — on the device this is the
mapping from entity ids to rows of factor matrices. Also provides vectorized
numpy paths for bulk conversion (the RDD ``zipWithUniqueId`` analog).
"""

from __future__ import annotations

from typing import Generic, Hashable, Iterable, Iterator, Mapping, Sequence, TypeVar

import numpy as np

K = TypeVar("K", bound=Hashable)
V = TypeVar("V", bound=Hashable)


class BiMapError(ValueError):
    pass


class BiMap(Generic[K, V]):
    """Immutable one-to-one mapping with an inverse view."""

    def __init__(self, forward: Mapping[K, V], _inverse: "BiMap[V, K] | None" = None):
        self._m: dict[K, V] = dict(forward)
        if _inverse is None:
            rev: dict[V, K] = {}
            for k, v in self._m.items():
                if v in rev:
                    raise BiMapError(f"duplicate value {v!r}: BiMap must be one-to-one")
                rev[v] = k
            self._inverse = BiMap(rev, _inverse=self)
        else:
            self._inverse = _inverse

    # -- mapping ----------------------------------------------------------
    def __getitem__(self, key: K) -> V:
        return self._m[key]

    def get(self, key: K, default: V | None = None) -> V | None:
        return self._m.get(key, default)

    def __contains__(self, key: object) -> bool:
        return key in self._m

    def __len__(self) -> int:
        return len(self._m)

    def __iter__(self) -> Iterator[K]:
        return iter(self._m)

    def items(self):
        return self._m.items()

    def keys(self):
        return self._m.keys()

    def values(self):
        return self._m.values()

    def to_dict(self) -> dict[K, V]:
        return dict(self._m)

    @property
    def inverse(self) -> "BiMap[V, K]":
        """The value->key view (reference BiMap.inverse)."""
        return self._inverse

    def take(self, keys: Iterable[K]) -> "BiMap[K, V]":
        return BiMap({k: self._m[k] for k in keys if k in self._m})

    def __eq__(self, other: object) -> bool:
        return isinstance(other, BiMap) and self._m == other._m

    def __repr__(self) -> str:
        return f"BiMap({self._m!r})"

    # -- constructors (reference object BiMap:66-110) ---------------------
    @staticmethod
    def string_int(keys: Iterable[str]) -> "BiMap[str, int]":
        """Assign each distinct key a dense int index in first-seen order."""
        seen: dict[str, int] = {}
        for k in keys:
            if k not in seen:
                seen[k] = len(seen)
        return BiMap(seen)

    string_long = string_int  # Python ints are unbounded

    @staticmethod
    def from_dense(ids: Sequence[str]) -> "BiMap[str, int]":
        """Wrap an already-dense id list (index = list position) — the
        zero-copy constructor for columnar reads whose id lists came out
        of ``scan_ratings``/``index_spans`` pre-indexed."""
        return BiMap({k: i for i, k in enumerate(ids)})

    # -- vectorized paths --------------------------------------------------
    def to_index_array(self, keys: Sequence[K]) -> np.ndarray:
        """Bulk key->index conversion to an int32 numpy array."""
        return np.fromiter((self._m[k] for k in keys), dtype=np.int32, count=len(keys))
