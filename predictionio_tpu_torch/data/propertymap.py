"""PropertyMap / EntityMap: aggregated current-state views of entities.

A copy of ``predictionio_tpu/data/propertymap.py`` for the port.

Capability parity with the reference's PropertyMap/EntityMap
(data/.../storage/PropertyMap.scala:36, EntityMap.scala:69): a DataMap plus
first/last updated times, and an id-indexed entity view for ML id mapping.
"""

from __future__ import annotations

from datetime import datetime
from typing import Any, Iterator, Mapping

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.datamap import DataMap


class PropertyMap(DataMap):
    """Aggregated properties of an entity plus update-time metadata."""

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Mapping[str, Any] | None,
        first_updated: datetime,
        last_updated: datetime,
    ):
        super().__init__(fields)
        self.first_updated = first_updated
        self.last_updated = last_updated

    def __eq__(self, other: object) -> bool:
        if isinstance(other, PropertyMap):
            return (
                self.to_dict() == other.to_dict()
                and self.first_updated == other.first_updated
                and self.last_updated == other.last_updated
            )
        return super().__eq__(other)

    def __hash__(self) -> int:
        return hash((super().__hash__(), self.first_updated, self.last_updated))

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self.to_dict()!r}, "
            f"first_updated={self.first_updated}, last_updated={self.last_updated})"
        )


class EntityMap:
    """Map of entityId -> data, with a stable integer index per entity.

    The bridge from string entity ids to dense row
    indices of factor/feature matrices (reference EntityMap.scala:69).
    """

    def __init__(self, entities: Mapping[str, Any]):
        self._data = dict(entities)
        self._id_to_ix = BiMap.string_int(sorted(self._data.keys()))

    def __getitem__(self, entity_id: str) -> Any:
        return self._data[entity_id]

    def __contains__(self, entity_id: str) -> bool:
        return entity_id in self._data

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def index_of(self, entity_id: str) -> int:
        return self._id_to_ix[entity_id]

    def entity_of(self, index: int) -> str:
        return self._id_to_ix.inverse[index]

    @property
    def id_index(self) -> BiMap:
        return self._id_to_ix
