"""Vectorized aggregation over columnar event batches.

A copy of ``predictionio_tpu/models/columnar.py`` for the port.

Shared by the implicit-feedback templates (similarproduct, ecommerce,
recommendeduser): turns a :class:`RatingsBatch` of raw per-event records
into deduplicated, dense-indexed training triples without per-event
Python loops — the numpy replacement for the reference's RDD
``map``/``reduceByKey`` pipelines (e.g. viewCountsRDD in
examples/scala-parallel-ecommercerecommendation/weighted-items/src/main/
scala/ALSAlgorithm.scala and the similarproduct multi template's rating
aggregation, examples/scala-parallel-similarproduct/multi/src/main/
scala/ALSAlgorithm.scala:147).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.storage.base import RatingsBatch


@dataclass
class IndexedRatings:
    """Dense-indexed, deduplicated training triples ready for ALS."""

    user_index: BiMap
    item_index: BiMap
    rows: np.ndarray  # [N] int32 into user_index
    cols: np.ndarray  # [N] int32 into item_index
    vals: np.ndarray  # [N] float32


def _merge_item_index(
    extra_items: Iterable[str], batch_item_ids: Sequence[str]
) -> tuple[BiMap, np.ndarray | None]:
    """Item index covering property-only items (known from ``$set``
    entities, so they get factor slots) plus every item in the batch;
    returns it with a [len(batch_item_ids)] remap from batch-dense to
    index-dense columns (None = identity: batch ids are already dense
    in first-seen order, so with no extra items the per-id Python remap
    loop — millions of iterations at event-store scale — is pure waste)."""
    extra = list(extra_items)
    if not extra:
        return BiMap.from_dense(list(batch_item_ids)), None
    item_index = BiMap.string_int(extra + list(batch_item_ids))
    remap = np.fromiter(
        (item_index[i] for i in batch_item_ids),
        dtype=np.int32,
        count=len(batch_item_ids),
    )
    return item_index, remap


def aggregate_counts(
    batch: RatingsBatch, extra_items: Iterable[str] = ()
) -> IndexedRatings:
    """Per-(user, item) event counts (the view-count signal), vectorized:
    one np.unique over packed pair keys replaces the reference's
    reduceByKey shuffle."""
    if len(batch) == 0:
        raise ValueError("cannot train on zero events")
    n_items = max(len(batch.target_ids), 1)
    key = batch.rows.astype(np.int64) * n_items + batch.cols
    uniq, counts = np.unique(key, return_counts=True)
    rows = (uniq // n_items).astype(np.int32)
    cols_batch = (uniq % n_items).astype(np.int32)
    item_index, remap = _merge_item_index(extra_items, batch.target_ids)
    return IndexedRatings(
        user_index=BiMap.from_dense(batch.entity_ids),
        item_index=item_index,
        rows=rows,
        cols=cols_batch if remap is None else remap[cols_batch],
        vals=counts.astype(np.float32),
    )


def from_triples(
    triples: Sequence[tuple[str, str, float]], extra_items: Iterable[str] = ()
) -> IndexedRatings:
    """Dense-index explicit (user, item, value) triples — the small-scale
    path for order-sensitive signals (e.g. latest like/dislike wins)."""
    if not triples:
        raise ValueError("cannot train on zero events")
    user_index = BiMap.string_int(u for u, _, _ in triples)
    item_index = BiMap.string_int(
        list(extra_items) + [i for _, i, _ in triples]
    )
    return IndexedRatings(
        user_index=user_index,
        item_index=item_index,
        rows=user_index.to_index_array([u for u, _, _ in triples]),
        cols=item_index.to_index_array([i for _, i, _ in triples]),
        vals=np.asarray([v for _, _, v in triples], dtype=np.float32),
    )
