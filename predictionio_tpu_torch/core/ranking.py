"""Ranking metrics: Precision@K, MAP@K, NDCG@K over (Q, P, A) batches.

Port of ``predictionio_tpu/core/ranking.py`` (host only). Capability
parity with the reference's item-rank evaluation measures
(examples/experimental/scala-local-movielens-evaluation/src/main/scala/
Evaluation.scala:73-140 selects MeasureType.PrecisionAtK / MeanAveragePrecisionAtK
with measureK on binary-thresholded ratings). The reference computes these
inside the external itemrank engine's DetailedEvaluator; here they are
framework metrics any engine can use.

Predictions are ranked id sequences (plain ids or (id, score) pairs —
the shape the recommendation/similar-product templates serve); actuals are
the relevant-id collection. Scoring is a vectorized numpy membership test
per point; the evaluation fast path scores whole splits with K3
(ops/topk.py ranking_metrics_batch) instead (core/fast_eval.py).
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import numpy as np

from predictionio_tpu_torch.core.metrics import DeviceRankingSpec, OptionAverageMetric

# padding sentinel for encoded actual-id rows: sorts past every real id
# and past every out-of-vocabulary code, and ``pos < count`` in the
# kernel's sorted lookup keeps it from ever matching (K3, csrc/ranking.cu)
ACTUAL_PAD = np.iinfo(np.int32).max


def encode_actuals(actuals: Sequence, index: Any) -> tuple[np.ndarray, np.ndarray]:
    """Encode per-query actual/relevant id collections as padded sorted
    int rows — the one-time host-side prep for the device metric kernel
    (ops/topk.py ranking_metrics_batch, K3).

    ``index`` maps raw ids to the prediction id space (``.get``-capable:
    BiMap or dict). Actual ids MISSING from it get distinct codes <= -2:
    they still count toward |actual| (AP normalization, IDCG) but can
    never match a predicted id (predictions are >= 0, empty slots -1).

    Returns ``(rows [Q, A] int32 sorted ascending + ACTUAL_PAD padding,
    counts [Q] int32)``.
    """
    encoded: list[list[int]] = []
    counts = np.zeros(len(actuals), dtype=np.int32)
    width = 1
    for qi, a in enumerate(actuals):
        ids = _id_set(a)
        counts[qi] = len(ids)
        row = []
        miss = -2
        for x in ids:
            j = index.get(x)
            if j is None:
                row.append(miss)
                miss -= 1
            else:
                row.append(int(j))
        row.sort()
        encoded.append(row)
        width = max(width, len(row))
    out = np.full((len(actuals), width), ACTUAL_PAD, dtype=np.int32)
    for qi, row in enumerate(encoded):
        out[qi, : len(row)] = row
    return out, counts


def _ranked_ids(p: Any) -> list:
    """Extract a ranked id list from a prediction: accepts an iterable of
    ids, of (id, score) pairs, or an object with ``item_scores`` /
    ``itemScores`` (the recommendation templates' PredictedResult)."""
    if hasattr(p, "item_scores"):
        p = p.item_scores
    elif hasattr(p, "itemScores"):
        p = p.itemScores
    ids = []
    for x in p:
        if isinstance(x, (tuple, list)) and len(x) == 2:
            ids.append(x[0])
        elif hasattr(x, "item") and not callable(getattr(x, "item")):
            ids.append(x.item)  # ItemScore-style record (numpy scalars'
            # callable .item() deliberately excluded)
        else:
            ids.append(x)
    return ids


def _id_set(a: Any) -> set:
    if hasattr(a, "item_ids"):
        a = a.item_ids
    elif isinstance(a, dict) and "item" in a:
        return {a["item"]}  # single held-out rating actual (k-fold QA)
    return set(a)


def precision_at_k(predicted: Sequence, actual: Iterable, k: int) -> float | None:
    """|top-k hits| / k. None (skip) when there are no relevant actuals."""
    actual_set = _id_set(actual)
    if not actual_set:
        return None
    top = _ranked_ids(predicted)[:k]
    if not top:
        return 0.0
    hits = np.fromiter((x in actual_set for x in top), dtype=bool, count=len(top))
    return float(hits.sum()) / k


def average_precision_at_k(
    predicted: Sequence, actual: Iterable, k: int
) -> float | None:
    """AP@K: mean of precision-at-hit-positions, normalized by
    min(k, |actual|). None when there are no relevant actuals."""
    actual_set = _id_set(actual)
    if not actual_set:
        return None
    top = _ranked_ids(predicted)[:k]
    if not top:
        return 0.0
    hits = np.fromiter((x in actual_set for x in top), dtype=bool, count=len(top))
    if not hits.any():
        return 0.0
    # precision@i at each hit position, vectorized over the rank axis
    cum_hits = np.cumsum(hits)
    ranks = np.arange(1, len(top) + 1)
    precisions = np.where(hits, cum_hits / ranks, 0.0)
    return float(precisions.sum()) / min(k, len(actual_set))


def ndcg_at_k(predicted: Sequence, actual: Iterable, k: int) -> float | None:
    """Binary-relevance NDCG@K. None when there are no relevant actuals."""
    actual_set = _id_set(actual)
    if not actual_set:
        return None
    top = _ranked_ids(predicted)[:k]
    if not top:
        return 0.0
    hits = np.fromiter((x in actual_set for x in top), dtype=bool, count=len(top))
    discounts = 1.0 / np.log2(np.arange(2, len(top) + 2))
    dcg = float((hits * discounts).sum())
    ideal_n = min(k, len(actual_set))
    idcg = float((1.0 / np.log2(np.arange(2, ideal_n + 2))).sum())
    return dcg / idcg


class PrecisionAtK(OptionAverageMetric):
    """Mean Precision@K over eval points; points without relevant actuals
    are skipped (Option semantics)."""

    def __init__(self, k: int):
        self.k = k

    def calculate_point(self, q, p, a) -> float | None:
        return precision_at_k(p, a, self.k)

    def device_spec(self) -> DeviceRankingSpec | None:
        # exact-type gate: a subclass may override calculate_point, and
        # the device kernel would silently ignore it (core/metrics.py)
        return DeviceRankingSpec("precision", self.k) if type(self) is PrecisionAtK else None

    @property
    def header(self) -> str:
        return f"PrecisionAtK (k={self.k})"


class MAPAtK(OptionAverageMetric):
    """Mean Average Precision at K (MAP@K)."""

    def __init__(self, k: int):
        self.k = k

    def calculate_point(self, q, p, a) -> float | None:
        return average_precision_at_k(p, a, self.k)

    def device_spec(self) -> DeviceRankingSpec | None:
        return DeviceRankingSpec("ap", self.k) if type(self) is MAPAtK else None

    @property
    def header(self) -> str:
        return f"MAPAtK (k={self.k})"


class NDCGAtK(OptionAverageMetric):
    """Mean NDCG@K (binary relevance)."""

    def __init__(self, k: int):
        self.k = k

    def calculate_point(self, q, p, a) -> float | None:
        return ndcg_at_k(p, a, self.k)

    def device_spec(self) -> DeviceRankingSpec | None:
        return DeviceRankingSpec("ndcg", self.k) if type(self) is NDCGAtK else None

    @property
    def header(self) -> str:
        return f"NDCGAtK (k={self.k})"
