"""Metric contracts and standard reductions over (Query, Prediction, Actual).

Port of ``predictionio_tpu/core/metrics.py`` (host only).
Capability parity with the reference metrics
(core/.../controller/Metric.scala:39-269): ``Metric`` with an ordering for
best-candidate selection, plus AverageMetric / OptionAverageMetric /
StdevMetric / OptionStdevMetric / SumMetric / ZeroMetric. The reference
reduces with Spark ``StatCounter`` over unioned RDDs; here the per-point
scores become one numpy array per evaluation and the reductions are
vectorized (device tensors are pulled host-side: metric reduction is not
a device-bound op at these cardinalities).
"""

from __future__ import annotations

import abc
import math
from dataclasses import dataclass
from typing import Any, Generic, Sequence, TypeVar

import numpy as np

Q = TypeVar("Q")
P = TypeVar("P")
A = TypeVar("A")

# eval data: [(eval_info, [(q, p, a), ...]), ...]
EvalDataSet = Sequence[tuple[Any, Sequence[tuple[Q, P, A]]]]


@dataclass(frozen=True)
class DeviceRankingSpec:
    """A metric's claim to the device-resident eval fast path.

    ``kernel`` names an output of ops/topk.py ranking_metrics_batch (K3)
    ("precision" | "ap" | "ndcg"); ``k`` is the cutoff. Metrics that
    advertise a spec are computed fully vectorized over a candidate's
    padded top-k matrix instead of per (query, prediction, actual) point
    (core/fast_eval.py eval_device); mean reduction skips invalid
    (empty-actual) rows, matching OptionAverageMetric semantics.
    """

    kernel: str
    k: int


class Metric(abc.ABC, Generic[Q, P, A]):
    """Computes one score over the full evaluation data set. Higher is
    better by default; set ``smaller_is_better = True`` to flip the
    ordering (the reference's Ordering parameter)."""

    smaller_is_better: bool = False

    @abc.abstractmethod
    def calculate(self, eval_data: EvalDataSet) -> float: ...

    def compare(self, r0: float, r1: float) -> int:
        """> 0 if r0 is better than r1 (NaN always loses)."""
        if math.isnan(r0):
            return 0 if math.isnan(r1) else -1
        if math.isnan(r1):
            return 1
        sign = -1 if self.smaller_is_better else 1
        return sign * ((r0 > r1) - (r0 < r1))

    @property
    def header(self) -> str:
        return type(self).__name__

    def device_spec(self) -> DeviceRankingSpec | None:
        """A DeviceRankingSpec when this metric can ride the device
        fast path, else None (the default — per-point Python scoring).
        Implementations MUST return None for subclasses whose
        ``calculate_point`` may have been overridden: the fast path
        never calls it, so a spec from a customized metric would
        silently compute the wrong number."""
        return None


class QPAMetric(Metric[Q, P, A]):
    """Per-point scoring base: implement ``calculate_point(q, p, a)``.

    ``allow_none``: Option* variants skip None scores; strict variants
    treat None as a scoring bug and raise."""

    allow_none: bool = False

    @abc.abstractmethod
    def calculate_point(self, q: Q, p: P, a: A) -> float | None: ...

    def _scores(self, eval_data: EvalDataSet) -> np.ndarray:
        vals = []
        for _, qpa in eval_data:
            for q, p, a in qpa:
                score = self.calculate_point(q, p, a)
                if score is None:
                    if self.allow_none:
                        continue
                    raise ValueError(
                        f"{type(self).__name__}.calculate_point returned None; "
                        "use an Option* metric to skip points"
                    )
                vals.append(score)
        return np.asarray(vals, dtype=np.float64)


class AverageMetric(QPAMetric[Q, P, A]):
    """Mean of per-point scores (None from calculate_point is an error —
    use OptionAverageMetric for skippable points)."""

    def calculate(self, eval_data: EvalDataSet) -> float:
        scores = self._scores(eval_data)
        return float(scores.mean()) if scores.size else float("nan")


class OptionAverageMetric(AverageMetric[Q, P, A]):
    """Mean over points where calculate_point returns a value
    (reference OptionAverageMetric: None points are excluded from the
    denominator)."""

    allow_none = True


class StdevMetric(QPAMetric[Q, P, A]):
    """Population stdev of per-point scores (StatCounter.stdev parity)."""

    def calculate(self, eval_data: EvalDataSet) -> float:
        scores = self._scores(eval_data)
        return float(scores.std()) if scores.size else float("nan")


class OptionStdevMetric(StdevMetric[Q, P, A]):
    allow_none = True


class SumMetric(QPAMetric[Q, P, A]):
    def calculate(self, eval_data: EvalDataSet) -> float:
        scores = self._scores(eval_data)
        return float(scores.sum()) if scores.size else 0.0


class ZeroMetric(Metric[Q, P, A]):
    """Always 0 (reference ZeroMetric — placeholder in sweeps)."""

    def calculate(self, eval_data: EvalDataSet) -> float:
        return 0.0
