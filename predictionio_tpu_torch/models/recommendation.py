"""Recommendation engine template (explicit-feedback ALS): serving half.

Port of ``predictionio_tpu/models/recommendation.py`` for deploy: the
query and result shapes, the params, the ALS model, and scoring through
K2, the fused gather -> score -> top-k (``ops/topk.py``, kernel
``csrc/topk.cu``).

Queries/results use the reference template's JSON shape:
``{"user": "1", "num": 4}`` -> ``{"itemScores": [{"item": ..., "score": ...}]}``.

Not ported yet, and refused with ``NotImplementedError`` rather than
answered another way: training (``ALSAlgorithm.train``,
``read_training``; the next slice), ``sharded_serving=True`` (ring
top-k over several cards), and catalogs large enough for two-stage
retrieval (``PIO_RETRIEVAL_THRESHOLD`` rows and up, same knobs and
defaults as the JAX package).
"""

from __future__ import annotations

import math
import os
import threading
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from predictionio_tpu_torch.core import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    Params,
    Preparator,
    WorkflowContext,
)
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models.modelfile import host_array, numpy_to_tensor
from predictionio_tpu_torch.ops import als as als_ops
from predictionio_tpu_torch.ops.topk import gather_top_k_batch
from predictionio_tpu_torch.utils.device import resolve_device

_TRAINING = "training is the next slice of the PyTorch port"


# -- query / result wire shapes --------------------------------------------


@dataclass
class Query:
    user: str
    num: int = 4


@dataclass
class ItemScore:
    item: str
    score: float


@dataclass
class PredictedResult:
    itemScores: list[ItemScore] = field(default_factory=list)


# -- DASE components --------------------------------------------------------


@dataclass
class DataSourceParams(Params):
    app_name: str = ""
    event_names: tuple[str, ...] = ("rate", "buy")
    buy_rating: float = 4.0
    eval_folds: int = 3
    eval_seed: int = 42


class RecommendationDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx: WorkflowContext):
        raise NotImplementedError(_TRAINING)


class RecommendationPreparator(Preparator):
    """Passthrough (the reference custom-prepartor variant)."""

    def prepare(self, ctx: WorkflowContext, td):
        return td


@dataclass
class ALSAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    seed: int = 3
    compute_dtype: str = "float32"
    storage_dtype: str = "float32"
    sharded_serving: bool = False
    sharded_train: bool = False
    sharded_mode: str = "auto"
    bucket_widths: tuple[int, ...] = als_ops.DEFAULT_BUCKETS
    sharded_gather_budget_bytes: int | None = None


@dataclass
class ALSModel:
    """Host-persistable factor model; device tensors made on first use.

    With int8 storage the factor arrays hold the quantized values and
    ``user_scales``/``item_scales`` the per-row f32 scales (``row =
    values * scale``); dense models keep scales None. bfloat16 factors
    are held as ``modelfile.BFLOAT16`` (the bf16 bits)."""

    user_index: BiMap
    item_index: BiMap
    user_factors: np.ndarray  # [U, D] float32/bf16, or int8 values
    item_factors: np.ndarray  # [I, D] float32/bf16, or int8 values
    user_scales: np.ndarray | None = None  # [U] float32 when int8
    item_scales: np.ndarray | None = None  # [I] float32 when int8

    def __post_init__(self):
        self.user_factors = host_array(self.user_factors)
        self.item_factors = host_array(self.item_factors)
        self._device: tuple[torch.device, tuple] | None = None
        self._device_lock = threading.Lock()

    def device_factors(self, device: torch.device) -> tuple:
        """(U, V) on ``device``, uploaded once and cached; int8 tables stay
        (values, scales) pairs on the device."""
        with self._device_lock:
            if self._device is None or self._device[0] != device:

                def put(values, scales):
                    if scales is not None:
                        return (
                            numpy_to_tensor(values, device),
                            numpy_to_tensor(scales, device),
                        )
                    return numpy_to_tensor(values, device)

                self._device = (device, (
                    put(self.user_factors, self.user_scales),
                    put(self.item_factors, self.item_scales),
                ))
            return self._device[1]


def model_from_numpy(user_ids, item_ids, user_factors, item_factors,
                     user_scales=None, item_scales=None) -> ALSModel:
    """An ALSModel from the JAX package's parameters as numpy: dense id
    lists (index = row) and the factor arrays (bf16 from ``ml_dtypes``
    or :data:`~predictionio_tpu_torch.models.modelfile.BFLOAT16`; int8
    values with f32 scales)."""
    return ALSModel(
        user_index=BiMap.from_dense(list(user_ids)),
        item_index=BiMap.from_dense(list(item_ids)),
        user_factors=np.asarray(user_factors),
        item_factors=np.asarray(item_factors),
        user_scales=None if user_scales is None else np.asarray(user_scales, np.float32),
        item_scales=None if item_scales is None else np.asarray(item_scales, np.float32),
    )


# two-stage retrieval routing knobs (predictionio_tpu/ops/retrieval.py)
def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _two_stage(k: int, num_items: int) -> bool:
    """Would the JAX package route this request through two-stage
    retrieval (shortlist + exact rescore)?"""
    threshold = int(os.environ.get("PIO_RETRIEVAL_THRESHOLD", 100_000))
    if not (threshold > 0 and num_items >= threshold):
        return False
    oversample = float(os.environ.get("PIO_RETRIEVAL_OVERSAMPLE", 8.0))
    tile = int(os.environ.get("PIO_RETRIEVAL_TILE", 1 << 18))
    kp = _pow2(int(math.ceil(oversample * _pow2(max(1, k)))))
    kp = max(1, min(kp, tile, _pow2(num_items)))
    return k <= kp < num_items


class ALSAlgorithm(Algorithm):
    params_class = ALSAlgorithmParams
    query_class = Query

    def train(self, ctx: WorkflowContext, td) -> ALSModel:
        raise NotImplementedError(_TRAINING)

    def warmup_query(self, model: ALSModel) -> Query | None:
        """A known user, so the warmup takes the device path."""
        if not len(model.user_index):
            return None
        return Query(user=model.user_index.inverse[0], num=4)

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        # a batch of one: rows are batch-size invariant, so a query gets
        # the same bytes alone or coalesced
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(
        self, model: ALSModel, queries: Sequence[tuple[int, Query]]
    ) -> list[tuple[int, PredictedResult]]:
        """One fused gather + score + top-k device call for all known
        users; unknown users get empty results."""
        if self.params.sharded_serving:
            raise NotImplementedError(
                "sharded_serving (ring top-k over several cards) is the "
                "multi-GPU slice of the PyTorch port"
            )
        known = [(ix, q) for ix, q in queries if q.user in model.user_index]
        out: list[tuple[int, PredictedResult]] = [
            (ix, PredictedResult(itemScores=[]))
            for ix, q in queries
            if q.user not in model.user_index
        ]
        if not known:
            return out
        uixs = np.asarray(
            [model.user_index[q.user] for _, q in known], dtype=np.int32
        )
        # power-of-two k (the JAX package's compile bucketing); results
        # slice to q.num, and a top-k prefix is k-invariant
        k = max(int(q.num) for _, q in known)
        k = 1 << max(0, k - 1).bit_length()
        num_items = len(model.item_index)
        if _two_stage(k, num_items):
            raise NotImplementedError(
                f"a {num_items}-item catalog routes to two-stage retrieval "
                "(PIO_RETRIEVAL_THRESHOLD), a later serving slice of the "
                "PyTorch port"
            )
        U, V = model.device_factors(resolve_device(self.device))
        scores, ids = gather_top_k_batch(uixs, U, V, k)
        scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
        inv = model.item_index.inverse
        for row, (ix, q) in enumerate(known):
            out.append((
                ix,
                PredictedResult(itemScores=[
                    ItemScore(item=inv[int(i)], score=float(s))
                    for s, i in zip(scores[row, : q.num], ids[row, : q.num])
                    if int(i) >= 0
                ]),
            ))
        return out


def engine() -> Engine:
    """EngineFactory (reference RecommendationEngine object)."""
    return Engine(
        datasource_classes=RecommendationDataSource,
        preparator_classes=RecommendationPreparator,
        algorithm_classes={"als": ALSAlgorithm},
        serving_classes=FirstServing,
    )
