"""Recommended-user engine template: similar users via implicit ALS.

Port of ``predictionio_tpu/models/recommendeduser.py`` (reference
``examples/scala-parallel-similarproduct/recommended-user``): the
similar-product pipeline retargeted at users -- the DataSource reads
``$set`` user entities and user->user ``follow`` events, ALS trains
implicitly on the follow matrix (``ops/als.py als_train(implicit=True)``:
K1 on the algorithm's device), and a query for one or more users returns
the users most cosine-similar to the *followed-user* factor vectors,
with white/black-list filters. Scoring goes through K2's summed-rows
mode (``ops/topk.py sum_rows_top_k_batch``); a catalog of
``PIO_RETRIEVAL_THRESHOLD`` rows or more serves its no-whiteList queries
through two-stage retrieval (``ops/retrieval.py``: the coarse shortlist
K4, the summed-rows rescore K5, the live recall probe).

Not ported yet, and refused with ``NotImplementedError`` rather than
answered another way: ``sharded_train`` (several cards).

Query: ``{"users": [...], "num": N, "whiteList": [...]?,
"blackList": [...]?}`` -> ``{"userScores": [{"user": ..., "score": ...}]}``.
"""

from __future__ import annotations

import logging
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
    IdentityPreparator,
    Params,
    SanityCheck,
    WorkflowContext,
)
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.storage import RatingsBatch
from predictionio_tpu_torch.models.columnar import aggregate_counts
from predictionio_tpu_torch.models.filters import (
    entity_exclusion_mask,
    normalized_device_factors,
    normalized_query_vectors,
)
from predictionio_tpu_torch.models.modelfile import host_array
from predictionio_tpu_torch.obs import device as obs_device
from predictionio_tpu_torch.ops import als as als_ops
from predictionio_tpu_torch.ops import retrieval
from predictionio_tpu_torch.ops.topk import sum_rows_top_k_batch
from predictionio_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclass
class Query:
    users: list[str] = field(default_factory=list)
    num: int = 4
    whiteList: list[str] | None = None
    blackList: list[str] | None = None


@dataclass
class UserScore:
    user: str
    score: float


@dataclass
class PredictedResult:
    userScores: list[UserScore] = field(default_factory=list)


@dataclass
class DataSourceParams(Params):
    app_name: str = ""


@dataclass
class TrainingData(SanityCheck):
    users: list[str] = field(default_factory=list)
    # bulk signal, columnar (no per-event Python objects at 10^7 scale)
    follow_events: RatingsBatch = field(default_factory=RatingsBatch.empty)

    def sanity_check(self) -> None:
        if not len(self.follow_events):
            raise ValueError("TrainingData has no follow events")


class RecommendedUserDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        app = self.params.app_name
        users = list(store.aggregate_properties(app, entity_type="user"))
        follows = store.find_ratings(
            app, entity_type="user", event_names=["follow"],
            target_entity_type="user", rating_key=None,
            default_ratings={"follow": 1.0},
        )
        return TrainingData(users=users, follow_events=follows)


@dataclass
class ALSAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: int = 3
    compute_dtype: str = "float32"
    storage_dtype: str = "float32"
    sharded_train: bool = False
    sharded_gather_budget_bytes: int | None = None


@dataclass
class RecommendedUserModel:
    """Host-persistable followed-user factors; the normalized device
    catalog is made on first use (int8 storage: ``followed_factors`` the
    quantized values, ``followed_scales`` the per-row f32 scales)."""

    followed_index: BiMap  # followed-user id <-> column index
    followed_factors: np.ndarray  # [F, D] row-normalized at device load
    followed_scales: np.ndarray | None = None  # [F] f32, int8 storage only

    def __post_init__(self):
        self.followed_factors = host_array(self.followed_factors)
        self._device: tuple[torch.device, object, torch.Tensor] | None = None
        self._coarse: tuple[torch.device, retrieval.CoarseCatalog] | None = None
        self._device_lock = threading.Lock()

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_device"] = None
        state["_coarse"] = None
        del state["_device_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._device_lock = threading.Lock()

    def _on_device(self, device: torch.device):
        with self._device_lock:
            if self._device is None or self._device[0] != device:
                table, norms = normalized_device_factors(
                    self.followed_factors, self.followed_scales, device
                )
                self._device = (device, table, norms)
                obs_device.count_transfer("h2d", "serve.model_put", sum(
                    a.nbytes for a in (self.followed_factors, self.followed_scales)
                    if a is not None
                ))
            return self._device

    def device_factors(self, device: torch.device):
        """Row-normalized catalog on ``device`` (dot == cosine), uploaded
        once and cached; int8 storage stays the quantized pair -- see
        models/similarproduct.py's device_factors."""
        return self._on_device(device)[1]

    def device_norms(self, device: torch.device) -> torch.Tensor:
        """[F] f32 stored-row norms on ``device``, computed once at load
        (``ops.topk.top_k_similar``'s ``norms`` argument)."""
        return self._on_device(device)[2]

    def coarse_catalog(self, device: torch.device) -> retrieval.CoarseCatalog:
        """Tiled coarse copy of the normalized catalog on ``device`` for the
        two-stage shortlist pass, cached."""
        table = self.device_factors(device)
        with self._device_lock:
            if self._coarse is None or self._coarse[0] != device:
                self._coarse = (device, retrieval.CoarseCatalog(table, device=device))
            return self._coarse[1]


class ALSAlgorithm(Algorithm):
    """Implicit ALS on follow counts; cosine user-user scoring over the
    followed-side factors (reference recommended-user ALSAlgorithm.scala)."""

    params_class = ALSAlgorithmParams
    query_class = Query

    def train(self, ctx: WorkflowContext, td: TrainingData) -> RecommendedUserModel:
        if self.params.sharded_train:
            raise NotImplementedError(
                "sharded_train (factors sharded over several cards) is the "
                "multi-GPU slice of the PyTorch port"
            )
        if not len(td.follow_events):
            raise ValueError("cannot train on zero follow events")
        device = resolve_device(
            self.device if self.device is not None
            else (ctx.device if ctx is not None else None)
        )
        r = aggregate_counts(td.follow_events, extra_items=td.users)
        followed_index = r.item_index
        data = als_ops.build_ratings_data(
            r.rows, r.cols, r.vals, len(r.user_index), len(followed_index)
        )
        params = als_ops.ALSParams(
            rank=self.params.rank,
            iterations=self.params.num_iterations,
            reg=self.params.lambda_,
            implicit=True,
            alpha=self.params.alpha,
            seed=self.params.seed,
            compute_dtype=self.params.compute_dtype,
            storage_dtype=self.params.storage_dtype,
            **als_ops.sharded_budget_kwarg(
                self.params.sharded_gather_budget_bytes
            ),
        )
        _, V = als_ops.als_train(data, params, device=device)
        vf, vs = als_ops.host_factors(V)
        return RecommendedUserModel(
            followed_index=followed_index,
            followed_factors=vf,
            followed_scales=vs,
        )

    def warmup_query(self, model: RecommendedUserModel) -> Query | None:
        """A known user, so the warmup takes the device path."""
        if not len(model.followed_index):
            return None
        return Query(users=[model.followed_index.inverse[0]], num=4)

    def predict(self, model: RecommendedUserModel, query: Query) -> PredictedResult:
        # batch of one through the batched scorer: byte-identical to the
        # same query arriving inside a coalesced micro-batch
        return _score_users_batch(model, [query], resolve_device(self.device))[0]

    def batch_predict(
        self, model: RecommendedUserModel,
        queries: Sequence[tuple[int, Query]],
    ) -> list[tuple[int, PredictedResult]]:
        results = _score_users_batch(
            model, [q for _, q in queries], resolve_device(self.device)
        )
        return [(ix, r) for (ix, _), r in zip(queries, results)]


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _score_users_batch(
    model: RecommendedUserModel, queries: Sequence[Query], device: torch.device
) -> list[PredictedResult]:
    """Batched user-user scoring: one summed-rows K2 call covers every
    no-whiteList query in the micro-batch (the excluded set -- the
    query's own users plus ``blackList`` hits -- is small, so the batch
    requests top-(num + |excluded|) unmasked and drops exclusions
    host-side; a whiteList can exclude most of the catalog, so those
    queries keep per-query masked scoring through the same kernel).
    Single-query ``predict`` delegates here with a batch of one -- see
    models/similarproduct.py for the parity argument."""
    index = model.followed_index
    inv = index.inverse
    results: list[PredictedResult | None] = [None] * len(queries)
    simple: list[tuple[int, list[int], set[int], int]] = []
    complex_: list[tuple[int, list[int], np.ndarray, int]] = []
    for qi, q in enumerate(queries):
        known = [index[u] for u in q.users if u in index]
        if not known:
            logger.info("no query users with factors; returning empty result")
            results[qi] = PredictedResult(userScores=[])
            continue
        if q.whiteList is not None:
            mask = entity_exclusion_mask(index, q.users, q.whiteList, q.blackList)
            complex_.append((qi, known, mask, int(q.num)))
        else:
            excluded = set(known)
            if q.blackList is not None:
                excluded.update(index[u] for u in q.blackList if u in index)
            simple.append((qi, known, excluded, int(q.num)))
    num_rows = len(index)
    if simple:
        L = _pow2(max(len(known) for _, known, _, _ in simple))
        ixs = np.zeros((len(simple), L), dtype=np.int32)
        weights = np.zeros((len(simple), L), dtype=np.float32)
        for row, (_, known, _, _) in enumerate(simple):
            ixs[row, : len(known)] = known
            weights[row, : len(known)] = 1.0
        k = _pow2(max(num + len(excl) for _, _, excl, num in simple))
        kp = retrieval.shortlist_k(k, num_rows) if retrieval.engaged(num_rows) else 0
        V = model.device_factors(device)
        if kp and k <= kp < num_rows:
            # two-stage: coarse shortlist, exact rescore of [B, S]
            # candidates, one launch on the card (ops/retrieval.py)
            qv = normalized_query_vectors(
                model.followed_factors, model.followed_scales, ixs, weights
            )
            scores, ids = retrieval.two_stage_top_k(
                model.coarse_catalog(device), qv, kp, k, "sum_rows", V, row_ixs=ixs,
                row_weights=weights)
            if retrieval.probe_due():
                _, exact_ids = sum_rows_top_k_batch(ixs[:1], weights[:1], V, k=k)
                retrieval.probe_recall(ids[0], exact_ids.cpu().numpy()[0])
        else:
            scores, ids = sum_rows_top_k_batch(ixs, weights, V, k=k)
            scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
        for row, (qi, _, excluded, num) in enumerate(simple):
            user_scores: list[UserScore] = []
            for s, i in zip(scores[row], ids[row]):
                ii = int(i)
                if ii < 0 or ii in excluded:
                    continue
                user_scores.append(UserScore(user=inv[ii], score=float(s)))
                if len(user_scores) == num:
                    break
            results[qi] = PredictedResult(userScores=user_scores)
    if complex_ and retrieval.engaged(num_rows):
        # whiteList filters can mask most of the catalog: exact path
        retrieval.note_exact(len(complex_))
    for qi, known, mask, num in complex_:
        L = _pow2(len(known))
        ixs = np.zeros((1, L), dtype=np.int32)
        weights = np.zeros((1, L), dtype=np.float32)
        ixs[0, : len(known)] = known
        weights[0, : len(known)] = 1.0
        scores, ids = sum_rows_top_k_batch(
            ixs, weights, model.device_factors(device), k=_pow2(num),
            exclude_mask=mask,
        )
        row_s = scores.cpu().numpy()[0][:num]
        row_i = ids.cpu().numpy()[0][:num]
        results[qi] = PredictedResult(
            userScores=[
                UserScore(user=inv[int(i)], score=float(s))
                for s, i in zip(row_s, row_i)
                if s > -1e29  # drop fully-masked placeholders
            ]
        )
    return results  # type: ignore[return-value]


def engine() -> Engine:
    """Reference RecommendedUserEngine factory (recommended-user
    Engine.scala: Map("als" -> ALSAlgorithm))."""
    return Engine(
        datasource_classes=RecommendedUserDataSource,
        preparator_classes=IdentityPreparator,
        algorithm_classes={"als": ALSAlgorithm},
        serving_classes=FirstServing,
    )
