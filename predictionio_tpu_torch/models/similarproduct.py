"""Similar-product engine template: implicit ALS + item-item cosine.

Port of ``predictionio_tpu/models/similarproduct.py`` (reference
``examples/scala-parallel-similarproduct/multi``):

- the DataSource reads ``$set`` user/item entities (items carry
  ``categories``) plus ``view`` and ``like``/``dislike`` events;
- ALSAlgorithm trains implicit ALS (MLlib ``ALS.trainImplicit``) on view
  counts through ``ops/als.py`` ``als_train(implicit=True)``: one K1
  launch per bucket (kernel ``csrc/als_solve.cu``, implicit mode) on the
  algorithm's device; candidates score by summed cosine similarity
  against the query items' factor vectors (ALSAlgorithm.scala:147,193,
  244) through K2's summed-rows mode (``ops/topk.py``
  ``sum_rows_top_k_batch``, kernel ``csrc/topk.cu``); a catalog of
  ``PIO_RETRIEVAL_THRESHOLD`` rows or more (default 100,000) serves its
  simple queries through two-stage retrieval instead (``ops/retrieval.py``:
  the coarse shortlist K4, the summed-rows rescore K5), while queries
  with ``categories`` or a ``whiteList`` stay on K2's masked exact path;
- LikeAlgorithm (the "multi" variant's second algorithm) trains on
  like=1 / dislike=-1 signals (LikeAlgorithm.scala). With alpha > 0 a
  dislike weighs ``alpha * r < 0``, which can leave a user's system
  indefinite: such rows train to NaN, as in the JAX package;
- CosineAlgorithm covers the experimental DIMSUM variant
  (examples/experimental/scala-parallel-similarproduct-dimsum): exact
  top-N item-item cosine from raw view counts, computed at train time
  by K6 (``ops/cosine_sim.py``, kernel ``csrc/cosine_sim.cu``) on the
  algorithm's device, served by the JAX package's host loop over the
  stored neighbor tables;
- Serving sums per-item scores across algorithms and re-ranks (the
  multi variant's Serving.scala).

Query: ``{"items": [...], "num": N, "categories": [...]?,
"whiteList": [...]?, "blackList": [...]?}`` ->
``{"itemScores": [{"item": ..., "score": ...}]}``.

Not ported yet, and refused with ``NotImplementedError`` rather than
answered another way: ``sharded_train`` (several cards).
"""

from __future__ import annotations

import logging
import threading
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from predictionio_tpu_torch.core import (
    Algorithm,
    DataSource,
    Engine,
    IdentityPreparator,
    Params,
    SanityCheck,
    Serving,
    WorkflowContext,
)
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.storage import RatingsBatch
from predictionio_tpu_torch.models.columnar import (
    IndexedRatings,
    aggregate_counts,
    from_triples,
)
from predictionio_tpu_torch.models.filters import (
    entity_exclusion_mask,
    normalized_device_factors,
    normalized_query_vectors,
)
from predictionio_tpu_torch.models.modelfile import host_array
from predictionio_tpu_torch.obs import device as obs_device
from predictionio_tpu_torch.ops import als as als_ops
from predictionio_tpu_torch.ops import retrieval
from predictionio_tpu_torch.ops.cosine_sim import item_similarity_topn
from predictionio_tpu_torch.ops.topk import sum_rows_top_k_batch
from predictionio_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclass
class Query:
    items: list[str] = field(default_factory=list)
    num: int = 4
    categories: list[str] | None = None
    whiteList: list[str] | None = None
    blackList: list[str] | None = None


@dataclass
class ItemScore:
    item: str
    score: float


@dataclass
class PredictedResult:
    itemScores: list[ItemScore] = field(default_factory=list)


@dataclass
class DataSourceParams(Params):
    app_name: str = ""


@dataclass
class TrainingData(SanityCheck):
    users: list[str] = field(default_factory=list)
    items: dict[str, list[str]] = field(default_factory=dict)  # id -> categories
    # bulk signal, columnar (no per-event Python objects at 10^7 scale)
    view_events: RatingsBatch = field(default_factory=RatingsBatch.empty)
    # order-sensitive small signal (latest like/dislike wins) stays a list
    like_events: list[tuple[str, str, bool]] = field(default_factory=list)

    def sanity_check(self) -> None:
        if not len(self.view_events) and not self.like_events:
            raise ValueError("TrainingData has no view/like events")


class SimilarProductDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        app = self.params.app_name
        users = list(store.aggregate_properties(app, entity_type="user"))
        item_props = store.aggregate_properties(app, entity_type="item")
        items = {
            iid: pm.get_opt("categories", default=[]) or []
            for iid, pm in item_props.items()
        }
        # columnar bulk read: every view carries implicit weight 1.0
        views = store.find_ratings(
            app, entity_type="user", event_names=["view"],
            target_entity_type="item", rating_key=None,
            default_ratings={"view": 1.0},
        )
        likes = [
            (e.entity_id, e.target_entity_id, e.event == "like")
            for e in store.find(
                app, entity_type="user", event_names=["like", "dislike"],
                target_entity_type="item",
            )
        ]
        return TrainingData(
            users=users, items=items, view_events=views, like_events=likes
        )


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
class SimilarProductModel:
    """Host-persistable item factors; the normalized device catalog is
    made on first use. With int8 storage ``item_factors`` holds the
    quantized values and ``item_scales`` the per-row f32 scales; bfloat16
    factors are held as ``modelfile.BFLOAT16`` (the bf16 bits)."""

    item_index: BiMap
    item_factors: np.ndarray  # [I, D]; int8 values when item_scales set
    categories: dict[str, list[str]]
    item_scales: np.ndarray | None = None  # [I] f32, int8 storage only

    def __post_init__(self):
        self.item_factors = host_array(self.item_factors)
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
                    self.item_factors, self.item_scales, device
                )
                self._device = (device, table, norms)
                obs_device.count_transfer("h2d", "serve.model_put", sum(
                    a.nbytes for a in (self.item_factors, self.item_scales)
                    if a is not None
                ))
            return self._device

    def device_factors(self, device: torch.device):
        """Row-normalized catalog on ``device`` (dot == cosine), uploaded
        once and cached. int8 storage stays the quantized (values,
        1/||values||) pair -- cosine drops the positive per-row scale, so
        normalization folds into the scale and the device table keeps
        the 4x size win."""
        return self._on_device(device)[1]

    def device_norms(self, device: torch.device) -> torch.Tensor:
        """[I] f32 stored-row norms on ``device``, computed once at load."""
        return self._on_device(device)[2]

    def coarse_catalog(self, device: torch.device) -> retrieval.CoarseCatalog:
        """Tiled coarse copy of the normalized catalog on ``device`` for the
        two-stage shortlist pass, cached: bf16 of the dense table, or the
        int8 values with 1/||row|| folded into the scales."""
        table = self.device_factors(device)
        with self._device_lock:
            if self._coarse is None or self._coarse[0] != device:
                self._coarse = (device, retrieval.CoarseCatalog(table, device=device))
            return self._coarse[1]


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _exclude_mask(
    item_index: BiMap, categories: dict[str, list[str]], query: Query
) -> np.ndarray:
    """Build the candidate-exclusion mask from query items, category,
    white/black lists (reference ALSAlgorithm.scala:193-244 filters)."""
    mask = entity_exclusion_mask(
        item_index, query.items, query.whiteList, query.blackList
    )
    if query.categories is not None:
        wanted = set(query.categories)
        for iid, ix in item_index.items():
            if not wanted.intersection(categories.get(iid, ())):
                mask[ix] = True
    return mask


def _score_similar_batch(
    model: SimilarProductModel, queries: Sequence[Query], device: torch.device
) -> list[PredictedResult]:
    """Score a whole micro-batch of similar-item queries with ONE
    summed-rows K2 call for the common case.

    Two filter regimes:

    - SIMPLE (no ``categories``/``whiteList``): the excluded set is
      small and enumerable host-side (the query's own items plus any
      ``blackList`` hits), so the batch requests top-(num + |excluded|)
      with NO mask and drops excluded ids from the returned prefix --
      identical results (masking sinks excluded entries without
      perturbing the others, and top-k prefixes are k-invariant), one
      shared device call for every simple query in the batch.
    - COMPLEX (``categories``/``whiteList`` present): the exclusion can
      cover most of the catalog, so these queries keep masked scoring,
      one [1, I]-masked call each, through the same kernel.

    Single-query ``predict`` delegates here with a batch of one, so a
    query's response bytes are identical whether or not it was
    coalesced (query rows pad with weight-0 rows, and a row's scores do
    not depend on the batch).

    At ``PIO_RETRIEVAL_THRESHOLD`` catalog rows and more the simple
    queries go through two-stage retrieval: the shortlist of the host
    query vectors (``filters.normalized_query_vectors``) over the coarse
    catalog (K4), then the summed-rows rescore (K5) of the same ``[B,
    L]`` rows and weights, which rebuilds the query vectors on the device
    as K2 does; complex queries stay on the exact masked path and are
    counted (``pio_retrieval_queries_total{path="exact"}``)."""
    index = model.item_index
    inv = index.inverse
    results: list[PredictedResult | None] = [None] * len(queries)
    simple: list[tuple[int, list[int], set[int], int]] = []
    complex_: list[tuple[int, list[int], np.ndarray, int]] = []
    for qi, q in enumerate(queries):
        known = [index[i] for i in q.items if i in index]
        if not known:
            logger.info("no query items with factors; returning empty result")
            results[qi] = PredictedResult(itemScores=[])
            continue
        if q.categories is not None or q.whiteList is not None:
            complex_.append(
                (qi, known,
                 _exclude_mask(index, model.categories, q), int(q.num))
            )
        else:
            excluded = set(known)
            if q.blackList is not None:
                excluded.update(index[i] for i in q.blackList if i in index)
            simple.append((qi, known, excluded, int(q.num)))
    num_rows = len(index)
    if simple:
        # pad the per-query item lists to a shared pow2 width with
        # weight-0 rows (index 0 gathered, then zeroed -- exact), and
        # size k for the worst headroom in the batch
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
            qv = normalized_query_vectors(model.item_factors, model.item_scales, ixs, weights)
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
            item_scores: list[ItemScore] = []
            for s, i in zip(scores[row], ids[row]):
                ii = int(i)
                if ii < 0 or ii in excluded:
                    continue
                item_scores.append(ItemScore(item=inv[ii], score=float(s)))
                if len(item_scores) == num:
                    break
            results[qi] = PredictedResult(itemScores=item_scores)
    if complex_ and retrieval.engaged(num_rows):
        # category/whiteList filters can mask most of the catalog, so
        # these stay on the exact masked path even at retrieval scale
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
            itemScores=[
                ItemScore(item=inv[int(i)], score=float(s))
                for s, i in zip(row_s, row_i)
                if s > -1e29  # drop fully-masked placeholders
            ]
        )
    return results  # type: ignore[return-value]


def _view_counts(td: TrainingData) -> IndexedRatings:
    """Aggregate view events into per-(user, item) counts, vectorized
    (items known only from ``$set`` entities still get index slots)."""
    return aggregate_counts(td.view_events, extra_items=td.items)


class ALSAlgorithm(Algorithm):
    """Implicit ALS on view counts; cosine item-item scoring."""

    params_class = ALSAlgorithmParams
    query_class = Query

    def _ratings(self, td: TrainingData) -> IndexedRatings:
        return _view_counts(td)

    def train(self, ctx: WorkflowContext, td: TrainingData) -> SimilarProductModel:
        if self.params.sharded_train:
            raise NotImplementedError(
                "sharded_train (factors sharded over several cards) is the "
                "multi-GPU slice of the PyTorch port"
            )
        device = resolve_device(
            self.device if self.device is not None
            else (ctx.device if ctx is not None else None)
        )
        r = self._ratings(td)
        user_index, item_index = r.user_index, r.item_index
        data = als_ops.build_ratings_data(
            r.rows, r.cols, r.vals, len(user_index), len(item_index)
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
        return SimilarProductModel(
            item_index=item_index,
            item_factors=vf,
            categories=dict(td.items),
            item_scales=vs,
        )

    def warmup_query(self, model: SimilarProductModel) -> Query | None:
        """A known item, so the warmup takes the device path."""
        if not len(model.item_index):
            return None
        return Query(items=[model.item_index.inverse[0]], num=4)

    def predict(self, model: SimilarProductModel, query: Query) -> PredictedResult:
        # batch of one through the batched scorer: byte-identical to the
        # same query arriving inside a coalesced micro-batch
        return _score_similar_batch(model, [query], resolve_device(self.device))[0]

    def batch_predict(
        self, model: SimilarProductModel,
        queries: Sequence[tuple[int, Query]],
    ) -> list[tuple[int, PredictedResult]]:
        results = _score_similar_batch(
            model, [q for _, q in queries], resolve_device(self.device)
        )
        return [(ix, r) for (ix, _), r in zip(queries, results)]


class LikeAlgorithm(ALSAlgorithm):
    """like=1 / dislike=-1 signal instead of view counts
    (reference multi/LikeAlgorithm.scala: latest like/dislike wins)."""

    def _ratings(self, td: TrainingData) -> IndexedRatings:
        latest: dict[tuple[str, str], float] = {}
        for u, i, is_like in td.like_events:  # events are time-ordered
            latest[(u, i)] = 1.0 if is_like else -1.0
        return from_triples(
            [(u, i, v) for (u, i), v in latest.items()], extra_items=td.items
        )


@dataclass
class CosineAlgorithmParams(Params):
    top_n: int = 20  # neighbors kept per item (dimsum threshold analog)


@dataclass
class CosineModel:
    item_index: BiMap
    sim_scores: np.ndarray  # [I, N] cosine of the N nearest items
    sim_ids: np.ndarray  # [I, N] their item indices
    categories: dict[str, list[str]]


class CosineAlgorithm(Algorithm):
    """Precomputed exact item-item cosine neighbors from view counts
    (DIMSUM-variant parity; see ops/cosine_sim.py): K6 on the
    algorithm's device at train time, a host loop at serve time."""

    params_class = CosineAlgorithmParams
    query_class = Query

    def train(self, ctx: WorkflowContext, td: TrainingData) -> CosineModel:
        device = resolve_device(
            self.device if self.device is not None
            else (ctx.device if ctx is not None else None)
        )
        r = _view_counts(td)
        scores, ids = item_similarity_topn(
            r.rows, r.cols, r.vals, len(r.user_index), len(r.item_index),
            top_n=self.params.top_n, device=device,
        )
        return CosineModel(
            item_index=r.item_index,
            sim_scores=scores,
            sim_ids=ids,
            categories=dict(td.items),
        )

    def predict(self, model: CosineModel, query: Query) -> PredictedResult:
        known = [model.item_index[i] for i in query.items if i in model.item_index]
        if not known:
            return PredictedResult(itemScores=[])
        combined: dict[int, float] = defaultdict(float)
        for ix in known:
            for score, jx in zip(model.sim_scores[ix], model.sim_ids[ix]):
                if np.isfinite(score):
                    combined[int(jx)] += float(score)
        mask = _exclude_mask(model.item_index, model.categories, query)
        inv = model.item_index.inverse
        ranked = sorted(
            ((jx, s) for jx, s in combined.items() if not mask[jx]),
            key=lambda kv: -kv[1],
        )[: int(query.num)]
        return PredictedResult(
            itemScores=[ItemScore(item=inv[jx], score=s) for jx, s in ranked]
        )


class SumScoreServing(Serving):
    """Combines algorithms by summing per-item scores and re-ranking
    (reference multi/Serving.scala)."""

    def serve(self, query: Query, predictions: Sequence[PredictedResult]) -> PredictedResult:
        combined: dict[str, float] = defaultdict(float)
        for p in predictions:
            for item_score in p.itemScores:
                combined[item_score.item] += item_score.score
        ranked = sorted(combined.items(), key=lambda kv: -kv[1])[: query.num]
        return PredictedResult(
            itemScores=[ItemScore(item=i, score=s) for i, s in ranked]
        )


def engine() -> Engine:
    """Reference SimilarProductEngine factory (multi/Engine.scala:
    Map("als" -> ALSAlgorithm, "likealgo" -> LikeAlgorithm))."""
    return Engine(
        datasource_classes=SimilarProductDataSource,
        preparator_classes=IdentityPreparator,
        algorithm_classes={
            "als": ALSAlgorithm,
            "likealgo": LikeAlgorithm,
            "cosine": CosineAlgorithm,
        },
        serving_classes=SumScoreServing,
    )
