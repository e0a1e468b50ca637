"""E-commerce recommendation template: weighted implicit ALS + live
serve-time business rules.

Port of ``predictionio_tpu/models/ecommerce.py`` (reference
``examples/scala-parallel-ecommercerecommendation/weighted-items``):

- the DataSource reads user/item ``$set`` entities and ``view``/``buy``
  events;
- ALSAlgorithm trains ``ALS.trainImplicit`` on view counts
  (ALSAlgorithm.scala:136) through ``ops/als.py als_train(implicit=True)``:
  K1 on the algorithm's device;
- predict applies, per request: unseen-item filtering from a **live**
  event-store read of the user's seen events, the unavailable-items
  constraint read live from the latest ``$set`` of constraint entity
  ``unavailableItems`` (:234-265), category/white/black-list filters,
  and per-group item weight multipliers (:295, WeightsGroup);
- cold-start users are scored from their recently viewed items' factor
  vectors (predictNewUser, :332-410).

The live business rules become a host-side exclusion mask built before
the device call; the weighted catalog (``V * weights``) is a torch op on
the device, made once per weight set; scoring is one K2 call
(``ops/topk.py top_k_items_batch``) per micro-batch of simple queries,
or, at ``PIO_RETRIEVAL_THRESHOLD`` catalog rows and more, two-stage
retrieval over the weighted catalog (``ops/retrieval.py``: K4, then the
vectors-form rescore K5).

Not ported yet, and refused with ``NotImplementedError`` rather than
answered another way: ``sharded_train`` (several cards).
"""

from __future__ import annotations

import json
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
from predictionio_tpu_torch.data.storage import RatingsBatch, get_storage
from predictionio_tpu_torch.models.columnar import aggregate_counts
from predictionio_tpu_torch.models.filters import entity_exclusion_mask
from predictionio_tpu_torch.models.modelfile import host_array, numpy_to_tensor
from predictionio_tpu_torch.obs import device as obs_device
from predictionio_tpu_torch.ops import als as als_ops
from predictionio_tpu_torch.ops import retrieval
from predictionio_tpu_torch.ops.topk import top_k_items_batch
from predictionio_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclass
class Query:
    user: str = ""
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
    items: dict[str, list[str]] = field(default_factory=dict)
    # bulk signals, columnar (no per-event Python objects at 10^7 scale)
    view_events: RatingsBatch = field(default_factory=RatingsBatch.empty)
    buy_events: RatingsBatch = field(default_factory=RatingsBatch.empty)

    def sanity_check(self) -> None:
        if not len(self.view_events):
            raise ValueError(
                "viewEvents in TrainingData cannot be empty. Please check if "
                "DataSource generates TrainingData correctly."
            )


class ECommerceDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        app = self.params.app_name
        users = list(store.aggregate_properties(app, entity_type="user"))
        items = {
            iid: pm.get_opt("categories", default=[]) or []
            for iid, pm in store.aggregate_properties(app, entity_type="item").items()
        }
        views = store.find_ratings(
            app, entity_type="user", event_names=["view"],
            target_entity_type="item", rating_key=None,
            default_ratings={"view": 1.0},
        )
        buys = store.find_ratings(
            app, entity_type="user", event_names=["buy"],
            target_entity_type="item", rating_key=None,
            default_ratings={"buy": 1.0},
        )
        return TrainingData(
            users=users, items=items, view_events=views, buy_events=buys
        )


@dataclass
class WeightsGroup:
    items: list[str] = field(default_factory=list)
    weight: float = 1.0


@dataclass
class ECommAlgorithmParams(Params):
    app_name: str = ""  # for live serve-time event reads
    unseen_only: bool = True
    seen_events: tuple[str, ...] = ("view", "buy")
    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: int = 3
    compute_dtype: str = "float32"
    storage_dtype: str = "float32"
    weights: list[dict] = field(default_factory=list)  # [{items, weight}]
    sharded_train: bool = False
    sharded_gather_budget_bytes: int | None = None


@dataclass
class ECommModel:
    """Host-persistable factors; device tensors made on first use (int8
    storage: the factor arrays hold the quantized values and the scales
    the per-row f32 scales; bfloat16 is held as ``modelfile.BFLOAT16``)."""

    user_index: BiMap
    item_index: BiMap
    user_factors: np.ndarray  # int8 values when user_scales set
    item_factors: np.ndarray  # int8 values when item_scales set
    categories: dict[str, list[str]]
    user_scales: np.ndarray | None = None  # [U] f32, int8 storage only
    item_scales: np.ndarray | None = None  # [I] f32, int8 storage only

    def __post_init__(self):
        self.user_factors = host_array(self.user_factors)
        self.item_factors = host_array(self.item_factors)
        self._device: tuple[torch.device, tuple] | None = None
        self._device_lock = threading.Lock()

    def _rows(self, factors, scales, ixs) -> np.ndarray:
        rows = numpy_to_tensor(factors[ixs], torch.device("cpu")).float().numpy()
        if scales is not None:
            return rows * scales[ixs][..., None]
        return rows

    def user_rows(self, ixs):
        """Dense f32 user vectors (dequantizes int8, widens bf16)."""
        return self._rows(self.user_factors, self.user_scales, ixs)

    def item_rows(self, ixs):
        """Dense f32 item vectors (dequantizes int8, widens bf16)."""
        return self._rows(self.item_factors, self.item_scales, ixs)

    def device_factors(self, device: torch.device) -> tuple:
        """(U, V) on ``device``, uploaded once and cached; quantized tables
        stay (values, scales) pairs on the device -- K2 scores them
        without densifying."""
        with self._device_lock:
            if self._device is None or self._device[0] != device:

                def put(values, scales):
                    if scales is not None:
                        return (numpy_to_tensor(values, device),
                                numpy_to_tensor(scales, device))
                    return numpy_to_tensor(values, device)

                self._device = (device, (
                    put(self.user_factors, self.user_scales),
                    put(self.item_factors, self.item_scales),
                ))
                obs_device.count_transfer("h2d", "serve.model_put", sum(
                    a.nbytes for a in (self.user_factors, self.user_scales,
                                       self.item_factors, self.item_scales)
                    if a is not None
                ))
            return self._device[1]

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_device"] = None
        del state["_device_lock"]
        # derived serving caches (device tensors / index maps) rebuild
        # lazily after unpickle
        state.pop("_weighted_V", None)
        state.pop("_coarse_V", None)
        state.pop("_cat_members", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._device_lock = threading.Lock()


class ECommAlgorithm(Algorithm):
    params_class = ECommAlgorithmParams
    query_class = Query

    def __init__(self, params=None):
        super().__init__(params)
        # serving caches are read and rebuilt from concurrent HTTP
        # handler threads; one lock (double-checked before each costly
        # rebuild) keeps a write spike from fanning out N duplicate
        # full-store scans / [I, D] multiplies whose results all but one
        # thread would discard
        self._serve_lock = threading.Lock()

    def train(self, ctx: WorkflowContext, td: TrainingData) -> ECommModel:
        if self.params.sharded_train:
            raise NotImplementedError(
                "sharded_train (factors sharded over several cards) is the "
                "multi-GPU slice of the PyTorch port"
            )
        if not len(td.view_events):
            raise ValueError("cannot train on zero view events")
        device = resolve_device(
            self.device if self.device is not None
            else (ctx.device if ctx is not None else None)
        )
        r = aggregate_counts(td.view_events, extra_items=td.items)
        user_index, item_index = r.user_index, r.item_index
        data = als_ops.build_ratings_data(
            r.rows, r.cols, r.vals, len(user_index), len(item_index)
        )
        U, V = als_ops.als_train(
            data,
            als_ops.ALSParams(
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
            ),
            device=device,
        )
        uf, us = als_ops.host_factors(U)
        vf, vs = als_ops.host_factors(V)
        return ECommModel(
            user_index=user_index,
            item_index=item_index,
            user_factors=uf,
            item_factors=vf,
            categories=dict(td.items),
            user_scales=us,
            item_scales=vs,
        )

    # -- live business rules (host-side, before the device call) ----------
    #
    # Live semantics with cached cost: every filter read goes through a
    # per-algorithm cache keyed by the event store's change_token -- a
    # static store serves seen/unavailable sets from memory (the reads
    # that made live-filter serving ~100x the dense path replayed the
    # event store per request), while ANY write to the store changes the
    # token and drops the whole cache, so a just-ingested
    # ``$set unavailableItems`` or view event takes effect on the next
    # query. A custom Events DAO without a change_token override returns
    # None, which disables caching and keeps the reference's
    # read-per-request behavior.

    def _filter_cache(self) -> tuple[dict | None, object]:
        """(cache dict or None if caching disabled, current token).

        Read ONCE per query (predict passes the cache down). The (app_id,
        channel_id) resolution is memoized -- it is immutable for the
        life of a deployed engine."""
        try:
            ids = getattr(self, "_app_ids", None)
            if ids is None:
                ids = store.app_name_to_id(self.params.app_name)
                self._app_ids = ids
            token = get_storage().get_events().change_token(*ids)
        except Exception:
            token = None
        if token is None:
            return None, None
        cache = getattr(self, "_filters", None)
        if cache is None or cache["token"] != token:
            with self._serve_lock:
                cache = getattr(self, "_filters", None)  # double-check
                if cache is None or cache["token"] != token:
                    cache = {"token": token, "seen": {}, "unavail": None}
                    self._filters = cache
        return cache, token

    def _seen_items(self, user: str, cache: dict | None) -> set[str]:
        """Live read of the user's seen events (reference :234-249),
        cached until the event store changes.

        On replay-style backends (memory -- where a filtered read costs a
        full scan anyway) the first miss builds the seen sets of EVERY
        user in one scan, so 40 distinct users cost one replay, not 40.
        Indexed backends (sqlite) keep cheap per-user point reads."""
        if cache is not None:
            if user in cache["seen"]:
                return cache["seen"][user]
            if cache.get("seen_all") is not None:
                return cache["seen_all"].get(user, frozenset())
        try:
            indexed = get_storage().get_events().entity_indexed
        except Exception:
            indexed = True
        if cache is not None and not indexed:
            with self._serve_lock:
                if cache.get("seen_all") is not None:  # double-check
                    return cache["seen_all"].get(user, frozenset())
                try:
                    events = store.find(
                        app_name=self.params.app_name,
                        entity_type="user",
                        event_names=list(self.params.seen_events),
                        target_entity_type="item",
                        limit=None,
                    )
                except Exception:
                    logger.exception(
                        "seen-items scan failed; serving without filter"
                    )
                    return set()
                seen_all: dict[str, set[str]] = {}
                for e in events:
                    if e.target_entity_id:
                        seen_all.setdefault(e.entity_id, set()).add(
                            e.target_entity_id
                        )
                cache["seen_all"] = seen_all
                return seen_all.get(user, frozenset())
        try:
            events = store.find_by_entity(
                app_name=self.params.app_name,
                entity_type="user",
                entity_id=user,
                event_names=list(self.params.seen_events),
                target_entity_type="item",
                limit=None,
            )
        except Exception:
            logger.exception("seen-items read failed; serving without filter")
            return set()
        seen = {e.target_entity_id for e in events if e.target_entity_id}
        if cache is not None:
            cache["seen"][user] = seen
        return seen

    def _unavailable_items(self, cache: dict | None) -> set[str]:
        """Live read of the latest unavailableItems constraint
        (reference :250-265), cached until the event store changes."""
        if cache is not None and cache["unavail"] is not None:
            return cache["unavail"]
        try:
            events = store.find_by_entity(
                app_name=self.params.app_name,
                entity_type="constraint",
                entity_id="unavailableItems",
                event_names=["$set"],
                limit=1,
                latest=True,
            )
        except Exception:
            logger.exception("constraint read failed; serving without filter")
            return set()
        unavail = (
            set(events[0].properties.get_opt("items", default=[]) or [])
            if events
            else set()
        )
        if cache is not None:
            cache["unavail"] = unavail
        return unavail

    def _recent_item_vector(self, model: ECommModel, user: str):
        """Cold-start: mean factor vector of recently viewed items
        (reference predictNewUser :332-410)."""
        try:
            events = store.find_by_entity(
                app_name=self.params.app_name,
                entity_type="user",
                entity_id=user,
                event_names=["view"],
                target_entity_type="item",
                limit=10,
                latest=True,
            )
        except Exception:
            return None
        ixs = [
            model.item_index[e.target_entity_id]
            for e in events
            if e.target_entity_id in model.item_index
        ]
        if not ixs:
            return None
        return model.item_rows(ixs).mean(axis=0)

    def _category_members(self, model: ECommModel, category: str) -> np.ndarray:
        """Item indices carrying ``category`` -- built once per (model,
        category), replacing the per-query full-catalog Python loop."""
        index = getattr(model, "_cat_members", None)
        if index is None:
            index = {}
            model._cat_members = index
        got = index.get(category)
        if got is None:
            with self._serve_lock:
                got = index.get(category)  # double-check
                if got is None:
                    got = np.fromiter(
                        (
                            ix
                            for iid, ix in model.item_index.items()
                            if category in model.categories.get(iid, ())
                        ),
                        np.int64,
                    )
                    index[category] = got
        return got

    def _exclusions(self, model: ECommModel, query: Query) -> np.ndarray:
        """Per-query exclusion mask: white/black lists, categories,
        unavailable items, seen items (reference :234-295)."""
        n = len(model.item_index)
        mask = entity_exclusion_mask(
            model.item_index, (), query.whiteList, query.blackList
        )
        if query.categories is not None:
            in_any = np.zeros(n, bool)
            for cat in query.categories:
                in_any[self._category_members(model, cat)] = True
            mask |= ~in_any
        cache, _ = self._filter_cache()  # one token read per query
        for iid in self._unavailable_items(cache):
            if iid in model.item_index:
                mask[model.item_index[iid]] = True
        if self.params.unseen_only:
            for iid in self._seen_items(query.user, cache):
                if iid in model.item_index:
                    mask[model.item_index[iid]] = True
        return mask

    def _weighted_item_factors(self, model: ECommModel, device: torch.device):
        """Device-resident ``V * weights`` -- weights are static per
        deployment (params), so the [I, D] multiply runs once, on the
        device, not per query. Keyed by the device and the weight
        CONTENT: two algorithms with different weight groups may serve
        the same model object."""
        key = (str(device), json.dumps(self.params.weights, sort_keys=True))
        # lock-free hit path: predicts must not stall behind the lock
        # while another thread holds it across a full-store seen scan
        cache = getattr(model, "_weighted_V", None)
        if cache is not None and key in cache:
            return cache[key]
        with self._serve_lock:
            cache = getattr(model, "_weighted_V", None)  # double-check
            if cache is None:
                cache = {}
                model._weighted_V = cache
            if key in cache:
                return cache[key]
            _, V = model.device_factors(device)
            if self.params.weights:
                n = len(model.item_index)
                weights = np.ones(n, dtype=np.float32)
                for group in self.params.weights:
                    w = float(group.get("weight", 1.0))
                    for iid in group.get("items", []):
                        if iid in model.item_index:
                            weights[model.item_index[iid]] = w
                w_dev = torch.from_numpy(weights).to(device)
                if isinstance(V, tuple):
                    # per-row weight folds into the per-row scale: the
                    # weighted catalog stays int8
                    weighted = (V[0], V[1] * w_dev)
                else:
                    weighted = (V * w_dev[:, None]).contiguous()
            else:
                weighted = V
            cache[key] = weighted
            return weighted

    def _coarse_catalog(self, model: ECommModel, device: torch.device):
        """Tiled coarse copy of the WEIGHTED item table for the two-stage
        shortlist pass (ops/retrieval.py) -- the business-rule weights
        bake into the coarse scores exactly like the exact path's, so the
        shortlist ranks what serving ranks. Cached like
        ``_weighted_item_factors``."""
        key = (str(device), json.dumps(self.params.weights, sort_keys=True))
        cache = getattr(model, "_coarse_V", None)
        if cache is not None and key in cache:
            return cache[key]
        table = self._weighted_item_factors(model, device)
        with self._serve_lock:
            cache = getattr(model, "_coarse_V", None)  # double-check
            if cache is None:
                cache = {}
                model._coarse_V = cache
            if key not in cache:
                cache[key] = retrieval.CoarseCatalog(table, device=device)
            return cache[key]

    def cacheable_query(self, query: Query) -> bool:
        """Never cacheable: predictions depend on LIVE event-store state
        the epoch fence can't see -- the user's seen events, the latest
        ``$set`` of the ``unavailableItems`` constraint entity, and
        cold-start users' recent views all change with ingest, not with
        model swaps. A cached result would keep recommending an item the
        store just marked unavailable until the next retrain."""
        return False

    def warmup_query(self, model: ECommModel) -> Query | None:
        """A known user, so the warmup takes the device path."""
        if not len(model.user_index):
            return None
        return Query(user=model.user_index.inverse[0], num=4)

    def predict(self, model: ECommModel, query: Query) -> PredictedResult:
        # batch of one through the batched scorer: byte-identical to the
        # same query arriving inside a coalesced micro-batch
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(
        self, model: ECommModel, queries: Sequence[tuple[int, Query]]
    ) -> list[tuple[int, PredictedResult]]:
        """Batched scoring with the live business rules intact: the
        exclusion masks (seen/unavailable/black-list) are built host-side
        per query BEFORE dispatch, then every category/whiteList-free
        query in the micro-batch shares one ``top_k_items_batch`` call
        with headroom k = pow2(num + |excluded|) and drops its exclusions
        host-side. Category/whiteList queries can exclude most of the
        catalog (headroom would balloon to the catalog size), so they
        keep per-query masked calls through the same kernel."""
        device = resolve_device(self.device)
        inv = model.item_index.inverse
        results: list[PredictedResult | None] = [None] * len(queries)
        vecs: list[np.ndarray | None] = [None] * len(queries)
        masks: list[np.ndarray | None] = [None] * len(queries)
        simple: list[int] = []
        complex_: list[int] = []
        for qi, (_, q) in enumerate(queries):
            if q.user in model.user_index:
                vec = np.asarray(model.user_rows(model.user_index[q.user]))
            else:
                recent = self._recent_item_vector(model, q.user)
                if recent is None:
                    logger.info(
                        "user %s has no factors and no recent views;"
                        " empty result",
                        q.user,
                    )
                    results[qi] = PredictedResult(itemScores=[])
                    continue
                vec = np.asarray(recent)
            vecs[qi] = vec.astype(np.float32)
            masks[qi] = self._exclusions(model, q)
            if q.categories is None and q.whiteList is None:
                simple.append(qi)
            else:
                complex_.append(qi)
        V = self._weighted_item_factors(model, device)
        n_items = len(model.item_index)
        if simple:
            batch = np.stack([vecs[qi] for qi in simple])
            k = _pow2(
                max(
                    int(queries[qi][1].num) + int(masks[qi].sum())
                    for qi in simple
                )
            )
            kp = retrieval.shortlist_k(k, n_items) if retrieval.engaged(n_items) else 0
            if kp and k <= kp < n_items:
                # two-stage: coarse shortlist over the weighted catalog,
                # exact rescore of the [B, S] candidates, one launch on the
                # card (ops/retrieval.py)
                scores, ids = retrieval.two_stage_top_k(
                    self._coarse_catalog(model, device), batch, kp, k, "vectors", V,
                    vectors=batch)
                if retrieval.probe_due():
                    _, exact_ids = top_k_items_batch(batch[:1], V, k=k)
                    retrieval.probe_recall(ids[0], exact_ids.cpu().numpy()[0])
            else:
                scores, ids = top_k_items_batch(batch, V, k=k)
                scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
            for row, qi in enumerate(simple):
                mask, num = masks[qi], int(queries[qi][1].num)
                item_scores: list[ItemScore] = []
                for s, i in zip(scores[row], ids[row]):
                    ii = int(i)
                    if ii < 0 or mask[ii]:
                        continue
                    item_scores.append(ItemScore(item=inv[ii], score=float(s)))
                    if len(item_scores) == num:
                        break
                results[qi] = PredictedResult(itemScores=item_scores)
        if complex_ and retrieval.engaged(n_items):
            # category/whiteList masks can cover most of the catalog:
            # exact masked path
            retrieval.note_exact(len(complex_))
        for qi in complex_:
            num = int(queries[qi][1].num)
            scores, ids = top_k_items_batch(
                vecs[qi][None, :], V, k=_pow2(num), exclude_mask=masks[qi],
            )
            row_s = scores.cpu().numpy()[0][:num]
            row_i = ids.cpu().numpy()[0][:num]
            results[qi] = PredictedResult(
                itemScores=[
                    ItemScore(item=inv[int(i)], score=float(s))
                    for s, i in zip(row_s, row_i)
                    if s > -1e29
                ]
            )
        return [(ix, r) for (ix, _), r in zip(queries, results)]


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def engine() -> Engine:
    """Reference ECommerceRecommendationEngine factory."""
    return Engine(
        datasource_classes=ECommerceDataSource,
        preparator_classes=IdentityPreparator,
        algorithm_classes={"als": ECommAlgorithm},
        serving_classes=FirstServing,
    )
