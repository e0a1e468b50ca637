"""Recommendation engine template: explicit-feedback ALS.

Port of ``predictionio_tpu/models/recommendation.py`` (reference
``examples/scala-parallel-recommendation/custom-prepartor``):

- the DataSource reads ``rate`` and ``buy`` events from the event store,
  ``buy`` forced to ``buy_rating`` (DataSource.scala:35-60);
- ALSAlgorithm trains ALS at the configured rank/iterations/lambda
  (``ops/als.py`` ``als_train``, one K1 launch per bucket, kernel
  ``csrc/als_solve.cu``) on the algorithm's device, optionally warm
  started from the previous instance's model;
- predict scores through K2, the fused gather -> score -> top-k
  (``ops/topk.py``, kernel ``csrc/topk.cu``); a catalog of
  ``PIO_RETRIEVAL_THRESHOLD`` rows or more (default 100,000) goes
  through two-stage retrieval instead (``ops/retrieval.py``): a coarse
  shortlist over the model's ``CoarseCatalog`` (K4), then the exact
  rescore of the shortlist (K5), with a live recall probe on K2;
- evaluation: ``read_eval`` makes the seeded k-fold splits,
  ``train_sweep`` trains a sweep's candidates at once (``ops/als.py``
  ``als_train_sweep``, K1s) and ``eval_topk`` scores a whole split in
  one batched K2 call (``ops/topk.py gather_top_k_batch``), for
  core/fast_eval.py.

Queries/results use the reference template's JSON shape:
``{"user": "1", "num": 4}`` -> ``{"itemScores": [{"item": ..., "score": ...}]}``.

On a store with tail files (``jsonl``, ``partitioned``) ``read_training``
probes the packed-prep cache (``core/prep_cache.py``): a hit maps the
previous batch and buckets, a splice decodes only the appended tail and
rebuilds the width classes it touches, and ``train`` publishes the new
entry after K1 has trained on it.

Not ported yet, and refused with ``NotImplementedError`` rather than
answered another way: ``sharded_train`` / ``sharded_serving`` (several
cards).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from predictionio_tpu_torch.core import (
    Algorithm,
    DataSource,
    Engine,
    EvalTopK,
    FirstServing,
    Params,
    Preparator,
    SanityCheck,
    WorkflowContext,
)
from predictionio_tpu_torch.core import prep_cache
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.storage import RatingsBatch
from predictionio_tpu_torch.models.modelfile import (
    BFLOAT16,
    host_array,
    numpy_to_tensor,
)
from predictionio_tpu_torch.obs import device as obs_device
from predictionio_tpu_torch.ops import als as als_ops
from predictionio_tpu_torch.ops import retrieval
from predictionio_tpu_torch.ops.topk import gather_top_k_batch
from predictionio_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


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
    # evaluation split knobs (read_eval): fold count and the seed of the
    # shuffled fold assignment, so repeated evaluations see the same folds
    eval_folds: int = 3
    eval_seed: int = 42


@dataclass
class TrainingData(SanityCheck):
    """Columnar ratings: dense-indexed COO triples plus id lists.
    ``user_ids[rows[i]]`` rated ``item_ids[cols[i]]`` with ``ratings[i]``.
    ``prep`` is the packed-prep cache handle of the read
    (``core/prep_cache.py PrepHandle``): ``train`` takes its cached or
    spliced buckets and publishes the new entry. None for synthetic
    TrainingData (eval folds, tests)."""

    user_ids: list[str] = field(default_factory=list)
    item_ids: list[str] = field(default_factory=list)
    rows: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    cols: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    ratings: np.ndarray = field(default_factory=lambda: np.empty(0, np.float32))
    prep: object = field(default=None, repr=False, compare=False)

    def sanity_check(self) -> None:
        if len(self.ratings) == 0:
            raise ValueError(
                "TrainingData has no ratings; check event store contents "
                "and the datasource appName"
            )


class RecommendationDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        # buy is FORCED to buy_rating, beating any rating property (the
        # reference ignores properties for buy events, DataSource.scala:55).
        # The probe takes the JAX package's filter set, so both packages
        # key the same entry
        t0 = time.perf_counter()
        handle = prep_cache.probe(
            self.params.app_name,
            entity_type="user",
            event_names=list(self.params.event_names),
            target_entity_type="item",
            rating_key="rating",
            default_ratings=None,
            override_ratings={"buy": self.params.buy_rating},
        )
        if handle.status in ("hit", "splice"):
            # a hit maps the previous batch; a splice decoded only the
            # appended tail bytes
            batch = handle.batch
        else:
            batch = store.find_ratings(
                app_name=self.params.app_name,
                entity_type="user",
                event_names=list(self.params.event_names),
                target_entity_type="item",
                rating_key="rating",
                override_ratings={"buy": self.params.buy_rating},
            )
        logger.info(
            "read_training: %d rating rows in %.3fs (prep cache: %s)",
            len(batch.vals), time.perf_counter() - t0, handle.status,
        )
        return TrainingData(
            user_ids=batch.entity_ids,
            item_ids=batch.target_ids,
            rows=batch.rows,
            cols=batch.cols,
            ratings=batch.vals,
            prep=handle,
        )

    def read_eval(self, ctx: WorkflowContext):
        """Seeded k-fold split for evaluation: a shuffled balanced
        partition from numpy's ``default_rng(eval_seed)``, so the folds
        are the JAX package's on the same events, and repeated runs see
        the same splits and scores. Each train fold's id space is
        compacted to the entities it holds (a user whose every rating fell
        in the test fold is unknown to that model: an empty prediction,
        not a score from untrained factors); each held-out rating is one
        ``num=1`` query."""
        td = self.read_training(ctx)
        k = max(1, int(self.params.eval_folds))
        folds = []
        n = len(td.ratings)
        rng = np.random.default_rng(int(self.params.eval_seed))
        fold_of = np.empty(n, dtype=np.int64)
        fold_of[rng.permutation(n)] = np.arange(n) % k
        for fold in range(k):
            mask = fold_of == fold
            rows_tr, cols_tr = td.rows[~mask], td.cols[~mask]
            used_u = np.unique(rows_tr)
            used_i = np.unique(cols_tr)
            train = TrainingData(
                user_ids=[td.user_ids[u] for u in used_u],
                item_ids=[td.item_ids[i] for i in used_i],
                rows=np.searchsorted(used_u, rows_tr).astype(np.int32),
                cols=np.searchsorted(used_i, cols_tr).astype(np.int32),
                ratings=td.ratings[~mask],
            )
            qa = [
                (
                    Query(user=td.user_ids[td.rows[i]], num=1),
                    {
                        "item": td.item_ids[td.cols[i]],
                        "rating": float(td.ratings[i]),
                    },
                )
                for i in np.flatnonzero(mask)
            ]
            folds.append((train, {"fold": fold}, qa))
        return folds


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

    def user_rows(self, ixs) -> np.ndarray:
        """Dense f32 user vectors for the given indices (dequantizing
        int8, widening bf16): the shortlist pass's queries, on the host."""
        rows = numpy_to_tensor(self.user_factors[ixs], torch.device("cpu")).float().numpy()
        if self.user_scales is not None:
            return rows * self.user_scales[ixs][..., None]
        return rows

    def coarse_catalog(self, device: torch.device) -> retrieval.CoarseCatalog:
        """Tiled coarse copy of the item table on ``device`` for the
        two-stage shortlist pass, built once a catalog crosses
        ``PIO_RETRIEVAL_THRESHOLD`` and cached (dropped when pickled; a
        reload loads a new model)."""
        with self._device_lock:
            if self._coarse is None or self._coarse[0] != device:
                table = self.item_factors if self.item_scales is None else (
                    self.item_factors, self.item_scales)
                self._coarse = (device, retrieval.CoarseCatalog(table, device=device))
            return self._coarse[1]

    def device_factors(self, device: torch.device) -> tuple:
        """(U, V) on ``device``, uploaded once and cached; int8 tables stay
        (values, scales) pairs on the device."""
        with self._device_lock:
            if self._device is None or self._device[0] != device:
                self._device = (device, (
                    _put(self.user_factors, self.user_scales, device),
                    _put(self.item_factors, self.item_scales, device),
                ))
                obs_device.count_transfer("h2d", "serve.model_put", sum(
                    a.nbytes for a in (self.user_factors, self.user_scales,
                                       self.item_factors, self.item_scales)
                    if a is not None
                ))
            return self._device[1]

    def carry_device(self, old: "ALSModel", device: torch.device) -> None:
        """Adopt ``old``'s item table on ``device`` and its coarse catalog,
        and upload this model's user table: for a fold-in patch, which
        shares ``old``'s item arrays. The speed layer calls it in its own
        thread, so the served swap uploads nothing and no request pays
        for it (``apply_patch`` counts the patch's bytes)."""
        item = old.device_factors(device)[1]
        user = _put(self.user_factors, self.user_scales, device)
        with self._device_lock:
            self._device = (device, (user, item))
            self._coarse = old._coarse


def _put(values: np.ndarray, scales: np.ndarray | None, device: torch.device):
    """One factor table on ``device``: a tensor, or the int8 (values,
    scales) pair."""
    if scales is not None:
        return numpy_to_tensor(values, device), numpy_to_tensor(scales, device)
    return numpy_to_tensor(values, device)


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


class ALSAlgorithm(Algorithm):
    params_class = ALSAlgorithmParams
    query_class = Query

    def train(self, ctx: WorkflowContext, td: TrainingData) -> ALSModel:
        if len(td.ratings) == 0:
            raise ValueError("cannot train ALS on zero ratings")
        if self.params.sharded_train:
            raise NotImplementedError(
                "sharded_train (factors sharded over several cards) is the "
                "multi-GPU slice of the PyTorch port"
            )
        device = resolve_device(
            self.device if self.device is not None
            else (ctx.device if ctx is not None else None)
        )
        # ids arrive dense-indexed from the columnar read; the BiMap is a
        # view over the id lists
        user_index = BiMap.from_dense(td.user_ids)
        item_index = BiMap.from_dense(td.item_ids)
        rows, cols = td.rows, td.cols
        vals = np.asarray(td.ratings, dtype=np.float32)
        prep = td.prep
        widths = tuple(self.params.bucket_widths)
        packed = prep.packed_buckets(widths) if prep is not None and prep.active else None
        if packed is not None:
            # buckets from the prep cache: mapped on a hit, spliced after an
            # appended tail; bit-identical to a fresh build by contract
            data = als_ops.RatingsData(
                rows=np.asarray(rows, np.int32), cols=np.asarray(cols, np.int32),
                vals=vals, num_rows=len(user_index), num_cols=len(item_index),
                row_buckets=packed[0], col_buckets=packed[1],
            )
        else:
            data = als_ops.build_ratings_data(
                rows, cols, vals, len(user_index), len(item_index),
                bucket_widths=widths,
            )
        params = als_ops.ALSParams(
            rank=self.params.rank,
            iterations=self.params.num_iterations,
            reg=self.params.lambda_,
            seed=self.params.seed,
            compute_dtype=self.params.compute_dtype,
            storage_dtype=self.params.storage_dtype,
            **als_ops.sharded_budget_kwarg(self.params.sharded_gather_budget_bytes),
        )
        warm = self._resolve_warm_start(ctx, td)
        try:
            tol = float(os.environ.get("PIO_TOL", "") or (
                ctx.runtime_conf.get("tol", 0.0) if ctx is not None else 0.0
            ) or 0.0)
        except ValueError:
            tol = 0.0
        U, V = als_ops.als_train(
            data, params, warm_start=warm, tol=tol, device=device,
            progress_extra={"prep_cache": prep.status} if prep is not None else None,
        )
        if prep is not None and prep.active and prep.status != "hit":
            prep.publish(
                RatingsBatch(
                    entity_ids=td.user_ids, target_ids=td.item_ids,
                    rows=data.rows, cols=data.cols, vals=data.vals,
                ),
                data=data,
                bucket_widths=widths,
            )
        logger.info(
            "ALS trained: %d users x %d items, rank %d, train RMSE %.4f",
            len(user_index), len(item_index), self.params.rank,
            als_ops.rmse(U, V, rows, cols, vals),
        )
        uf, us = als_ops.host_factors(U)
        vf, vs = als_ops.host_factors(V)
        return ALSModel(
            user_index=user_index,
            item_index=item_index,
            user_factors=uf,
            item_factors=vf,
            user_scales=us,
            item_scales=vs,
        )

    def train_sweep(
        self, ctx: WorkflowContext, td: TrainingData, params_list
    ) -> list[ALSModel] | None:
        """Stacked candidate trainings for evaluation sweeps: one bucket
        layout and K1s's launches of each bucket's half-step train every
        reg/seed/rank candidate (``ops/als.py als_train_sweep``: differing
        ranks ride the candidate axis by exact zero-padding). None -- one
        ``train`` a candidate -- when the candidates differ in program
        shape (iterations, dtypes, bucket widths), ask for sharded
        training, or mix ranks with a lambda <= 0, as the JAX package
        declines."""
        if len(td.ratings) == 0 or len(params_list) < 2:
            return None
        base = params_list[0]
        ranks_differ = len({p.rank for p in params_list}) > 1
        for p in params_list:
            if (
                p.num_iterations != base.num_iterations
                or p.compute_dtype != base.compute_dtype
                or p.storage_dtype != base.storage_dtype
                or tuple(p.bucket_widths) != tuple(base.bucket_widths)
                or p.sharded_train
                or (ranks_differ and p.lambda_ <= 0)
            ):
                return None
        device = resolve_device(
            self.device if self.device is not None
            else (ctx.device if ctx is not None else None)
        )
        user_index = BiMap.from_dense(td.user_ids)
        item_index = BiMap.from_dense(td.item_ids)
        data = als_ops.build_ratings_data(
            td.rows, td.cols, np.asarray(td.ratings, dtype=np.float32),
            len(user_index), len(item_index),
            bucket_widths=tuple(base.bucket_widths),
        )
        candidates = [
            als_ops.ALSParams(
                rank=p.rank,
                iterations=p.num_iterations,
                reg=p.lambda_,
                seed=p.seed,
                compute_dtype=p.compute_dtype,
                storage_dtype=p.storage_dtype,
            )
            for p in params_list
        ]
        results = als_ops.als_train_sweep(data, candidates, device=device)
        logger.info(
            "ALS sweep: %d candidates trained together (%d users x %d items, "
            "ranks %s)", len(candidates), len(user_index), len(item_index),
            sorted({p.rank for p in candidates}),
        )
        out = []
        for U, V in results:
            uf, us = als_ops.host_factors(U)
            vf, vs = als_ops.host_factors(V)
            model = ALSModel(
                user_index=user_index,
                item_index=item_index,
                user_factors=uf,
                item_factors=vf,
                user_scales=us,
                item_scales=vs,
            )
            # the trained tables stay on the device for eval_topk, which
            # would otherwise upload the host copy again
            model._device = (device, (U, V))
            out.append(model)
        return out

    def _resolve_warm_start(self, ctx, td: TrainingData):
        """Previous model -> iteration-0 factor carry, or None for cold.

        The model arrives via ``ctx.runtime_conf["warm_start_model"]``
        (core/workflow.py resolves ``--warm-start`` to the latest
        COMPLETED instance's model, which either package may have
        trained). An incompatible model -- another type, rank or storage
        dtype -- falls back to a cold start with a named warning. Rows
        are re-aligned id by id; entities the previous model lacks keep
        NaN, which the trainer replaces with the cold draw."""
        prev = ctx.runtime_conf.get("warm_start_model") if ctx is not None else None
        if prev is None:
            return None
        if not isinstance(prev, ALSModel):
            logger.warning(
                "warm-start: previous model is %s, not ALSModel; cold start",
                type(prev).__name__,
            )
            return None
        prev_rank = int(prev.user_factors.shape[1])
        if prev_rank != int(self.params.rank):
            logger.warning(
                "warm-start: rank mismatch (previous model %d, params %d); "
                "cold start", prev_rank, self.params.rank,
            )
            return None
        prev_dtype = (
            "int8" if prev.user_scales is not None
            else "bfloat16" if prev.user_factors.dtype == BFLOAT16
            else str(prev.user_factors.dtype)
        )
        if prev_dtype != self.params.storage_dtype:
            logger.warning(
                "warm-start: storage dtype mismatch (previous model %s, "
                "params %s); cold start", prev_dtype, self.params.storage_dtype,
            )
            return None

        def rows_f32(values, scales, ixs):
            x = numpy_to_tensor(values[ixs], torch.device("cpu")).float().numpy()
            return x * scales[ixs][:, None] if scales is not None else x

        def align(ids, index, values, scales):
            out = np.full((len(ids), prev_rank), np.nan, np.float32)
            ix = np.fromiter((index.get(i, -1) for i in ids), np.int64, len(ids))
            m = ix >= 0
            if m.any():
                out[np.flatnonzero(m)] = rows_f32(values, scales, ix[m])
            return out

        U0 = align(td.user_ids, prev.user_index, prev.user_factors, prev.user_scales)
        V0 = align(td.item_ids, prev.item_index, prev.item_factors, prev.item_scales)
        logger.info(
            "warm-start: carrying %d/%d user and %d/%d item factor rows "
            "from previous model",
            int(np.isfinite(U0[:, 0]).sum()), len(td.user_ids),
            int(np.isfinite(V0[:, 0]).sum()), len(td.item_ids),
        )
        return U0, V0

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
        """One fused gather + score + top-k device call (K2) for all known
        users; unknown users get empty results.

        Catalogs with at least ``PIO_RETRIEVAL_THRESHOLD`` rows route
        through two-stage retrieval (``ops/retrieval.py``): the coarse
        shortlist of k' candidates (K4), then the exact rescore of the
        ``[B, k']`` shortlist (K5), one ``two_stage_top_k`` call (one
        launch on the card), every ``PIO_RETRIEVAL_PROBE_EVERY``-th
        dispatch probing one query's recall against K2. Below the
        threshold nothing changes, bit for bit."""
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
        kp = retrieval.shortlist_k(k, num_items) if retrieval.engaged(num_items) else 0
        two_stage = bool(kp) and k <= kp < num_items
        device = resolve_device(self.device)
        U, V = model.device_factors(device)
        if two_stage:
            scores, ids = retrieval.two_stage_top_k(
                model.coarse_catalog(device), model.user_rows(uixs), kp, k, "gather", V,
                user_ixs=uixs, user_factors=U)
            if retrieval.probe_due():
                # live recall probe: the dispatch's first query scored exactly
                _, exact_ids = gather_top_k_batch(uixs[:1], U, V, k)
                n0 = int(known[0][1].num)
                retrieval.probe_recall(ids[0, :n0], exact_ids.cpu().numpy()[0, :n0])
        else:
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


    def eval_topk(
        self, model: ALSModel, queries: Sequence[Query], k: int
    ) -> EvalTopK | None:
        """Device eval scoring (core/fast_eval.py eval_device): one
        batched top-k (K2, ``gather_top_k_batch``, the serving path's
        call) over every known user of the eval split. The ``[Q, k]`` id
        and score matrices stay on the algorithm's device as torch
        tensors.

        Parity with the per-query path: the same call on the same tables,
        a top-k prefix that does not depend on k, all -1 rows for unknown
        users, and each row capped to its query's ``num`` as ``predict``
        truncates its result list."""
        if self.params.sharded_serving:
            raise NotImplementedError(
                "sharded_serving (ring top-k over several cards) is the "
                "multi-GPU slice of the PyTorch port"
            )
        num_items = len(model.item_index)
        if num_items == 0:
            return None
        device = resolve_device(self.device)
        kr = max(1, min(int(k), num_items))
        qn = len(queries)
        ids = torch.full((qn, kr), -1, dtype=torch.int32, device=device)
        scores = torch.zeros((qn, kr), dtype=torch.float32, device=device)
        known = [qi for qi, q in enumerate(queries) if q.user in model.user_index]
        if known:
            uixs = np.asarray(
                [model.user_index[queries[qi].user] for qi in known], dtype=np.int32
            )
            U, V = model.device_factors(device)
            s, i = gather_top_k_batch(uixs, U, V, kr)
            at = torch.from_numpy(np.asarray(known, dtype=np.int64)).to(device)
            ids[at] = i
            scores[at] = s
        # cap each row to the query's requested result count, as the
        # per-query path slices to q.num before metrics see it
        nums = torch.tensor([int(q.num) for q in queries], dtype=torch.int64,
                            device=device)
        over = torch.arange(kr, device=device)[None, :] >= nums[:, None]
        ids[over] = -1
        scores[over] = 0.0
        return EvalTopK(ids=ids, scores=scores, index=model.item_index)


def engine() -> Engine:
    """EngineFactory (reference RecommendationEngine object)."""
    return Engine(
        datasource_classes=RecommendationDataSource,
        preparator_classes=RecommendationPreparator,
        algorithm_classes={"als": ALSAlgorithm},
        serving_classes=FirstServing,
    )
