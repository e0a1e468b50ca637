"""FastEvalEngine: prefix-memoizing evaluation over parameter sweeps.

Capability parity with the reference FastEvalEngine
(core/.../controller/FastEvalEngine.scala:46-346): during a sweep, many
candidates share pipeline prefixes (same datasource params -> same eval
sets; same +preparator -> same prepared data; same +algorithms -> same
models and batch predictions). The workflow caches each prefix so shared
stages compute once across candidates.

Cache keys mirror the reference's DataSourcePrefix / PreparatorPrefix /
AlgorithmsPrefix / ServingPrefix (:46-160), keyed on params JSON.

Port of ``predictionio_tpu/core/fast_eval.py``. On the port every
algorithm of the workflow runs on the context's device (``ctx.device``).
The device fast path scores a candidate with one batched top-k per eval
split (``Algorithm.eval_topk``; the recommendation template's runs on
K2's launches) and reduces P@K / MAP@K / NDCG@K with K3
(``ops/topk.py ranking_metrics_batch``, kernel ``csrc/ranking.cu``);
stacked candidate trainings go through ``Algorithm.train_sweep`` (K1s).
``jit_compiles`` counts the kernel builds the sweep triggered
(``kernels/_build.py``, as ``obs/device.py compile_snapshot`` sees them).
"""

from __future__ import annotations

import json
import logging
import time
from contextlib import contextmanager
from typing import Any, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.obs import device as obs_device

from predictionio_tpu_torch.core.base import Algorithm, FirstServing
from predictionio_tpu_torch.core.context import WorkflowContext
from predictionio_tpu_torch.core.engine import Engine, WorkflowParams
from predictionio_tpu_torch.core.metrics import Metric
from predictionio_tpu_torch.core.params import EngineParams, Params
from predictionio_tpu_torch.core.ranking import encode_actuals

logger = logging.getLogger(__name__)


def _key(*pairs: tuple[str, Params]) -> str:
    return json.dumps(
        [[name, params.to_dict()] for name, params in pairs], sort_keys=True
    )


class FastEvalEngineWorkflow:
    """Holds the prefix caches for one sweep (reference
    FastEvalEngineWorkflow, :46-310)."""

    def __init__(self, engine: Engine, ctx: WorkflowContext):
        self.engine = engine
        self.ctx = ctx
        self.datasource_cache: dict[str, Any] = {}
        self.preparator_cache: dict[str, Any] = {}
        self.models_cache: dict[str, Any] = {}
        self.algorithms_cache: dict[str, Any] = {}
        # device fast path caches: per-candidate padded [Q, K] top-k
        # matrices, and per eval split the encoded actual-id rows (shared
        # across every candidate whose model exposes the same id space)
        self.topk_cache: dict[str, list] = {}
        self.actuals_cache: dict[tuple[str, int], tuple[Any, torch.Tensor, torch.Tensor]] = {}
        self.hits = {"datasource": 0, "preparator": 0, "algorithms": 0, "topk": 0}
        self.misses = {"datasource": 0, "preparator": 0, "algorithms": 0, "topk": 0}
        self.swept_candidates = 0  # candidates trained via stacked sweeps
        self.jit_compiles = 0  # kernel builds this sweep (set by batch_eval)
        self.fast_path_candidates = 0  # candidates scored via eval_device
        self.phase_seconds = {"train": 0.0, "predict": 0.0, "metric": 0.0}
        self._active_phases: set[str] = set()

    @contextmanager
    def _phase(self, name: str):
        """Accumulate wall time into the per-phase eval report counters.

        Reentrant per name (an outer section swallows inner sections of
        the same phase), so helpers can time their own work without the
        caller knowing; callers must not nest DIFFERENT phase names."""
        if name in self._active_phases:
            yield
            return
        self._active_phases.add(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._active_phases.discard(name)
            self.phase_seconds[name] = (
                self.phase_seconds.get(name, 0.0) + time.perf_counter() - t0
            )

    def _algorithms(self, ep: EngineParams) -> list[Algorithm]:
        """The candidate's algorithms, each on the run's device."""
        algorithms = self.engine.make_algorithms(ep)
        for a in algorithms:
            a.device = self.ctx.device
        return algorithms

    def _eval_sets(self, ep: EngineParams):
        key = _key(ep.datasource)
        if key not in self.datasource_cache:
            self.misses["datasource"] += 1
            datasource = self.engine.make_datasource(ep)
            with self._phase("train"):
                self.datasource_cache[key] = datasource.read_eval(self.ctx)
        else:
            self.hits["datasource"] += 1
        return key, self.datasource_cache[key]

    def _prepared(self, ep: EngineParams):
        ds_key, eval_sets = self._eval_sets(ep)
        key = ds_key + "|" + _key(ep.preparator)
        if key not in self.preparator_cache:
            self.misses["preparator"] += 1
            preparator = self.engine.make_preparator(ep)
            with self._phase("train"):
                self.preparator_cache[key] = [
                    (preparator.prepare(self.ctx, td), info, qa)
                    for td, info, qa in eval_sets
                ]
        else:
            self.hits["preparator"] += 1
        return key, self.preparator_cache[key]

    def _models(self, ep: EngineParams, prep_key: str, prepared_sets):
        """Per eval set: the trained model per algorithm. A separate cache
        stage from predictions so ``prewarm_sweeps`` can fill it with
        stacked trainings (K1s) before candidates are walked serially."""
        key = prep_key + "|" + _key(*ep.algorithms)
        if key not in self.models_cache:
            with self._phase("train"):
                self.models_cache[key] = [
                    [
                        a.train(self.ctx, pd)
                        for a in self._algorithms(ep)
                    ]
                    for pd, _info, _qa in prepared_sets
                ]
        return self.models_cache[key]

    def prewarm_sweeps(self, engine_params_list: Sequence[EngineParams]) -> None:
        """Stack candidate trainings where the algorithm supports it.

        Groups candidates sharing the datasource+preparator prefix and a
        single-algorithm slot of the same component name, then offers the
        whole group's params to ``Algorithm.train_sweep`` (the stacking
        hook -- see ops/als.py als_train_sweep, K1s). Supported groups land
        in the models cache from one stacked training; unsupported ones
        fall back to serial ``train`` calls. The reference has no analog:
        batchEval runs candidates serially
        (core/.../core/BaseEngine.scala:61-70). A failure inside
        ``train_sweep`` (a kernel build or launch) raises.
        """
        groups: dict[tuple[str, str], list[EngineParams]] = {}
        for ep in engine_params_list:
            if len(ep.algorithms) != 1:
                continue
            prefix = _key(ep.datasource) + "|" + _key(ep.preparator)
            groups.setdefault((prefix, ep.algorithms[0][0]), []).append(ep)
        for (_prefix, _name), eps in groups.items():
            # distinct algorithm params only; singletons gain nothing
            seen: dict[str, EngineParams] = {}
            for ep in eps:
                seen.setdefault(_key(*ep.algorithms), ep)
            distinct = list(seen.values())
            if len(distinct) < 2:
                continue
            prep_key, prepared_sets = self._prepared(distinct[0])
            algo = self._algorithms(distinct[0])[0]
            params_list = [ep.algorithms[0][1] for ep in distinct]
            per_set_models = []
            for pd, _info, _qa in prepared_sets:
                with self._phase("train"):
                    models = algo.train_sweep(self.ctx, pd, params_list)
                if models is None:
                    per_set_models = None
                    break
                per_set_models.append(models)
            if per_set_models is None:
                continue
            for ci, ep in enumerate(distinct):
                key = prep_key + "|" + _key(*ep.algorithms)
                self.models_cache[key] = [
                    [set_models[ci]] for set_models in per_set_models
                ]
            self.swept_candidates += len(distinct)

    def _predictions(self, ep: EngineParams):
        """Per eval set: list over algorithms of {query_ix: prediction}."""
        prep_key, prepared_sets = self._prepared(ep)
        key = prep_key + "|" + _key(*ep.algorithms)
        if key not in self.algorithms_cache:
            self.misses["algorithms"] += 1
            algorithms = self._algorithms(ep)
            per_set_models = self._models(ep, prep_key, prepared_sets)
            per_set = []
            with self._phase("predict"):
                for (pd, info, qa), models in zip(prepared_sets, per_set_models):
                    indexed = list(enumerate(q for q, _ in qa))
                    per_algo = [
                        dict(a.batch_predict(m, indexed))
                        for a, m in zip(algorithms, models)
                    ]
                    per_set.append((per_algo, info, qa))
            self.algorithms_cache[key] = per_set
            # the factor models were consumed into (small) predictions;
            # dropping them bounds sweep memory at O(1) models instead of
            # O(candidates x folds)
            self.models_cache.pop(key, None)
        else:
            self.hits["algorithms"] += 1
        return self.algorithms_cache[key]

    def eval(self, ep: EngineParams):
        serving = self.engine.make_serving(ep)
        results = []
        predictions = self._predictions(ep)
        with self._phase("predict"):
            for per_algo, info, qa in predictions:
                served = [
                    (q, serving.serve(q, [pa[ix] for pa in per_algo]), a)
                    for ix, (q, a) in enumerate(qa)
                ]
                results.append((info, served))
        return results

    # -- device-resident fast path -----------------------------------------

    def _encoded_actuals(self, prep_key: str, set_i: int, qa, index):
        """Padded sorted actual-id rows for one eval split on the run's
        device, encoded once and reused across every candidate sharing
        the id space."""
        cache_key = (prep_key, set_i)
        cached = self.actuals_cache.get(cache_key)
        if cached is not None:
            tok, enc, counts = cached
            if tok is index or tok == index:
                return enc, counts
        enc, counts = encode_actuals([a for _, a in qa], index)
        enc = torch.from_numpy(enc).to(self.ctx.device)
        counts = torch.from_numpy(counts).to(self.ctx.device)
        self.actuals_cache[cache_key] = (index, enc, counts)
        return enc, counts

    def eval_device(self, ep: EngineParams, metrics: Sequence[Metric]):
        """Score one candidate fully on device, or None to signal the
        caller to fall back to the per-query ``eval`` path.

        Fallback gates (any miss -> None): every metric advertises a
        DeviceRankingSpec (custom Metric subclasses don't); serving is
        exactly FirstServing (a custom Serving may transform or combine
        predictions the fast path never materializes); the first
        algorithm implements ``eval_topk``. When all gates pass, the
        candidate's predictions stay on device as ONE padded [Q, K]
        top-k matrix per eval split and PrecisionAtK / MAPAtK / NDCGAtK
        reduce in K3 -- no per-query Python at all. Past the gates a
        failure (a kernel build or launch) raises.

        Returns one score per metric, in order.
        """
        from predictionio_tpu_torch.ops import topk as topk_ops

        specs = [m.device_spec() for m in metrics]
        if not specs or any(s is None for s in specs):
            return None
        serving = self.engine.make_serving(ep)
        if type(serving) is not FirstServing:
            return None
        algorithms = self._algorithms(ep)
        if not algorithms:
            return None
        algo = algorithms[0]
        if type(algo).eval_topk is Algorithm.eval_topk:
            return None

        k_max = max(s.k for s in specs)
        prep_key, prepared_sets = self._prepared(ep)
        algo_key = prep_key + "|" + _key(*ep.algorithms)
        key = algo_key + f"|k={k_max}"
        per_set = self.topk_cache.get(key)
        if per_set is None:
            self.misses["topk"] += 1
            per_set_models = self._models(ep, prep_key, prepared_sets)
            per_set = []
            with self._phase("predict"):
                for (_pd, _info, qa), models in zip(prepared_sets, per_set_models):
                    topk = algo.eval_topk(models[0], [q for q, _ in qa], k_max)
                    if topk is None:
                        return None
                    per_set.append(topk)
            self.topk_cache[key] = per_set
            # factor models were consumed into (small) top-k matrices;
            # dropping them bounds sweep memory like _predictions does
            self.models_cache.pop(algo_key, None)
        else:
            self.hits["topk"] += 1

        with self._phase("metric"):
            sums = np.zeros(len(specs), dtype=np.float64)
            counts = np.zeros(len(specs), dtype=np.int64)
            for set_i, ((_pd, _info, qa), topk) in enumerate(
                zip(prepared_sets, per_set)
            ):
                enc, n_actual = self._encoded_actuals(
                    prep_key, set_i, qa, topk.index
                )
                pred_ids = torch.as_tensor(topk.ids, device=self.ctx.device)
                by_k: dict[int, list[np.ndarray]] = {}
                for mi, spec in enumerate(specs):
                    res = by_k.get(spec.k)
                    if res is None:
                        res = [
                            r.cpu().numpy()
                            for r in topk_ops.ranking_metrics_batch(
                                pred_ids[:, : spec.k].contiguous(), enc, n_actual,
                                k=spec.k,
                            )
                        ]
                        by_k[spec.k] = res
                    precision, ap, ndcg, valid = res
                    arr = {"precision": precision, "ap": ap, "ndcg": ndcg}[
                        spec.kernel
                    ]
                    sums[mi] += float(arr[valid].sum(dtype=np.float64))
                    counts[mi] += int(valid.sum())
        self.fast_path_candidates += 1
        return [
            float(sums[i] / counts[i]) if counts[i] else float("nan")
            for i in range(len(specs))
        ]


class FastEvalEngine(Engine):
    """Engine whose batch_eval memoizes shared prefixes
    (reference FastEvalEngine :313-346). Train/deploy behavior is
    unchanged; only evaluation uses the caches."""

    def batch_eval(
        self,
        ctx: WorkflowContext,
        engine_params_list: Sequence[EngineParams],
        workflow_params: WorkflowParams | None = None,
    ):
        workflow = FastEvalEngineWorkflow(self, ctx)
        jit_before = obs_device.compile_snapshot()
        workflow.prewarm_sweeps(engine_params_list)
        out = [(ep, workflow.eval(ep)) for ep in engine_params_list]
        # kernel sources are built once, at first use (kernels/_build.py):
        # a per-sweep build delta says whether this sweep paid for a build
        jit_after = obs_device.compile_snapshot()
        workflow.jit_compiles = sum(
            s["compiles"] for s in jit_after.values()
        ) - sum(s["compiles"] for s in jit_before.values())
        logger.info(
            "FastEvalEngine cache hits=%s misses=%s swept=%d jit_compiles=%d",
            workflow.hits,
            workflow.misses,
            workflow.swept_candidates,
            workflow.jit_compiles,
        )
        return out
