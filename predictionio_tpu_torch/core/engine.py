"""Engine: chains DASE components; train/eval orchestration.

Port of ``predictionio_tpu/core/engine.py``: component registries keyed
by name, instantiation, ``train`` = read -> sanity-check -> prepare ->
per-algorithm train (Engine.scala:625-729), ``eval`` = per-eval-set
train + batch-predict + serving join (Engine.scala:730-820) and
``batch_eval`` over candidates, engine-params extraction from a variant
(jValueToEngineParams, Engine.scala:357-420), and engine factory
resolution.
"""

from __future__ import annotations

import importlib
import logging
from dataclasses import dataclass, field
from typing import Any, Generic, Mapping, Sequence, TypeVar

from predictionio_tpu_torch.core.base import (
    Algorithm,
    DataSource,
    Preparator,
    SanityCheck,
    Serving,
    doer,
)
from predictionio_tpu_torch.core.context import WorkflowContext
from predictionio_tpu_torch.core.params import EngineParams, Params

logger = logging.getLogger(__name__)

TD = TypeVar("TD")
PD = TypeVar("PD")
Q = TypeVar("Q")
P = TypeVar("P")
A = TypeVar("A")

@dataclass
class WorkflowParams:
    """Train run options (reference workflow/WorkflowParams.scala), the
    JAX package's fields. ``profile_dir`` (a JAX profiler trace) and
    ``mesh_axes`` (a device mesh) have no counterpart on one card yet:
    setting either raises."""

    batch: str = ""
    verbose: int = 0
    save_model: bool = True
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    runtime_conf: dict[str, Any] = field(default_factory=dict)
    profile_dir: str | None = None
    mesh_axes: list[tuple[str, int]] | None = None

    def __post_init__(self):
        if self.profile_dir:
            raise NotImplementedError(
                "WorkflowParams.profile_dir: training traces are a later "
                "slice of the PyTorch port"
            )
        if self.mesh_axes:
            raise NotImplementedError(
                "WorkflowParams.mesh_axes: device meshes are the multi-GPU "
                "slice of the PyTorch port"
            )


class StopAfterReadInterruption(Exception):
    pass


class StopAfterPrepareInterruption(Exception):
    pass


def _sanity(obj: Any, what: str, skip: bool) -> None:
    if skip:
        return
    if isinstance(obj, SanityCheck):
        logger.info("%s: sanity check starting", what)
        obj.sanity_check()
        logger.info("%s: sanity check passed", what)


_PORT = "predictionio_tpu_torch"
_JAX_PACKAGE = "predictionio_tpu"
#: the factory a deploy uses when neither the variant nor the instance names one
DEFAULT_ENGINE_FACTORY = f"{_PORT}.models.recommendation.engine"


class Engine(Generic[TD, PD, Q, P, A]):
    """An engine: named component classes for each DASE slot
    (``Engine(dataSourceClassMap, preparatorClassMap, algorithmClassMap,
    servingClassMap)``, Engine.scala:83-130), with ``""`` naming the
    single class of a slot."""

    def __init__(
        self,
        datasource_classes: type | Mapping[str, type],
        preparator_classes: type | Mapping[str, type],
        algorithm_classes: type | Mapping[str, type],
        serving_classes: type | Mapping[str, type],
    ):
        self.datasource_classes = _as_map(datasource_classes)
        self.preparator_classes = _as_map(preparator_classes)
        self.algorithm_classes = _as_map(algorithm_classes)
        self.serving_classes = _as_map(serving_classes)

    def _make(self, registry: Mapping[str, type], slot: str, name: str, params: Params):
        if name not in registry:
            raise KeyError(
                f"{slot} named '{name}' is not registered on this engine "
                f"(available: {sorted(registry)})"
            )
        return doer(registry[name], params)

    def make_datasource(self, ep: EngineParams) -> DataSource:
        return self._make(self.datasource_classes, "datasource", *ep.datasource)

    def make_preparator(self, ep: EngineParams) -> Preparator:
        return self._make(self.preparator_classes, "preparator", *ep.preparator)

    def make_algorithms(self, ep: EngineParams) -> list[Algorithm]:
        return [
            self._make(self.algorithm_classes, "algorithm", name, params)
            for name, params in ep.algorithms
        ]

    def make_serving(self, ep: EngineParams) -> Serving:
        return self._make(self.serving_classes, "serving", *ep.serving)

    def train(
        self,
        ctx: WorkflowContext,
        engine_params: EngineParams,
        workflow_params: WorkflowParams | None = None,
        algorithms: Sequence[Algorithm] | None = None,
    ) -> list[Any]:
        """Train all algorithms (object Engine.train, Engine.scala:625-729).
        Pass ``algorithms`` to reuse instances: the persistence path must
        serialize models through the instances that trained them. Each
        algorithm trains on its ``device``, else on ``ctx.device``."""
        wp = workflow_params or WorkflowParams()
        datasource = self.make_datasource(engine_params)
        preparator = self.make_preparator(engine_params)
        if algorithms is None:
            algorithms = self.make_algorithms(engine_params)
        if not algorithms:
            raise ValueError("engine has no algorithms configured")

        td = datasource.read_training(ctx)
        _sanity(td, "TrainingData", wp.skip_sanity_check)
        if wp.stop_after_read:
            raise StopAfterReadInterruption()

        pd = preparator.prepare(ctx, td)
        _sanity(pd, "PreparedData", wp.skip_sanity_check)
        if wp.stop_after_prepare:
            raise StopAfterPrepareInterruption()

        # warm starts ride runtime_conf: the workflow driver resolves the
        # previous instance's models into "warm_start_models" (aligned
        # with the algorithms) and each algorithm sees its own slot
        warm = ctx.runtime_conf.get("warm_start_models")
        models = []
        for i, algo in enumerate(algorithms):
            if warm is not None:
                ctx.runtime_conf["warm_start_model"] = (
                    warm[i] if i < len(warm) else None
                )
            models.append(algo.train(ctx, pd))
        ctx.runtime_conf.pop("warm_start_model", None)
        for i, m in enumerate(models):
            _sanity(m, f"Model {i}", wp.skip_sanity_check)
        return models

    def eval(
        self,
        ctx: WorkflowContext,
        engine_params: EngineParams,
        workflow_params: WorkflowParams | None = None,
    ) -> list[tuple[Any, list[tuple[Q, P, A]]]]:
        """For each eval set from the datasource: train on its TD, score
        its (Q, A) pairs through all algorithms + serving (object
        Engine.eval, Engine.scala:730-820). Returns
        [(eval_info, [(query, prediction, actual)])]."""
        wp = workflow_params or WorkflowParams()
        datasource = self.make_datasource(engine_params)
        preparator = self.make_preparator(engine_params)
        serving = self.make_serving(engine_params)

        results = []
        for td, eval_info, qa_pairs in datasource.read_eval(ctx):
            _sanity(td, "TrainingData(eval)", wp.skip_sanity_check)
            pd = preparator.prepare(ctx, td)
            algorithms = self.make_algorithms(engine_params)
            for algo in algorithms:  # each scores on the run's device
                algo.device = ctx.device
            models = [algo.train(ctx, pd) for algo in algorithms]

            indexed_queries = [
                (ix, serving.supplement(q)) for ix, (q, _) in enumerate(qa_pairs)
            ]
            # per-algorithm batch predict, then join on query index --
            # the union->groupByKey->sort-by-algo join of Engine.scala:783-814
            per_algo: list[dict[int, Any]] = []
            for algo, model in zip(algorithms, models):
                per_algo.append(dict(algo.batch_predict(model, indexed_queries)))
            served = []
            for ix, (q, a) in enumerate(qa_pairs):
                predictions = [pa[ix] for pa in per_algo]
                served.append((q, serving.serve(q, predictions), a))
            results.append((eval_info, served))
        return results

    def batch_eval(
        self,
        ctx: WorkflowContext,
        engine_params_list: Sequence[EngineParams],
        workflow_params: WorkflowParams | None = None,
    ) -> list[tuple[EngineParams, list[tuple[Any, list[tuple[Q, P, A]]]]]]:
        """Every candidate through :meth:`eval` (BaseEngine.batchEval)."""
        return [
            (ep, self.eval(ctx, ep, workflow_params)) for ep in engine_params_list
        ]

    def params_from_variant(self, variant: Mapping[str, Any]) -> EngineParams:
        def one(slot: str, registry: Mapping[str, type]) -> tuple[str, Params]:
            spec = variant.get(slot)
            if spec is None:
                name = "" if "" in registry else next(iter(sorted(registry)), "")
                cls = registry.get(name)
                params_cls = getattr(cls, "params_class", None)
                return (name, params_cls() if params_cls else Params())
            name, raw = _split_spec(spec)
            if name not in registry:
                raise KeyError(
                    f"variant references unknown {slot} '{name}' "
                    f"(available: {sorted(registry)})"
                )
            params_cls = getattr(registry[name], "params_class", Params)
            return (name, params_cls.from_dict(raw))

        algo_specs = variant.get("algorithms")
        if algo_specs is None:
            algorithms = [one("algorithms", self.algorithm_classes)]
        else:
            algorithms = []
            for spec in algo_specs:
                name, raw = _split_spec(spec)
                if name not in self.algorithm_classes:
                    raise KeyError(
                        f"variant references unknown algorithm '{name}' "
                        f"(available: {sorted(self.algorithm_classes)})"
                    )
                params_cls = getattr(self.algorithm_classes[name], "params_class", Params)
                algorithms.append((name, params_cls.from_dict(raw)))

        return EngineParams(
            datasource=one("datasource", self.datasource_classes),
            preparator=one("preparator", self.preparator_classes),
            algorithms=algorithms,
            serving=one("serving", self.serving_classes),
        )


def _as_map(classes: type | Mapping[str, type]) -> dict[str, type]:
    if isinstance(classes, Mapping):
        return dict(classes)
    return {"": classes}


def _split_spec(spec: Mapping[str, Any]) -> tuple[str, Mapping[str, Any]]:
    """Accept {"name": n, "params": {...}} or bare params {...}: a dict is
    the wrapper form only when its keys are a subset of {name, params}."""
    if spec and set(spec.keys()) <= {"name", "params"}:
        return spec.get("name", ""), spec.get("params", {}) or {}
    return "", spec


class EngineFactory:
    """User entry object: ``apply()`` returns the Engine
    (reference controller/EngineFactory.scala)."""

    def apply(self) -> Engine:
        raise NotImplementedError


def port_factory_name(dotted_name: str) -> str:
    """A recorded factory name -> the port's: ``predictionio_tpu.<path>``
    becomes ``predictionio_tpu_torch.<path>``; port names stay."""
    if dotted_name.startswith(_JAX_PACKAGE + "."):
        return _PORT + dotted_name[len(_JAX_PACKAGE):]
    return dotted_name


def resolve_engine_factory(dotted_name: str) -> Engine:
    """Import-by-name engine discovery (reference WorkflowUtils.getEngine),
    restricted to the port: the name is mapped by :func:`port_factory_name`
    and must then lie in ``predictionio_tpu_torch``. Accepts a
    module-level Engine, a zero-arg callable returning one, or an
    EngineFactory class/instance."""
    name = port_factory_name(dotted_name)
    module_name, _, attr = name.rpartition(".")
    if not module_name:
        raise ValueError(f"engine factory {dotted_name!r} is not a dotted path")
    if module_name != _PORT and not module_name.startswith(_PORT + "."):
        raise ValueError(
            f"engine factory {dotted_name!r} is outside the PyTorch port "
            f"({_PORT})"
        )
    try:
        obj = getattr(importlib.import_module(module_name), attr)
    except (ImportError, AttributeError) as e:
        raise ValueError(
            f"engine factory {dotted_name!r} is not ported yet ({name}: {e})"
        ) from e
    if isinstance(obj, Engine):
        return obj
    if isinstance(obj, type):
        obj = obj()
    if isinstance(obj, EngineFactory):
        return obj.apply()
    if callable(obj):
        result = obj()
        if isinstance(result, Engine):
            return result
    raise TypeError(f"{name} did not yield an Engine")
