"""Workflow drivers: train and persist, and re-hydrate for serving.

Port of ``predictionio_tpu/core/workflow.py`` (reference
CreateWorkflow.scala:136, CoreWorkflow.scala:45-160): ``run_train`` with
the engine-instance lifecycle (INIT -> COMPLETED / FAILED) and model
persistence into MODELDATA, in the JAX package's record layout and model
file format, so either package deploys what the other trained; warm
starts from the latest COMPLETED instance; :func:`save_instance`, which
records already-built models as a COMPLETED instance; and the deploy
path (``prepare_deploy``). Retrain-on-deploy models are refused.
"""

from __future__ import annotations

import json
import logging
import os
import traceback
from datetime import datetime, timezone
from typing import Any, Mapping, Sequence

from predictionio_tpu_torch.core import persistence
from predictionio_tpu_torch.core.context import WorkflowContext
from predictionio_tpu_torch.core.engine import (
    Engine,
    EngineParams,
    StopAfterPrepareInterruption,
    StopAfterReadInterruption,
    WorkflowParams,
)
from predictionio_tpu_torch.data.storage import (
    EngineInstance,
    EngineInstanceStatus,
    Model,
    Storage,
    get_storage,
)

logger = logging.getLogger(__name__)


def _now() -> datetime:
    return datetime.now(tz=timezone.utc)


def _params_json(pair: tuple[str, Any]) -> str:
    name, params = pair
    return json.dumps({"name": name, "params": params.to_dict()}, sort_keys=True)


def _new_instance(
    engine_params: EngineParams,
    engine_id: str,
    engine_version: str,
    engine_variant: str,
    engine_factory: str,
    batch: str = "",
    runtime_conf: Mapping[str, Any] | None = None,
) -> EngineInstance:
    """An INIT engine-instance record, as the JAX package writes it."""
    return EngineInstance(
        id="",
        status=EngineInstanceStatus.INIT,
        start_time=_now(),
        end_time=_now(),
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
        engine_factory=engine_factory,
        batch=batch,
        runtime_conf={k: str(v) for k, v in (runtime_conf or {}).items()},
        datasource_params=_params_json(engine_params.datasource),
        preparator_params=_params_json(engine_params.preparator),
        algorithms_params=json.dumps(
            [
                {"name": name, "params": params.to_dict()}
                for name, params in engine_params.algorithms
            ],
            sort_keys=True,
        ),
        serving_params=_params_json(engine_params.serving),
    )


def run_train(
    engine: Engine,
    engine_params: EngineParams,
    engine_id: str = "default",
    engine_version: str = "0",
    engine_variant: str = "default",
    engine_factory: str = "",
    workflow_params: WorkflowParams | None = None,
    storage: Storage | None = None,
    ctx: WorkflowContext | None = None,
) -> str:
    """Train and persist: the ``train`` driver (CreateWorkflow.main +
    CoreWorkflow.runTrain). Returns the engine instance id; raises on
    failure after marking the instance FAILED. Algorithms train on
    ``ctx.device`` (by default CUDA, raising without it)."""
    storage = storage or get_storage()
    wp = workflow_params or WorkflowParams()
    ctx = ctx or WorkflowContext(
        mode="Training", batch=wp.batch, runtime_conf=wp.runtime_conf,
    )
    instances = storage.get_metadata_engine_instances()
    instance = _new_instance(
        engine_params, engine_id, engine_version, engine_variant,
        engine_factory, batch=wp.batch, runtime_conf=wp.runtime_conf,
    )
    instance_id = instances.insert(instance)
    instance.id = instance_id
    logger.info("engine instance %s created (INIT)", instance_id)

    try:
        algorithms = engine.make_algorithms(engine_params)
        for algo in algorithms:
            algo.device = ctx.device
        if _warm_start_requested(wp):
            prev = _previous_models(
                storage, algorithms, engine_id, engine_version, engine_variant
            )
            if prev is not None:
                ctx.runtime_conf["warm_start_models"] = prev
        models = engine.train(ctx, engine_params, wp, algorithms=algorithms)
        if wp.save_model:
            blob = persistence.serialize_models(algorithms, models, instance_id)
            storage.get_model_data_models().insert(Model(instance_id, blob))
        instance.status = EngineInstanceStatus.COMPLETED
        instance.end_time = _now()
        instances.update(instance)
        logger.info("engine instance %s COMPLETED", instance_id)
        return instance_id
    except (StopAfterReadInterruption, StopAfterPrepareInterruption) as stop:
        # a debug stop asked for by WorkflowParams, not a failure
        # (reference CoreWorkflow.scala:91-97)
        instance.end_time = _now()
        instances.update(instance)
        logger.info("training of %s interrupted by %s", instance_id, type(stop).__name__)
        return instance_id
    except Exception:
        instance.status = EngineInstanceStatus.FAILED
        instance.end_time = _now()
        instances.update(instance)
        logger.error(
            "engine instance %s FAILED:\n%s", instance_id, traceback.format_exc()
        )
        raise


def _warm_start_requested(wp: WorkflowParams) -> bool:
    """``train --warm-start`` sets PIO_WARM_START=1, as the JAX CLI does;
    in-process callers can set ``runtime_conf["warm_start"]`` instead."""
    if wp.runtime_conf.get("warm_start"):
        return True
    env = os.environ.get("PIO_WARM_START", "").strip().lower()
    return env not in ("", "0", "false", "no", "off")


def _previous_models(
    storage: Storage,
    algorithms: list[Any],
    engine_id: str,
    engine_version: str,
    engine_variant: str,
) -> list[Any] | None:
    """Models of the latest COMPLETED instance of this engine identity --
    trained by either package -- aligned with ``algorithms``, for
    warm-start carries. No previous instance, no persisted model or a
    model that does not load degrades to a cold start with a named
    warning; each algorithm checks compatibility (rank, dtype) itself."""
    try:
        instance = storage.get_metadata_engine_instances().get_latest_completed(
            engine_id, engine_version, engine_variant
        )
        if instance is None:
            logger.warning(
                "warm-start: no completed instance for engine %s/%s/%s; "
                "cold start", engine_id, engine_version, engine_variant,
            )
            return None
        models = _load_models(storage, instance, algorithms)
        if models is None:
            logger.warning(
                "warm-start: instance %s has no persisted model; cold start",
                instance.id,
            )
            return None
        logger.info("warm-start: carrying models from instance %s", instance.id)
        return [None if m is persistence.RETRAIN else m for m in models]
    except Exception as e:  # a warm start is an optimization: fall back cold
        logger.warning("warm-start: previous model unavailable (%s); cold start", e)
        return None


def _load_models(storage: Storage, instance: EngineInstance,
                 algorithms: Sequence[Any]) -> list[Any] | None:
    """An instance's persisted models, or None when it has none. A local
    model file maps in place; remote stores fall through to a byte read."""
    model_store = storage.get_model_data_models()
    local = model_store.local_path(instance.id)
    if local is not None:
        models = persistence.deserialize_model_path(local, algorithms, instance.id)
        if models is not None:
            return models
    blob = model_store.get(instance.id)
    if blob is None:
        return None
    return persistence.deserialize_models(blob.models, algorithms, instance.id)


def save_instance(
    engine: Engine,
    engine_params: EngineParams,
    models: Sequence[Any],
    engine_id: str = "default",
    engine_version: str = "0",
    engine_variant: str = "default",
    engine_factory: str = "",
    storage: Storage | None = None,
) -> str:
    """Persist ``models`` (one per algorithm of ``engine_params``) and
    record them as a COMPLETED engine instance, exactly as ``run_train``
    records a finished training. Returns the instance id."""
    storage = storage or get_storage()
    algorithms = engine.make_algorithms(engine_params)
    instance = _new_instance(
        engine_params, engine_id, engine_version, engine_variant, engine_factory
    )
    instances = storage.get_metadata_engine_instances()
    instance_id = instances.insert(instance)
    blob = persistence.serialize_models(algorithms, models, instance_id)
    storage.get_model_data_models().insert(Model(instance_id, blob))
    instance.status = EngineInstanceStatus.COMPLETED
    instance.end_time = _now()
    instances.update(instance)
    logger.info("engine instance %s COMPLETED", instance_id)
    return instance_id


def prepare_deploy(
    engine: Engine,
    instance: EngineInstance,
    storage: Storage | None = None,
    ctx: WorkflowContext | None = None,
) -> tuple[EngineParams, list[Any], list[Any], Any]:
    """Re-hydrate a completed instance for serving
    (CreateServer.createServerActorWithEngine + Engine.prepareDeploy).

    Returns (engine_params, algorithms, models, serving); every algorithm
    scores on ``ctx.device`` (CUDA unless the context says otherwise).
    Models persisted as the ``RETRAIN`` sentinel (an algorithm whose
    ``make_persistent_model`` returned None) are trained here, on the
    same algorithm instances and ``ctx``."""
    storage = storage or get_storage()
    ctx = ctx or WorkflowContext(mode="Serving", batch=instance.batch)
    engine_params = engine_params_from_instance(engine, instance)
    algorithms = engine.make_algorithms(engine_params)
    for algo in algorithms:
        algo.device = ctx.device
    serving = engine.make_serving(engine_params)

    models = _load_models(storage, instance, algorithms)
    if models is None:
        raise RuntimeError(
            f"no persisted model for engine instance {instance.id}; "
            "was it trained with save_model=False?"
        )
    if any(m is persistence.RETRAIN for m in models):
        logger.info("instance %s has retrain-on-deploy models; training", instance.id)
        retrained = engine.train(ctx, engine_params, algorithms=algorithms)
        models = [
            retrained[i] if m is persistence.RETRAIN else m
            for i, m in enumerate(models)
        ]
    return engine_params, algorithms, models, serving


def engine_params_from_instance(
    engine: Engine, instance: EngineInstance
) -> EngineParams:
    """Instance params-JSON -> EngineParams
    (reference Engine.engineInstanceToEngineParams, Engine.scala:422-498)."""
    variant: dict[str, Any] = {}
    ds = json.loads(instance.datasource_params or "{}")
    prep = json.loads(instance.preparator_params or "{}")
    algos = json.loads(instance.algorithms_params or "[]")
    serv = json.loads(instance.serving_params or "{}")
    if ds:
        variant["datasource"] = ds
    if prep:
        variant["preparator"] = prep
    if algos:
        variant["algorithms"] = algos
    if serv:
        variant["serving"] = serv
    return engine.params_from_variant(variant)


def load_variant(path: str) -> dict[str, Any]:
    """Read an engine variant JSON file (engine.json analog)."""
    with open(path) as f:
        return json.load(f)


def variant_engine_params(engine: Engine, variant: Mapping[str, Any]) -> EngineParams:
    return engine.params_from_variant(variant)
