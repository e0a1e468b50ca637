"""Workflow: re-hydrate an engine instance for serving.

Port of the deploy half of ``predictionio_tpu/core/workflow.py``
(prepare_deploy, engine_params_from_instance, load_variant,
variant_engine_params) plus :func:`save_instance`, the persistence half
of ``run_train``: it records already-built models as a COMPLETED engine
instance in the same storage layout, so the port can publish models
before it can train them. ``run_train`` itself is the next slice.
"""

from __future__ import annotations

import json
import logging
from datetime import datetime, timezone
from typing import Any, Mapping, Sequence

from predictionio_tpu_torch.core import persistence
from predictionio_tpu_torch.core.context import WorkflowContext
from predictionio_tpu_torch.core.engine import Engine, EngineParams
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
    record them as a COMPLETED engine instance, exactly as the JAX
    package's ``run_train`` records a finished training. Returns the
    instance id."""
    storage = storage or get_storage()
    algorithms = engine.make_algorithms(engine_params)
    instance = EngineInstance(
        id="",
        status=EngineInstanceStatus.INIT,
        start_time=_now(),
        end_time=_now(),
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
        engine_factory=engine_factory,
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
    Retrain-on-deploy models need the training slice and raise."""
    storage = storage or get_storage()
    ctx = ctx or WorkflowContext(mode="Serving", batch=instance.batch)
    engine_params = engine_params_from_instance(engine, instance)
    algorithms = engine.make_algorithms(engine_params)
    for algo in algorithms:
        algo.device = ctx.device
    serving = engine.make_serving(engine_params)

    # zero-copy path: a local model file maps in place; remote stores
    # fall through to the byte read
    model_store = storage.get_model_data_models()
    models = None
    local = model_store.local_path(instance.id)
    if local is not None:
        models = persistence.deserialize_model_path(
            local, algorithms, instance.id
        )
    if models is None:
        blob = model_store.get(instance.id)
        if blob is None:
            raise RuntimeError(
                f"no persisted model for engine instance {instance.id}; "
                "was it trained with save_model=False?"
            )
        models = persistence.deserialize_models(
            blob.models, algorithms, instance.id
        )
    if any(m is persistence.RETRAIN for m in models):
        raise NotImplementedError(
            f"instance {instance.id} has retrain-on-deploy models; training "
            "is the next slice of the PyTorch port"
        )
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
