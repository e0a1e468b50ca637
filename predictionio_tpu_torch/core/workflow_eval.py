"""Evaluation workflow: the `pio eval` runtime.

Capability parity with the reference evaluation workflow
(core/.../workflow/CoreWorkflow.runEvaluation:103-160,
EvaluationWorkflow.scala, CreateWorkflow evaluation branch :263-277):
EvaluationInstance lifecycle INIT -> EVALCOMPLETED with the one-liner /
HTML / JSON result views persisted for the dashboard.

Port of ``predictionio_tpu/core/workflow_eval.py``: the evaluation runs
on ``ctx.device`` (CUDA unless the caller's context says otherwise).
"""

from __future__ import annotations

import importlib
import logging
import traceback
from datetime import datetime, timezone
from typing import Any

from predictionio_tpu_torch.core.context import WorkflowContext
from predictionio_tpu_torch.core.engine import WorkflowParams
from predictionio_tpu_torch.core.evaluation import Evaluation, MetricEvaluatorResult
from predictionio_tpu_torch.core.params import EngineParamsGenerator
from predictionio_tpu_torch.data.storage import (
    EvaluationInstance,
    EvaluationInstanceStatus,
    Storage,
    get_storage,
)

logger = logging.getLogger(__name__)


def _now() -> datetime:
    return datetime.now(tz=timezone.utc)


def _resolve(obj_or_name: Any, expected: type) -> Any:
    """Dotted-name or instance -> instance (WorkflowUtils.getEvaluation /
    getEngineParamsGenerator analogs, workflow/WorkflowUtils.scala:72-120)."""
    if isinstance(obj_or_name, expected):
        return obj_or_name
    if isinstance(obj_or_name, str):
        module_name, _, attr = obj_or_name.rpartition(".")
        if not module_name:
            raise ValueError(f"{obj_or_name!r} is not a dotted path")
        obj = getattr(importlib.import_module(module_name), attr)
        if isinstance(obj, type):
            obj = obj()
        if callable(obj) and not isinstance(obj, expected):
            obj = obj()
        if isinstance(obj, expected):
            return obj
    raise TypeError(f"cannot resolve {obj_or_name!r} to {expected.__name__}")


def run_evaluation(
    evaluation_class: Any,
    engine_params_generator_class: Any = None,
    batch: str = "",
    workflow_params: WorkflowParams | None = None,
    storage: Storage | None = None,
    ctx: WorkflowContext | None = None,
) -> tuple[str, MetricEvaluatorResult]:
    """Run a full evaluation sweep; returns (instance id, result)."""
    storage = storage or get_storage()
    wp = workflow_params or WorkflowParams(batch=batch)
    ctx = ctx or WorkflowContext(mode="Evaluation", batch=batch)

    evaluation = _resolve(evaluation_class, Evaluation)
    generator = None
    if engine_params_generator_class is not None:
        generator = _resolve(engine_params_generator_class, EngineParamsGenerator)

    instances = storage.get_metadata_evaluation_instances()
    instance = EvaluationInstance(
        id="",
        status=EvaluationInstanceStatus.INIT,
        start_time=_now(),
        end_time=_now(),
        evaluation_class=str(evaluation_class),
        engine_params_generator_class=str(engine_params_generator_class or ""),
        batch=batch,
    )
    instance_id = instances.insert(instance)
    # adopt the generated id locally: remote backends (http) can't mutate
    # our copy server-side, and the later update() keys on instance.id
    instance.id = instance_id

    try:
        params_list = generator.engine_params_list if generator else None
        result = evaluation.run(ctx, params_list, wp)
        instance.status = EvaluationInstanceStatus.EVALCOMPLETED
        instance.end_time = _now()
        # no-save results (FakeWorkflow) complete the instance without
        # persisting result views (reference CoreWorkflow noSave handling)
        if not getattr(result, "no_save", False):
            instance.evaluator_results = result.to_one_liner()
            instance.evaluator_results_html = result.to_html()
            instance.evaluator_results_json = result.to_json()
        instances.update(instance)
        logger.info(
            "evaluation instance %s EVALCOMPLETED "
            "(fast-path candidates=%d, phase seconds=%s)",
            instance_id,
            getattr(result, "fast_path_candidates", 0),
            {
                k: round(v, 3)
                for k, v in getattr(result, "phase_seconds", {}).items()
            },
        )
        return instance_id, result
    except Exception:
        instance.status = EvaluationInstanceStatus.FAILED
        instance.end_time = _now()
        instances.update(instance)
        logger.error("evaluation %s FAILED:\n%s", instance_id, traceback.format_exc())
        raise
