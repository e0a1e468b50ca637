"""MetricEvaluator + Evaluation: tuning sweeps over EngineParams.

Capability parity with the reference evaluation layer
(core/.../controller/MetricEvaluator.scala:64-263, Evaluation.scala,
EngineParamsGenerator.scala): score every candidate EngineParams with a
primary metric (+ optional side metrics), pick the best by the metric's
ordering, optionally write ``best.json`` with the winning params, and
render one-liner / HTML / JSON result views persisted on the
EvaluationInstance.

Port of ``predictionio_tpu/core/evaluation.py``. The device fast path's
gate swallows errors of the type checks only (``make_serving`` /
``make_algorithms``); the stacked trainings (``prewarm_sweeps``) and
every kernel launch after it raise.
"""

from __future__ import annotations

import html as html_mod
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Sequence

from predictionio_tpu_torch.core.context import WorkflowContext
from predictionio_tpu_torch.core.engine import Engine, WorkflowParams
from predictionio_tpu_torch.core.metrics import Metric
from predictionio_tpu_torch.core.params import EngineParams, EngineParamsGenerator

logger = logging.getLogger(__name__)


@dataclass
class MetricScores:
    score: float
    other_scores: list[float] = field(default_factory=list)


@dataclass
class MetricEvaluatorResult:
    best_score: MetricScores
    best_engine_params: EngineParams
    best_idx: int
    metric_header: str
    other_metric_headers: list[str]
    engine_params_scores: list[tuple[EngineParams, MetricScores]]
    # eval report extras: per-phase wall time (train / predict / metric,
    # plus "serial" for candidates that ran the classic engine.eval
    # path), sweep cache hit/miss counters, and how many candidates the
    # device fast path scored (core/fast_eval.py eval_device)
    phase_seconds: dict[str, float] = field(default_factory=dict)
    cache_stats: dict[str, dict[str, int]] = field(default_factory=dict)
    fast_path_candidates: int = 0

    def to_one_liner(self) -> str:
        return f"[{self.best_score.score:.4f}] {self.metric_header}"

    def to_json(self) -> str:
        return json.dumps(
            {
                "bestScore": self.best_score.score,
                "bestIndex": self.best_idx,
                "metricHeader": self.metric_header,
                "otherMetricHeaders": self.other_metric_headers,
                "bestEngineParams": self.best_engine_params.to_jsonable(),
                "scores": [
                    {
                        "engineParams": ep.to_jsonable(),
                        "score": ms.score,
                        "otherScores": ms.other_scores,
                    }
                    for ep, ms in self.engine_params_scores
                ],
                "phaseSeconds": self.phase_seconds,
                "cacheStats": self.cache_stats,
                "fastPathCandidates": self.fast_path_candidates,
            },
            sort_keys=True,
        )

    def to_html(self) -> str:
        rows = "".join(
            f"<tr><td>{i}</td><td>{ms.score:.6f}</td>"
            f"<td>{[round(s, 6) for s in ms.other_scores]}</td>"
            f"<td><pre>{html_mod.escape(json.dumps(ep.to_jsonable(), indent=2))}"
            f"</pre></td></tr>"
            for i, (ep, ms) in enumerate(self.engine_params_scores)
        )
        return (
            f"<html><body><h1>Evaluation: {html_mod.escape(self.metric_header)}</h1>"
            f"<p>Best score: {self.best_score.score:.6f} "
            f"(candidate #{self.best_idx})</p>"
            f"<table border='1'><tr><th>#</th><th>{self.metric_header}</th>"
            f"<th>{self.other_metric_headers}</th><th>Params</th></tr>"
            f"{rows}</table></body></html>"
        )


class MetricEvaluator:
    """Evaluates each candidate and selects the best
    (MetricEvaluator.evaluateBase, MetricEvaluator.scala:218-260)."""

    def __init__(
        self,
        metric: Metric,
        other_metrics: Sequence[Metric] = (),
        output_path: str | None = None,
        use_device_path: bool = True,
    ):
        self.metric = metric
        self.other_metrics = list(other_metrics)
        self.output_path = output_path
        # the device fast path (core/fast_eval.py eval_device); off forces
        # every candidate through the classic per-query engine.eval path
        self.use_device_path = use_device_path

    def _make_workflow(
        self,
        ctx: WorkflowContext,
        engine: Engine,
        engine_params_list: Sequence[EngineParams],
        metrics: Sequence[Metric],
    ):
        """A prewarmed FastEvalEngineWorkflow when the sweep can take the
        device fast path, else None (per-candidate engine.eval keeps the
        exact classic semantics — sanity checks, serving.supplement)."""
        if not self.use_device_path or not isinstance(engine, Engine):
            return None
        if any(m.device_spec() is None for m in metrics):
            return None
        try:
            from predictionio_tpu_torch.core.base import Algorithm, FirstServing

            for ep in engine_params_list:
                if type(engine.make_serving(ep)) is not FirstServing:
                    return None
            algos = engine.make_algorithms(engine_params_list[0])
            if not algos or type(algos[0]).eval_topk is Algorithm.eval_topk:
                return None
        except Exception:
            logger.debug("device eval gating failed; using serial path", exc_info=True)
            return None
        from predictionio_tpu_torch.core.fast_eval import FastEvalEngineWorkflow

        workflow = FastEvalEngineWorkflow(engine, ctx)
        workflow.prewarm_sweeps(engine_params_list)
        return workflow

    def evaluate(
        self,
        ctx: WorkflowContext,
        engine: Engine,
        engine_params_list: Sequence[EngineParams],
        workflow_params: WorkflowParams | None = None,
    ) -> MetricEvaluatorResult:
        if not engine_params_list:
            raise ValueError("engine_params_list must not be empty")
        metrics = [self.metric, *self.other_metrics]
        workflow = self._make_workflow(ctx, engine, engine_params_list, metrics)
        phase: dict[str, float] = (
            workflow.phase_seconds
            if workflow is not None
            else {"train": 0.0, "predict": 0.0, "metric": 0.0}
        )
        scores: list[tuple[EngineParams, MetricScores]] = []
        for i, ep in enumerate(engine_params_list):
            vals = workflow.eval_device(ep, metrics) if workflow is not None else None
            if vals is not None:
                ms = MetricScores(score=vals[0], other_scores=vals[1:])
            else:
                t0 = time.perf_counter()
                eval_data = engine.eval(ctx, ep, workflow_params)
                phase["serial"] = (
                    phase.get("serial", 0.0) + time.perf_counter() - t0
                )
                t0 = time.perf_counter()
                ms = MetricScores(
                    score=self.metric.calculate(eval_data),
                    other_scores=[
                        m.calculate(eval_data) for m in self.other_metrics
                    ],
                )
                phase["metric"] = (
                    phase.get("metric", 0.0) + time.perf_counter() - t0
                )
            logger.info(
                "candidate %d/%d: %s = %s%s",
                i + 1,
                len(engine_params_list),
                self.metric.header,
                ms.score,
                " (device fast path)" if vals is not None else "",
            )
            scores.append((ep, ms))

        best_idx = 0
        for i in range(1, len(scores)):
            if self.metric.compare(scores[i][1].score, scores[best_idx][1].score) > 0:
                best_idx = i
        best_ep, best_ms = scores[best_idx]
        result = MetricEvaluatorResult(
            best_score=best_ms,
            best_engine_params=best_ep,
            best_idx=best_idx,
            metric_header=self.metric.header,
            other_metric_headers=[m.header for m in self.other_metrics],
            engine_params_scores=scores,
            phase_seconds=dict(phase),
            cache_stats=(
                {"hits": dict(workflow.hits), "misses": dict(workflow.misses)}
                if workflow is not None
                else {}
            ),
            fast_path_candidates=(
                workflow.fast_path_candidates if workflow is not None else 0
            ),
        )
        logger.info(
            "eval phases (s): %s; fast-path candidates %d/%d",
            {k: round(v, 3) for k, v in result.phase_seconds.items()},
            result.fast_path_candidates,
            len(scores),
        )
        if self.output_path:
            self.save_engine_json(result, self.output_path)
        return result

    def save_engine_json(self, result: MetricEvaluatorResult, path: str) -> None:
        """Write the best params as an engine-variant JSON (the reference's
        best.json via saveEngineJson, MetricEvaluator.scala:185-216)."""
        ep = result.best_engine_params
        variant = {
            "datasource": {"name": ep.datasource[0], "params": ep.datasource[1].to_dict()},
            "preparator": {"name": ep.preparator[0], "params": ep.preparator[1].to_dict()},
            "algorithms": [
                {"name": name, "params": params.to_dict()}
                for name, params in ep.algorithms
            ],
            "serving": {"name": ep.serving[0], "params": ep.serving[1].to_dict()},
        }
        with open(path, "w") as f:
            json.dump(variant, f, indent=2, sort_keys=True)
        logger.info("best engine params written to %s", path)


class Evaluation:
    """Binds an engine to an evaluator for `pio eval`
    (reference controller/Evaluation.scala; ``engine_metric`` wraps a bare
    Metric in a MetricEvaluator exactly like ``engineMetric_=``)."""

    def __init__(
        self,
        engine: Engine,
        metric: Metric | None = None,
        evaluator: MetricEvaluator | None = None,
        engine_params_generator: EngineParamsGenerator | None = None,
    ):
        if evaluator is None and metric is None:
            raise ValueError("Evaluation needs a metric or an evaluator")
        self.engine = engine
        self.evaluator = evaluator or MetricEvaluator(metric)
        self.engine_params_generator = engine_params_generator

    def run(
        self,
        ctx: WorkflowContext,
        engine_params_list: Sequence[EngineParams] | None = None,
        workflow_params: WorkflowParams | None = None,
    ) -> MetricEvaluatorResult:
        if engine_params_list is None:
            if self.engine_params_generator is None:
                raise ValueError(
                    "no engine_params_list given and no generator configured"
                )
            engine_params_list = self.engine_params_generator.engine_params_list
        return self.evaluator.evaluate(
            ctx, self.engine, engine_params_list, workflow_params
        )
