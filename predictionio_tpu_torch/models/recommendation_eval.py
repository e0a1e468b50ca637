"""Shipped evaluation for the recommendation template — a ready `pio eval`
target.

The reference ships this as part of the template zoo: a Precision@K
evaluation over k-fold splits with an EngineParamsGenerator sweeping ALS
hyperparameters (reference
examples/experimental/scala-local-movielens-evaluation/src/main/scala/Evaluation.scala:73-140
— `ItemRankEvaluation` with Precision@K / MAP@K;
core/.../controller/EngineParamsGenerator.scala). Run it with:

    python -m predictionio_tpu_torch.cli.main eval \\
        predictionio_tpu_torch.models.recommendation_eval.evaluation \\
        predictionio_tpu_torch.models.recommendation_eval.param_grid \\
        [--device cuda|cpu]

The target app defaults to ``MyApp``; set ``PIO_EVAL_APP_NAME`` to point
the sweep at another app (the reference's template hardcodes the app name
in Evaluation.scala for the user to edit — an env var keeps the shipped
module usable unedited).

Port of ``predictionio_tpu/models/recommendation_eval.py``: the same
sweep, on the port's recommendation engine. It rides the device
evaluation fast path end to end: Precision@K plus the MAP@K / NDCG@K
side metrics are stock ranking metrics, the engine serves with
FirstServing, and ALSAlgorithm implements ``train_sweep`` (K1s) and
``eval_topk`` (K2's launches) -- so every candidate's predictions stay
on the device as one padded [Q, K] top-k matrix and the metrics reduce
in K3 (ops/topk.py ranking_metrics_batch). The eval split is seeded
(DataSourceParams.eval_seed), so repeated runs reproduce identical folds
and scores, the JAX package's folds among them.

Both entry points are zero-arg factories (resolved lazily by
``run_evaluation``), so importing this module never touches storage.
"""

from __future__ import annotations

import os

from predictionio_tpu_torch.core.evaluation import Evaluation, MetricEvaluator
from predictionio_tpu_torch.core.params import EngineParamsGenerator
from predictionio_tpu_torch.core.ranking import MAPAtK, NDCGAtK, PrecisionAtK
from predictionio_tpu_torch.models import recommendation

SWEEP = [
    # (rank, lambda): the lambda/rank grid the reference's evaluation sweeps
    (5, 0.05),
    (10, 0.05),
    (10, 0.2),
    (20, 0.1),
]
# Precision@1 (hit rate): the engine's k-fold eval splits issue num=1
# queries per held-out rating (models/recommendation.py read_eval)
K = 1


def _app_name() -> str:
    return os.environ.get("PIO_EVAL_APP_NAME", "MyApp")


def _candidates(app_name: str):
    eng = recommendation.engine()
    return [
        eng.params_from_variant({
            "id": "eval",
            "engineFactory": "predictionio_tpu_torch.models.recommendation.engine",
            "datasource": {"params": {"app_name": app_name}},
            "algorithms": [{
                "name": "als",
                "params": {
                    "rank": rank,
                    "lambda": reg,
                    "num_iterations": 10,
                },
            }],
        })
        for rank, reg in SWEEP
    ]


def param_grid() -> EngineParamsGenerator:
    """The candidate sweep (EngineParamsGenerator analog)."""
    gen = EngineParamsGenerator()
    gen.engine_params_list = _candidates(_app_name())
    return gen


def evaluation() -> Evaluation:
    """Precision@K (primary) + MAP@K / NDCG@K side metrics over the
    engine's seeded k-fold eval splits."""
    return Evaluation(
        engine=recommendation.engine(),
        evaluator=MetricEvaluator(
            metric=PrecisionAtK(k=K),
            other_metrics=[MAPAtK(k=K), NDCGAtK(k=K)],
        ),
        engine_params_generator=param_grid(),
    )
