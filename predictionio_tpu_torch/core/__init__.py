"""DASE core of the port: contracts, params, engine, deploy workflow."""

from predictionio_tpu_torch.core.params import Params, EmptyParams, EngineParams
from predictionio_tpu_torch.core.base import (
    Algorithm,
    DataSource,
    EvalTopK,
    Preparator,
    IdentityPreparator,
    Serving,
    FirstServing,
    SanityCheck,
    doer,
)
from predictionio_tpu_torch.core.context import WorkflowContext
from predictionio_tpu_torch.core.engine import Engine, EngineFactory

__all__ = [
    "Params",
    "EmptyParams",
    "EngineParams",
    "Algorithm",
    "DataSource",
    "EvalTopK",
    "Preparator",
    "IdentityPreparator",
    "Serving",
    "FirstServing",
    "SanityCheck",
    "doer",
    "WorkflowContext",
    "Engine",
    "EngineFactory",
]
