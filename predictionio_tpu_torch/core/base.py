"""DASE component contracts: DataSource, Preparator, Algorithm, Serving.

Port of ``predictionio_tpu/core/base.py``: the serving and training
contracts, and the evaluation hooks (``DataSource.read_eval``,
``EvalTopK``, ``Algorithm.eval_topk`` and ``Algorithm.train_sweep``,
whose defaults decline as the JAX package's do). One difference: an ``Algorithm`` carries the
``torch.device`` it scores on (``device``), set by the deploy path from
the run's WorkflowContext; ``None`` means CUDA (utils/device.py).
"""

from __future__ import annotations

import abc
import inspect
from dataclasses import dataclass
from typing import Any, Generic, Sequence, TypeVar

import torch

from predictionio_tpu_torch.core.context import WorkflowContext
from predictionio_tpu_torch.core.params import EmptyParams, Params

TD = TypeVar("TD")  # training data
PD = TypeVar("PD")  # prepared data
Q = TypeVar("Q")  # query
P = TypeVar("P")  # predicted result
A = TypeVar("A")  # actual result
M = TypeVar("M")  # model


class Component:
    """Common base: every DASE component is constructed with a Params
    instance available as ``self.params`` (reference AbstractDoer)."""

    params_class: type[Params] = EmptyParams

    def __init__(self, params: Params | None = None):
        self.params = params if params is not None else self.params_class()


def doer(cls: type, params: Params | None = None) -> Any:
    """Instantiate a DASE component with params, tolerating zero-arg
    constructors (reference core/AbstractDoer.scala ``object Doer``)."""
    try:
        sig = inspect.signature(cls.__init__)
        takes_params = len(sig.parameters) > 1  # beyond self
    except (TypeError, ValueError):
        takes_params = True
    if takes_params:
        return cls(params) if params is not None else cls()
    return cls()


class DataSource(Component, Generic[TD, Q, A], abc.ABC):
    """Reads training (and evaluation) data from the event store.

    ``read_training`` -> TD; ``read_eval`` -> [(TD, eval_info, [(Q, A)])]
    for k evaluation sets (reference BaseDataSource.readTrainingBase /
    readEvalBase).
    """

    @abc.abstractmethod
    def read_training(self, ctx: WorkflowContext) -> TD: ...

    def read_eval(
        self, ctx: WorkflowContext
    ) -> list[tuple[TD, Any, list[tuple[Q, A]]]]:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement read_eval; "
            "evaluation is unavailable for this data source"
        )


class Preparator(Component, Generic[TD, PD], abc.ABC):
    """TD -> PD transformation (reference BasePreparator.prepareBase)."""

    @abc.abstractmethod
    def prepare(self, ctx: WorkflowContext, training_data: TD) -> PD: ...


class IdentityPreparator(Preparator[TD, TD]):
    """PD = TD passthrough (reference controller/IdentityPreparator.scala)."""

    def prepare(self, ctx: WorkflowContext, training_data: TD) -> TD:
        return training_data


@dataclass
class EvalTopK:
    """Device-shaped evaluation predictions: one candidate's answers to a
    whole eval split as a padded [Q, P] id/score matrix (the evaluation
    fast path's interchange type, core/fast_eval.py eval_device).

    ``ids``: int32 [Q, P] ranked predicted item indices in the model's
    dense id space; -1 marks an empty slot (rows already capped to each
    query's requested result count, so slicing ``ids[:, :k]`` is exactly
    the per-query path's ``top[:k]``).
    ``scores``: float32 [Q, P] matching scores (padding slots are 0).
    ``index``: the id -> dense-int mapping (``.get``-capable: a BiMap or
    dict) that encodes actual/relevant ids into the same space.
    """

    ids: Any
    scores: Any
    index: Any


class Algorithm(Component, Generic[PD, M, Q, P], abc.ABC):
    """Train a model from prepared data; score queries against it.

    ``query_class`` is used by the query server to deserialize JSON
    queries (dict passthrough when None); ``device`` is where scoring
    runs (None = CUDA)."""

    query_class: type | None = None
    device: torch.device | None = None

    @abc.abstractmethod
    def train(self, ctx: WorkflowContext, prepared_data: PD) -> M: ...

    @abc.abstractmethod
    def predict(self, model: M, query: Q) -> P: ...

    def batch_predict(self, model: M, queries: Sequence[tuple[int, Q]]) -> list[tuple[int, P]]:
        """Bulk scoring. Default: loop ``predict``; engines override with
        one batched device call."""
        return [(ix, self.predict(model, q)) for ix, q in queries]

    def cacheable_query(self, query: Q) -> bool:
        """May the engine server cache this query's response until the
        next model swap? Default True: a pure function of (model, query)
        is exactly invalidated by the server's epoch fence -- every
        ``/reload`` bumps the epoch and retires all cached entries.
        Return False when the prediction reads MUTABLE state outside the
        model (live event-store filters, wall-clock time, per-request
        randomness): the epoch fence cannot see those writes, so a cached
        result could go stale (server/query_cache.py)."""
        return True

    def warmup_query(self, model: M) -> Q | None:
        """A throwaway query scored once at deploy before the port binds
        (the first real query then finds the kernels built and the
        tables on the device), or None to skip. Default: a zero-arg
        ``query_class()`` when that constructs."""
        if self.query_class is None:
            return None
        try:
            return self.query_class()
        except TypeError:
            return None

    def eval_topk(
        self, model: M, queries: Sequence[Q], k: int
    ) -> "EvalTopK | None":
        """Batched device eval scoring, or None when unsupported.

        The evaluation fast path calls this once per eval split with all
        queries: an implementation returns the whole split's ranked
        predictions as one padded EvalTopK matrix (one batched top-k
        device call instead of Q Python predictions). Rows must match
        what ``predict``/``batch_predict`` would serve -- same ranking,
        capped to each query's requested result count -- so metric parity
        with the per-query path holds exactly. Returning None (the
        default) keeps the candidate on the per-query path.
        """
        return None

    def train_sweep(
        self, ctx: WorkflowContext, prepared_data: PD, params_list: Sequence[Any]
    ) -> "list[M] | None":
        """Train MANY param variants of this algorithm at once, or None.

        Evaluation sweeps call this with every candidate's params for one
        algorithm slot; an implementation that can stack the trainings
        (a candidate axis on the device, ops/als.py als_train_sweep)
        returns one model per candidate in order. Returning None (the
        default) tells the sweep to fall back to one ``train`` call per
        candidate.
        """
        return None

    def make_persistent_model(self, model: M) -> Any:
        """The object to persist for this model: the model itself (model
        file), a PersistentModel, or None ("retrain on deploy")."""
        return model


class Serving(Component, Generic[Q, P], abc.ABC):
    """Combines per-algorithm predictions into one response."""

    def supplement(self, query: Q) -> Q:
        return query

    @abc.abstractmethod
    def serve(self, query: Q, predictions: Sequence[P]) -> P: ...

    def cacheable_query(self, query: Q) -> bool:
        """Serving-level veto on query-result caching (the Algorithm
        hook of the same name, for combine-time state: A/B bucketing by
        time, randomized tie-breaks). Default True -- ``serve`` is
        normally a pure join of its inputs."""
        return True


class FirstServing(Serving[Q, P]):
    """Serve the first algorithm's prediction (reference LFirstServing:28)."""

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        return predictions[0]


class SanityCheck(abc.ABC):
    """Optional self-check run on TrainingData / PreparedData / models
    during training unless skipped (reference controller/SanityCheck.scala)."""

    @abc.abstractmethod
    def sanity_check(self) -> None: ...
