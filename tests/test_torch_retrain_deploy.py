"""Retrain-on-deploy in the port (``core/workflow.py prepare_deploy``).

An algorithm whose ``make_persistent_model`` returns None persists the
``RETRAIN`` sentinel (the reference's PAlgorithm without a
PersistentModel); deploying such an instance trains it there, as the JAX
package does (``predictionio_tpu/core/workflow.py:263-269``).
``tests/test_engine.py``'s ``test_prepare_deploy_retrains_sentinels`` on
the port's fake engine, and the recommendation engine: the deployed
model equals a fresh ``run_train``'s from the same warm start, bit for
bit, on the CPU (K1's plain version).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from predictionio_tpu_torch.core import (
    Algorithm,
    DataSource,
    Engine,
    EngineParams,
    Params,
    Preparator,
    Serving,
)
from predictionio_tpu_torch.core import persistence, workflow
from predictionio_tpu_torch.core.context import WorkflowContext
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.models import recommendation as rec


@dataclass
class IdParams(Params):
    id: int = 0


@dataclass
class FakeModel:
    aid: int
    pid: int
    tid: int


class DataSource0(DataSource):
    params_class = IdParams

    def read_training(self, ctx):
        return self.params.id


class Preparator0(Preparator):
    params_class = IdParams

    def prepare(self, ctx, td):
        return (td, self.params.id)


class RetrainAlgo(Algorithm):
    params_class = IdParams

    def train(self, ctx, pd):
        return FakeModel(aid=self.params.id, pid=pd[1], tid=pd[0])

    def predict(self, model, query):
        return (model.aid, query)

    def make_persistent_model(self, model):
        return None  # a model that is trained again at deploy


class Serving0(Serving):
    def serve(self, query, predictions):
        return predictions[0]


def test_prepare_deploy_retrains_sentinels():
    storage = tstorage.test_storage()
    try:
        engine = Engine(DataSource0, Preparator0, {"": RetrainAlgo}, Serving0)
        ep = EngineParams(datasource=("", IdParams(1)), preparator=("", IdParams(2)),
                          algorithms=[("", IdParams(5))])
        iid = workflow.run_train(engine, ep, storage=storage,
                                 ctx=WorkflowContext(device="cpu"))
        inst = storage.get_metadata_engine_instances().get(iid)
        blob = storage.get_model_data_models().get(iid)
        algos = engine.make_algorithms(ep)
        assert persistence.deserialize_models(blob.models, algos, iid) == [
            persistence.RETRAIN]
        _, _, models, _ = workflow.prepare_deploy(engine, inst, storage=storage,
                                                  ctx=WorkflowContext(device="cpu"))
        assert models == [FakeModel(aid=5, pid=2, tid=1)]
    finally:
        storage.close()


class TransientALS(rec.ALSAlgorithm):
    def make_persistent_model(self, model):
        return None


def _store_with_ratings():
    storage = tstorage.test_storage()
    app_id = storage.get_metadata_apps().insert(tstorage.App(0, "Retrain"))
    rng = np.random.default_rng(3)
    storage.get_events().batch_insert([
        Event(event="rate", entity_type="user", entity_id=f"u{u}",
              target_entity_type="item", target_entity_id=f"i{int(i)}",
              properties={"rating": float(rng.integers(1, 6))})
        for u in range(30) for i in rng.choice(20, 6, replace=False)], app_id)
    return storage


def test_a_retrain_entry_deploys_as_a_fresh_training():
    storage = _store_with_ratings()
    tstorage.set_storage(storage)
    try:
        ep = EngineParams(
            datasource=("", rec.DataSourceParams(app_name="Retrain")),
            algorithms=[("als", rec.ALSAlgorithmParams(rank=4, num_iterations=3, seed=9))])
        persisted = rec.engine()
        transient = rec.engine()
        transient.algorithm_classes = {"als": TransientALS}
        first = workflow.run_train(persisted, ep, engine_id="seed", storage=storage,
                                   ctx=WorkflowContext(device="cpu"))
        _, _, (warm,), _ = workflow.prepare_deploy(
            persisted, storage.get_metadata_engine_instances().get(first), storage,
            WorkflowContext(device="cpu"))

        def ctx():
            return WorkflowContext(device="cpu", runtime_conf={"warm_start_models": [warm]})

        iid = workflow.run_train(transient, ep, engine_id="transient", storage=storage,
                                 ctx=ctx())
        _, _, (deployed,), _ = workflow.prepare_deploy(
            transient, storage.get_metadata_engine_instances().get(iid), storage, ctx())
        fresh_id = workflow.run_train(persisted, ep, engine_id="fresh", storage=storage,
                                      ctx=ctx())
        _, _, (fresh,), _ = workflow.prepare_deploy(
            persisted, storage.get_metadata_engine_instances().get(fresh_id), storage,
            WorkflowContext(device="cpu"))
        assert isinstance(deployed, rec.ALSModel)
        assert list(deployed.user_index.items()) == list(fresh.user_index.items())
        assert list(deployed.item_index.items()) == list(fresh.item_index.items())
        np.testing.assert_array_equal(deployed.user_factors, fresh.user_factors)
        np.testing.assert_array_equal(deployed.item_factors, fresh.item_factors)
        # the warm start took: the deployed model is not the cold one
        cold_id = workflow.run_train(persisted, ep, engine_id="cold", storage=storage,
                                     ctx=WorkflowContext(device="cpu"))
        _, _, (cold,), _ = workflow.prepare_deploy(
            persisted, storage.get_metadata_engine_instances().get(cold_id), storage,
            WorkflowContext(device="cpu"))
        assert not np.array_equal(deployed.user_factors, cold.user_factors)
    finally:
        tstorage.set_storage(None)
        storage.close()
