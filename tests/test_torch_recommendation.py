"""The serving slice end to end: an instance the JAX package trained,
deployed by the port.

The JAX package's ``run_train`` trains the recommendation engine (60
users x 40 items, rank 8, 2 iterations; f32 and int8 storage) into
sqlite + localfs storage under a temporary ``PIO_FS_BASEDIR``. The port
opens the same storage, deploys the instance on the CPU through its own
``deploy`` entry point and answers queries; every answer must hold the
JAX engine server's item list, with scores within rtol=1e-5 (the two
packages sum the dot products in different orders; byte identity is not
the bar). One query goes over real HTTP.
"""

from __future__ import annotations

import http.client
import json
import os

import numpy as np
import pytest

from predictionio_tpu.core import EngineParams
from predictionio_tpu.core.workflow import run_train
from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.data.event import Event
from predictionio_tpu.data.storage import App
from predictionio_tpu.models import modelfile as jmf
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.server.engine_server import EngineServer as JaxEngineServer
from predictionio_tpu_torch.cli import main as tcli
from predictionio_tpu_torch.core.context import WorkflowContext
from predictionio_tpu_torch.core.engine import resolve_engine_factory
from predictionio_tpu_torch.core.workflow import save_instance
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models import recommendation as trec
from predictionio_tpu_torch.models import similarproduct as tsim
from predictionio_tpu_torch.ops import als as tals
from predictionio_tpu_torch.server.engine_server import EngineServer

N_USERS, N_ITEMS = 60, 40
FACTORY = "predictionio_tpu.models.recommendation.engine"
QUERIES = [
    {"user": "u0", "num": 1},
    {"user": "u7", "num": 4},
    {"user": "u13"},  # default num
    {"user": "u21", "num": 10},
    {"user": "u59", "num": N_ITEMS},
    {"user": "u3", "num": 100},  # more than the catalog holds
    {"user": "nobody", "num": 4},
    {"user": 5, "num": 4},  # a non-string id is an unknown user
]


@pytest.fixture(scope="module", params=["float32", "int8"])
def trained(request, tmp_path_factory):
    """(basedir, instance id, variant path) of a JAX-trained instance."""
    storage_dtype = request.param
    basedir = tmp_path_factory.mktemp(f"rec_{storage_dtype}")
    storage = jstorage.Storage(env={"PIO_FS_BASEDIR": str(basedir)})
    app_id = storage.get_metadata_apps().insert(App(0, "RecApp"))
    events = storage.get_events()
    events.init(app_id)
    rng = np.random.default_rng(0)
    batch = []
    for u in range(N_USERS):
        for i in rng.choice(N_ITEMS, 12, replace=False):
            batch.append(Event(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{int(i)}",
                properties={"rating": float(rng.integers(1, 6))},
            ))
    events.batch_insert(batch, app_id)
    variant = basedir / "engine.json"
    variant.write_text(json.dumps({"id": "rec-port", "engineFactory": FACTORY}))
    ep = EngineParams(
        datasource=("", jrec.DataSourceParams(app_name="RecApp")),
        algorithms=[("als", jrec.ALSAlgorithmParams(
            rank=8, num_iterations=2, lambda_=0.05, storage_dtype=storage_dtype,
        ))],
    )
    jstorage.set_storage(storage)  # the datasource reads the singleton
    try:
        iid = run_train(
            jrec.engine(), ep, engine_id="rec-port", engine_variant="engine.json",
            engine_factory=FACTORY, storage=storage,
        )
    finally:
        jstorage.set_storage(None)
        storage.close()
    return basedir, iid, str(variant)


@pytest.fixture()
def servers(trained):
    """(JAX engine server, port engine server) on the same instance."""
    basedir, iid, _ = trained
    js = jstorage.Storage(env={"PIO_FS_BASEDIR": str(basedir)})
    ts = tstorage.Storage(env={"PIO_FS_BASEDIR": str(basedir)})
    jax_server = JaxEngineServer(
        jrec.engine(), js.get_metadata_engine_instances().get(iid),
        storage=js, host="127.0.0.1", port=0,
    )
    port_server = EngineServer(
        resolve_engine_factory(FACTORY), ts.get_metadata_engine_instances().get(iid),
        storage=ts, host="127.0.0.1", port=0, device="cpu",
    )
    yield jax_server, port_server
    port_server.stop()
    js.close()
    ts.close()


def _assert_same_answer(got, want):
    got, want = got["itemScores"], want["itemScores"]
    assert [x["item"] for x in got] == [x["item"] for x in want]
    np.testing.assert_allclose(
        [x["score"] for x in got], [x["score"] for x in want], rtol=1e-5, atol=1e-6
    )


def test_port_answers_like_the_jax_server(servers):
    jax_server, port_server = servers
    assert port_server.warmup() == 1
    for body in QUERIES:
        _assert_same_answer(port_server.handle_query(dict(body)),
                            jax_server.handle_query(dict(body)))
    assert port_server.status()["requestCount"] == len(QUERIES)


def test_batch_predict_matches_per_query(servers):
    _, port_server = servers
    algo, model = port_server.algorithms[0], port_server.models[0]
    queries = [(j, trec.Query(user=f"u{j}", num=3 + j % 5)) for j in range(17)]
    queries.append((17, trec.Query(user="nobody")))
    batched = dict(algo.batch_predict(model, queries))
    for j, q in queries:
        assert batched[j] == algo.predict(model, q)


def test_http_round_trip(servers):
    jax_server, port_server = servers
    port = port_server.start(background=True)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        body = {"user": "u7", "num": 5}
        conn.request("POST", "/queries.json", json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        _assert_same_answer(json.loads(resp.read()), jax_server.handle_query(body))
        conn.request("POST", "/queries.json", b"[1, 2]")
        resp = conn.getresponse()
        assert resp.status == 400 and "message" in json.loads(resp.read())
        conn.request("GET", "/")
        status = json.loads(conn.getresponse().read())
        assert status["status"] == "alive" and status["device"] == "cpu"
    finally:
        conn.close()


def test_cli_deploy_resolves_the_variant(trained, monkeypatch):
    basedir, iid, variant = trained
    monkeypatch.setenv("PIO_FS_BASEDIR", str(basedir))
    for k in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(k)
    tstorage.set_storage(None)
    try:
        args = tcli.build_parser().parse_args([
            "deploy", "--variant", variant, "--ip", "127.0.0.1", "--port", "0",
            "--device", "cpu",
        ])
        server = tcli.deploy_server(args)
        assert server.instance.id == iid
        assert isinstance(server.algorithms[0], trec.ALSAlgorithm)
        args.engine_instance_id = "no-such-instance"
        with pytest.raises(LookupError):
            tcli.deploy_server(args)
    finally:
        tstorage.get_storage().close()
        tstorage.set_storage(None)


def test_port_written_instance_reads_in_the_jax_package(tmp_path):
    ts = tstorage.Storage(env={"PIO_FS_BASEDIR": str(tmp_path)})
    engine = trec.engine()
    ep = engine.params_from_variant({"algorithms": [{"name": "als", "params": {"rank": 2}}]})
    model = trec.model_from_numpy(["a", "b"], ["x", "y", "z"],
                                  np.ones((2, 2), np.float32), np.eye(3, 2, dtype=np.float32))
    iid = save_instance(engine, ep, [model], engine_id="e", storage=ts)
    js = jstorage.Storage(env={"PIO_FS_BASEDIR": str(tmp_path)})
    inst = js.get_metadata_engine_instances().get_latest_completed("e", "0", "default")
    assert inst is not None and inst.id == iid
    [(kind, back)] = jmf.deserialize(js.get_model_data_models().get(iid).models)
    assert kind == "arrays" and back.item_index.to_dict() == {"x": 0, "y": 1, "z": 2}
    js.close()
    ts.close()


def test_unported_paths_raise(servers, monkeypatch, tmp_path):
    _, port_server = servers
    algo, model = port_server.algorithms[0], port_server.models[0]
    q = [(0, trec.Query(user="u1", num=4))]
    # two-stage retrieval is ported: at threshold 10 (40 items >= 10) the
    # shortlist + rescore answers as the exact path does
    exact = algo.batch_predict(model, q)
    monkeypatch.setenv("PIO_RETRIEVAL_THRESHOLD", "10")
    assert algo.batch_predict(model, q) == exact
    monkeypatch.delenv("PIO_RETRIEVAL_THRESHOLD")
    sharded = trec.ALSAlgorithm(trec.ALSAlgorithmParams(sharded_serving=True))
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        sharded.batch_predict(model, q)
    td = trec.TrainingData(user_ids=["a"], item_ids=["x"],
                           rows=np.zeros(1, np.int32), cols=np.zeros(1, np.int32),
                           ratings=np.ones(1, np.float32))
    ctx = WorkflowContext(device="cpu")
    sharded_train = trec.ALSAlgorithm(trec.ALSAlgorithmParams(sharded_train=True))
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        sharded_train.train(ctx, td)
    # checkpointing is ported (core/checkpoint.py): the env var trains
    monkeypatch.setenv("PIO_CHECKPOINT_EVERY", "1")
    monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(tmp_path / "ckpt"))
    assert algo.train(ctx, td).user_factors.shape[0] == 1
    monkeypatch.delenv("PIO_CHECKPOINT_EVERY")
    monkeypatch.delenv("PIO_CHECKPOINT_DIR")
    # evaluation is ported: a stacked sweep trains, its multi-card
    # candidates decline as in the JAX package, and sharded eval scoring
    # refuses as the other multi-card paths do
    assert len(algo.train_sweep(ctx, td, [algo.params, algo.params])) == 2
    assert algo.train_sweep(ctx, td, [algo.params, sharded_train.params]) is None
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        sharded.eval_topk(model, [trec.Query(user="u1", num=4)], 4)
    with pytest.raises(ValueError, match="not ported"):
        resolve_engine_factory("predictionio_tpu.models.classification.engine")


def _similar_product_refusal(case: str) -> None:
    ctx = WorkflowContext(device="cpu")
    td = tsim.TrainingData(users=["a"], items={"x": []}, view_events=tstorage.RatingsBatch(
        ["a"], ["x"], np.zeros(1, np.int32), np.zeros(1, np.int32), np.ones(1, np.float32)))
    if case == "sharded_train":
        tsim.ALSAlgorithm(tsim.ALSAlgorithmParams(sharded_train=True)).train(ctx, td)
    elif case == "cosine":
        engine = tsim.engine()
        assert "cosine" in engine.algorithm_classes
        engine.algorithm_classes["cosine"]().train(ctx, td)


def _similar_product_cosine():
    """The engine's cosine algorithm trained on three items (a user views
    x and y, another x and z) and asked for x's neighbor outside z."""
    ctx = WorkflowContext(device="cpu")
    td = tsim.TrainingData(users=["a", "b"], items={"x": [], "y": [], "z": []},
                           view_events=tstorage.RatingsBatch(
                               ["a", "b"], ["x", "y", "z"], np.array([0, 0, 1, 1], np.int32),
                               np.array([0, 1, 0, 2], np.int32), np.ones(4, np.float32)))
    algo = tsim.engine().algorithm_classes["cosine"]()
    model = algo.train(ctx, td)
    return model, algo.predict(model, tsim.Query(items=["x"], num=3, blackList=["z"]))


def _similar_product_two_stage(monkeypatch):
    """A 40-item catalog's answers on the exact path, then at threshold
    10, where two-stage retrieval serves them."""
    algo = tsim.ALSAlgorithm(tsim.ALSAlgorithmParams(rank=2, num_iterations=1))
    algo.device = WorkflowContext(device="cpu").device
    model = tsim.SimilarProductModel(
        item_index=BiMap.from_dense([f"i{j}" for j in range(40)]),
        item_factors=np.random.default_rng(3).standard_normal((40, 2)).astype(np.float32),
        categories={})
    queries = [tsim.Query(items=["i0"], num=3), tsim.Query(items=["i1", "i2"], num=4,
                                                          blackList=["i5"])]
    exact = [algo.predict(model, q) for q in queries]
    monkeypatch.setenv("PIO_RETRIEVAL_THRESHOLD", "10")
    return exact, [algo.predict(model, q) for q in queries]


@pytest.mark.parametrize("case,match", [
    ("sharded_train", "multi-GPU"),
    ("two_stage", "two-stage"),
    ("cosine", "cosine_sim"),
])
def test_similar_product_unported_paths_raise(case, match, monkeypatch):
    """The similar-product template refuses what the port does not have
    yet, naming the later slice, rather than answering another way. The
    two-stage case is ported: at threshold 10 the template answers, and
    as its exact path does. So is the cosine algorithm (ops/cosine_sim.py):
    it trains and answers on the CPU."""
    if case == "two_stage":
        exact, two = _similar_product_two_stage(monkeypatch)
        assert all(r.itemScores for r in two) and two == exact
        return
    if case == "cosine":
        model, answer = _similar_product_cosine()
        assert isinstance(model, tsim.CosineModel) and model.sim_ids.shape == (3, 2)
        assert [s.item for s in answer.itemScores] == ["y"]
        return
    with pytest.raises(NotImplementedError, match=match):
        _similar_product_refusal(case)
