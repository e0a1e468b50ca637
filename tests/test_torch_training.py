"""The training slice end to end, on the CPU: events in a sqlite store ->
``train`` -> model file -> ``deploy``, the port against the JAX package.

The JAX package writes the events (60 users x 40 items, rate and buy
events) into sqlite + localfs storage under a temporary
``PIO_FS_BASEDIR`` and trains once cold (rank 6, 3 iterations). The
store is copied; the JAX package's ``train --warm-start`` runs in one
copy and the port's ``train --warm-start --device cpu`` in the other, so
both start from the same factors (``jax.random`` bits cannot be drawn
in torch). Tolerances: the two trained models' factors within
rtol=5e-4, atol=5e-5 (``tests/test_als.py:188``, the same init, the
normal equations summed and factored in different orders); their
answers with the same items, scores within rtol=2e-3, atol=2e-4 (the
factor tolerance carried through a rank-6 dot product), items allowed
to swap only between scores that close. The port-trained instance also
deploys on the JAX package, whose answers then match the port's within
rtol=1e-5 (the same factors; tests/test_torch_recommendation.py).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest

from predictionio_tpu.cli import main as jcli
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.data import store as jstore
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.server.engine_server import EngineServer as JaxEngineServer
from predictionio_tpu_torch.cli import main as tcli
from predictionio_tpu_torch.core.context import WorkflowContext
from predictionio_tpu_torch.core.engine import WorkflowParams, resolve_engine_factory
from predictionio_tpu_torch.core.workflow import run_train
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data import store as tstore
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App
from predictionio_tpu_torch.models import recommendation as trec
from predictionio_tpu_torch.server.engine_server import EngineServer

N_USERS, N_ITEMS, RANK = 60, 40, 6
FACTORY = "predictionio_tpu.models.recommendation.engine"
VARIANT = {
    "id": "train-port",
    "engineFactory": FACTORY,
    "datasource": {"params": {"appName": "TrainApp"}},
    "algorithms": [{"name": "als", "params": {
        "rank": RANK, "numIterations": 3, "lambda": 0.05, "seed": 5}}],
}
QUERIES = [{"user": f"u{j}", "num": n} for j, n in ((0, 1), (7, 4), (21, 10),
                                                      (59, N_ITEMS), (33, 5))]


def _events(event_cls, seed: int = 0) -> list:
    """Rate events (half stars) and a few buy events with a misleading
    rating property (buy is forced to buy_rating)."""
    rng = np.random.default_rng(seed)
    out = []
    for u in range(N_USERS):
        for i in rng.choice(N_ITEMS, 10, replace=False):
            out.append(event_cls(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{int(i)}",
                properties={"rating": float(rng.integers(1, 11)) / 2},
            ))
        if u % 7 == 0:
            out.append(event_cls(
                event="buy", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{(u * 3) % N_ITEMS}",
                properties={"rating": 1.0},
            ))
    return out


@pytest.fixture(scope="module")
def cold_store(tmp_path_factory):
    """A basedir holding JAX-written events and one JAX cold training."""
    basedir = tmp_path_factory.mktemp("train_cold")
    storage = jstorage.Storage(env={"PIO_FS_BASEDIR": str(basedir)})
    app_id = storage.get_metadata_apps().insert(JApp(0, "TrainApp"))
    storage.get_events().init(app_id)
    storage.get_events().batch_insert(_events(JEvent), app_id)
    (basedir / "engine.json").write_text(json.dumps(VARIANT))
    jstorage.set_storage(storage)  # the datasource reads the singleton
    try:
        jax_run_train(
            jrec.engine(),
            jrec.engine().params_from_variant(VARIANT),
            engine_id="train-port", engine_variant="engine.json",
            engine_factory=FACTORY, storage=storage,
        )
    finally:
        jstorage.set_storage(None)
        storage.close()
    return basedir


@pytest.fixture()
def pio_env(monkeypatch):
    """Point both packages' storage singletons at a basedir through the
    environment, as the CLIs read it; restore everything afterwards."""
    for k in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("PIO_WARM_START", "0")  # the JAX CLI sets it
    opened = []

    def use(basedir):
        monkeypatch.setenv("PIO_FS_BASEDIR", str(basedir))
        for mod in (jstorage, tstorage):
            mod.set_storage(None)
            opened.append(mod.get_storage())

    yield use
    for s in opened:
        s.close()
    jstorage.set_storage(None)
    tstorage.set_storage(None)


def _latest(storage):
    return storage.get_metadata_engine_instances().get_latest_completed(
        "train-port", "0", "engine.json")


def _answers_match(got, want, rtol, atol):
    gi, wi = [x["item"] for x in got["itemScores"]], [x["item"] for x in want["itemScores"]]
    gs = np.asarray([x["score"] for x in got["itemScores"]])
    ws = np.asarray([x["score"] for x in want["itemScores"]])
    assert len(gi) == len(wi)
    np.testing.assert_allclose(gs, ws, rtol=rtol, atol=atol)
    for p, (a, b) in enumerate(zip(gi, wi)):
        if a != b:  # only near-tied neighbours may swap
            near = [q for q in (p - 1, p + 1) if 0 <= q < len(ws)]
            assert any(abs(ws[q] - ws[p]) <= atol + rtol * abs(ws[p]) for q in near)
    assert set(gi) == set(wi) or len(gi) < N_ITEMS


def test_warm_start_train_through_both_clis_then_deploy(cold_store, tmp_path, pio_env):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    cold = jstorage.Storage(env={"PIO_FS_BASEDIR": str(cold_store)})
    cold_id = _latest(cold).id
    cold.close()
    shutil.copytree(cold_store, jdir)
    shutil.copytree(cold_store, tdir)

    pio_env(jdir)
    assert jcli.main(["train", "--variant", str(jdir / "engine.json"),
                      "--warm-start"]) == 0
    pio_env(tdir)
    assert tcli.main(["train", "--variant", str(tdir / "engine.json"),
                      "--warm-start", "--device", "cpu"]) == 0

    js_j = jstorage.Storage(env={"PIO_FS_BASEDIR": str(jdir)})
    js_t = jstorage.Storage(env={"PIO_FS_BASEDIR": str(tdir)})
    ts_t = tstorage.Storage(env={"PIO_FS_BASEDIR": str(tdir)})
    inst_j, inst_t = _latest(js_j), _latest(ts_t)
    assert cold_id not in (inst_j.id, inst_t.id)  # the two warm trainings
    assert json.loads(inst_t.algorithms_params) == json.loads(inst_j.algorithms_params)
    jax_on_jax = JaxEngineServer(jrec.engine(), inst_j, storage=js_j,
                                 host="127.0.0.1", port=0)
    port_on_port = EngineServer(resolve_engine_factory(FACTORY), inst_t,
                                storage=ts_t, host="127.0.0.1", port=0, device="cpu")
    jax_on_port = JaxEngineServer(jrec.engine(), _latest(js_t), storage=js_t,
                                  host="127.0.0.1", port=0)
    try:
        mj, mt = jax_on_jax.models[0], port_on_port.models[0]
        assert mt.user_index.to_dict() == mj.user_index.to_dict()
        assert mt.item_index.to_dict() == mj.item_index.to_dict()
        np.testing.assert_allclose(mt.user_factors, np.asarray(mj.user_factors),
                                   rtol=5e-4, atol=5e-5)
        np.testing.assert_allclose(mt.item_factors, np.asarray(mj.item_factors),
                                   rtol=5e-4, atol=5e-5)
        for q in QUERIES:
            want = jax_on_jax.handle_query(dict(q))
            got = port_on_port.handle_query(dict(q))
            _answers_match(got, want, rtol=2e-3, atol=2e-4)
            _answers_match(jax_on_port.handle_query(dict(q)), got, rtol=1e-5, atol=1e-6)
    finally:
        port_on_port.stop()
        for s in (js_j, js_t, ts_t):
            s.close()


def _triples(batch):
    return [(batch.entity_ids[r], batch.target_ids[c], float(v))
            for r, c, v in zip(batch.rows, batch.cols, batch.vals)]


def test_events_written_by_either_package_read_the_same(tmp_path):
    """The port's writes read back in the JAX package's find_ratings and
    find, and the reverse, in the same order with the same values."""
    for writer in ("port", "jax"):
        base = tmp_path / writer
        ts = tstorage.Storage(env={"PIO_FS_BASEDIR": str(base)})
        js = jstorage.Storage(env={"PIO_FS_BASEDIR": str(base)})
        if writer == "port":
            app_id = ts.get_metadata_apps().insert(App(0, "Mixed"))
            ts.get_events().batch_insert(_events(Event, seed=3), app_id)
        else:
            app_id = js.get_metadata_apps().insert(JApp(0, "Mixed"))
            js.get_events().batch_insert(_events(JEvent, seed=3), app_id)
        kw = dict(event_names=["rate", "buy"], entity_type="user",
                  target_entity_type="item", override_ratings={"buy": 4.0})
        a = tstore.find_ratings("Mixed", storage=ts, **kw)
        b = jstore.find_ratings("Mixed", storage=js, **kw)
        assert a.entity_ids == b.entity_ids and a.target_ids == b.target_ids
        for name in ("rows", "cols", "vals"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert 4.0 in a.vals[np.asarray(a.entity_ids)[a.rows] == "u0"]
        te = tstore.find("Mixed", entity_id="u7", storage=ts)
        je = jstore.find("Mixed", entity_id="u7", storage=js)
        assert [e.to_dict(for_api=False) for e in te] == [
            e.to_dict(for_api=False) for e in je]
        # the port's default row-walk scan (event-time order) reads the
        # same triples as its columnar one (insertion order)
        walked = tstorage.base.Events.scan_ratings(ts.get_events(), app_id, **kw)
        assert sorted(_triples(walked)) == sorted(_triples(a))
        ts.close()
        js.close()


def test_sqlite_schema_is_the_jax_packages(tmp_path):
    """Both packages create the same tables, indexes and columns."""
    import sqlite3

    schemas = []
    for mod, app_cls, event_cls in ((tstorage, App, Event), (jstorage, JApp, JEvent)):
        base = tmp_path / mod.__name__
        s = mod.Storage(env={"PIO_FS_BASEDIR": str(base)})
        app_id = s.get_metadata_apps().insert(app_cls(0, "Schema"))
        s.get_events().insert(event_cls(event="rate", entity_type="user",
                                        entity_id="u", target_entity_type="item",
                                        target_entity_id="i"), app_id, 3)
        s.close()
        with sqlite3.connect(base / "pio.db") as conn:
            schemas.append(sorted(conn.execute(
                "SELECT type, name, sql FROM sqlite_master").fetchall()))
    assert schemas[0] == schemas[1]
    assert any(name == "pio_event_1_3" for _, name, _ in schemas[0])


def test_event_backends_the_port_lacks_raise_a_named_error(tmp_path):
    for kind in ("search", "postgres", "http"):
        s = tstorage.Storage(env={
            "PIO_STORAGE_SOURCES_EV_TYPE": kind,
            "PIO_STORAGE_SOURCES_META_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_META_PATH": str(tmp_path / "pio.db"),
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EV",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "META",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "META",
        })
        with pytest.raises(tstorage.StorageError, match=kind):
            s.get_events()
        assert s.get_metadata_apps().get_all() == []
        s.close()


def test_run_train_lifecycle_on_memory_storage():
    """run_train in process on the memory backend: stops after read and
    after prepare leave INIT instances, a failure marks FAILED, a
    finished run is COMPLETED with its model deployable."""
    storage = tstorage.test_storage()
    app_id = storage.get_metadata_apps().insert(App(0, "TrainApp"))
    storage.get_events().batch_insert(_events(Event, seed=1), app_id)
    engine = trec.engine()
    ep = engine.params_from_variant(VARIANT)
    ctx = WorkflowContext(device="cpu")
    tstorage.set_storage(storage)
    try:
        for flag in ("stop_after_read", "stop_after_prepare"):
            iid = run_train(engine, ep, workflow_params=WorkflowParams(**{flag: True}),
                            storage=storage, ctx=WorkflowContext(device="cpu"))
            assert storage.get_metadata_engine_instances().get(iid).status == "INIT"
        bad = engine.params_from_variant({**VARIANT, "datasource": {
            "params": {"appName": "NoSuchApp"}}})
        with pytest.raises(Exception, match="NoSuchApp"):
            run_train(engine, bad, storage=storage, ctx=WorkflowContext(device="cpu"))
        statuses = [i.status for i in storage.get_metadata_engine_instances().get_all()]
        assert statuses.count("FAILED") == 1
        iid = run_train(engine, ep, engine_id="train-port", engine_variant="engine.json",
                        storage=storage, ctx=ctx)
        inst = storage.get_metadata_engine_instances().get(iid)
        assert inst.status == "COMPLETED"
        server = EngineServer(engine, inst, storage=storage, host="127.0.0.1",
                              port=0, device="cpu")
        assert server.handle_query({"user": "u3", "num": 3})["itemScores"]
        server.stop()
        with pytest.raises(NotImplementedError):
            WorkflowParams(mesh_axes=[("data", 2)])
        with pytest.raises(NotImplementedError):
            WorkflowParams(profile_dir="/nonexistent")
    finally:
        tstorage.set_storage(None)
        storage.close()


def test_cli_train_needs_cuda_unless_asked_for_the_cpu(cold_store, tmp_path, pio_env):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: train would run on it")
    base = tmp_path / "store"
    shutil.copytree(cold_store, base)
    pio_env(base)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["train", "--variant", str(base / "engine.json")])
    with pytest.raises(SystemExit):  # the JAX CLI's mesh flags are refused
        tcli.main(["train", "--variant", str(base / "engine.json"), "--mesh", "data=8"])
    # its checkpoint flags are ported: parsed, then training needs CUDA
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(["train", "--variant", str(base / "engine.json"), "--resume",
                       "--checkpoint-dir", str(tmp_path / "ckpt")])
    finally:  # the CLI sets these in os.environ, as the JAX CLI does
        for k in ("PIO_RESUME", "PIO_CHECKPOINT_DIR"):
            os.environ.pop(k, None)
