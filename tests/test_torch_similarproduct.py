"""The similar-product template on the port against the JAX package's, on
the CPU.

Both packages get the same events or the same model arrays. Tolerances
and their reasons:

- ``aggregate_properties`` (sqlite and memory stores): equal maps, the
  same update times;
- ``aggregate_counts`` / ``from_triples`` and the normalized catalogs:
  bit for bit (the same numpy operations);
- a JAX-written ``SimilarProductModel`` deployed on the port: the same
  items as the JAX package's ``predict``, scores within rtol=1e-5,
  atol=1e-6 (the two sum the query rows and dot products in different
  orders), items swapping only inside runs of near-tied scores; on a
  catalog whose scores are exact, NaN rows included, the served response
  bytes equal the JAX package's;
- the template ported from ``tests/test_templates.py`` (without the
  cosine case), run on the port alone: the same structural checks.
"""

from __future__ import annotations

import dataclasses
import json
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage.base import RatingsBatch as JRatingsBatch
from predictionio_tpu.models import columnar as jcol
from predictionio_tpu.models import filters as jfilters
from predictionio_tpu.models import modelfile as jmf
from predictionio_tpu.models import similarproduct as jsim
from predictionio_tpu.server import jsonx as jjsonx
from predictionio_tpu_torch.cli import main as tcli
from predictionio_tpu_torch.core import EngineParams, WorkflowContext
from predictionio_tpu_torch.core.workflow import prepare_deploy, run_train
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data import store as tstore
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, RatingsBatch
from predictionio_tpu_torch.models import columnar as tcol
from predictionio_tpu_torch.models import filters as tfilters
from predictionio_tpu_torch.models import modelfile as tmf
from predictionio_tpu_torch.models import similarproduct as sim
from predictionio_tpu_torch.server import jsonx as tjsonx

CPU = torch.device("cpu")
CTX = WorkflowContext(mode="TemplateTest", device="cpu")
T0 = datetime(2021, 3, 1, tzinfo=timezone.utc)
RTOL, ATOL = 1e-5, 1e-6


# -- aggregate_properties ------------------------------------------------------


def _property_events(event_cls) -> list:
    """$set / $unset / $delete histories, out of time order, for users and
    items, plus other events the replay must ignore."""
    def ev(name, etype, eid, props, minutes, **kw):
        return event_cls(event=name, entity_type=etype, entity_id=eid,
                         properties=props, event_time=T0 + timedelta(minutes=minutes), **kw)

    return [
        ev("$set", "user", "u1", {"a": 1, "b": "x"}, 0),
        ev("$set", "user", "u1", {"b": "y", "c": [1, 2]}, 2),
        ev("$unset", "user", "u1", {"a": None}, 1),
        ev("$set", "user", "u2", {"a": 5}, 0),
        ev("$delete", "user", "u2", {}, 3),
        ev("$set", "user", "u3", {"z": True}, 4),
        ev("$delete", "user", "u3", {}, 5),
        ev("$set", "user", "u3", {"z": False}, 6),
        ev("$set", "item", "i1", {"categories": ["c1", "c2"]}, 0),
        ev("$set", "item", "i2", {"categories": ["c2"], "price": 3.5}, 1),
        ev("$unset", "item", "i2", {"price": None}, 7),
        ev("$set", "item", "u1", {"categories": ["c3"]}, 1),  # same id, other type
        ev("view", "user", "u1", {}, 9, target_entity_type="item", target_entity_id="i1"),
    ]


def _same_maps(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].to_dict() == want[k].to_dict(), k
        assert got[k].first_updated == want[k].first_updated, k
        assert got[k].last_updated == want[k].last_updated, k


@pytest.mark.parametrize("backend", ["sqlite", "memory"])
def test_aggregate_properties_matches_jax(backend, tmp_path):
    if backend == "sqlite":  # the JAX package writes, both read one store
        js = jstorage.Storage(env={"PIO_FS_BASEDIR": str(tmp_path)})
        app_id = js.get_metadata_apps().insert(jstorage.App(0, "PropApp"))
        js.get_events().batch_insert(_property_events(JEvent), app_id)
        ts = tstorage.Storage(env={"PIO_FS_BASEDIR": str(tmp_path)})
    else:  # each package writes the same events into its own store
        js, ts = jstorage.test_storage(), tstorage.test_storage()
        app_id = js.get_metadata_apps().insert(jstorage.App(0, "PropApp"))
        assert ts.get_metadata_apps().insert(App(0, "PropApp")) == app_id
        js.get_events().batch_insert(_property_events(JEvent), app_id)
        ts.get_events().batch_insert(_property_events(Event), app_id)
    try:
        for etype in ("user", "item"):
            want = js.get_events().aggregate_properties(app_id, entity_type=etype)
            got = tstore.aggregate_properties("PropApp", entity_type=etype, storage=ts)
            _same_maps(got, want)
        got = ts.get_events().aggregate_properties(app_id, entity_type="item",
                                                   required=["categories"])
        assert sorted(got) == ["i1", "i2", "u1"]
        assert sorted(ts.get_events().aggregate_properties(
            app_id, entity_type="user")) == ["u1", "u3"]
        with pytest.raises(ValueError, match="entity_type"):
            ts.get_events().aggregate_properties(app_id)
    finally:
        js.close()
        ts.close()


# -- columnar aggregation --------------------------------------------------------


def _same_indexed(t, j) -> None:
    assert t.user_index.to_dict() == j.user_index.to_dict()
    assert t.item_index.to_dict() == j.item_index.to_dict()
    for name in ("rows", "cols", "vals"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("extra", [(), ("i9", "i3", "x0")])
def test_aggregate_counts_and_from_triples_bit_identical(extra):
    rng = np.random.default_rng(5)
    users = [f"u{j}" for j in range(7)]
    items = [f"i{j}" for j in range(6)]
    rows = rng.integers(0, 7, 80).astype(np.int32)
    cols = rng.integers(0, 6, 80).astype(np.int32)
    vals = np.ones(80, np.float32)
    _same_indexed(
        tcol.aggregate_counts(RatingsBatch(users, items, rows, cols, vals), extra),
        jcol.aggregate_counts(JRatingsBatch(users, items, rows, cols, vals), extra),
    )
    triples = [(users[r], items[c], float(v)) for r, c, v in
               zip(rows[:20], cols[:20], rng.choice([-1.0, 1.0], 20))]
    _same_indexed(tcol.from_triples(triples, extra), jcol.from_triples(triples, extra))
    for fn in (tcol.aggregate_counts, tcol.from_triples):
        with pytest.raises(ValueError, match="zero events"):
            fn(RatingsBatch.empty() if fn is tcol.aggregate_counts else [])


# -- the normalized catalog --------------------------------------------------------


def _jax_factors(storage: str, n_items: int, rank: int, seed: int):
    """(values, scales) as the JAX package's model holds them."""
    import jax.numpy as jnp
    from predictionio_tpu.ops import als as jals

    x = np.random.default_rng(seed).standard_normal((n_items, rank)).astype(np.float32)
    if storage == "int8":
        q, s = jals.quantize_rows(jnp.asarray(x))
        return np.array(q), np.array(s)
    if storage == "bfloat16":
        return np.array(jnp.asarray(x, jnp.bfloat16)), None
    return x, None


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_normalized_device_factors_match_jax(storage):
    values, scales = _jax_factors(storage, 23, 6, 1)
    values[4] = 0  # a zero row: divided by the 1e-12 floor
    jt, jn = jfilters.normalized_device_factors(values, scales)
    tt, tn = tfilters.normalized_device_factors(tmf.host_array(values), scales, CPU)
    assert np.array_equal(tn.numpy().view(np.int32), np.asarray(jn).view(np.int32))
    if storage == "int8":
        assert np.array_equal(tt[0].numpy(), np.asarray(jt[0]))
        assert np.array_equal(tt[1].numpy().view(np.int32), np.asarray(jt[1]).view(np.int32))
    else:
        assert tt.dtype == torch.float32 and np.asarray(jt).dtype == np.float32
        assert np.array_equal(tt.numpy().view(np.int32), np.asarray(jt).view(np.int32))
    ixs = np.array([[0, 5, 7], [3, 0, 0]], np.int32)
    w = np.array([[1, 1, 1], [1, 0, 0]], np.float32)
    np.testing.assert_array_equal(
        tfilters.normalized_query_vectors(tmf.host_array(values), scales, ixs, w),
        jfilters.normalized_query_vectors(values, scales, ixs, w))


# -- a JAX-written model deployed on the port ----------------------------------------

N_ITEMS = 48
QUERIES = [
    {"items": ["i3"], "num": 4},
    {"items": ["i3", "i17", "nope"], "num": 10},
    {"items": ["i5"], "num": 6, "blackList": ["i1", "i2", "i40"]},
    {"items": ["i8"], "num": 5, "categories": ["odd"]},
    {"items": ["i8", "i9"], "num": 7, "categories": ["c3", "none"]},
    {"items": ["i0"], "num": 4, "whiteList": ["i2", "i4", "i6", "i46"]},
    {"items": ["i2"], "num": N_ITEMS + 5},
    {"items": ["zz"], "num": 4},
    {"items": [], "num": 4},
]


def _categories():
    return {f"i{j}": (["even"] if j % 2 == 0 else ["odd"]) + (["c3"] if j % 3 == 0 else [])
            for j in range(N_ITEMS) if j != 11}  # i11 has no categories


def _jax_model(storage: str, values=None, scales=None):
    if values is None:
        values, scales = _jax_factors(storage, N_ITEMS, 8, 2)
    return jsim.SimilarProductModel(
        item_index=JBiMap.from_dense([f"i{j}" for j in range(N_ITEMS)]),
        item_factors=values, categories=_categories(), item_scales=scales)


def _port_model(jm):
    [(_, tm)] = tmf.deserialize(jmf.serialize([("arrays", jm)], "sim"))
    assert type(tm) is sim.SimilarProductModel
    return tm


def _same_answer(got, want) -> None:
    gi = [s.item for s in got.itemScores]
    wi = [s.item for s in want.itemScores]
    gs = np.asarray([s.score for s in got.itemScores], np.float32)
    ws = np.asarray([s.score for s in want.itemScores], np.float32)
    assert len(gi) == len(wi)
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL)
    for p, (a, b) in enumerate(zip(gi, wi)):
        if a != b:  # only near-tied neighbours may swap
            near = [q for q in (p - 1, p + 1) if 0 <= q < len(ws)]
            assert any(abs(ws[q] - ws[p]) <= ATOL + RTOL * abs(ws[p]) for q in near)
    assert set(gi) == set(wi) or len(gi) < len(ws) + 1


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_jax_model_answers_the_same_items_on_the_port(storage):
    jm = _jax_model(storage)
    tm = _port_model(jm)
    jalgo = jsim.ALSAlgorithm(jsim.ALSAlgorithmParams())
    talgo = sim.ALSAlgorithm(sim.ALSAlgorithmParams())
    talgo.device = CPU
    queries = [sim.Query(**q) for q in QUERIES]
    batch = dict(talgo.batch_predict(tm, list(enumerate(queries))))
    for j, q in enumerate(QUERIES):
        want = jalgo.predict(jm, jsim.Query(**q))
        got = talgo.predict(tm, sim.Query(**q))
        _same_answer(got, want)
        # a query alone and inside a batch: the same bytes
        assert tjsonx.dumps_bytes(dataclasses.asdict(batch[j])) == tjsonx.dumps_bytes(
            dataclasses.asdict(got))
        items = [s.item for s in got.itemScores]
        if "blackList" in q:
            assert not set(items) & set(q["blackList"])
        if "whiteList" in q:
            assert set(items) <= set(q["whiteList"])
        if "categories" in q:
            assert all(set(_categories().get(i, ())) & set(q["categories"]) for i in items)
        assert not set(items) & set(q["items"])
    assert talgo.predict(tm, sim.Query(items=["zz"])).itemScores == []
    assert tm.device_norms(CPU).shape == (N_ITEMS,)


def _exact_factors(rng):
    """Rows of one or four entries of +-1 (norm 1 or 2): the normalized
    catalog holds +-1, +-0.5 and 0, so every summed query and score is
    an exact float32 sum, in either package's order."""
    x = np.zeros((N_ITEMS, 8), np.float32)
    for j in range(N_ITEMS):
        n = 1 if j % 3 else 4
        x[j, rng.choice(8, n, replace=False)] = rng.choice([-1.0, 1.0], n)
    return x


def test_nan_rows_serve_the_jax_packages_bytes():
    """A LikeAlgorithm model with dislikes trains NaN rows (see
    tests/test_torch_als.py). Summed with an ALS model's finite scores,
    the served responses are byte for byte the JAX package's (both
    encoders write NaN as the stdlib does)."""
    rng = np.random.default_rng(9)
    als = _exact_factors(rng)
    like = _exact_factors(rng)
    like[[0, 1]] = np.nan
    jms = [_jax_model("float32", als), _jax_model("float32", like)]
    tms = [_port_model(m) for m in jms]
    jalgos = [jsim.ALSAlgorithm(), jsim.LikeAlgorithm()]
    talgos = [sim.ALSAlgorithm(), sim.LikeAlgorithm()]
    for a in talgos:
        a.device = CPU
    jserve, tserve = jsim.SumScoreServing(), sim.SumScoreServing()
    nan_seen = False
    for q in [{"items": ["i2"], "num": 6}, {"items": ["i0"], "num": 4},
              {"items": ["i4", "i1"], "num": 5, "blackList": ["i7"]},
              {"items": ["i2"], "num": 6, "categories": ["even"]}]:
        jq, tq = jsim.Query(**q), sim.Query(**q)
        want = jjsonx.dumps_bytes(dataclasses.asdict(jserve.serve(
            jq, [a.predict(m, jq) for a, m in zip(jalgos, jms)])))
        got = tjsonx.dumps_bytes(dataclasses.asdict(tserve.serve(
            tq, [a.predict(m, tq) for a, m in zip(talgos, tms)])))
        assert got == want
        nan_seen |= b"NaN" in got
    assert nan_seen


# -- the template on the port (tests/test_templates.py:127-237) -------------------------


def _set(entity_type, entity_id, props, minutes):
    return Event(event="$set", entity_type=entity_type, entity_id=entity_id,
                 properties=props, event_time=T0 + timedelta(minutes=minutes))


def _interaction(name, user, item, minutes):
    return Event(event=name, entity_type="user", entity_id=user,
                 target_entity_type="item", target_entity_id=item,
                 event_time=T0 + timedelta(minutes=minutes))


def _seed_events() -> list:
    """12 items of two parities, 30 users viewing items of their own
    parity, and one like and one dislike each."""
    rng = np.random.default_rng(1)
    out, t = [], 0
    for i in range(12):
        out.append(_set("item", f"i{i}", {"categories": ["even" if i % 2 == 0 else "odd"]}, t))
        t += 1
    for u in range(30):
        out.append(_set("user", f"u{u}", {}, t))
        for _ in range(8):
            i = int(rng.integers(0, 6)) * 2 + (u % 2)
            t += 1
            out.append(_interaction("view", f"u{u}", f"i{i}", t))
    for u in range(30):
        out.append(_interaction("like", f"u{u}", f"i{u % 2}", t + 1))
        out.append(_interaction("dislike", f"u{u}", f"i{(u + 1) % 2}", t + 2))
        t += 2
    return out


@pytest.fixture()
def seeded():
    storage = tstorage.test_storage()
    app_id = storage.get_metadata_apps().insert(App(0, "SimApp"))
    storage.get_events().batch_insert(_seed_events(), app_id)
    tstorage.set_storage(storage)
    yield storage
    tstorage.set_storage(None)
    storage.close()


def _ep(algos=("als",)):
    return EngineParams(
        datasource=("", sim.DataSourceParams(app_name="SimApp")),
        algorithms=[(a, sim.ALSAlgorithmParams(rank=6, num_iterations=8, alpha=2.0))
                    for a in algos],
    )


def _read(seeded):
    return sim.SimilarProductDataSource(
        sim.DataSourceParams(app_name="SimApp")).read_training(CTX)


def test_similar_items_same_parity(seeded):
    engine = sim.engine()
    run_train(engine, _ep(), engine_id="sim", storage=seeded, ctx=CTX)
    inst = seeded.get_metadata_engine_instances().get_latest_completed("sim", "0", "default")
    _, [algo], [model], serving = prepare_deploy(engine, inst, storage=seeded, ctx=CTX)
    q = sim.Query(items=["i0"], num=3)
    result = serving.serve(q, [algo.predict(model, q)])
    assert len(result.itemScores) == 3
    assert "i0" not in [s.item for s in result.itemScores]
    parities = [int(s.item[1:]) % 2 for s in result.itemScores]
    assert parities.count(0) >= 2  # mostly even items similar to i0


def test_bf16_storage_through_template(seeded):
    algo = sim.ALSAlgorithm(sim.ALSAlgorithmParams(
        rank=6, num_iterations=8, alpha=2.0,
        compute_dtype="bfloat16", storage_dtype="bfloat16",
    ))
    model = algo.train(CTX, _read(seeded))
    assert model.item_factors.dtype == tmf.BFLOAT16
    algo.device = CPU
    result = algo.predict(model, sim.Query(items=["i0"], num=3))
    assert len(result.itemScores) == 3
    parities = [int(s.item[1:]) % 2 for s in result.itemScores]
    assert parities.count(0) >= 2  # same-parity structure preserved


def test_category_and_blacklist_filters(seeded):
    algo = sim.ALSAlgorithm(sim.ALSAlgorithmParams(rank=4, num_iterations=4))
    model = algo.train(CTX, _read(seeded))
    algo.device = CPU
    result = algo.predict(model, sim.Query(items=["i0"], num=5, categories=["odd"]))
    assert all(int(s.item[1:]) % 2 == 1 for s in result.itemScores)
    items2 = [s.item for s in algo.predict(
        model, sim.Query(items=["i0"], num=5, blackList=["i2", "i4"])).itemScores]
    assert "i2" not in items2 and "i4" not in items2
    items3 = [s.item for s in algo.predict(
        model, sim.Query(items=["i0"], num=5, whiteList=["i2", "i4"])).itemScores]
    assert set(items3) <= {"i2", "i4"}


def test_multi_algorithm_sum_serving(seeded):
    engine = sim.engine()
    ep = _ep(algos=("als", "likealgo"))
    algos = engine.make_algorithms(ep)
    for a in algos:
        a.device = CPU
    models = engine.train(CTX, ep, algorithms=algos)
    serving = engine.make_serving(ep)
    q = sim.Query(items=["i0"], num=4)
    result = serving.serve(q, [a.predict(m, q) for a, m in zip(algos, models)])
    assert len(result.itemScores) <= 4
    scores = [s.score for s in result.itemScores]
    assert scores == sorted(scores, reverse=True)
    # the like/dislike fixture at alpha 2 is indefinite for every user:
    # the rated items train to NaN, as in the JAX package
    like = models[1]
    rated = [like.item_index[i] for i in ("i0", "i1")]
    assert np.isnan(like.item_factors[rated]).all()


def test_unknown_query_items(seeded):
    algo = sim.ALSAlgorithm(sim.ALSAlgorithmParams(rank=4, num_iterations=2))
    model = algo.train(CTX, _read(seeded))
    algo.device = CPU
    assert algo.predict(model, sim.Query(items=["zz"])).itemScores == []
    assert algo.warmup_query(model) == sim.Query(items=[model.item_index.inverse[0]], num=4)


def test_cli_train_and_deploy_on_the_cpu(tmp_path, monkeypatch):
    """events in sqlite -> ``train --device cpu`` -> ``deploy`` over the
    JAX package's factory name, both algorithms; the deployed engine
    answers as its models do, summed by SumScoreServing."""
    import http.client

    for k in [k for k in __import__("os").environ if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    tstorage.set_storage(None)
    storage = tstorage.get_storage()
    app_id = storage.get_metadata_apps().insert(App(0, "SimApp"))
    storage.get_events().batch_insert(_seed_events(), app_id)
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps({
        "id": "sim-port", "engineFactory": "predictionio_tpu.models.similarproduct.engine",
        "datasource": {"params": {"appName": "SimApp"}},
        "algorithms": [
            {"name": "als", "params": {"rank": 6, "numIterations": 4, "alpha": 2.0}},
            {"name": "likealgo", "params": {"rank": 6, "numIterations": 4, "alpha": 0.5}},
        ]}))
    server = None
    try:
        assert tcli.main(["train", "--variant", str(variant), "--device", "cpu"]) == 0
        server = tcli.deploy_server(tcli.build_parser().parse_args([
            "deploy", "--variant", str(variant), "--ip", "127.0.0.1", "--port", "0",
            "--device", "cpu"]))
        assert [type(a).__name__ for a in server.algorithms] == ["ALSAlgorithm",
                                                                  "LikeAlgorithm"]
        assert server.warmup() == 2
        port = server.start(background=True)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        for q in ({"items": ["i0"], "num": 3}, {"items": ["i1"], "num": 4,
                                                "categories": ["odd"]}):
            conn.request("POST", "/queries.json", json.dumps(q).encode(),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            assert resp.status == 200
            want = server.serving.serve(sim.Query(**q), [
                a.predict(m, sim.Query(**q))
                for a, m in zip(server.algorithms, server.models)])
            assert body == tjsonx.dumps_bytes(dataclasses.asdict(want))
        conn.close()
    finally:
        if server is not None:
            server.stop()
        tstorage.set_storage(None)
        storage.close()
