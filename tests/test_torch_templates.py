"""The recommended-user and e-commerce templates, and the similar-product
template's cosine algorithm, on the port against the JAX package's, on
the CPU.

The port's copies of ``tests/test_templates.py``'s ``TestRecommendedUser``
and ``TestECommerce`` cases and ``test_cosine_algorithm_dimsum_variant``
(run on the port alone: the same structural checks), then the two
packages side by side on the same numpy inputs. Tolerances and their
reasons:

- answers on the same factors (models built from one set of arrays):
  the same items, scores within rtol=1e-5, atol=1e-6 (the two sum the
  dot products in different orders), items swapping only inside runs of
  near-tied scores;
- trainings from the same initial factors (the ``warm_start`` seam,
  injected into both packages' ``als_train``): factors within rtol 5e-4 /
  atol 5e-5, the JAX package's own bar for a training;
- the cosine algorithm's neighbor tables on integer view counts: bit
  for bit, ids of ``-inf`` padding included (every sum is exact);
- model files written by one package load in the other with every array
  bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import set_storage as jset_storage
from predictionio_tpu.data.storage import test_storage as jtest_storage
from predictionio_tpu.models import ecommerce as jec
from predictionio_tpu.models import modelfile as jmf
from predictionio_tpu.models import recommendeduser as jru
from predictionio_tpu.models import similarproduct as jsim
from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.core import EngineParams, WorkflowContext
from predictionio_tpu_torch.core.workflow import prepare_deploy, run_train
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data import store as tstore
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App
from predictionio_tpu_torch.models import ecommerce as ec
from predictionio_tpu_torch.models import modelfile as tmf
from predictionio_tpu_torch.models import recommendeduser as ru
from predictionio_tpu_torch.models import similarproduct as sim
from predictionio_tpu_torch.ops import als as tals
from predictionio_tpu_torch.ops import retrieval
from predictionio_tpu_torch.server import jsonx as tjsonx

CPU = torch.device("cpu")
CTX = WorkflowContext(mode="TemplateTest", device="cpu")
RTOL, ATOL = 1e-5, 1e-6


def _set(event_cls, entity_type, entity_id, props):
    return event_cls(event="$set", entity_type=entity_type, entity_id=entity_id,
                     properties=props)


def _interaction(event_cls, name, user, item, target_type="item"):
    return event_cls(event=name, entity_type="user", entity_id=user,
                     target_entity_type=target_type, target_entity_id=item)


def _seed(app_name: str, events_of, backend: str = "memory", tmp_path=None):
    """A port storage (memory, or sqlite + localfs under ``tmp_path``)
    holding ``events_of(Event)`` for a new app, installed as the
    singleton."""
    if backend == "memory":
        storage = tstorage.test_storage()
    else:
        storage = tstorage.Storage(env={"PIO_FS_BASEDIR": str(tmp_path)})
    app_id = storage.get_metadata_apps().insert(App(0, app_name))
    storage.get_events().batch_insert(events_of(Event), app_id)
    tstorage.set_storage(storage)
    return storage, app_id


def _jax_seed(app_name: str, events_of):
    storage = jtest_storage()
    app_id = storage.get_metadata_apps().insert(JApp(0, app_name))
    for e in events_of(JEvent):
        storage.get_events().insert(e, app_id)
    jset_storage(storage)
    return storage


def _same_scores(got, want, key: str) -> None:
    """The same entries (``key`` names them), scores within rtol 1e-5,
    neighbours swapping only inside near ties."""
    gi = [getattr(s, key) for s in got]
    wi = [getattr(s, key) for s in want]
    gs = np.asarray([s.score for s in got], np.float32)
    ws = np.asarray([s.score for s in want], np.float32)
    assert len(gi) == len(wi)
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL)
    for p, (a, b) in enumerate(zip(gi, wi)):
        if a != b:
            near = [q for q in (p - 1, p + 1) if 0 <= q < len(ws)]
            assert any(abs(ws[q] - ws[p]) <= ATOL + RTOL * abs(ws[p]) for q in near)


@pytest.fixture(autouse=True)
def _no_singletons():
    yield
    tstorage.set_storage(None)
    jset_storage(None)


# -- recommended-user ------------------------------------------------------------


def _follow_events(event_cls) -> list:
    """20 users who follow users of their own parity (plus a little
    noise): tests/test_templates.py's fixture."""
    rng = np.random.default_rng(4)
    out = [_set(event_cls, "user", f"u{u}", {}) for u in range(20)]
    for u in range(20):
        for _ in range(6):
            t = int(rng.integers(0, 10)) * 2 + (u % 2)
            if t != u:
                out.append(_interaction(event_cls, "follow", f"u{u}", f"u{t}", "user"))
    return out


class TestRecommendedUser:
    @pytest.fixture()
    def seeded(self):
        storage, _ = _seed("RecUserApp", _follow_events)
        yield storage
        storage.close()

    def ep(self):
        return EngineParams(
            datasource=("", ru.DataSourceParams(app_name="RecUserApp")),
            algorithms=[("als", ru.ALSAlgorithmParams(rank=6, num_iterations=8, alpha=2.0))],
        )

    def test_similar_users_same_parity(self, seeded):
        engine = ru.engine()
        run_train(engine, self.ep(), engine_id="recuser", storage=seeded, ctx=CTX)
        inst = seeded.get_metadata_engine_instances().get_latest_completed(
            "recuser", "0", "default")
        _, [algo], [model], serving = prepare_deploy(engine, inst, storage=seeded, ctx=CTX)
        q = ru.Query(users=["u0"], num=4)
        result = serving.serve(q, [algo.predict(model, q)])
        assert len(result.userScores) == 4
        assert "u0" not in [s.user for s in result.userScores]
        parities = [int(s.user[1:]) % 2 for s in result.userScores]
        assert parities.count(0) >= 3

    def test_white_black_lists(self, seeded):
        algo = ru.ALSAlgorithm(ru.ALSAlgorithmParams(rank=4, num_iterations=4))
        td = ru.RecommendedUserDataSource(
            ru.DataSourceParams(app_name="RecUserApp")).read_training(CTX)
        model = algo.train(CTX, td)
        algo.device = CPU
        white = [s.user for s in algo.predict(
            model, ru.Query(users=["u0"], num=5, whiteList=["u2", "u4"])).userScores]
        assert set(white) <= {"u2", "u4"}
        black = [s.user for s in algo.predict(
            model, ru.Query(users=["u0"], num=5, blackList=["u2"])).userScores]
        assert "u2" not in black
        assert algo.predict(model, ru.Query(users=["zz"])).userScores == []
        assert algo.warmup_query(model) == ru.Query(
            users=[model.followed_index.inverse[0]], num=4)

    def test_sharded_train_is_refused(self, seeded):
        algo = ru.ALSAlgorithm(ru.ALSAlgorithmParams(sharded_train=True))
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            algo.train(CTX, ru.TrainingData())


# -- e-commerce --------------------------------------------------------------------


def _ecom_events(event_cls) -> list:
    """tests/test_templates.py's fixture: 10 items in two categories, 20
    users viewing items of their parity's category."""
    rng = np.random.default_rng(2)
    out = [_set(event_cls, "item", f"i{i}", {"categories": ["cat-a" if i < 5 else "cat-b"]})
           for i in range(10)]
    for u in range(20):
        out.append(_set(event_cls, "user", f"u{u}", {}))
        for _ in range(6):
            i = int(rng.integers(0, 5)) + (0 if u % 2 == 0 else 5)
            out.append(_interaction(event_cls, "view", f"u{u}", f"i{i}"))
    return out


def _ecom_algo(**kw):
    params = dict(app_name="EcomApp", rank=4, num_iterations=4, unseen_only=False)
    params.update(kw)
    algo = ec.ECommAlgorithm(ec.ECommAlgorithmParams(**params))
    algo.device = CPU
    return algo


def _ecom_read():
    return ec.ECommerceDataSource(ec.DataSourceParams(app_name="EcomApp")).read_training(CTX)


class TestECommerce:
    @pytest.fixture()
    def seeded(self):
        storage, app_id = _seed("EcomApp", _ecom_events)
        yield storage, app_id
        storage.close()

    @pytest.fixture()
    def seeded_sqlite(self, tmp_path):
        storage, app_id = _seed("EcomApp", _ecom_events, "sqlite", tmp_path)
        yield storage, app_id
        storage.close()

    def ep(self, **kw):
        defaults = dict(app_name="EcomApp", rank=6, num_iterations=8, alpha=2.0,
                        unseen_only=False)
        defaults.update(kw)
        return EngineParams(
            datasource=("", ec.DataSourceParams(app_name="EcomApp")),
            algorithms=[("als", ec.ECommAlgorithmParams(**defaults))],
        )

    def test_personalized_recommendations(self, seeded):
        storage, _ = seeded
        engine = ec.engine()
        run_train(engine, self.ep(), engine_id="ecom", storage=storage, ctx=CTX)
        inst = storage.get_metadata_engine_instances().get_latest_completed(
            "ecom", "0", "default")
        _, [algo], [model], serving = prepare_deploy(engine, inst, storage=storage, ctx=CTX)
        q = ec.Query(user="u0", num=3)
        result = serving.serve(q, [algo.predict(model, q)])
        assert len(result.itemScores) == 3
        # even users view items 0-4 (cat-a)
        assert all(int(s.item[1:]) < 5 for s in result.itemScores)

    def test_unseen_only_filters_seen(self, seeded):
        td = _ecom_read()
        algo = _ecom_algo(unseen_only=True)
        model = algo.train(CTX, td)
        ev = td.view_events
        seen = {ev.target_ids[c] for r, c in zip(ev.rows, ev.cols) if ev.entity_ids[r] == "u0"}
        result = algo.predict(model, ec.Query(user="u0", num=10))
        assert seen.isdisjoint({s.item for s in result.itemScores})

    def test_unavailable_items_live_constraint(self, seeded):
        storage, app_id = seeded
        algo = _ecom_algo()
        model = algo.train(CTX, _ecom_read())
        before = {s.item for s in algo.predict(model, ec.Query(user="u0", num=5)).itemScores}
        ban = sorted(before)[:2]
        storage.get_events().insert(
            Event(event="$set", entity_type="constraint", entity_id="unavailableItems",
                  properties={"items": ban}), app_id)
        after = {s.item for s in algo.predict(model, ec.Query(user="u0", num=5)).itemScores}
        assert not set(ban) & after

    def test_weights_groups_boost(self, seeded):
        td = _ecom_read()
        base_algo = _ecom_algo()
        model = base_algo.train(CTX, td)
        base = base_algo.predict(model, ec.Query(user="u0", num=10))
        positive = [s for s in base.itemScores if s.score > 0]
        assert len(positive) >= 2
        target = positive[-1].item
        boosted_algo = _ecom_algo(weights=[{"items": [target], "weight": 100.0}])
        boosted = boosted_algo.predict(model, ec.Query(user="u0", num=10))
        assert boosted.itemScores[0].item == target

    @pytest.mark.parametrize("backend", ["memory", "sqlite"])
    def test_live_filter_cache_hits_without_store_reads(self, backend, tmp_path,
                                                         monkeypatch):
        """On a static store, repeat queries serve the seen/unavailable
        filters from the change-token cache -- zero event-store reads --
        and any write drops the cache; on the sqlite store the token is
        its (data_version, total_changes, ddl_bump) triple."""
        storage, app_id = _seed("EcomApp", _ecom_events, backend, tmp_path)
        try:
            algo = _ecom_algo(unseen_only=True)
            model = algo.train(CTX, _ecom_read())
            algo.predict(model, ec.Query(user="u0", num=5))  # warm the cache
            calls = []
            real = tstore.find_by_entity

            def counting(*a, **kw):
                calls.append(kw.get("entity_type"))
                return real(*a, **kw)

            monkeypatch.setattr(tstore, "find_by_entity", counting)
            r1 = algo.predict(model, ec.Query(user="u0", num=5))
            assert calls == [], f"cached serving still read the store: {calls}"
            ban = [r1.itemScores[0].item]
            storage.get_events().insert(
                Event(event="$set", entity_type="constraint", entity_id="unavailableItems",
                      properties={"items": ban}), app_id)
            r2 = algo.predict(model, ec.Query(user="u0", num=5))
            assert calls, "post-write serving must re-read the live filters"
            assert ban[0] not in {s.item for s in r2.itemScores}
            if backend == "sqlite":  # one read per user per token
                assert calls.count("user") == 1
        finally:
            storage.close()

    def test_sqlite_change_token_moves_on_every_write(self, seeded_sqlite):
        storage, app_id = seeded_sqlite
        events = storage.get_events()
        tokens = [events.change_token(app_id)]
        assert tokens[0] == events.change_token(app_id)  # static: stable
        eid = events.insert(_interaction(Event, "view", "u0", "i1"), app_id)
        tokens.append(events.change_token(app_id))
        events.delete(eid, app_id)
        tokens.append(events.change_token(app_id))
        events.remove(app_id)
        tokens.append(events.change_token(app_id))
        assert len(set(tokens)) == 4
        assert tstore.change_token("EcomApp") == tokens[-1]
        assert events.entity_indexed

    def test_memory_change_token_and_replay_seen_scan(self, seeded, monkeypatch):
        storage, app_id = seeded
        events = storage.get_events()
        assert not events.entity_indexed
        t0 = events.change_token(app_id)
        events.insert(_interaction(Event, "view", "u1", "i2"), app_id)
        assert events.change_token(app_id) != t0
        algo = _ecom_algo(unseen_only=True)
        model = algo.train(CTX, _ecom_read())
        scans = []
        real = tstore.find
        monkeypatch.setattr(tstore, "find", lambda *a, **kw: scans.append(
            (kw.get("entity_type"), kw.get("entity_id"))) or real(*a, **kw))
        for u in ("u0", "u1", "u2", "u3"):
            algo.predict(model, ec.Query(user=u, num=3))
        # one replay serves every user's seen set; one constraint read
        assert sorted(scans, key=str) == [("constraint", "unavailableItems"), ("user", None)]

    def test_cold_start_user_via_recent_views(self, seeded):
        storage, app_id = seeded
        algo = _ecom_algo()
        model = algo.train(CTX, _ecom_read())
        for i in range(3):
            storage.get_events().insert(_interaction(Event, "view", "newbie", f"i{i}"), app_id)
        result = algo.predict(model, ec.Query(user="newbie", num=3))
        assert len(result.itemScores) == 3
        assert algo.predict(model, ec.Query(user="ghost")).itemScores == []

    def test_ecommerce_algorithm_opts_out_of_the_query_cache(self):
        algo = ec.ECommAlgorithm(ec.ECommAlgorithmParams(app_name="x"))
        assert algo.cacheable_query(ec.Query(user="u1")) is False


# -- the similar-product template's cosine algorithm -------------------------------


def _view_events(event_cls) -> list:
    """tests/test_templates.py's similar-product fixture: users view items
    of their own parity."""
    rng = np.random.default_rng(1)
    out = [_set(event_cls, "item", f"i{i}", {"categories": ["even" if i % 2 == 0 else "odd"]})
           for i in range(12)]
    for u in range(30):
        out.append(_set(event_cls, "user", f"u{u}", {}))
        for _ in range(8):
            i = int(rng.integers(0, 6)) * 2 + (u % 2)
            out.append(_interaction(event_cls, "view", f"u{u}", f"i{i}"))
    return out


def test_cosine_algorithm_dimsum_variant():
    storage, _ = _seed("SimApp", _view_events)
    try:
        algo = sim.CosineAlgorithm(sim.CosineAlgorithmParams(top_n=8))
        td = sim.SimilarProductDataSource(sim.DataSourceParams(app_name="SimApp")
                                          ).read_training(CTX)
        model = algo.train(CTX, td)
        result = algo.predict(model, sim.Query(items=["i0"], num=3))
        assert len(result.itemScores) == 3
        assert "i0" not in [s.item for s in result.itemScores]
        parities = [int(s.item[1:]) % 2 for s in result.itemScores]
        assert parities.count(0) >= 2
        black = [s.item for s in algo.predict(
            model, sim.Query(items=["i0"], num=5, blackList=["i2"])).itemScores]
        assert "i2" not in black
        assert algo.predict(model, sim.Query(items=["zz"])).itemScores == []
    finally:
        storage.close()


def test_cosine_algorithm_matches_the_jax_package():
    """The same events through both packages' CosineAlgorithm: the
    neighbor tables bit for bit (integer view counts: every sum exact),
    and the same answers through each package's host loop."""
    storage, _ = _seed("SimApp", _view_events)
    jstorage = _jax_seed("SimApp", _view_events)
    try:
        jctx = __import__("predictionio_tpu.core", fromlist=["WorkflowContext"]
                          ).WorkflowContext(mode="TemplateTest")
        for top_n in (1, 5, 20):
            jalgo = jsim.CosineAlgorithm(jsim.CosineAlgorithmParams(top_n=top_n))
            jm = jalgo.train(jctx, jsim.SimilarProductDataSource(
                jsim.DataSourceParams(app_name="SimApp")).read_training(jctx))
            talgo = sim.CosineAlgorithm(sim.CosineAlgorithmParams(top_n=top_n))
            tm = talgo.train(CTX, sim.SimilarProductDataSource(
                sim.DataSourceParams(app_name="SimApp")).read_training(CTX))
            assert list(tm.item_index.items()) == list(jm.item_index.items())
            np.testing.assert_array_equal(tm.sim_scores.view(np.int32),
                                          np.asarray(jm.sim_scores).view(np.int32))
            np.testing.assert_array_equal(tm.sim_ids, np.asarray(jm.sim_ids))
            for q in ({"items": ["i0"], "num": 4}, {"items": ["i1", "i3"], "num": 6},
                      {"items": ["i2"], "num": 5, "categories": ["odd"]},
                      {"items": ["i4"], "num": 3, "whiteList": ["i0", "i6", "i8"]}):
                got = talgo.predict(tm, sim.Query(**q))
                want = jalgo.predict(jm, jsim.Query(**q))
                assert tjsonx.dumps_bytes(dataclasses.asdict(got)) == tjsonx.dumps_bytes(
                    dataclasses.asdict(want))
    finally:
        storage.close()
        jstorage.close()


# -- the same factors, and the same training, in both packages ---------------------


def _factors(n: int, d: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _int8(n: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (n, d)).astype(np.int8),
            rng.uniform(0.001, 0.02, n).astype(np.float32))


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_recommendeduser_answers_equal_the_jax_packages(storage):
    n = 60
    ids = [f"u{j}" for j in range(n)]
    vals, scales = (_factors(n, 6, 3), None) if storage == "float32" else _int8(n, 6, 3)
    jm = jru.RecommendedUserModel(followed_index=JBiMap.from_dense(ids),
                                  followed_factors=vals, followed_scales=scales)
    [(_, tm)] = tmf.deserialize(jmf.serialize([("arrays", jm)], "ru"))
    assert type(tm) is ru.RecommendedUserModel
    jalgo = jru.ALSAlgorithm(jru.ALSAlgorithmParams())
    talgo = ru.ALSAlgorithm(ru.ALSAlgorithmParams())
    talgo.device = CPU
    queries = [{"users": ["u0"], "num": 5}, {"users": ["u1", "u7"], "num": 8},
               {"users": ["u2"], "num": 4, "blackList": ["u3", "u4"]},
               {"users": ["u5"], "num": 6, "whiteList": [f"u{j}" for j in range(0, 40, 3)]},
               {"users": ["u9"], "num": n + 4}, {"users": ["zz"], "num": 3}]
    batch = dict(talgo.batch_predict(tm, [(j, ru.Query(**q)) for j, q in enumerate(queries)]))
    for j, q in enumerate(queries):
        got = talgo.predict(tm, ru.Query(**q))
        _same_scores(got.userScores, jalgo.predict(jm, jru.Query(**q)).userScores, "user")
        assert tjsonx.dumps_bytes(dataclasses.asdict(batch[j])) == tjsonx.dumps_bytes(
            dataclasses.asdict(got))


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_ecommerce_answers_equal_the_jax_packages(storage):
    nu, ni = 12, 80
    users, items = [f"u{j}" for j in range(nu)], [f"i{j}" for j in range(ni)]
    if storage == "float32":
        uf, us, vf, vs = _factors(nu, 6, 5), None, _factors(ni, 6, 6), None
    else:
        (uf, us), (vf, vs) = _int8(nu, 6, 5), _int8(ni, 6, 6)
    cats = {f"i{j}": ["c0" if j % 2 else "c1"] for j in range(ni)}
    jm = jec.ECommModel(user_index=JBiMap.from_dense(users), item_index=JBiMap.from_dense(items),
                        user_factors=uf, item_factors=vf, categories=cats,
                        user_scales=us, item_scales=vs)
    [(_, tm)] = tmf.deserialize(jmf.serialize([("arrays", jm)], "ec"))
    assert type(tm) is ec.ECommModel
    weights = [{"items": ["i3", "i9"], "weight": 3.0}, {"items": ["i10"], "weight": 0.5}]
    jalgo = jec.ECommAlgorithm(jec.ECommAlgorithmParams(unseen_only=False, weights=weights))
    talgo = ec.ECommAlgorithm(ec.ECommAlgorithmParams(unseen_only=False, weights=weights))
    talgo.device = CPU
    queries = [{"user": "u0", "num": 5}, {"user": "u1", "num": 7, "blackList": ["i3"]},
               {"user": "u2", "num": 4, "categories": ["c0"]},
               {"user": "u3", "num": 3, "whiteList": ["i1", "i2", "i9", "i40"]},
               {"user": "u4", "num": ni + 3}]
    # no app: the live filters are off in both (their store reads fail
    # and are logged), so the answers are the model's alone
    batch = dict(talgo.batch_predict(tm, [(j, ec.Query(**q)) for j, q in enumerate(queries)]))
    for j, q in enumerate(queries):
        got = talgo.predict(tm, ec.Query(**q))
        _same_scores(got.itemScores, jalgo.predict(jm, jec.Query(**q)).itemScores, "item")
        assert tjsonx.dumps_bytes(dataclasses.asdict(batch[j])) == tjsonx.dumps_bytes(
            dataclasses.asdict(got))


def _warm_starts(monkeypatch, U0, V0):
    """Both packages' template trainings start from (U0, V0)."""
    from predictionio_tpu.parallel import als_sharded

    def jax_train(data, params, ctx, sharded=False):
        return jals.als_train(data, params, warm_start=(U0, V0))

    real = tals.als_train
    monkeypatch.setattr(als_sharded, "train_for_context", jax_train)
    monkeypatch.setattr(tals, "als_train", lambda data, params, device=None: real(
        data, params, warm_start=(U0, V0), device=device))


def test_recommendeduser_training_matches_the_jax_package(monkeypatch):
    storage, _ = _seed("RecUserApp", _follow_events)
    jstorage = _jax_seed("RecUserApp", _follow_events)
    try:
        _warm_starts(monkeypatch, _factors(20, 4, 7) * 0.3, _factors(20, 4, 8) * 0.3)
        from predictionio_tpu.core import WorkflowContext as JCtx

        params = dict(rank=4, num_iterations=3, alpha=2.0)
        jm = jru.ALSAlgorithm(jru.ALSAlgorithmParams(**params)).train(
            JCtx(mode="TemplateTest"), jru.RecommendedUserDataSource(
                jru.DataSourceParams(app_name="RecUserApp")).read_training(None))
        talgo = ru.ALSAlgorithm(ru.ALSAlgorithmParams(**params))
        tm = talgo.train(CTX, ru.RecommendedUserDataSource(
            ru.DataSourceParams(app_name="RecUserApp")).read_training(CTX))
        assert list(tm.followed_index.items()) == list(jm.followed_index.items())
        np.testing.assert_allclose(tm.followed_factors, np.asarray(jm.followed_factors),
                                   rtol=5e-4, atol=5e-5)
        talgo.device = CPU
        jalgo = jru.ALSAlgorithm(jru.ALSAlgorithmParams(**params))
        for q in ({"users": ["u0"], "num": 4}, {"users": ["u3", "u5"], "num": 6}):
            got = talgo.predict(tm, ru.Query(**q)).userScores
            want = jalgo.predict(jm, jru.Query(**q)).userScores
            assert [s.user for s in got][:2] == [s.user for s in want][:2]
            np.testing.assert_allclose([s.score for s in got], [s.score for s in want],
                                       rtol=5e-3, atol=5e-4)
    finally:
        storage.close()
        jstorage.close()


def test_ecommerce_training_matches_the_jax_package(monkeypatch):
    storage, _ = _seed("EcomApp", _ecom_events)
    jstorage = _jax_seed("EcomApp", _ecom_events)
    try:
        _warm_starts(monkeypatch, _factors(20, 4, 9) * 0.3, _factors(10, 4, 10) * 0.3)
        from predictionio_tpu.core import WorkflowContext as JCtx

        params = dict(app_name="EcomApp", rank=4, num_iterations=3, unseen_only=True)
        jalgo = jec.ECommAlgorithm(jec.ECommAlgorithmParams(**params))
        jm = jalgo.train(JCtx(mode="TemplateTest"), jec.ECommerceDataSource(
            jec.DataSourceParams(app_name="EcomApp")).read_training(None))
        talgo = ec.ECommAlgorithm(ec.ECommAlgorithmParams(**params))
        tm = talgo.train(CTX, _ecom_read())
        for name in ("user_factors", "item_factors"):
            np.testing.assert_allclose(getattr(tm, name), np.asarray(getattr(jm, name)),
                                       rtol=5e-4, atol=5e-5)
        talgo.device = CPU
        for q in ({"user": "u0", "num": 3}, {"user": "u1", "num": 4}):
            got = talgo.predict(tm, ec.Query(**q)).itemScores
            want = jalgo.predict(jm, jec.Query(**q)).itemScores
            # the live seen filter read from each package's own store
            assert {s.item for s in got} == {s.item for s in want}
            np.testing.assert_allclose(sorted(s.score for s in got),
                                       sorted(s.score for s in want), rtol=5e-3, atol=5e-4)
    finally:
        storage.close()
        jstorage.close()


# -- two-stage branches (tests/test_retrieval.py:362, :382) --------------------------


def _same_results(a, b) -> None:
    for (ia, ra), (ib, rb) in zip(a, b):
        assert ia == ib
        assert tjsonx.dumps_bytes(dataclasses.asdict(ra)) == tjsonx.dumps_bytes(
            dataclasses.asdict(rb))


def test_two_stage_recommendeduser(monkeypatch):
    n = 512
    vq, vs = _int8(n, 8, 24)
    model = ru.RecommendedUserModel(followed_index=BiMap.from_dense([f"u{j}" for j in range(n)]),
                                    followed_factors=vq, followed_scales=vs)
    algo = ru.ALSAlgorithm(ru.ALSAlgorithmParams())
    algo.device = CPU
    queries = [(0, ru.Query(users=["u0", "u1"], num=5)),
               (1, ru.Query(users=["u2"], num=4, blackList=["u5", "u6"]))]
    exact = algo.batch_predict(model, queries)
    monkeypatch.setenv("PIO_RETRIEVAL_THRESHOLD", "64")
    monkeypatch.setenv("PIO_RETRIEVAL_TILE", "128")
    before = retrieval.stats_block()["two_stage_queries"]
    two = algo.batch_predict(model, queries)
    assert retrieval.stats_block()["two_stage_queries"] > before
    _same_results(exact, two)
    jm = jru.RecommendedUserModel(followed_index=JBiMap.from_dense([f"u{j}" for j in range(n)]),
                                  followed_factors=vq, followed_scales=vs)
    jtwo = jru.ALSAlgorithm(jru.ALSAlgorithmParams()).batch_predict(
        jm, [(i, jru.Query(**dataclasses.asdict(q))) for i, q in queries])
    for (_, got), (_, want) in zip(two, jtwo):
        _same_scores(got.userScores, want.userScores, "user")


def test_two_stage_ecommerce(monkeypatch):
    n = 512
    users, items = [f"u{j}" for j in range(8)], [f"i{j}" for j in range(n)]
    uf, vf = _factors(8, 8, 25), _factors(n, 8, 26)
    cats = {f"i{j}": ["c0"] for j in range(0, n, 2)}
    model = ec.ECommModel(user_index=BiMap.from_dense(users), item_index=BiMap.from_dense(items),
                          user_factors=uf, item_factors=vf, categories=cats)
    algo = _ecom_algo(app_name="")
    queries = [(0, ec.Query(user="u0", num=5)), (1, ec.Query(user="u1", num=4, blackList=["i3"])),
               (2, ec.Query(user="u2", num=3, categories=["c0"]))]  # complex
    exact = algo.batch_predict(model, queries)
    monkeypatch.setenv("PIO_RETRIEVAL_THRESHOLD", "64")
    monkeypatch.setenv("PIO_RETRIEVAL_TILE", "128")
    before = retrieval.stats_block()["exact_queries"]
    two = algo.batch_predict(model, queries)
    # the categories query stays on the exact masked path, counted
    assert retrieval.stats_block()["exact_queries"] > before
    _same_results(exact, two)
    jm = jec.ECommModel(user_index=JBiMap.from_dense(users), item_index=JBiMap.from_dense(items),
                        user_factors=uf, item_factors=vf, categories=cats)
    jtwo = jec.ECommAlgorithm(jec.ECommAlgorithmParams(unseen_only=False)).batch_predict(
        jm, [(i, jec.Query(**dataclasses.asdict(q))) for i, q in queries])
    for (_, got), (_, want) in zip(two, jtwo):
        _same_scores(got.itemScores, want.itemScores, "item")


# -- model files across the packages ---------------------------------------------


def _models(jax: bool):
    """One model of each new class from the same arrays, as either
    package builds it."""
    bm = JBiMap.from_dense if jax else BiMap.from_dense
    mods = (jru, jec, jsim) if jax else (ru, ec, sim)
    vq, vs = _int8(30, 5, 1)
    sims = np.sort(np.random.default_rng(2).random((30, 4)).astype(np.float32), axis=1)[:, ::-1]
    sims[3] = -np.inf  # an item with no neighbors
    return [
        mods[0].RecommendedUserModel(followed_index=bm([f"u{j}" for j in range(30)]),
                                     followed_factors=vq, followed_scales=vs),
        mods[1].ECommModel(user_index=bm([f"u{j}" for j in range(7)]),
                           item_index=bm([f"i{j}" for j in range(30)]),
                           user_factors=_factors(7, 5, 3), item_factors=_factors(30, 5, 4),
                           categories={"i1": ["a", "b"], "i2": []}),
        mods[2].CosineModel(item_index=bm([f"i{j}" for j in range(30)]),
                            sim_scores=np.ascontiguousarray(sims),
                            sim_ids=np.arange(120, dtype=np.int32).reshape(30, 4) % 30,
                            categories={"i0": ["x"], "i5": ["y", "z"]}),
    ]


def _same_model(a, b) -> None:
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert np.asarray(y).dtype == x.dtype
            np.testing.assert_array_equal(np.asarray(y).view(np.uint8), x.view(np.uint8))
        elif f.name.endswith("index"):
            assert list(x.items()) == list(y.items())
        else:
            assert x == y


@pytest.mark.parametrize("which", [0, 1, 2], ids=["recommendeduser", "ecommerce", "cosine"])
def test_model_files_cross_the_packages(which):
    jm, tm = _models(True)[which], _models(False)[which]
    [(_, back)] = tmf.deserialize(jmf.serialize([("arrays", jm)], "m"))
    assert type(back) is type(tm)
    _same_model(tm, back)
    [(_, jback)] = jmf.deserialize(tmf.serialize([("arrays", tm)], "m"))
    assert type(jback) is type(jm)
    _same_model(jm, jback)
    # the port records the JAX package's class name
    assert tmf.serialize([("arrays", tm)], "m") == jmf.serialize([("arrays", jm)], "m")


# -- the CLI on the JAX package's factory names -------------------------------------

CLI_CASES = {
    "recommendeduser": ("predictionio_tpu.models.recommendeduser.engine", _follow_events,
                        [{"name": "als", "params": {"rank": 4, "numIterations": 3}}],
                        [{"users": ["u0"], "num": 3}, {"users": ["u1"], "num": 2,
                                                       "blackList": ["u3"]}]),
    "ecommerce": ("predictionio_tpu.models.ecommerce.engine", _ecom_events,
                  [{"name": "als", "params": {"appName": "CliApp", "rank": 4,
                                              "numIterations": 3}}],
                  [{"user": "u0", "num": 3}, {"user": "u1", "num": 2, "categories": ["cat-a"]}]),
    "cosine": ("predictionio_tpu.models.similarproduct.engine", _view_events,
               [{"name": "cosine", "params": {"topN": 5}}],
               [{"items": ["i0"], "num": 3}, {"items": ["i1", "i3"], "num": 2}]),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_train_and_deploy_on_the_cpu(case, tmp_path, monkeypatch):
    """events in sqlite -> ``train --device cpu`` -> ``deploy`` of each
    engine through the JAX package's factory name (mapped to the port);
    the deployed engine answers as its model does in process."""
    import http.client
    import json
    import os

    from predictionio_tpu_torch.cli import main as tcli

    factory, events_of, algos, queries = CLI_CASES[case]
    for k in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    tstorage.set_storage(None)
    storage = tstorage.get_storage()
    app_id = storage.get_metadata_apps().insert(App(0, "CliApp"))
    storage.get_events().batch_insert(events_of(Event), app_id)
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps({"id": f"{case}-port", "engineFactory": factory,
                                   "datasource": {"params": {"appName": "CliApp"}},
                                   "algorithms": algos}))
    server = None
    try:
        assert tcli.main(["train", "--variant", str(variant), "--device", "cpu"]) == 0
        server = tcli.deploy_server(tcli.build_parser().parse_args([
            "deploy", "--variant", str(variant), "--ip", "127.0.0.1", "--port", "0",
            "--device", "cpu"]))
        assert server.warmup() == 1
        port = server.start(background=True)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        query_cls = server.algorithms[0].query_class
        for q in queries:
            conn.request("POST", "/queries.json", json.dumps(q).encode(),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            assert resp.status == 200
            want = server.serving.serve(query_cls(**q), [
                server.algorithms[0].predict(server.models[0], query_cls(**q))])
            assert body == tjsonx.dumps_bytes(dataclasses.asdict(want))
            assert json.loads(body)[next(iter(json.loads(body)))]  # a non-empty answer
        conn.close()
    finally:
        if server is not None:
            server.stop()
        tstorage.set_storage(None)
        storage.close()
