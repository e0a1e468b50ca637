"""The port's speed layer (``predictionio_tpu_torch/realtime/``) on the
CPU, on its sqlite and memory stores, held against the JAX package.

The port's cases of ``tests/test_realtime.py``: ``TestTailerDurability``
and ``TestSeqBackendTails`` (seq mode), the fold-in cases
(``test_foldin_parity_vs_retrain`` on unsharded rows, ``..._requantizes``,
``..._cold_item_stats``), ``TestEpochFence``, ``TestSpeedLayerEndToEnd``
(the port's ``EngineServer`` on a real socket; events written to the
store, the port having no event server yet), ``TestQueryCacheEpochFence``,
``TestCursorCorruptionRecovery`` and ``TestFoldInCircuitBreaker``; and
the two speed-layer cases of ``tests/test_slo.py``. The files mode and
the columnar tail and fold on the jsonl and partitioned stores are in
``tests/test_torch_realtime_files.py``.

Against the JAX package: one model (``model_from_numpy``) and the same
events in both packages' stores give the same fold -- user order,
``users_added``, cold items -- with solved rows within rtol 5e-4 / atol
5e-5 for f32 and one storage quantum for bf16 and int8; the port's
grouped fold layout against the JAX package's one padded bucket through
K1's plain version; a tailer cursor either package wrote, resumed by the
other, on a sqlite store either package writes.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from predictionio_tpu_torch import faults
from predictionio_tpu_torch.common.breaker import CircuitBreaker
from predictionio_tpu_torch.core import EngineParams
from predictionio_tpu_torch.core.context import WorkflowContext
from predictionio_tpu_torch.core.workflow import prepare_deploy, run_train
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.models import recommendation as rec
from predictionio_tpu_torch.obs import freshness
from predictionio_tpu_torch.obs import metrics as obs_metrics
from predictionio_tpu_torch.ops import als as als_ops
from predictionio_tpu_torch.realtime import (
    ALSFoldIn,
    EventTailer,
    FoldInConfig,
    SpeedLayer,
)
from predictionio_tpu_torch.realtime import foldin as foldin_mod
from predictionio_tpu_torch.server import jsonx
from predictionio_tpu_torch.server.engine_server import EngineServer

CPU = WorkflowContext(mode="Training", device="cpu")


def _rate(uid, iid, rating, event="rate", **kw):
    return Event(
        event=event,
        entity_type="user",
        entity_id=uid,
        target_entity_type="item",
        target_entity_id=iid,
        properties={"rating": float(rating)},
        **kw,
    )


def http(method, url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=15) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _raw_post(url: str, payload: dict) -> bytes:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=15) as resp:
        return resp.read()


# -- stores ------------------------------------------------------------------------


def _sqlite_events(tmp_path):
    from predictionio_tpu_torch.data.storage.sqlite import SQLiteEvents, SQLiteStorageClient

    return SQLiteEvents(SQLiteStorageClient({"path": str(tmp_path / "ev.db")}))


def _memory_events(tmp_path):
    from predictionio_tpu_torch.data.storage.memory import MemoryEvents, MemoryStorageClient

    return MemoryEvents(MemoryStorageClient({}))


BACKENDS = {"sqlite": _sqlite_events, "memory": _memory_events}


def _storage(kind: str, tmp_path) -> tstorage.Storage:
    if kind == "memory":
        return tstorage.test_storage()
    return tstorage.Storage(env={"PIO_FS_BASEDIR": str(tmp_path / "store")})


def _app(storage, name: str) -> int:
    app_id = storage.get_metadata_apps().insert(tstorage.App(0, name))
    storage.get_events().init(app_id)
    return app_id


@pytest.fixture(params=sorted(BACKENDS))
def kind(request):
    return request.param


@pytest.fixture()
def storage(kind, tmp_path):
    s = _storage(kind, tmp_path)
    tstorage.set_storage(s)
    yield s
    tstorage.set_storage(None)
    s.close()


# ---------------------------------------------------------------------------
# tailer cursor durability
# ---------------------------------------------------------------------------


class TestTailerDurability:
    APP = 7

    @pytest.fixture(params=sorted(BACKENDS))
    def events(self, request, tmp_path):
        return BACKENDS[request.param](tmp_path)

    def test_attaches_at_end(self, events, tmp_path):
        # pre-deploy history belongs to the batch layer, not the tailer
        events.insert(_rate("old", "i0", 1), self.APP)
        t = EventTailer(events, self.APP, cursor_path=tmp_path / "cursor.json")
        assert t.mode == "seq"
        assert t.poll() == []
        events.insert(_rate("u1", "i1", 5), self.APP)
        assert [e.entity_id for e in t.poll()] == ["u1"]
        assert t.poll() == []

    def test_restart_mid_log_resumes_exactly(self, events, tmp_path):
        cursor = tmp_path / "cursor.json"
        t = EventTailer(events, self.APP, cursor_path=cursor)
        for k in range(10):
            events.insert(_rate(f"u{k}", "i1", 5), self.APP)
        first = t.poll(limit=4)
        assert len(first) == 4
        # process restart: a NEW tailer from the persisted cursor must
        # deliver the remaining 6 -- no double-counting, no skipping
        t2 = EventTailer(events, self.APP, cursor_path=cursor)
        rest = t2.poll()
        assert len(rest) == 6
        got = {e.entity_id for e in first} | {e.entity_id for e in rest}
        assert got == {f"u{k}" for k in range(10)}
        assert t2.poll() == []
        assert t2.events_behind() == 0

    def test_batches_respect_limit(self, events, tmp_path):
        t = EventTailer(events, self.APP, batch_limit=3)
        for k in range(8):
            events.insert(_rate(f"u{k}", "i1", 5), self.APP)
        sizes, total = [], []
        while True:
            got = t.poll()
            if not got:
                break
            sizes.append(len(got))
            total.extend(got)
        assert all(s <= 3 for s in sizes)
        assert {e.entity_id for e in total} == {f"u{k}" for k in range(8)}

    def test_duplicate_ids_not_redelivered(self, events, tmp_path):
        t = EventTailer(events, self.APP)
        eid = events.insert(_rate("u1", "i1", 5), self.APP)
        assert len(t.poll()) == 1
        # replace the same event id: the tailer has already delivered it
        events.insert(_rate("u1", "i1", 2, event_id=eid), self.APP)
        assert t.poll() == []

    def test_poll_columnar_wraps_the_object_poll(self, events, tmp_path):
        """On seq stores the JAX tailer's columnar poll delivers one Event
        segment; the port's does the same."""
        t = EventTailer(events, self.APP)
        assert t.poll_columnar().n_events == 0
        events.insert(_rate("u1", "i1", 5), self.APP)
        batch = t.poll_columnar()
        assert batch.n_events == 1 and isinstance(batch.segments[0], list)
        assert len(batch.creation_timestamps()) == 1


class TestSeqBackendTails:
    """tail_events/tail_end contract on the seq-ordered backends."""

    APP = 3

    def test_sqlite_rowid_tail(self, tmp_path):
        events = _sqlite_events(tmp_path)
        assert events.tail_end(self.APP) == 0  # missing table
        assert events.tail_events(self.APP, after=0) == ([], 0)
        events.insert(_rate("u1", "i1", 5), self.APP)
        events.insert(_rate("u2", "i2", 4), self.APP)
        end = events.tail_end(self.APP)
        assert end == 2
        got, cur = events.tail_events(self.APP, after=0, limit=1)
        assert [e.entity_id for e in got] == ["u1"] and cur == 1
        got, cur = events.tail_events(self.APP, after=cur)
        assert [e.entity_id for e in got] == ["u2"] and cur == end

    def test_memory_seq_tail(self, tmp_path):
        events = _memory_events(tmp_path)
        events.insert(_rate("u1", "i1", 5), self.APP)
        end = events.tail_end(self.APP)
        got, cur = events.tail_events(self.APP, after=0)
        assert [e.entity_id for e in got] == ["u1"] and cur == end
        assert events.tail_events(self.APP, after=cur) == ([], cur)
        # a deleted event is skipped, a replaced one comes back current
        eid = events.insert(_rate("u2", "i2", 4), self.APP)
        events.insert(_rate("u3", "i3", 3), self.APP)
        events.delete(eid, self.APP)
        got, _ = events.tail_events(self.APP, after=cur)
        assert [e.entity_id for e in got] == ["u3"]

    def test_sqlite_tails_events_the_jax_package_wrote(self, tmp_path):
        """The same sqlite file, written by the JAX package's DAO: the
        port's tail reads its rows (no schema change)."""
        from predictionio_tpu.data.event import Event as JEvent
        from predictionio_tpu.data.storage.sqlite import SQLiteEvents as JSQLiteEvents
        from predictionio_tpu.data.storage.sqlite import (
            SQLiteStorageClient as JSQLiteStorageClient,
        )

        jev = JSQLiteEvents(JSQLiteStorageClient({"path": str(tmp_path / "ev.db")}))
        for k in range(3):
            jev.insert(JEvent(event="rate", entity_type="user", entity_id=f"u{k}",
                              target_entity_type="item", target_entity_id="i1",
                              properties={"rating": 4.0}), self.APP)
        events = _sqlite_events(tmp_path)
        assert events.tail_end(self.APP) == jev.tail_end(self.APP) == 3
        got, cur = events.tail_events(self.APP, after=1)
        want, jcur = jev.tail_events(self.APP, after=1)
        assert cur == jcur == 3
        assert [(e.event_id, e.entity_id, e.properties.to_dict()) for e in got] == \
            [(e.event_id, e.entity_id, e.properties.to_dict()) for e in want]

    def test_generic_mode_without_a_seq_tail(self, tmp_path):
        """A store that answers neither ``tail_end`` nor ``tail_files``
        is tailed by ``change_token`` + ``find`` past the watermark."""
        events = _memory_events(tmp_path)
        events.insert(_rate("old", "i0", 1, event_time=datetime.now(timezone.utc)
                            - timedelta(hours=1)), self.APP)

        class NoSeq:
            def __getattr__(self, name):
                return getattr(events, name)

            def tail_end(self, app_id, channel_id=None):
                return None

        t = EventTailer(NoSeq(), self.APP)
        assert t.mode == "generic"
        assert t.poll() == []
        assert t.events_behind() == 0
        events.insert(_rate("u1", "i1", 5), self.APP)
        assert t.events_behind() is None
        assert [e.entity_id for e in t.poll()] == ["u1"]
        assert t.poll() == [] and t.events_behind() == 0

    def test_a_file_log_store_is_a_later_slice(self, tmp_path):
        """A store with ``tail_files`` (the file-log stores, ported since)
        is tailed in files mode, by byte offsets, as in the JAX package."""
        events = _memory_events(tmp_path)
        log = tmp_path / "log.jsonl"
        log.write_bytes(b"")

        class FileLog:
            tail_files = staticmethod(lambda app_id, channel_id=None: [log])

            def __getattr__(self, name):
                return getattr(events, name)

        t = EventTailer(FileLog(), self.APP)
        assert t.mode == "files"
        with open(log, "a") as f:
            f.write(_rate("u1", "i1", 5).to_json() + "\n")
        assert t.events_behind() == 1
        assert [e.entity_id for e in t.poll()] == ["u1"]
        assert t.poll() == [] and t.events_behind() == 0


# ---------------------------------------------------------------------------
# cursor files across the packages
# ---------------------------------------------------------------------------


class TestCursorAcrossPackages:
    APP = 5

    def _jax_sqlite(self, tmp_path):
        from predictionio_tpu.data.storage.sqlite import SQLiteEvents as J
        from predictionio_tpu.data.storage.sqlite import SQLiteStorageClient as JC

        return J(JC({"path": str(tmp_path / "ev.db")}))

    def test_port_resumes_a_jax_cursor(self, tmp_path):
        from predictionio_tpu.realtime.tailer import EventTailer as JEventTailer

        jev = self._jax_sqlite(tmp_path)
        cursor = tmp_path / "cursor.json"
        jt = JEventTailer(jev, self.APP, cursor_path=cursor)
        events = _sqlite_events(tmp_path)
        for k in range(5):
            events.insert(_rate(f"u{k}", "i1", 5), self.APP)
        assert len(jt.poll(limit=2)) == 2
        t = EventTailer(events, self.APP, cursor_path=cursor)
        assert t.mode == "seq"
        assert [e.entity_id for e in t.poll()] == ["u2", "u3", "u4"]
        assert t.poll() == []

    def test_jax_tailer_resumes_a_port_cursor(self, tmp_path):
        from predictionio_tpu.realtime.tailer import EventTailer as JEventTailer

        events = _sqlite_events(tmp_path)
        cursor = tmp_path / "cursor.json"
        t = EventTailer(events, self.APP, cursor_path=cursor)
        for k in range(5):
            events.insert(_rate(f"u{k}", "i1", 5), self.APP)
        assert len(t.poll(limit=3)) == 3
        jt = JEventTailer(self._jax_sqlite(tmp_path), self.APP, cursor_path=cursor)
        assert [e.entity_id for e in jt.poll()] == ["u3", "u4"]
        state = json.loads(cursor.read_text())
        assert set(state) == {"version", "mode", "watermark", "seq", "files", "seen"}


# ---------------------------------------------------------------------------
# fold-in
# ---------------------------------------------------------------------------

# Tolerances of the JAX package's test: the fold-in solves the new user's
# row in closed form against FIXED item factors, while a retrain also
# moves the item factors
RMSE_TOL = {"float32": 0.35, "bfloat16": 0.4, "int8": 0.5}


def _train_model(storage, app_name, storage_dtype, engine_id, iterations=8):
    engine = rec.engine()
    ep = EngineParams(
        datasource=("", rec.DataSourceParams(app_name=app_name)),
        algorithms=[("als", rec.ALSAlgorithmParams(
            rank=4, num_iterations=iterations, storage_dtype=storage_dtype))],
    )
    run_train(engine, ep, engine_id=engine_id, storage=storage, ctx=CPU)
    instance = storage.get_metadata_engine_instances().get_latest_completed(
        engine_id, "0", "default")
    _, _, models, _ = prepare_deploy(engine, instance, storage, CPU)
    return models[0], instance


def _scores(model, uid):
    row = model.user_rows([model.user_index[uid]])[0]
    V = als_ops.dense_factors(
        rec._put(model.item_factors, model.item_scales, torch.device("cpu"))).numpy()
    return {iid: float(row @ V[ix]) for iid, ix in model.item_index.items()}


def _block_app(storage, name):
    app_id = _app(storage, name)
    events = storage.get_events()
    # block structure: group A loves i0-3 / hates i4-7, group B inverse
    for u in range(6):
        for i in range(8):
            events.insert(_rate(f"a{u}", f"i{i}", 5 if i < 4 else 1), app_id)
            events.insert(_rate(f"b{u}", f"i{i}", 1 if i < 4 else 5), app_id)
    return app_id, events


@pytest.mark.parametrize("storage_dtype", ["float32", "bfloat16", "int8"])
def test_foldin_parity_vs_retrain(storage, storage_dtype):
    """A folded-in user must rank like a from-scratch retrain that saw
    the same events: same preferred block, overlapping top items, and
    RMSE on the user's own ratings within the documented tolerance."""
    app_id, events = _block_app(storage, "FoldApp")
    base_model, _ = _train_model(storage, "FoldApp", storage_dtype, "fold")
    assert "newu" not in base_model.user_index

    new_ratings = {"i0": 5, "i1": 5, "i4": 1, "i5": 1}
    new_events = [_rate("newu", iid, v) for iid, v in new_ratings.items()]
    for e in new_events:
        events.insert(e, app_id)

    foldin = ALSFoldIn(events, app_id, config=FoldInConfig(), device="cpu")
    patched, stats = foldin.fold(base_model, new_events)
    assert patched is not None
    assert stats.users_added == 1
    assert patched.user_factors.shape[0] == base_model.user_factors.shape[0] + 1
    assert patched.user_factors.dtype == base_model.user_factors.dtype
    assert "newu" not in base_model.user_index  # served model untouched

    retrained, _ = _train_model(storage, "FoldApp", storage_dtype, "fold2")
    s_fold = _scores(patched, "newu")
    s_full = _scores(retrained, "newu")
    for s in (s_fold, s_full):
        assert min(s["i2"], s["i3"]) > max(s["i6"], s["i7"]), s

    def top3(s):
        return {i for i, _ in sorted(s.items(), key=lambda kv: -kv[1])[:3]}

    assert len(top3(s_fold) & top3(s_full)) >= 2

    def rmse(s):
        err = [s[iid] - v for iid, v in new_ratings.items()]
        return float(np.sqrt(np.mean(np.square(err))))

    assert rmse(s_fold) <= rmse(s_full) + RMSE_TOL[storage_dtype]


def test_foldin_updates_existing_user_and_requantizes(storage):
    """Folding new events for a KNOWN user rewrites that row in place
    (int8: with a fresh per-row scale) and leaves every other row
    byte-identical."""
    app_id, events = _block_app(storage, "Fold8App")
    model, _ = _train_model(storage, "Fold8App", "int8", "f8")
    flips = [_rate("a0", f"i{i}", 1 if i < 4 else 5) for i in range(8)]
    for e in flips:
        events.insert(e, app_id)
    foldin = ALSFoldIn(events, app_id, config=FoldInConfig(), device="cpu")
    patched, stats = foldin.fold(model, flips)
    assert patched is not None and stats.users_added == 0
    ix = model.user_index["a0"]
    assert patched.user_factors.dtype == np.int8
    assert patched.user_scales is not None
    assert not np.array_equal(patched.user_factors[ix], model.user_factors[ix])
    other = [i for i in range(len(model.user_index)) if i != ix]
    assert np.array_equal(patched.user_factors[other], model.user_factors[other])
    s = _scores(patched, "a0")
    assert min(s["i4"], s["i5"]) > max(s["i0"], s["i1"]), s


def test_foldin_accumulates_cold_item_stats(storage):
    app_id = _app(storage, "ColdApp")
    events = storage.get_events()
    for u in range(4):
        for i in range(4):
            events.insert(_rate(f"u{u}", f"i{i}", 4), app_id)
    model, _ = _train_model(storage, "ColdApp", "float32", "cold")
    batch = [
        _rate("u0", "BRAND_NEW", 5),
        _rate("u1", "BRAND_NEW", 3),
        _rate("u0", "i0", 2),
    ]
    for e in batch:
        events.insert(e, app_id)
    foldin = ALSFoldIn(events, app_id, config=FoldInConfig(), device="cpu")
    patched, stats = foldin.fold(model, batch)
    assert patched is not None  # u0/u1 still solvable on known items
    assert stats.cold_item_events == 2
    assert foldin.cold_start_stats()["BRAND_NEW"] == {"events": 2, "mean_rating": 4.0}
    assert "BRAND_NEW" not in patched.item_index  # items stay fixed


def test_patched_model_shares_the_item_table_on_the_device(storage):
    """The patch carries the old model's device item table and coarse
    catalog; only its user table is new on the device."""
    app_id, events = _block_app(storage, "ShareApp")
    model, _ = _train_model(storage, "ShareApp", "float32", "share", iterations=2)
    cpu = torch.device("cpu")
    U_old, V_old = model.device_factors(cpu)
    model._coarse = (cpu, object())  # a built catalog stands in
    new = [_rate("zz", "i0", 5), _rate("zz", "i1", 4)]
    for e in new:
        events.insert(e, app_id)
    patched, _ = ALSFoldIn(events, app_id, device="cpu").fold(model, new)
    assert patched.item_factors is model.item_factors
    U_new, V_new = patched.device_factors(cpu)
    assert V_new is V_old and patched._coarse is model._coarse
    assert U_new.shape[0] == U_old.shape[0] + 1
    assert np.array_equal(U_new.numpy(), patched.user_factors)


def test_foldin_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the fold would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        ALSFoldIn(_memory_events(tmp_path), 1)


# -- the fold layout: grouped by width, against one padded bucket ----------------


def _pairs(seed, lengths, n_items=64):
    rng = np.random.default_rng(seed)
    return [
        [(int(i), float(rng.integers(1, 6)))
         for i in rng.choice(n_items, size=n, replace=False)]
        for n in lengths
    ]


def test_grouped_buckets_group_rows_by_the_power_of_two_of_their_width():
    pairs = _pairs(0, [1, 9, 8, 33, 3, 16, 17, 64])
    groups = foldin_mod.grouped_buckets(pairs)
    assert [c.shape for _, c, _, _ in groups] == [(3, 8), (2, 16), (1, 32), (2, 64)]
    assert [list(rows) for rows, *_ in groups] == [[0, 2, 4], [1, 5], [6], [3, 7]]
    for rows, col_ids, ratings, mask in groups:
        for r, i in enumerate(rows):
            n = len(pairs[i])
            assert mask[r].sum() == n and not mask[r, n:].any()
            assert [(int(c), float(v)) for c, v in zip(col_ids[r, :n], ratings[r, :n])] \
                == pairs[i]
    col_ids, ratings, mask = foldin_mod.padded_bucket(pairs)
    assert col_ids.shape == (8, 64) and mask.sum() == sum(map(len, pairs))


@pytest.mark.parametrize("storage_dtype", ["float32", "bfloat16", "int8"])
def test_grouped_layout_solves_as_one_padded_bucket(storage_dtype):
    """K1's plain version on the grouped layout against the JAX package's
    one ``(pow2(B), pow2(max history))`` bucket: the same rows. Padding
    adds exact zeros, but the plain version's ``bmm`` sums a wider row in
    another order, so the CPU bar is one bucket solve's (rtol 2e-4 / atol
    2e-5, ``tests/test_torch_als.py``); the card holds K1's two layouts
    bit for bit (``chip_smoke.py`` realtime)."""
    rng = np.random.default_rng(1)
    V = als_ops.to_storage(torch.from_numpy(
        rng.standard_normal((64, 6)).astype(np.float32)), storage_dtype)
    pairs = _pairs(2, [1, 5, 8, 12, 40, 3, 64, 20, 9])
    out = np.zeros((len(pairs), 6), np.float32)
    for rows, c, r, m in foldin_mod.grouped_buckets(pairs):
        out[rows] = als_ops.solve_bucket_explicit(V, c, r, m, 0.05).numpy()
    c, r, m = foldin_mod.padded_bucket(pairs)
    padded = als_ops.solve_bucket_explicit(V, c, r, m, 0.05).numpy()[:len(pairs)]
    np.testing.assert_allclose(out, padded, rtol=2e-4, atol=2e-5)
    assert np.isfinite(out).all()


# -- fold parity with the JAX package --------------------------------------------


def _both_models(storage_dtype, n_users=10, n_items=8, rank=4):
    """The same ALS model in both packages, from numpy."""
    from predictionio_tpu.data.bimap import BiMap as JBiMap
    from predictionio_tpu.models import recommendation as jrec

    rng = np.random.default_rng(7)
    uf = rng.standard_normal((n_users, rank)).astype(np.float32)
    vf = rng.standard_normal((n_items, rank)).astype(np.float32)
    users = [f"u{j}" for j in range(n_users)]
    items = [f"i{j}" for j in range(n_items)]
    us = vs = None
    if storage_dtype == "int8":
        q = [als_ops.quantize_rows(torch.from_numpy(a)) for a in (uf, vf)]
        (uf, us), (vf, vs) = ((a.numpy(), s.numpy()) for a, s in q)
    elif storage_dtype == "bfloat16":
        import ml_dtypes

        uf, vf = uf.astype(ml_dtypes.bfloat16), vf.astype(ml_dtypes.bfloat16)
    port = rec.model_from_numpy(users, items, uf, vf, us, vs)
    jax_model = jrec.ALSModel(
        user_index=JBiMap.from_dense(users), item_index=JBiMap.from_dense(items),
        user_factors=uf, item_factors=vf, user_scales=us, item_scales=vs)
    return port, jax_model


def _both_stores():
    from predictionio_tpu.data import storage as jst
    from predictionio_tpu.data.event import Event as JEvent

    jax_storage, port_storage = jst.test_storage(), tstorage.test_storage()
    t0 = datetime(2024, 1, 1, tzinfo=timezone.utc)
    rows = []
    rng = np.random.default_rng(11)
    # known users re-rating, new users, a cold item, a repeated pair
    # (last write wins), a non-rating event
    for k, (u, i) in enumerate([("u1", "i0"), ("new1", "i3"), ("u4", "i2"),
                                ("new1", "COLD"), ("u1", "i5"), ("new2", "i7"),
                                ("u4", "i2"), ("new2", "i1"), ("new1", "i6"),
                                ("u9", "COLD")]):
        rows.append((u, i, float(rng.integers(1, 6)), t0 + timedelta(seconds=k)))
    history = [(f"u{j}", f"i{(j * 3 + m) % 8}", float(1 + (j + m) % 5),
                t0 - timedelta(days=1, seconds=j * 10 + m))
               for j in range(10) for m in range(3)]
    out = []
    for st, ev_cls in ((jax_storage, JEvent), (port_storage, Event)):
        app_cls = jst.App if st is jax_storage else tstorage.App
        app_id = st.get_metadata_apps().insert(app_cls(0, "P"))
        events = st.get_events()
        events.init(app_id)
        for u, i, v, t in history + rows:
            events.insert(ev_cls(event="rate", entity_type="user", entity_id=u,
                                 target_entity_type="item", target_entity_id=i,
                                 properties={"rating": v}, event_time=t), app_id)
        events.insert(ev_cls(event="view", entity_type="user", entity_id="u2",
                             target_entity_type="item", target_entity_id="i1",
                             event_time=t0), app_id)
        batch = [ev_cls(event="rate", entity_type="user", entity_id=u,
                        target_entity_type="item", target_entity_id=i,
                        properties={"rating": v}, event_time=t)
                 for u, i, v, t in rows]
        out.append((events, app_id, batch))
    return out


@pytest.mark.parametrize("storage_dtype", ["float32", "bfloat16", "int8"])
def test_fold_equals_the_jax_packages(storage_dtype):
    from predictionio_tpu.realtime import ALSFoldIn as JALSFoldIn
    from predictionio_tpu.realtime import FoldInConfig as JFoldInConfig

    port_model, jax_model = _both_models(storage_dtype)
    (jev, japp, jbatch), (tev, tapp, tbatch) = _both_stores()
    jf = JALSFoldIn(jev, japp, config=JFoldInConfig(reg=0.05))
    tf = ALSFoldIn(tev, tapp, config=FoldInConfig(reg=0.05), device="cpu")
    jp, js = jf.fold(jax_model, jbatch)
    tp, ts = tf.fold(port_model, tbatch)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.users_added == 2 and ts.cold_item_events == 2
    assert tf.cold_start_stats() == jf.cold_start_stats()
    assert list(tp.user_index.items()) == list(jp.user_index.items())
    assert tp.item_index == port_model.item_index
    touched = [tp.user_index[u] for u in ("u1", "new1", "u4", "new2", "u9")
               if u in tp.user_index]
    untouched = [i for i in range(len(port_model.user_index)) if i not in touched]
    got_raw, want_raw = tp.user_factors, np.asarray(jp.user_factors)
    if storage_dtype == "bfloat16":
        assert np.array_equal(got_raw[untouched].view(np.uint16),
                              want_raw[untouched].view(np.uint16))
    else:
        assert np.array_equal(got_raw[untouched], want_raw[untouched])
    got, want = tp.user_rows(touched), np.asarray(jp.user_rows(touched))
    if storage_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5)
    elif storage_dtype == "bfloat16":
        # one bf16 quantum of the larger magnitude
        quantum = 2.0 ** (np.floor(np.log2(np.maximum(abs(got), abs(want)))) - 7)
        assert (np.abs(got - want) <= quantum).all()
    else:
        scale = np.maximum(tp.user_scales[touched], np.asarray(jp.user_scales)[touched])
        assert (np.abs(got - want) <= scale[:, None] * 1.001).all()


def test_fold_layouts_equal_the_jax_packages_rows():
    """The rows the fold solves are the JAX package's, in its order:
    ``touched_pairs`` against the JAX fold's history re-read."""
    port_model, jax_model = _both_models("float32")
    (jev, japp, jbatch), (tev, tapp, tbatch) = _both_stores()
    tf = ALSFoldIn(tev, tapp, device="cpu")
    stats = foldin_mod.FoldInStats()
    touched = []
    tf._collect_events(port_model, tbatch, stats, touched, set())
    users, pairs = tf.touched_pairs(port_model, touched, stats)
    assert users == ["u1", "new1", "u4", "new2", "u9"][:len(users)]
    c, r, m = foldin_mod.padded_bucket(pairs)
    assert c.shape == (8, 8) and m.sum() == sum(len(p) for p in pairs)


# ---------------------------------------------------------------------------
# epoch fencing: /reload vs apply_patch races
# ---------------------------------------------------------------------------


@pytest.fixture()
def deployed(storage):
    """Recommendation engine trained + deployed by the port on a local
    port, on the CPU, with its app for the speed layer to ingest into."""
    app_id = _app(storage, "RtApp")
    events = storage.get_events()
    rng = np.random.default_rng(0)
    for u in range(12):
        for _ in range(6):
            i = int(rng.integers(0, 8))
            events.insert(_rate(f"u{u}", f"i{i}", float(rng.integers(1, 6))), app_id)
    engine = rec.engine()
    ep = EngineParams(
        datasource=("", rec.DataSourceParams(app_name="RtApp")),
        algorithms=[("als", rec.ALSAlgorithmParams(rank=4, num_iterations=3))],
    )
    run_train(engine, ep, engine_id="rt", storage=storage, ctx=CPU)
    instance = storage.get_metadata_engine_instances().get_latest_completed(
        "rt", "0", "default")
    freshness.reset()
    server = EngineServer(engine, instance, storage=storage, host="127.0.0.1",
                          port=0, server_key="secret", device="cpu")
    port = server.start()
    yield {
        "base": f"http://127.0.0.1:{port}",
        "server": server,
        "storage": storage,
        "engine": engine,
        "ep": ep,
        "app_id": app_id,
        "retrain": lambda: run_train(engine, ep, engine_id="rt", storage=storage, ctx=CPU),
    }
    server.stop()


class TestEpochFence:
    def test_stale_patch_rejected_after_reload(self, deployed):
        """A fold-in that snapshotted before a /reload must NOT be able to
        resurrect pre-retrain factors."""
        server = deployed["server"]
        _, models, epoch = server.model_snapshot()
        deployed["retrain"]()
        status, _ = http("POST", deployed["base"] + "/reload?accessKey=secret")
        assert status == 200
        reloaded_models = server.models
        assert server.apply_patch(list(models), epoch) is False
        assert server.models is reloaded_models  # untouched

    def test_patch_applies_and_reload_supersedes(self, deployed):
        from predictionio_tpu_torch.obs import device as obs_device

        server = deployed["server"]
        _, models, epoch = server.model_snapshot()
        before = obs_device.transfer_totals().get("h2d.serve.model_patch", 0)
        assert server.apply_patch(list(models), epoch) is True
        assert server._foldin_epoch == 1
        # the JAX server's count: the models' host arrays
        m = models[0]
        want = sum(a.nbytes for a in (m.user_factors, m.item_factors))
        assert obs_device.transfer_totals()["h2d.serve.model_patch"] - before == want
        # a stale second apply with the consumed epoch is fenced out
        assert server.apply_patch(list(models), epoch) is False
        deployed["retrain"]()
        assert server.reload() is True
        assert server._foldin_epoch == 0

    def test_stats_route_without_speed_layer(self, deployed):
        status, body = http("GET", deployed["base"] + "/stats.json")
        assert status == 200
        assert body["realtime"] == {"enabled": False}
        assert body["status"] == "alive"
        row = body["variants"]["default"]
        assert row["foldinEpoch"] == 0 and row["secondsBehind"] is None


# ---------------------------------------------------------------------------
# end to end: deploy -> ingest -> fold -> personalized -> retrain wins
# ---------------------------------------------------------------------------


class TestSpeedLayerEndToEnd:
    def test_demo_flow(self, deployed, tmp_path):
        """A new user becomes personally servable without a retrain, then
        a retrain + /reload supersedes the patch (step() driven directly)."""
        server, base = deployed["server"], deployed["base"]
        events = deployed["storage"].get_events()
        layer = SpeedLayer(server, interval=3600, cursor_path=tmp_path / "cursor.json")
        assert server.speed_layer is layer
        assert layer.step() == "idle"

        status, body = http("POST", f"{base}/queries.json", {"user": "zz9"})
        assert status == 200 and body["itemScores"] == []

        for iid, v in (("i0", 5.0), ("i1", 5.0), ("i2", 4.0)):
            events.insert(_rate("zz9", iid, v), deployed["app_id"])
        assert layer.step() == "patched"

        status, body = http("POST", f"{base}/queries.json", {"user": "zz9", "num": 3})
        assert status == 200 and len(body["itemScores"]) == 3

        status, stats_body = http("GET", f"{base}/stats.json")
        rt = stats_body["realtime"]
        assert rt["enabled"] is True and rt["mode"] == "seq"
        assert rt["foldin_epoch"] == 1 and rt["users_added"] == 1
        assert rt["events_behind"] == 0 and rt["seconds_behind"] == 0.0
        row = stats_body["variants"]["default"]
        assert row["foldinEpoch"] == 1 and row["secondsBehind"] == 0.0

        deployed["retrain"]()
        status, _ = http("POST", f"{base}/reload?accessKey=secret")
        assert status == 200
        assert layer.step() == "superseded"
        assert layer.tailer.poll() == []  # cursor at the new watermark
        status, stats_body = http("GET", f"{base}/stats.json")
        assert stats_body["realtime"]["foldin_epoch"] == 0
        status, body = http("POST", f"{base}/queries.json", {"user": "zz9", "num": 3})
        assert status == 200 and len(body["itemScores"]) == 3

    def test_reload_mid_fold_drops_batch(self, deployed, tmp_path):
        """A retrain landing between snapshot and patch: the fold loses
        the fence, sees the new instance, and drops the batch."""
        server = deployed["server"]
        layer = SpeedLayer(server, interval=3600)
        deployed["storage"].get_events().insert(_rate("zz8", "i0", 5), deployed["app_id"])
        real_apply = server.apply_patch
        fired = []

        def racing_apply(models, epoch):
            if not fired:
                fired.append(True)
                deployed["retrain"]()
                server.reload()
            return real_apply(models, epoch)

        server.apply_patch = racing_apply
        try:
            assert layer.step() == "superseded"
        finally:
            server.apply_patch = real_apply
        assert layer.step() == "idle"

    def test_gauges_report_backlog(self, deployed, tmp_path):
        server = deployed["server"]
        layer = SpeedLayer(server, interval=3600)
        g = layer.gauges()
        assert g["enabled"] is True and g["mode"] == "seq"
        events = deployed["storage"].get_events()
        for k in range(5):
            events.insert(_rate("zz7", f"i{k}", 4), deployed["app_id"])
        assert layer.gauges()["events_behind"] == 5
        assert layer.step() == "patched"
        assert layer.gauges()["events_behind"] == 0

    def test_started_loop_folds_and_stop_persists_the_cursor(self, deployed, tmp_path):
        """``start()`` runs the cycle on its own thread every interval;
        ``server.stop()`` stops it and flushes the cursor."""
        import time

        server = deployed["server"]
        cursor = tmp_path / "cursor.json"
        layer = SpeedLayer(server, interval=0.05, cursor_path=cursor)
        layer.start()
        deployed["storage"].get_events().insert(_rate("zz6", "i3", 5), deployed["app_id"])
        deadline = time.time() + 20
        while server._foldin_epoch < 1 and time.time() < deadline:
            time.sleep(0.05)
        assert server._foldin_epoch == 1
        layer.stop()
        assert json.loads(cursor.read_text())["mode"] == "seq"


class TestDeployCLI:
    def test_deploy_realtime_starts_a_layer_per_variant(self, deployed, tmp_path):
        from predictionio_tpu_torch.cli import main as cli

        server = deployed["server"]
        args = cli.build_parser().parse_args([
            "deploy", "--realtime", "3600", "--realtime-cursor",
            str(tmp_path / "c.json"), "--device", "cpu"])
        layers = cli.start_speed_layers(server, args)
        try:
            assert len(layers) == 1 and server.speed_layer is layers[0]
            assert layers[0].interval == 3600.0
            assert (tmp_path / "c.json").exists()
        finally:
            for layer in layers:
                layer.stop()
        off = cli.build_parser().parse_args(["deploy", "--device", "cpu"])
        assert cli.start_speed_layers(server, off) == []

    def test_workers_still_raise(self, monkeypatch, capsys):
        """``deploy --workers 2 --realtime 1`` is the worker set's: its
        parent builds no server (each worker runs its own speed layer),
        and without a port of its own it is refused with exit 1."""
        from predictionio_tpu_torch.cli import main as cli

        def built(args):
            raise AssertionError("the worker set's parent built a server")

        monkeypatch.setattr(cli, "deploy_server", built)
        args = cli.build_parser().parse_args(
            ["deploy", "--workers", "2", "--realtime", "1", "--port", "0"])
        assert cli.cmd_deploy(args) == 1
        assert "--workers needs an explicit --port" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the query cache under the epoch fence
# ---------------------------------------------------------------------------


@pytest.fixture()
def cached_deployed(deployed):
    server = EngineServer(
        deployed["engine"], deployed["server"].instance, storage=deployed["storage"],
        host="127.0.0.1", port=0, server_key="secret", query_cache_mb=4, device="cpu",
    )
    port = server.start()
    yield {**deployed, "base": f"http://127.0.0.1:{port}", "server": server}
    server.stop()


class TestQueryCacheEpochFence:
    def _block_predict(self, server):
        algo = server.algorithms[0]
        orig = algo.predict
        started, release = threading.Event(), threading.Event()

        def blocking(*a, **k):
            started.set()
            assert release.wait(timeout=30), "test never released the gate"
            return orig(*a, **k)

        algo.predict = blocking
        return started, release, orig

    def test_foldin_racing_inflight_query_never_caches_stale(self, cached_deployed):
        """A query snapshots the model, a fold-in patch swaps it
        mid-compute: the stale result lands under the pre-swap epoch."""
        server = cached_deployed["server"]
        url = cached_deployed["base"] + "/queries.json"
        q = {"user": "u1", "num": 3}
        started, release, orig = self._block_predict(server)
        result = {}
        t = threading.Thread(target=lambda: result.update(b=_raw_post(url, q)))
        t.start()
        assert started.wait(timeout=30)
        _, models, epoch = server.model_snapshot()
        flipped = [dataclasses.replace(m, user_factors=-m.user_factors) for m in models]
        assert server.apply_patch(flipped, epoch) is True
        release.set()
        t.join(timeout=30)
        assert not t.is_alive()
        stale = result["b"]
        server.algorithms[0].predict = orig
        fresh = _raw_post(url, q)
        assert fresh != stale
        assert fresh == jsonx.dumps_bytes(server.handle_query(q))
        hits_before = server.query_cache.gauges()["cache_hits"]
        assert _raw_post(url, q) == fresh
        assert server.query_cache.gauges()["cache_hits"] == hits_before + 1

    def test_reload_racing_inflight_query_never_caches_stale(self, cached_deployed):
        from predictionio_tpu_torch.server.query_cache import canonical_query_bytes

        server = cached_deployed["server"]
        url = cached_deployed["base"] + "/queries.json"
        q = {"user": "u1", "num": 3}
        started, release, _ = self._block_predict(server)
        t = threading.Thread(target=lambda: _raw_post(url, q))
        t.start()
        assert started.wait(timeout=30)
        cached_deployed["retrain"]()
        status, _ = http("POST", cached_deployed["base"] + "/reload?accessKey=secret")
        assert status == 200
        release.set()
        t.join(timeout=30)
        assert not t.is_alive()
        with server._lock:
            epoch = server._epoch
        key = ("default", canonical_query_bytes(q), epoch)
        assert server.query_cache.get(key) is None
        calls = []
        algo = server.algorithms[0]
        orig2 = algo.predict
        algo.predict = lambda *a, **k: (calls.append(1), orig2(*a, **k))[1]
        _raw_post(url, q)
        assert len(calls) == 1

    def test_speed_layer_counts_cache_invalidations(self, cached_deployed):
        server = cached_deployed["server"]
        layer = SpeedLayer(server, interval=60.0)
        events = cached_deployed["storage"].get_events()
        events.insert(_rate("u1", "i2", 5.0), cached_deployed["app_id"])
        assert layer.step() == "patched"
        assert layer.gauges()["query_cache_invalidations"] == 1
        status, body = http("GET", cached_deployed["base"] + "/stats.json")
        assert status == 200
        assert body["realtime"]["query_cache_invalidations"] == 1


# ---------------------------------------------------------------------------
# corrupt-cursor recovery + fold-in circuit breaker
# ---------------------------------------------------------------------------


class TestCursorCorruptionRecovery:
    APP = 7

    def _recovered_counter(self):
        return obs_metrics.counter(
            "pio_tailer_cursor_recovered",
            "Tailer restarts that discarded a corrupt cursor file",
        )

    def _tailer_with_cursor(self, tmp_path):
        events = _sqlite_events(tmp_path)
        cursor = tmp_path / "cursor.json"
        t = EventTailer(events, self.APP, cursor_path=cursor)
        events.insert(_rate("u1", "i1", 4), self.APP)
        assert len(t.poll()) == 1  # persists a real cursor
        return events, cursor

    @pytest.mark.parametrize("corruption", [
        "torn-json", "not-a-dict", "watermark-wrong-type",
        "files-missing-fields", "seen-not-a-list",
    ])
    def test_corrupt_cursor_falls_back_to_reattach(self, tmp_path, corruption):
        events, cursor = self._tailer_with_cursor(tmp_path)
        good = json.loads(cursor.read_text())
        if corruption == "torn-json":
            cursor.write_text(cursor.read_text()[: len(cursor.read_text()) // 2])
        elif corruption == "not-a-dict":
            cursor.write_text("[1, 2, 3]")
        elif corruption == "watermark-wrong-type":
            good["watermark"] = ["not", "a", "number"]
            cursor.write_text(json.dumps(good))
        elif corruption == "files-missing-fields":
            good["files"] = {"/some/log": {"offset": 0}}
            cursor.write_text(json.dumps(good))
        elif corruption == "seen-not-a-list":
            good["seen"] = 42
            cursor.write_text(json.dumps(good))
        before = self._recovered_counter().value()
        events.insert(_rate("u2", "i2", 3), self.APP)
        t2 = EventTailer(events, self.APP, cursor_path=cursor)
        assert self._recovered_counter().value() == before + 1
        assert t2.poll() == []  # re-attached at the end, not at zero
        events.insert(_rate("u3", "i3", 5), self.APP)
        assert [e.entity_id for e in t2.poll()] == ["u3"]
        assert json.loads(cursor.read_text())["version"] == 1

    def test_structurally_corrupt_cursor_counts_recovery(self, tmp_path):
        events, cursor = self._tailer_with_cursor(tmp_path)
        good = json.loads(cursor.read_text())
        good["files"] = {"/some/log": {"offset": 0}}
        cursor.write_text(json.dumps(good))
        before = self._recovered_counter().value()
        EventTailer(events, self.APP, cursor_path=cursor)
        assert self._recovered_counter().value() == before + 1

    def test_cursor_of_another_mode_resets_without_counting(self, tmp_path):
        events, cursor = self._tailer_with_cursor(tmp_path)
        good = json.loads(cursor.read_text())
        good["mode"] = "files"
        cursor.write_text(json.dumps(good))
        before = self._recovered_counter().value()
        t = EventTailer(events, self.APP, cursor_path=cursor)
        assert self._recovered_counter().value() == before
        assert t.poll() == [] and json.loads(cursor.read_text())["mode"] == "seq"


class TestFoldInCircuitBreaker:
    """Repeated fold-in failures trip the breaker; the engine keeps
    serving the last good model; the breaker half-opens after backoff and
    closes on a successful fold."""

    def _speed_layer(self, deployed, tmp_path, clock):
        breaker = CircuitBreaker("foldin", failure_threshold=3, base_backoff_s=2.0,
                                 max_backoff_s=60.0, jitter=0.0, clock=clock)
        return SpeedLayer(deployed["server"], cursor_path=tmp_path / "cursor.json",
                          breaker=breaker)

    def test_breaker_trips_half_opens_and_recovers(self, deployed, tmp_path):
        clock = {"t": 1000.0}
        sl = self._speed_layer(deployed, tmp_path, lambda: clock["t"])
        app_id = deployed["app_id"]
        events = deployed["storage"].get_events()
        _, models_before, _ = deployed["server"].model_snapshot()
        with faults.injected("foldin.fold:always"):
            for i in range(3):
                events.insert(_rate("u1", f"i{i % 3}", 5), app_id)
                assert sl.step() == "fold_failed"
            assert sl.breaker.state == "open"
            events.insert(_rate("u1", "i1", 5), app_id)
            assert sl.step() == "breaker_open"
        _, models_now, _ = deployed["server"].model_snapshot()
        assert all(a is b for a, b in zip(models_now, models_before))
        snap = sl.gauges()["breaker"]
        assert snap["state"] == "open" and snap["trips_total"] == 1
        assert snap["failures_total"] == 3 and snap["retry_in_s"] > 0
        clock["t"] += 2.5
        assert sl.step() == "patched"
        assert sl.breaker.state == "closed"
        _, models_after, _ = deployed["server"].model_snapshot()
        assert any(a is not b for a, b in zip(models_after, models_before))

    def test_open_breaker_does_not_consume_events(self, deployed, tmp_path):
        clock = {"t": 0.0}
        sl = self._speed_layer(deployed, tmp_path, lambda: clock["t"])
        app_id = deployed["app_id"]
        events = deployed["storage"].get_events()
        with faults.injected("foldin.fold:always"):
            for i in range(3):
                events.insert(_rate("u2", f"i{i % 3}", 4), app_id)
                assert sl.step() == "fold_failed"
            events.insert(_rate("u3", "i1", 5), app_id)
            assert sl.step() == "breaker_open"
        clock["t"] += 2.5
        before = sl.events_folded
        assert sl.step() == "patched"
        assert sl.events_folded == before + 1

    def test_breaker_state_rides_stats_json(self, deployed, tmp_path):
        self._speed_layer(deployed, tmp_path, lambda: 0.0)
        status, body = http("GET", deployed["base"] + "/stats.json")
        assert status == 200
        assert body["realtime"]["breaker"]["state"] == "closed"
        assert body["realtime"]["breaker"]["trips_total"] == 0

    def test_a_failing_solve_trips_the_breaker_with_no_fallback(self, deployed,
                                                                 tmp_path, monkeypatch):
        """A K1 that fails fails the fold: counted by the breaker, the
        served model kept, nothing solved another way."""
        def broken(*a, **k):
            raise RuntimeError("K1 launch failed")

        monkeypatch.setattr(als_ops, "solve_bucket_explicit", broken)
        sl = self._speed_layer(deployed, tmp_path, lambda: 0.0)
        _, models_before, _ = deployed["server"].model_snapshot()
        deployed["storage"].get_events().insert(_rate("u5", "i1", 5), deployed["app_id"])
        assert sl.step() == "fold_failed"
        assert sl.breaker.snapshot()["failures_total"] == 1
        _, models_now, _ = deployed["server"].model_snapshot()
        assert all(a is b for a, b in zip(models_now, models_before))


# ---------------------------------------------------------------------------
# freshness lineage (the speed-layer cases of tests/test_slo.py)
# ---------------------------------------------------------------------------


class TestFreshnessLineage:
    def test_patch_commit_measured_from_ingest_time(self, deployed):
        server = deployed["server"]
        events = deployed["storage"].get_events()
        layer = SpeedLayer(server, interval=3600)
        n_before = freshness.HISTOGRAM.merged()[2]
        for iid, v in (("i0", 5.0), ("i1", 5.0), ("i2", 4.0)):
            events.insert(_rate("zz9", iid, v), deployed["app_id"])
        assert layer.step() == "patched"
        assert freshness.HISTOGRAM.merged()[2] == n_before + 3
        with freshness._lock:
            last = dict(freshness._last_commit)
        assert last["kind"] == "patch" and last["events"] == 3
        assert last["foldin_epoch"] == 1
        assert 0.0 <= last["newest_event_lag_s"] < 60.0
        status, body = http("GET", deployed["base"] + "/stats.json")
        assert status == 200
        fr = body["freshness"]
        assert fr["enabled"] is True and fr["last_commit"]["kind"] == "patch"
        assert fr["ingest_to_servable_s"]["count"] >= 3

    def test_superseded_fold_does_not_advance_freshness(self, deployed):
        server = deployed["server"]
        layer = SpeedLayer(server, interval=3600)
        deployed["storage"].get_events().insert(_rate("zz8", "i0", 5), deployed["app_id"])
        real_apply = server.apply_patch
        fired = []

        def racing_apply(models, epoch):
            if not fired:
                fired.append(True)
                deployed["retrain"]()
                server.reload()
            return real_apply(models, epoch)

        n_before = freshness.HISTOGRAM.merged()[2]
        with freshness._lock:
            commit_before = dict(freshness._last_commit or {})
        server.apply_patch = racing_apply
        try:
            assert layer.step() == "superseded"
        finally:
            server.apply_patch = real_apply
        assert freshness.HISTOGRAM.merged()[2] <= n_before + 1
        with freshness._lock:
            last = dict(freshness._last_commit)
        assert last["kind"] == "reload"
        assert last != commit_before

    def test_speed_layer_slos_installed(self, deployed):
        from predictionio_tpu_torch.obs import slo as slo_mod

        SpeedLayer(deployed["server"], interval=3600)
        names = slo_mod.REGISTRY.names()
        assert any(n.startswith("realtime.seconds_behind") for n in names)
