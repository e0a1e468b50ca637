"""The port's packed-prep cache (``core/prep_cache.py``) against a fresh
scan and layout, and against the JAX package's cache on the same files.

The contract: a probe that reports ``hit`` or ``splice`` gives a batch
and bucket lists bit-identical to a fresh ``find_ratings`` and
``build_padded_buckets`` of the same log, and anything the cache cannot
prove (a changed file, a replayed event id, a corrupt entry, a faulted
publish) falls back to a clean rebuild. The entry's file is the JAX
package's, so either package hits and splices the other's entries. The
single-device cases of ``tests/test_prep_cache.py`` are restated here
on the port; the sharded pack raises (the multi-GPU slice).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from predictionio_tpu.core import WorkflowContext as JWorkflowContext
from predictionio_tpu.core import prep_cache as jprep_cache
from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.data import store as jdata_store
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch import faults
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.core import prep_cache
from predictionio_tpu_torch.core.context import WorkflowContext
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data import store as data_store
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.models import recommendation as rec
from predictionio_tpu_torch.obs import metrics as obs_metrics
from predictionio_tpu_torch.ops import als as als_ops

from tests.test_torch_filelog_stores import _backend_env, _run_chaos_child

T0 = datetime(2020, 1, 1, tzinfo=timezone.utc)
# small widths, so the hot user segments across table rows: a splice
# must give seg_row exactly, not just the plain buckets
WIDTHS = (4, 16)
FILTERS = dict(
    event_names=["rate"],
    entity_type="user",
    target_entity_type="item",
    rating_key="rating",
    default_ratings=None,
    override_ratings=None,
)


def _env(kind, tmp_path):
    env = _backend_env(kind, tmp_path)
    env["PIO_STORAGE_SOURCES_LOG_SYNC"] = "always"
    return env


@pytest.fixture(params=["jsonl", "partitioned"])
def prep_storage(request, tmp_path, monkeypatch):
    """A port Storage on a file-log store and an isolated cache dir."""
    monkeypatch.setenv("PIO_PREP_CACHE_DIR", str(tmp_path / "prep"))
    monkeypatch.delenv("PIO_PREP_CACHE", raising=False)
    monkeypatch.delenv("PIO_PREP_CACHE_MAX_MB", raising=False)
    storage = tstorage.Storage(env=_env(request.param, tmp_path))
    app_id = storage.get_metadata_apps().insert(tstorage.App(0, "A"))
    storage.get_events().init(app_id)
    yield storage, app_id
    storage.close()


def _put(storage, app_id, i0, n, user=None):
    user = user or (lambda i: "hot" if i % 3 == 0 else f"u{i % 13}")
    storage.get_events().batch_insert(
        [
            Event(
                event="rate", entity_type="user", entity_id=user(i),
                target_entity_type="item", target_entity_id=f"i{i % 7}",
                properties={"rating": float(i % 5 + 1)},
                event_time=T0 + timedelta(minutes=i),
            )
            for i in range(i0, i0 + n)
        ],
        app_id,
    )


def _fresh_pack(batch):
    rb = als_ops.build_padded_buckets(batch.rows, batch.cols, batch.vals, WIDTHS)
    cb = als_ops.build_padded_buckets(batch.cols, batch.rows, batch.vals, WIDTHS)
    return rb, cb


def _publish(handle, batch):
    rb, cb = _fresh_pack(batch)
    data = als_ops.RatingsData(
        rows=batch.rows, cols=batch.cols, vals=batch.vals,
        num_rows=len(batch.entity_ids), num_cols=len(batch.target_ids),
        row_buckets=rb, col_buckets=cb,
    )
    return handle.publish(batch, data=data, bucket_widths=WIDTHS)


def _jax_publish(handle, batch):
    rb = jals.build_padded_buckets(batch.rows, batch.cols, batch.vals, WIDTHS)
    cb = jals.build_padded_buckets(batch.cols, batch.rows, batch.vals, WIDTHS)
    data = jals.RatingsData(
        rows=batch.rows, cols=batch.cols, vals=batch.vals,
        num_rows=len(batch.entity_ids), num_cols=len(batch.target_ids),
        row_buckets=rb, col_buckets=cb,
    )
    return handle.publish(batch, data=data, bucket_widths=WIDTHS)


def _assert_batch_equal(got, want):
    assert list(got.entity_ids) == list(want.entity_ids)
    assert list(got.target_ids) == list(want.target_ids)
    for f in ("rows", "cols", "vals"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _assert_buckets_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("row_ids", "col_ids", "ratings", "mask"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert (a.seg_row is None) == (b.seg_row is None)
        if a.seg_row is not None:
            assert np.array_equal(a.seg_row, b.seg_row)


def _rebuilds(reason):
    return obs_metrics.counter("pio_prep_cache_rebuilds_total", reason=reason).value()


class TestSpliceBitIdentity:
    def test_miss_publish_hit_then_splice(self, prep_storage):
        storage, app_id = prep_storage
        _put(storage, app_id, 0, 120)  # "hot" holds 40 rows: segmented
        h = prep_cache.probe("A", storage=storage, **FILTERS)
        assert h.status == "miss"
        batch = data_store.find_ratings("A", storage=storage, **FILTERS)
        assert _publish(h, batch)

        h2 = prep_cache.probe("A", storage=storage, **FILTERS)
        assert h2.status == "hit"
        _assert_batch_equal(h2.batch, batch)
        rb, cb = h2.packed_buckets(WIDTHS)
        want_rb, want_cb = _fresh_pack(batch)
        _assert_buckets_equal(rb, want_rb)
        _assert_buckets_equal(cb, want_cb)
        assert any(b.seg_row is not None for b in rb)

        # an appended tail over the existing ids: a surgical splice on
        # both stores, its buckets those of a fresh full layout
        _put(storage, app_id, 120, 30)
        h3 = prep_cache.probe("A", storage=storage, **FILTERS)
        assert h3.status == "splice" and h3.splice.surgical
        fresh = data_store.find_ratings("A", storage=storage, **FILTERS)
        _assert_batch_equal(h3.batch, fresh)
        want_rb, want_cb = _fresh_pack(fresh)
        pk = h3.packed_buckets(WIDTHS)
        _assert_buckets_equal(pk[0], want_rb)
        _assert_buckets_equal(pk[1], want_cb)

        # the spliced state published: the next probe is a hit again
        assert _publish(h3, h3.batch)
        assert prep_cache.probe("A", storage=storage, **FILTERS).status == "hit"

    def test_splice_with_new_ids(self, prep_storage):
        """A tail with new users still gives the fresh scan's batch (the
        renumber path); buckets come back only from a surgical splice
        (one tail file, as on jsonl), else None: never a wrong pack."""
        storage, app_id = prep_storage
        _put(storage, app_id, 0, 90)
        h = prep_cache.probe("A", storage=storage, **FILTERS)
        batch = data_store.find_ratings("A", storage=storage, **FILTERS)
        assert _publish(h, batch)

        _put(storage, app_id, 90, 24, user=lambda i: f"new{i % 5}")
        h2 = prep_cache.probe("A", storage=storage, **FILTERS)
        assert h2.status == "splice"
        fresh = data_store.find_ratings("A", storage=storage, **FILTERS)
        _assert_batch_equal(h2.batch, fresh)
        pk = h2.packed_buckets(WIDTHS)
        if h2.splice.surgical:
            want_rb, want_cb = _fresh_pack(fresh)
            _assert_buckets_equal(pk[0], want_rb)
            _assert_buckets_equal(pk[1], want_cb)
        else:
            assert pk is None

    def test_replayed_event_id_forces_rebuild(self, prep_storage):
        storage, app_id = prep_storage
        events = storage.get_events()
        events.insert(Event(
            event="rate", entity_type="user", entity_id="u1",
            target_entity_type="item", target_entity_id="i1",
            properties={"rating": 3.0}, event_id="dup0", event_time=T0), app_id)
        _put(storage, app_id, 1, 40)
        h = prep_cache.probe("A", storage=storage, **FILTERS)
        batch = data_store.find_ratings("A", storage=storage, **FILTERS)
        assert _publish(h, batch)

        before = _rebuilds("duplicate")
        events.insert(Event(
            event="rate", entity_type="user", entity_id="u1",
            target_entity_type="item", target_entity_id="i2",
            properties={"rating": 5.0}, event_id="dup0",
            event_time=T0 + timedelta(days=1)), app_id)
        h2 = prep_cache.probe("A", storage=storage, **FILTERS)
        assert h2.status == "miss"
        assert _rebuilds("duplicate") == before + 1

    def test_sharded_pack_raises_naming_the_multi_gpu_slice(self, prep_storage):
        storage, app_id = prep_storage
        _put(storage, app_id, 0, 30)
        h = prep_cache.probe("A", storage=storage, **FILTERS)
        with pytest.raises(NotImplementedError, match="item 12"):
            h.sharded_pack(als_ops.ALSParams(rank=4), 8, "auto")


class TestFallbacks:
    def test_faulted_publish_skips_then_rebuilds_clean(self, prep_storage):
        storage, app_id = prep_storage
        _put(storage, app_id, 0, 60)
        h = prep_cache.probe("A", storage=storage, **FILTERS)
        assert h.status == "miss"
        batch = data_store.find_ratings("A", storage=storage, **FILTERS)
        with faults.injected("train.prep_cache:raise"):
            assert not _publish(h, batch)
        assert not list(Path(prep_cache.cache_dir()).glob("*.prep"))

        h2 = prep_cache.probe("A", storage=storage, **FILTERS)
        assert h2.status == "miss"
        assert _publish(h2, batch)
        h3 = prep_cache.probe("A", storage=storage, **FILTERS)
        assert h3.status == "hit"
        _assert_batch_equal(h3.batch, batch)

    def test_corrupt_entry_falls_back_to_rebuild(self, prep_storage):
        storage, app_id = prep_storage
        _put(storage, app_id, 0, 60)
        h = prep_cache.probe("A", storage=storage, **FILTERS)
        batch = data_store.find_ratings("A", storage=storage, **FILTERS)
        assert _publish(h, batch)
        [entry] = Path(prep_cache.cache_dir()).glob("*.prep")
        blob = entry.read_bytes()

        before = _rebuilds("corrupt")
        entry.write_bytes(blob[: len(blob) // 2])  # a torn write
        h2 = prep_cache.probe("A", storage=storage, **FILTERS)
        assert h2.status == "miss"
        assert _rebuilds("corrupt") == before + 1
        assert _publish(h2, batch)
        assert prep_cache.probe("A", storage=storage, **FILTERS).status == "hit"

    def test_disabled_by_env(self, prep_storage, monkeypatch):
        storage, app_id = prep_storage
        _put(storage, app_id, 0, 30)
        monkeypatch.setenv("PIO_PREP_CACHE", "0")
        h = prep_cache.probe("A", storage=storage, **FILTERS)
        assert not h.active and h.status == "off"

    def test_a_store_without_tail_files_stays_off(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PIO_PREP_CACHE_DIR", str(tmp_path / "prep"))
        storage = tstorage.Storage(env=_backend_env("jsonl", tmp_path) | {
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB"})
        try:
            app_id = storage.get_metadata_apps().insert(tstorage.App(0, "A"))
            storage.get_events().init(app_id)
            _put(storage, app_id, 0, 20)
            assert prep_cache.probe("A", storage=storage, **FILTERS).status == "off"
        finally:
            storage.close()


_KILL_CHILD = """
import json, sys
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data import store as data_store
from predictionio_tpu_torch.core import prep_cache

cfg = json.load(open(sys.argv[1]))
st = Storage(env=cfg["env"])
FILTERS = dict(event_names=["rate"], entity_type="user",
               target_entity_type="item", rating_key="rating",
               default_ratings=None, override_ratings=None)
h = prep_cache.probe("A", storage=st, **FILTERS)
print("STATUS", h.status, flush=True)
batch = h.batch
if batch is None:
    batch = data_store.find_ratings("A", storage=st, **FILTERS)
h.publish(batch)
print("PUBLISHED", flush=True)  # never reached under the kill
"""


@pytest.mark.chaos
def test_kill9_mid_publish_leaves_a_husk_and_the_old_entry(tmp_path, monkeypatch):
    """SIGKILL between the tmp write and the rename: the published name
    keeps its bytes, only a ``.tmp`` husk is left, and the next probe
    still splices from the old entry."""
    env_dict = _env("jsonl", tmp_path)
    storage = tstorage.Storage(env=env_dict)
    try:
        app_id = storage.get_metadata_apps().insert(tstorage.App(0, "A"))
        storage.get_events().init(app_id)
        assert app_id == 1  # the chaos child's app
        proc, acked, done = _run_chaos_child(tmp_path, env_dict, "")
        assert done and len(acked) == 40
        cache_dir = tmp_path / "prep"
        monkeypatch.setenv("PIO_PREP_CACHE_DIR", str(cache_dir))
        h = prep_cache.probe("A", storage=storage, **FILTERS)
        assert h.status == "miss"
        batch = data_store.find_ratings("A", storage=storage, **FILTERS)
        assert _publish(h, batch)
        [entry] = cache_dir.glob("*.prep")
        old_bytes = entry.read_bytes()

        _put(storage, app_id, 1000, 25, user=lambda i: f"u{i % 9}")
        child_env = dict(os.environ, PIO_FAULTS="storage.fsync:nth=1:kill",
                         PIO_COLUMNAR_CACHE="0", PIO_PREP_CACHE_DIR=str(cache_dir))
        child_env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(Path(__file__).resolve().parent.parent),
                        os.environ.get("PYTHONPATH")) if p)
        cfg = tmp_path / "kill_cfg.json"
        cfg.write_text(json.dumps({"env": env_dict}))
        cp = subprocess.run([sys.executable, "-c", _KILL_CHILD, str(cfg)],
                            capture_output=True, text=True, env=child_env, timeout=120)
        assert cp.returncode == -signal.SIGKILL, cp.stderr
        assert "STATUS splice" in cp.stdout and "PUBLISHED" not in cp.stdout

        assert [p.name for p in cache_dir.glob("*.prep")] == [entry.name]
        assert entry.read_bytes() == old_bytes
        assert list(cache_dir.glob("*.tmp.*"))
        h2 = prep_cache.probe("A", storage=storage, **FILTERS)
        assert h2.status == "splice"
        _assert_batch_equal(h2.batch, data_store.find_ratings("A", storage=storage, **FILTERS))
        assert _publish(h2, h2.batch)
        assert prep_cache.probe("A", storage=storage, **FILTERS).status == "hit"
    finally:
        storage.close()


class TestCacheLifecycle:
    def _entry(self, storage, app_id, n=120):
        _put(storage, app_id, 0, n)
        h = prep_cache.probe("A", storage=storage, **FILTERS)
        batch = data_store.find_ratings("A", storage=storage, **FILTERS)
        assert _publish(h, batch)
        (entry,) = prep_cache.cache_entries()
        return entry, batch

    def test_lru_budget_eviction(self, prep_storage):
        storage, app_id = prep_storage
        entry, _ = self._entry(storage, app_id)
        src = Path(entry["path"])
        size = entry["bytes"]
        for i, name in enumerate(("aaa", "bbb", "ccc")):
            dst = src.with_name(f"{name}{prep_cache.SUFFIX}")
            shutil.copy2(src, dst)
            t = entry["atime"] - 100.0 * (3 - i)
            os.utime(dst, (t, t))
        names = [e["name"] for e in prep_cache.cache_entries()]
        assert names == [f"{n}{prep_cache.SUFFIX}" for n in ("aaa", "bbb", "ccc")] + [src.name]

        assert prep_cache.enforce_budget(limit=2 * size) == names[:2]
        left = prep_cache.cache_entries()
        assert [e["name"] for e in left] == names[2:]
        assert obs_metrics.gauge("pio_prep_cache_bytes").value() == float(
            sum(e["bytes"] for e in left))
        assert prep_cache.max_bytes() is None
        assert prep_cache.enforce_budget() == []

    def test_evict_by_name_and_bad_names(self, prep_storage):
        storage, app_id = prep_storage
        entry, _ = self._entry(storage, app_id)
        assert not prep_cache.evict("nope.prep")
        assert not prep_cache.evict(entry["name"] + ".bak")
        assert prep_cache.evict(entry["name"])
        assert prep_cache.cache_entries() == []
        assert obs_metrics.gauge("pio_prep_cache_bytes").value() == 0.0

    def test_prune_sweeps_aged_husks_only(self, prep_storage):
        storage, app_id = prep_storage
        entry, _ = self._entry(storage, app_id)
        d = prep_cache.cache_dir()
        old_husk, new_husk = d / "x.prep.tmp.123", d / "y.prep.tmp.456"
        for husk in (old_husk, new_husk):
            husk.write_bytes(b"partial")
        t = time.time() - 1000.0
        os.utime(old_husk, (t, t))
        res = prep_cache.prune(max_age_s=600.0)
        assert res == {"husks": [old_husk.name], "evicted": []}
        assert new_husk.exists() and Path(entry["path"]).exists()

    def test_eviction_race_with_live_reader(self, prep_storage):
        """An entry evicted under a live hit: the handle's mapping
        outlives the unlink, and its buckets upload as copies."""
        storage, app_id = prep_storage
        entry, batch = self._entry(storage, app_id)
        h = prep_cache.probe("A", storage=storage, **FILTERS)
        assert h.status == "hit"
        assert prep_cache.evict(entry["name"])
        _assert_batch_equal(h.batch, batch)
        rb, cb = h.packed_buckets(WIDTHS)
        _assert_buckets_equal(rb, _fresh_pack(batch)[0])
        assert not rb[0].col_ids.flags.writeable
        up = als_ops.device_buckets(rb, torch.device("cpu"))
        assert up[0].col_ids.data_ptr() != rb[0].col_ids.ctypes.data
        assert np.array_equal(up[0].col_ids.numpy(), rb[0].col_ids)
        assert prep_cache.probe("A", storage=storage, **FILTERS).status == "miss"


# -- splice_padded_buckets: a property against both fresh builds ------------


def _first_appearance(codes):
    uniq, first = np.unique(codes, return_index=True)
    remap = np.empty(int(codes.max()) + 1, np.int64)
    remap[uniq[np.argsort(first, kind="stable")]] = np.arange(len(uniq))
    return remap[codes]


@st.composite
def _log_and_delta(draw):
    """An old log, a delta that reaches existing rows and rows past the
    old maximum, and the full stream with the delta spliced in at random
    places (the old entries keep their order)."""
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    n_old = draw(st.integers(1, 120))
    n_new = draw(st.integers(0, 40))
    # few rows give degrees past the last width (segments), many rows
    # small degrees that cross a class boundary with a few new entries
    nu = draw(st.integers(1, 40))
    ni = draw(st.integers(1, 30))
    hot = rng.random() < 0.5
    rows0 = rng.integers(0, nu, n_old)
    if hot:
        rows0[rng.random(n_old) < 0.5] = 0
    vals0 = rng.integers(1, 6, n_old).astype(np.float32)
    # first-appearance codes, as a scan assigns them: new ids come past
    # the old maximum
    rows0 = _first_appearance(rows0)
    cols0 = _first_appearance(rng.integers(0, ni, n_old))
    d_rows = rng.integers(0, int(rows0.max()) + 1 + draw(st.integers(0, 4)), n_new)
    d_cols = rng.integers(0, int(cols0.max()) + 1 + draw(st.integers(0, 3)), n_new)
    d_vals = rng.integers(1, 6, n_new).astype(np.float32)
    where = np.sort(rng.integers(0, n_old + 1, n_new))
    rows = np.insert(rows0, where, d_rows).astype(np.int32)
    cols = np.insert(cols0, where, d_cols).astype(np.int32)
    vals = np.insert(vals0, where, d_vals).astype(np.float32)
    widths = draw(st.sampled_from([(4, 16), (2, 4, 8), (2, 8, 32), (8, 32, 128, 512, 2048)]))
    return (rows0.astype(np.int32), cols0.astype(np.int32), vals0, rows, cols, vals,
            d_rows.astype(np.int32), d_cols.astype(np.int32), widths)


def test_a_row_that_changes_class_leaves_its_old_class():
    r0, c0 = np.array([0, 0, 0, 1, 1, 1], np.int32), np.arange(6, dtype=np.int32)
    old = als_ops.build_padded_buckets(r0, c0, np.ones(6, np.float32), (4, 16))
    r, c = np.append(r0, [0, 0]).astype(np.int32), np.arange(8, dtype=np.int32)
    got = als_ops.splice_padded_buckets(old, r, c, np.ones(8, np.float32),
                                        np.array([0, 0], np.int32), (4, 16))
    assert [b.row_ids.tolist() for b in got] == [[1], [0]]
    _assert_buckets_equal(got, als_ops.build_padded_buckets(r, c, np.ones(8, np.float32), (4, 16)))


@settings(max_examples=100, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_log_and_delta())
def test_splice_padded_buckets_equals_a_fresh_build_and_the_jax_splice(case):
    rows0, cols0, vals0, rows, cols, vals, d_rows, d_cols, widths = case
    for r0, c0, r, c, dr in ((rows0, cols0, rows, cols, d_rows),
                             (cols0, rows0, cols, rows, d_cols)):
        old = als_ops.build_padded_buckets(r0, c0, vals0, widths)
        got = als_ops.splice_padded_buckets(old, r, c, vals, dr, widths)
        _assert_buckets_equal(got, als_ops.build_padded_buckets(r, c, vals, widths))
        jold = jals.build_padded_buckets(r0, c0, vals0, widths)
        _assert_buckets_equal(got, jals.splice_padded_buckets(jold, r, c, vals, dr, widths))


# -- across the packages -----------------------------------------------------


@pytest.fixture(params=["jsonl", "partitioned"])
def both(request, tmp_path, monkeypatch):
    """(port Storage, JAX Storage) over one file-log store, one cache dir."""
    monkeypatch.setenv("PIO_PREP_CACHE_DIR", str(tmp_path / "prep"))
    monkeypatch.delenv("PIO_PREP_CACHE", raising=False)
    env = _env(request.param, tmp_path)
    port = tstorage.Storage(env=env)
    app_id = port.get_metadata_apps().insert(tstorage.App(0, "A"))
    port.get_events().init(app_id)
    jax = jstorage.Storage(env=env)
    yield port, jax, app_id
    jax.close()
    port.close()


def test_both_packages_key_the_same_entry(both):
    port, jax, app_id = both
    _put(port, app_id, 0, 20)
    assert (prep_cache.probe("A", storage=port, **FILTERS).path
            == jprep_cache.probe("A", storage=jax, **FILTERS).path)


def test_a_jax_entry_hits_and_splices_on_the_port(both):
    port, jax, app_id = both
    _put(port, app_id, 0, 120)
    jh = jprep_cache.probe("A", storage=jax, **FILTERS)
    assert jh.status == "miss"
    assert _jax_publish(jh, jdata_store.find_ratings("A", storage=jax, **FILTERS))

    h = prep_cache.probe("A", storage=port, **FILTERS)
    assert h.status == "hit"
    fresh = data_store.find_ratings("A", storage=port, **FILTERS)
    _assert_batch_equal(h.batch, fresh)
    for got, want in zip(h.packed_buckets(WIDTHS), _fresh_pack(fresh)):
        _assert_buckets_equal(got, want)

    _put(port, app_id, 120, 30)
    h = prep_cache.probe("A", storage=port, **FILTERS)
    jh = jprep_cache.probe("A", storage=jax, **FILTERS)
    assert h.status == jh.status == "splice"
    fresh = data_store.find_ratings("A", storage=port, **FILTERS)
    _assert_batch_equal(h.batch, fresh)
    _assert_batch_equal(jh.batch, fresh)
    for got, jgot, want in zip(h.packed_buckets(WIDTHS), jh.packed_buckets(WIDTHS),
                               _fresh_pack(fresh)):
        _assert_buckets_equal(got, want)
        _assert_buckets_equal(got, jgot)


def test_a_port_entry_hits_on_the_jax_package(both):
    port, jax, app_id = both
    _put(port, app_id, 0, 90)
    h = prep_cache.probe("A", storage=port, **FILTERS)
    batch = data_store.find_ratings("A", storage=port, **FILTERS)
    assert _publish(h, batch)
    _put(port, app_id, 90, 20)
    h = prep_cache.probe("A", storage=port, **FILTERS)
    assert h.status == "splice"
    rb, cb = h.packed_buckets(WIDTHS)
    data = als_ops.RatingsData(rows=h.batch.rows, cols=h.batch.cols, vals=h.batch.vals,
                               num_rows=len(h.batch.entity_ids),
                               num_cols=len(h.batch.target_ids),
                               row_buckets=rb, col_buckets=cb)
    assert h.publish(h.batch, data=data, bucket_widths=WIDTHS)

    jh = jprep_cache.probe("A", storage=jax, **FILTERS)
    assert jh.status == "hit"
    fresh = jdata_store.find_ratings("A", storage=jax, **FILTERS)
    _assert_batch_equal(jh.batch, fresh)
    jrb, jcb = jh.packed_buckets(WIDTHS)
    _assert_buckets_equal(jrb, jals.build_padded_buckets(fresh.rows, fresh.cols, fresh.vals, WIDTHS))
    _assert_buckets_equal(jcb, jals.build_padded_buckets(fresh.cols, fresh.rows, fresh.vals, WIDTHS))
    assert "sharded_pack" not in jh.entry.header


def test_a_jax_entry_with_a_sharded_pack_is_read_for_its_batch_and_single_pack(both):
    from predictionio_tpu.parallel import als_sharded

    port, jax, app_id = both
    _put(port, app_id, 0, 120)
    jh = jprep_cache.probe("A", storage=jax, **FILTERS)
    batch = jdata_store.find_ratings("A", storage=jax, **FILTERS)
    rb = jals.build_padded_buckets(batch.rows, batch.cols, batch.vals, WIDTHS)
    cb = jals.build_padded_buckets(batch.cols, batch.rows, batch.vals, WIDTHS)
    data = jals.RatingsData(rows=batch.rows, cols=batch.cols, vals=batch.vals,
                            num_rows=len(batch.entity_ids), num_cols=len(batch.target_ids),
                            row_buckets=rb, col_buckets=cb)
    params = jals.ALSParams(rank=4, iterations=2, seed=1)
    sharded = als_sharded.prepare_sharded_pack(data, params, 8, "auto")
    assert jh.publish(batch, data=data, bucket_widths=WIDTHS, sharded=sharded,
                      params=params, sharded_requested="auto")

    h = prep_cache.probe("A", storage=port, **FILTERS)
    assert h.status == "hit" and "sharded_pack" in h.entry.header
    _assert_batch_equal(h.batch, batch)
    got_rb, got_cb = h.packed_buckets(WIDTHS)
    _assert_buckets_equal(got_rb, rb)
    _assert_buckets_equal(got_cb, cb)
    with pytest.raises(NotImplementedError, match="item 12"):
        h.sharded_pack(als_ops.ALSParams(rank=4), 8, "auto")


def _warm_models(td, rank, seed):
    """The same random initial factors as a previous model of each
    package (the warm_start seam)."""
    rng = np.random.default_rng(seed)
    U0 = rng.standard_normal((len(td.user_ids), rank)).astype(np.float32) * 0.3
    V0 = rng.standard_normal((len(td.item_ids), rank)).astype(np.float32) * 0.3
    port = rec.model_from_numpy(td.user_ids, td.item_ids, U0, V0)
    jax = jrec.ALSModel(user_index=jrec.BiMap.from_dense(list(td.user_ids)),
                        item_index=jrec.BiMap.from_dense(list(td.item_ids)),
                        user_factors=U0, item_factors=V0)
    return port, jax


def test_train_through_both_packages_with_the_cache_warm(both):
    """Each package's DataSource and ALSAlgorithm on the same store: the
    JAX package publishes on a miss, both splice after an append, and the
    trainings from one injected init agree within the reference's
    tolerance."""
    port, jax, app_id = both
    _put(port, app_id, 0, 150)
    ds = rec.DataSourceParams(app_name="A", event_names=("rate",))
    jds = jrec.DataSourceParams(app_name="A", event_names=("rate",))
    ap = dict(rank=4, num_iterations=4, lambda_=0.05, seed=3, bucket_widths=WIDTHS)
    tstorage.set_storage(port)
    jstorage.set_storage(jax)
    try:
        jtd = jrec.RecommendationDataSource(jds).read_training(JWorkflowContext(mode="Training"))
        assert jtd.prep.status == "miss"
        jrec.ALSAlgorithm(jrec.ALSAlgorithmParams(**ap)).train(
            JWorkflowContext(mode="Training"), jtd)
        _put(port, app_id, 150, 40, user=lambda i: f"new{i % 4}")

        td = rec.RecommendationDataSource(ds).read_training(WorkflowContext(device="cpu"))
        jtd = jrec.RecommendationDataSource(jds).read_training(JWorkflowContext(mode="Training"))
        assert td.prep.status == jtd.prep.status == "splice"
        _assert_batch_equal(td.prep.batch, jtd.prep.batch)
        pmodel, jmodel = _warm_models(td, 4, 11)
        ctx = WorkflowContext(device="cpu", runtime_conf={"warm_start_model": pmodel})
        jctx = JWorkflowContext(mode="Training", runtime_conf={"warm_start_model": jmodel})
        want = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams(**ap)).train(jctx, jtd)
        got = rec.ALSAlgorithm(rec.ALSAlgorithmParams(**ap)).train(ctx, td)
    finally:
        tstorage.set_storage(None)
        jstorage.set_storage(None)
    np.testing.assert_allclose(got.user_factors, np.asarray(want.user_factors),
                               rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(got.item_factors, np.asarray(want.item_factors),
                               rtol=5e-4, atol=5e-5)
    # the port's train published the spliced state: the JAX package hits it
    assert jprep_cache.probe("A", storage=jax, **FILTERS | {
        "event_names": ["rate"], "override_ratings": {"buy": 4.0}}).status == "hit"


def test_a_spliced_train_equals_a_cold_one_bit_for_bit(both, monkeypatch):
    """K1's input from a splice equals a fresh layout's, so the port's
    train gives the same factors from the same seed."""
    port, _, app_id = both
    _put(port, app_id, 0, 120)
    ds = rec.DataSourceParams(app_name="A", event_names=("rate",))
    algo = rec.ALSAlgorithm(rec.ALSAlgorithmParams(
        rank=4, num_iterations=3, seed=5, bucket_widths=WIDTHS))
    tstorage.set_storage(port)
    try:
        def train():
            td = rec.RecommendationDataSource(ds).read_training(WorkflowContext(device="cpu"))
            return td.prep.status, algo.train(WorkflowContext(device="cpu"), td)

        assert train()[0] == "miss"
        _put(port, app_id, 120, 30)
        status, spliced = train()
        assert status == "splice"
        monkeypatch.setenv("PIO_PREP_CACHE", "0")
        status, cold = train()
        assert status == "off"
    finally:
        tstorage.set_storage(None)
    np.testing.assert_array_equal(spliced.user_factors, cold.user_factors)
    np.testing.assert_array_equal(spliced.item_factors, cold.item_factors)


# -- the CLI -------------------------------------------------------------------


def _cli_env(monkeypatch, tmp_path, kind="jsonl"):
    for k, v in _env(kind, tmp_path).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("PIO_PROGRESS_FILE", str(tmp_path / "progress.json"))
    monkeypatch.setenv("PIO_PREP_CACHE_DIR", str(tmp_path / "default_prep"))
    monkeypatch.delenv("PIO_PREP_CACHE", raising=False)
    monkeypatch.delenv("PIO_PREP_CACHE_MAX_MB", raising=False)
    tstorage.set_storage(None)
    storage = tstorage.get_storage()
    app_id = storage.get_metadata_apps().insert(tstorage.App(0, "A"))
    storage.get_events().init(app_id)
    _put(storage, app_id, 0, 90)
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps({
        "id": "prep", "engineFactory": "predictionio_tpu_torch.models.recommendation.engine",
        "datasource": {"params": {"appName": "A", "eventNames": ["rate"]}},
        "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 2,
                                                   "lambda": 0.05, "seed": 1}}],
    }))
    return storage, app_id, str(variant)


def test_train_prep_cache_flags(monkeypatch, tmp_path):
    storage, app_id, variant = _cli_env(monkeypatch, tmp_path)
    try:
        d = tmp_path / "flag_prep"
        train = ["train", "--variant", variant, "--device", "cpu"]

        def status():
            return json.loads((tmp_path / "progress.json").read_text())["prep_cache"]

        assert cli.main(train + ["--prep-cache-dir", str(d)]) == 0
        assert status() == "miss"
        assert len(list(d.glob("*.prep"))) == 1
        assert not (tmp_path / "default_prep").exists()
        assert cli.main(train) == 0
        assert status() == "hit"
        _put(storage, app_id, 90, 20)
        assert cli.main(train + ["--no-prep-cache"]) == 0
        assert status() == "off"
        monkeypatch.delenv("PIO_PREP_CACHE")
        assert cli.main(train) == 0
        assert status() == "splice"
    finally:
        tstorage.set_storage(None)
        storage.close()


def test_cache_verb_json_equals_the_jax_verb(monkeypatch, tmp_path, capsys):
    from predictionio_tpu.cli import main as jcli

    storage, app_id, variant = _cli_env(monkeypatch, tmp_path)
    try:
        assert cli.main(["train", "--variant", variant, "--device", "cpu"]) == 0
        [entry] = prep_cache.cache_entries()
        # an atime past the mtime, so a header read moves neither clock
        t = entry["mtime"] + 5.0
        os.utime(entry["path"], (t, entry["mtime"]))
        capsys.readouterr()

        def both_out(argv):
            rc = cli.main(argv)
            ours = capsys.readouterr()
            jrc = jcli.main(argv)
            theirs = capsys.readouterr()
            assert rc == jrc
            return ours, theirs

        ours, theirs = both_out(["cache", "list", "--json"])
        listing = json.loads(ours.out)
        assert listing == json.loads(theirs.out)
        assert [e["name"] for e in listing["entries"]] == [entry["name"]]
        assert listing["entries"][0]["single_pack"] and not listing["entries"][0]["sharded_pack"]
        ours, theirs = both_out(["cache", "list"])
        age = re.compile(r"last used -?\d+s ago")
        assert age.sub("", ours.out) == age.sub("", theirs.out)
        ours, theirs = both_out(["cache", "evict", "nope.prep"])

        def said(err):
            return [ln for ln in err.splitlines() if ln.startswith("cache:")]

        assert said(ours.err) == said(theirs.err) == ["cache: no such entry 'nope.prep'"]

        (tmp_path / "default_prep" / "x.prep.tmp.1").write_bytes(b"partial")
        os.utime(tmp_path / "default_prep" / "x.prep.tmp.1", (t - 1e4, t - 1e4))
        assert cli.main(["cache", "prune", "--max-mb", "0.000001", "--json"]) == 0
        assert json.loads(capsys.readouterr().out) == {
            "husks": ["x.prep.tmp.1"], "evicted": [entry["name"]]}
        assert cli.main(["cache", "evict", entry["name"]]) == 1
        assert prep_cache.cache_entries() == []
    finally:
        tstorage.set_storage(None)
        storage.close()
