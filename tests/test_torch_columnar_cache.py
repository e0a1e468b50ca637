"""The port's columnar segment cache: parity with the row scan,
invalidation on every mutation path, and graceful fallback on corruption
(``tests/test_columnar_cache.py`` restated for ``predictionio_tpu_torch``;
cache files across the packages are in
``tests/test_torch_filelog_compat.py``).

The row scan (``PIO_COLUMNAR_CACHE=0``) is the correctness oracle for
the cached path — cold (build) and warm (mmap hit) scans must return
bit-identical arrays. ``base.Events.scan_ratings`` stays the semantic
oracle: jsonl matches it array-for-array; partitioned merges partitions
in partition order (a pre-existing property of its fast path), so there
the comparison is on sorted triples, same as test_partitioned.py.
"""

import json
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base as storage_base
from predictionio_tpu_torch.data.storage import columnar_cache
from predictionio_tpu_torch.data.storage.jsonl import JSONLEvents, JSONLStorageClient
from predictionio_tpu_torch.data.storage.partitioned import (
    PartitionedEvents,
    PartitionedStorageClient,
)

T0 = datetime(2020, 1, 1, tzinfo=timezone.utc)
APP = 5

KWARGS = dict(
    event_names=["rate", "like"],
    entity_type="user",
    target_entity_type="item",
    default_ratings={"like": 1.0},
    override_ratings={"buy": 4.0},
)


def _make_jsonl(tmp_path):
    return JSONLEvents(JSONLStorageClient({"path": str(tmp_path / "j")}))


def _make_partitioned(tmp_path):
    # tiny segments so sealing happens and the cache covers active +
    # sealed segments on a small dataset
    return PartitionedEvents(
        PartitionedStorageClient(
            {"path": str(tmp_path / "p"), "partitions": 4,
             "segment_bytes": 600}
        )
    )


@pytest.fixture(params=["jsonl", "partitioned"])
def dao(request, tmp_path):
    make = _make_jsonl if request.param == "jsonl" else _make_partitioned
    d = make(tmp_path)
    d.init(APP)
    return d


def _seed(dao):
    """Mixed dataset: rate/like/buy events, $set/$unset property events,
    an in-place replacement, and a $delete — the full replay surface."""
    ids = []
    for i in range(40):
        ids.append(dao.insert(
            Event(
                event="rate", entity_type="user", entity_id=f"u{i % 7}",
                target_entity_type="item", target_entity_id=f"i{i % 5}",
                properties={"rating": float(i % 5 + 1)},
                event_time=T0 + timedelta(minutes=i),
            ), APP))
    for i in range(6):
        dao.insert(
            Event(
                event="like", entity_type="user", entity_id=f"u{i}",
                target_entity_type="item", target_entity_id=f"i{i % 3}",
                event_time=T0 + timedelta(hours=1, minutes=i),
            ), APP)
    dao.insert(
        Event(
            event="buy", entity_type="user", entity_id="u1",
            target_entity_type="item", target_entity_id="i4",
            properties={"rating": 99.0},  # override must beat this
        ), APP)
    dao.insert(
        Event(event="$set", entity_type="item", entity_id="i1",
              properties={"categories": ["c1"]}), APP)
    dao.insert(
        Event(event="$unset", entity_type="item", entity_id="i1",
              properties={"categories": ["c1"]}), APP)
    # last-write-wins replacement of an existing event id
    dao.insert(
        Event(
            event="rate", entity_type="user", entity_id="u1",
            target_entity_type="item", target_entity_id="i2",
            properties={"rating": 5.0}, event_id=ids[4],
        ), APP)
    dao.delete(ids[3], APP)
    return ids


def _assert_same_batch(a, b):
    assert a.entity_ids == b.entity_ids
    assert a.target_ids == b.target_ids
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.cols, b.cols)
    np.testing.assert_array_equal(a.vals, b.vals)


def _triples(batch):
    return sorted(
        (batch.entity_ids[r], batch.target_ids[c], float(v))
        for r, c, v in zip(batch.rows, batch.cols, batch.vals)
    )


def _cache_files(dao):
    root = Path(dao._c.base_path)
    return sorted(root.rglob("*" + columnar_cache.SUFFIX))


class TestParity:
    def test_row_cold_warm_identical(self, dao, monkeypatch):
        _seed(dao)
        monkeypatch.setenv("PIO_COLUMNAR_CACHE", "0")
        row = dao.scan_ratings(APP, **KWARGS)
        assert not _cache_files(dao)
        monkeypatch.delenv("PIO_COLUMNAR_CACHE")
        cold = dao.scan_ratings(APP, **KWARGS)  # builds the cache
        assert _cache_files(dao)
        warm = dao.scan_ratings(APP, **KWARGS)  # serves from it
        _assert_same_batch(row, cold)
        _assert_same_batch(row, warm)
        assert len(warm) > 0

    def test_warm_scan_never_parses_rows(self, dao):
        from unittest import mock

        _seed(dao)
        dao.scan_ratings(APP, **KWARGS)  # build
        with mock.patch(
            "predictionio_tpu_torch.native.load_ratings_jsonl",
            side_effect=AssertionError("row parse on warm scan"),
        ), mock.patch(
            "predictionio_tpu_torch.native.load_ratings_jsonl_chunked",
            side_effect=AssertionError("row parse on warm scan"),
        ):
            warm = dao.scan_ratings(APP, **KWARGS)
        assert len(warm) > 0

    def test_matches_base_oracle(self, dao):
        """Same event set as the per-event replay oracle. Dense id ORDER
        is a fast-path property (replacements/partition merges place
        rows differently than the oracle's replay table — pre-existing,
        see test_partitioned.test_columnar_matches_base_fallback), so
        the cross-implementation comparison is on sorted triples; exact
        array parity is covered by test_row_cold_warm_identical."""
        _seed(dao)
        oracle = storage_base.Events.scan_ratings(dao, APP, **KWARGS)
        dao.scan_ratings(APP, **KWARGS)  # build
        warm = dao.scan_ratings(APP, **KWARGS)
        assert _triples(warm) == _triples(oracle)
        # the $delete'd and replaced events must not appear
        assert len(warm) == len(oracle)

    def test_rating_key_mismatch_falls_back_correctly(self, dao):
        _seed(dao)
        dao.scan_ratings(APP, **KWARGS)  # cache built with key "rating"
        got = dao.scan_ratings(
            APP, event_names=["rate"], rating_key="nosuch",
            default_ratings={"rate": 2.5},
        )
        oracle = storage_base.Events.scan_ratings(
            dao, APP, event_names=["rate"], rating_key="nosuch",
            default_ratings={"rate": 2.5},
        )
        assert _triples(got) == _triples(oracle)
        assert set(np.asarray(got.vals)) == {2.5}


class TestInvalidation:
    def test_append_invalidates(self, dao):
        _seed(dao)
        dao.scan_ratings(APP, **KWARGS)  # build
        before = dao.scan_ratings(APP, **KWARGS)
        dao.insert(
            Event(
                event="rate", entity_type="user", entity_id="u99",
                target_entity_type="item", target_entity_id="i99",
                properties={"rating": 3.0},
            ), APP)
        after = dao.scan_ratings(APP, **KWARGS)
        assert len(after) == len(before) + 1
        assert ("u99", "i99", 3.0) in _triples(after)

    def test_delete_invalidates(self, dao):
        ids = _seed(dao)
        dao.scan_ratings(APP, **KWARGS)  # build
        before = dao.scan_ratings(APP, **KWARGS)
        dao.delete(ids[10], APP)
        after = dao.scan_ratings(APP, **KWARGS)
        assert len(after) == len(before) - 1
        oracle = storage_base.Events.scan_ratings(dao, APP, **KWARGS)
        assert _triples(after) == _triples(oracle)

    def test_jsonl_compaction_drops_cache(self, tmp_path):
        dao = _make_jsonl(tmp_path)
        dao.init(APP)
        ids = _seed(dao)
        dao.scan_ratings(APP, **KWARGS)
        assert _cache_files(dao)
        dao.compact(APP)
        # post-compaction scans must rebuild and agree with the oracle
        got = dao.scan_ratings(APP, **KWARGS)
        oracle = storage_base.Events.scan_ratings(dao, APP, **KWARGS)
        assert _triples(got) == _triples(oracle)
        assert ids  # dataset was non-trivial


class TestFallback:
    def test_corrupt_cache_falls_back(self, dao, monkeypatch):
        _seed(dao)
        monkeypatch.setenv("PIO_COLUMNAR_CACHE", "0")
        row = dao.scan_ratings(APP, **KWARGS)
        monkeypatch.delenv("PIO_COLUMNAR_CACHE")
        dao.scan_ratings(APP, **KWARGS)  # build
        files = _cache_files(dao)
        assert files
        for i, f in enumerate(files):
            if i % 2 == 0:  # garbage body, plausible size
                f.write_bytes(b"\x00garbage" * 64)
            else:  # truncation mid-header
                f.write_bytes(f.read_bytes()[:20])
        got = dao.scan_ratings(APP, **KWARGS)
        _assert_same_batch(row, got)

    def test_truncated_to_zero_falls_back(self, dao, monkeypatch):
        _seed(dao)
        monkeypatch.setenv("PIO_COLUMNAR_CACHE", "0")
        row = dao.scan_ratings(APP, **KWARGS)
        monkeypatch.delenv("PIO_COLUMNAR_CACHE")
        dao.scan_ratings(APP, **KWARGS)
        for f in _cache_files(dao):
            f.write_bytes(b"")
        got = dao.scan_ratings(APP, **KWARGS)
        _assert_same_batch(row, got)

    def test_env_kill_switch_writes_nothing(self, dao, monkeypatch):
        _seed(dao)
        monkeypatch.setenv("PIO_COLUMNAR_CACHE", "0")
        dao.scan_ratings(APP, **KWARGS)
        dao.scan_ratings(APP, **KWARGS)
        assert not _cache_files(dao)

    def test_source_prop_disables(self, tmp_path):
        dao = JSONLEvents(
            JSONLStorageClient(
                {"path": str(tmp_path / "j"), "columnar_cache": "false"}
            )
        )
        dao.init(APP)
        _seed(dao)
        dao.scan_ratings(APP, **KWARGS)
        assert not _cache_files(dao)


class TestFormat:
    def test_load_rejects_bad_magic_and_header(self, tmp_path):
        src = tmp_path / "events_1.jsonl"
        src.write_text(
            '{"event":"rate","entityType":"user","entityId":"u1",'
            '"targetEntityType":"item","targetEntityId":"i1",'
            '"properties":{"rating":3.0},"eventId":"e1"}\n'
        )
        blocks = columnar_cache.build_blocks(src.read_bytes())
        assert blocks is not None
        cpath = columnar_cache.cache_path(src)
        st = src.stat()
        assert columnar_cache.store(
            cpath, (st.st_mtime_ns, st.st_size), blocks
        )
        cb = columnar_cache.load(cpath)
        assert cb is not None and cb.valid_for((st.st_mtime_ns, st.st_size))
        assert not cb.valid_for((st.st_mtime_ns + 1, st.st_size))
        # bad magic
        raw = bytearray(cpath.read_bytes())
        raw[:4] = b"XXXX"
        cpath.write_bytes(bytes(raw))
        assert columnar_cache.load(cpath) is None
        # valid magic, mangled JSON header
        raw = bytearray(
            columnar_cache.MAGIC + (999999).to_bytes(8, "little") + b"{}"
        )
        cpath.write_bytes(bytes(raw))
        assert columnar_cache.load(cpath) is None

    def test_build_bails_on_fallback_lines(self, tmp_path):
        # an escaped entityId forces the native scanner's fallback flag;
        # such logs are never cached (the cached path must stay exactly
        # the vectorized native scan)
        src = tmp_path / "events_1.jsonl"
        src.write_text(
            json.dumps({
                "event": "rate", "entityType": "user",
                "entityId": 'u"1', "targetEntityType": "item",
                "targetEntityId": "i1", "properties": {"rating": 3.0},
                "eventId": "e1",
            }) + "\n"
        )
        assert columnar_cache.build_blocks(src.read_bytes()) is None


class TestSharedDecoder:
    """Tentpole invariant: ONE span->array decoder (colspans) under the
    cache cold-build, the tailer's columnar poll, and ``pio import`` —
    the cache must literally call it, and the tail decoder's shape
    classifier must keep exactly the rows the native rating oracle
    keeps."""

    def test_cache_build_calls_shared_decoder(self, tmp_path, monkeypatch):
        from predictionio_tpu_torch.data.storage import colspans

        src = tmp_path / "events_1.jsonl"
        src.write_text(
            '{"event":"rate","entityType":"user","entityId":"u1",'
            '"targetEntityType":"item","targetEntityId":"i1",'
            '"properties":{"rating":3.0},"eventId":"e1"}\n'
        )
        calls = []
        orig = colspans.decode_columns

        def spying(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        monkeypatch.setattr(colspans, "decode_columns", spying)
        blocks = columnar_cache.build_blocks(src.read_bytes())
        assert blocks is not None
        assert calls, "cache cold-build bypassed the shared decoder"
        # the sentinel rides along too: one definition, re-exported
        assert columnar_cache.TIME_ABSENT is colspans.TIME_ABSENT

    def test_tail_decoder_matches_native_oracle(self):
        from predictionio_tpu_torch import native
        from predictionio_tpu_torch.data.storage import colspans

        if not native.native_available():
            pytest.skip("native scanner unavailable")
        lines = [
            json.dumps({
                "event": "rate", "entityType": "user", "entityId": f"u{i}",
                "targetEntityType": "item", "targetEntityId": f"i{i % 3}",
                "properties": {"rating": float(i % 5 + 1)},
                "eventId": f"e{i}",
            }) for i in range(8)
        ]
        lines.append(json.dumps({
            "event": "like", "entityType": "user", "entityId": "u1",
            "targetEntityType": "item", "targetEntityId": "i9",
            "eventId": "lk1",
        }))
        lines.append(json.dumps({
            "event": "buy", "entityType": "user", "entityId": "u2",
            "targetEntityType": "item", "targetEntityId": "i1",
            "properties": {"rating": 99.0}, "eventId": "by1",
        }))
        lines.append(json.dumps({
            "event": "$set", "entityType": "item", "entityId": "i1",
            "properties": {"categories": ["c1"]}, "eventId": "st1",
        }))
        lines.append(json.dumps({
            "event": "rate", "entityType": "user", "entityId": "u3",
            "targetEntityType": "item", "targetEntityId": "i2",
            "eventId": "nr1",  # rate-shaped, no resolvable rating
        }))
        buf = ("\n".join(lines) + "\n").encode()
        sel = dict(
            event_names=("rate", "like", "buy"),
            default_ratings={"like": 1.0},
            override_ratings={"buy": 4.0},
            entity_type="user",
            target_entity_type="item",
        )
        tail = colspans.decode_tail(
            buf, colspans.DecodeConfig(rating_key="rating", **sel)
        )
        users, items, rows, cols, vals = native.load_ratings_jsonl(
            buf, rating_key="rating", **sel
        )
        got = sorted(
            (tail.user_ids[u], tail.item_ids[it], float(v))
            for u, it, v in zip(tail.user_idx, tail.item_idx, tail.ratings)
        )
        want = sorted(
            (users[r], items[c], float(v))
            for r, c, v in zip(rows, cols, vals)
        )
        assert got == want
        # the classifier routed the $set and the bare rate — and ONLY
        # those — to the object path
        routed = {buf.split(b"\n")[i] for i in tail.fallback_lines}
        assert routed == {lines[-2].encode(), lines[-1].encode()}


@pytest.mark.chaos
class TestCrashConsistency:
    """Torn-write / kill-9 behavior of the cache publish path: a crash
    at any byte leaves either the old cache or the new one, a leftover
    torn tmp is inert, and an injected store failure degrades to the
    row scan (never an error, never wrong data)."""

    def _row_oracle(self, dao, monkeypatch):
        monkeypatch.setenv("PIO_COLUMNAR_CACHE", "0")
        row = dao.scan_ratings(APP, **KWARGS)
        monkeypatch.delenv("PIO_COLUMNAR_CACHE")
        return row

    def test_injected_store_failure_degrades_to_row_scan(self, dao, monkeypatch):
        from predictionio_tpu_torch import faults

        _seed(dao)
        row = self._row_oracle(dao, monkeypatch)
        with faults.injected("colcache.store:always"):
            got = dao.scan_ratings(APP, **KWARGS)
            _assert_same_batch(row, got)
        assert not _cache_files(dao)  # nothing half-published
        # fault cleared: the next scan rebuilds and still matches
        rebuilt = dao.scan_ratings(APP, **KWARGS)
        _assert_same_batch(row, rebuilt)
        assert _cache_files(dao)

    def test_crash_between_write_and_rename_leaves_old_cache(
        self, dao, monkeypatch
    ):
        """A kill after the tmp write but before the rename (emulated by
        injecting at the storage.rename point) must leave the previous
        cache intact and the torn tmp inert."""
        from predictionio_tpu_torch import faults

        _seed(dao)
        row = self._row_oracle(dao, monkeypatch)
        dao.scan_ratings(APP, **KWARGS)  # publish generation 1
        files_before = _cache_files(dao)
        assert files_before
        # invalidate, then crash the republish at the rename
        dao.insert(
            Event(
                event="rate", entity_type="user", entity_id="u50",
                target_entity_type="item", target_entity_id="i2",
                properties={"rating": 2.0},
            ), APP)
        with faults.injected("storage.rename:always"):
            got = dao.scan_ratings(APP, **KWARGS)  # row path; store fails
        oracle = storage_base.Events.scan_ratings(dao, APP, **KWARGS)
        assert _triples(got) == _triples(oracle)
        # the failed publish appears as stale-or-absent, never torn: the
        # next scan detects staleness, rebuilds, and matches the oracle
        rebuilt = dao.scan_ratings(APP, **KWARGS)
        assert _triples(rebuilt) == _triples(oracle)
        assert len(row) + 1 == len(rebuilt)

    def test_leftover_torn_tmp_is_inert(self, dao, monkeypatch):
        _seed(dao)
        row = self._row_oracle(dao, monkeypatch)
        dao.scan_ratings(APP, **KWARGS)
        files = _cache_files(dao)
        assert files
        for f in files:
            torn = f.with_name(f.name + ".tmp.99999")
            torn.write_bytes(f.read_bytes()[:13])  # torn mid-header
        got = dao.scan_ratings(APP, **KWARGS)
        _assert_same_batch(row, got)
