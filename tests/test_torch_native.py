"""The port's native event codec binding against the JAX package's.

``predictionio_tpu_torch/native`` binds the repo's ``native/pio_native.cpp``
on its own (built into ``predictionio_tpu_torch/_build/``). The cases of
``tests/test_native.py`` are restated here for the port's binding, in
both codec modes -- the C++ library and the pure-Python path -- and every
output is held equal to the JAX binding's on the same buffer in the same
mode, with the jsonl store's ``prove_clean`` and chunked
``scan_ratings`` held to the JAX package's.
"""

from __future__ import annotations

import json
import math
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from predictionio_tpu import native as jnative
from predictionio_tpu_torch import native

EVENTS = [
    {
        "event": "rate",
        "entityType": "user",
        "entityId": "u1",
        "targetEntityType": "item",
        "targetEntityId": "i1",
        "properties": {"rating": 4.5},
        "eventTime": "2020-01-01T12:30:15.250Z",
    },
    {
        "event": "buy",
        "entityType": "user",
        "entityId": "u2",
        "targetEntityType": "item",
        "targetEntityId": "i1",
        "eventTime": "2020-06-01T00:00:00.000+02:00",
    },
    {
        "event": "$set",
        "entityType": "user",
        "entityId": 'u"quoted',  # escaped in JSON -> scanner fallback line
        "properties": {"a": "x", "b": 2},
        "eventTime": "2020-03-01T00:00:00.000Z",
    },
    {
        "event": "view",
        "entityType": "user",
        "entityId": "u3",
        "targetEntityType": "item",
        "targetEntityId": "i2",
        # nested object with a decoy rating: must NOT be extracted
        "properties": {"nested": {"rating": 9}, "rating": 2},
        "eventTime": "2020-04-01T08:00:00.000Z",
    },
]


def _buf():
    return "\n".join(json.dumps(d) for d in EVENTS).encode() + b"\n"


@pytest.fixture(params=["native", "python"])
def codec_mode(request, monkeypatch):
    """Both bindings in one mode: the C++ library, or the pure-Python
    path (the library reported absent)."""
    if request.param == "python":
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    else:
        assert native.native_available(), "the port's native codec did not build"
        if not jnative.native_available():
            pytest.skip("the JAX package's native codec did not build")
    return request.param


def _same_scan(a, b):
    np.testing.assert_array_equal(a.offs, b.offs)
    np.testing.assert_array_equal(a.lens, b.lens)
    np.testing.assert_array_equal(a.flags, b.flags)


def _same_events(got, want):
    """Equal events. A time the line did not carry is the decoder's clock
    reading (this minute; every line's own times are years old), so it is
    left out of the comparison."""
    now = datetime.now(timezone.utc)

    def fields(e):
        d = e.to_dict(for_api=False)
        for key, t in (("eventTime", e.event_time), ("creationTime", e.creation_time)):
            if abs((now - t).total_seconds()) < 60:
                d.pop(key)
        return d

    assert [fields(e) for e in got] == [fields(e) for e in want]


def _same_arrays(got, want):
    assert got[0] == want[0] and got[1] == want[1]
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_the_field_slots_are_the_jax_bindings():
    names = [n for n in dir(jnative) if n.startswith(("F_", "FLAG_")) or n == "N_FIELDS"]
    assert names and all(getattr(native, n) == getattr(jnative, n) for n in names)


class TestScan:
    def test_field_spans(self):
        assert native.native_available()
        s = native.scan_events(_buf())
        assert len(s) == 4
        assert s.field_str(0, native.F_EVENT) == "rate"
        assert s.field_str(0, native.F_ENTITY_ID) == "u1"
        assert s.field_str(1, native.F_TARGET_ENTITY_ID) == "i1"
        assert s.field_bytes(1, native.F_PROPERTIES) is None
        assert json.loads(s.field_bytes(3, native.F_PROPERTIES)) == EVENTS[3][
            "properties"
        ]
        assert s.flags[2] & native.FLAG_FALLBACK
        assert not s.flags[0] and not s.flags[1]
        _same_scan(s, jnative.scan_events(_buf()))

    def test_blank_lines_and_garbage(self, codec_mode):
        buf = b'\n{"event":"a","entityType":"t","entityId":"e"}\nnot json\n'
        s = native.scan_events(buf)
        assert s.flags[0] & native.FLAG_EMPTY
        assert s.flags[2] & native.FLAG_FALLBACK
        if codec_mode == "native":
            assert s.flags[1] == 0
        _same_scan(s, jnative.scan_events(buf))


class TestParseEvents:
    def test_roundtrip_all_lines(self, codec_mode):
        evs = native.parse_events_jsonl(_buf())
        assert len(evs) == 4
        assert evs[0].entity_id == "u1"
        assert evs[0].properties.to_dict() == {"rating": 4.5}
        assert evs[2].entity_id == 'u"quoted'
        assert evs[1].event_time == datetime(
            2020, 6, 1, tzinfo=timezone(timedelta(hours=2))
        )
        _same_events(evs, jnative.parse_events_jsonl(_buf()))

    def test_matches_python_json(self, codec_mode):
        from predictionio_tpu_torch.data.event import Event

        expected = [Event.from_dict(d) for d in EVENTS]
        got = native.parse_events_jsonl(_buf())
        for e, g in zip(expected, got):
            assert e.event == g.event
            assert e.entity_id == g.entity_id
            assert e.properties.to_dict() == g.properties.to_dict()
            assert e.event_time == g.event_time


class TestIndexSpans:
    def test_dense_indexing(self, codec_mode):
        buf = b"abc def abc xyz"
        offs = np.array([0, 4, 8, 12], dtype=np.int64)
        lens = np.array([3, 3, 3, 3], dtype=np.int64)
        idx, ids = native.index_spans(buf, offs, lens)
        assert list(idx) == [0, 1, 0, 2]
        assert ids == ["abc", "def", "xyz"]
        jidx, jids = jnative.index_spans(buf, offs, lens)
        np.testing.assert_array_equal(idx, jidx)
        assert ids == jids

    def test_absent_spans(self, codec_mode):
        buf = b"ab"
        offs = np.array([0, -1], dtype=np.int64)
        lens = np.array([2, 0], dtype=np.int64)
        idx, ids = native.index_spans(buf, offs, lens)
        assert list(idx) == [0, -1]
        assert ids == ["ab"]


class TestParseTimes:
    def test_formats(self, codec_mode):
        cases = [
            ("2020-01-01T12:30:15.250Z", datetime(2020, 1, 1, 12, 30, 15, 250000, tzinfo=timezone.utc)),
            ("2020-06-01T00:00:00.000+02:00", datetime(2020, 6, 1, tzinfo=timezone(timedelta(hours=2)))),
            ("1999-12-31T23:59:59Z", datetime(1999, 12, 31, 23, 59, 59, tzinfo=timezone.utc)),
        ]
        buf = " ".join(c[0] for c in cases).encode()
        offs, lens, pos = [], [], 0
        for text, _ in cases:
            offs.append(pos)
            lens.append(len(text))
            pos += len(text) + 1
        offs = np.array(offs, dtype=np.int64)
        lens = np.array(lens, dtype=np.int64)
        out = native.parse_times(buf, offs, lens)
        for got, (_, dt) in zip(out, cases):
            assert got == pytest.approx(dt.timestamp(), abs=1e-6)
        np.testing.assert_array_equal(out, jnative.parse_times(buf, offs, lens))

    def test_invalid_is_nan(self, codec_mode):
        out = native.parse_times(
            b"not-a-time", np.array([0], dtype=np.int64), np.array([10], dtype=np.int64)
        )
        assert math.isnan(out[0])


@pytest.fixture(scope="module")
def cpp_scan():
    """The C++ scan of ``_buf()``: spans for the decoders of either mode
    (the pure-Python scan flags every line and gives none)."""
    assert native.native_available()
    return native.scan_events(_buf())


class TestExtractNumber:
    def test_top_level_only(self, codec_mode, cpp_scan):
        s = cpp_scan
        args = (s.buf, s.offs[:, native.F_PROPERTIES], s.lens[:, native.F_PROPERTIES],
                "rating")
        out = native.extract_number(*args)
        assert out[0] == 4.5
        assert math.isnan(out[1])  # no properties
        assert out[3] == 2.0  # top-level, not the nested decoy
        np.testing.assert_array_equal(out, jnative.extract_number(*args))


class TestLoadRatings:
    def test_arrays_with_defaults_and_filter(self, codec_mode):
        got = native.load_ratings_jsonl(
            _buf(), event_names=["rate", "buy"], default_ratings={"buy": 4.0}
        )
        uids, iids, rows, cols, vals = got
        assert uids == ["u1", "u2"]
        assert iids == ["i1"]
        assert list(rows) == [0, 1]
        assert list(cols) == [0, 0]
        assert list(vals) == [4.5, 4.0]
        _same_arrays(got, jnative.load_ratings_jsonl(
            _buf(), event_names=["rate", "buy"], default_ratings={"buy": 4.0}))

    def test_fallback_lines_merge(self, codec_mode):
        quoted = {
            "event": "rate",
            "entityType": "user",
            "entityId": 'u"q',
            "targetEntityType": "item",
            "targetEntityId": "i9",
            "properties": {"rating": 1.0},
        }
        data = _buf() + json.dumps(quoted).encode() + b"\n"
        got = native.load_ratings_jsonl(data, event_names=["rate"])
        uids, iids, rows, cols, vals = got
        assert 'u"q' in uids and "i9" in iids
        assert vals[list(uids).index('u"q') == np.asarray(rows)][0] == 1.0
        _same_arrays(got, jnative.load_ratings_jsonl(data, event_names=["rate"]))

    def test_rows_cols_consistent(self, codec_mode):
        uids, iids, rows, cols, vals = native.load_ratings_jsonl(_buf())
        assert len(rows) == len(cols) == len(vals)
        assert rows.max() < len(uids) and cols.max() < len(iids)


class TestStrictness:
    """The native fast path rejects exactly what json + validation
    rejects, in both bindings."""

    def test_tags_and_creation_time_preserved(self, codec_mode):
        line = {
            "event": "view", "entityType": "user", "entityId": "u1",
            "tags": ["t1", "t2"],
            "creationTime": "2019-01-01T00:00:00.000Z",
            "eventTime": "2019-01-02T00:00:00.000Z",
        }
        buf = (json.dumps(line) + "\n").encode()
        (e,) = native.parse_events_jsonl(buf)
        assert e.tags == ("t1", "t2")
        assert (e.creation_time.year, e.creation_time.day) == (2019, 1)
        _same_events([e], jnative.parse_events_jsonl(buf))

    def test_concatenated_records_fail(self, codec_mode):
        bad = (
            b'{"event":"a","entityType":"t","entityId":"x"}'
            b'{"event":"b","entityType":"t","entityId":"y"}\n'
        )
        with pytest.raises(json.JSONDecodeError):
            native.parse_events_jsonl(bad)

    def test_truncated_line_fails(self, codec_mode):
        with pytest.raises(json.JSONDecodeError):
            native.parse_events_jsonl(b'{"event":"a","entityType":"t","entityId":"x"')

    def test_numeric_entity_id_rejected(self, codec_mode):
        from predictionio_tpu_torch.data.event import EventValidationError

        with pytest.raises(EventValidationError):
            native.parse_events_jsonl(
                b'{"event":"a","entityType":"t","entityId":123}\n'
            )

    def test_export_import_roundtrip_preserves_all_fields(self, tmp_path):
        from predictionio_tpu_torch.cli import commands
        from predictionio_tpu_torch.data import store
        from predictionio_tpu_torch.data.event import Event
        from predictionio_tpu_torch.data.storage import test_storage

        storage = test_storage()
        commands.app_new("RoundApp", storage=storage)
        app_id, _ = store.app_name_to_id("RoundApp", storage=storage)
        src = Event(
            event="view", entity_type="user", entity_id="u1",
            target_entity_type="item", target_entity_id="i1",
            tags=("a", "b"), pr_id="pr9",
            event_time=datetime(2020, 5, 1, tzinfo=timezone.utc),
            creation_time=datetime(2020, 5, 2, tzinfo=timezone.utc),
        )
        storage.get_events().insert(src, app_id)
        out = tmp_path / "out.jsonl"
        commands.export_events("RoundApp", str(out), storage=storage)

        commands.app_new("RoundApp2", storage=storage)
        commands.import_events("RoundApp2", str(out), storage=storage)
        (got,) = store.find("RoundApp2", storage=storage)
        assert got.tags == ("a", "b")
        assert got.pr_id == "pr9"
        assert got.event_time == src.event_time
        assert got.creation_time == src.creation_time


class TestImportUsesCodec:
    def test_import_events_roundtrip(self, tmp_path):
        from predictionio_tpu_torch.cli import commands
        from predictionio_tpu_torch.data import store
        from predictionio_tpu_torch.data.storage import test_storage

        storage = test_storage()
        commands.app_new("NativeApp", storage=storage)
        p = tmp_path / "events.jsonl"
        p.write_bytes(_buf())
        assert commands.import_events("NativeApp", str(p), storage=storage) == 4
        evs = store.find("NativeApp", storage=storage)
        assert len(evs) == 4
        assert {e.entity_id for e in evs} == {"u1", "u2", 'u"quoted', "u3"}


class TestThreadedScan:
    def test_threaded_scan_matches_serial(self, monkeypatch):
        """The multithreaded line scanner gives the serial spans and flags
        (PIO_NATIVE_THREADS forces the thread count), and the JAX
        binding's."""
        lines = []
        for i in range(1200):
            if i % 97 == 0:
                lines.append("")
            elif i % 53 == 0:
                lines.append('{"event":"r\\u0061te","entityId":"e"}')
            else:
                lines.append(
                    '{"event":"rate","entityType":"user","entityId":"u%d",'
                    '"properties":{"rating":%d.0},"eventId":"x%d"}'
                    % (i, i % 5, i)
                )
        big = (("\n".join(lines) + "\n").encode()) * 200
        monkeypatch.setenv("PIO_NATIVE_THREADS", "1")
        s1 = native.scan_events(big)
        monkeypatch.setenv("PIO_NATIVE_THREADS", "4")
        s4 = native.scan_events(big)
        _same_scan(s1, s4)
        _same_scan(s4, jnative.scan_events(big))


class TestRouting:
    def test_route_id_bytes_rule(self):
        for s in (b"03-abcdef", b"ff-abcdef", b"G3-abc", b"plain"):
            assert native.route_id_bytes(s, 8) == jnative.route_id_bytes(s, 8)
        assert native.route_id_bytes(b"03-abcdef", 8) == 3
        assert native.route_id_bytes(b"plain", 8) == native.fnv1a32(b"plain") % 8

    def test_native_route_ids_matches_python(self):
        ids = [b"03-x", b"ff-y", b"e123", b"07-z", b"G1-q", b"a" * 40]
        buf = b"".join(ids)
        offs, lens, pos = [], [], 0
        for s in ids:
            offs.append(pos)
            lens.append(len(s))
            pos += len(s)
        offs.append(-1)
        lens.append(0)
        offs = np.asarray(offs, np.int64)
        lens = np.asarray(lens, np.int64)
        got = native.route_ids(buf, offs, lens, 8)
        assert got.tolist() == [native.route_id_bytes(s, 8) for s in ids] + [-1]
        np.testing.assert_array_equal(got, jnative.route_ids(buf, offs, lens, 8))

    def test_degraded_python_route_ids(self, monkeypatch):
        monkeypatch.setattr(native, "_load", lambda: None)
        ids = [b"03-x", b"zz", b"ff-y"]
        buf = b"".join(ids)
        offs = np.asarray([0, 4, 6], np.int64)
        lens = np.asarray([4, 2, 4], np.int64)
        got = native.route_ids(buf, offs, lens, 8)
        assert got.tolist() == [native.route_id_bytes(s, 8) for s in ids]


class TestFuzzScannerVsJson:
    """For every generated line the span scanner extracts what json.loads
    sees, or flags the line for the json fallback; and the port's spans
    are the JAX binding's."""

    FIELDS = {
        "event": native.F_EVENT,
        "entityType": native.F_ENTITY_TYPE,
        "entityId": native.F_ENTITY_ID,
        "targetEntityType": native.F_TARGET_ENTITY_TYPE,
        "targetEntityId": native.F_TARGET_ENTITY_ID,
        "eventTime": native.F_EVENT_TIME,
        "prId": native.F_PR_ID,
        "eventId": native.F_EVENT_ID,
        "creationTime": native.F_CREATION_TIME,
    }

    def _random_string(self, rng):
        clean = ["plain-ascii_09", "user-42", "a" * 50, "", "x.y/z"]
        nasty = ["späce ünïcode ☃", 'quo"te', "back\\slash", "tab\tchar", "ライン"]
        if rng.random() < 0.75:
            return clean[rng.integers(0, len(clean))]
        return nasty[rng.integers(0, len(nasty))]

    def test_random_lines_never_extract_wrong_values(self):
        rng = np.random.default_rng(1234)
        lines, recs = [], []
        for _ in range(500):
            rec = {}
            for name in self.FIELDS:
                if rng.random() < 0.7:
                    rec[name] = self._random_string(rng)
            if rng.random() < 0.5:
                rec["properties"] = {
                    "rating": float(rng.integers(1, 6)),
                    "note": self._random_string(rng),
                }
            if rng.random() < 0.3:
                rec["tags"] = [self._random_string(rng)]
            if rng.random() < 0.2:
                rec["extraKey"] = self._random_string(rng)
            recs.append(rec)
            lines.append(json.dumps(rec, ensure_ascii=rng.random() < 0.5))
        buf = ("\n".join(lines) + "\n").encode()
        scanned = native.scan_events(buf)
        assert len(scanned) == len(recs)
        n_fast = sum(1 for f in scanned.flags if not (f & native.FLAG_FALLBACK))
        assert n_fast >= 50  # the parity loop is not vacuous
        for i, rec in enumerate(recs):
            if scanned.flags[i] & native.FLAG_FALLBACK:
                continue
            for name, slot in self.FIELDS.items():
                assert scanned.field_str(i, slot) == rec.get(name), (i, name)
        _same_scan(scanned, jnative.scan_events(buf))

    def test_malformed_lines_always_flagged(self, codec_mode):
        malformed = [
            b'{"event":"a"', b'{"event":"a"}{"event":"b"}', b'["not","an","object"]',
            b'garbage', b'{"event":}', b'{broken', b'{"a":"b",}',
        ]
        buf = b"\n".join(malformed) + b"\n"
        scanned = native.scan_events(buf)
        for i in range(len(malformed)):
            assert scanned.flags[i] & native.FLAG_FALLBACK, malformed[i]
        _same_scan(scanned, jnative.scan_events(buf))

    def test_escaped_key_forces_fallback(self, codec_mode):
        line = (
            b'{"event":"rate","entityType":"user","entityId":"x",'
            b'"entityI\\u0064":"y"}\n'
        )
        assert native.scan_events(line).flags[0] & native.FLAG_FALLBACK
        (e,) = native.parse_events_jsonl(line)
        assert e.entity_id == "y"  # json.loads semantics
        _same_events([e], jnative.parse_events_jsonl(line))


class TestChunkedScan:
    """The bounded-memory bulk read: chunked loads equal the whole-buffer
    path, and the JAX binding's chunked load."""

    @staticmethod
    def _log(n=500):
        rng = np.random.default_rng(7)
        lines = [
            '{"event":"rate","entityType":"user","entityId":"u%d",'
            '"targetEntityType":"item","targetEntityId":"i%d",'
            '"properties":{"rating":%d.0},'
            '"eventTime":"2020-01-01T00:00:00.000Z","eventId":"e%d"}'
            % (u, i, r, j)
            for j, (u, i, r) in enumerate(zip(rng.integers(0, 37, n).tolist(),
                                              rng.integers(0, 23, n).tolist(),
                                              rng.integers(1, 6, n).tolist()))
        ]
        return ("\n".join(lines) + "\n").encode()

    def test_chunked_loader_matches_whole_buffer(self, codec_mode):
        buf = self._log(700)
        wu, wi, wr, wc, wv = native.load_ratings_jsonl(buf, event_names=["rate"])
        chunked = native.load_ratings_jsonl_chunked(
            buf, chunk_bytes=4096, event_names=["rate"]
        )
        cu, ci, cr, cc, cv = chunked
        w = sorted(zip((wu[r] for r in wr), (wi[c] for c in wc), wv))
        c = sorted(zip((cu[r] for r in cr), (ci[c] for c in cc), cv))
        assert w == c
        _same_arrays(chunked, jnative.load_ratings_jsonl_chunked(
            buf, chunk_bytes=4096, event_names=["rate"]))

    def test_chunked_loader_small_buffer_passthrough(self):
        buf = self._log(10)
        a = native.load_ratings_jsonl_chunked(buf, chunk_bytes=1 << 20)
        _same_arrays(a, native.load_ratings_jsonl(buf))

    def test_prove_clean_chunked_matches_whole(self):
        from predictionio_tpu.data.storage import jsonl as jjsonl
        from predictionio_tpu_torch.data.storage.jsonl import (
            prove_clean,
            prove_clean_chunked,
        )

        clean = self._log(400)
        # a cross-chunk duplicate id: the last line repeats the first's
        dirty = clean.replace(b'"eventId":"e399"}', b'"eventId":"e0"}')
        marked = clean + b'{"$delete": "e1"}\n'
        for buf, want in ((clean, False), (dirty, True), (marked, True)):
            assert prove_clean(buf)[0] is want
            assert prove_clean_chunked(buf, chunk_bytes=2048)[0] is want
            assert jjsonl.prove_clean_chunked(buf, chunk_bytes=2048)[0] is want

    def test_jsonl_scan_ratings_chunked_path(self, tmp_path, monkeypatch):
        """The big-buffer path through the jsonl store equals the normal
        path, and the JAX store's chunked read of the same log."""
        from predictionio_tpu.data.storage import jsonl as jjsonl
        from predictionio_tpu_torch.data.storage import jsonl as jmod

        dao = jmod.JSONLEvents(jmod.JSONLStorageClient({"path": str(tmp_path)}))
        dao.append_jsonl(self._log(600), 1)
        normal = dao.scan_ratings(1, event_names=["rate"])
        monkeypatch.setattr(jmod, "SCAN_CHUNK_BYTES", 4096)
        monkeypatch.setattr(jjsonl, "SCAN_CHUNK_BYTES", 4096)
        dao._c.clean_stat.clear()
        chunked = dao.scan_ratings(1, event_names=["rate"])
        jdao = jjsonl.JSONLEvents(jjsonl.JSONLStorageClient(
            {"path": str(tmp_path), "columnar_cache": "0"}))
        want = jdao.scan_ratings(1, event_names=["rate"])

        def triples(b):
            return sorted((b.entity_ids[r], b.target_ids[c], float(v))
                          for r, c, v in zip(b.rows, b.cols, b.vals))

        assert triples(normal) == triples(chunked) == triples(want)
        assert len(chunked) == 600


class TestSpliceLines:
    def test_native_splice_matches_python_loop(self):
        """pio_splice_lines splices each line as the Python loop does, and
        as the JAX binding does."""
        lines = [
            b'{"event":"rate","entityType":"user","entityId":"u1"}',
            b'{"event":"rate","entityType":"user","entityId":"u2",'
            b'"eventId":"abc"}   ',
            b'{"event":"buy","entityType":"user","entityId":"u3",'
            b'"creationTime":"2020-01-01T00:00:00.000Z"}',
        ]
        buf = b"\n".join(lines) + b"\n"
        starts = np.array([0, len(lines[0]) + 1,
                           len(lines[0]) + len(lines[1]) + 2], np.int64)
        ends = starts + np.array([len(x) for x in lines], np.int64)
        want_id = np.array([1, 0, 1], np.uint8)
        want_ct = np.array([1, 1, 0], np.uint8)
        ids = b"a" * 32 + b"b" * 32
        ct = b',"creationTime":"2021-02-03T04:05:06.000Z"'
        blob = native.splice_lines(buf, starts, ends, want_id, want_ct, ids, ct)
        assert blob is not None
        got = blob.rstrip(b"\n").split(b"\n")
        assert got[0] == lines[0][:-1] + b',"eventId":"' + b"a" * 32 + b'"' + ct + b"}"
        assert got[1] == lines[1].rstrip()[:-1] + ct + b"}"
        assert got[2] == lines[2][:-1] + b',"eventId":"' + b"b" * 32 + b'"}'
        assert blob == jnative.splice_lines(buf, starts, ends, want_id, want_ct, ids, ct)
        from predictionio_tpu_torch.data.event import Event

        for line in got:
            Event.from_json(line.decode())


class TestHashSpans:
    def test_hash64_spans_match_the_jax_binding(self):
        buf = b"alpha beta alpha"
        offs = np.array([0, 6, 11, -1], np.int64)
        lens = np.array([5, 4, 5, 0], np.int64)
        got = native.hash64_spans(buf, offs, lens)
        assert got[0] == got[2] and got[0] != got[1] and got[3] == 0
        np.testing.assert_array_equal(got, jnative.hash64_spans(buf, offs, lens))
