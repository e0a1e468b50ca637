"""The port's file-log event stores: ``tests/test_backends.py``'s jsonl
and partitioned cases (the log, capability defaults, cross-process
compaction, the import splice, change tokens, group commit, the export
splice, the differential fuzz) restated for ``predictionio_tpu_torch``,
and the kill -9 rows of ``tests/test_storage.py``. The cases that hold
the port's stores to the JAX package's on the same bytes are in
``tests/test_torch_filelog_compat.py``."""

import json
import threading
from datetime import datetime, timedelta, timezone

import pytest

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import Model, Storage, StorageError
from predictionio_tpu_torch.data.storage.jsonl import JSONLEvents, JSONLStorageClient

T0 = datetime(2020, 1, 1, tzinfo=timezone.utc)


def _event(i):
    return Event(
        event="rate",
        entity_type="user",
        entity_id=f"u{i}",
        properties={"rating": float(i)},
        event_time=T0 + timedelta(minutes=i),
    )


class TestJSONLEvents:
    def test_log_survives_reopen(self, tmp_path):
        events = JSONLEvents(JSONLStorageClient({"path": str(tmp_path)}))
        ids = [events.insert(_event(i), 7) for i in range(5)]
        events.delete(ids[0], 7)
        # a fresh client over the same dir replays the same state
        events2 = JSONLEvents(JSONLStorageClient({"path": str(tmp_path)}))
        assert events2.get(ids[0], 7) is None
        assert len(events2.find(7)) == 4

    def test_replacement_last_write_wins(self, tmp_path):
        events = JSONLEvents(JSONLStorageClient({"path": str(tmp_path)}))
        eid = events.insert(_event(1), 1)
        updated = Event(
            event="rate", entity_type="user", entity_id="u1",
            properties={"rating": 5.0}, event_id=eid,
        )
        events.insert(updated, 1)
        assert len(events.find(1)) == 1
        assert events.get(eid, 1).properties["rating"] == 5.0

    def test_compact_shrinks_log(self, tmp_path):
        client = JSONLStorageClient({"path": str(tmp_path)})
        events = JSONLEvents(client)
        ids = [events.insert(_event(i), 3) for i in range(10)]
        for eid in ids[:6]:
            events.delete(eid, 3)
        log = client.base_path / "events_3.jsonl"
        lines_before = len(log.read_text().splitlines())
        live = events.compact(3)
        assert live == 4
        assert len(log.read_text().splitlines()) == 4 < lines_before
        assert len(events.find(3)) == 4

    def test_creation_time_and_microseconds_roundtrip(self, tmp_path):
        """Replayed events are identical to the inserted ones: creation
        time survives and exact-timestamp cursor queries still match."""
        events = JSONLEvents(JSONLStorageClient({"path": str(tmp_path)}))
        e = Event(
            event="rate", entity_type="user", entity_id="u1",
            event_time=T0 + timedelta(microseconds=123_456),
        )
        eid = events.insert(e, 1)
        got = events.get(eid, 1)
        assert got.creation_time == e.creation_time
        assert got.event_time == e.event_time
        # cursoring from the exact event_time finds the event
        assert len(events.find(1, start_time=e.event_time)) == 1
        events.compact(1)
        assert events.get(eid, 1).creation_time == e.creation_time

    def test_channel_files_isolated(self, tmp_path):
        events = JSONLEvents(JSONLStorageClient({"path": str(tmp_path)}))
        events.insert(_event(1), 1, channel_id=None)
        events.insert(_event(2), 1, channel_id=42)
        assert len(events.find(1)) == 1
        assert len(events.find(1, channel_id=42)) == 1
        assert events.remove(1, channel_id=42)
        assert events.find(1, channel_id=42) == []


class TestCapabilityDefaults:
    def test_jsonl_never_claims_metadata(self, tmp_path):
        s = Storage(
            env={
                "PIO_STORAGE_SOURCES_LOG_TYPE": "jsonl",
                "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp_path / "log"),
                "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
                "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db"),
            }
        )
        assert s.repository_source("METADATA") == ("DB", "sqlite")
        assert s.repository_source("EVENTDATA") == ("LOG", "jsonl")

    def test_explicit_binding_beats_capability(self, tmp_path):
        s = Storage(
            env={
                "PIO_STORAGE_SOURCES_LOG_TYPE": "jsonl",
                "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp_path / "log"),
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "LOG",
            }
        )
        with pytest.raises(StorageError, match="does not support"):
            s.get_metadata_apps()


class TestRegressions:
    def test_jsonl_append_vs_compact_across_processes(self, tmp_path):
        """A writer in another OS process must not lose records to a
        concurrent compact (an in-process lock alone would let it)."""
        import subprocess
        import sys
        import textwrap

        client = JSONLStorageClient({"path": str(tmp_path)})
        events = JSONLEvents(client)
        events.init(11)
        n_child = 200
        child = subprocess.Popen(
            [
                sys.executable,
                "-c",
                textwrap.dedent(
                    f"""
                    from predictionio_tpu_torch.data.storage.jsonl import (
                        JSONLEvents, JSONLStorageClient)
                    from predictionio_tpu_torch.data.event import Event
                    ev = JSONLEvents(JSONLStorageClient({{"path": {str(tmp_path)!r}}}))
                    for i in range({n_child}):
                        ev.insert(Event(event="rate", entity_type="user",
                                        entity_id=f"c{{i}}"), 11)
                    """
                ),
            ],
        )
        # compact continuously while the child appends
        while child.poll() is None:
            events.compact(11)
        assert child.returncode == 0
        events.compact(11)
        assert len(events.find(11)) == n_child


class TestSpliceImport:
    """Import splice-through fast path for jsonl (cli/commands.py):
    validated lines append verbatim; edge lines take the parse path."""

    def _run_import(self, tmp_path, lines):
        import predictionio_tpu_torch.cli.commands as commands
        from predictionio_tpu_torch.data.storage import App, Storage

        s = Storage(
            env={
                "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
                "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db"),
                "PIO_STORAGE_SOURCES_LOG_TYPE": "jsonl",
                "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp_path / "events"),
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
            }
        )
        s.get_metadata_apps().insert(App(0, "Imp"))
        f = tmp_path / "in.jsonl"
        f.write_text("\n".join(lines) + "\n")
        n = commands.import_events("Imp", str(f), storage=s)
        return s, n

    def test_mixed_fast_and_fallback_lines(self, tmp_path):
        import json as _json

        lines = [
            # fast path: plain rate events
            '{"event":"rate","entityType":"user","entityId":"u1",'
            '"targetEntityType":"item","targetEntityId":"i1",'
            '"properties":{"rating":3.0},"eventTime":"2020-01-01T00:00:00.000Z"}',
            '{"event":"buy","entityType":"user","entityId":"u2",'
            '"targetEntityType":"item","targetEntityId":"i2",'
            '"eventTime":"2020-01-02T00:00:00.000Z"}',
            # reserved event -> slow path (still valid)
            '{"event":"$set","entityType":"user","entityId":"u3",'
            '"properties":{"a":1},"eventTime":"2020-01-03T00:00:00.000Z"}',
            # no eventTime -> slow path stamps receipt time
            '{"event":"rate","entityType":"user","entityId":"u4",'
            '"targetEntityType":"item","targetEntityId":"i4",'
            '"properties":{"rating":1.0}}',
            # explicit eventId preserved on the fast path
            '{"event":"rate","entityType":"user","entityId":"u5",'
            '"targetEntityType":"item","targetEntityId":"i5",'
            '"properties":{"rating":2.0},"eventTime":"2020-01-05T00:00:00.000Z",'
            '"eventId":"fixedid01"}',
        ]
        s, n = self._run_import(tmp_path, lines)
        assert n == 5
        events = s.get_events().find(1)
        assert len(events) == 5
        by_entity = {e.entity_id: e for e in events}
        # every event got an id and creation time, and replays cleanly
        for e in events:
            assert e.event_id and e.creation_time is not None
        assert by_entity["u5"].event_id == "fixedid01"
        assert by_entity["u1"].properties["rating"] == 3.0
        assert by_entity["u3"].event == "$set"
        # the log file contains valid JSON lines only
        log = tmp_path / "events" / "events_1.jsonl"
        for line in log.read_text().splitlines():
            _json.loads(line)

    def test_invalid_lines_rejected_like_slow_path(self, tmp_path):
        from predictionio_tpu_torch.data.event import EventValidationError

        lines = [
            # pio_ entityType is illegal -> must reach the validator
            '{"event":"rate","entityType":"pio_user","entityId":"u1",'
            '"eventTime":"2020-01-01T00:00:00.000Z"}',
        ]
        with pytest.raises(EventValidationError):
            self._run_import(tmp_path, lines)

    def test_pio_property_goes_to_validator(self, tmp_path):
        from predictionio_tpu_torch.data.event import EventValidationError

        lines = [
            '{"event":"rate","entityType":"user","entityId":"u1",'
            '"properties":{"pio_x":1},"eventTime":"2020-01-01T00:00:00.000Z"}',
        ]
        with pytest.raises(EventValidationError):
            self._run_import(tmp_path, lines)

    def test_scan_ratings_after_splice_import(self, tmp_path):
        lines = [
            '{"event":"rate","entityType":"user","entityId":"u%d",'
            '"targetEntityType":"item","targetEntityId":"i%d",'
            '"properties":{"rating":%d.0},"eventTime":"2020-01-01T00:00:00.000Z"}'
            % (i, i % 3, i % 5 + 1)
            for i in range(50)
        ]
        s, n = self._run_import(tmp_path, lines)
        assert n == 50
        b = s.get_events().scan_ratings(1, event_names=["rate"])
        assert len(b) == 50
        assert sorted(b.entity_ids) == sorted({f"u{i}" for i in range(50)})

    def test_malformed_event_time_rejected_not_spliced(self, tmp_path):
        """A bad eventTime must fail at import (as the slow path does),
        never be appended verbatim to poison the log."""
        from predictionio_tpu_torch.data.event import EventValidationError

        lines = [
            '{"event":"rate","entityType":"user","entityId":"u1",'
            '"targetEntityType":"item","targetEntityId":"i1",'
            '"eventTime":"NOT-A-DATE"}',
        ]
        with pytest.raises((EventValidationError, ValueError)):
            self._run_import(tmp_path, lines)

    def test_escaped_reserved_property_key_caught(self, tmp_path):
        """A JSON-escaped reserved key (\\u0070io_x == pio_x) must reach
        the validator, not slip through the raw-byte screen."""
        from predictionio_tpu_torch.data.event import EventValidationError

        lines = [
            '{"event":"rate","entityType":"user","entityId":"u1",'
            '"properties":{"\\u0070io_x":1},'
            '"eventTime":"2020-01-01T00:00:00.000Z"}',
        ]
        with pytest.raises(EventValidationError):
            self._run_import(tmp_path, lines)

    def test_delete_marker_injection_blocked(self, tmp_path):
        """A wire line with a top-level "$delete" key must NOT be spliced
        verbatim (it would act as a jsonl delete marker and erase an
        attacker-chosen existing event on replay)."""
        # seed a victim event through the normal path
        import predictionio_tpu_torch.cli.commands as commands
        from predictionio_tpu_torch.data.storage import App, Storage

        s = Storage(
            env={
                "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
                "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db"),
                "PIO_STORAGE_SOURCES_LOG_TYPE": "jsonl",
                "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp_path / "events"),
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
            }
        )
        s.get_metadata_apps().insert(App(0, "Victim"))
        victim_id = s.get_events().insert(
            Event(event="rate", entity_type="user", entity_id="u1",
                  target_entity_type="item", target_entity_id="i1",
                  properties={"rating": 3.0}), 1)
        evil = (
            '{"event":"view","entityType":"user","entityId":"u9",'
            '"targetEntityType":"item","targetEntityId":"i9",'
            '"eventTime":"2020-01-01T00:00:00.000Z",'
            '"$delete":"%s"}' % victim_id
        )
        f = tmp_path / "evil.jsonl"
        f.write_text(evil + "\n")
        n = commands.import_events("Victim", str(f), storage=s)
        assert n == 1
        events = s.get_events().find(1)
        # the victim survives and the imported event exists (sans the
        # unknown key, dropped by the slow path)
        assert {e.entity_id for e in events} == {"u1", "u9"}
        assert s.get_events().get(victim_id, 1) is not None

    def test_dollar_delete_value_does_not_force_recompaction(self, tmp_path):
        """A property VALUE containing "$delete" must not make every
        scan_ratings call rewrite the whole log."""
        client = JSONLStorageClient({"path": str(tmp_path)})
        events = JSONLEvents(client)
        events.init(2)
        events.insert(
            Event(event="rate", entity_type="user", entity_id="u1",
                  target_entity_type="item", target_entity_id="i1",
                  properties={"rating": 3.0, "note": "$delete me"}), 2)
        log = client.base_path / "events_2.jsonl"
        mtime_before = log.stat().st_mtime_ns
        b = events.scan_ratings(2, event_names=["rate"])
        assert len(b) == 1
        assert log.stat().st_mtime_ns == mtime_before  # no rewrite

    def test_sqlite_boolean_rating_matches_other_backends(self, tmp_path):
        """JSON boolean ratings must be rejected (event-name default wins)
        on sqlite exactly as on the base/jsonl paths."""
        from predictionio_tpu_torch.data.storage import Storage
        from predictionio_tpu_torch.data.storage import base as storage_base

        s = Storage(
            env={
                "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
                "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db"),
            }
        )
        ev = s.get_events()
        ev.init(1)
        ev.insert(
            Event(event="rate", entity_type="user", entity_id="u1",
                  target_entity_type="item", target_entity_id="i1",
                  properties={"rating": True}), 1)
        kwargs = dict(event_names=["rate"], default_ratings={"rate": 9.0})
        fast = ev.scan_ratings(1, **kwargs)
        slow = storage_base.Events.scan_ratings(ev, 1, **kwargs)
        assert list(fast.vals) == list(slow.vals) == [9.0]


class TestChangeToken:
    """Events.change_token: any write must change it (serving-filter
    caches key on it); a quiet store must keep it stable."""

    def _daos(self, tmp_path):
        from predictionio_tpu_torch.data.storage.memory import (
            MemoryEvents,
            MemoryStorageClient,
        )
        from predictionio_tpu_torch.data.storage.partitioned import (
            PartitionedEvents,
            PartitionedStorageClient,
        )
        from predictionio_tpu_torch.data.storage.sqlite import (
            SQLiteEvents,
            SQLiteStorageClient,
        )

        return {
            "memory": MemoryEvents(MemoryStorageClient()),
            "jsonl": JSONLEvents(
                JSONLStorageClient({"path": str(tmp_path / "jl")})
            ),
            "sqlite": SQLiteEvents(
                SQLiteStorageClient({"path": str(tmp_path / "ev.db")})
            ),
            "partitioned": PartitionedEvents(
                PartitionedStorageClient(
                    {"path": str(tmp_path / "parts"), "partitions": 2}
                )
            ),
        }

    def test_writes_change_token_quiet_store_keeps_it(self, tmp_path):
        import time

        for name, dao in self._daos(tmp_path).items():
            t0 = dao.change_token(1)
            assert t0 is not None, name
            eid = dao.insert(_event(1), 1)
            t1 = dao.change_token(1)
            assert t1 != t0, f"{name}: insert did not change the token"
            # mtime-based tokens need a tick between writes on coarse fs
            time.sleep(0.002)
            dao.delete(eid, 1)
            t2 = dao.change_token(1)
            assert t2 != t1, f"{name}: delete did not change the token"
            assert dao.change_token(1) == t2, f"{name}: quiet store moved"

    def test_base_default_is_none(self):
        from predictionio_tpu_torch.data.storage import base

        class Minimal(base.Events):
            def init(self, *a, **k): return True
            def remove(self, *a, **k): return False
            def insert(self, *a, **k): return ""
            def get(self, *a, **k): return None
            def delete(self, *a, **k): return False
            def find(self, *a, **k): return []

        assert Minimal().change_token(1) is None

    def test_store_helper_resolves_app_name(self, tmp_path):
        from predictionio_tpu_torch.data import store
        from predictionio_tpu_torch.data.storage import App, set_storage, test_storage

        s = test_storage()
        set_storage(s)
        try:
            app_id = s.get_metadata_apps().insert(App(0, "TokApp"))
            t0 = store.change_token("TokApp")
            s.get_events().insert(_event(1), app_id)
            assert store.change_token("TokApp") != t0
        finally:
            set_storage(None)


class TestGroupCommit:
    """Fsync group commit (groupcommit.py): concurrent single-event
    writers must coalesce onto fewer fsyncs while every acked event
    stays durable-ordered (ack strictly after a covering fsync)."""

    def test_concurrent_inserts_coalesce_fsyncs(self, tmp_path, monkeypatch):
        import os as os_mod
        from concurrent.futures import ThreadPoolExecutor

        from predictionio_tpu_torch.data.storage import groupcommit

        dao = JSONLEvents(JSONLStorageClient({"path": str(tmp_path)}))
        dao.insert(_event(0), 1)  # create the file outside the count
        calls = []
        real_fsync = os_mod.fsync

        def counting_fsync(fd):
            calls.append(fd)
            return real_fsync(fd)

        monkeypatch.setattr(groupcommit.os, "fsync", counting_fsync)
        n = 64
        with ThreadPoolExecutor(16) as pool:
            ids = list(pool.map(
                lambda i: dao.insert(_event(i + 1), 1), range(n)
            ))
        assert len(set(ids)) == n
        assert len(calls) < n, (
            f"no coalescing: {len(calls)} fsyncs for {n} concurrent inserts"
        )
        got = {e.event_id for e in dao.find(1, limit=None)}
        assert set(ids) <= got

    def test_partitioned_rotation_during_group_commit(self, tmp_path):
        """Seals triggered mid-stream fsync the active log BEFORE the
        rename and release waiters — no event may be lost across
        rotations under concurrent generated-id ingest."""
        from concurrent.futures import ThreadPoolExecutor

        from predictionio_tpu_torch.data.storage.partitioned import (
            PartitionedEvents,
            PartitionedStorageClient,
        )

        dao = PartitionedEvents(PartitionedStorageClient(
            {"path": str(tmp_path / "p"), "partitions": 2,
             "segment_bytes": 400}  # rotate every couple of events
        ))
        n = 120
        with ThreadPoolExecutor(12) as pool:
            ids = list(pool.map(lambda i: dao.insert(_event(i), 7), range(n)))
        assert len(set(ids)) == n
        got = {e.event_id for e in dao.find(7, limit=None)}
        assert set(ids) == got
        # rotations actually happened
        assert list((tmp_path / "p").glob("events_7/p*/seg_*.jsonl"))

    def test_syncer_error_propagates_and_recovers(self, tmp_path):
        from predictionio_tpu_torch.data.storage.groupcommit import FsyncCoalescer

        c = FsyncCoalescer()
        seq = c.note_write()
        # missing file = rotated/removed: treated as moot, returns
        c.wait_durable(seq, tmp_path / "never-existed")
        # later writes against a real file still work
        f = tmp_path / "log"
        f.write_bytes(b"x")
        seq2 = c.note_write()
        c.wait_durable(seq2, f)

    def test_parse_sync_mode(self):
        import pytest as _pytest

        from predictionio_tpu_torch.data.storage.groupcommit import parse_sync_mode

        assert parse_sync_mode(None) is None
        assert parse_sync_mode("always") is None
        assert parse_sync_mode("interval") == 0.05
        assert parse_sync_mode("interval:20") == 0.02
        for bad in ("interval:0", "interval:-5", "sometimes"):
            with _pytest.raises(ValueError):
                parse_sync_mode(bad)

    def test_interval_sync_mode_acks_without_fsync(self, tmp_path, monkeypatch):
        """sync=interval: inserts ack after flush (no inline fsync — the
        reference's hflush durability), events are immediately readable,
        and the background syncer makes them disk-durable within an
        interval."""
        import os as os_mod
        import time as time_mod

        from predictionio_tpu_torch.data.storage import groupcommit

        dao = JSONLEvents(
            JSONLStorageClient({"path": str(tmp_path), "sync": "interval:20"})
        )
        calls = []
        real_fsync = os_mod.fsync

        def counting_fsync(fd):
            calls.append(fd)
            return real_fsync(fd)

        monkeypatch.setattr(groupcommit.os, "fsync", counting_fsync)
        n = 40
        ids = [dao.insert(_event(i), 1) for i in range(n)]
        inline = len(calls)
        assert inline < n / 2, (
            f"interval mode still fsyncs inline: {inline} fsyncs for {n}"
        )
        assert {e.event_id for e in dao.find(1, limit=None)} == set(ids)
        # the background syncer catches up within a couple of intervals
        committer = dao._c.committers.get(dao._file(1, None))
        deadline = time_mod.time() + 2.0
        while time_mod.time() < deadline:
            with committer._cond:
                if committer._synced >= committer._seq:
                    break
            time_mod.sleep(0.01)
        with committer._cond:
            assert committer._synced >= committer._seq, "syncer never ran"
        assert len(calls) > inline, "background fsync never happened"

    def test_interval_sync_mode_partitioned(self, tmp_path):
        from predictionio_tpu_torch.data.storage.partitioned import (
            PartitionedEvents,
            PartitionedStorageClient,
        )

        dao = PartitionedEvents(PartitionedStorageClient(
            {"path": str(tmp_path / "p"), "partitions": 2,
             "sync": "interval:20"}
        ))
        ids = [dao.insert(_event(i), 7) for i in range(30)]
        assert {e.event_id for e in dao.find(7, limit=None)} == set(ids)

    def test_append_fd_survives_compact_and_remove(self, tmp_path):
        """The cached append handle must not write to a dead inode after
        compact (atomic replace) or remove (unlink): inode revalidation
        under the flock reopens it."""
        dao = JSONLEvents(JSONLStorageClient({"path": str(tmp_path)}))
        dao.insert(_event(0), 1)
        dao.delete(dao.find(1)[0].event_id, 1)
        dao.insert(_event(1), 1)
        assert dao.compact(1) == 1  # replaces the log file
        dao.insert(_event(2), 1)  # cached fd must detect the new inode
        assert {e.entity_id for e in dao.find(1, limit=None)} == {"u1", "u2"}
        assert dao.remove(1)
        dao.init(1)
        dao.insert(_event(3), 1)
        assert [e.entity_id for e in dao.find(1, limit=None)] == ["u3"]


class TestExportSplice:
    """export_jsonl fast path: stream the replay-clean log verbatim;
    must be semantically identical to the per-event slow path."""

    def _fill(self, dao, app_id):
        ids = []
        for i in range(40):
            ids.append(dao.insert(_event(i), app_id))
        # exercise last-write-wins + deletes: export must reflect the
        # FOLDED state (forces a compact before streaming)
        dao.insert(
            Event(
                event="rate", entity_type="user", entity_id="u0-replaced",
                properties={"rating": 9.0}, event_id=ids[0],
                event_time=T0,
            ),
            app_id,
        )
        dao.delete(ids[1], app_id)
        return ids

    def _roundtrip(self, dao, app_id, tmp_path, name):
        from predictionio_tpu_torch.cli import commands
        from predictionio_tpu_torch.data.storage import App, set_storage, test_storage

        out = tmp_path / f"{name}.jsonl"
        with open(out, "wb") as f:
            n = dao.export_jsonl(app_id, None, f)
        source = {e.event_id: e for e in dao.find(app_id, limit=None)}
        assert n == len(source)
        # re-import into a fresh memory store and compare
        s2 = test_storage()
        set_storage(s2)
        try:
            s2.get_metadata_apps().insert(App(0, "ExpApp"))
            commands.import_events("ExpApp", str(out), storage=s2)
            got = {e.event_id: e for e in s2.get_events().find(1, limit=None)}
        finally:
            set_storage(None)
        assert set(got) == set(source)
        for eid, e in source.items():
            g = got[eid]
            assert g.entity_id == e.entity_id
            assert g.properties.to_dict() == e.properties.to_dict()
            assert g.event_time == e.event_time

    def test_jsonl_export_roundtrip(self, tmp_path):
        dao = JSONLEvents(JSONLStorageClient({"path": str(tmp_path / "j")}))
        self._fill(dao, 1)
        self._roundtrip(dao, 1, tmp_path, "jsonl")

    def test_partitioned_export_roundtrip(self, tmp_path):
        from predictionio_tpu_torch.data.storage.partitioned import (
            PartitionedEvents,
            PartitionedStorageClient,
        )

        dao = PartitionedEvents(PartitionedStorageClient(
            {"path": str(tmp_path / "p"), "partitions": 4,
             "segment_bytes": 500}
        ))
        self._fill(dao, 1)
        self._roundtrip(dao, 1, tmp_path, "partitioned")

    def test_blank_lines_compacted_out_of_export(self, tmp_path):
        """A log with blank lines (external edit) still proves clean for
        scans, but a verbatim export must not count or emit them."""
        dao = JSONLEvents(JSONLStorageClient({"path": str(tmp_path)}))
        for i in range(5):
            dao.insert(_event(i), 1)
        path = dao._file(1, None)
        path.write_bytes(path.read_bytes() + b"\n \n")
        out = tmp_path / "exp.jsonl"
        with open(out, "wb") as f:
            n = dao.export_jsonl(1, None, f)
        assert n == 5
        lines = out.read_bytes().splitlines()
        assert len(lines) == 5 and all(ln.startswith(b"{") for ln in lines)

    def test_cli_export_uses_fast_path(self, tmp_path, monkeypatch):
        from predictionio_tpu_torch.cli import commands
        from predictionio_tpu_torch.data.storage import (
            App,
            Storage,
            set_storage,
        )

        s = Storage(env={
            "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db"),
            "PIO_STORAGE_SOURCES_LOG_TYPE": "jsonl",
            "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp_path / "ev"),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
        })
        app_id = s.get_metadata_apps().insert(App(0, "FastExp"))
        for i in range(10):
            s.get_events().insert(_event(i), app_id)
        # the slow path must NOT run for jsonl-backed storage
        def boom(*a, **k):
            raise AssertionError("slow export path used for jsonl backend")

        from predictionio_tpu_torch.data import store as store_mod

        monkeypatch.setattr(store_mod, "find", boom)
        out = tmp_path / "exp.jsonl"
        n = commands.export_events("FastExp", str(out), storage=s)
        assert n == 10
        assert out.read_bytes().count(b"\n") == 10


# -- differential fuzz across every Events backend ---------------------------


class TestDifferentialFuzz:
    """One randomized op sequence applied to every Events backend of the
    port -- memory, jsonl, sqlite, partitioned -- must leave identical
    observable state: find() contents, get()/delete() results, and
    scan_ratings() triples. Any backend that diverges on replace
    semantics, rating extraction, or filter behavior fails against the
    other three."""

    APP = 11

    def _daos(self, tmp_path):
        from predictionio_tpu_torch.data.storage.memory import (
            MemoryEvents,
            MemoryStorageClient,
        )
        from predictionio_tpu_torch.data.storage.partitioned import (
            PartitionedEvents,
            PartitionedStorageClient,
        )
        from predictionio_tpu_torch.data.storage.sqlite import (
            SQLiteEvents,
            SQLiteStorageClient,
        )

        return {
            "memory": MemoryEvents(MemoryStorageClient()),
            "jsonl": JSONLEvents(
                JSONLStorageClient({"path": str(tmp_path / "jl")})
            ),
            "sqlite": SQLiteEvents(
                SQLiteStorageClient({"path": str(tmp_path / "ev.db")})
            ),
            "partitioned": PartitionedEvents(
                PartitionedStorageClient(
                    {"path": str(tmp_path / "parts"), "partitions": 2}
                )
            ),
        }

    def _rand_event(self, rng, i):
        name = ("rate", "buy", "view")[rng.randrange(3)]
        r = rng.random()
        if r < 0.6:
            props = {"rating": float(rng.randrange(1, 6))}
        elif r < 0.7:
            # boolean ratings must be rejected by rating extraction on
            # every backend (defaults win) — the sqlite regression class
            props = {"rating": bool(rng.randrange(2))}
        else:
            props = {}
        return Event(
            event_id=f"ev{i}",
            event=name,
            entity_type="user",
            entity_id=f"u{rng.randrange(9)}",
            target_entity_type="item",
            target_entity_id=f"i{rng.randrange(13)}",
            properties=props,
            event_time=T0 + timedelta(minutes=i),
        )

    @staticmethod
    def _obs(e):
        """Order-free observable identity of a stored event."""
        return (
            e.event_id, e.event, e.entity_id, e.target_entity_id,
            json.dumps(dict(e.properties or {}), sort_keys=True),
            e.event_time.isoformat(),
        )

    def test_random_op_sequence_identical_state(self, tmp_path):
        import random

        rng = random.Random(0)
        daos = self._daos(tmp_path)
        for dao in daos.values():
            dao.init(self.APP)

        live = []
        for i in range(120):
            op = rng.random()
            if op < 0.55 or not live:
                e = self._rand_event(rng, i)
                for dao in daos.values():
                    dao.insert(e, self.APP)
                live.append(e)
            elif op < 0.75:
                # reinsert an existing id with a new rating: every
                # backend must replace, last write wins
                old = live[rng.randrange(len(live))]
                e = Event(
                    event_id=old.event_id, event=old.event,
                    entity_type="user", entity_id=old.entity_id,
                    target_entity_type="item",
                    target_entity_id=old.target_entity_id,
                    properties={"rating": float(rng.randrange(1, 6))},
                    event_time=old.event_time,
                )
                for dao in daos.values():
                    dao.insert(e, self.APP)
                live[live.index(old)] = e
            elif op < 0.9:
                victim = live.pop(rng.randrange(len(live)))
                results = {
                    n: dao.delete(victim.event_id, self.APP)
                    for n, dao in daos.items()
                }
                assert all(results.values()), results
            else:
                batch = [self._rand_event(rng, 1000 * (i + 1) + j)
                         for j in range(3)]
                for dao in daos.values():
                    dao.batch_insert(list(batch), self.APP)
                live.extend(batch)

        # full-state find() parity (order-free)
        states = {
            n: sorted(self._obs(e) for e in dao.find(self.APP, limit=None))
            for n, dao in daos.items()
        }
        ref = states.pop("memory")
        assert len(ref) == len(live)
        for n, got in states.items():
            assert got == ref, f"{n} diverged from memory on find()"

        # filtered find() parity: entity filter and a time window
        for kwargs in (
            dict(entity_type="user", entity_id="u3", limit=None),
            dict(start_time=T0 + timedelta(minutes=20),
                 until_time=T0 + timedelta(minutes=60), limit=None),
        ):
            flt = {
                n: sorted(self._obs(e) for e in dao.find(self.APP, **kwargs))
                for n, dao in daos.items()
            }
            fref = flt.pop("memory")
            for n, got in flt.items():
                assert got == fref, f"{n} diverged on find({kwargs})"

        # scan_ratings parity: numeric ratings, boolean rejection, and
        # per-event-name defaults/overrides all at once
        kwargs = dict(
            event_names=["rate", "buy"],
            default_ratings={"rate": 9.0, "buy": 4.0},
            override_ratings={"buy": 4.0},
        )
        scans = {}
        for n, dao in daos.items():
            b = dao.scan_ratings(self.APP, **kwargs)
            scans[n] = sorted(
                (b.entity_ids[b.rows[k]], b.target_ids[b.cols[k]],
                 float(b.vals[k]))
                for k in range(len(b))
            )
        sref = scans.pop("memory")
        assert sref  # the op mix always leaves rate/buy events behind
        for n, got in scans.items():
            assert got == sref, f"{n} diverged on scan_ratings()"

        # point lookups: one live id, one deleted id
        probe = live[0].event_id
        for n, dao in daos.items():
            assert dao.get(probe, self.APP) is not None, n
            assert dao.get("never-inserted", self.APP) is None, n
            assert dao.delete("never-inserted", self.APP) is False, n


# ---------------------------------------------------------------------------
# kill -9 crash recovery (tests/test_storage.py's matrix, the jsonl and
# partitioned rows, under both sync modes): a child process ingests
# through the port's store and is SIGKILLed by a PIO_FAULTS kill rule; the
# reopened store must hold every acked event once, and nothing torn
# ---------------------------------------------------------------------------

CHAOS_CHILD = '''
import json, random, sys
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import Storage

cfg = json.load(open(sys.argv[1]))
storage = Storage(env=cfg["env"])
events = storage.get_events()
rng = random.Random(cfg["seed"])
for i in range(cfg["n_events"]):
    eid = events.insert(Event(
        event="rate", entity_type="user", entity_id=f"u{rng.randrange(10)}",
        target_entity_type="item", target_entity_id=f"i{rng.randrange(8)}",
        properties={"rating": float(rng.randrange(1, 6)), "n": i}), cfg["app_id"])
    # printed once insert returned: every ACK line is an acked event
    print(f"ACK {eid}", flush=True)
storage.close()
print("DONE", flush=True)
'''


def _backend_env(backend, tmp_path, sync="always"):
    env = {
        "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "meta.db"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
        "PIO_STORAGE_SOURCES_LOG_TYPE": backend,
        "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp_path / "eventlog"),
        "PIO_STORAGE_SOURCES_LOG_SYNC": sync,
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
    }
    if backend == "partitioned":
        env["PIO_STORAGE_SOURCES_LOG_PARTITIONS"] = "4"
    return env


def _run_chaos_child(tmp_path, env_dict, faults_spec, n_events=40, seed=3):
    import os
    import subprocess
    import sys
    from pathlib import Path

    child = tmp_path / "chaos_child.py"
    child.write_text(CHAOS_CHILD)
    cfg = tmp_path / "chaos_cfg.json"
    cfg.write_text(json.dumps({"env": env_dict, "app_id": 1,
                               "n_events": n_events, "seed": seed}))
    env = dict(os.environ, PIO_FAULTS=faults_spec)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(Path(__file__).resolve().parent.parent),
                    os.environ.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, str(child), str(cfg)],
                          capture_output=True, text=True, env=env, timeout=120)
    acked = [ln.split(" ", 1)[1] for ln in proc.stdout.splitlines()
             if ln.startswith("ACK ")]
    return proc, acked, "DONE" in proc.stdout.splitlines()


def _log_root(env_dict):
    from pathlib import Path

    return Path(env_dict["PIO_STORAGE_SOURCES_LOG_PATH"])


@pytest.mark.chaos
class TestKill9Recovery:
    """Group-committed ingest SIGKILLed at each durability-critical fault
    point, per store and sync mode. Both modes ack only after the bytes
    are flushed to the page cache (``always`` after a covering fsync
    too), so every acked event survives a process kill: present exactly
    once, the replay never crashes, nothing half-appears."""

    KILLS = [
        ("jsonl", "always", "storage.write:nth=20:kill"),
        ("jsonl", "always", "storage.fsync:nth=15:kill"),
        ("jsonl", "interval", "storage.write:nth=20:kill"),
        ("partitioned", "always", "storage.write:nth=20:kill"),
        ("partitioned", "always", "storage.fsync:nth=15:kill"),
        ("partitioned", "interval", "storage.write:nth=20:kill"),
    ]

    @pytest.mark.parametrize(
        "backend,sync,spec", KILLS,
        ids=[f"{b}-{m}-{s.split(':')[0]}" for b, m, s in KILLS])
    def test_acked_events_survive_kill(self, backend, sync, spec, tmp_path):
        import signal

        env_dict = _backend_env(backend, tmp_path, sync)
        proc, acked, done = _run_chaos_child(tmp_path, env_dict, spec)
        assert proc.returncode == -signal.SIGKILL, proc.stderr
        assert not done
        assert acked, "kill landed before any ack: the matrix point is vacuous"
        recovered = Storage(env=env_dict)
        try:
            got = list(recovered.get_events().find(1))
            ids = [e.event_id for e in got]
            assert len(ids) == len(set(ids))
            assert not set(acked) - set(ids), "acked events lost after kill -9"
            for e in got:
                assert e.event == "rate" and "rating" in e.properties
        finally:
            recovered.close()

    @pytest.mark.parametrize("backend", ["jsonl", "partitioned"])
    def test_torn_trailing_write_dropped_on_replay(self, backend, tmp_path):
        """The OS tearing the final append: replay drops only the torn,
        unacked tail and keeps every acked record."""
        import signal

        env_dict = _backend_env(backend, tmp_path)
        proc, acked, _ = _run_chaos_child(tmp_path, env_dict, "storage.fsync:nth=12:kill")
        assert proc.returncode == -signal.SIGKILL
        logs = [p for p in _log_root(env_dict).rglob("*") if p.is_file()
                and p.stat().st_size > 0 and not p.name.startswith("_meta")]
        assert logs
        for p in logs:
            with open(p, "ab") as f:
                f.write(b'{"event": "rate", "entityId": "torn-nev')
        recovered = Storage(env=env_dict)
        try:
            got = list(recovered.get_events().find(1))
            assert set(acked) <= {e.event_id for e in got}
            assert all("torn-nev" not in (e.entity_id or "") for e in got)
        finally:
            recovered.close()

    def test_clean_child_acks_everything(self, tmp_path):
        """Control: without faults every event is acked and present."""
        env_dict = _backend_env("jsonl", tmp_path)
        proc, acked, done = _run_chaos_child(tmp_path, env_dict, "", n_events=10)
        assert proc.returncode == 0 and done and len(acked) == 10
        recovered = Storage(env=env_dict)
        try:
            assert {e.event_id for e in recovered.get_events().find(1)} == set(acked)
        finally:
            recovered.close()

    @pytest.mark.parametrize("backend", ["jsonl", "partitioned"])
    def test_restarted_writer_truncates_torn_tail(self, backend, tmp_path):
        """A restarted writer appending to a log a crashed one left torn
        truncates the torn bytes first, so no corrupt mid-file line."""
        env_dict = _backend_env(backend, tmp_path)

        def rate(item, v):
            return Event(event="rate", entity_type="user", entity_id="u1",
                         target_entity_type="item", target_entity_id=item,
                         properties={"rating": v})

        store = Storage(env=env_dict)
        first = store.get_events().insert(rate("i1", 4.0), 1)
        store.close()
        logs = [p for p in _log_root(env_dict).rglob("*.jsonl") if p.stat().st_size > 0]
        assert len(logs) == 1
        with open(logs[0], "ab") as f:
            f.write(b'{"event": "rate", "entityId": "torn-nev')
        restarted = Storage(env=env_dict)
        try:
            second = restarted.get_events().insert(rate("i9", 5.0), 1)
            got = list(restarted.get_events().find(1))
            assert {e.event_id for e in got} == {first, second}
            raw = logs[0].read_bytes()
            assert b"torn-nev" not in raw and raw.endswith(b"\n")
        finally:
            restarted.close()


# ---------------------------------------------------------------------------
# the verbs on a file-log store
# ---------------------------------------------------------------------------


def test_cli_verbs_on_a_partitioned_store(tmp_path):
    """``app new``, ``import --warm-cache`` (the splice route, then the
    columnar cache), ``status`` (the event store's type), ``export``
    (the JAX package's export of the same store, byte for byte) and
    ``train --no-columnar-cache`` on the CPU, through the port's CLI."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from predictionio_tpu.cli import commands as jcommands
    from predictionio_tpu.data.storage import Storage as JStorage

    repo = str(Path(__file__).resolve().parent.parent)
    store = {
        "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db"),
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "models"),
        "PIO_STORAGE_SOURCES_LOG_TYPE": "partitioned",
        "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp_path / "events"),
        "PIO_STORAGE_SOURCES_LOG_PARTITIONS": "4",
        "PIO_STORAGE_SOURCES_LOG_SEGMENT_BYTES": "4096",
    }
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_STORAGE_")}
    env.update(store, PIO_FS_BASEDIR=str(tmp_path), PYTHONPATH=repo)

    def pio(*args):
        proc = subprocess.run(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main", *args],
            capture_output=True, text=True, env=env, timeout=180, cwd=repo)
        assert proc.returncode == 0, proc.stderr[-2000:]
        return proc.stdout

    pio("app", "new", "FileApp")
    lines = [json.dumps({
        "event": "rate", "entityType": "user", "entityId": f"u{u}",
        "targetEntityType": "item", "targetEntityId": f"i{(u * 3 + i) % 9}",
        "properties": {"rating": float(1 + (u + i) % 5)},
        "eventTime": "2020-01-01T00:00:00.000Z"}) for u in range(20) for i in range(5)]
    (tmp_path / "in.jsonl").write_text("\n".join(lines) + "\n")
    out = pio("import", "--appid-or-name", "FileApp", "--input",
              str(tmp_path / "in.jsonl"), "--warm-cache")
    assert "Imported 100 events." in out
    assert "Columnar cache warmed (100 rating rows)." in out
    assert list((tmp_path / "events").rglob("*.colcache"))
    assert list((tmp_path / "events").rglob("seg_*.jsonl"))  # sealed at 4 KiB
    status = json.loads(pio("status").split("\n(sanity check)")[0])
    assert status["storage"]["EVENTDATA"] == {"source": "LOG", "type": "partitioned"}
    pio("export", "--appid-or-name", "FileApp", "--output", str(tmp_path / "port.jsonl"))
    jstorage = JStorage(env=store)
    try:
        jcommands.export_events("FileApp", str(tmp_path / "jax.jsonl"), storage=jstorage)
    finally:
        jstorage.close()
    exported = (tmp_path / "port.jsonl").read_bytes()
    assert exported == (tmp_path / "jax.jsonl").read_bytes()
    assert exported.count(b"\n") == 100
    (tmp_path / "engine.json").write_text(json.dumps({
        "id": "file-app", "datasource": {"params": {"appName": "FileApp"}},
        "algorithms": [{"name": "als", "params": {"rank": 3, "numIterations": 2}}]}))
    out = pio("train", "--variant", str(tmp_path / "engine.json"), "--device", "cpu",
              "--no-columnar-cache")
    assert "Training completed." in out
