"""The port's speed layer on its file-log stores (jsonl, partitioned) on
the CPU, held against the JAX package.

The files-mode cases of ``tests/test_realtime.py`` restated for
``predictionio_tpu_torch``: ``TestTailerDurability`` and
``TestCursorCorruptionRecovery`` on the jsonl and partitioned stores,
``TestTailerFileLineage``, ``TestColumnarTail`` and
``test_columnar_foldin_vs_retrain``. Against the JAX package: a files-mode
cursor either package wrote, resumed by the other; and the slice as a
whole, the same events in a partitioned store tailed by both packages'
``EventTailer.poll_columnar`` and folded by both ``fold_in_columnar``
from the same factors, solved rows within rtol 5e-4 / atol 5e-5 (f32),
the port's columnar fold bit for bit its object fold.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from predictionio_tpu_torch import faults
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import colspans
from predictionio_tpu_torch.models import recommendation as rec
from predictionio_tpu_torch.obs import metrics as obs_metrics
from predictionio_tpu_torch.obs import trace as obs_trace
from predictionio_tpu_torch.ops import als as als_ops
from predictionio_tpu_torch.realtime import ALSFoldIn, EventTailer, FoldInConfig
from predictionio_tpu_torch.realtime import tailer as tailer_mod

from tests.test_torch_realtime import (  # noqa: F401 (fixtures)
    RMSE_TOL,
    _app,
    _memory_events,
    _rate,
    _scores,
    _train_model,
    kind,
    storage,
)

APP = 7


def _jsonl_events(tmp_path):
    from predictionio_tpu_torch.data.storage.jsonl import JSONLEvents, JSONLStorageClient

    return JSONLEvents(JSONLStorageClient({"path": str(tmp_path / "ev")}))


def _partitioned_events(tmp_path):
    from predictionio_tpu_torch.data.storage.partitioned import (
        PartitionedEvents,
        PartitionedStorageClient,
    )

    return PartitionedEvents(PartitionedStorageClient(
        {"path": str(tmp_path / "pev"), "partitions": 2}))


FILE_BACKENDS = {"jsonl": _jsonl_events, "partitioned": _partitioned_events}


@pytest.fixture(params=sorted(FILE_BACKENDS))
def file_events(request, tmp_path):
    return FILE_BACKENDS[request.param](tmp_path)


# ---------------------------------------------------------------------------
# the tailer's files mode
# ---------------------------------------------------------------------------


class TestTailerDurability:
    def test_attaches_at_end(self, file_events, tmp_path):
        # pre-deploy history belongs to the batch layer, not the tailer
        file_events.insert(_rate("old", "i0", 1), APP)
        t = EventTailer(file_events, APP, cursor_path=tmp_path / "cursor.json")
        assert t.mode == "files"
        assert t.poll() == []
        file_events.insert(_rate("u1", "i1", 5), APP)
        assert [e.entity_id for e in t.poll()] == ["u1"]
        assert t.poll() == []

    def test_restart_mid_log_resumes_exactly(self, file_events, tmp_path):
        cursor = tmp_path / "cursor.json"
        t = EventTailer(file_events, APP, cursor_path=cursor)
        for k in range(10):
            file_events.insert(_rate(f"u{k}", "i1", 5), APP)
        first = t.poll(limit=4)
        assert len(first) == 4
        # a restarted tailer on the persisted cursor delivers the other 6
        t2 = EventTailer(file_events, APP, cursor_path=cursor)
        rest = t2.poll()
        assert len(rest) == 6
        got = {e.entity_id for e in first} | {e.entity_id for e in rest}
        assert got == {f"u{k}" for k in range(10)}
        assert t2.poll() == []
        assert t2.events_behind() == 0

    def test_batches_respect_limit(self, file_events, tmp_path):
        t = EventTailer(file_events, APP, batch_limit=3)
        for k in range(8):
            file_events.insert(_rate(f"u{k}", "i1", 5), APP)
        sizes, total = [], []
        while got := t.poll():
            sizes.append(len(got))
            total.extend(got)
        assert all(s <= 3 for s in sizes)
        assert {e.entity_id for e in total} == {f"u{k}" for k in range(8)}

    def test_duplicate_ids_not_redelivered(self, file_events, tmp_path):
        t = EventTailer(file_events, APP)
        eid = file_events.insert(_rate("u1", "i1", 5), APP)
        assert len(t.poll()) == 1
        # the same event id rewritten: already delivered, deduped by id
        file_events.insert(_rate("u1", "i1", 2, event_id=eid), APP)
        assert t.poll() == []


class TestTailerFileLineage:
    """Rotation and torn trailing lines."""

    def test_compaction_rotation_resumes_clean(self, tmp_path):
        events = _jsonl_events(tmp_path)
        events.insert(_rate("old", "i0", 1), APP)
        t = EventTailer(events, APP, cursor_path=tmp_path / "cursor.json")
        events.insert(_rate("u1", "i1", 5), APP)
        assert len(t.poll()) == 1
        # compact() rewrites the log into a new inode: the re-read neither
        # re-delivers u1 nor resurrects pre-attach history
        events.compact(APP)
        assert t.poll() == []
        events.insert(_rate("u2", "i2", 5), APP)
        assert [e.entity_id for e in t.poll()] == ["u2"]

    def test_torn_trailing_line(self, tmp_path):
        events = _jsonl_events(tmp_path)
        cursor = tmp_path / "cursor.json"
        t = EventTailer(events, APP, cursor_path=cursor)
        path = events._file(APP, None)
        line = json.dumps(_rate("torn", "i5", 2).with_event_id("torn-1")
                          .to_dict(for_api=False))
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "ab") as f:
            f.write(line[:25].encode())  # the writer died mid-append
        assert t.poll() == []
        with open(path, "ab") as f:
            f.write((line[25:] + "\n").encode())
        assert [e.entity_id for e in t.poll()] == ["torn"]
        assert t.poll() == []
        assert EventTailer(events, APP, cursor_path=cursor).poll() == []

    def test_attach_on_torn_line_delivers_once_completed(self, tmp_path):
        events = _jsonl_events(tmp_path)
        events.insert(_rate("old", "i0", 1), APP)
        path = events._file(APP, None)
        line = json.dumps(_rate("torn", "i5", 2).with_event_id("torn-2")
                          .to_dict(for_api=False))
        with open(path, "ab") as f:
            f.write(line[:25].encode())
        # attached while the tail is torn: the end offset stops at the
        # last newline, not inside the torn bytes
        t = EventTailer(events, APP)
        assert t.poll() == []
        with open(path, "ab") as f:
            f.write((line[25:] + "\n").encode())
        assert [e.entity_id for e in t.poll()] == ["torn"]

    def test_partitioned_tails_across_partitions(self, tmp_path):
        events = _partitioned_events(tmp_path)
        t = EventTailer(events, APP)
        assert t.mode == "files"
        for k in range(16):  # ids hash across both partitions
            events.insert(_rate(f"u{k}", "i1", 5), APP)
        assert {e.entity_id for e in t.poll()} == {f"u{k}" for k in range(16)}
        assert t.poll() == []
        assert t.events_behind() == 0


def _lineage_break(kind, tmp_path):
    """A log with pre-attach history, a tailer attached to it (cursor on
    disk), and new events written so that the lineage breaks: compaction
    on jsonl, a seal on partitioned (the new events land in a segment
    file the tailer never saw). Returns (events, cursor, new ids)."""
    if kind == "jsonl":
        events = _jsonl_events(tmp_path)
    else:
        from predictionio_tpu_torch.data.storage.partitioned import (
            PartitionedEvents,
            PartitionedStorageClient,
        )

        events = PartitionedEvents(PartitionedStorageClient(
            {"path": str(tmp_path / "pev"), "partitions": 2, "segment_bytes": 4096}))
    for k in range(10):
        events.insert(_rate(f"old{k}", "i0", 1), APP)
    cursor = tmp_path / "cursor.json"
    EventTailer(events, APP, cursor_path=cursor)  # attaches at the end
    new = []
    while True:
        new.append(f"new{len(new)}")
        events.insert(_rate(new[-1], "i1", 5), APP)
        if kind == "jsonl" and len(new) == 4:
            events.compact(APP)
            break
        if kind == "partitioned" and any(
                f.name.startswith("seg_") for f in events.tail_files(APP)):
            break
    return events, cursor, new


class TestRereadAcrossPolls:
    """A broken-lineage re-read that one poll cannot finish (the batch
    limit stops it part way) keeps the attach watermark until the end of
    the file, also across a restart on the cursor: pre-attach history past
    the stop never delivers. (The JAX package's tailer delivers it there:
    its part-way cursor forgets that the re-read filters.)"""

    @pytest.mark.parametrize("kind", sorted(FILE_BACKENDS))
    @pytest.mark.parametrize("columnar", [False, True])
    @pytest.mark.parametrize("restart", [False, True])
    def test_no_history_past_a_stop(self, tmp_path, kind, columnar, restart):
        _, dcfg = _columnar_configs()
        events, cursor, new = _lineage_break(kind, tmp_path)

        def tailer():
            return EventTailer(events, APP, cursor_path=cursor,
                               columnar_config=dcfg if columnar else None)

        t, got, stopped = tailer(), [], False
        for _ in range(40):  # a poll reads 3 lines; the logs hold fewer than 60
            if columnar:
                got += _batch_entity_ids(t.poll_columnar(limit=3))
            else:
                got += [e.entity_id for e in t.poll(limit=3)]
            stopped |= any(c.mtime_ns == tailer_mod._REREAD for c in t._files.values())
            if restart:
                t = tailer()
        assert stopped  # a re-read stopped part way at least once
        assert t.events_behind() == 0
        assert sorted(got) == sorted(new)
        events.insert(_rate("after", "i2", 4), APP)
        last = (_batch_entity_ids(t.poll_columnar()) if columnar
                else [e.entity_id for e in t.poll()])
        assert last == ["after"]


class TestCursorCorruptionRecovery:
    """A truncated or malformed files-mode cursor re-attaches at the
    watermark instead of crashing, and counts the recovery."""

    @staticmethod
    def _recovered():
        return obs_metrics.counter(
            "pio_tailer_cursor_recovered",
            "Tailer restarts that discarded a corrupt cursor file").value()

    @staticmethod
    def _tailer_with_cursor(events, tmp_path):
        cursor = tmp_path / "cursor.json"
        t = EventTailer(events, APP, cursor_path=cursor)
        events.insert(_rate("u1", "i1", 4), APP)
        assert len(t.poll()) == 1  # persists a real cursor
        return cursor

    @pytest.mark.parametrize("corruption", [
        "torn-json", "not-a-dict", "watermark-wrong-type", "files-missing-fields",
        "seen-not-a-list",
    ])
    def test_corrupt_cursor_falls_back_to_reattach(self, file_events, tmp_path, corruption):
        cursor = self._tailer_with_cursor(file_events, tmp_path)
        good = json.loads(cursor.read_text())
        assert good["mode"] == "files" and good["files"]
        if corruption == "torn-json":
            cursor.write_text(cursor.read_text()[: len(cursor.read_text()) // 2])
        elif corruption == "not-a-dict":
            cursor.write_text("[1, 2, 3]")
        elif corruption == "watermark-wrong-type":
            cursor.write_text(json.dumps({**good, "watermark": ["not", "a", "number"]}))
        elif corruption == "files-missing-fields":
            cursor.write_text(json.dumps(
                {**good, "files": {p: {"offset": 0} for p in good["files"]}}))
        else:
            cursor.write_text(json.dumps({**good, "seen": 42}))
        before = self._recovered()
        file_events.insert(_rate("u2", "i2", 3), APP)
        t2 = EventTailer(file_events, APP, cursor_path=cursor)
        if corruption != "seen-not-a-list":
            assert self._recovered() >= before
        assert t2.poll() == []  # re-attached at the end, not at zero
        file_events.insert(_rate("u3", "i3", 5), APP)
        assert [e.entity_id for e in t2.poll()] == ["u3"]
        assert json.loads(cursor.read_text())["version"] == 1

    def test_structurally_corrupt_cursor_counts_recovery(self, file_events, tmp_path):
        cursor = self._tailer_with_cursor(file_events, tmp_path)
        good = json.loads(cursor.read_text())
        cursor.write_text(json.dumps(
            {**good, "files": {p: {"offset": 0} for p in good["files"]}}))
        before = self._recovered()
        EventTailer(file_events, APP, cursor_path=cursor)
        assert self._recovered() == before + 1


class TestFilesCursorAcrossPackages:
    """A files-mode cursor is the JAX package's format: either package's
    tailer resumes the other's on the same log."""

    @staticmethod
    def _jax_events(kind, tmp_path):
        if kind == "jsonl":
            from predictionio_tpu.data.storage.jsonl import JSONLEvents, JSONLStorageClient

            return JSONLEvents(JSONLStorageClient({"path": str(tmp_path / "ev")}))
        from predictionio_tpu.data.storage.partitioned import (
            PartitionedEvents,
            PartitionedStorageClient,
        )

        return PartitionedEvents(PartitionedStorageClient(
            {"path": str(tmp_path / "pev"), "partitions": 2}))

    @pytest.mark.parametrize("kind", sorted(FILE_BACKENDS))
    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_cursor_resumes_in_the_other_package(self, tmp_path, kind, writer):
        from predictionio_tpu.realtime.tailer import EventTailer as JEventTailer

        port_events = FILE_BACKENDS[kind](tmp_path)
        jax_events = self._jax_events(kind, tmp_path)
        cursor = tmp_path / "cursor.json"
        first, second = ((JEventTailer, jax_events), (EventTailer, port_events))
        if writer == "port":
            first, second = second, first
        t1 = first[0](first[1], APP, cursor_path=cursor)
        for k in range(6):
            port_events.insert(_rate(f"u{k}", "i1", 5), APP)
        got = [e.entity_id for e in t1.poll(limit=2)]
        state = json.loads(cursor.read_text())
        assert state["mode"] == "files"
        assert set(state) == {"version", "mode", "watermark", "seq", "files", "seen"}
        t2 = second[0](second[1], APP, cursor_path=cursor)
        got += [e.entity_id for e in t2.poll()]
        assert sorted(got) == [f"u{k}" for k in range(6)]
        assert t2.poll() == []


# ---------------------------------------------------------------------------
# the columnar tail and fold
# ---------------------------------------------------------------------------


def _columnar_configs():
    """Matching FoldInConfig / DecodeConfig with every rating rule:
    property extraction, per-event defaults and overrides."""
    cfg = FoldInConfig(event_names=("rate", "buy", "like"),
                       default_ratings={"like": 5.0}, override_ratings={"buy": 4.0})
    dcfg = colspans.DecodeConfig(
        event_names=cfg.event_names, rating_key=cfg.rating_key,
        default_ratings=cfg.default_ratings, override_ratings=cfg.override_ratings,
        entity_type=cfg.entity_type, target_entity_type=cfg.target_entity_type)
    return cfg, dcfg


def _batch_entity_ids(batch):
    """Delivered entity ids across a TailedBatch's segments, in order."""
    out = []
    for seg in batch.segments:
        if isinstance(seg, list):
            out.extend(e.entity_id for e in seg)
        else:
            out.extend(seg.user_ids[i] for i in seg.user_idx)
    return out


def _columnar_rows(batch):
    return sum(seg.n_rows for seg in batch.segments if not isinstance(seg, list))


def _mixed_stream(events, app, ev_cls=Event):
    """One line for each of the classifier's routes: plain rates, a
    default-rated and an override-rated event, a properties-rich
    ``$set``, a rate with no resolvable rating, a new user, a cold item."""
    def rate(u, i, v):
        return ev_cls(event="rate", entity_type="user", entity_id=u,
                      target_entity_type="item", target_entity_id=i,
                      properties={"rating": float(v)})

    evs = [
        rate("u1", "i1", 5), rate("u2", "i2", 3),
        ev_cls(event="like", entity_type="user", entity_id="u1",
               target_entity_type="item", target_entity_id="i3"),
        ev_cls(event="buy", entity_type="user", entity_id="u2",
               target_entity_type="item", target_entity_id="i1",
               properties={"rating": 1.0}),
        ev_cls(event="$set", entity_type="user", entity_id="u1",
               properties={"plan": "pro"}),
        rate("u3", "i2", 4),
        ev_cls(event="rate", entity_type="user", entity_id="u3",
               target_entity_type="item", target_entity_id="i4"),
        rate("nu1", "i0", 5), rate("u0", "COLD_ITEM", 4),
    ]
    for e in evs:
        events.insert(e, app)
    return evs


def _synthetic_model(storage_dtype="float32", n_users=4, n_items=6, rank=4):
    rng = np.random.default_rng(11)
    U = rng.normal(size=(n_users, rank)).astype(np.float32)
    V = rng.normal(size=(n_items, rank)).astype(np.float32)
    us = vs = None
    if storage_dtype == "int8":
        (U, us), (V, vs) = ((q.numpy(), s.numpy()) for q, s in
                            (als_ops.quantize_rows(torch.from_numpy(a)) for a in (U, V)))
    elif storage_dtype == "bfloat16":
        import ml_dtypes

        U, V = U.astype(ml_dtypes.bfloat16), V.astype(ml_dtypes.bfloat16)
    return rec.model_from_numpy([f"u{i}" for i in range(n_users)],
                                [f"i{i}" for i in range(n_items)], U, V, us, vs)


def _attach_pair(events, dcfg):
    # every partition's log exists before the attach: a log born after it
    # is fresh lineage, which goes through the object path by design
    for k in range(4):
        events.insert(_rate(f"pre{k}", "i0", 1), APP)
    return EventTailer(events, APP), EventTailer(events, APP, columnar_config=dcfg)


class TestColumnarTail:
    """poll_columnar / fold_in_columnar deliver and patch as poll / fold
    do, bit for bit, while the rate-shaped lines take the array path."""

    @pytest.mark.parametrize("storage_dtype", ["float32", "bfloat16", "int8"])
    @pytest.mark.parametrize("backend", sorted(FILE_BACKENDS))
    def test_mixed_stream_bit_parity(self, tmp_path, backend, storage_dtype):
        cfg, dcfg = _columnar_configs()
        events = FILE_BACKENDS[backend](tmp_path)
        t_obj, t_col = _attach_pair(events, dcfg)
        inserted = _mixed_stream(events, APP)
        obj_events = t_obj.poll()
        batch = t_col.poll_columnar()
        assert batch.n_events == len(obj_events) == len(inserted)
        assert _columnar_rows(batch) > 0  # the array path ran
        assert sorted(_batch_entity_ids(batch)) == sorted(e.entity_id for e in obj_events)
        model = _synthetic_model(storage_dtype)
        fold_o = ALSFoldIn(events, APP, config=cfg, device="cpu")
        fold_c = ALSFoldIn(events, APP, config=cfg, device="cpu")
        patched_o, stats_o = fold_o.fold(model, obj_events)
        patched_c, stats_c = fold_c.fold_in_columnar(model, batch)
        assert stats_c == stats_o
        assert stats_c.users_added == 1 and stats_c.cold_item_events == 1
        assert list(patched_c.user_index) == list(patched_o.user_index)
        assert patched_c.user_factors.dtype == patched_o.user_factors.dtype
        assert np.array_equal(patched_c.user_factors.view(np.uint8),
                              patched_o.user_factors.view(np.uint8))
        if storage_dtype == "int8":
            assert np.array_equal(patched_c.user_scales, patched_o.user_scales)
        assert fold_c.cold_start_stats() == fold_o.cold_start_stats()

    def test_rotation_mid_stream_no_duplicates(self, tmp_path):
        _, dcfg = _columnar_configs()
        events = _jsonl_events(tmp_path)
        events.insert(_rate("old", "i0", 1), APP)
        t = EventTailer(events, APP, columnar_config=dcfg)
        events.insert(_rate("u1", "i1", 5), APP)
        assert _batch_entity_ids(t.poll_columnar()) == ["u1"]
        # a compaction re-read (fresh lineage, the object path) re-delivers
        # nothing; the next append is back on the array path
        events.compact(APP)
        assert t.poll_columnar().n_events == 0
        events.insert(_rate("u2", "i2", 5), APP)
        batch = t.poll_columnar()
        assert _batch_entity_ids(batch) == ["u2"]
        assert _columnar_rows(batch) == 1

    def test_torn_trailing_line_columnar(self, tmp_path):
        _, dcfg = _columnar_configs()
        events = _jsonl_events(tmp_path)
        events.insert(_rate("pre", "i0", 1), APP)
        cursor = tmp_path / "cursor.json"
        t = EventTailer(events, APP, cursor_path=cursor, columnar_config=dcfg)
        path = events._file(APP, None)
        line = json.dumps(_rate("torn", "i5", 2).with_event_id("torn-col")
                          .to_dict(for_api=False))
        with open(path, "ab") as f:
            f.write(line[:25].encode())
        assert t.poll_columnar().n_events == 0
        with open(path, "ab") as f:
            f.write((line[25:] + "\n").encode())
        batch = t.poll_columnar()
        assert _batch_entity_ids(batch) == ["torn"] and _columnar_rows(batch) == 1
        assert t.poll_columnar().n_events == 0
        t2 = EventTailer(events, APP, cursor_path=cursor, columnar_config=dcfg)
        assert t2.poll_columnar().n_events == 0

    def test_read_cap_resumes_without_rereading(self, tmp_path, monkeypatch):
        """A capped read decodes a clean newline prefix and parks the rest
        behind an offset-only cursor: every line once, in order."""
        _, dcfg = _columnar_configs()
        events = _jsonl_events(tmp_path)
        events.insert(_rate("pre", "i0", 1), APP)
        t = EventTailer(events, APP, columnar_config=dcfg)
        for k in range(40):
            events.insert(_rate(f"u{k}", "i1", 5), APP)
        monkeypatch.setattr(tailer_mod, "_READ_CAP", 1024)
        batch = t.poll_columnar()
        assert 0 < batch.n_events < 40
        cur = t._files[str(events._file(APP, None))]
        assert cur.mtime_ns == -1 and cur.size == -1
        delivered, polls = _batch_entity_ids(batch), 1
        while (got := t.poll_columnar()).n_events:
            delivered.extend(_batch_entity_ids(got))
            polls += 1
        assert polls > 1
        assert delivered == [f"u{k}" for k in range(40)]

    def test_decode_fault_falls_back_to_object_path(self, tmp_path):
        _, dcfg = _columnar_configs()
        events = _jsonl_events(tmp_path)
        events.insert(_rate("pre", "i0", 1), APP)
        t = EventTailer(events, APP, columnar_config=dcfg)
        for k in range(3):
            events.insert(_rate(f"u{k}", "i1", 4), APP)
        fb_before = tailer_mod._m_col_fallback.value()
        with faults.injected("tail.decode:always") as plan:
            batch = t.poll_columnar()
        assert plan.fire_count("tail.decode") == 1
        assert _batch_entity_ids(batch) == ["u0", "u1", "u2"]
        assert _columnar_rows(batch) == 0
        assert tailer_mod._m_col_fallback.value() == fb_before + 3
        assert t.poll_columnar().n_events == 0

    def test_counters_split_columnar_vs_fallback(self, tmp_path):
        _, dcfg = _columnar_configs()
        events = _jsonl_events(tmp_path)
        _, t_col = _attach_pair(events, dcfg)
        col0 = tailer_mod._m_col_lines.value()
        fb0 = tailer_mod._m_col_fallback.value()
        _mixed_stream(events, APP)
        batch = t_col.poll_columnar()
        col_rows = _columnar_rows(batch)
        assert col_rows == 7  # 9 lines but the $set and the bare rate
        assert tailer_mod._m_col_lines.value() == col0 + col_rows
        assert tailer_mod._m_col_fallback.value() == fb0 + batch.n_events - col_rows

    def test_decode_records_trace_span(self, tmp_path):
        _, dcfg = _columnar_configs()
        events = _jsonl_events(tmp_path)
        _, t_col = _attach_pair(events, dcfg)
        events.insert(_rate("u1", "i1", 5), APP)
        tr = obs_trace.Trace("poll")
        obs_trace.set_current_trace(tr)
        try:
            assert t_col.poll_columnar().n_events == 1
        finally:
            obs_trace.set_current_trace(None)
        assert any(name == "tail.decode" for name, _, _ in tr.spans)

    def test_seq_backend_wraps_object_poll(self, tmp_path):
        """A store without tail_files: poll_columnar is the object poll,
        one Event segment."""
        _, dcfg = _columnar_configs()
        events = _memory_events(tmp_path)
        t = EventTailer(events, APP, columnar_config=dcfg)
        events.insert(_rate("u1", "i1", 5), APP)
        batch = t.poll_columnar()
        assert batch.n_events == 1 and _columnar_rows(batch) == 0
        assert _batch_entity_ids(batch) == ["u1"]


def test_columnar_foldin_vs_retrain(storage, tmp_path):
    """A columnar fold of a new user's ratings ranks as a from-scratch
    retrain that saw the same events does."""
    app_id = _app(storage, "ColFoldApp")
    store_events = storage.get_events()
    log_events = _jsonl_events(tmp_path)

    def both(e):
        store_events.insert(e, app_id)
        log_events.insert(e, APP)

    for u in range(6):
        for i in range(8):
            both(_rate(f"a{u}", f"i{i}", 5 if i < 4 else 1))
            both(_rate(f"b{u}", f"i{i}", 1 if i < 4 else 5))
    base_model, _ = _train_model(storage, "ColFoldApp", "float32", "colfold")
    assert "newu" not in base_model.user_index
    t = EventTailer(log_events, APP, columnar_config=colspans.DecodeConfig())
    new_ratings = {"i0": 5, "i1": 5, "i4": 1, "i5": 1}
    for iid, v in new_ratings.items():
        both(_rate("newu", iid, v))
    batch = t.poll_columnar()
    assert batch.n_events == _columnar_rows(batch) == len(new_ratings)
    patched, stats = ALSFoldIn(log_events, APP, config=FoldInConfig(),
                               device="cpu").fold_in_columnar(base_model, batch)
    assert patched is not None and stats.users_added == 1
    retrained, _ = _train_model(storage, "ColFoldApp", "float32", "colfold2")
    s_fold, s_full = _scores(patched, "newu"), _scores(retrained, "newu")
    for s in (s_fold, s_full):
        assert min(s["i2"], s["i3"]) > max(s["i6"], s["i7"]), s

    def top3(s):
        return {i for i, _ in sorted(s.items(), key=lambda kv: -kv[1])[:3]}

    assert len(top3(s_fold) & top3(s_full)) >= 2

    def rmse(s):
        return float(np.sqrt(np.mean([(s[i] - v) ** 2 for i, v in new_ratings.items()])))

    assert rmse(s_fold) <= rmse(s_full) + RMSE_TOL["float32"]


# ---------------------------------------------------------------------------
# the slice against the JAX package
# ---------------------------------------------------------------------------


def test_columnar_tail_and_fold_equal_the_jax_packages(tmp_path):
    """The same events in a partitioned store written by each package,
    tailed by each package's ``poll_columnar`` and folded by each
    ``fold_in_columnar`` from the same factors: the same deliveries, fold
    stats and user order, solved rows within rtol 5e-4 / atol 5e-5; the
    port's columnar fold bit for bit its object fold of the same lines."""
    from predictionio_tpu import native as jnative
    from predictionio_tpu.data.bimap import BiMap as JBiMap
    from predictionio_tpu.data.event import Event as JEvent
    from predictionio_tpu.data.storage import colspans as jcolspans
    from predictionio_tpu.data.storage.partitioned import (
        PartitionedEvents as JPartitionedEvents,
    )
    from predictionio_tpu.data.storage.partitioned import (
        PartitionedStorageClient as JPartitionedStorageClient,
    )
    from predictionio_tpu.models import recommendation as jrec
    from predictionio_tpu.realtime import ALSFoldIn as JALSFoldIn
    from predictionio_tpu.realtime import EventTailer as JEventTailer
    from predictionio_tpu.realtime import FoldInConfig as JFoldInConfig

    if not jnative.native_available():
        pytest.skip("the JAX package's native codec did not build")
    cfg, dcfg = _columnar_configs()
    jdcfg = jcolspans.DecodeConfig(**{k: getattr(dcfg, k) for k in (
        "event_names", "rating_key", "default_ratings", "override_ratings",
        "entity_type", "target_entity_type")})
    jcfg = JFoldInConfig(**{k: getattr(cfg, k) for k in (
        "event_names", "rating_key", "default_ratings", "override_ratings",
        "entity_type", "target_entity_type", "reg", "weighted_reg")})
    port_events = _partitioned_events(tmp_path / "port")
    jax_events = JPartitionedEvents(JPartitionedStorageClient(
        {"path": str(tmp_path / "jax" / "pev"), "partitions": 2}))
    model = _synthetic_model("float32", n_users=6, n_items=8)
    jmodel = jrec.ALSModel(
        user_index=JBiMap.from_dense(list(model.user_index)),
        item_index=JBiMap.from_dense(list(model.item_index)),
        user_factors=model.user_factors, item_factors=model.item_factors)
    # histories before the attach, the mixed stream after it
    for ev, cls in ((port_events, Event), (jax_events, JEvent)):
        for k in range(6):
            for i in range(3):
                ev.insert(cls(event="rate", entity_type="user", entity_id=f"u{k}",
                              target_entity_type="item", target_entity_id=f"i{(k + i) % 8}",
                              properties={"rating": float(1 + (k + i) % 5)}), APP)
    t_obj, t_col = EventTailer(port_events, APP), EventTailer(
        port_events, APP, columnar_config=dcfg)
    jt_col = JEventTailer(jax_events, APP, columnar_config=jdcfg)
    _mixed_stream(port_events, APP)
    _mixed_stream(jax_events, APP, JEvent)
    batch, jbatch, objs = t_col.poll_columnar(), jt_col.poll_columnar(), t_obj.poll()
    assert batch.n_events == jbatch.n_events == len(objs) == 9
    assert _columnar_rows(batch) == _columnar_rows(jbatch) == 7
    assert sorted(_batch_entity_ids(batch)) == sorted(_batch_entity_ids(jbatch))
    tp, ts = ALSFoldIn(port_events, APP, config=cfg, device="cpu").fold_in_columnar(
        model, batch)
    jp, js = JALSFoldIn(jax_events, APP, config=jcfg).fold_in_columnar(jmodel, jbatch)
    op, _ = ALSFoldIn(port_events, APP, config=cfg, device="cpu").fold(model, objs)
    assert (ts.rating_events, ts.users_touched, ts.users_added, ts.cold_item_events) == (
        js.rating_events, js.users_touched, js.users_added, js.cold_item_events)
    assert list(tp.user_index.items()) == list(jp.user_index.items())
    np.testing.assert_allclose(tp.user_factors, np.asarray(jp.user_factors),
                               rtol=5e-4, atol=5e-5)
    assert np.array_equal(tp.user_factors.view(np.uint8), op.user_factors.view(np.uint8))
