"""The port's binary frame ingest against the JAX package's.

``tests/test_frame_ingest.py``'s ``TestFrameCodec``, ``TestBinEndpoint``
and ``TestBackpressure`` restated for ``predictionio_tpu_torch``'s
``data/storage/frame.py`` and event server, with ``encode_body`` giving
the same bytes in both packages and each decoded frame rendering the
JAX package's events; every row of ``test_differential_bin_vs_json``
(sqlite, memory, jsonl, partitioned), where the port's stored events are
also the JAX server's on the same body; and the kill -9 splice matrix on
the jsonl and partitioned stores.
"""

from __future__ import annotations

import io
import json
import struct
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.cli import commands as jcommands
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.storage import frame as jframe
from predictionio_tpu.server.event_server import EventServer as JaxEventServer
from predictionio_tpu_torch import faults
from predictionio_tpu_torch.cli import commands
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import AccessKey, Storage, frame
from predictionio_tpu_torch.data.storage import test_storage as memory_storage
from predictionio_tpu_torch.server.event_server import EventServer

from tests.test_torch_event_server import http

STAMP = "2024-01-01T00:00:00.000000Z"


def _mixed_events(n: int, prefix: str = "m", seed: int = 0) -> list[dict]:
    """A mixed-shape batch from a seed: targeted and untargeted events,
    ``$set``, unicode properties, tags and prId, varied time spellings,
    explicit ids."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, 211, n).tolist()
    items = rng.integers(0, 37, n).tolist()
    out = []
    kinds = ("rate", "buy", "$set", "view", "like")
    for j in range(n):
        kind = j % 5
        d = {
            "event": kinds[kind],
            "entityType": "user",
            "entityId": f"{prefix}u{users[j]}",
            "eventTime": (
                f"2021-03-0{j % 9 + 1}T0{j % 10}:1{j % 6}:0{j % 10}"
                f".{j % 1000:03d}+0{j % 3}:00"
            ),
            "eventId": f"{prefix}ev{j:06d}",
            "creationTime": "2021-04-01T12:30:45.678Z",
        }
        if kind != 2:
            d["targetEntityType"] = "item"
            d["targetEntityId"] = f"i{items[j]}"
        if kind == 0:
            d["properties"] = {"rating": j % 5 + 0.5}
        elif kind == 2:
            d["properties"] = {
                "名前": f"ユーザー{j}",
                "nested": {"a": [1, 2, j], "b": None},
                "flag": j % 2 == 0,
            }
        elif kind == 4:
            d["tags"] = ["α-tag", "b"]
            d["prId"] = f"pr{j % 7}"
        out.append(d)
    return out


def _post_bin(base: str, key: str, body: bytes):
    req = urllib.request.Request(
        f"{base}/batch/events.bin?accessKey={key}",
        data=body,
        method="POST",
        headers={"Content-Type": "application/octet-stream"},
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read() or b"{}"), dict(resp.headers)
    except urllib.error.HTTPError as e:
        payload = e.read()
        try:
            parsed = json.loads(payload or b"{}")
        except json.JSONDecodeError:
            parsed = {"raw": payload.decode("utf-8", "replace")}
        return e.code, parsed, dict(e.headers)


@pytest.fixture()
def bin_server():
    storage = memory_storage()
    info = commands.app_new("FrameApp", storage=storage)
    server = EventServer(storage=storage, host="127.0.0.1", port=0)
    port = server.start()
    yield {
        "base": f"http://127.0.0.1:{port}",
        "key": info["access_key"],
        "app_id": info["id"],
        "storage": storage,
        "server": server,
    }
    server.stop()


def _first_frame(body: bytes) -> bytes:
    return next(iter(frame.read_frames(io.BytesIO(body))))


class TestFrameCodec:
    @pytest.mark.parametrize("frame_events", [1, 128, 300, 2000])
    def test_encode_body_bytes_equal_the_jax_package(self, frame_events):
        evs = _mixed_events(300)
        body = frame.encode_body(evs, frame_events=frame_events)
        assert body == jframe.encode_body(evs, frame_events=frame_events)

    def test_roundtrip_to_events(self):
        evs = _mixed_events(300)
        body = frame.encode_body(evs, frame_events=128)
        batches = [frame.decode_frame(p) for p in frame.read_frames(io.BytesIO(body))]
        assert [b.n for b in batches] == [128, 128, 44]
        decoded = []
        for b in batches:
            events, ids = b.to_events(None, STAMP)
            assert [e.event_id for e in events] == ids
            decoded.extend(events)
        for d, e in zip(evs, decoded):
            assert e.to_dict(for_api=False) == Event.from_dict(d).to_dict(for_api=False)
            assert e.to_dict(for_api=False) == JaxEvent.from_dict(d).to_dict(
                for_api=False)

    def test_render_jsonl_byte_parity(self):
        """Each rendered line is what json.dumps(Event.to_dict()) stores,
        and the JAX package's rendering of the same frame."""
        evs = _mixed_events(100)
        payload = _first_frame(frame.encode_body(evs, frame_events=100))
        blob, ids, _ = frame.decode_frame(payload).render_jsonl(None, STAMP)
        lines = blob.decode("utf-8").splitlines()
        assert len(lines) == 100
        for d, line in zip(evs, lines):
            assert line == json.dumps(Event.from_dict(d).to_dict(for_api=False))
        jblob, jids, _ = jframe.decode_frame(payload).render_jsonl(None, STAMP)
        assert (blob, ids) == (jblob, jids)

    def test_generated_ids_and_stamp(self):
        evs = [{"event": "view", "entityType": "user", "entityId": "u1"}
               for _ in range(5)]
        payload = _first_frame(frame.encode_body(evs))
        blob, ids, _ = frame.decode_frame(payload).render_jsonl(None, STAMP)
        assert len(set(ids)) == 5 and all(len(i) == 32 for i in ids)
        for line in blob.decode().splitlines():
            d = json.loads(line)
            assert d["eventTime"] == STAMP
            assert d["creationTime"] == STAMP

    def test_torn_and_malformed_bodies(self):
        body = frame.encode_body(_mixed_events(20), frame_events=10)
        cases = [
            (body[:-7], "TornFrame"),
            (b"XXXX" + body[4:], "BadMagic"),
            (frame.MAGIC + struct.pack("<I", 1 << 31) + b"\0" * 16, "FrameTooLarge"),
        ]
        for bad, code in cases:
            with pytest.raises(frame.FrameError) as ei:
                list(frame.read_frames(io.BytesIO(bad)))
            assert ei.value.code == code
            with pytest.raises(jframe.FrameError) as je:
                list(jframe.read_frames(io.BytesIO(bad)))
            assert str(ei.value) == str(je.value)

    def test_invalid_event_positions(self):
        evs = _mixed_events(10)
        evs[7]["event"] = ""
        payload = _first_frame(frame.encode_body(evs, frame_events=10))
        with pytest.raises(frame.FrameEventError) as ei:
            frame.decode_frame(payload).render_jsonl(None, STAMP)
        assert ei.value.index == 7
        with pytest.raises(jframe.FrameEventError) as je:
            jframe.decode_frame(payload).render_jsonl(None, STAMP)
        assert str(ei.value) == str(je.value)


class TestBinEndpoint:
    def test_stores_events(self, bin_server):
        base, key = bin_server["base"], bin_server["key"]
        evs = _mixed_events(120)
        status, resp, _ = _post_bin(base, key, frame.encode_body(evs, frame_events=50))
        assert status == 200
        assert resp["accepted"] == 120 and resp["frames"] == 3
        stored = bin_server["storage"].get_events().find(bin_server["app_id"])
        assert {e.event_id for e in stored} == {e["eventId"] for e in evs}

    def test_torn_frame_rejected_atomically(self, bin_server):
        """A torn second frame rejects the request with the committed
        prefix reported; no event of the torn frame is stored."""
        base, key = bin_server["base"], bin_server["key"]
        evs = _mixed_events(40, prefix="t")
        body = frame.encode_body(evs, frame_events=20)
        status, resp, _ = _post_bin(base, key, body[:-11])
        assert status == 400
        assert resp["error"] == "TornFrame"
        assert resp["accepted"] == 20 and resp["frames"] == 1
        stored = bin_server["storage"].get_events().find(bin_server["app_id"])
        assert {e.event_id for e in stored} == {e["eventId"] for e in evs[:20]}

    def test_http_frame_fault_point(self, bin_server):
        """``http.frame`` injection severs the body read mid-request: the
        committed frame stays, the faulted one adds nothing, and the
        server keeps serving."""
        base, key = bin_server["base"], bin_server["key"]
        evs = _mixed_events(40, prefix="f")
        body = frame.encode_body(evs, frame_events=20)
        with faults.injected("http.frame:nth=2:raise=OSError"):
            try:
                status, resp, _ = _post_bin(base, key, body)
                assert status >= 400
            except OSError:
                pass
        stored = bin_server["storage"].get_events().find(bin_server["app_id"])
        assert {e.event_id for e in stored} == {e["eventId"] for e in evs[:20]}
        status, resp, _ = _post_bin(base, key, body)  # server still up
        assert status == 200 and resp["accepted"] == 40

    def test_invalid_event_rejects_whole_frame(self, bin_server):
        base, key = bin_server["base"], bin_server["key"]
        evs = _mixed_events(10, prefix="x")
        evs[4]["entityId"] = ""
        status, resp, _ = _post_bin(base, key, frame.encode_body(evs, frame_events=10))
        assert status == 400
        assert resp["error"] == "InvalidEvent"
        assert resp["accepted"] == 0
        assert bin_server["storage"].get_events().find(bin_server["app_id"]) == []

    def test_event_allowlist_applies(self, bin_server):
        restricted = bin_server["storage"].get_metadata_access_keys().insert(
            AccessKey("", appid=bin_server["app_id"], events=["view"])
        )
        status, resp, _ = _post_bin(bin_server["base"], restricted,
                                    frame.encode_body(_mixed_events(5)))
        assert status == 400 and resp["accepted"] == 0

    def test_empty_body_rejected(self, bin_server):
        status, resp, _ = _post_bin(bin_server["base"], bin_server["key"], b"")
        assert status == 400
        assert resp["error"] == "EmptyBody"


class TestBackpressure:
    def test_shed_and_recover(self, bin_server):
        server = bin_server["server"]
        base, key = bin_server["base"], bin_server["key"]
        body = frame.encode_body(_mixed_events(5))
        budget = server._budget
        # standing occupancy: an idle budget always admits
        assert budget.try_acquire(budget.max_bytes)
        try:
            status, resp, headers = _post_bin(base, key, body)
            assert status == 429
            assert resp["error"] == "IngestBackpressure"
            assert headers.get("Retry-After") == "1"
            status, resp = http(
                "POST", f"{base}/batch/events.json?accessKey={key}",
                [{"event": "view", "entityType": "user", "entityId": "u1"}],
            )
            assert status == 429
        finally:
            budget.release(budget.max_bytes)
        stats = server.ingest_stats()
        assert stats["shed_total"] >= 2
        assert stats["inflight_bytes"] == 0
        status, resp, _ = _post_bin(base, key, body)  # drained: admits
        assert status == 200 and resp["accepted"] == 5

    def test_stats_shape(self, bin_server):
        stats = bin_server["server"].ingest_stats()
        for k in ("inflight_bytes", "max_inflight_bytes", "utilization",
                  "queue_depth", "shed_total", "frames_total", "batch_max_events"):
            assert k in stats, k


def _env_for(backend: str, tmp_path) -> dict:
    env = {
        "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "meta.db"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB",
    }
    if backend == "memory":
        env.update({"PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
                    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM"})
    if backend in ("jsonl", "partitioned"):
        env.update({"PIO_STORAGE_SOURCES_LOG_TYPE": backend,
                    "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp_path / "eventlog"),
                    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG"})
    if backend == "partitioned":
        env["PIO_STORAGE_SOURCES_LOG_PARTITIONS"] = "4"
    return env


def _ingest_both_ways(server_cls, storage, cmds, evs) -> tuple[list[str], list[str]]:
    """The same batch through ``/batch/events.json`` (50 a request) into
    one app and ``/batch/events.bin`` into another: the two apps' stored
    events, canonical and sorted."""
    app_json = cmds.app_new("DiffJson", storage=storage)
    app_bin = cmds.app_new("DiffBin", storage=storage)
    server = server_cls(storage=storage, host="127.0.0.1", port=0)
    port = server.start()
    try:
        base = f"http://127.0.0.1:{port}"
        for lo in range(0, len(evs), 50):
            status, resp = http(
                "POST", f"{base}/batch/events.json?accessKey={app_json['access_key']}",
                evs[lo : lo + 50])
            assert status == 200
            assert all(r["status"] == 201 for r in resp)
        status, resp, _ = _post_bin(base, app_bin["access_key"],
                                    frame.encode_body(evs, frame_events=1024))
        assert status == 200 and resp["accepted"] == len(evs)
    finally:
        server.stop()

    def canon(app_id: int) -> list[str]:
        return sorted(json.dumps(e.to_dict(for_api=False))
                      for e in storage.get_events().find(app_id))

    return canon(app_json["id"]), canon(app_bin["id"])


@pytest.mark.parametrize("backend", ["sqlite", "memory", "jsonl", "partitioned"])
def test_differential_bin_vs_json(backend, tmp_path):
    """The same 5k-event mixed batch through ``/batch/events.bin`` and
    ``/batch/events.json`` leaves byte-identical stored events on the
    port's server, and the JAX server stores the same bytes."""
    evs = _mixed_events(5000, prefix="d")
    storage = Storage(env=_env_for(backend, tmp_path / "port"))
    try:
        got_json, got_bin = _ingest_both_ways(EventServer, storage, commands, evs)
    finally:
        storage.close()
    assert len(got_bin) == 5000
    assert got_json == got_bin
    jstorage = JaxStorage(env=_env_for(backend, tmp_path / "jax"))
    try:
        want_json, want_bin = _ingest_both_ways(JaxEventServer, jstorage, jcommands, evs)
    finally:
        jstorage.close()
    assert (got_json, got_bin) == (want_json, want_bin)


# -- kill -9 durability on the splice path -------------------------------------

_SPLICE_CHILD = """
import io, json, sys
cfg = json.load(open(sys.argv[1]))
from predictionio_tpu_torch.data.storage import Storage, frame
storage = Storage(env=cfg["env"])
dao = storage.get_events()
dao.init(cfg["app_id"])
events = [
    {"event": "rate", "entityType": "user", "entityId": "ku%d" % (j % 13),
     "targetEntityType": "item", "targetEntityId": "ki%d" % (j % 7),
     "properties": {"rating": float(j % 5 + 1)},
     "eventTime": "2024-02-02T00:00:00.000Z",
     "creationTime": "2024-02-02T00:00:01.000Z",
     "eventId": "kev%04d" % j}
    for j in range(cfg["n_events"])
]
body = frame.encode_body(events, frame_events=cfg["frame_events"])
for payload in frame.read_frames(io.BytesIO(body)):
    batch = frame.decode_frame(payload)
    blob, ids, _ = batch.render_jsonl(None, "2024-02-02T00:00:00.000000Z")
    dao.append_jsonl(blob, cfg["app_id"], None)
    print("ACK " + " ".join(ids), flush=True)
print("DONE", flush=True)
"""


@pytest.mark.parametrize("backend,spec", [
    ("jsonl", "storage.fsync:nth=3:kill"),
    # partitioned spreads each 50-event frame over 4 partition writes:
    # nth=10 lands mid-frame-3 with two frames acked
    ("partitioned", "storage.write:nth=10:kill"),
])
def test_kill9_splice_zero_acked_loss(backend, spec, tmp_path):
    """SIGKILL mid-splice through the port's store: every frame acked
    before the kill is fully present after reopening the store
    (``tests/test_frame_ingest.py``'s matrix)."""
    import os
    import subprocess
    import sys

    env_dict = _env_for(backend, tmp_path)
    env_dict["PIO_STORAGE_SOURCES_LOG_SYNC"] = "always"
    storage = Storage(env=env_dict)
    try:
        info = commands.app_new("KillApp", storage=storage)
    finally:
        storage.close()
    cfg_path = tmp_path / "splice_cfg.json"
    cfg_path.write_text(json.dumps({"env": env_dict, "app_id": info["id"],
                                    "n_events": 200, "frame_events": 50}))
    child_env = dict(os.environ, PIO_FAULTS=spec)
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    os.environ.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", _SPLICE_CHILD, str(cfg_path)],
                          capture_output=True, text=True, env=child_env, timeout=120)
    assert proc.returncode == -9, (proc.returncode, proc.stderr)
    acked: list[str] = []
    for line in proc.stdout.splitlines():
        if line.startswith("ACK "):
            acked.extend(line.split()[1:])
    assert acked, proc.stdout
    assert "DONE" not in proc.stdout
    storage = Storage(env=env_dict)
    try:
        stored = {e.event_id for e in storage.get_events().find(info["id"])}
    finally:
        storage.close()
    lost = set(acked) - stored
    assert not lost, f"acked events lost after kill: {sorted(lost)[:5]}"
