"""The quickstart on the port's CLI, and its records read both ways.

``tests/test_cli.py``'s ``test_quickstart`` and
``test_app_and_accesskey_verbs`` restated for ``python -m
predictionio_tpu_torch.cli.main`` (``--device cpu`` for ``train`` and
``deploy``): version, status, app new, import, export, train, deploy, a
query, undeploy, with the JAX CLI's printed lines. Then the records and
events each package's commands write into one sqlite store, read back
the same by the other; ``import`` through the splice route against the
JAX package's ``_splice_import_chunk``; ``import --http`` from either
package into the port's event server; the event codec's path in
``status``; and the flags of later slices, which raise.
"""

from __future__ import annotations

import json
import logging
import os
import re
import socket
import subprocess
import sys
import time
import urllib.request
from datetime import datetime, timezone

import numpy as np
import pytest

from predictionio_tpu.cli import commands as jcommands
from predictionio_tpu.data import store as jstore
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu_torch import native
from predictionio_tpu_torch.cli import commands
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.data.storage import test_storage as memory_storage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pio(args, env, timeout=180, check=True):
    proc = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main", *args],
        capture_output=True, text=True, env=env, timeout=timeout, cwd=REPO,
    )
    if check and proc.returncode != 0:
        raise AssertionError(
            f"pio {' '.join(args)} failed rc={proc.returncode}\n"
            f"stdout: {proc.stdout}\nstderr: {proc.stderr}"
        )
    return proc


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture()
def cli_env(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_STORAGE_")}
    env["PIO_FS_BASEDIR"] = str(tmp_path / "store")
    env["PYTHONPATH"] = REPO
    return env


def rate_lines(seed: int, users: int = 10, per_user: int = 6) -> list[dict]:
    """``rate`` events from a seed, one per (user, i)."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(1, 6, users * per_user).tolist()
    return [
        {
            "event": "rate",
            "entityType": "user",
            "entityId": f"u{u}",
            "targetEntityType": "item",
            "targetEntityId": f"i{(u + i) % 8}",
            "properties": {"rating": float(vals[u * per_user + i])},
            "eventTime": "2020-01-01T00:00:00.000Z",
        }
        for u in range(users) for i in range(per_user)
    ]


def write_lines(path, events: list[dict]) -> None:
    path.write_text("".join(json.dumps(e) + "\n" for e in events))


class TestCLILifecycle:
    def test_quickstart(self, cli_env, tmp_path):
        assert pio(["version"], cli_env).stdout.strip()
        out = pio(["status"], cli_env).stdout
        assert "(sanity check) All storage repositories verified." in out
        out = pio(["app", "new", "QuickApp"], cli_env).stdout
        access_key = [
            line.split(":", 1)[1].strip()
            for line in out.splitlines()
            if line.startswith("Access Key:")
        ][0]
        assert access_key

        events_file = tmp_path / "events.jsonl"
        write_lines(events_file, rate_lines(seed=0))
        out = pio(["import", "--appid-or-name", "QuickApp", "--input",
                   str(events_file)], cli_env).stdout
        assert "Imported 60 events." in out

        export_file = tmp_path / "export.jsonl"
        out = pio(["export", "--appid-or-name", "QuickApp", "--output",
                   str(export_file)], cli_env).stdout
        assert "Exported 60 events" in out
        assert len(export_file.read_text().splitlines()) == 60

        variant = {
            "id": "quick",
            "engineFactory": "predictionio_tpu_torch.models.recommendation.engine",
            "datasource": {"params": {"app_name": "QuickApp"}},
            "algorithms": [{"name": "als", "params": {"rank": 4, "num_iterations": 3}}],
        }
        variant_file = tmp_path / "engine.json"
        variant_file.write_text(json.dumps(variant))
        out = pio(["train", "--variant", str(variant_file), "--device", "cpu"],
                  cli_env).stdout
        assert "Training completed" in out

        port = free_port()
        server = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "deploy",
             "--variant", str(variant_file), "--ip", "127.0.0.1", "--port", str(port),
             "--device", "cpu"],
            env=cli_env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        try:
            deadline = time.time() + 120
            last_err = None
            while time.time() < deadline:
                if server.poll() is not None:
                    raise AssertionError(
                        f"deploy exited early: {server.stderr.read().decode()}")
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                                timeout=2) as resp:
                        if resp.status == 200:
                            break
                except Exception as e:
                    last_err = e
                    time.sleep(0.5)
            else:
                raise AssertionError(f"engine server never came up: {last_err}")
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/queries.json",
                data=json.dumps({"user": "u1", "num": 3}).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=30) as resp:
                body = json.loads(resp.read())
            assert len(body["itemScores"]) == 3
            out = pio(["undeploy", "--ip", "127.0.0.1", "--port", str(port)],
                      cli_env).stdout
            assert "Undeployed." in out
            assert server.wait(timeout=30) == 0
        finally:
            if server.poll() is None:
                server.kill()

    def test_app_and_accesskey_verbs(self, cli_env):
        pio(["app", "new", "VerbApp"], cli_env)
        assert "VerbApp" in pio(["app", "list"], cli_env).stdout
        out = pio(["app", "show", "VerbApp"], cli_env).stdout
        assert json.loads(out)["name"] == "VerbApp"
        pio(["app", "channel-new", "VerbApp", "live"], cli_env)
        assert "live" in pio(["app", "show", "VerbApp"], cli_env).stdout
        pio(["app", "channel-delete", "VerbApp", "live"], cli_env)
        out = pio(["accesskey", "new", "VerbApp", "--event", "rate"], cli_env).stdout
        key = out.split(":", 1)[1].strip()
        assert key in pio(["accesskey", "list", "VerbApp"], cli_env).stdout
        pio(["accesskey", "delete", key], cli_env)
        proc = pio(["app", "new", "VerbApp"], cli_env, check=False)
        assert proc.returncode == 1
        assert "already exists" in proc.stderr
        pio(["app", "data-delete", "VerbApp"], cli_env)
        pio(["app", "delete", "VerbApp"], cli_env)
        assert "VerbApp" not in pio(["app", "list"], cli_env).stdout


def both_storages(tmp_path):
    env = {"PIO_FS_BASEDIR": str(tmp_path)}
    return Storage(env=env), JaxStorage(env=env)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_apps_keys_and_channels_read_by_the_other_package(writer, tmp_path):
    port, jax = both_storages(tmp_path)
    w, r = (commands, jcommands) if writer == "port" else (jcommands, commands)
    ws, rs = (port, jax) if writer == "port" else (jax, port)
    try:
        info = w.app_new("Shared", app_id=7, description="one app", storage=ws)
        w.channel_new("Shared", "live", storage=ws)
        key = w.accesskey_new("Shared", events=["rate", "buy"], storage=ws)
        shown = r.app_show("Shared", storage=rs)
        assert shown == w.app_show("Shared", storage=ws)
        assert shown["id"] == 7 and shown["description"] == "one app"
        assert {k["key"] for k in shown["access_keys"]} == {info["access_key"], key}
        assert [c["name"] for c in shown["channels"]] == ["live"]
        assert r.accesskey_list("Shared", storage=rs) == w.accesskey_list(
            "Shared", storage=ws)
        assert r.app_list(storage=rs) == w.app_list(storage=ws)
        got = rs.get_metadata_access_keys().get(key)
        assert (got.key, got.appid, got.events) == (key, 7, ["rate", "buy"])
        # the reader deletes what the writer made
        r.accesskey_delete(key, storage=rs)
        r.channel_delete("Shared", "live", storage=rs)
        assert w.app_show("Shared", storage=ws)["channels"] == []
        r.app_delete("Shared", storage=rs)
        assert w.app_list(storage=ws) == []
    finally:
        port.close()
        jax.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_imported_events_found_equal_by_the_other_package(writer, tmp_path):
    """Events a package imports into sqlite (ids, times and creation
    times given) are ``find``-equal in the other, and its export of them
    is the other's export, byte for byte."""
    port, jax = both_storages(tmp_path / "store")
    w, ws = (commands, port) if writer == "port" else (jcommands, jax)
    events = rate_lines(seed=1)
    for j, e in enumerate(events):
        e["eventId"] = f"ev{j:04d}"
        e["eventTime"] = f"2020-01-0{j % 9 + 1}T00:00:{j % 60:02d}.{j:03d}+02:00"
        e["creationTime"] = "2020-02-01T00:00:00.000Z"
    events.append({"event": "$set", "entityType": "item", "entityId": "i3",
                   "properties": {"categories": ["a", "b"]}, "eventId": "ev-set",
                   "eventTime": "2020-01-01T00:00:00.000Z",
                   "creationTime": "2020-02-01T00:00:00.000Z"})
    src = tmp_path / "events.jsonl"
    write_lines(src, events)
    try:
        w.app_new("Imported", storage=ws)
        assert w.import_events("Imported", str(src), storage=ws) == len(events)
        got = store.find("Imported", storage=port)
        want = jstore.find("Imported", storage=jax)
        assert len(got) == len(events)
        assert [e.to_dict(for_api=False) for e in got] == [
            e.to_dict(for_api=False) for e in want]
        commands.export_events("Imported", str(tmp_path / "port.jsonl"), storage=port)
        jcommands.export_events("Imported", str(tmp_path / "jax.jsonl"), storage=jax)
        assert (tmp_path / "port.jsonl").read_bytes() == (
            tmp_path / "jax.jsonl").read_bytes()
        batch = store.find_ratings("Imported", event_names=["rate"], storage=port)
        jbatch = jstore.find_ratings("Imported", event_names=["rate"], storage=jax)
        assert batch.entity_ids == jbatch.entity_ids
        np.testing.assert_array_equal(batch.vals, jbatch.vals)
    finally:
        port.close()
        jax.close()


def _mask_generated_ids(blob: bytes, lines_with_ids: set[int]) -> list[bytes]:
    out = []
    for i, line in enumerate(blob.split(b"\n")):
        if i not in lines_with_ids:
            line = re.sub(rb'"eventId":"[0-9a-f]{32}"', b'"eventId":"*"', line)
        out.append(line)
    return out


def test_splice_import_chunk_equals_the_jax_function():
    """The splice route, alone: the same chunk gives the JAX function's
    blob, spliced count and fallback lines (the ids it draws for lines
    without one aside)."""
    rng = np.random.default_rng(5)
    lines = []
    for j in range(200):
        e = {"event": "rate", "entityType": "user", "entityId": f"u{rng.integers(50)}",
             "targetEntityType": "item", "targetEntityId": f"i{rng.integers(30)}",
             "properties": {"rating": float(rng.integers(1, 6))},
             "eventTime": "2020-01-01T00:00:00.000Z"}
        if j % 3:
            e["eventId"] = f"id{j}"
        if j % 7 == 0:
            e["creationTime"] = "2020-01-02T00:00:00.000Z"
        if j % 11 == 0:
            e["event"] = "$set"  # reserved: the slow path decides
        if j % 13 == 0:
            e["properties"] = {"pio_x": 1}  # reserved key: slow path
        if j % 17 == 0:
            e.pop("eventTime")  # no time on the wire: slow path
        lines.append(json.dumps(e))
    chunk = ("\n".join(lines) + "\n").encode()
    now = "2024-05-06T07:08:09.123Z"
    blob, n, fallback = commands._splice_import_chunk(chunk, now)
    jblob, jn, jfallback = jcommands._splice_import_chunk(chunk, now)
    assert n == jn and fallback == jfallback and 0 < n < 200 and fallback
    kept = [j for j in range(200) if lines[j].encode() not in fallback]
    with_ids = {k for k, j in enumerate(kept) if j % 3}
    assert _mask_generated_ids(blob, with_ids) == _mask_generated_ids(jblob, with_ids)


def test_import_takes_the_splice_route_on_a_store_that_appends_lines(tmp_path):
    """On a store with ``append_jsonl`` the import appends spliced lines
    and sends only the rest through ``_flush_slow``."""
    storage = memory_storage()
    commands.app_new("Splice", storage=storage)
    appended: list[bytes] = []
    dao_cls = type(storage.get_events())
    dao_cls.append_jsonl = lambda self, blob, app_id, channel_id=None: appended.append(blob)
    try:
        events = rate_lines(seed=2)
        events[3]["event"] = "$set"  # one line for the slow path
        events[3].pop("targetEntityType")
        events[3].pop("targetEntityId")
        src = tmp_path / "events.jsonl"
        write_lines(src, events)
        assert commands.import_events("Splice", str(src), storage=storage, jobs=1) == 60
    finally:
        del dao_cls.append_jsonl
    assert sum(len(b.splitlines()) for b in appended) == 59
    assert [e.event for e in store.find("Splice", storage=storage)] == ["$set"]


@pytest.mark.parametrize("client", ["port", "jax"])
def test_import_over_http_into_the_port_event_server(client, tmp_path):
    """``import --http`` of either package sends binary frames that the
    port's event server stores as the file's events."""
    from predictionio_tpu_torch.server.event_server import EventServer

    storage = memory_storage()
    info = commands.app_new("Wire", storage=storage)
    server = EventServer(storage=storage, host="127.0.0.1", port=0)
    port = server.start()
    events = rate_lines(seed=3, users=40, per_user=25)
    for j, e in enumerate(events):
        e["eventId"] = f"w{j}"
    src = tmp_path / "events.jsonl"
    write_lines(src, events)
    try:
        mod = commands if client == "port" else jcommands
        n = mod.import_events_http(str(src), f"http://127.0.0.1:{port}",
                                   info["access_key"], frame_events=300)
    finally:
        server.stop()
    assert n == len(events)
    got = sorted(store.find("Wire", storage=storage), key=lambda e: e.event_id)
    want = sorted((Event.from_dict(e) for e in events), key=lambda e: e.event_id)
    strip = ("creationTime",)
    assert [{k: v for k, v in e.to_dict(for_api=False).items() if k not in strip}
            for e in got] == [
        {k: v for k, v in e.to_dict(for_api=False).items() if k not in strip}
        for e in want]


def test_status_names_the_event_codec(monkeypatch, caplog):
    info = commands.status(storage=memory_storage())
    assert info["event_codec"]["path"] == "native"
    assert info["event_codec"]["library"] == str(native.library_path())
    assert info["devices"] and info["default_backend"] in ("cpu", "cuda")
    # a source that is not there: the pure-Python codec, said so
    monkeypatch.setattr(native, "SOURCE", native.SOURCE.with_name("absent.cpp"))
    monkeypatch.setattr(native, "_lib_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_path", None)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert commands.status(storage=memory_storage())["event_codec"] == {
            "path": "python", "library": None}
    assert any("pure-Python" in r.getMessage() and r.levelno == logging.WARNING
               for r in caplog.records)
    (event,) = native.parse_events_jsonl(
        b'{"event":"rate","entityType":"user","entityId":"u1"}\n')
    assert event.entity_id == "u1"


@pytest.mark.parametrize("argv", [
    ["eventserver", "--workers", "2", "--port", "7070"],
    ["deploy", "--workers", "2", "--variant", "engine.json"],
    ["start-all", "--no-dashboard", "--no-adminserver", "--replicas", "2"],
])
def test_later_slice_flags_raise(argv, monkeypatch, tmp_path):
    """The flags of ROADMAP.md queue 1 item 10b run: ``--workers 2``
    spawns two workers of the port's CLI with the flag stripped and
    ``--reuse-port`` added; ``start-all --replicas 2`` without an engine
    to deploy starts the event server alone, as the JAX package's does. Nothing is started for real: ``subprocess.Popen`` and
    ``daemon.start_service`` are recorders."""
    from predictionio_tpu_torch.cli import daemon

    monkeypatch.setenv("PIO_RUN_DIR", str(tmp_path / "run"))
    spawned, started = [], []

    class Worker:
        def __init__(self, cmd, *a, **kw):
            spawned.append(cmd)

        def poll(self):
            return 0

    monkeypatch.setattr(subprocess, "Popen", Worker)
    monkeypatch.setattr("signal.signal", lambda *a: None)
    monkeypatch.setattr(cli.time, "sleep", lambda s: None)
    monkeypatch.setattr(daemon, "start_service",
                        lambda name, av, host, port: started.append((name, port)) or 1)
    assert cli.main(argv) == 0
    if argv[0] == "start-all":
        assert started == [("eventserver", 7070)] and not spawned
        return
    rest = [t for t in argv if t not in ("--workers", "2")]
    assert spawned == [[sys.executable, "-m", "predictionio_tpu_torch.cli.main",
                        *rest, "--reuse-port"]] * 2
    assert not started


def test_undeploy_without_a_server_fails(capsys):
    assert cli.main(["undeploy", "--ip", "127.0.0.1", "--port", str(free_port())]) == 1
    assert "undeploy failed" in capsys.readouterr().err


def test_app_new_records_a_creation_usable_now(tmp_path):
    """``app new`` on sqlite makes the app's event table: an event
    inserted right after is found, by both packages."""
    port, jax = both_storages(tmp_path)
    try:
        info = commands.app_new("Now", storage=port)
        when = datetime(2021, 1, 1, tzinfo=timezone.utc)
        port.get_events().insert(Event(event="view", entity_type="user",
                                       entity_id="u1", event_time=when), info["id"])
        assert [e.entity_id for e in jstore.find("Now", storage=jax)] == ["u1"]
    finally:
        port.close()
        jax.close()
