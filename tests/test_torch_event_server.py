"""The port's event server against the JAX package's.

The cases of ``tests/test_servers.py::TestEventServer`` restated for
``predictionio_tpu_torch.server.event_server``, on real sockets. Each
case drives the port's server; where the answer is deterministic (``/``,
the 400/401/403/404/413/500 bodies, batch-limit rejections, webhook
errors) the same request goes to the JAX ``EventServer`` too and the two
answers must agree byte for byte. Stored events are compared field for
field (ids and the server's clock readings aside). Both servers run on
in-memory stores of their own package; the sqlite case shares one store
between the packages.
"""

from __future__ import annotations

import base64
import http.client as httpc
import json
from urllib.parse import urlencode, urlsplit

import pytest

from predictionio_tpu.cli import commands as jcommands
from predictionio_tpu.data.storage import test_storage as jax_memory_storage
from predictionio_tpu.server.event_server import EventServer as JaxEventServer
from predictionio_tpu_torch.cli import commands
from predictionio_tpu_torch.data.storage import AccessKey, Storage
from predictionio_tpu_torch.data.storage import test_storage as memory_storage
from predictionio_tpu_torch.server import plugins as plugin_mod
from predictionio_tpu_torch.server.event_server import EventServer

EVENT = {
    "event": "rate",
    "entityType": "user",
    "entityId": "u1",
    "targetEntityType": "item",
    "targetEntityId": "i1",
    "properties": {"rating": 4.5},
}


def raw(method: str, url: str, body=None, headers=None) -> tuple[int, bytes]:
    """(status, body bytes) of one request."""
    parts = urlsplit(url)
    data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
    conn = httpc.HTTPConnection(parts.hostname, parts.port, timeout=10)
    try:
        path = parts.path + (f"?{parts.query}" if parts.query else "")
        conn.request(method, path, data, headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def http(method, url, body=None, headers=None):
    status, payload = raw(method, url, body, headers)
    return status, json.loads(payload or b"{}")


def _start(server_cls, storage, cmds, app="EventApp", **kw):
    info = cmds.app_new(app, storage=storage)
    server = server_cls(storage=storage, host="127.0.0.1", port=0, **kw)
    port = server.start()
    return {"base": f"http://127.0.0.1:{port}", "key": info["access_key"],
            "app_id": info["id"], "storage": storage, "server": server}


@pytest.fixture()
def event_server():
    s = _start(EventServer, memory_storage(), commands, stats=True)
    yield s
    s["server"].stop()


@pytest.fixture()
def jax_server():
    s = _start(JaxEventServer, jax_memory_storage(), jcommands, stats=True)
    yield s
    s["server"].stop()


def same_answer(port, jax, method, path, body=None, headers=None, key=True):
    """The port's and the JAX server's answers to one request, which must
    be byte-equal; returns the port's (status, parsed body)."""
    def url(s):
        sep = "&" if "?" in path else "?"
        return s["base"] + path + (f"{sep}accessKey={s['key']}" if key else "")

    got = raw(method, url(port), body, headers)
    want = raw(method, url(jax), body, headers)
    assert got == want
    return got[0], json.loads(got[1] or b"{}")


def stored(s, **kw) -> list[dict]:
    """The app's stored events as dicts, without the ids and the server's
    clock readings (creation time)."""
    out = []
    for e in s["storage"].get_events().find(s["app_id"], **kw):
        d = e.to_dict(for_api=False)
        d.pop("eventId", None)
        d.pop("creationTime", None)
        out.append(d)
    return sorted(out, key=json.dumps)


class TestEventServer:
    def test_welcome(self, event_server, jax_server):
        status, body = same_answer(event_server, jax_server, "GET", "/", key=False)
        assert status == 200 and body["status"] == "alive"

    def test_create_and_get_event(self, event_server, jax_server):
        base, key = event_server["base"], event_server["key"]
        status, body = http("POST", f"{base}/events.json?accessKey={key}", EVENT)
        assert status == 201 and "eventId" in body
        eid = body["eventId"]
        status, body = http("GET", f"{base}/events/{eid}.json?accessKey={key}")
        assert status == 200
        assert body["entityId"] == "u1"
        assert body["properties"]["rating"] == 4.5
        status, listed = http("GET", f"{base}/events.json?accessKey={key}")
        assert status == 200 and len(listed) == 1
        jb, jk = jax_server["base"], jax_server["key"]
        _, jbody = http("POST", f"{jb}/events.json?accessKey={jk}", EVENT)
        _, jgot = http("GET", f"{jb}/events/{jbody['eventId']}.json?accessKey={jk}")
        for d in (body, jgot):
            d.pop("eventId")
            d.pop("eventTime")  # the server's clock: no eventTime was sent
        assert body == jgot
        status, _ = http("DELETE", f"{base}/events/{eid}.json?accessKey={key}")
        assert status == 200
        status, payload = raw("GET", f"{base}/events/{eid}.json?accessKey={key}")
        assert status == 404
        assert (status, payload) == raw("GET", f"{jb}/events/nope.json?accessKey={jk}")

    def test_auth_required(self, event_server, jax_server):
        status, _ = same_answer(event_server, jax_server, "POST", "/events.json",
                                EVENT, key=False)
        assert status == 401
        status, _ = same_answer(event_server, jax_server, "POST",
                                "/events.json?accessKey=wrong", EVENT, key=False)
        assert status == 401

    def test_basic_auth_key(self, event_server):
        base, key = event_server["base"], event_server["key"]
        cred = base64.b64encode(f"{key}:".encode()).decode()
        status, _ = http("POST", f"{base}/events.json", EVENT,
                         headers={"Authorization": f"Basic {cred}"})
        assert status == 201

    def test_invalid_event_rejected(self, event_server, jax_server):
        bad = dict(EVENT, event="$unset", properties={})
        bad.pop("targetEntityType")
        bad.pop("targetEntityId")
        status, _ = same_answer(event_server, jax_server, "POST", "/events.json", bad)
        assert status == 400

    def test_event_name_allowlist(self, event_server, jax_server):
        from predictionio_tpu.data.storage import AccessKey as JaxAccessKey

        restricted = {
            "port": event_server["storage"].get_metadata_access_keys().insert(
                AccessKey("", appid=event_server["app_id"], events=["view"])),
            "jax": jax_server["storage"].get_metadata_access_keys().insert(
                JaxAccessKey("", appid=jax_server["app_id"], events=["view"])),
        }
        got = raw("POST", f"{event_server['base']}/events.json?accessKey="
                  f"{restricted['port']}", EVENT)
        want = raw("POST", f"{jax_server['base']}/events.json?accessKey="
                   f"{restricted['jax']}", EVENT)
        assert got[0] == 403 and got == want
        status, _ = http("POST", f"{event_server['base']}/events.json?accessKey="
                         f"{restricted['port']}", dict(EVENT, event="view"))
        assert status == 201

    def test_batch_limit_50(self, event_server, jax_server):
        status, body = same_answer(event_server, jax_server, "POST",
                                   "/batch/events.json", [EVENT] * 51)
        assert status == 413
        assert body["error"] == "BatchTooLarge"
        assert "PIO_BATCH_MAX_EVENTS" in body["message"]
        batch = [EVENT, dict(EVENT, event="")]  # the second invalid
        base, key = event_server["base"], event_server["key"]
        status, body = http("POST", f"{base}/batch/events.json?accessKey={key}", batch)
        assert status == 200
        assert body[0]["status"] == 201
        _, jbody = http("POST", f"{jax_server['base']}/batch/events.json?accessKey="
                        f"{jax_server['key']}", batch)
        assert body[1] == jbody[1] and body[1]["status"] == 400

    def test_batch_limit_knob(self, monkeypatch):
        monkeypatch.setenv("PIO_BATCH_MAX_EVENTS", "3")
        port = _start(EventServer, memory_storage(), commands, app="KnobApp")
        jax = _start(JaxEventServer, jax_memory_storage(), jcommands, app="KnobApp")
        try:
            base, key = port["base"], port["key"]
            status, _ = http("POST", f"{base}/batch/events.json?accessKey={key}",
                             [EVENT] * 3)
            assert status == 200
            status, body = same_answer(port, jax, "POST", "/batch/events.json",
                                       [EVENT] * 4)
            assert status == 413
            assert body["error"] == "BatchTooLarge"
        finally:
            port["server"].stop()
            jax["server"].stop()

    def test_channel_auth(self, event_server, jax_server):
        status, _ = same_answer(event_server, jax_server, "POST",
                                "/events.json?channel=nope", EVENT)
        assert status == 401
        commands.channel_new("EventApp", "live", storage=event_server["storage"])
        jcommands.channel_new("EventApp", "live", storage=jax_server["storage"])
        base, key = event_server["base"], event_server["key"]
        status, _ = http("POST", f"{base}/events.json?accessKey={key}&channel=live",
                         EVENT)
        assert status == 201
        # channel isolation: the default channel has no events
        status, _ = same_answer(event_server, jax_server, "GET", "/events.json")
        assert status == 404

    def test_stats(self, event_server, jax_server):
        for s in (event_server, jax_server):
            http("POST", f"{s['base']}/events.json?accessKey={s['key']}", EVENT)
        status, body = http("GET", f"{event_server['base']}/stats.json?accessKey="
                            f"{event_server['key']}")
        assert status == 200
        assert body["eventCount"]["rate"] == 1
        _, jbody = http("GET", f"{jax_server['base']}/stats.json?accessKey="
                        f"{jax_server['key']}")
        for k in ("statusCount", "eventCount", "entityTypeCount", "lastEventSeq"):
            assert body[k] == jbody[k]
        assert set(body["ingest"]) == set(jbody["ingest"])

    def test_segmentio_webhook(self, event_server, jax_server):
        payload = {
            "version": "2",
            "type": "track",
            "userId": "sio-user",
            "event": "Signed Up",
            "properties": {"plan": "Pro"},
            "timestamp": "2020-01-02T03:04:05.000Z",
        }
        for s in (event_server, jax_server):
            status, _ = http(
                "POST", f"{s['base']}/webhooks/segmentio.json?accessKey={s['key']}",
                payload)
            assert status == 201
        base, key = event_server["base"], event_server["key"]
        status, events = http("GET", f"{base}/events.json?accessKey={key}"
                              "&entityId=sio-user")
        assert status == 200
        assert events[0]["event"] == "track"
        assert events[0]["properties"]["event"] == "Signed Up"
        assert stored(event_server) == stored(jax_server)
        status, _ = same_answer(event_server, jax_server, "POST",
                                "/webhooks/segmentio.json", {"version": "1"})
        assert status == 400

    def test_mailchimp_webhook_form(self, event_server, jax_server):
        form = urlencode(
            {
                "type": "subscribe",
                "fired_at": "2009-03-26 21:35:57",
                "data[id]": "8a25ff1d98",
                "data[list_id]": "a6b5da1054",
                "data[email]": "api@mailchimp.com",
            }
        ).encode()
        for s in (event_server, jax_server):
            status, _ = http(
                "POST", f"{s['base']}/webhooks/mailchimp.form?accessKey={s['key']}",
                form)
            assert status == 201
        base, key = event_server["base"], event_server["key"]
        status, events = http("GET", f"{base}/events.json?accessKey={key}"
                              "&entityId=8a25ff1d98")
        assert events[0]["event"] == "subscribe"
        assert events[0]["targetEntityId"] == "a6b5da1054"
        assert stored(event_server) == stored(jax_server)
        status, _ = same_answer(event_server, jax_server, "POST",
                                "/webhooks/mailchimp.form",
                                urlencode({"type": "nope"}).encode())
        assert status == 400

    def test_unknown_webhook(self, event_server, jax_server):
        status, _ = same_answer(event_server, jax_server, "POST",
                                "/webhooks/unknown.json", {})
        assert status == 404
        status, _ = same_answer(event_server, jax_server, "GET",
                                "/webhooks/segmentio.form")
        assert status == 404
        status, body = same_answer(event_server, jax_server, "GET",
                                   "/webhooks/segmentio.json")
        assert status == 200 and body == {"message": "Ok"}

    def test_plugins_json_inventory(self, event_server):
        """GET /plugins.json groups loaded plugins by interception type
        (reference EventServer.scala:156-177)."""

        class Sniffy(plugin_mod.EventServerPlugin):
            plugin_name = "sniffy"
            plugin_description = "records things"
            plugin_type = plugin_mod.INPUT_SNIFFER

        event_server["server"].plugins.append(Sniffy())
        status, body = http("GET", f"{event_server['base']}/plugins.json")
        assert status == 200
        entry = body["plugins"]["inputsniffers"]["sniffy"]
        assert entry["description"] == "records things"
        assert entry["class"].endswith("Sniffy")
        assert body["plugins"]["inputblockers"] == {}

    def test_plugin_rest_dispatch(self, event_server, jax_server):
        """/plugins/<type>/<name>/<args...> authenticates, then hands the
        sub-path and the app to the plugin's handle_rest."""
        from predictionio_tpu.server import plugins as jplugin_mod

        def echo(mod):
            class Echo(mod.EventServerPlugin):
                plugin_name = "echo"
                plugin_type = mod.INPUT_SNIFFER

                def handle_rest(self, path, params):
                    return {"path": path, "appId": params.get("appId"),
                            "q": params.get("q")}
            return Echo()

        event_server["server"].plugins.append(echo(plugin_mod))
        jax_server["server"].plugins.append(echo(jplugin_mod))
        base, key = event_server["base"], event_server["key"]
        status, _ = same_answer(event_server, jax_server, "GET",
                                "/plugins/inputsniffer/echo/a/b", key=False)
        assert status == 401
        status, body = http("GET", f"{base}/plugins/inputsniffer/echo/a/b"
                            f"?accessKey={key}&q=7")
        assert status == 200
        assert body == {"path": "a/b", "appId": str(event_server["app_id"]), "q": "7"}
        status, body = http("POST", f"{base}/plugins/inputsniffer/echo?accessKey={key}",
                            {})
        assert status == 200 and body["path"] == ""
        for path in ("/plugins/inputblocker/echo", "/plugins/bogus/echo"):
            status, _ = same_answer(event_server, jax_server, "GET", path)
            assert status == 404

    def test_plugin_rest_error_does_not_kill_server(self, event_server, jax_server):
        from predictionio_tpu.server import plugins as jplugin_mod

        def boom(mod):
            class Boom(mod.EventServerPlugin):
                plugin_name = "boom"
                plugin_type = mod.INPUT_BLOCKER

                def handle_rest(self, path, params):
                    raise RuntimeError("kapow")
            return Boom()

        event_server["server"].plugins.append(boom(plugin_mod))
        jax_server["server"].plugins.append(boom(jplugin_mod))
        status, body = same_answer(event_server, jax_server, "GET",
                                   "/plugins/inputblocker/boom")
        assert status == 500 and "kapow" in body["message"]
        status, _ = http("GET", f"{event_server['base']}/")
        assert status == 200


def test_event_server_touches_no_device(event_server):
    """Serving events initialises no CUDA, and /stats.json's device block
    reads no device memory."""
    import torch

    base, key = event_server["base"], event_server["key"]
    assert http("POST", f"{base}/events.json?accessKey={key}", EVENT)[0] == 201
    status, body = http("GET", f"{base}/stats.json?accessKey={key}")
    assert status == 200
    assert all(d["memory"] is None for d in body["device"]["devices"])
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_events_posted_to_either_server_read_the_same_by_the_other(writer, tmp_path):
    """One sqlite store: events POSTed through one package's event server
    (single, batch, webhook) are found equal by the other package, on
    an app and access key that package's commands made."""
    from predictionio_tpu.data.storage import Storage as JaxStorage

    env = {"PIO_FS_BASEDIR": str(tmp_path)}
    port_storage, jax_storage = Storage(env=env), JaxStorage(env=env)
    try:
        if writer == "port":
            s = _start(EventServer, port_storage, commands, app="Shared")
        else:
            s = _start(JaxEventServer, jax_storage, jcommands, app="Shared")
        try:
            base, key = s["base"], s["key"]
            one = dict(EVENT, eventId="e-single", eventTime="2021-02-03T04:05:06.789Z")
            assert http("POST", f"{base}/events.json?accessKey={key}", one)[0] == 201
            batch = [dict(EVENT, entityId=f"u{j}", eventId=f"e-batch-{j}",
                          eventTime="2021-02-03T04:05:06.789+02:00",
                          properties={"rating": j + 0.5}) for j in range(5)]
            status, body = http("POST", f"{base}/batch/events.json?accessKey={key}",
                                batch)
            assert status == 200 and [r["status"] for r in body] == [201] * 5
        finally:
            s["server"].stop()
        port_events = port_storage.get_events().find(s["app_id"])
        jax_events = jax_storage.get_events().find(s["app_id"])
        assert len(port_events) == 6
        assert [e.to_dict(for_api=False) for e in port_events] == [
            e.to_dict(for_api=False) for e in jax_events]
        # the other package's server takes the same key
        other = (_start(JaxEventServer, jax_storage, jcommands, app="Other")
                 if writer == "port" else
                 _start(EventServer, port_storage, commands, app="Other"))
        try:
            status, _ = http("GET", f"{other['base']}/events/e-single.json"
                             f"?accessKey={key}")
            assert status == 200
        finally:
            other["server"].stop()
    finally:
        port_storage.close()
        jax_storage.close()


def test_eventserver_verb_serves_and_drains_on_sigterm(tmp_path):
    """``cli.main eventserver`` in a process of its own: ready on
    ``/readyz``, an event POSTed with an access key from ``app new`` is
    stored in sqlite, and SIGTERM drains it to exit 0."""
    import os
    import signal
    import socket
    import subprocess
    import sys
    import time

    from predictionio_tpu.data import store as jstore
    from predictionio_tpu.data.storage import Storage as JaxStorage

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_STORAGE_")}
    env.update(PIO_FS_BASEDIR=str(tmp_path), PYTHONPATH=root)
    storage = Storage(env={"PIO_FS_BASEDIR": str(tmp_path)})
    key = commands.app_new("Served", storage=storage)["access_key"]
    storage.close()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "eventserver",
         "--ip", "127.0.0.1", "--port", str(port)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.time() + 60
        while True:
            assert proc.poll() is None, proc.stdout.read().decode()
            try:
                if raw("GET", f"{base}/readyz")[0] == 200:
                    break
            except OSError:
                pass
            assert time.time() < deadline, "eventserver not ready"
            time.sleep(0.2)
        one = dict(EVENT, eventId="served-1", eventTime="2021-01-01T00:00:00.000Z")
        assert http("POST", f"{base}/events.json?accessKey={key}", one)[0] == 201
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    jax = JaxStorage(env={"PIO_FS_BASEDIR": str(tmp_path)})
    try:
        assert [e.event_id for e in jstore.find("Served", storage=jax)] == ["served-1"]
    finally:
        jax.close()
