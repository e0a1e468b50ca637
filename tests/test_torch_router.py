"""The port's router tier (``predictionio_tpu_torch/server/router.py``),
held to ``tests/test_router.py``: ring affinity deterministic and stable
across replica restarts, work-conserving spill, ejection and
re-admission on the breaker backoff with instance-aware membership, the
``router.forward`` / ``router.probe`` fault points, hedging, and a
multi-tenant replica set of the port's ``EngineServer`` (``device="cpu"``,
on an instance the JAX package trained) byte-identical through the router,
404s passed through. Beyond the JAX cases: the port's ring and picks equal
the JAX package's for the same replicas, seed and keys, so a mixed fleet
places queries alike; and the ``route`` verb serves with ``torch`` made
unimportable."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu_torch import faults
from predictionio_tpu_torch.server import router as router_mod
from predictionio_tpu_torch.server.http import HTTPApp, Response, Router
from predictionio_tpu_torch.server.router import RouterServer, parse_replica_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _post(url, body, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST"
    )
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _mk_pool(n=3, module=router_mod, **kw):
    reps = [module.Replica(f"r{i}", "127.0.0.1", 10000 + i) for i in range(n)]
    pool = module.ReplicaPool(reps, seed=7, **kw)
    for r in reps:
        r.state = module.READY
        r.instance = f"boot-{r.name}"
    return pool, reps


class TestReplicaPool:
    def test_affinity_is_deterministic_and_spreads(self):
        pool, _ = _mk_pool()
        keys = [f"query-{i}".encode() for i in range(64)]
        first = {k: pool.pick(k).name for k in keys}
        for _ in range(5):
            assert {k: pool.pick(k).name for k in keys} == first
        assert len(set(first.values())) > 1  # the ring actually spreads

    def test_ring_is_stable_across_pool_rebuild(self):
        """The ring is keyed on replica NAME: a rebuilt pool (the
        restarted-router case) sends every key to the same replica."""
        pool_a, _ = _mk_pool()
        pool_b, _ = _mk_pool()
        for i in range(64):
            k = f"query-{i}".encode()
            assert pool_a.pick(k).name == pool_b.pick(k).name

    def test_saturated_preferred_spills_to_least_inflight(self):
        pool, reps = _mk_pool(saturation=2)
        key = b"sticky"
        preferred = pool.pick(key)
        preferred.inflight = 2  # slots full
        others = [r for r in reps if r is not preferred]
        others[0].inflight = 1
        for _ in range(10):
            assert pool.pick(key) is not preferred

    def test_ejected_preferred_is_skipped_and_exclude_honored(self):
        pool, reps = _mk_pool()
        key = b"sticky"
        preferred = pool.pick(key)
        preferred.state = router_mod.EJECTED
        assert pool.pick(key) is not preferred
        assert pool.pick(key, exclude={r.name for r in reps}) is None
        only = pool.pick_other(
            exclude={r.name for r in reps if r is not reps[0]}
        )
        assert only is reps[0]

    def test_failure_ejects_with_backoff_and_probe_readmits(self):
        t = [100.0]
        pool, reps = _mk_pool(
            eject_base_s=1.0, eject_max_s=8.0, clock=lambda: t[0]
        )
        r0 = reps[0]
        pool.begin(r0)
        pool.record_failure(r0, "connect refused")
        assert r0.state == router_mod.EJECTED
        assert r0.ejections == 1 and r0.retry_at > t[0]

        def probe(host, port, timeout=0):
            return {"ready": True, "instance": r0.instance}

        # same instance, backoff not served: the ready probe is ignored
        pool.probe_one(r0, probe=probe)
        assert r0.state == router_mod.EJECTED
        # backoff expired: the same ready probe re-admits
        t[0] = r0.retry_at + 0.01
        pool.probe_one(r0, probe=probe)
        assert r0.state == router_mod.READY

    def test_repeat_failures_while_ejected_do_not_escalate(self):
        t = [100.0]
        pool, reps = _mk_pool(
            eject_base_s=1.0, eject_max_s=8.0, clock=lambda: t[0]
        )
        r0 = reps[0]
        pool.begin(r0)
        pool.record_failure(r0, "boom")
        retry_at = r0.retry_at
        pool.probe_one(r0, probe=lambda *a, **k: None)  # failing probe
        assert (r0.ejections, r0.eject_attempt) == (1, 1)
        assert r0.retry_at == retry_at  # backoff not re-armed per probe

    def test_new_instance_bypasses_backoff(self):
        """A restarted replica is a NEW member: a ready probe with a
        different instance id admits it immediately, fresh stats."""
        t = [100.0]
        pool, reps = _mk_pool(
            eject_base_s=1000.0, eject_max_s=2000.0, clock=lambda: t[0]
        )
        r0 = reps[0]
        r0.latencies.append(0.5)
        pool.begin(r0)
        pool.record_failure(r0, "kill -9")
        assert r0.retry_at > t[0] + 500  # effectively forever

        pool.probe_one(
            r0, probe=lambda *a, **k: {"ready": True, "instance": "resp-2"}
        )
        assert r0.state == router_mod.READY
        assert r0.instance == "resp-2"
        assert r0.eject_attempt == 0 and not r0.latencies

    def test_success_resets_breaker_escalation(self):
        pool, reps = _mk_pool()
        r0 = reps[0]
        r0.eject_attempt = 3
        pool.begin(r0)
        pool.record_success(r0, 0.01)
        assert r0.eject_attempt == 0


class TestAgainstTheJaxPackage:
    """One ring for both packages: the same replicas, seed and keys give
    the same ring, the same preferred replica, the same spill choices and
    the same ejection backoffs, so a fleet whose routers run either
    package places every query alike."""

    def test_ring_and_picks_equal(self):
        from predictionio_tpu.server import router as jrouter

        for n in (1, 2, 3, 5):
            ours, _ = _mk_pool(n)
            theirs, _ = _mk_pool(n, module=jrouter)
            assert ours._ring_points == theirs._ring_points
            assert ours._ring_names == theirs._ring_names
            rng = np.random.default_rng(n)
            keys = [bytes(rng.integers(0, 256, int(rng.integers(1, 40)),
                                       dtype=np.uint8)) for _ in range(256)]
            keys += [b"", b"\x00" + json.dumps({"user": "u1"}).encode()]
            for k in keys:
                assert [r.name for r in ours._ring_order(k)] == [
                    r.name for r in theirs._ring_order(k)]
                assert ours.pick(k).name == theirs.pick(k).name

    def test_spill_choices_and_backoffs_equal(self):
        from predictionio_tpu.server import router as jrouter

        t = [50.0]
        pools = [_mk_pool(4, module=m, saturation=1, eject_base_s=0.5,
                          eject_max_s=30.0, clock=lambda: t[0])
                 for m in (router_mod, jrouter)]
        for pool, reps in pools:
            for r, load in zip(reps, (1, 0, 2, 0)):
                r.inflight = load
        picks = [[pool.pick(f"q{i}".encode()).name for i in range(64)]
                 + [pool.pick_other({"r1"}).name for _ in range(16)]
                 for pool, _ in pools]
        assert picks[0] == picks[1]
        backoffs = []
        for (pool, reps), m in zip(pools, (router_mod, jrouter)):
            seq = []
            for _ in range(5):
                pool.begin(reps[2])
                pool.record_failure(reps[2], "down")
                seq.append(reps[2].retry_at - t[0])
                reps[2].state = m.READY  # re-admitted: the next one escalates
            backoffs.append(seq)
        assert backoffs[0] == backoffs[1]

    def test_parse_replica_spec_equal(self):
        from predictionio_tpu.server.router import parse_replica_spec as jparse

        for spec, i in (("127.0.0.1:8000", 2), ("web=10.0.0.5:9001", 0),
                        ("a=b=c:1", 3), ("[::1]:80", 1)):
            assert parse_replica_spec(spec, i) == jparse(spec, i)


class TestParseReplicaSpec:
    def test_forms(self):
        assert parse_replica_spec("127.0.0.1:8000", 2) \
            == ("engine-2", "127.0.0.1", 8000)
        assert parse_replica_spec("web=10.0.0.5:9001", 0) \
            == ("web", "10.0.0.5", 9001)

    @pytest.mark.parametrize("bad", ["8000", "host:", ":9", "host:abc"])
    def test_rejects_malformed(self, bad):
        with pytest.raises(ValueError):
            parse_replica_spec(bad, 0)


def _fake_engine(tag: str, delay_s: float = 0.0):
    """A minimal replica: answers /queries.json (tagged, echoing the
    body) and exposes the HTTPApp's built-in /readyz with its per-boot
    instance id — everything the router's probe and forward need."""
    r = Router()

    def q(req):
        if delay_s:
            time.sleep(delay_s)
        return Response.json({"who": tag, "echo": req.json()})

    r.add("POST", "/queries.json", q)
    app = HTTPApp(r, host="127.0.0.1", port=0, name=f"fake-{tag}")
    port = app.start(background=True)
    return app, port


@pytest.fixture()
def fake_pair():
    a, ap = _fake_engine("a")
    b, bp = _fake_engine("b")
    made = []
    try:
        yield {"a": ("engine-0", "127.0.0.1", ap),
               "b": ("engine-1", "127.0.0.1", bp), "made": made}
    finally:
        for srv in made:
            srv.stop()
        a.stop()
        b.stop()


def _router(fake_pair, **kw):
    kw.setdefault("probe_interval_s", 5.0)
    kw.setdefault("hedge", False)
    server = RouterServer(
        [fake_pair["a"], fake_pair["b"]], host="127.0.0.1", port=0, **kw
    )
    fake_pair["made"].append(server)
    port = server.start(background=True)
    return server, port


class TestFaultPoints:
    def test_router_points_are_documented(self):
        from predictionio_tpu_torch.faults.inject import KNOWN_POINTS

        assert "router.forward" in KNOWN_POINTS
        assert "router.probe" in KNOWN_POINTS

    def test_forward_fault_retries_on_another_replica(self, fake_pair):
        server, port = _router(fake_pair)
        retries0 = server._m_retries.value()
        with faults.injected("router.forward:times=1:raise"):
            status, body = _post(
                f"http://127.0.0.1:{port}/queries.json", {"user": "u1"}
            )
        assert status == 200  # the client never saw the fault
        assert json.loads(body)["echo"] == {"user": "u1"}
        assert server._m_retries.value() - retries0 == 1
        stats = server.stats()["replicas"]
        assert sum(s["ejections"] for s in stats.values()) == 1
        assert sum(1 for s in stats.values() if s["state"] == "ready") == 1

    def test_probe_fault_ejects_until_probe_recovers(self, fake_pair):
        server, port = _router(fake_pair, probe_interval_s=0.05)
        with faults.injected("router.probe:times=20:raise"):
            deadline = time.time() + 10
            while time.time() < deadline:
                states = {
                    s["state"] for s in server.stats()["replicas"].values()
                }
                if states == {"ejected"}:
                    break
                time.sleep(0.02)
            assert states == {"ejected"}
            # nothing admitted: the router itself reports not-ready
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/readyz", timeout=5
                )
            assert ei.value.code == 503
        # the plan is spent: probes succeed, backoff expires, both
        # replicas get re-admitted and traffic flows again
        deadline = time.time() + 10
        while time.time() < deadline:
            states = {
                s["state"] for s in server.stats()["replicas"].values()
            }
            if states == {"ready"}:
                break
            time.sleep(0.05)
        assert states == {"ready"}
        status, _ = _post(
            f"http://127.0.0.1:{port}/queries.json", {"user": "u2"}
        )
        assert status == 200


class TestHedging:
    def test_hedge_beats_the_straggler(self, fake_pair, monkeypatch):
        """With one straggling replica, hedged requests finish near the
        healthy replica's latency: the duplicate fires after the
        (blind, clamped-to-max) delay and the first response wins."""
        monkeypatch.setenv("PIO_ROUTER_HEDGE_MIN_MS", "5")
        monkeypatch.setenv("PIO_ROUTER_HEDGE_MAX_MS", "60")
        slow, sp = _fake_engine("slow", delay_s=0.5)
        try:
            fake_pair["b"] = ("engine-1", "127.0.0.1", sp)
            server, port = _router(fake_pair, hedge=True)
            hedges0 = server._m_hedges.value()
            wins0 = server._m_hedge_wins.value()
            for i in range(12):
                t0 = time.perf_counter()
                status, _ = _post(
                    f"http://127.0.0.1:{port}/queries.json",
                    {"user": f"u{i}"},
                )
                elapsed = time.perf_counter() - t0
                assert status == 200
                assert elapsed < 0.45, (
                    f"query u{i} waited out the straggler: {elapsed:.3f}s"
                )
            assert server._m_hedges.value() > hedges0
            assert server._m_hedge_wins.value() > wins0
        finally:
            slow.stop()


class TestMultiTenantThroughRouter:
    """Every routing form is byte-identical through the router, including
    the 404 for an unknown tenant (a replica 4xx is the CLIENT's answer,
    not a router failure), with the port's EngineServer on the CPU as the
    replica."""

    QUERIES = [{"user": f"u{u}", "num": 3} for u in range(4)]

    def _train(self, basedir):
        """The JAX package trains the instance into a sqlite + localfs
        store; the port reads it from there."""
        from predictionio_tpu.cli import commands
        from predictionio_tpu.core import EngineParams
        from predictionio_tpu.core.workflow import run_train
        from predictionio_tpu.data import storage as jstorage
        from predictionio_tpu.data.event import Event
        from predictionio_tpu.models import recommendation as rec

        env = {"PIO_FS_BASEDIR": str(basedir)}
        storage = jstorage.Storage(env=env)
        try:
            info = commands.app_new("RouteTenants", storage=storage)
            rng = np.random.default_rng(13)
            storage.get_events().batch_insert([
                Event(
                    event="rate", entity_type="user",
                    entity_id=f"u{u}", target_entity_type="item",
                    target_entity_id=f"i{int(rng.integers(0, 8))}",
                    properties={"rating": float(rng.integers(1, 6))},
                )
                for u in range(10) for _ in range(5)
            ], info["id"])
            ep = EngineParams(
                datasource=("", rec.DataSourceParams(app_name="RouteTenants")),
                algorithms=[(
                    "als", rec.ALSAlgorithmParams(rank=4, num_iterations=2),
                )],
            )
            jstorage.set_storage(storage)
            try:
                iid = run_train(rec.engine(), ep, engine_id="route-tenants",
                                storage=storage)
            finally:
                jstorage.set_storage(None)
        finally:
            storage.close()
        return env, iid

    def test_byte_identity_and_404_passthrough(self, tmp_path):
        from predictionio_tpu_torch.data import storage as tstorage
        from predictionio_tpu_torch.models import recommendation as rec
        from predictionio_tpu_torch.server.engine_server import EngineServer

        env, iid = self._train(tmp_path)
        storage = tstorage.Storage(env=env)
        inst = storage.get_metadata_engine_instances().get(iid)
        multi = EngineServer(
            rec.engine(), inst, storage=storage, host="127.0.0.1", port=0,
            extra_variants=[("b", rec.engine(), inst)], device="cpu",
        )
        mp = multi.start()
        server = RouterServer(
            [("engine-0", "127.0.0.1", mp)], host="127.0.0.1", port=0,
            probe_interval_s=5.0, hedge=False,
        )
        rp = server.start(background=True)
        try:
            forms = [
                ("/queries.json", None),
                ("/b/queries.json", None),
                ("/queries.json", {"X-PIO-Variant": "b"}),
                # unknown tenant: the replica's 404 message passes
                # through byte-identical, both route forms
                ("/nope/queries.json", None),
                ("/queries.json", {"X-PIO-Variant": "nope"}),
            ]
            statuses = set()
            for q in self.QUERIES:
                for path, headers in forms:
                    sd, direct = _post(
                        f"http://127.0.0.1:{mp}{path}", q, headers
                    )
                    sr, routed = _post(
                        f"http://127.0.0.1:{rp}{path}", q, headers
                    )
                    assert (sr, routed) == (sd, direct), (path, headers)
                    statuses.add(sd)
            assert statuses == {200, 404}
            # the stats surface status renders from
            with urllib.request.urlopen(
                f"http://127.0.0.1:{rp}/stats.json", timeout=10
            ) as r:
                doc = json.loads(r.read())
            assert doc["server"] == "router"
            assert doc["replicas"]["engine-0"]["state"] == "ready"
            assert doc["replicas"]["engine-0"]["requests"] > 0
            assert doc["routing"]["hedge_enabled"] is False
        finally:
            server.stop()
            multi.stop()
            storage.close()


_TORCHLESS_ROUTE = r"""
import sys
sys.modules["torch"] = None
sys.path.insert(0, sys.argv[1])
from predictionio_tpu_torch.cli import main
sys.exit(main.main(sys.argv[2:]))
"""


def test_route_verb_serves_without_torch(fake_pair):
    """``route`` is host code: with ``torch`` unimportable it binds,
    admits its replicas, forwards queries and answers /metrics and
    /stats.json, and SIGTERM stops it with exit 0."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        rp = s.getsockname()[1]
    specs = [f"{name}={host}:{port}"
             for name, host, port in (fake_pair["a"], fake_pair["b"])]
    proc = subprocess.Popen(
        [sys.executable, "-c", _TORCHLESS_ROUTE, REPO, "route", "--ip",
         "127.0.0.1", "--port", str(rp), "--no-hedge", "--probe-interval",
         "0.2", *[a for spec in specs for a in ("--replica", spec)]],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.time() + 60
        while True:
            try:
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{rp}/readyz", timeout=2
                ) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            assert proc.poll() is None, proc.stdout.read()
            assert time.time() < deadline, "the router never became ready"
            time.sleep(0.1)
        whos = set()
        for i in range(16):
            status, body = _post(f"http://127.0.0.1:{rp}/queries.json",
                                 {"user": f"u{i}"})
            assert status == 200
            doc = json.loads(body)
            assert doc["echo"] == {"user": f"u{i}"}
            whos.add(doc["who"])
        assert whos == {"a", "b"}  # the ring spread 16 keys over both
        with urllib.request.urlopen(f"http://127.0.0.1:{rp}/metrics",
                                    timeout=10) as r:
            assert b"pio_router_requests_total" in r.read()
        with urllib.request.urlopen(f"http://127.0.0.1:{rp}/stats.json",
                                    timeout=10) as r:
            stats = json.loads(r.read())
        assert sum(s["requests"] for s in stats["replicas"].values()) == 16
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
