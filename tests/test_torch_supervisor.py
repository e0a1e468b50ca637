"""The port's fleet supervisor (``predictionio_tpu_torch/server/
supervisor.py``) and daemon tooling (``cli/daemon.py``), on the CPU:
seeded restart backoff, flap -> broken + incident bundle, spawn fault
injection, kill -9 recovery of a real child, the SO_REUSEPORT
rolling-restart handoff's byte parity and the retrain cadence.

The port's copy of ``tests/test_supervisor.py``, with the cases that
hold the two packages to one another: the run dir's files (service
records, ``supervisor.json``) written by either package are read by the
other, both packages' status lines render one state file identically,
one seed gives both the same restart backoff, and the port's services
are the port's CLI."""

from __future__ import annotations

import http.client
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import zlib

import pytest

from predictionio_tpu.cli import daemon as jdaemon
from predictionio_tpu.server import supervisor as jsup_mod
from predictionio_tpu_torch import faults
from predictionio_tpu_torch.cli import daemon
from predictionio_tpu_torch.common.breaker import backoff_interval
from predictionio_tpu_torch.server import supervisor as sup_mod
from predictionio_tpu_torch.server.http import HTTPApp, Response, Router


@pytest.fixture(autouse=True)
def _run_dir(tmp_path, monkeypatch):
    """Isolate pid files / service records / supervisor.json / incident
    bundles per test."""
    monkeypatch.setenv("PIO_RUN_DIR", str(tmp_path / "run"))
    faults.clear()
    yield
    faults.clear()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _FakeProc:
    """Popen-shaped handle the unit tests crash on demand."""

    def __init__(self, pid: int):
        self.pid = pid
        self._rc: int | None = None

    def poll(self):
        return self._rc

    def wait(self, timeout=None):
        if self._rc is None:
            raise subprocess.TimeoutExpired("fake", timeout or 0)
        return self._rc

    def terminate(self):
        if self._rc is None:
            self._rc = -signal.SIGTERM

    def kill(self):
        if self._rc is None:
            self._rc = -signal.SIGKILL

    def die(self, rc: int):
        self._rc = rc


def _machine(
    *, seed=7, base=0.5, max_s=30.0, flap_max=100, flap_window_s=60.0,
    stable_s=30.0, retrain=None, mod=sup_mod,
):
    """A single-service supervisor (of ``mod``'s package) with injected
    clock/sleep/spawn/probe so the crash/backoff/flap state machine runs
    without processes."""
    clock = {"t": 0.0}
    procs: list[_FakeProc] = []

    def spawn():
        p = _FakeProc(1000 + len(procs))
        procs.append(p)
        return p

    def probe(_spec):
        p = procs[-1] if procs else None
        if p is not None and p.poll() is None:
            return {"pid": p.pid, "instance": f"boot-{len(procs)}"}
        return None

    sup = mod.Supervisor(
        [mod.ServiceSpec(name="engine", spawn=spawn)],
        poll_interval=0.01,
        base_backoff_s=base,
        max_backoff_s=max_s,
        jitter=0.2,
        flap_max=flap_max,
        flap_window_s=flap_window_s,
        stable_s=stable_s,
        health_fail_threshold=3,
        seed=seed,
        clock=lambda: clock["t"],
        sleep=lambda s: clock.__setitem__("t", clock["t"] + s),
        probe=probe,
        retrain=retrain,
    )
    return sup, clock, procs


def _crash_three_times(sup, clock, procs) -> list[float]:
    """Crash the one child three times, each restart waited out; the
    backoff drawn for each."""
    child = sup._children[0]
    observed = []
    for _ in range(3):
        procs[-1].die(1)
        sup.step()
        observed.append(child.last_backoff_s)
        clock["t"] = child.next_retry_at
        sup.step()
        sup.step()
    return observed


class TestBackoffStateMachine:
    def test_restart_backoff_is_seeded_and_exponential(self):
        sup, clock, procs = _machine(seed=7)
        sup.start_all(wait_healthy_s=5.0)
        child = sup._children[0]
        assert child.state == sup_mod.UP

        # the reference stream: same policy, same per-service seed
        rng = random.Random(7 ^ zlib.crc32(b"engine"))
        observed, expected = [], []
        for attempt in (1, 2, 3):
            procs[-1].die(1)
            sup.step()
            assert child.state == sup_mod.RESTARTING
            observed.append(child.last_backoff_s)
            expected.append(
                backoff_interval(
                    attempt, base_s=0.5, max_s=30.0, jitter=0.2, rng=rng
                )
            )
            # one tick early: must still be waiting out the backoff
            sup.step(now=child.next_retry_at - 0.01)
            assert child.state == sup_mod.RESTARTING
            clock["t"] = child.next_retry_at
            sup.step()
            assert child.state == sup_mod.STARTING
            sup.step()
            assert child.state == sup_mod.UP

        assert observed == pytest.approx(expected)
        assert child.restarts == 3
        # successive delays grow (the jitter is only +/-20%)
        assert observed[0] < observed[1] < observed[2]

    def test_backoff_resets_after_stability_window(self):
        sup, clock, procs = _machine(stable_s=5.0)
        sup.start_all(wait_healthy_s=5.0)
        child = sup._children[0]
        procs[-1].die(1)
        sup.step()
        clock["t"] = child.next_retry_at
        sup.step()
        sup.step()
        assert child.state == sup_mod.UP and child.attempt == 1
        clock["t"] += 5.1  # outlive the stability window
        sup.step()
        assert child.attempt == 0  # next crash backs off from ~base again

    def test_restart_metric_and_state_file(self):
        before = sup_mod.Supervisor._m_restarts("engine").value()
        sup, clock, procs = _machine()
        sup.start_all(wait_healthy_s=5.0)
        child = sup._children[0]
        procs[-1].die(-signal.SIGKILL)
        sup.step()
        assert child.last_exit == "signal 9 (SIGKILL)"
        clock["t"] = child.next_retry_at
        sup.step()
        sup.step()
        assert sup_mod.Supervisor._m_restarts("engine").value() == before + 1
        doc = json.loads(sup_mod.state_file().read_text())
        svc = doc["services"]["engine"]
        assert svc["state"] == "up" and svc["restarts"] == 1
        assert svc["last_exit"] == "signal 9 (SIGKILL)"
        # the gauge tracks the state code
        g = sup_mod.Supervisor._g_state("engine")
        assert g.value() == 0.0

    def test_unhealthy_but_alive_child_is_restarted(self):
        sup, clock, procs = _machine()
        sup.start_all(wait_healthy_s=5.0)
        child = sup._children[0]
        # hang the child: pid alive, probes dead
        alive = procs[-1]
        sup._probe_fn = lambda spec: None
        for _ in range(3):  # health_fail_threshold
            sup.step()
        assert child.state == sup_mod.RESTARTING
        assert "unhealthy" in child.last_exit
        assert alive.poll() is not None  # it was terminated, not leaked

    def test_same_seed_same_backoff_in_both_packages(self):
        """The port's supervisor draws the JAX package's restart backoff
        sequence from the same seed, crash for crash."""
        runs = []
        for mod in (sup_mod, jsup_mod):
            sup, clock, procs = _machine(seed=11, mod=mod)
            sup.start_all(wait_healthy_s=5.0)
            runs.append(_crash_three_times(sup, clock, procs))
            sup.stop()
        assert runs[0] == runs[1]
        assert len(set(runs[0])) == 3


class TestFlapDetection:
    def test_flap_declares_broken_and_fires_incident(self, monkeypatch):
        monkeypatch.setenv("PIO_INCIDENT_MIN_INTERVAL_S", "0")
        sup, clock, procs = _machine(flap_max=3, flap_window_s=60.0)
        sup.start_all(wait_healthy_s=5.0)
        child = sup._children[0]
        for _ in range(3):
            procs[-1].die(-signal.SIGKILL)
            sup.step()
            if child.state == sup_mod.RESTARTING:
                clock["t"] = child.next_retry_at
                sup.step()
                sup.step()
        assert child.state == sup_mod.BROKEN
        assert child.next_retry_at is None  # no further respawns
        # the flight recorder captured the flap
        from predictionio_tpu_torch.obs import incident as obs_incident

        names = [b["name"] for b in obs_incident.list_incidents()]
        assert any("supervisor-flap-engine" in n for n in names)
        doc = json.loads(sup_mod.state_file().read_text())
        assert doc["services"]["engine"]["state"] == "broken"

    def test_slow_crashes_outside_window_never_break(self):
        sup, clock, procs = _machine(flap_max=3, flap_window_s=10.0)
        sup.start_all(wait_healthy_s=5.0)
        child = sup._children[0]
        for _ in range(6):  # 2x the flap budget, but spread out
            procs[-1].die(1)
            sup.step()
            assert child.state == sup_mod.RESTARTING
            clock["t"] = child.next_retry_at
            sup.step()
            sup.step()
            assert child.state == sup_mod.UP
            clock["t"] += 11.0  # next crash lands outside the window
        assert child.restarts == 6


class TestSpawnFaultInjection:
    def test_spawn_fault_backs_off_then_recovers(self):
        sup, clock, procs = _machine()
        child = sup._children[0]
        with faults.injected("supervisor.spawn:nth=1") as plan:
            sup.start_all(wait_healthy_s=5.0)
            assert plan.fire_count("supervisor.spawn") == 1
            # first spawn raised -> scheduled with backoff, not crashed
            if child.state == sup_mod.RESTARTING:
                assert "spawn failed" in child.last_exit
                clock["t"] = child.next_retry_at
                sup.step()
                sup.step()
        assert child.state == sup_mod.UP
        assert child.restarts == 1
        assert len(procs) == 1  # exactly one real spawn happened


class TestStatusReporting:
    def test_read_state_reports_liveness(self):
        sup, clock, procs = _machine()
        sup.start_all(wait_healthy_s=5.0)
        doc = sup_mod.read_state()
        assert doc is not None
        assert doc["pid"] == os.getpid() and doc["live"] is True
        assert doc["services"]["engine"]["state"] == "up"

    def test_status_lines_render_supervised_services(self):
        from predictionio_tpu_torch.cli.main import _supervisor_lines

        sup, clock, procs = _machine()
        sup.start_all(wait_healthy_s=5.0)
        lines = _supervisor_lines()
        assert any(
            line.startswith("supervisor[engine]: up") for line in lines
        )

    def test_stop_reverses_and_marks_stopped(self):
        sup, clock, procs = _machine()
        sup.start_all(wait_healthy_s=5.0)
        sup.stop()
        child = sup._children[0]
        assert child.state == sup_mod.STOPPED
        assert procs[-1].poll() is not None
        doc = json.loads(sup_mod.state_file().read_text())
        assert doc["services"]["engine"]["state"] == "stopped"

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_state_file_read_by_the_other_package(self, writer):
        """supervisor.json, with restarts and a retrain block, is read the
        same by both packages' read_state."""
        mod = sup_mod if writer == "port" else jsup_mod
        rprocs: list[_FakeProc] = []

        def rspawn():
            p = _FakeProc(3000 + len(rprocs))
            rprocs.append(p)
            return p

        sup, clock, procs = _machine(mod=mod)
        sup.retrain = mod.RetrainScheduler(
            1.0, train_argv=["train"], spawn=rspawn,
            clock=lambda: clock["t"], fetch_stats=lambda: None,
            fetch_slo=lambda: None, post_reload=lambda: 1,
        )
        sup.start_all(wait_healthy_s=5.0)
        _crash_three_times(sup, clock, procs)
        clock["t"] += 1.5
        sup.step()
        rprocs[-1].die(0)
        sup.step()
        ours, theirs = sup_mod.read_state(), jsup_mod.read_state()
        assert ours == theirs
        assert ours["live"] is True
        assert ours["services"]["engine"]["restarts"] == 3
        assert ours["retrain"]["runs"] == 1
        assert ours["retrain"]["last_run"]["reloaded"] == 1

    @pytest.mark.parametrize("state", ["up", "restarting", "broken"])
    def test_both_packages_render_one_state_file_identically(self, state):
        from predictionio_tpu.cli.main import _supervisor_lines as jlines
        from predictionio_tpu_torch.cli.main import _supervisor_lines

        doc = {
            "pid": os.getpid(), "updated": time.time(),
            "services": {
                "eventserver": {"state": "up", "pid": 11, "port": 7070,
                                "instance": "a", "restarts": 0,
                                "last_exit": None, "last_backoff_s": None,
                                "next_retry_in_s": None},
                "engine": {"state": state, "pid": 12 if state == "up" else None,
                           "port": 8000, "instance": None, "restarts": 2,
                           "last_exit": "signal 9 (SIGKILL)",
                           "last_backoff_s": 1.1,
                           "next_retry_in_s": 0.7 if state == "restarting" else None},
            },
            "retrain": {"state": "idle", "interval_s": 20.0,
                        "base_interval_s": 20.0, "slo_driven": False,
                        "next_in_s": 3.5, "runs": 1, "skips": 0, "failures": 1,
                        "last_run": {"t": 1.0, "ok": False,
                                     "exit": "exit code 1", "wall_s": 2.0,
                                     "reloaded": 0}},
        }
        sup_mod.state_file().write_text(json.dumps(doc))
        ours = _supervisor_lines()
        assert ours == jlines()
        assert ours[1].startswith(f"supervisor[engine]: {state} (restarts 2")
        assert ours[-1].startswith("supervisor[retrain]: idle (every 20.0s")
        # a supervisor that is gone is said so, by both
        doc["pid"] = 2 ** 22 + 12345
        sup_mod.state_file().write_text(json.dumps(doc))
        ours = _supervisor_lines()
        assert ours == jlines()
        assert all(line.endswith("[supervisor not running]") for line in ours)


class TestServiceRecords:
    def test_record_roundtrip(self):
        daemon.write_service_record(
            "engine", ["deploy", "--port", "1234"], "127.0.0.1", 1234,
            instance="abc",
        )
        rec = daemon.read_service_record("engine")
        assert rec == {
            "name": "engine",
            "argv": ["deploy", "--port", "1234"],
            "host": "127.0.0.1",
            "port": 1234,
            "instance": "abc",
        }

    def test_rolling_restart_requires_a_record(self):
        with pytest.raises(RuntimeError):
            daemon.rolling_restart("engine")

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_records_and_pid_files_read_by_the_other_package(self, writer):
        """The run dir is the JAX package's, byte for byte: a record and
        a pid file that either package writes, the other reads, and
        ``known_services`` lists the same fleet."""
        w, r = (daemon, jdaemon) if writer == "port" else (jdaemon, daemon)
        w.write_service_record("engine", ["deploy", "--port", "8001"],
                               "127.0.0.1", 8001, instance="i1")
        w.write_service_record("eventserver", ["eventserver"], "127.0.0.1", 7071)
        w._pid_file("engine").write_text(str(os.getpid()))
        w._pid_file("eventserver").write_text(str(os.getpid()))
        assert r.read_service_record("engine") == w.read_service_record("engine")
        assert r._record_file("engine").read_bytes() == w._record_file("engine").read_bytes()
        assert r.read_pid("engine") == os.getpid()
        assert r.service_port("engine") == 8001
        assert r.known_services() == w.known_services() == ["eventserver", "engine"]
        assert r.run_dir() == w.run_dir()


class TestPortServices:
    """What the port's daemon tooling starts: its own CLI, sharing the
    fleet's prep-cache directory and the operator's kernel build
    directory."""

    def test_spawn_service_runs_the_port_cli(self, monkeypatch):
        seen = {}

        class Popen:
            def __init__(self, argv, **kw):
                seen["argv"], seen["env"] = argv, kw["env"]
                self.pid = 4242

        monkeypatch.delenv("PIO_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(daemon.subprocess, "Popen", Popen)
        proc = daemon.spawn_service("engine", ["deploy", "--port", "1"])
        assert proc.pid == 4242
        assert seen["argv"] == [sys.executable, "-m", "predictionio_tpu_torch.cli.main",
                                "deploy", "--port", "1"]
        assert daemon.CLI_MODULE == "predictionio_tpu_torch.cli.main"
        # no build directory is imposed: the children load the kernels
        # from the package's persistent _build/, as every port process does
        assert "PIO_COMPILATION_CACHE_DIR" not in seen["env"]
        assert not (daemon.run_dir() / "jit_cache").exists()
        assert seen["env"]["PIO_PREP_CACHE_DIR"] == os.environ["PIO_PREP_CACHE_DIR"]

    def test_an_explicit_build_dir_wins(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PIO_COMPILATION_CACHE_DIR", str(tmp_path / "builds"))
        assert daemon.service_env()["PIO_COMPILATION_CACHE_DIR"] == str(tmp_path / "builds")
        monkeypatch.setenv("PIO_COMPILATION_CACHE_DIR", "")
        assert daemon.service_env()["PIO_COMPILATION_CACHE_DIR"] == ""

    def test_kernel_builds_follow_the_build_dir(self, monkeypatch, tmp_path):
        """``kernels/_build.py`` reads PIO_COMPILATION_CACHE_DIR at each
        load (empty or unset: the package's ``_build/``), and a library
        already there is loaded, not rebuilt."""
        from predictionio_tpu_torch.kernels import _build

        monkeypatch.delenv("PIO_COMPILATION_CACHE_DIR", raising=False)
        assert _build.build_dir() == _build.BUILD_DIR
        monkeypatch.setenv("PIO_COMPILATION_CACHE_DIR", "")
        assert _build.build_dir() == _build.BUILD_DIR
        monkeypatch.setenv("PIO_COMPILATION_CACHE_DIR", str(tmp_path / "b"))
        assert _build.build_dir() == tmp_path / "b"

        monkeypatch.setattr(_build, "_libs", {})
        monkeypatch.setattr(_build, "_name_locks", {})
        monkeypatch.setattr(_build, "build_info", {})
        compiled, loaded = [], []

        def fake_compile(src, out):
            compiled.append(out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_bytes(b"")
            return {"seconds": 0.5, "log": "", "cached": False}

        monkeypatch.setattr(_build, "_compile", fake_compile)
        monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: loaded.append(path))
        _build.load("topk")
        assert [p.parent for p in compiled] == [tmp_path / "b"]
        # a second process (fresh _libs) on the same directory loads it
        monkeypatch.setattr(_build, "_libs", {})
        _build.load("topk")
        assert len(compiled) == 1 and _build.build_info["topk"]["cached"]
        assert loaded == [str(compiled[0])] * 2


_CHILD_SCRIPT = """
import sys
from predictionio_tpu_torch.server.http import HTTPApp, Response, Router

router = Router()
router.add(
    "GET", "/answer",
    lambda req: Response.json({"answer": 42, "payload": "x" * 256}),
)
HTTPApp(
    router, host="127.0.0.1", port=int(sys.argv[1]), reuse_port=True,
    name="chaos-child",
).start(background=False)
"""


@pytest.mark.chaos
class TestKillNineRecovery:
    def test_kill9_child_restarts_and_serves_same_bytes(self):
        port = _free_port()

        def spawn():
            return subprocess.Popen(
                [sys.executable, "-c", _CHILD_SCRIPT, str(port)],
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )

        sup = sup_mod.Supervisor(
            [sup_mod.ServiceSpec(name="engine", port=port, spawn=spawn)],
            poll_interval=0.05,
            base_backoff_s=0.1,
            max_backoff_s=1.0,
            flap_max=10,
            seed=3,
        )
        try:
            sup.start_all(wait_healthy_s=30.0)
            child = sup._children[0]
            assert child.state == sup_mod.UP

            def fetch() -> bytes:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
                try:
                    conn.request("GET", "/answer")
                    resp = conn.getresponse()
                    assert resp.status == 200
                    return resp.read()
                finally:
                    conn.close()

            baseline = fetch()
            first_boot = child.instance
            os.kill(child.pid, signal.SIGKILL)

            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                sup.step()
                if (
                    child.state == sup_mod.UP
                    and child.restarts == 1
                    and child.instance != first_boot
                ):
                    break
                time.sleep(0.05)
            assert child.state == sup_mod.UP and child.restarts == 1
            assert "signal 9" in child.last_exit
            # the respawned child serves byte-identical answers
            assert fetch() == baseline
        finally:
            sup.stop()


class TestRollingRestartByteParity:
    def test_handoff_under_keepalive_client_is_lossless(self):
        """Two HTTPApps overlap on one SO_REUSEPORT port; a keep-alive
        client keeps querying across the old instance's drain. Every
        response must be 200 with byte-identical bodies — the
        zero-downtime contract ``rolling-restart`` is built on."""

        def app_on(port: int) -> HTTPApp:
            router = Router()
            router.add(
                "GET", "/scores",
                lambda req: Response.json(
                    {"items": list(range(32)), "model": "m1"}
                ),
            )
            return HTTPApp(
                router, host="127.0.0.1", port=port, reuse_port=True,
                name="parity",
            )

        port = _free_port()
        old = app_on(port)
        old.start()
        new = None
        drainer = None
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            bodies = []
            for i in range(20):
                conn.request("GET", "/scores")
                resp = conn.getresponse()
                assert resp.status == 200
                bodies.append(resp.read())
                if i == 5:
                    # bring the replacement up on the SAME port, wait
                    # for its readiness, then drain the old instance
                    new = app_on(port)
                    new.start()
                    ready = daemon.wait_ready(
                        "127.0.0.1", port, timeout=10.0,
                        not_instance=old.instance_id,
                    )
                    assert ready is not None
                    assert ready["instance"] == new.instance_id
                    drainer = threading.Thread(
                        target=lambda: old.drain(timeout=10.0)
                    )
                    drainer.start()
                    time.sleep(0.05)  # let the old listener close
            assert all(b == bodies[0] for b in bodies)
            drainer.join(timeout=15)
            assert not drainer.is_alive()
            # the survivor is the new instance
            doc = daemon.probe_health("127.0.0.1", port)
            assert doc is not None and doc["instance"] == new.instance_id
            conn.close()
        finally:
            if drainer is None:
                old.stop()
            if new is not None:
                new.stop()


class TestRetrainScheduler:
    """The SLO-driven retrain cadence machine, run entirely on injected
    clock/spawn/fetch hooks: cadence + serialization, the
    watermark-unmoved skip, burn-halving down to the floor with decay
    back at ok, and failure accounting that never touches the
    supervised-children flap detector."""

    def _sched(self, interval=10.0, **kw):
        clock = {"t": 0.0}
        procs: list[_FakeProc] = []

        def spawn():
            p = _FakeProc(2000 + len(procs))
            procs.append(p)
            return p

        defaults = dict(
            train_argv=["train"],
            spawn=spawn,
            clock=lambda: clock["t"],
            fetch_stats=lambda: None,
            fetch_slo=lambda: None,
            post_reload=lambda: 1,
        )
        defaults.update(kw)
        return sup_mod.RetrainScheduler(interval, **defaults), clock, procs

    def test_cadence_fires_serializes_and_reloads(self):
        s, clock, procs = self._sched()
        s.tick()
        assert not procs, "fired before the first interval elapsed"
        clock["t"] = 10.1
        s.tick()
        assert len(procs) == 1
        clock["t"] = 25.0
        s.tick()  # child still running: serialized, nothing new spawns
        assert len(procs) == 1
        procs[0].die(0)
        s.tick()
        assert s.runs == 1 and s.failures == 0
        assert s.last_run["ok"] is True
        assert s.last_run["reloaded"] == 1
        clock["t"] = 36.0  # next cadence counts from the FINISH
        s.tick()
        assert len(procs) == 2

    def test_unmoved_watermark_skips_the_tick(self):
        wm = {"v": 100.0}
        s, clock, procs = self._sched(
            fetch_stats=lambda: {
                "realtime": {"events_folded": wm["v"], "events_behind": 0.0}
            }
        )
        clock["t"] = 10.1
        s.tick()
        procs[0].die(0)
        s.tick()
        assert s.runs == 1
        clock["t"] = 21.0
        s.tick()  # nothing new folded since the last successful run
        assert len(procs) == 1 and s.skips == 1
        assert s.last_run["skipped"] is True
        wm["v"] = 150.0
        clock["t"] = 32.0
        s.tick()
        assert len(procs) == 2 and s.skips == 1

    def test_slo_burn_halves_to_floor_then_decays_back(self):
        state = {"s": "burning"}
        s, clock, procs = self._sched(
            slo_driven=True, floor_s=1.0,
            fetch_slo=lambda: {
                "slos": [{"name": "serving.freshness", "state": state["s"]}]
            },
        )
        t = 0.0
        while s.interval_s > 1.0 and t < 120:
            t += 1.1
            clock["t"] = t
            if procs and procs[-1].poll() is None:
                procs[-1].die(0)
            s.tick()
        assert s.interval_s == 1.0, "burning SLO never reached the floor"
        assert s.runs >= 1, "burn never pulled a retrain forward"
        state["s"] = "ok"
        while s.interval_s < s.base_interval_s and t < 400:
            t += 1.1
            clock["t"] = t
            if procs and procs[-1].poll() is None:
                procs[-1].die(0)
            s.tick()
        assert s.interval_s == s.base_interval_s, "ok never decayed back"

    def test_spawn_failure_is_counted_not_raised(self):
        def bad_spawn():
            raise OSError("no such binary")

        s, clock, _procs = self._sched(spawn=bad_spawn)
        clock["t"] = 10.1
        s.tick()
        assert s.failures == 1
        assert s.last_run["ok"] is False
        assert "spawn failed" in s.last_run["exit"]
        # the cadence machine keeps going
        clock["t"] = 21.0
        s.tick()
        assert s.failures == 2

    def test_kill9_mid_solve_then_clean_retrain(self):
        """Chaos drill: kill -9 the scheduler's train child mid-solve;
        the exit is recorded as a failure (not a crash-loop) and the
        NEXT cadence tick retrains clean."""
        spawned: list[subprocess.Popen] = []

        def spawn():
            code = (
                "import time; time.sleep(60)" if not spawned
                else "raise SystemExit(0)"
            )
            p = subprocess.Popen([sys.executable, "-c", code])
            spawned.append(p)
            return p

        clock = {"t": 0.0}
        s = sup_mod.RetrainScheduler(
            5.0, train_argv=["train"], spawn=spawn,
            clock=lambda: clock["t"], fetch_stats=lambda: None,
            fetch_slo=lambda: None, post_reload=lambda: 1,
        )
        clock["t"] = 5.1
        s.tick()
        assert len(spawned) == 1
        os.kill(spawned[0].pid, signal.SIGKILL)
        spawned[0].wait(timeout=30)
        clock["t"] = 6.0
        s.tick()  # reap: a failure with the signal named, never a flap
        assert s.failures == 1 and s.runs == 0
        assert "SIGKILL" in s.last_run["exit"]
        clock["t"] = 11.2
        s.tick()  # next cadence: clean retrain
        assert len(spawned) == 2
        deadline = time.time() + 30
        while spawned[1].poll() is None and time.time() < deadline:
            time.sleep(0.02)
        s.tick()
        assert s.runs == 1 and s.last_run["ok"] is True

    def test_retrain_failures_never_feed_the_flap_detector(self):
        """A persistently failing retrain child must not break the
        supervised engine: the retrain child is not a supervised
        service, so the flap detector never sees its exits."""
        rprocs: list[_FakeProc] = []

        def rspawn():
            p = _FakeProc(3000 + len(rprocs))
            rprocs.append(p)
            return p

        clock_holder = {}
        s = sup_mod.RetrainScheduler(
            0.5, train_argv=["train"], spawn=rspawn,
            clock=lambda: clock_holder.get("c", {"t": 0.0})["t"],
            fetch_stats=lambda: None, fetch_slo=lambda: None,
            post_reload=lambda: 1,
        )
        sup, clock, procs = _machine(flap_max=3, flap_window_s=60.0,
                                     retrain=s)
        clock_holder["c"] = clock
        sup.start_all(wait_healthy_s=5.0)
        for _ in range(20):
            clock["t"] += 0.6
            if rprocs and rprocs[-1].poll() is None:
                rprocs[-1].die(1)  # every retrain crashes
            sup.step(clock["t"])
        assert s.failures >= 3
        doc = sup.state_doc()
        assert doc["retrain"]["failures"] == s.failures
        assert doc["services"]["engine"]["state"] == "up"
        assert doc["services"]["engine"]["restarts"] == 0
        # the engine child itself never died: one spawn total
        assert len(procs) == 1

    def test_batch_only_serving_never_skips(self):
        """An engine without the speed layer reports
        realtime: {"enabled": false} — no counters. That is UNKNOWN
        progress, not an unmoved watermark: the cadence must keep
        retraining instead of skipping forever after the first run."""
        s, clock, procs = self._sched(
            fetch_stats=lambda: {"realtime": {"enabled": False}}
        )
        clock["t"] = 10.1
        s.tick()
        procs[0].die(0)
        s.tick()
        assert s.runs == 1
        clock["t"] = 21.0
        s.tick()  # would skip forever if the watermark read as 0.0
        assert len(procs) == 2 and s.skips == 0

    def test_default_spawn_runs_the_port_train(self, monkeypatch):
        """With no injected spawn, a due tick starts the port's ``train``
        (``daemon.spawn_service``) with the scheduler's argv."""
        seen = []
        monkeypatch.setattr(
            sup_mod.daemon, "spawn_service",
            lambda name, argv: seen.append((name, argv)) or _FakeProc(9),
        )
        clock = {"t": 0.0}
        s = sup_mod.RetrainScheduler(
            1.0, train_argv=["train", "--warm-start", "--device", "cpu"],
            clock=lambda: clock["t"], fetch_stats=lambda: None,
            fetch_slo=lambda: None, post_reload=lambda: 0,
        )
        clock["t"] = 1.5
        s.tick()
        assert seen == [("retrain", ["train", "--warm-start", "--device", "cpu"])]
