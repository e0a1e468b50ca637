"""The port's fleet verbs through its CLI, on the CPU: ``start-all`` /
``stop-all`` of daemonized services (``tests/test_cli.py``
``TestStartStopAll``, on the event server alone), the plans that need a
later slice failing before anything is spawned, ``status --json``
against a live daemon (and the JAX package's ``status --json`` of the
same fleet), and ``supervise --retrain-every`` with a deployed engine
on a jsonl store that retrains once and reloads. Every child gets
``--device cpu``."""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from predictionio_tpu_torch.cli import daemon
from predictionio_tpu_torch.cli import main as cli

from tests.test_torch_filelog_stores import _backend_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET = ["--ip", "127.0.0.1", "--no-dashboard", "--no-adminserver"]


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


def port_closed(port: int, timeout: float = 15.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=0.5):
                time.sleep(0.3)
        except OSError:
            return True
    return False


def get_json(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return json.loads(r.read())


@pytest.fixture()
def cli_env(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_STORAGE_")}
    env["PIO_FS_BASEDIR"] = str(tmp_path / "store")
    env["PIO_RUN_DIR"] = str(tmp_path / "run")
    env["PYTHONPATH"] = REPO
    return env


class TestStartStopAll:
    def test_start_all_stop_all(self, cli_env, tmp_path):
        """One-shot fleet bring-up/teardown (reference bin/pio-start-all):
        the event server as a detached daemon with a pid file, then
        stop-all terminates it."""
        ev = free_port()
        out = pio(["start-all", *FLEET, "--event-port", str(ev)], cli_env,
                  timeout=120).stdout
        run = tmp_path / "run"
        try:
            assert "eventserver: up" in out
            assert (run / "eventserver.pid").exists()
            rec = json.loads((run / "eventserver.json").read_text())
            assert rec["argv"] == ["eventserver", "--ip", "127.0.0.1", "--port",
                                   str(ev), "--reuse-port"]
            assert rec["instance"]
            with urllib.request.urlopen(f"http://127.0.0.1:{ev}/", timeout=10) as resp:
                assert resp.status == 200
            # double start refuses and rolls back nothing extra
            proc = pio(["start-all", *FLEET, "--event-port", str(ev)], cli_env,
                       check=False)
            assert proc.returncode == 1
            assert "already running" in proc.stderr
        finally:
            out = pio(["stop-all"], cli_env, timeout=60).stdout
        assert "eventserver: stopped" in out
        assert not (run / "eventserver.pid").exists()
        assert not (run / "eventserver.json").exists()
        assert port_closed(ev), "event server port still open after stop-all"
        assert "Nothing to stop" in pio(["stop-all"], cli_env).stdout


class TestLaterSlicePlans:
    def test_default_plan_exits_1_naming_10c_before_spawning(self, cli_env, tmp_path):
        """The JAX default plan starts the dashboard and the admin
        server: on the port the command fails naming their slice, and
        nothing was started."""
        ev = free_port()
        proc = pio(["start-all", "--ip", "127.0.0.1", "--event-port", str(ev)],
                   cli_env, check=False)
        assert proc.returncode == 1
        assert "later slice" in proc.stderr and "10c" in proc.stderr
        run = tmp_path / "run"
        assert not list(run.glob("*.pid")) and not list(run.glob("*.log"))
        assert port_closed(ev, timeout=0.5)

    @pytest.mark.parametrize("argv,item", [
        (["supervise", "--no-adminserver"], "10c"),
        (["start-all", "--no-dashboard"], "10c"),
        (["start-all", *FLEET, "--replicas", "2", "--engine-factory", "m.engine"], "10d"),
        (["supervise", *FLEET, "--engine-factory", "m.engine"], "10d"),
        (["start-all", *FLEET, "--engine-dir", "."], "10d"),
    ])
    def test_plans_of_later_slices_raise_before_spawning(self, argv, item, monkeypatch,
                                                         tmp_path):
        monkeypatch.setenv("PIO_RUN_DIR", str(tmp_path / "run"))

        def spawned(*a, **kw):
            raise AssertionError("a service was spawned")

        monkeypatch.setattr(daemon, "spawn_service", spawned)
        with pytest.raises(NotImplementedError, match=f"later slice.*{item}"):
            cli.main(argv)

    def test_workers_still_raise(self, monkeypatch, tmp_path, capsys):
        """``--workers`` and ``--replicas`` are no longer later slices:
        ``deploy --workers 2`` without a port of its own is refused as the
        JAX package refuses it (exit 1, nothing spawned), and a
        ``supervise --replicas 2`` plan runs engine-0, engine-1 and the
        router under the supervisor."""
        monkeypatch.setenv("PIO_RUN_DIR", str(tmp_path / "run"))

        def spawned(*a, **kw):
            raise AssertionError("a service was spawned")

        monkeypatch.setattr(daemon, "spawn_service", spawned)
        monkeypatch.setattr(subprocess, "Popen", spawned)
        assert cli.main(["deploy", "--workers", "2", "--port", "0",
                         "--variant", "engine.json"]) == 1
        assert "--workers needs an explicit --port" in capsys.readouterr().err
        plans = []
        monkeypatch.setattr(cli, "_run_supervised",
                            lambda args, plan: plans.append(plan) or 0)
        assert cli.main(["supervise", *FLEET, "--replicas", "2", "--variant",
                         "engine.json", "--engine-port", "8500"]) == 0
        assert [(n, p) for n, _, p in plans[0]] == [
            ("eventserver", 7070), ("engine-0", 8500), ("engine-1", 8501),
            ("router", 8100)]


def test_status_json_of_a_live_daemon(cli_env, monkeypatch, capsys):
    """``status --json`` prints one compact line with the live event
    server's pid, port, metrics and SLOs, and the JAX package's
    ``status --json`` sees the same fleet in the same run dir."""
    from predictionio_tpu.cli import main as jcli

    ev = free_port()
    pio(["start-all", *FLEET, "--event-port", str(ev)], cli_env, timeout=120)
    try:
        out = pio(["status", "--json"], cli_env).stdout.strip().splitlines()
        assert len(out) == 1
        doc = json.loads(out[0])
        svc = doc["services"]["eventserver"]
        pid = int(open(os.path.join(cli_env["PIO_RUN_DIR"], "eventserver.pid")).read())
        assert svc["pid"] == pid and svc["port"] == ev
        assert any(k.startswith("pio_http_") for k in svc["metrics"])
        assert {s["name"] for s in svc["slo"]["slos"]} >= {"ingest.availability"}
        assert "supervisor" not in doc
        assert set(doc) >= {"services", "alerts", "incidents"}
        # the plain status: storage, then the daemons' SLO lines
        plain = pio(["status"], cli_env).stdout
        assert "slo[eventserver] ingest.availability: OK" in plain
        # the JAX package's verb reads the port's run dir
        monkeypatch.setenv("PIO_RUN_DIR", cli_env["PIO_RUN_DIR"])
        capsys.readouterr()
        assert jcli._status_json() == 0
        theirs = json.loads(capsys.readouterr().out)
        assert theirs["services"]["eventserver"]["pid"] == pid
        assert theirs["services"]["eventserver"]["port"] == ev
    finally:
        pio(["stop-all"], cli_env, timeout=60)
    assert port_closed(ev)


def _wait(what: str, cond, timeout: float = 120.0, proc=None, log=None):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = cond()
        if got:
            return got
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"{what}: the supervisor exited {proc.returncode}\n"
                                 + (log.read_text()[-3000:] if log else ""))
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {what}\n"
                         + (log.read_text()[-3000:] if log else ""))


def test_supervise_retrains_once_and_reloads(cli_env, tmp_path):
    """``supervise --retrain-every`` on a jsonl store: the event server
    and a deployed engine come up, the scheduled warm ``train`` (a
    prep-cache splice of the events appended since the cold train) runs
    and the engine reloads onto its instance; ``status`` renders it, the
    supervisor's ``/metrics`` counts it, and SIGTERM stops the fleet."""
    from predictionio_tpu_torch.data import storage as tstorage
    from predictionio_tpu_torch.data.event import Event

    env = {**cli_env, **_backend_env("jsonl", tmp_path)}
    env["PIO_PREP_CACHE_DIR"] = str(tmp_path / "prep")
    env["PIO_SUPERVISE_POLL_S"] = "0.2"
    storage = tstorage.Storage(env=env)
    try:
        app_id = storage.get_metadata_apps().insert(tstorage.App(0, "Fleet"))
        events = storage.get_events()
        events.init(app_id)

        def rate(users, items, seed):
            import numpy as np

            rng = np.random.default_rng(seed)
            events.batch_insert([
                Event(event="rate", entity_type="user", entity_id=f"u{u}",
                      target_entity_type="item", target_entity_id=f"i{int(i)}",
                      properties={"rating": float(rng.integers(1, 6))})
                for u in users for i in rng.choice(30, 8, replace=False)], app_id)

        rate(range(40), 30, seed=1)
    finally:
        storage.close()
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps({
        "id": "fleet", "engineFactory": "predictionio_tpu_torch.models.recommendation.engine",
        "datasource": {"params": {"appName": "Fleet"}},
        "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 3,
                                                   "lambda": 0.05, "seed": 1}}],
    }))
    out = pio(["train", "--variant", str(variant), "--device", "cpu"], env).stdout
    first = out.split("Engine instance ID:")[1].strip()
    storage = tstorage.Storage(env=env)
    try:
        events = storage.get_events()
        rate(range(35, 50), 30, seed=2)  # known and new users
    finally:
        storage.close()

    ev, eng, sp = free_port(), free_port(), free_port()
    run = tmp_path / "run"
    log = tmp_path / "supervise.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "supervise",
             *FLEET, "--event-port", str(ev), "--engine-port", str(eng),
             "--supervise-port", str(sp), "--variant", str(variant),
             "--device", "cpu", "--retrain-every", "3s", "--retrain-tol", "1e-4"],
            cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT)
    try:
        def state():
            try:
                return json.loads((run / "supervisor.json").read_text())
            except (OSError, ValueError):
                return None

        _wait("the fleet up", lambda: (s := state()) and all(
            s["services"][n]["state"] == "up" for n in ("eventserver", "engine")),
            proc=proc, log=log)
        # a retrain that finished while the engine answered reloads it
        # (one that the cadence started during the bring-up may not)
        rt = _wait("a retrain and its reload", lambda: (s := state())
                   and s["retrain"]["runs"] >= 1
                   and s["retrain"]["last_run"]["reloaded"] == 1 and s["retrain"],
                   proc=proc, log=log)
        assert rt["failures"] == 0
        assert rt["last_run"]["ok"] is True and rt["last_run"]["exit"] == "exit code 0"
        progress = json.loads((run / "train_progress.json").read_text())
        assert progress["warm_start"] is True
        assert progress["k1_launches"] == 0  # the CPU runs K1's plain version
        # the first scheduled train spliced the events appended since the
        # cold train into the prep-cache entry that train published
        reads = [line.rsplit("(prep cache: ", 1)[1].rstrip(")")
                 for line in (run / "retrain.log").read_text().splitlines()
                 if "(prep cache: " in line]
        assert reads[0] == "splice", reads
        # the engine serves a completed instance that a retrain wrote
        served = get_json(eng, "/")["engineInstanceId"]
        assert served != first
        storage = tstorage.Storage(env=env)
        try:
            inst = storage.get_metadata_engine_instances().get(served)
        finally:
            storage.close()
        assert inst.status == "COMPLETED" and inst.engine_id == "fleet"
        req = urllib.request.Request(
            f"http://127.0.0.1:{eng}/queries.json",
            data=json.dumps({"user": "u45", "num": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert len(json.loads(r.read())["itemScores"]) == 3
        text = pio(["status"], env).stdout
        assert "supervisor[eventserver]: up (restarts 0" in text
        assert "supervisor[engine]: up (restarts 0" in text
        assert "supervisor[retrain]:" in text and "last ok" in text
        with urllib.request.urlopen(f"http://127.0.0.1:{sp}/metrics", timeout=10) as r:
            metrics = r.read().decode()
        assert "pio_retrain_runs_total" in metrics
        assert 'pio_supervisor_state{service="engine"} 0' in metrics
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    doc = json.loads((run / "supervisor.json").read_text())
    assert {s["state"] for s in doc["services"].values()} == {"stopped"}
    assert not list(run.glob("*.pid"))
    assert port_closed(ev) and port_closed(eng)
    stopped = [line for line in log.read_text().splitlines() if "-> stopped" in line]
    assert [("engine" in line, "eventserver" in line) for line in stopped] == [
        (True, False), (False, True)], "the fleet did not stop in reverse order"
