"""Worker processes and replica sets on the port, on the CPU.

``eventserver --workers N`` and ``deploy --workers N``
(``cli/main.py _run_workers``, held to ``tests/test_servers.py
TestWorkerProcesses``): N fresh interpreters of the port's CLI sharing
one port, nothing lost or duplicated on ingest, every answer of a worker
set byte-identical to one process's, the parent without torch, and a
dead worker ending the set with a nonzero exit. With ``subprocess.Popen``
replaced: every spelling of ``--workers`` stripped and ``--reuse-port``
added, the children running ``predictionio_tpu_torch.cli.main``, SIGTERM
forwarded. The ``start-all`` / ``supervise --replicas N`` plans equal the
JAX package's (names, ports, the router's ``--replica`` arguments, the
spawned command with the module name mapped), ``status``'s replica lines
equal the JAX verb's on one live router, a daemonized replica set
(``start-all --replicas 2 --device cpu``) serves through its router,
survives a kill -9 of a replica and stops, and a supervised one
(``supervise --replicas 2``) restarts a killed replica, which the router
admits, with no failed query through the router."""

from __future__ import annotations

import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu_torch.cli import daemon
from predictionio_tpu_torch.cli import main as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET = ["--ip", "127.0.0.1", "--no-dashboard", "--no-adminserver"]
CLI = [sys.executable, "-m", "predictionio_tpu_torch.cli.main"]


def listen_ports(n: int) -> list:
    """``n`` consecutive free ports below the kernel's ephemeral range, so
    that no client connection's local end takes one before its server
    binds (the second replica binds after the first one's boot)."""
    import random

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768

    def free(port):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
                return True
            except OSError:
                return False

    for _ in range(1000):
        start = random.randrange(10_000, low - n)
        if all(free(start + i) for i in range(n)):
            return list(range(start, start + n))
    raise RuntimeError(f"no {n} consecutive free ports below {low}")


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


def post_raw(port: int, body: dict, path: str = "/queries.json") -> tuple[int, bytes]:
    """One POST on a fresh connection: (status, raw bytes)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def wait_until(what: str, cond, timeout: float = 120.0, proc=None):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            got = cond()
        except OSError:
            got = None
        if got:
            return got
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"{what}: the process exited {proc.returncode}")
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def worker_pids(port: int, n: int, proc=None) -> set:
    """Fresh connections to ``/healthz`` until ``n`` distinct pids
    answered: the kernel spreads new connections over the port's
    SO_REUSEPORT sockets."""
    pids: set = set()

    def seen():
        pids.add(get_json(port, "/healthz")["pid"])
        return len(pids) >= n

    wait_until(f"{n} workers answering", seen, proc=proc)
    return pids


def per_worker_metrics(port: int, pids: set) -> dict:
    """{pid: parsed /metrics} of every worker: ``/healthz`` then
    ``/metrics`` on one keep-alive connection reach the same worker."""
    import http.client

    from predictionio_tpu_torch.obs.metrics import parse_prometheus

    out: dict = {}

    def read_one():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            conn.request("GET", "/healthz")
            pid = json.loads(conn.getresponse().read())["pid"]
            conn.request("GET", "/metrics")
            out[pid] = parse_prometheus(conn.getresponse().read())
        finally:
            conn.close()
        return set(out) >= pids

    wait_until("every worker's /metrics", read_one)
    return out


def torch_mapped(pid: int) -> bool:
    """Whether process ``pid`` has loaded torch's shared libraries."""
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


@contextlib.contextmanager
def port_store(basedir):
    """The port's storage singleton on a sqlite + localfs store under
    ``basedir`` (what the CLI children read through PIO_FS_BASEDIR)."""
    from predictionio_tpu_torch.data import storage as tstorage

    saved = {k: v for k, v in os.environ.items()
             if k.startswith("PIO_STORAGE_") or k == "PIO_FS_BASEDIR"}
    for k in saved:
        del os.environ[k]
    os.environ["PIO_FS_BASEDIR"] = str(basedir)
    tstorage.set_storage(None)
    try:
        yield tstorage.get_storage()
    finally:
        tstorage.get_storage().close()
        tstorage.set_storage(None)
        os.environ.pop("PIO_FS_BASEDIR", None)
        os.environ.update(saved)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A recommendation instance trained on the CPU by the port's
    ``train``, and the environment its children read it with."""
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import App

    base = tmp_path_factory.mktemp("workers")
    variant = base / "engine.json"
    variant.write_text(json.dumps({
        "id": "workers", "engineFactory":
            "predictionio_tpu_torch.models.recommendation.engine",
        "datasource": {"params": {"appName": "Workers"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 4, "numIterations": 3, "lambda": 0.05, "seed": 1}}],
    }))
    with port_store(base / "store") as storage:
        app_id = storage.get_metadata_apps().insert(App(0, "Workers"))
        events = storage.get_events()
        events.init(app_id)
        rng = np.random.default_rng(5)
        events.batch_insert([
            Event(event="rate", entity_type="user", entity_id=f"u{u}",
                  target_entity_type="item", target_entity_id=f"i{int(i)}",
                  properties={"rating": float(rng.integers(1, 6))})
            for u in range(30) for i in rng.choice(20, 6, replace=False)], app_id)
        assert cli.main(["train", "--variant", str(variant), "--device", "cpu"]) == 0
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_STORAGE_")}
    env.update(PIO_FS_BASEDIR=str(base / "store"), PIO_RUN_DIR=str(base / "run"),
               PYTHONPATH=REPO)
    return {"variant": str(variant), "env": env, "base": base}


# -- the worker set through real processes ------------------------------------


class TestWorkerProcesses:
    def test_eventserver_workers_share_port_without_loss(self, tmp_path):
        """``eventserver --workers 2`` on a jsonl store: two processes
        bind the same port via SO_REUSEPORT; ingest across them loses
        nothing and duplicates nothing (storage appends are
        cross-process locked)."""
        from predictionio_tpu_torch.cli import commands
        from predictionio_tpu_torch.data.storage import Storage

        env = dict(
            os.environ,
            PIO_STORAGE_SOURCES_DB_TYPE="sqlite",
            PIO_STORAGE_SOURCES_DB_PATH=str(tmp_path / "pio.db"),
            PIO_STORAGE_SOURCES_LOG_TYPE="jsonl",
            PIO_STORAGE_SOURCES_LOG_PATH=str(tmp_path / "ev"),
            PIO_STORAGE_REPOSITORIES_METADATA_SOURCE="DB",
            PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE="LOG",
            PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE="DB",
            PYTHONPATH=REPO,
        )
        storage = Storage(env=env)
        try:
            info = commands.app_new("WorkerApp", storage=storage)
            port, = listen_ports(1)
            sup = subprocess.Popen(
                [*CLI, "eventserver", "--ip", "127.0.0.1", "--port", str(port),
                 "--workers", "2"], env=env, cwd=REPO)
            try:
                pids = worker_pids(port, 2, proc=sup)
                assert sup.pid not in pids
                key = info["access_key"]
                event = {"event": "rate", "entityType": "user",
                         "targetEntityType": "item", "targetEntityId": "i1",
                         "properties": {"rating": 4}}
                for i in range(60):
                    status, _ = post_raw(port, dict(event, entityId=f"u{i}"),
                                         f"/events.json?accessKey={key}")
                    assert status == 201
            finally:
                sup.terminate()
                assert sup.wait(timeout=30) == 0
            events = storage.get_events().find(info["id"], limit=None)
            assert len(events) == 60
            assert len({e.event_id for e in events}) == 60
            assert sorted(e.entity_id for e in events) == sorted(
                f"u{i}" for i in range(60))
        finally:
            storage.close()

    def test_deploy_workers_answer_as_one_process(self, trained):
        """``deploy --workers 2 --device cpu``: two worker pids behind one
        port, neither the parent's, and the parent holds no torch; every
        answer, over fresh connections that land on either worker, is
        byte-identical to a single-process deploy of the same instance.
        A kill -9 of one worker ends the set: the parent exits nonzero and
        stops the other."""
        env = trained["env"]
        base = ["deploy", "--variant", trained["variant"], "--ip", "127.0.0.1",
                "--device", "cpu"]
        one_port, set_port = listen_ports(2)
        one = subprocess.Popen([*CLI, *base, "--port", str(one_port)], env=env, cwd=REPO)
        parent = subprocess.Popen([*CLI, *base, "--port", str(set_port), "--workers", "2"],
                                  env=env, cwd=REPO)
        try:
            pids = worker_pids(set_port, 2, proc=parent)
            assert parent.pid not in pids
            assert not torch_mapped(parent.pid)
            assert all(torch_mapped(p) for p in pids)
            wait_until("the single deploy", lambda: get_json(one_port, "/readyz"),
                       proc=one)
            for u in range(30):
                q = {"user": f"u{u}", "num": 4}
                single = post_raw(one_port, q)
                assert single[0] == 200
                assert post_raw(set_port, q) == single
            served = {pid: int(m.get("pio_serving_seconds_count", 0))
                      for pid, m in per_worker_metrics(set_port, pids).items()}
            assert sum(served.values()) == 30 and min(served.values()) > 0, served
            os.kill(min(pids), signal.SIGKILL)
            rc = parent.wait(timeout=30)
            assert rc != 0
            survivor = max(pids)
            wait_until("the other worker gone",
                       lambda: not os.path.exists(f"/proc/{survivor}")
                       or open(f"/proc/{survivor}/stat").read().split()[2] == "Z",
                       timeout=30)
            assert port_closed(set_port)
        finally:
            for proc in (one, parent):
                if proc.poll() is None:
                    proc.terminate()
                    proc.wait(timeout=30)


# -- the worker set's parent with Popen replaced --------------------------------


class FakeWorker:
    """A Popen stand-in: records its command and signals; ``poll`` gives
    ``exits`` in turn (None while running), then the last one."""

    def __init__(self, cmd, exits, on_poll=None):
        self.cmd = cmd
        self.exits = list(exits)
        self.on_poll = on_poll
        self.signals: list[int] = []
        self.terminated = self.waited = False

    def poll(self):
        if self.on_poll is not None:
            self.on_poll(self)
        return self.exits.pop(0) if len(self.exits) > 1 else self.exits[0]

    def send_signal(self, signum):
        self.signals.append(signum)

    def terminate(self):
        self.terminated = True

    def wait(self, timeout=None):
        self.waited = True
        return 0

    def kill(self):
        pass


@pytest.fixture()
def fake_spawn(monkeypatch):
    """Replace ``subprocess.Popen``, the signal handlers and the poll
    sleep of ``_run_workers``; returns the spawned fakes and the handlers
    it installed."""
    state = {"workers": [], "handlers": {}, "exits": lambda i: [0]}

    def popen(cmd, *a, **kw):
        w = FakeWorker(cmd, state["exits"](len(state["workers"])), state.get("on_poll"))
        state["workers"].append(w)
        return w

    monkeypatch.setattr(subprocess, "Popen", popen)
    monkeypatch.setattr(signal, "signal",
                        lambda signum, fn: state["handlers"].__setitem__(signum, fn))
    monkeypatch.setattr(cli.time, "sleep", lambda s: None)
    return state


class TestWorkerParent:
    @pytest.mark.parametrize("spelling", [
        ["--workers", "3"], ["--workers=3"], ["--work", "3"], ["--w=3"],
        ["--worker", "3"],
    ])
    def test_every_spelling_is_stripped_and_reuse_port_added(self, fake_spawn, spelling):
        argv = ["deploy", "--variant", "engine.json", *spelling, "--port", "8123",
                "--device", "cpu"]
        assert cli.main(argv) == 0
        cmds = [w.cmd for w in fake_spawn["workers"]]
        assert len(cmds) == 3
        want = [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "deploy",
                "--variant", "engine.json", "--port", "8123", "--device", "cpu",
                "--reuse-port"]
        assert cmds == [want] * 3

    def test_children_run_the_ports_cli_and_keep_reuse_port_once(self, fake_spawn):
        assert cli.main(["eventserver", "--reuse-port", "--port", "7071",
                         "--workers", "2", "--stats"]) == 0
        for w in fake_spawn["workers"]:
            assert w.cmd[:3] == [sys.executable, "-m", daemon.CLI_MODULE]
            assert daemon.CLI_MODULE == "predictionio_tpu_torch.cli.main"
            assert w.cmd[3:] == ["eventserver", "--reuse-port", "--port", "7071",
                                 "--stats"]

    def test_sigterm_and_sigint_are_forwarded(self, fake_spawn):
        """The forwarders are installed before the spawn; a SIGTERM that
        arrives while the set runs reaches every worker, whose clean exits
        end the parent with 0."""
        got = {"delivered": False}

        def deliver(worker):
            if not got["delivered"] and len(fake_spawn["workers"]) == 2:
                got["delivered"] = True
                fake_spawn["handlers"][signal.SIGTERM](signal.SIGTERM, None)

        fake_spawn["on_poll"] = deliver
        fake_spawn["exits"] = lambda i: [None, -signal.SIGTERM]
        assert cli.main(["deploy", "--port", "8124", "--workers", "2"]) == 0
        assert set(fake_spawn["handlers"]) == {signal.SIGTERM, signal.SIGINT}
        assert [w.signals for w in fake_spawn["workers"]] == [[signal.SIGTERM]] * 2
        assert fake_spawn["handlers"][signal.SIGINT] is fake_spawn["handlers"][signal.SIGTERM]

    def test_a_dead_worker_exits_nonzero_and_stops_the_rest(self, fake_spawn):
        fake_spawn["exits"] = lambda i: [None, -signal.SIGKILL] if i == 1 else [None]
        rc = cli.main(["eventserver", "--port", "7072", "--workers", "3"])
        assert rc == -signal.SIGKILL
        alive = [w for i, w in enumerate(fake_spawn["workers"]) if i != 1]
        assert all(w.terminated and w.waited for w in alive)
        assert not fake_spawn["workers"][1].terminated

    def test_a_worker_that_fails_cleanly_still_fails_the_set(self, fake_spawn):
        fake_spawn["exits"] = lambda i: [3] if i == 0 else [None]
        assert cli.main(["deploy", "--port", "8125", "--workers", "2"]) == 3

    def test_port_zero_is_refused_and_one_worker_is_one_process(self, fake_spawn,
                                                               monkeypatch, capsys):
        assert cli.main(["deploy", "--port", "0", "--workers", "2"]) == 1
        assert "--workers needs an explicit --port" in capsys.readouterr().err
        assert not fake_spawn["workers"]
        built = []

        def no_server(args):
            built.append(args.workers)
            raise LookupError("no instance")

        monkeypatch.setattr(cli, "deploy_server", no_server)
        assert cli.main(["deploy", "--port", "8126", "--workers", "1"]) == 1
        assert built == [1] and not fake_spawn["workers"]


# -- the replica-set plans, against the JAX package's ----------------------------


@pytest.fixture()
def both_plans(monkeypatch, tmp_path):
    """``start_service`` and ``_run_supervised`` of both packages replaced
    by recorders: what each CLI would start, in order."""
    from predictionio_tpu.cli import daemon as jdaemon
    from predictionio_tpu.cli import main as jcli

    monkeypatch.setenv("PIO_RUN_DIR", str(tmp_path / "run"))
    plans = {"port": [], "jax": []}
    for key, mod, dmod in (("port", cli, daemon), ("jax", jcli, jdaemon)):
        def start(name, argv, host, port, _k=key):
            plans[_k].append((name, list(argv), host, port))
            return 4242

        def supervised(args, plan, _k=key):
            plans[_k].extend((n, list(a), "supervised", p) for n, a, p in plan)
            return 0

        monkeypatch.setattr(dmod, "start_service", start)
        monkeypatch.setattr(mod, "_run_supervised", supervised)
    return plans


class TestReplicaPlans:
    @pytest.mark.parametrize("verb", ["start-all", "supervise"])
    def test_replicas_plan_equals_the_jax_packages(self, both_plans, verb, tmp_path):
        from predictionio_tpu.cli import main as jcli

        variant = str(tmp_path / "engine.json")
        argv = [verb, *FLEET, "--event-port", "7170", "--engine-port", "8200",
                "--router-port", "8300", "--replicas", "3", "--variant", variant]
        assert cli.main(argv) == 0
        assert jcli.main(argv) == 0
        assert both_plans["port"] == both_plans["jax"]
        plan = both_plans["port"]
        assert [(n, p) for n, _, _, p in plan] == [
            ("eventserver", 7170), ("engine-0", 8200), ("engine-1", 8201),
            ("engine-2", 8202), ("router", 8300)]
        router_argv = plan[-1][1]
        assert router_argv == [
            "route", "--ip", "127.0.0.1", "--port", "8300", "--reuse-port",
            "--replica", "engine-0=127.0.0.1:8200",
            "--replica", "engine-1=127.0.0.1:8201",
            "--replica", "engine-2=127.0.0.1:8202"]
        for i in range(3):
            assert plan[1 + i][1] == ["deploy", "--ip", "127.0.0.1", "--reuse-port",
                                      "--variant", variant, "--port", str(8200 + i)]

    def test_default_router_port_and_device_flag(self, both_plans, tmp_path):
        """``--router-port`` defaults to 8100, as in the JAX package;
        ``--device`` reaches every replica's deploy."""
        variant = str(tmp_path / "engine.json")
        assert cli.main(["start-all", *FLEET, "--replicas", "2", "--variant", variant,
                         "--device", "cpu"]) == 0
        names = {n: (a, p) for n, a, _, p in both_plans["port"]}
        assert names["router"][1] == 8100
        assert "--port" in names["router"][0] and "8100" in names["router"][0]
        for i in range(2):
            argv, port = names[f"engine-{i}"]
            assert port == 8000 + i
            assert argv[argv.index("--device") + 1] == "cpu"

    def test_replicas_without_a_variant_plan_no_engine(self, both_plans):
        from predictionio_tpu.cli import main as jcli

        argv = ["start-all", *FLEET, "--replicas", "2", "--event-port", "7171"]
        assert cli.main(argv) == 0 and jcli.main(argv) == 0
        assert both_plans["port"] == both_plans["jax"]
        assert [n for n, *_ in both_plans["port"]] == ["eventserver"]

    def test_retrain_reloads_every_replica(self, tmp_path):
        """The scheduled retrain ``/reload``s every ``engine-<i>`` of a
        replica set, as the JAX supervisor's does."""
        from predictionio_tpu.cli import main as jcli

        variant = str(tmp_path / "engine.json")
        argv = ["supervise", *FLEET, "--replicas", "3", "--engine-port", "8400",
                "--variant", variant, "--retrain-every", "60s"]
        ours = cli.build_parser().parse_args(argv)
        theirs = jcli.build_parser().parse_args(argv)
        plan = [("engine-0", [], 8400), ("engine-1", [], 8401), ("engine-2", [], 8402),
                ("router", [], 8100)]
        sched = cli._retrain_scheduler(ours, plan, "127.0.0.1")
        jsched = jcli._retrain_scheduler(theirs, plan, "127.0.0.1")
        assert list(sched.engine_ports) == list(jsched.engine_ports) == [8400, 8401, 8402]

    def test_spawned_command_maps_the_module(self, monkeypatch, tmp_path):
        """What ``spawn_service`` runs for a replica-set member: the JAX
        package's command line with its CLI module replaced by the
        port's."""
        from predictionio_tpu.cli import daemon as jdaemon

        monkeypatch.setenv("PIO_RUN_DIR", str(tmp_path / "run"))
        cmds = []
        monkeypatch.setattr(subprocess, "Popen",
                            lambda cmd, **kw: cmds.append(cmd) or FakeWorker(cmd, [None]))
        argv = ["route", "--ip", "127.0.0.1", "--port", "8100", "--reuse-port",
                "--replica", "engine-0=127.0.0.1:8000"]
        daemon.spawn_service("router", argv)
        jdaemon.spawn_service("router", argv)
        ours, theirs = cmds
        assert ours == [m.replace("predictionio_tpu.cli.main",
                                  "predictionio_tpu_torch.cli.main") for m in theirs]
        assert ours[:3] == [sys.executable, "-m", "predictionio_tpu_torch.cli.main"]


# -- status of a live router ------------------------------------------------------


def test_status_replica_lines_equal_the_jax_verbs(monkeypatch, tmp_path, capsys):
    """A live router recorded in the run dir: the port's ``status``
    replica lines equal the JAX verb's, an ejected replica leads with its
    state upper-cased, and ``status --json`` carries the router's
    ``/stats.json`` with its ``replicas`` block."""
    from predictionio_tpu.cli import main as jcli
    from predictionio_tpu_torch.server.http import HTTPApp, Response, Router
    from predictionio_tpu_torch.server.router import RouterServer

    monkeypatch.setenv("PIO_RUN_DIR", str(tmp_path / "run"))
    engines = []
    for tag in ("a", "b"):
        r = Router()
        r.add("POST", "/queries.json", lambda req, t=tag: Response.json({"who": t}))
        app = HTTPApp(r, host="127.0.0.1", port=0, name=f"fake-{tag}")
        engines.append((app, app.start(background=True)))
    server = RouterServer([(f"engine-{i}", "127.0.0.1", p)
                           for i, (_, p) in enumerate(engines)],
                          host="127.0.0.1", port=0, probe_interval_s=60.0, hedge=False)
    rp = server.start(background=True)
    # the routing counters are the process's metrics: count from here
    routed0 = server.stats()["routing"]["requests"]
    try:
        daemon._pid_file("router").write_text(str(os.getpid()))
        daemon.write_service_record("router", ["route"], "127.0.0.1", rp,
                                    instance=server.app.instance_id)
        for i in range(12):
            assert post_raw(rp, {"user": f"u{i}"})[0] == 200
        lines = cli._replica_lines()
        assert lines == jcli._replica_lines()
        assert len(lines) == 2
        assert lines[0].startswith("replica[router/engine-0]: ready, 0 inflight, p99 ")
        assert sum(int(ln.rsplit(", ", 1)[1].split()[0]) for ln in lines) == 12
        # a dead replica: the retry answers, the member is ejected
        engines[1][0].stop()
        for i in range(12):
            assert post_raw(rp, {"user": f"v{i}"})[0] == 200
        lines = cli._replica_lines()
        assert lines == jcli._replica_lines()
        assert lines[1].startswith("replica[router/engine-1]: EJECTED, ")
        assert lines[1].endswith("1 ejections")
        capsys.readouterr()
        assert cli._status_json() == 0
        doc = json.loads(capsys.readouterr().out)
        stats = doc["services"]["router"]["stats"]
        assert stats["server"] == "router"
        assert set(stats["replicas"]) == {"engine-0", "engine-1"}
        assert stats["replicas"]["engine-1"]["state"] == "ejected"
        assert stats["routing"]["requests"] - routed0 == 24
        assert any(k.startswith("pio_router_") for k in doc["services"]["router"]["metrics"])
    finally:
        daemon._pid_file("router").unlink(missing_ok=True)
        server.stop()
        engines[0][0].stop()


# -- a daemonized replica set on the CPU -------------------------------------------


def test_start_all_replicas_serves_through_the_router(trained, tmp_path):
    """``start-all --replicas 2 --device cpu``: the event server, two
    engine replicas on consecutive ports and the router come up as
    daemons; routed answers are byte-identical to a replica's, both
    replicas take queries and a repeated query stays on its replica;
    ``status`` and ``status --json`` show the replica set; a kill -9 of a
    replica costs the client nothing; ``stop-all`` stops them all."""
    env = dict(trained["env"], PIO_RUN_DIR=str(tmp_path / "run"),
               PIO_ROUTER_HEDGE="0")
    ev, eng, _, rp = listen_ports(4)  # the replicas on eng and eng + 1

    def pio(*args, timeout=180):
        proc = subprocess.run([*CLI, *args], env=env, cwd=REPO, capture_output=True,
                              text=True, timeout=timeout)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return proc.stdout

    out = pio("start-all", *FLEET, "--event-port", str(ev), "--engine-port", str(eng),
              "--router-port", str(rp), "--replicas", "2", "--variant",
              trained["variant"], "--device", "cpu")
    try:
        for name in ("eventserver", "engine-0", "engine-1", "router"):
            assert f"{name}: up on port" in out
        wait_until("both replicas admitted", lambda: all(
            r["state"] == "ready" for r in get_json(rp, "/stats.json")["replicas"].values()))
        queries = [{"user": f"u{u}", "num": 3} for u in range(20)]
        for q in queries:
            direct = post_raw(eng, q)
            assert direct[0] == 200
            assert post_raw(rp, q) == direct
        reps = get_json(rp, "/stats.json")["replicas"]
        assert set(reps) == {"engine-0", "engine-1"}
        assert all(r["requests"] > 0 for r in reps.values())
        before = {n: r["requests"] for n, r in reps.items()}
        for _ in range(5):
            assert post_raw(rp, queries[0])[0] == 200
        moved = {n: r["requests"] - before[n]
                 for n, r in get_json(rp, "/stats.json")["replicas"].items()}
        assert sorted(moved.values()) == [0, 5]  # affinity: one replica took all
        text = pio("status")
        assert "replica[router/engine-0]: ready" in text
        assert "replica[router/engine-1]: ready" in text
        doc = json.loads(pio("status", "--json").strip().splitlines()[-1])
        assert set(doc["services"]) == {"eventserver", "engine-0", "engine-1", "router"}
        assert set(doc["services"]["router"]["stats"]["replicas"]) == {"engine-0", "engine-1"}
        with open(tmp_path / "run" / "engine-0.pid") as f:
            os.kill(int(f.read()), signal.SIGKILL)
        for q in queries:
            status, raw = post_raw(rp, q)
            assert status == 200
        stats = get_json(rp, "/stats.json")
        assert stats["replicas"]["engine-0"]["state"] == "ejected"
        assert stats["routing"]["retries"] + stats["replicas"]["engine-0"]["ejections"] >= 1
    finally:
        out = pio("stop-all", timeout=120)
    for name in ("router", "engine-1", "eventserver"):
        assert f"{name}: stopped" in out
    assert not list((tmp_path / "run").glob("*.pid"))
    for port in (ev, eng, eng + 1, rp):
        assert port_closed(port)


def test_supervise_replicas_readmits_a_restarted_replica(trained, tmp_path):
    """``supervise --replicas 2 --device cpu``: a keep-alive query loop
    through the router sees no failure across a kill -9 of ``engine-0``;
    the supervisor restarts it, the router admits its new instance, and
    ``status`` shows both; SIGTERM to the supervisor stops the set."""
    import http.client
    import threading

    run = tmp_path / "run"
    env = dict(trained["env"], PIO_RUN_DIR=str(run), PIO_SUPERVISE_POLL_S="0.2",
               PIO_ROUTER_PROBE_INTERVAL_S="0.2")
    ev, eng, _, rp = listen_ports(4)
    log = tmp_path / "supervise.log"
    with open(log, "w") as f:
        sup = subprocess.Popen(
            [*CLI, "supervise", *FLEET, "--event-port", str(ev), "--engine-port", str(eng),
             "--router-port", str(rp), "--replicas", "2", "--variant", trained["variant"],
             "--device", "cpu"], env=env, cwd=REPO, stdout=f, stderr=subprocess.STDOUT)
    answers, done = [], threading.Event()

    def loop():
        conn = http.client.HTTPConnection("127.0.0.1", rp, timeout=30)
        i = 0
        while not done.is_set():
            q = json.dumps({"user": f"u{i % 30}", "num": 3}).encode()
            conn.request("POST", "/queries.json", q, {"Content-Type": "application/json"})
            resp = conn.getresponse()
            answers.append((i % 30, resp.status, resp.read()))
            i += 1
        conn.close()

    try:
        def state():
            try:
                return json.loads((run / "supervisor.json").read_text())
            except (OSError, ValueError):
                return None

        names = ("eventserver", "engine-0", "engine-1", "router")
        wait_until("the replica set up", lambda: (s := state()) and all(
            s["services"][n]["state"] == "up" for n in names), proc=sup)
        wait_until("both replicas admitted", lambda: all(
            r["state"] == "ready" for r in get_json(rp, "/stats.json")["replicas"].values()))
        want = {u: post_raw(eng, {"user": f"u{u}", "num": 3}) for u in range(30)}
        worker = threading.Thread(target=loop)
        worker.start()
        try:
            old = get_json(eng, "/healthz")["instance"]
            os.kill(int((run / "engine-0.pid").read_text()), signal.SIGKILL)
            new = wait_until("a new engine-0", lambda: (
                d := get_json(eng, "/healthz"))["instance"] != old and d, proc=sup)
            wait_until("the router admitting it", lambda: (
                r := get_json(rp, "/stats.json")["replicas"]["engine-0"])["state"] == "ready"
                and r["instance"] == new["instance"])
            time.sleep(0.5)
        finally:
            done.set()
            worker.join(timeout=60)
        assert answers and all(s == 200 and raw == want[u][1] for u, s, raw in answers)
        stats = get_json(rp, "/stats.json")
        assert stats["routing"]["retries"] + stats["replicas"]["engine-0"]["ejections"] >= 1
        assert state()["services"]["engine-0"]["restarts"] == 1
        text = subprocess.run([*CLI, "status"], env=env, cwd=REPO, capture_output=True,
                              text=True, timeout=120).stdout
        assert "replica[router/engine-0]: ready" in text
        assert "supervisor[engine-0]: up (restarts 1" in text
        sup.send_signal(signal.SIGTERM)
        assert sup.wait(timeout=60) == 0
    finally:
        if sup.poll() is None:
            sup.kill()
            sup.wait()
    assert {s["state"] for s in state()["services"].values()} == {"stopped"}
    assert not list(run.glob("*.pid"))
    for port in (ev, eng, eng + 1, rp):
        assert port_closed(port)
