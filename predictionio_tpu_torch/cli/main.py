"""Command line of the port: the quickstart's verbs.

    python -m predictionio_tpu_torch.cli.main version
    python -m predictionio_tpu_torch.cli.main status
    python -m predictionio_tpu_torch.cli.main app \\
        {new NAME [--id N] [--description D] [--access-key K] | list |
         show NAME | delete NAME | data-delete NAME [--channel C] |
         channel-new NAME CHANNEL | channel-delete NAME CHANNEL}
    python -m predictionio_tpu_torch.cli.main accesskey \\
        {new APP [--event E ...] | list [APP] | delete KEY}
    python -m predictionio_tpu_torch.cli.main eventserver \\
        [--ip 0.0.0.0] [--port 7070] [--stats] [--reuse-port] [--workers N]
    python -m predictionio_tpu_torch.cli.main import --appid-or-name APP \\
        --input FILE [--channel C] [--jobs N] [--warm-cache] \\
        [--http URL --access-key KEY]
    python -m predictionio_tpu_torch.cli.main export --appid-or-name APP \\
        --output FILE [--channel C]
    python -m predictionio_tpu_torch.cli.main train --variant engine.json \\
        [--engine-id ID] [--engine-version V] [--batch LABEL] \\
        [--skip-sanity-check] [--stop-after-read] [--stop-after-prepare] \\
        [--warm-start] [--tol T] [--checkpoint-every N] [--resume] \\
        [--checkpoint-dir DIR] [--no-columnar-cache] [--no-prep-cache] \\
        [--prep-cache-dir DIR] [--device cuda|cpu]
    python -m predictionio_tpu_torch.cli.main deploy \\
        [--engine-instance-id ID | --variant engine.json] \\
        [--ip 0.0.0.0] [--port 8000] [--device cuda|cpu] \\
        [--feedback --event-server-ip IP --event-server-port P \\
         --accesskey KEY] [--server-config server.conf] \\
        [--log-url URL] [--log-prefix P] [--batch-window-ms MS] \\
        [--reuse-port] [--query-cache-mb MB] [--variants A.json,B.json] \\
        [--no-warmup] [--realtime SECONDS [--realtime-cursor PATH]] \\
        [--workers N]
    python -m predictionio_tpu_torch.cli.main route \\
        {--replica [NAME=]HOST:PORT ... | --replicas N [--engine-host H] \\
         [--engine-port 8000]} [--ip 0.0.0.0] [--port 8100] \\
        [--probe-interval S] [--no-hedge] [--reuse-port]
    python -m predictionio_tpu_torch.cli.main undeploy [--ip IP] [--port P]
    python -m predictionio_tpu_torch.cli.main eval EVALUATION \\
        [ENGINE_PARAMS_GENERATOR] [--batch LABEL] [--device cuda|cpu]
    python -m predictionio_tpu_torch.cli.main cache \\
        {list [--json] | evict ENTRY | prune [--max-mb MB] [--json]}
    python -m predictionio_tpu_torch.cli.main {start-all [--supervise] | supervise} \\
        --no-dashboard --no-adminserver [--ip 0.0.0.0] [--event-port 7070] \\
        [--engine-port 8000] [--stats] [--variant engine.json] \\
        [--variants A.json,B.json] [--device cuda|cpu] [--supervise-port P] \\
        [--replicas N [--router-port 8100]] \\
        [--retrain-every DUR [--retrain-slo] [--retrain-floor DUR] \\
         [--retrain-tol T]]
    python -m predictionio_tpu_torch.cli.main rolling-restart SERVICE [--wait S]
    python -m predictionio_tpu_torch.cli.main stop-all

Port of ``predictionio_tpu/cli/main.py`` ``cmd_version`` (:106),
``cmd_status`` (:111), ``cmd_app`` (:755), ``cmd_accesskey`` (:799),
``cmd_train`` (:843-894), ``cmd_eval`` (:900-934), ``cmd_deploy``
(:1053-1207), ``cmd_undeploy`` (:1210), ``cmd_eventserver`` (:1223),
``cmd_export`` (:1308), ``cmd_import`` (:1323), ``cmd_cache``
(:1381), ``cmd_start_all`` (:1443), ``cmd_rolling_restart`` (:1654),
``cmd_stop_all`` (:1694), ``cmd_route`` (:1269) and ``_run_workers``
(:951-1026), with the JAX verbs' flags and printed lines.
The app, access-key, import, export and event-server verbs are host
code (``cli/commands.py``, ``server/event_server.py``) and start no
device; they write records and events that the JAX package reads, and
the reverse. ``status`` prints
the storage bindings, the torch devices, which event codec runs (the
native library or the pure-Python one), a live training's progress
line, and the JAX verb's supervisor, SLO and variant lines from the run
dir (``cli/daemon.py``) and the live daemons, and a live router's
replica lines; ``status --json`` prints one compact line merging every
live daemon's ``/metrics``, ``/stats.json`` (the router's with its
``replicas`` and ``routing`` blocks) and ``/slo.json`` with
``supervisor.json``. ``undeploy`` POSTs ``/stop`` to a deployed engine
server.

``deploy --workers N`` and ``eventserver --workers N`` run N copies of
the same command line (without ``--workers``, with ``--reuse-port``)
sharing one port by ``SO_REUSEPORT``; the parent only spawns, forwards
SIGTERM / SIGINT and exits nonzero when any worker dies. It imports no
``torch``; each worker is a fresh interpreter of this CLI, never a fork,
so each has its own CUDA context and model copy on the card. ``route``
is the router tier (``server/router.py``), host code only.

``start-all`` brings the fleet up as detached daemons (the event server,
and with ``--variant`` a deployed engine, both with ``--reuse-port``; with
``--replicas N`` the engine as ``engine-0`` .. ``engine-<N-1>`` on
consecutive ports from ``--engine-port`` behind a ``router`` on
``--router-port``);
``supervise`` (or ``start-all --supervise``) runs it under the
self-healing supervisor in the foreground (``server/supervisor.py``),
with ``--retrain-every DUR`` a cadenced warm ``train`` and ``/reload``;
``rolling-restart`` replaces one recorded daemon without downtime and
``stop-all`` stops them all. ``--device`` goes on to the engine's
``deploy`` and to the scheduled ``train``, so with no flag every child
scores and trains on the card. A plan that needs a later slice fails
before anything is spawned: the dashboard and the admin server (item
10c; pass ``--no-dashboard --no-adminserver``), ``--engine-factory`` and
``--engine-dir`` (10d).

``train`` records an engine instance under
the variant's (id, version, file-name label), as the JAX CLI does, so
``deploy`` of either package finds it; ``--warm-start`` starts from the
latest COMPLETED instance of that identity, whichever package trained
it. ``--checkpoint-every N``, ``--resume`` and ``--checkpoint-dir DIR``
set ``PIO_CHECKPOINT_EVERY``, ``PIO_RESUME`` and ``PIO_CHECKPOINT_DIR``
as the JAX CLI does (``core/checkpoint.py``; the files are the JAX
package's, so either package resumes the other's). ``--no-prep-cache``
and ``--prep-cache-dir DIR`` set ``PIO_PREP_CACHE=0`` and
``PIO_PREP_CACHE_DIR`` (``core/prep_cache.py``; either package hits the
other's entries), and ``cache list|evict|prune`` keeps that directory.
The JAX CLI's mesh,
multi-host and profiler flags belong to later slices and are not
accepted. ``deploy --realtime SECONDS`` runs the speed layer
(``realtime/``), one per mounted variant, folding tailed rating events
into the served model every SECONDS; its cursor is
``--realtime-cursor`` or ``~/.pio_tpu/realtime/cursor_<engine>_<port>
.json``. Flags that need a later slice are accepted and raise
``NotImplementedError`` naming it (``_check_later_slices``), never
ignored: the fleet plans above. ``import --warm-cache`` builds the columnar
segment cache of a jsonl or partitioned store after the import, and
``train --no-columnar-cache`` reads the row logs instead
(``PIO_COLUMNAR_CACHE=0``). The engine factory
comes from the variant's ``engineFactory`` (for ``deploy``, else from
the instance's recorded ``engine_factory``), else the port's
recommendation template; a JAX-package factory name maps to the port
module of the same path (core/engine.py ``port_factory_name``). Storage
is configured by the same ``PIO_*`` environment as the JAX package.
Training, evaluation and scoring run on CUDA unless ``--device cpu`` is
given. ``eval`` records an EvaluationInstance (INIT -> EVALCOMPLETED) and
prints the JAX verb's lines, its last a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import TYPE_CHECKING

from predictionio_tpu_torch import __version__

# each verb imports what it runs: torch and the engine stack only where it
# trains, evaluates or serves, so the event server, the supervisor and the
# fleet verbs start without them
if TYPE_CHECKING:
    from predictionio_tpu_torch.server.engine_server import EngineServer


def cmd_version(args) -> int:
    print(__version__)
    return 0


def _training_progress() -> dict | None:
    """The live-training progress doc (obs/progress.py), or None when
    no checkpointed ``train`` is currently publishing."""
    from predictionio_tpu_torch.obs import progress as obs_progress

    doc = obs_progress.read_progress()
    return doc if obs_progress.is_live(doc) else None


def _training_line() -> str | None:
    """Human one-liner for ``status`` when a checkpointed ``train`` is
    publishing its progress: "training: iter 7/20, ETA 41s"."""
    doc = _training_progress()
    if doc is None:
        return None
    # under --tol the iteration count is an upper bound
    bound = "<=" if doc.get("eta_is_bound") else ""
    parts = [f"iter {doc.get('iteration')}/{bound}{doc.get('total_iterations')}"]
    if doc.get("eta_s") is not None:
        parts.append(f"ETA {bound}{round(doc['eta_s'])}s")
    rmse = doc.get("rmse")
    if rmse:
        parts.append(f"RMSE {rmse[-1]:.4f}")
    if doc.get("events_per_s"):
        parts.append(f"{doc['events_per_s']:,.0f} events/s")
    return "training: " + ", ".join(parts)


def cmd_status(args) -> int:
    from predictionio_tpu_torch.cli import commands

    if getattr(args, "json", False):
        return _status_json()
    info = commands.status()
    print(json.dumps(info, indent=2))
    print("(sanity check) All storage repositories verified.")
    line = _training_line()
    if line:
        print(line)
    for line in _supervisor_lines():
        print(line)
    for line in _slo_lines():
        print(line)
    for line in _variant_lines():
        print(line)
    for line in _replica_lines():
        print(line)
    return 0


def _live_daemon_json(path: str) -> dict[str, dict]:
    """``GET path`` of every live daemon (pid file + answering port) as
    parsed JSON; silent on daemons that are down or refuse."""
    import urllib.request

    from predictionio_tpu_torch.cli import daemon

    docs: dict[str, dict] = {}
    for name in daemon.known_services():
        if daemon.read_pid(name) is None:
            continue
        port = daemon.service_port(name)
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=2.0
            ) as r:
                doc = json.loads(r.read())
        except Exception:
            continue
        if isinstance(doc, dict):
            docs[name] = doc
    return docs


def _variant_lines() -> list[str]:
    """Human per-tenant lines for ``status`` when a live engine daemon
    mounts more than one variant: one row per mount off its /stats.json
    ``variants`` block, e.g.
    ``variant[engine/b]: 124 reqs, p99 3.1ms, epoch 2``."""
    lines: list[str] = []
    for name, stats in _live_daemon_json("/stats.json").items():
        variants = stats.get("variants") or {}
        if len(variants) <= 1:
            continue
        for vname, v in variants.items():
            parts = [f"{v.get('requestCount', 0)} reqs"]
            if v.get("p99Ms") is not None:
                parts.append(f"p99 {v['p99Ms']}ms")
            parts.append(f"epoch {v.get('epoch', '?')}")
            if v.get("secondsBehind") is not None:
                parts.append(f"{v['secondsBehind']}s behind")
            if v.get("modelAgeSec") is not None:
                parts.append(f"model age {v['modelAgeSec']}s")
            lines.append(f"variant[{name}/{vname}]: {', '.join(parts)}")
    return lines


def _replica_lines() -> list[str]:
    """Human per-replica lines for ``status`` when a router tier is
    up: one row per pool member off its /stats.json ``replicas`` block,
    e.g. ``replica[router/engine-0]: ready, 2 inflight, p99 31.0ms,
    124 reqs`` — ejected members lead with their state upper-cased."""
    lines: list[str] = []
    for name, stats in _live_daemon_json("/stats.json").items():
        for rname, rr in (stats.get("replicas") or {}).items():
            state = str(rr.get("state", "?"))
            mark = state if state == "ready" else state.upper()
            parts = [
                f"{rr.get('inflight', 0)} inflight",
                f"p99 {rr.get('p99Ms', 0)}ms",
                f"{rr.get('requests', 0)} reqs",
            ]
            if rr.get("ejections"):
                parts.append(f"{rr['ejections']} ejections")
            lines.append(
                f"replica[{name}/{rname}]: {mark}, {', '.join(parts)}"
            )
    return lines


def _supervisor_lines() -> list[str]:
    """Human supervisor lines for ``status``, one per supervised
    service: ``supervisor[engine]: up (restarts 1)`` — with the last
    exit reason and next-retry ETA when it is mid-backoff or broken."""
    from predictionio_tpu_torch.server import supervisor as sup_mod

    doc = sup_mod.read_state()
    if doc is None:
        return []
    lines: list[str] = []
    stale = "" if doc.get("live") else " [supervisor not running]"
    for name, s in (doc.get("services") or {}).items():
        parts = [f"restarts {s.get('restarts', 0)}"]
        if s.get("pid"):
            parts.append(f"pid {s['pid']}")
        if s.get("last_exit") and s.get("state") != "up":
            parts.append(f"last exit: {s['last_exit']}")
        if s.get("next_retry_in_s") is not None:
            parts.append(f"retry in {s['next_retry_in_s']}s")
        lines.append(
            f"supervisor[{name}]: {s.get('state', '?')} "
            f"({', '.join(parts)}){stale}"
        )
    rt = doc.get("retrain")
    if isinstance(rt, dict):
        parts = [
            f"every {rt.get('interval_s')}s"
            + (" (slo)" if rt.get("slo_driven") else ""),
            f"runs {rt.get('runs', 0)}",
            f"skips {rt.get('skips', 0)}",
            f"failures {rt.get('failures', 0)}",
        ]
        last = rt.get("last_run") or {}
        if last:
            parts.append(
                "last ok" if last.get("ok") else
                f"last failed ({last.get('exit')})"
            )
        if rt.get("next_in_s") is not None:
            parts.append(f"next in {rt['next_in_s']}s")
        lines.append(
            f"supervisor[retrain]: {rt.get('state', '?')} "
            f"({', '.join(parts)}){stale}"
        )
    return lines


def _slo_lines() -> list[str]:
    """Human SLO lines for ``status``: one per objective, e.g.
    ``slo[engine] engine.latency: OK (burn 0.2/0.1)``; violated and
    burning objectives lead with their state upper-cased. Follows with
    the newest state transitions off each daemon's alert ring."""
    lines: list[str] = []
    alerts: list[tuple[float, str]] = []
    for service, doc in _live_daemon_json("/slo.json").items():
        for s in doc.get("slos", []):
            state = str(s.get("state", "?"))
            mark = state.upper() if state != "ok" else "OK"
            burn = ""
            if s.get("burn_fast") is not None:
                burn = f" (burn {s['burn_fast']}/{s.get('burn_slow')})"
            cur = ""
            if s.get("current") is not None:
                cur = f", current {s['current']}"
            lines.append(
                f"slo[{service}] {s.get('name')}: {mark}{burn}{cur}"
            )
        for a in doc.get("alerts", []):
            t = float(a.get("t") or 0.0)
            alerts.append(
                (
                    t,
                    f"alert[{service}] {a.get('slo')}: "
                    f"{a.get('from')} -> {a.get('to')} "
                    f"(burn {a.get('burn_fast')}/{a.get('burn_slow')}, "
                    f"t={a.get('t')})",
                )
            )
    lines.extend(line for _, line in sorted(alerts)[-5:])
    return lines


def _status_json() -> int:
    """``status --json``: one compact JSON line merging ``/metrics`` +
    ``/stats.json`` + ``/slo.json`` from every running daemon (live pid
    files) with the supervisor's state, the SLO alerts, the incident
    bundles and a live training's progress. Endpoints that refuse (the
    event server's /stats.json wants an access key) are skipped, not
    fatal."""
    import urllib.request

    from predictionio_tpu_torch.cli import daemon
    from predictionio_tpu_torch.obs import incident as obs_incident
    from predictionio_tpu_torch.obs import metrics as obs_metrics
    from predictionio_tpu_torch.server import supervisor as sup_mod

    def fetch(url: str):
        try:
            with urllib.request.urlopen(url, timeout=2.0) as r:
                return r.read()
        except Exception:
            return None

    services: dict = {}
    for name in daemon.known_services():
        pid = daemon.read_pid(name)
        if pid is None:
            continue
        port = daemon.service_port(name)
        entry: dict = {"pid": pid, "port": port}
        base = f"http://127.0.0.1:{port}"
        raw = fetch(f"{base}/metrics")
        if raw is not None:
            entry["metrics"] = obs_metrics.parse_prometheus(raw)
        for key in ("stats", "slo"):
            raw = fetch(f"{base}/{key}.json")
            if raw is not None:
                try:
                    entry[key] = json.loads(raw)
                except ValueError:
                    pass
        services[name] = entry
    summary: dict = {"services": services}
    sup_doc = sup_mod.read_state()
    if sup_doc is not None:
        summary["supervisor"] = sup_doc
    # the SLO alert ring across services, oldest -> newest, each record
    # tagged with the daemon it came from
    alerts = [
        {"service": name, **a}
        for name, entry in services.items()
        for a in (entry.get("slo") or {}).get("alerts", [])
    ]
    alerts.sort(key=lambda a: float(a.get("t") or 0.0))
    summary["alerts"] = alerts[-10:]
    bundles = obs_incident.list_incidents()
    summary["incidents"] = {
        "count": len(bundles),
        "latest": bundles[0]["name"] if bundles else None,
        "dir": str(obs_incident.incidents_dir()),
    }
    progress = _training_progress()
    if progress is not None:
        summary["training"] = progress
    print(json.dumps(summary, separators=(",", ":")))
    return 0


def cmd_app(args) -> int:
    from predictionio_tpu_torch.cli import commands

    try:
        if args.app_command == "new":
            info = commands.app_new(
                args.name, app_id=args.id or 0, description=args.description,
                access_key=args.access_key or "",
            )
            print("Created a new app:")
            print(f"      Name: {info['name']}")
            print(f"        ID: {info['id']}")
            print(f"Access Key: {info['access_key']}")
        elif args.app_command == "list":
            for a in commands.app_list():
                print(f"{a['id']:>6} | {a['name']} | {a['access_key']}")
        elif args.app_command == "show":
            info = commands.app_show(args.name)
            print(json.dumps(info, indent=2))
        elif args.app_command == "delete":
            commands.app_delete(args.name)
            print(f"Deleted app {args.name}.")
        elif args.app_command == "data-delete":
            commands.app_data_delete(args.name, channel=args.channel)
            print(f"Deleted data of app {args.name}.")
        elif args.app_command == "channel-new":
            info = commands.channel_new(args.name, args.channel)
            print(f"Created channel {info['name']} (id {info['id']}).")
        elif args.app_command == "channel-delete":
            commands.channel_delete(args.name, args.channel)
            print(f"Deleted channel {args.channel}.")
        else:
            print(
                "usage: pio app "
                "{new,list,show,delete,data-delete,channel-new,channel-delete}",
                file=sys.stderr,
            )
            return 1
        return 0
    except commands.CommandError as e:
        print(str(e), file=sys.stderr)
        return 1


def cmd_accesskey(args) -> int:
    from predictionio_tpu_torch.cli import commands

    try:
        if args.ak_command == "new":
            key = commands.accesskey_new(args.app_name, events=args.event or [])
            print(f"Created new access key: {key}")
        elif args.ak_command == "list":
            for k in commands.accesskey_list(args.app_name):
                print(f"{k['key']} | app {k['app_id']} | events {k['events'] or 'ALL'}")
        elif args.ak_command == "delete":
            commands.accesskey_delete(args.key)
            print(f"Deleted access key {args.key}.")
        else:
            print("usage: pio accesskey {new,list,delete}", file=sys.stderr)
            return 1
        return 0
    except commands.CommandError as e:
        print(str(e), file=sys.stderr)
        return 1


def cmd_undeploy(args) -> int:
    """POST ``/stop`` to the engine server at ``--ip``:``--port``."""
    import urllib.request

    url = f"http://{args.ip}:{args.port}/stop"
    try:
        urllib.request.urlopen(urllib.request.Request(url, data=b""), timeout=10)
        print("Undeployed.")
        return 0
    except Exception as e:
        print(f"undeploy failed: {e}", file=sys.stderr)
        return 1


def cmd_eventserver(args) -> int:
    """Serve the event API in the foreground; no device is touched."""
    rc = _maybe_run_workers(args)
    if rc is not None:
        return rc
    from predictionio_tpu_torch.server.event_server import EventServer

    server = EventServer(
        host=args.ip, port=args.port, stats=args.stats,
        reuse_port=args.reuse_port,
    )
    server.start(background=False)
    return 0


def cmd_route(args) -> int:
    """``route``: the scale-out router tier — one front port spreading
    /queries.json across a replica set of engine servers with
    consistent-hash affinity, health-aware ejection, and hedged
    requests (server/router.py). Host code: no device, no torch."""
    from predictionio_tpu_torch.server.router import (
        RouterServer,
        parse_replica_spec,
    )

    replicas: list[tuple[str, str, int]] = []
    for i, spec in enumerate(args.replica or []):
        try:
            replicas.append(parse_replica_spec(spec, i))
        except ValueError as e:
            print(f"route: {e}", file=sys.stderr)
            return 1
    if args.replicas:
        host = args.engine_host
        base = args.engine_port
        replicas.extend(
            (f"engine-{i}", host, base + i) for i in range(args.replicas)
        )
    if not replicas:
        print(
            "route: name at least one backend (--replica HOST:PORT or "
            "--replicas N)", file=sys.stderr,
        )
        return 1
    server = RouterServer(
        replicas,
        host=args.ip,
        port=args.port,
        reuse_port=args.reuse_port,
        probe_interval_s=args.probe_interval or None,
        hedge=False if args.no_hedge else None,
    )
    server.start(background=False)
    return 0


def cmd_export(args) -> int:
    from predictionio_tpu_torch.cli import commands
    from predictionio_tpu_torch.data.store import EventStoreError

    try:
        n = commands.export_events(
            args.appid_or_name, args.output, channel=args.channel
        )
    except (commands.CommandError, EventStoreError) as e:
        print(str(e), file=sys.stderr)
        return 1
    print(f"Exported {n} events to {args.output}.")
    return 0


def cmd_import(args) -> int:
    from predictionio_tpu_torch.cli import commands
    from predictionio_tpu_torch.data.store import EventStoreError

    try:
        if args.http:
            if not args.access_key:
                print("--http requires --access-key", file=sys.stderr)
                return 1
            n = commands.import_events_http(
                args.input, args.http, args.access_key,
                channel=args.channel,
            )
        else:
            n = commands.import_events(
                args.appid_or_name, args.input,
                channel=args.channel, jobs=args.jobs,
            )
    except (commands.CommandError, EventStoreError) as e:
        print(str(e), file=sys.stderr)
        return 1
    print(f"Imported {n} events.")
    if args.warm_cache:
        from predictionio_tpu_torch.data import store
        from predictionio_tpu_torch.data.storage import get_storage

        storage = get_storage()
        rows = store.warm_columnar_cache(
            commands._resolve_app_name(args.appid_or_name, storage),
            channel_name=args.channel,
            storage=storage,
        )
        print(f"Columnar cache warmed ({rows} rating rows).")
    return 0


def _engine_identity(args, variant: dict) -> tuple[str, str, str]:
    """(engine_id, version, variant label) -- the instance lookup key, as
    the JAX CLI computes it: an id-less variant falls back to the real
    path of its directory; the label is the variant file's name."""
    engine_id = getattr(args, "engine_id", None) or variant.get("id")
    if not engine_id:
        engine_id = (
            os.path.dirname(os.path.realpath(args.variant)) if args.variant
            else "default"
        )
    label = os.path.basename(args.variant or "") or "default"
    version = getattr(args, "engine_version", None) or variant.get("version", "0")
    return engine_id, version, label


def cmd_train(args) -> int:
    """Train the variant's engine and record a COMPLETED instance."""
    from predictionio_tpu_torch.core.context import WorkflowContext
    from predictionio_tpu_torch.core.engine import (
        DEFAULT_ENGINE_FACTORY,
        WorkflowParams,
        resolve_engine_factory,
    )
    from predictionio_tpu_torch.core.workflow import load_variant, run_train

    # the checkpoint flags reach als_train through the environment, as in
    # the JAX CLI
    if args.checkpoint_every:
        os.environ["PIO_CHECKPOINT_EVERY"] = str(args.checkpoint_every)
    if args.resume:
        os.environ["PIO_RESUME"] = "1"
    if args.checkpoint_dir:
        os.environ["PIO_CHECKPOINT_DIR"] = args.checkpoint_dir
    if args.no_columnar_cache:
        os.environ["PIO_COLUMNAR_CACHE"] = "0"
    if args.no_prep_cache:
        os.environ["PIO_PREP_CACHE"] = "0"
    if args.prep_cache_dir:
        os.environ["PIO_PREP_CACHE_DIR"] = args.prep_cache_dir
    variant = load_variant(args.variant) if args.variant else {}
    factory = variant.get("engineFactory") or DEFAULT_ENGINE_FACTORY
    engine = resolve_engine_factory(factory)
    runtime_conf: dict = {}
    if args.warm_start:
        runtime_conf["warm_start"] = True
    if args.tol is not None:
        runtime_conf["tol"] = args.tol
    wp = WorkflowParams(
        batch=args.batch,
        skip_sanity_check=args.skip_sanity_check,
        stop_after_read=args.stop_after_read,
        stop_after_prepare=args.stop_after_prepare,
        runtime_conf=runtime_conf,
    )
    ctx = WorkflowContext(mode="Training", batch=wp.batch,
                          runtime_conf=wp.runtime_conf, device=args.device)
    engine_id, engine_version, label = _engine_identity(args, variant)
    instance_id = run_train(
        engine,
        engine.params_from_variant(variant),
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=label,
        engine_factory=factory,
        workflow_params=wp,
        ctx=ctx,
    )
    print(f"Training completed. Engine instance ID: {instance_id}")
    return 0


def cmd_eval(args) -> int:
    """Run an evaluation sweep and record an EvaluationInstance."""
    from predictionio_tpu_torch.core.context import WorkflowContext
    from predictionio_tpu_torch.core.workflow_eval import run_evaluation

    ctx = WorkflowContext(mode="Evaluation", batch=args.batch or "", device=args.device)
    instance_id, result = run_evaluation(
        evaluation_class=args.evaluation_class,
        engine_params_generator_class=args.engine_params_generator_class,
        batch=args.batch or "",
        ctx=ctx,
    )
    print(result.to_one_liner())
    print(f"Evaluation completed. Evaluation instance ID: {instance_id}")
    # a compact machine-readable summary as the last stdout line, the JAX
    # verb's keys: a caller that keeps only the tail can json.loads it
    best = result.best_score
    summary = {
        "metric": result.metric_header,
        "best_index": result.best_idx,
        "best_params": result.best_engine_params.to_jsonable(),
        "best_scores": {
            result.metric_header: best.score,
            **dict(zip(result.other_metric_headers, best.other_scores)),
        },
        "scores": [ms.score for _, ms in result.engine_params_scores],
        "candidates": len(result.engine_params_scores),
        "fast_path_candidates": result.fast_path_candidates,
        "phase_seconds": {
            k: round(v, 3) for k, v in result.phase_seconds.items()
        },
        "cache": result.cache_stats,
        "instance_id": instance_id,
    }
    print(json.dumps(summary, sort_keys=True))
    return 0


def cmd_cache(args) -> int:
    """``cache list|evict|prune``: the packed-prep cache's lifecycle
    (``core/prep_cache.py``). Entries are derived data: evicting one only
    costs the next train a full scan and layout."""
    from predictionio_tpu_torch.core import prep_cache

    verb = args.cache_verb or "list"
    if verb == "list":
        entries = prep_cache.cache_entries(detail=True)
        total = sum(e["bytes"] for e in entries)
        cap = prep_cache.max_bytes()
        if args.json:
            print(json.dumps({
                "dir": str(prep_cache.cache_dir()),
                "total_bytes": total,
                "max_bytes": cap,
                "entries": entries,
            }, indent=2))
            return 0
        print(f"Prep cache: {prep_cache.cache_dir()}")
        if not entries:
            print("  (empty)")
            return 0
        for e in entries:
            packs = [k for k, key in (("single", "single_pack"), ("sharded", "sharded_pack"))
                     if e.get(key)]
            age = time.time() - e["atime"]
            print(
                f"  {e['name']}: {e['bytes'] / 1e6:.1f} MB, "
                f"{e.get('n', 0):,} events, "
                f"packs [{', '.join(packs) or 'none'}], "
                f"last used {age:.0f}s ago"
            )
        cap_s = f" / cap {cap / 1e6:.1f} MB" if cap else ""
        print(f"  total {total / 1e6:.1f} MB{cap_s}")
        return 0
    if verb == "evict":
        if prep_cache.evict(args.entry):
            print(f"evicted {args.entry}")
            return 0
        print(f"cache: no such entry {args.entry!r}", file=sys.stderr)
        return 1
    limit = None if args.max_mb is None else int(float(args.max_mb) * 1024 * 1024)
    out = prep_cache.prune(limit=limit)
    if args.json:
        print(json.dumps(out, indent=2))
    else:
        print(f"pruned: {len(out['husks'])} husk(s), "
              f"{len(out['evicted'])} entry(ies) evicted")
    return 0


def _load_server_config(args):
    """server.conf for key auth / SSL: --server-config flag, else the
    PIO_SERVER_CONF env var, else conf/server.conf when present."""
    from predictionio_tpu_torch.common import load_server_config

    path = (
        getattr(args, "server_config", None)
        or os.environ.get("PIO_SERVER_CONF")
        or "conf/server.conf"
    )
    return load_server_config(path=path)


def _maybe_run_workers(args) -> int | None:
    """The ``--workers N`` dispatch shared by deploy/eventserver: None
    means "continue single-process"."""
    if getattr(args, "workers", 1) <= 1:
        return None
    if args.port == 0:
        print("--workers needs an explicit --port", file=sys.stderr)
        return 1
    return _run_workers(args)


def _run_workers(args) -> int:
    """Spawn N copies of this exact CLI invocation (each binding the
    same port with SO_REUSEPORT) and supervise them: forward SIGTERM/
    SIGINT, exit nonzero if ANY worker dies (an external supervisor
    restarts the set). CPython serving is GIL-bound, so the scale-out
    unit is the PROCESS. Each child is a fresh interpreter of the port's
    CLI (``daemon.CLI_MODULE``), never a fork: on the card each makes its
    own CUDA context and model copy. This process imports no torch."""
    import signal
    import subprocess

    from predictionio_tpu_torch.cli.daemon import CLI_MODULE

    # strip every --workers spelling (separate token, --workers=N, and
    # argparse prefix abbreviations): a surviving flag would make each
    # child spawn its own workers — a fork bomb
    argv = []
    tokens = iter(args.argv)
    for tok in tokens:
        if tok.startswith("--w") and "--workers".startswith(
            tok.split("=", 1)[0]
        ):
            if "=" not in tok:
                next(tokens, None)  # drop the value token too
            continue
        argv.append(tok)
    if "--reuse-port" not in argv:
        argv.append("--reuse-port")

    procs: list = []

    # install the forwarders BEFORE spawning: a SIGTERM landing in the
    # spawn window must still reach (and not orphan) early workers
    def forward(signum, _frame):
        for pr in procs:
            pr.send_signal(signum)

    signal.signal(signal.SIGTERM, forward)
    signal.signal(signal.SIGINT, forward)
    for _ in range(args.workers):
        procs.append(
            subprocess.Popen([sys.executable, "-m", CLI_MODULE] + argv)
        )
    rc = 0
    try:
        # poll ALL workers: the death of any one must surface (waiting
        # on one pid would let the set run degraded indefinitely)
        while procs and rc == 0:
            time.sleep(0.5)
            for pr in list(procs):
                code = pr.poll()
                if code is None:
                    continue
                procs.remove(pr)
                if code not in (0, -signal.SIGTERM, -signal.SIGINT):
                    rc = code or 1
    finally:
        for pr in procs:
            pr.terminate()
        for pr in procs:
            try:
                pr.wait(timeout=10)
            except Exception:
                pr.kill()
    return rc


def _check_later_slices(args) -> None:
    """Flags that belong to a later slice of the port raise, naming it,
    instead of being ignored."""
    if getattr(args, "command", None) in ("start-all", "supervise"):
        if not (args.no_dashboard and args.no_adminserver):
            raise NotImplementedError(
                f"{args.command} starts the dashboard and the admin server "
                "unless given --no-dashboard --no-adminserver; both are a "
                "later slice of the PyTorch port (ROADMAP.md queue 1, item "
                "10c: the dashboard and the admin server)"
            )
        if args.engine_factory or args.engine_dir:
            raise NotImplementedError(
                "--engine-factory and --engine-dir are a later slice of the "
                "PyTorch port (ROADMAP.md queue 1, item 10d: the remaining "
                "verbs and flags); name the engine by --variant"
            )


def start_speed_layers(server: EngineServer, args) -> list:
    """``deploy --realtime SECONDS``: one started speed layer per mounted
    variant, each tailing its own app into its own mount behind that
    mount's epoch fence (the JAX CLI's cursor paths)."""
    if not getattr(args, "realtime", 0.0) or args.realtime <= 0:
        return []
    from pathlib import Path

    from predictionio_tpu_torch.realtime import SpeedLayer

    run = Path("~/.pio_tpu").expanduser() / "realtime"
    layers = [SpeedLayer(
        server, interval=args.realtime,
        cursor_path=args.realtime_cursor
        or str(run / f"cursor_{server.instance.engine_id}_{args.port}.json"),
    )]
    for name, v in server.variants.items():
        if v is server._default_variant:
            continue
        layers.append(SpeedLayer(
            v, interval=args.realtime,
            cursor_path=str(run / f"cursor_{v.instance.engine_id}_{args.port}_{name}.json"),
        ))
    for layer in layers:
        layer.start()
    return layers


def _resolve_extra_variants(args, instances) -> list:
    """``--variants a.json,b.json`` -> [(mount_name, engine, instance)].

    Each file resolves exactly like a solo ``deploy --variant`` of that
    path: its own engineFactory (falling back to the primary's), its own
    (id, version, basename-label) instance lookup. The mount name is the
    file's basename minus ``.json`` -- the path prefix queries route on
    (``/<name>/queries.json``). Raises LookupError for a variant with no
    completed instance."""
    from predictionio_tpu_torch.core.engine import (
        DEFAULT_ENGINE_FACTORY,
        resolve_engine_factory,
    )
    from predictionio_tpu_torch.core.workflow import load_variant

    spec = getattr(args, "variants", None) or ""
    paths = [p.strip() for p in spec.split(",") if p.strip()]
    extra = []
    for path in paths:
        variant = load_variant(path)
        factory = variant.get("engineFactory") or DEFAULT_ENGINE_FACTORY
        engine = resolve_engine_factory(factory)
        engine_id = variant.get("id") or os.path.dirname(os.path.realpath(path))
        label = os.path.basename(path)
        inst = instances.get_latest_completed(
            engine_id, variant.get("version", "0"), label
        )
        if inst is None:
            raise LookupError(
                f"no completed engine instance for variant {path} "
                f"(train it first: train --variant {path})"
            )
        name = label[:-5] if label.endswith(".json") else label
        extra.append((name, engine, inst))
    return extra


def deploy_server(args) -> EngineServer:
    """Resolve the engine and instance from ``args`` and build the
    server (models loaded to the device, not yet warmed or bound).
    Raises LookupError when no instance matches. One process: ``--workers``
    is ``cmd_deploy``'s, each worker builds its own server here."""
    from predictionio_tpu_torch.core.engine import (
        DEFAULT_ENGINE_FACTORY,
        resolve_engine_factory,
    )
    from predictionio_tpu_torch.core.workflow import load_variant
    from predictionio_tpu_torch.data.storage import get_storage
    from predictionio_tpu_torch.server.engine_server import EngineServer

    variant = load_variant(args.variant) if args.variant else {}
    storage = get_storage()
    instances = storage.get_metadata_engine_instances()
    if args.engine_instance_id:
        instance = instances.get(args.engine_instance_id)
        if instance is None:
            raise LookupError(f"engine instance {args.engine_instance_id} not found")
    else:
        engine_id, engine_version, label = _engine_identity(args, variant)
        instance = instances.get_latest_completed(engine_id, engine_version, label)
        if instance is None and args.variant:
            # instances trained before the basename-label change carry
            # the as-typed path as their label
            instance = instances.get_latest_completed(
                variant.get("id", "default"), engine_version, args.variant
            )
        if instance is None:
            raise LookupError(
                "No valid engine instance found for this engine; "
                "have you run `pio train` yet?"
            )
    factory = (
        variant.get("engineFactory") or instance.engine_factory
        or DEFAULT_ENGINE_FACTORY
    )
    engine = resolve_engine_factory(factory)
    return EngineServer(
        engine, instance, storage=storage, host=args.ip, port=args.port,
        feedback=args.feedback,
        event_server_url=(
            f"http://{args.event_server_ip}:{args.event_server_port}"
            if args.feedback else None
        ),
        access_key=args.accesskey,
        server_config=_load_server_config(args),
        log_url=args.log_url,
        log_prefix=args.log_prefix,
        batch_window_ms=args.batch_window_ms,
        reuse_port=args.reuse_port,
        query_cache_mb=args.query_cache_mb,
        extra_variants=_resolve_extra_variants(args, instances),
        device=args.device,
    )


def cmd_deploy(args) -> int:
    # the worker set's parent spawns and supervises only: it builds no
    # server, imports no torch and holds no CUDA context
    rc = _maybe_run_workers(args)
    if rc is not None:
        return rc
    try:
        server = deploy_server(args)
    except LookupError as e:
        print(e, file=sys.stderr)
        return 1
    # warmup BEFORE the port binds: the kernels build and the factor
    # tables upload here; a failure raises and the server never binds
    if not args.no_warmup:
        server.warmup()
    start_speed_layers(server, args)
    # foreground, like the reference: backgrounding is the caller's job.
    # SIGTERM drains (HTTPApp): in-flight queries finish, then it stops
    try:
        server.start(background=False)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def cmd_start_all(args) -> int:
    """Bring up the service fleet as detached daemons (reference
    bin/pio-start-all; see cli/daemon.py for the process model).
    With ``--supervise`` the fleet runs under a foreground supervisor
    (server/supervisor.py) that restarts crashed children with backoff.
    A plan that needs a later slice raises before anything is spawned."""
    from predictionio_tpu_torch.cli import daemon

    _check_later_slices(args)
    # --reuse-port on the HTTP services so `rolling-restart` can overlap
    # a replacement instance on the same port later
    plan: list[tuple[str, list[str], int]] = [
        (
            "eventserver",
            ["eventserver", "--ip", args.ip, "--port", str(args.event_port),
             "--reuse-port"]
            + (["--stats"] if args.stats else []),
            args.event_port,
        )
    ]
    if args.variant:
        # beyond the reference's script: also deploy the latest trained
        # engine so one verb yields a fully queryable stack. Paths go
        # absolute — the daemon child's cwd is not this shell's.
        deploy = ["deploy", "--ip", args.ip, "--reuse-port",
                  "--variant", os.path.abspath(args.variant)]
        deploy += _device_flag(args)
        if args.variants:
            deploy += [
                "--variants",
                ",".join(
                    os.path.abspath(p.strip())
                    for p in args.variants.split(",")
                    if p.strip()
                ),
            ]
        replicas = int(getattr(args, "replicas", 0) or 0)
        if replicas > 0:
            # scale-out: N engine replicas on consecutive ports, each a
            # first-class supervised service (engine-0..engine-N-1),
            # fronted by the router tier on --router-port
            router_host = args.ip if args.ip != "0.0.0.0" else "127.0.0.1"
            route = ["route", "--ip", args.ip,
                     "--port", str(args.router_port), "--reuse-port"]
            for i in range(replicas):
                port = args.engine_port + i
                plan.append((
                    f"engine-{i}",
                    deploy + ["--port", str(port)],
                    port,
                ))
                route += ["--replica", f"engine-{i}={router_host}:{port}"]
            plan.append(("router", route, args.router_port))
        else:
            plan.append(
                ("engine", deploy + ["--port", str(args.engine_port)],
                 args.engine_port)
            )

    if getattr(args, "supervise", False):
        return _run_supervised(args, plan)

    started: list[str] = []
    for name, argv, port in plan:
        host = args.ip if args.ip != "0.0.0.0" else "127.0.0.1"
        try:
            pid = daemon.start_service(name, argv, host, port)
        except RuntimeError as e:
            print(f"start-all: {e}", file=sys.stderr)
            for prev in reversed(started):  # roll back partial bring-up
                daemon.stop_service(prev)
            return 1
        started.append(name)
        print(f"{name}: up on port {port} (pid {pid})")
    print(f"Run dir: {daemon.run_dir()}")
    return 0


def _device_flag(args) -> list[str]:
    """``--device D`` for the fleet's engine and scheduled train, or
    nothing: then they run on the card."""
    return ["--device", args.device] if args.device else []


def _parse_duration(value: str) -> float:
    """``300`` / ``300s`` / ``15m`` / ``1h`` -> seconds."""
    s = str(value).strip().lower()
    mult = 1.0
    if s.endswith(("s", "m", "h")):
        mult = {"s": 1.0, "m": 60.0, "h": 3600.0}[s[-1]]
        s = s[:-1]
    try:
        out = float(s) * mult
    except ValueError:
        raise ValueError(f"bad duration {value!r} (want e.g. 300s, 15m, 1h)")
    if out <= 0:
        raise ValueError(f"duration must be positive, got {value!r}")
    return out


def _retrain_scheduler(args, plan, host):
    """Build the RetrainScheduler for ``--retrain-every``, or None."""
    from predictionio_tpu_torch.server import supervisor as sup_mod

    raw = getattr(args, "retrain_every", None)
    if not raw:
        return None
    interval = _parse_duration(raw)
    engine_ports = [
        port for name, _argv, port in plan
        if name == "engine" or name.startswith("engine-")
    ]
    if not engine_ports:
        raise ValueError("--retrain-every needs a deployed engine (--variant)")
    train_argv = ["train", "--warm-start",
                  "--variant", os.path.abspath(args.variant)]
    train_argv += _device_flag(args)
    if getattr(args, "retrain_tol", None):
        train_argv += ["--tol", str(args.retrain_tol)]
    floor = getattr(args, "retrain_floor", None)
    return sup_mod.RetrainScheduler(
        interval,
        train_argv=train_argv,
        engine_ports=engine_ports,
        host=host,
        slo_driven=bool(getattr(args, "retrain_slo", False)),
        floor_s=_parse_duration(floor) if floor else None,
    )


def _run_supervised(args, plan) -> int:
    """``start-all --supervise`` / ``supervise``: run the fleet under
    the self-healing supervisor in the FOREGROUND (the supervisor is the
    thing an init system or terminal owns; its children are the detached
    daemons). SIGTERM/SIGINT request an orderly reverse-order stop —
    each child gets a drain-grace SIGTERM first."""
    import signal

    from predictionio_tpu_torch.cli import daemon
    from predictionio_tpu_torch.server import supervisor as sup_mod

    host = args.ip if args.ip != "0.0.0.0" else "127.0.0.1"
    specs = [
        sup_mod.ServiceSpec(name=name, argv=argv, host=host, port=port)
        for name, argv, port in plan
    ]
    try:
        retrain = _retrain_scheduler(args, plan, host)
    except ValueError as e:
        print(f"supervise: {e}", file=sys.stderr)
        return 1
    sup = sup_mod.Supervisor(specs, retrain=retrain)

    def _request_stop(signum, _frame):
        sup.request_stop()

    signal.signal(signal.SIGTERM, _request_stop)
    signal.signal(signal.SIGINT, _request_stop)

    stats = None
    stats_port = getattr(args, "supervise_port", 0) or 0
    if stats_port:
        stats = sup_mod.stats_app(sup, host=host, port=stats_port)
        stats.start(background=True)
        print(f"supervisor: stats on http://{host}:{stats_port}/stats.json")
    try:
        sup.start_all()
    except Exception as e:
        print(f"supervise: {e}", file=sys.stderr)
        sup.stop()
        if stats is not None:
            stats.stop()
        return 1
    for name, doc in sup.services().items():
        print(
            f"{name}: {doc['state']} on port {doc['port']} (pid {doc['pid']})"
        )
    if retrain is not None:
        mode = "SLO-adaptive" if retrain.slo_driven else "fixed"
        print(
            f"retrain: every {retrain.base_interval_s:.0f}s ({mode}) -> "
            f"{len(retrain.engine_ports)} engine(s)"
        )
    print(f"Run dir: {daemon.run_dir()} (supervised; ^C or SIGTERM to stop)",
          flush=True)
    try:
        sup.run()
    finally:
        if stats is not None:
            stats.stop()
    return 0


def cmd_rolling_restart(args) -> int:
    """``rolling-restart <service>``: zero-downtime replacement of a
    recorded daemon — new instance overlaps on the same port via
    SO_REUSEPORT, must pass /readyz, then the old one drains out.

    ``rolling-restart engineserver`` walks the whole engine replica set
    (``engine`` and every ``engine-<i>``) ONE replica at a time."""
    import re

    from predictionio_tpu_torch.cli import daemon

    if args.service in ("engineserver", "engines"):
        names = [
            n for n in daemon.known_services()
            if n == "engine" or re.fullmatch(r"engine-\d+", n)
        ]
        if not names:
            print(
                "rolling-restart: no running engine replicas recorded",
                file=sys.stderr,
            )
            return 1
    else:
        names = [args.service]
    for name in names:
        try:
            info = daemon.rolling_restart(name, wait=args.wait)
        except RuntimeError as e:
            print(f"rolling-restart: {e}", file=sys.stderr)
            return 1
        print(
            f"{info['service']}: rolled pid {info['old_pid']} -> "
            f"{info['new_pid']} on port {info['port']} "
            f"(instance {info['instance']})"
        )
    return 0


def cmd_stop_all(args) -> int:
    """Tear down everything start-all recorded (reference bin/pio-stop-all)."""
    from predictionio_tpu_torch.cli import daemon

    stopped = 0
    # reverse bring-up order: engine first, event server last
    for name in reversed(daemon.known_services()):
        if daemon.stop_service(name):
            print(f"{name}: stopped")
            stopped += 1
    if not stopped:
        print("Nothing to stop.")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m predictionio_tpu_torch.cli.main",
        description="PredictionIO on PyTorch/CUDA",
    )
    sub = p.add_subparsers(dest="command", required=True)
    sub.add_parser("version", help="print the package version").set_defaults(fn=cmd_version)
    st = sub.add_parser("status", help="storage, devices, the event codec "
                        "and the daemons")
    st.add_argument(
        "--json", action="store_true",
        help="one compact JSON line merging /metrics + /stats.json + "
        "/slo.json from the running daemons with supervisor.json",
    )
    st.set_defaults(fn=cmd_status)

    a = sub.add_parser("app", help="manage apps and their channels")
    asub = a.add_subparsers(dest="app_command")
    for name in ("new", "show", "delete", "data-delete"):
        ap = asub.add_parser(name)
        ap.add_argument("name")
        if name == "new":
            ap.add_argument("--id", type=int, default=0)
            ap.add_argument("--description")
            ap.add_argument("--access-key", default="")
        if name == "data-delete":
            ap.add_argument("--channel")
    asub.add_parser("list")
    for name in ("channel-new", "channel-delete"):
        cp = asub.add_parser(name)
        cp.add_argument("name")
        cp.add_argument("channel")
    a.set_defaults(fn=cmd_app)

    ak = sub.add_parser("accesskey", help="manage access keys")
    aksub = ak.add_subparsers(dest="ak_command")
    akn = aksub.add_parser("new")
    akn.add_argument("app_name")
    akn.add_argument("--event", action="append")
    akl = aksub.add_parser("list")
    akl.add_argument("app_name", nargs="?")
    akd = aksub.add_parser("delete")
    akd.add_argument("key")
    ak.set_defaults(fn=cmd_accesskey)

    es = sub.add_parser("eventserver", help="serve the event API")
    es.add_argument("--ip", default="0.0.0.0")
    es.add_argument("--port", type=int, default=7070)
    es.add_argument("--stats", action="store_true",
                    help="serve /stats.json (ingest counts per app)")
    es.add_argument(
        "--workers", type=int, default=1,
        help="ingest processes sharing the port via SO_REUSEPORT "
        "(storage appends are cross-process locked)",
    )
    es.add_argument("--reuse-port", action="store_true")
    es.set_defaults(fn=cmd_eventserver)

    rt = sub.add_parser(
        "route",
        help="scale-out router tier over a set of engine replicas",
    )
    rt.add_argument("--ip", default="0.0.0.0")
    rt.add_argument("--port", type=int, default=8100)
    rt.add_argument(
        "--replica", action="append", metavar="[NAME=]HOST:PORT",
        help="one backend engine replica (repeatable)",
    )
    rt.add_argument(
        "--replicas", type=int, default=0, metavar="N",
        help="route to N replicas on consecutive ports starting at "
        "--engine-port (names engine-0..engine-N-1, matching what "
        "`start-all --replicas N` spawns)",
    )
    rt.add_argument("--engine-host", default="127.0.0.1")
    rt.add_argument("--engine-port", type=int, default=8000)
    rt.add_argument(
        "--probe-interval", type=float, default=0.0, metavar="SECONDS",
        help="replica /readyz probe interval (default "
        "PIO_ROUTER_PROBE_INTERVAL_S or 1.0)",
    )
    rt.add_argument(
        "--no-hedge", action="store_true",
        help="disable hedged requests (equivalent to PIO_ROUTER_HEDGE=0)",
    )
    rt.add_argument("--reuse-port", action="store_true")
    rt.set_defaults(fn=cmd_route)

    ex = sub.add_parser("export", help="write an app's events as JSON lines")
    ex.add_argument("--appid-or-name", required=True)
    ex.add_argument("--output", required=True)
    ex.add_argument("--channel")
    ex.set_defaults(fn=cmd_export)

    im = sub.add_parser("import", help="load JSON-lines events into an app")
    im.add_argument("--appid-or-name", required=True)
    im.add_argument("--input", required=True)
    im.add_argument("--channel")
    im.add_argument(
        "--jobs", type=int, default=None,
        help="decode/append worker threads for the bulk import "
        "(default: PIO_IMPORT_JOBS env or min(4, cpus); 1 = sequential)",
    )
    im.add_argument(
        "--warm-cache", action="store_true",
        help="build the columnar segment cache after the import, so the "
        "first training read maps column blocks (jsonl, partitioned)",
    )
    im.add_argument(
        "--http", metavar="URL", default=None,
        help="import over the wire: POST the file as binary frames to "
        "URL/batch/events.bin on a live event server instead of writing "
        "storage directly (requires --access-key)",
    )
    im.add_argument(
        "--access-key", default=None,
        help="access key for --http mode (the target app's key)",
    )
    im.set_defaults(fn=cmd_import)

    u = sub.add_parser("undeploy", help="stop a deployed engine server")
    u.add_argument("--ip", default="0.0.0.0")
    u.add_argument("--port", type=int, default=8000)
    u.set_defaults(fn=cmd_undeploy)

    t = sub.add_parser("train", help="train an engine and record an instance")
    t.add_argument("--variant", help="engine.json (engineFactory, params, id)")
    t.add_argument("--engine-id", help="instance engine id (default: the "
                   "variant's id, else its directory)")
    t.add_argument("--engine-version", help="instance engine version "
                   "(default: the variant's version, else 0)")
    t.add_argument("--batch", default="", help="batch label of the instance")
    t.add_argument("--skip-sanity-check", action="store_true")
    t.add_argument("--stop-after-read", action="store_true")
    t.add_argument("--stop-after-prepare", action="store_true")
    t.add_argument(
        "--warm-start", action="store_true",
        help="start from the latest COMPLETED instance's model of this "
        "engine identity instead of random factors (an incompatible "
        "model -- changed rank or storage dtype -- falls back to a cold "
        "start with a warning)",
    )
    t.add_argument(
        "--tol", type=float, metavar="T",
        help="stop iterating when the per-iteration train RMSE improves "
        "by less than T",
    )
    t.add_argument(
        "--no-prep-cache", action="store_true",
        help="skip the packed-prep cache and rebuild the training batch "
        "and bucket layout from the event log (sets PIO_PREP_CACHE=0)",
    )
    t.add_argument(
        "--prep-cache-dir", metavar="DIR",
        help="where packed-prep cache entries live (sets "
        "PIO_PREP_CACHE_DIR; default ~/.pio_tpu/prep_cache)",
    )
    t.add_argument(
        "--no-columnar-cache", action="store_true",
        help="read training events from the row logs instead of the "
        "columnar segment cache (sets PIO_COLUMNAR_CACHE=0 for this run)",
    )
    t.add_argument(
        "--checkpoint-every", type=int, metavar="N",
        help="snapshot the ALS factor carry atomically every N "
        "iterations so a killed run can resume (sets "
        "PIO_CHECKPOINT_EVERY)",
    )
    t.add_argument(
        "--resume", action="store_true",
        help="restore the latest checkpoint whose data fingerprint "
        "matches this run and continue bit-identically from its "
        "iteration (sets PIO_RESUME=1; no-op when none matches)",
    )
    t.add_argument(
        "--checkpoint-dir", metavar="DIR",
        help="where checkpoints live (sets PIO_CHECKPOINT_DIR; "
        "default ~/.pio_tpu/checkpoints)",
    )
    t.add_argument(
        "--device", default=None,
        help="torch device to train on (default: cuda; cpu runs the "
        "kernels' plain versions)",
    )
    t.set_defaults(fn=cmd_train)
    ev = sub.add_parser("eval", help="run an evaluation sweep and record an "
                        "evaluation instance")
    ev.add_argument("evaluation_class",
                    help="dotted path of an Evaluation (or a factory of one)")
    ev.add_argument("engine_params_generator_class", nargs="?",
                    help="dotted path of an EngineParamsGenerator (or a "
                    "factory of one)")
    ev.add_argument("--batch", default="", help="batch label of the instance")
    ev.add_argument(
        "--device", default=None,
        help="torch device to evaluate on (default: cuda; cpu runs the "
        "kernels' plain versions)",
    )
    ev.set_defaults(fn=cmd_eval)
    d = sub.add_parser("deploy", help="serve an engine instance over HTTP")
    d.add_argument("--engine-instance-id")
    d.add_argument("--variant", help="engine.json of the instance to deploy")
    d.add_argument("--ip", default="0.0.0.0")
    d.add_argument("--port", type=int, default=8000)
    d.add_argument(
        "--device", default=None,
        help="torch device to score on (default: cuda; cpu runs the "
        "kernels' plain versions)",
    )
    d.add_argument(
        "--no-warmup", action="store_true",
        help="skip the warmup query scored before the port binds",
    )
    d.add_argument("--feedback", action="store_true",
                   help="POST a predict event per query back to the event "
                   "server")
    d.add_argument("--event-server-ip", default="0.0.0.0")
    d.add_argument("--event-server-port", type=int, default=7070)
    d.add_argument("--accesskey", help="event server access key (feedback)")
    d.add_argument("--server-config", help="server.conf path (key auth / SSL)")
    d.add_argument("--log-url",
                   help="POST serving errors to this URL (reference --log-url)")
    d.add_argument("--log-prefix",
                   help="prefix prepended to remote log payloads")
    d.add_argument(
        "--batch-window-ms", type=float, default=0.0,
        help="micro-batch concurrent queries into one batched kernel call "
        "(0 = per-request serving); the window is waited only when a "
        "measured device round trip costs more than it",
    )
    d.add_argument(
        "--workers", type=int, default=1,
        help="server processes sharing the port via SO_REUSEPORT, each a "
        "fresh interpreter with its own CUDA context and model copy "
        "(needs an explicit --port)",
    )
    d.add_argument(
        "--reuse-port", action="store_true",
        help="bind with SO_REUSEPORT (for an external supervisor running "
        "several processes)",
    )
    d.add_argument(
        "--query-cache-mb", type=float, default=0.0, metavar="MB",
        help="cache preserialized query responses in this many MB, "
        "invalidated exactly on every /reload via the epoch fence "
        "(0 = disabled); engines opt out per query via cacheable_query",
    )
    d.add_argument(
        "--realtime", type=float, default=0.0, metavar="SECONDS",
        help="enable the speed layer: tail the app's event stream every "
        "SECONDS and fold new rating events into the live model between "
        "retrains (0 = batch-only serving)",
    )
    d.add_argument(
        "--realtime-cursor",
        help="durable tailer cursor file (default: "
        "~/.pio_tpu/realtime/cursor_<engine>_<port>.json)",
    )
    d.add_argument(
        "--variants", metavar="A.JSON,B.JSON",
        help="mount additional trained engine variants in this process, "
        "routed by path prefix (/<name>/queries.json, name = file "
        "basename minus .json) or the X-PIO-Variant header",
    )
    d.set_defaults(fn=cmd_deploy)

    ca = sub.add_parser(
        "cache", help="packed-prep cache lifecycle (list / evict / prune)"
    )
    casub = ca.add_subparsers(dest="cache_verb")
    cl = casub.add_parser("list", help="entries, LRU order, sizes")
    cl.add_argument("--json", action="store_true")
    ce = casub.add_parser("evict", help="drop one entry by name")
    ce.add_argument("entry", help="entry name from `cache list`")
    cp = casub.add_parser("prune", help="sweep tmp husks + enforce the size budget")
    cp.add_argument(
        "--max-mb", type=float, default=None,
        help="override PIO_PREP_CACHE_MAX_MB for this prune",
    )
    cp.add_argument("--json", action="store_true")
    ca.set_defaults(fn=cmd_cache, json=False, max_mb=None)

    def _fleet_args(parser) -> None:
        parser.add_argument("--ip", default="0.0.0.0")
        parser.add_argument("--event-port", type=int, default=7070)
        parser.add_argument("--engine-port", type=int, default=8000)
        parser.add_argument("--stats", action="store_true")
        parser.add_argument(
            "--no-dashboard", action="store_true",
            help="required: the dashboard is a later slice of the port",
        )
        parser.add_argument(
            "--no-adminserver", action="store_true",
            help="required: the admin server is a later slice of the port",
        )
        parser.add_argument("--variant", help="also deploy this engine variant")
        parser.add_argument(
            "--engine-factory",
            help="also deploy this engine factory: a later slice of the "
            "port (raises)",
        )
        parser.add_argument(
            "--engine-dir",
            help="also deploy the engine in this dir: a later slice of the "
            "port (raises)",
        )
        parser.add_argument(
            "--variants", metavar="A.JSON,B.JSON",
            help="co-mount these trained engine variants in the "
            "deployed engine process (see deploy --variants)",
        )
        parser.add_argument(
            "--device", default=None,
            help="torch device of the deployed engine and the scheduled "
            "train (default: cuda; cpu runs the kernels' plain versions)",
        )
        parser.add_argument(
            "--supervise-port", type=int, default=0,
            help="with --supervise: serve supervisor /stats.json and "
            "/metrics on this port",
        )
        parser.add_argument(
            "--replicas", type=int, default=0, metavar="N",
            help="deploy the engine as N replicas on consecutive ports "
            "starting at --engine-port, fronted by the `route` router "
            "tier on --router-port",
        )
        parser.add_argument(
            "--router-port", type=int, default=8100,
            help="router-tier port used with --replicas",
        )
        parser.add_argument(
            "--retrain-every", metavar="DUR", default=None,
            help="with --supervise: run a warm `train` + engine /reload "
            "on this cadence (e.g. 300s, 15m, 1h)",
        )
        parser.add_argument(
            "--retrain-slo", action="store_true",
            help="adapt the retrain cadence to the serving.freshness "
            "SLO burn rate (halve while burning, decay back when ok)",
        )
        parser.add_argument(
            "--retrain-floor", metavar="DUR", default=None,
            help="shortest adaptive retrain interval "
            "(default: --retrain-every / 8)",
        )
        parser.add_argument(
            "--retrain-tol", type=float, default=None, metavar="T",
            help="pass --tol T to the scheduled warm trains "
            "(early-stop on an RMSE plateau)",
        )

    sa = sub.add_parser("start-all", help="bring the service fleet up")
    _fleet_args(sa)
    sa.add_argument(
        "--supervise", action="store_true",
        help="stay in the foreground and restart crashed services "
        "with backoff",
    )
    sa.set_defaults(fn=cmd_start_all)

    sv = sub.add_parser(
        "supervise", help="start-all under the self-healing supervisor"
    )
    _fleet_args(sv)
    sv.set_defaults(fn=cmd_start_all, supervise=True)

    rr = sub.add_parser(
        "rolling-restart",
        help="zero-downtime replacement of one recorded service",
    )
    rr.add_argument("service", help="a service name from `status`")
    rr.add_argument(
        "--wait", type=float, default=90.0,
        help="seconds to wait for the replacement's /readyz (default 90)",
    )
    rr.set_defaults(fn=cmd_rolling_restart)

    sub.add_parser(
        "stop-all", help="stop every daemon the run dir records"
    ).set_defaults(fn=cmd_stop_all)
    return p


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(
        level=os.environ.get("PIO_LOG_LEVEL", "INFO"),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    args = build_parser().parse_args(argv)
    # the command line as given: what `--workers N` re-runs in each worker
    args.argv = list(sys.argv[1:] if argv is None else argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
