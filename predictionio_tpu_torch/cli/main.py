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
        [--ip 0.0.0.0] [--port 7070] [--stats] [--reuse-port]
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
        [--no-warmup] [--realtime SECONDS [--realtime-cursor PATH]]
    python -m predictionio_tpu_torch.cli.main undeploy [--ip IP] [--port P]
    python -m predictionio_tpu_torch.cli.main eval EVALUATION \\
        [ENGINE_PARAMS_GENERATOR] [--batch LABEL] [--device cuda|cpu]
    python -m predictionio_tpu_torch.cli.main cache \\
        {list [--json] | evict ENTRY | prune [--max-mb MB] [--json]}

Port of ``predictionio_tpu/cli/main.py`` ``cmd_version`` (:106),
``cmd_status`` (:111), ``cmd_app`` (:755), ``cmd_accesskey`` (:799),
``cmd_train`` (:843-894), ``cmd_eval`` (:900-934), ``cmd_deploy``
(:1053-1207), ``cmd_undeploy`` (:1210), ``cmd_eventserver`` (:1223),
``cmd_export`` (:1308), ``cmd_import`` (:1323) and ``cmd_cache``
(:1381), with the JAX verbs'
flags and printed lines. The app, access-key, import, export and
event-server verbs are host code (``cli/commands.py``,
``server/event_server.py``) and start no device; they write records and
events that the JAX package reads, and the reverse. ``status`` prints
the storage bindings, the torch devices, which event codec runs (the
native library or the pure-Python one) and a live training's progress
line; the JAX verb's daemon, SLO, variant and replica lines need the
daemon pid files of a later slice. ``undeploy`` POSTs ``/stop`` to a
deployed engine server.

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
ignored: ``deploy --workers N`` and ``eventserver --workers N`` (N > 1)
and ``status --json``. ``import --warm-cache`` builds the columnar
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

from predictionio_tpu_torch import __version__
from predictionio_tpu_torch.common import load_server_config
from predictionio_tpu_torch.core.context import WorkflowContext
from predictionio_tpu_torch.core.engine import (
    DEFAULT_ENGINE_FACTORY,
    WorkflowParams,
    resolve_engine_factory,
)
from predictionio_tpu_torch.core.workflow import load_variant, run_train
from predictionio_tpu_torch.core.workflow_eval import run_evaluation
from predictionio_tpu_torch.data.storage import get_storage
from predictionio_tpu_torch.server.engine_server import EngineServer


def cmd_version(args) -> int:
    print(__version__)
    return 0


def _training_line() -> str | None:
    """Human one-liner for ``status`` when a checkpointed ``train`` is
    publishing its progress: "training: iter 7/20, ETA 41s"."""
    from predictionio_tpu_torch.obs import progress as obs_progress

    doc = obs_progress.read_progress()
    if not obs_progress.is_live(doc):
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

    _check_later_slices(args)
    info = commands.status()
    print(json.dumps(info, indent=2))
    print("(sanity check) All storage repositories verified.")
    line = _training_line()
    if line:
        print(line)
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
    from predictionio_tpu_torch.server.event_server import EventServer

    _check_later_slices(args)
    server = EventServer(
        host=args.ip, port=args.port, stats=args.stats,
        reuse_port=args.reuse_port,
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

    _check_later_slices(args)
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
    _check_later_slices(args)
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
    path = (
        getattr(args, "server_config", None)
        or os.environ.get("PIO_SERVER_CONF")
        or "conf/server.conf"
    )
    return load_server_config(path=path)


def _check_later_slices(args) -> None:
    """Flags that belong to a later slice of the port raise, naming it,
    instead of being ignored."""
    if getattr(args, "workers", 1) > 1:
        if getattr(args, "command", None) == "eventserver":
            raise NotImplementedError(
                "eventserver --workers N (ingest processes sharing the port "
                "by SO_REUSEPORT, supervised by the daemon tooling) is a "
                "later slice of the PyTorch port (ROADMAP.md queue 1, item "
                "10: the CLI and the remaining host servers)"
            )
        raise NotImplementedError(
            "--workers N (server processes sharing the port) is a later "
            "slice of the PyTorch port: each process on one card needs a "
            "CUDA context and a model copy of its own, and forking after "
            "CUDA has started is unsafe (ROADMAP.md queue 1)"
        )
    if getattr(args, "command", None) == "status" and getattr(args, "json", False):
        raise NotImplementedError(
            "status --json (merging /metrics and /stats.json of the running "
            "daemons found by their pid files) is a later slice of the "
            "PyTorch port (ROADMAP.md queue 1, item 10: cli/daemon.py)"
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
    Raises LookupError when no instance matches."""
    _check_later_slices(args)
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m predictionio_tpu_torch.cli.main",
        description="PredictionIO on PyTorch/CUDA",
    )
    sub = p.add_subparsers(dest="command", required=True)
    sub.add_parser("version", help="print the package version").set_defaults(fn=cmd_version)
    st = sub.add_parser("status", help="storage, devices and the event codec")
    st.add_argument(
        "--json", action="store_true",
        help="one compact JSON line merging /metrics + /stats.json from "
        "running daemons: a later slice of the port (raises)",
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
        help="ingest processes sharing the port: a later slice of the "
        "port (N > 1 raises)",
    )
    es.add_argument("--reuse-port", action="store_true")
    es.set_defaults(fn=cmd_eventserver)

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
        help="server processes sharing the port: a later slice of the "
        "port (N > 1 raises)",
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
    return p


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(
        level=os.environ.get("PIO_LOG_LEVEL", "INFO"),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
