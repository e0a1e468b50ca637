"""CLI command implementations (reference tools/.../commands/*.scala).

Port of ``predictionio_tpu/cli/commands.py``: the app, channel and access
key commands, ``export``, ``import`` (from a file into storage, or over
HTTP as binary frames) and ``status``. Every record and event they write
is read back the same by the JAX package, and the reverse. ``import``
splices validated lines straight into a store that has ``append_jsonl``
(:func:`_splice_import_chunk`); the stores the port has so far (sqlite,
memory) do not, so it decodes and inserts through ``_flush_slow``.
``status`` lists the torch devices where the JAX package lists
``jax.devices()``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any

from predictionio_tpu_torch.data.storage import (
    AccessKey,
    App,
    Channel,
    Storage,
    get_storage,
)

logger = logging.getLogger(__name__)


class CommandError(RuntimeError):
    pass


# -- app commands (commands/App.scala) --------------------------------------


def app_new(
    name: str,
    app_id: int = 0,
    description: str | None = None,
    access_key: str = "",
    storage: Storage | None = None,
) -> dict[str, Any]:
    storage = storage or get_storage()
    apps = storage.get_metadata_apps()
    if apps.get_by_name(name) is not None:
        raise CommandError(f"App {name} already exists. Aborting.")
    new_id = apps.insert(App(app_id, name, description))
    if new_id is None:
        raise CommandError(f"Unable to create new app (id {app_id} taken?).")
    storage.get_events().init(new_id)
    key = storage.get_metadata_access_keys().insert(
        AccessKey(access_key, appid=new_id)
    )
    if key is None:
        raise CommandError("Unable to create new access key.")
    return {"id": new_id, "name": name, "access_key": key}


def app_list(storage: Storage | None = None) -> list[dict[str, Any]]:
    storage = storage or get_storage()
    keys = storage.get_metadata_access_keys()
    out = []
    for app in storage.get_metadata_apps().get_all():
        app_keys = keys.get_by_appid(app.id)
        out.append(
            {
                "id": app.id,
                "name": app.name,
                "description": app.description,
                "access_key": app_keys[0].key if app_keys else "",
            }
        )
    return out


def app_show(name: str, storage: Storage | None = None) -> dict[str, Any]:
    storage = storage or get_storage()
    app = storage.get_metadata_apps().get_by_name(name)
    if app is None:
        raise CommandError(f"App {name} does not exist. Aborting.")
    keys = storage.get_metadata_access_keys().get_by_appid(app.id)
    channels = storage.get_metadata_channels().get_by_appid(app.id)
    return {
        "id": app.id,
        "name": app.name,
        "description": app.description,
        "access_keys": [{"key": k.key, "events": k.events} for k in keys],
        "channels": [{"id": c.id, "name": c.name} for c in channels],
    }


def app_delete(name: str, storage: Storage | None = None) -> None:
    storage = storage or get_storage()
    app = storage.get_metadata_apps().get_by_name(name)
    if app is None:
        raise CommandError(f"App {name} does not exist. Aborting.")
    events = storage.get_events()
    for ch in storage.get_metadata_channels().get_by_appid(app.id):
        events.remove(app.id, ch.id)
        storage.get_metadata_channels().delete(ch.id)
    events.remove(app.id)
    for key in storage.get_metadata_access_keys().get_by_appid(app.id):
        storage.get_metadata_access_keys().delete(key.key)
    storage.get_metadata_apps().delete(app.id)


def app_data_delete(
    name: str, channel: str | None = None, storage: Storage | None = None
) -> None:
    storage = storage or get_storage()
    app = storage.get_metadata_apps().get_by_name(name)
    if app is None:
        raise CommandError(f"App {name} does not exist. Aborting.")
    events = storage.get_events()
    if channel is None:
        events.remove(app.id)
        events.init(app.id)
        return
    chans = [
        c
        for c in storage.get_metadata_channels().get_by_appid(app.id)
        if c.name == channel
    ]
    if not chans:
        raise CommandError(f"Channel {channel} does not exist. Aborting.")
    events.remove(app.id, chans[0].id)
    events.init(app.id, chans[0].id)


def channel_new(
    app_name: str, channel_name: str, storage: Storage | None = None
) -> dict[str, Any]:
    storage = storage or get_storage()
    app = storage.get_metadata_apps().get_by_name(app_name)
    if app is None:
        raise CommandError(f"App {app_name} does not exist. Aborting.")
    if not Channel.is_valid_name(channel_name):
        raise CommandError(
            f"Unable to create new channel. The channel name {channel_name} is "
            "invalid (1-16 alphanumeric or '-' characters)."
        )
    channel_id = storage.get_metadata_channels().insert(
        Channel(0, channel_name, app.id)
    )
    if channel_id is None:
        raise CommandError(f"Channel {channel_name} already exists. Aborting.")
    storage.get_events().init(app.id, channel_id)
    return {"id": channel_id, "name": channel_name, "app_id": app.id}


def channel_delete(
    app_name: str, channel_name: str, storage: Storage | None = None
) -> None:
    storage = storage or get_storage()
    app = storage.get_metadata_apps().get_by_name(app_name)
    if app is None:
        raise CommandError(f"App {app_name} does not exist. Aborting.")
    chans = [
        c
        for c in storage.get_metadata_channels().get_by_appid(app.id)
        if c.name == channel_name
    ]
    if not chans:
        raise CommandError(f"Channel {channel_name} does not exist. Aborting.")
    storage.get_events().remove(app.id, chans[0].id)
    storage.get_metadata_channels().delete(chans[0].id)


# -- access key commands (commands/AccessKey.scala) -------------------------


def accesskey_new(
    app_name: str,
    key: str = "",
    events: list[str] | None = None,
    storage: Storage | None = None,
) -> str:
    storage = storage or get_storage()
    app = storage.get_metadata_apps().get_by_name(app_name)
    if app is None:
        raise CommandError(f"App {app_name} does not exist. Aborting.")
    created = storage.get_metadata_access_keys().insert(
        AccessKey(key, appid=app.id, events=list(events or []))
    )
    if created is None:
        raise CommandError("Unable to create new access key.")
    return created


def accesskey_list(
    app_name: str | None = None, storage: Storage | None = None
) -> list[dict[str, Any]]:
    storage = storage or get_storage()
    keys = storage.get_metadata_access_keys()
    if app_name is None:
        all_keys = keys.get_all()
    else:
        app = storage.get_metadata_apps().get_by_name(app_name)
        if app is None:
            raise CommandError(f"App {app_name} does not exist. Aborting.")
        all_keys = keys.get_by_appid(app.id)
    return [{"key": k.key, "app_id": k.appid, "events": k.events} for k in all_keys]


def accesskey_delete(key: str, storage: Storage | None = None) -> None:
    storage = storage or get_storage()
    if not storage.get_metadata_access_keys().delete(key):
        raise CommandError(f"Access key {key} does not exist. Aborting.")


def _resolve_app_name(appid_or_name: str, storage: Storage) -> str:
    """Accept an app name or a numeric app id (reference --appid flag)."""
    apps = storage.get_metadata_apps()
    if apps.get_by_name(appid_or_name) is not None:
        return appid_or_name
    if appid_or_name.isdigit():
        app = apps.get(int(appid_or_name))
        if app is not None:
            return app.name
    raise CommandError(f"App {appid_or_name} does not exist. Aborting.")


# -- export / import (tools/export/EventsToFile.scala, imprt/FileToEvents) --


def export_events(
    app_name: str,
    output_path: str,
    channel: str | None = None,
    storage: Storage | None = None,
) -> int:
    """Dump an app's events as JSON-lines (one event per line).

    Backends whose storage format is already the wire format (jsonl,
    partitioned) stream their replay-clean logs verbatim
    (``export_jsonl`` -- no per-event Python objects, the inverse of the
    import splice); others serialize through the Event model."""
    from predictionio_tpu_torch.data import store

    storage = storage or get_storage()
    app_name = _resolve_app_name(app_name, storage)
    events_dao = storage.get_events()
    fast = getattr(events_dao, "export_jsonl", None)
    if fast is not None:
        app_id, channel_id = store.app_name_to_id(app_name, channel, storage)
        with open(output_path, "wb") as f:
            n = fast(app_id, channel_id, f)
        if n is not None:
            return n
        # capability probe said no (http backend whose backing store
        # can't splice-export): fall through to the per-event path
    events = store.find(app_name, channel_name=channel, storage=storage)
    with open(output_path, "w") as f:
        for e in events:
            f.write(json.dumps(e.to_dict(for_api=False), sort_keys=True) + "\n")
    return len(events)


def _positions_in_spans(chunk: bytes, pattern: bytes, starts, ends):
    """Boolean per-span mask: does any occurrence of ``pattern`` in
    ``chunk`` fall inside [starts, ends)? Vectorized via one global find
    pass + searchsorted (occurrences are rare; spans are many)."""
    import numpy as np

    hits = []
    pos = chunk.find(pattern)
    while pos >= 0:
        hits.append(pos)
        pos = chunk.find(pattern, pos + 1)
    if not hits:
        return np.zeros(len(starts), dtype=bool)
    hp = np.asarray(hits, dtype=np.int64)
    return np.searchsorted(hp, starts) < np.searchsorted(hp, ends)


def _splice_import_chunk(chunk: bytes, now_iso: str):
    """Validated splice-through for one line-aligned JSONL chunk.

    The import wire format and the jsonl storage format are the same, so
    a line that passes the (vectorized, span-level) validation rules of
    ``data.event.validate`` can be appended verbatim with eventId /
    creationTime spliced in -- no Event object, no re-serialization.
    Returns (blob_to_append: bytes, fallback_lines: list[bytes]); lines
    that fail any cheap check take the full parse+validate path instead.
    """
    import binascii

    import numpy as np

    from predictionio_tpu_torch import native

    sc = native.scan_events(chunk)
    n = len(sc)
    a8 = np.frombuffer(chunk, dtype=np.uint8)
    # line spans (scanner counts lines the same way: split on \n)
    nl = np.flatnonzero(a8 == 0x0A)
    starts = np.concatenate([[0], nl + 1])[:n]
    ends = np.concatenate([nl, [len(chunk)]])[:n]

    offs, lens = sc.offs, sc.lens

    def first_byte(field):
        o = offs[:, field]
        return np.where(o >= 0, a8[np.clip(o, 0, len(a8) - 1)], 0)

    def has_prefix(field, prefix: bytes):
        """span starts with prefix (False where absent/short)."""
        o, ln = offs[:, field], lens[:, field]
        ok = (o >= 0) & (ln >= len(prefix))
        out = ok.copy()
        for j, byte in enumerate(prefix):
            out &= np.where(
                ok, a8[np.clip(o + j, 0, len(a8) - 1)] == byte, False
            )
        return out

    ok = sc.flags == 0
    # any "$delete" byte sequence anywhere in the line punts to the slow
    # path: appended verbatim, a top-level {"$delete": id} key would act
    # as a jsonl delete MARKER on replay -- deleting an attacker-chosen
    # existing event. The slow path's Event.from_dict drops unknown keys.
    ok &= ~_positions_in_spans(chunk, b'"$delete"', starts, ends)
    ok &= (offs[:, native.F_EVENT] >= 0) & (lens[:, native.F_EVENT] > 0)
    ok &= (offs[:, native.F_ENTITY_TYPE] >= 0) & (lens[:, native.F_ENTITY_TYPE] > 0)
    ok &= (offs[:, native.F_ENTITY_ID] >= 0) & (lens[:, native.F_ENTITY_ID] > 0)
    # reserved names: any $-event or pio_ prefix goes to the slow path
    # (full validate decides builtin vs illegal)
    ok &= first_byte(native.F_EVENT) != ord("$")
    ok &= ~has_prefix(native.F_EVENT, b"pio_")
    ok &= ~has_prefix(native.F_ENTITY_TYPE, b"pio_")
    ok &= ~has_prefix(native.F_TARGET_ENTITY_TYPE, b"pio_")
    # target type/id specified together, both non-empty when present
    t_type, t_id = offs[:, native.F_TARGET_ENTITY_TYPE], offs[:, native.F_TARGET_ENTITY_ID]
    ok &= (t_type >= 0) == (t_id >= 0)
    ok &= (t_type < 0) | (lens[:, native.F_TARGET_ENTITY_TYPE] > 0)
    ok &= (t_id < 0) | (lens[:, native.F_TARGET_ENTITY_ID] > 0)
    # eventTime must be on the wire AND parseable -- an unparseable time
    # appended verbatim would poison every later read of the log
    ok &= offs[:, native.F_EVENT_TIME] >= 0
    ok &= ~np.isnan(
        native.parse_times(
            chunk, offs[:, native.F_EVENT_TIME], lens[:, native.F_EVENT_TIME]
        )
    )
    ct_present = offs[:, native.F_CREATION_TIME] >= 0
    ok &= ~ct_present | ~np.isnan(
        native.parse_times(
            chunk, offs[:, native.F_CREATION_TIME], lens[:, native.F_CREATION_TIME]
        )
    )
    # property keys may not use the pio_/$ reserved prefixes; a cheap
    # conservative substring test sends suspects to the full validator.
    # Any backslash in the properties span also punts to the validator:
    # JSON escapes (pio_x) could smuggle a reserved key past a raw
    # byte test
    p_off, p_len = offs[:, native.F_PROPERTIES], lens[:, native.F_PROPERTIES]
    p_start = np.where(p_off >= 0, p_off, 0).astype(np.int64)
    p_end = p_start + np.where(p_off >= 0, p_len, 0)
    suspicious = _positions_in_spans(chunk, b'"pio_', p_start, p_end)
    suspicious |= _positions_in_spans(chunk, b'"$', p_start, p_end)
    suspicious |= _positions_in_spans(chunk, b"\\", p_start, p_end)
    ok &= ~((p_off >= 0) & suspicious)

    ok_ix = np.flatnonzero(ok)
    # pre-generate random hex event ids for lines that lack one
    need_id = offs[ok_ix, native.F_EVENT_ID] < 0
    hexpool = binascii.hexlify(np.random.default_rng().bytes(16 * int(need_id.sum())))
    ct_suffix = (',"creationTime":"%s"' % now_iso).encode()
    fallback = [
        chunk[starts[i] : ends[i]]
        for i in np.flatnonzero(~ok & (sc.flags & native.FLAG_EMPTY == 0))
    ]
    # assemble the blob in one native pass (the per-line Python loop was
    # ~40% of import wall-clock at 2M events); falls back to the loop in
    # degraded no-native mode
    need_ct = offs[ok_ix, native.F_CREATION_TIME] < 0
    blob = native.splice_lines(
        chunk, starts[ok_ix], ends[ok_ix], need_id, need_ct,
        bytes(hexpool), ct_suffix,
    )
    if blob is not None:
        return blob, len(ok_ix), fallback
    out: list[bytes] = []
    id_i = 0
    for row, wants_id in zip(ok_ix, need_id):
        line = chunk[starts[row] : ends[row]].rstrip()
        tail = b""
        if wants_id:
            eid = hexpool[32 * id_i : 32 * id_i + 32]
            id_i += 1
            tail += b',"eventId":"' + eid + b'"'
        if offs[row, native.F_CREATION_TIME] < 0:
            tail += ct_suffix
        out.append(line[:-1] + tail + b"}" if tail else line)
    return b"\n".join(out), len(out), fallback


def import_events(
    app_name: str,
    input_path: str,
    channel: str | None = None,
    storage: Storage | None = None,
    jobs: int | None = None,
) -> int:
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from datetime import datetime, timezone

    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.event import validate
    from predictionio_tpu_torch.data.storage import colspans

    storage = storage or get_storage()
    app_name = _resolve_app_name(app_name, storage)
    app_id, channel_id = store.app_name_to_id(app_name, channel, storage)
    events_dao = storage.get_events()
    # jsonl backends take the splice-through path: wire format == storage
    # format, so validated lines append verbatim (no Event round trip) --
    # the 10^7-events/minute bulk-load path (reference FileToEvents runs
    # this load as a Spark job, tools/.../imprt/FileToEvents.scala:34-106)
    # The dict holds it so the pooled workers below can demote to the
    # slow path exactly once, without a shared nonlocal rebind race.
    splice = {"fn": getattr(events_dao, "append_jsonl", None)}
    now_iso = (
        datetime.now(timezone.utc).isoformat(timespec="milliseconds")
        .replace("+00:00", "Z")
    )
    if jobs is None:
        jobs = int(os.environ.get("PIO_IMPORT_JOBS", "0") or 0)
    if jobs <= 0:
        # the chunk pipeline overlaps native splice parse (GIL released)
        # with the storage appends' fsyncs; past a few workers the disk
        # is the bottleneck, so the default stays modest
        jobs = min(4, os.cpu_count() or 1)

    def _flush_slow(data: bytes | list[bytes]) -> int:
        if isinstance(data, list):
            data = b"\n".join(data)
        # shared span-scanning decoder (data/storage/colspans.py -- the
        # same one under the columnar cache and the tail path) decodes
        # the fixed wire fields without a per-line DOM parse (json
        # fallback for flagged lines inside)
        events = colspans.parse_events(data)
        done = 0
        for start in range(0, len(events), 500):
            batch = events[start : start + 500]
            for event in batch:
                validate(event)
            events_dao.batch_insert(batch, app_id, channel_id)
            done += len(batch)
        return done

    def _flush(data: bytes) -> int:
        fn = splice["fn"]
        if fn is None:
            return _flush_slow(data)
        done = 0
        blob, n_spliced, fallback = _splice_import_chunk(data, now_iso)
        if blob:
            try:
                fn(blob, app_id, channel_id)
                done += n_spliced
            except NotImplementedError:
                # http backend whose storage service can't splice:
                # degrade to per-event inserts for the rest of the run
                splice["fn"] = None
                done += _flush_slow(blob)
        if fallback:
            done += _flush_slow(fallback)
        return done

    # stream line-aligned chunks so peak memory stays bounded for
    # multi-GB event files; with jobs > 1 the chunks decode + append on
    # a thread pool (append order across chunks is immaterial: replay is
    # last-write-wins per event id and import lines carry unique ids),
    # with in-flight submissions bounded so a fast reader can't buffer
    # the whole file
    chunk_size = 8 << 20
    carry = b""
    futures: list = []
    inflight = threading.BoundedSemaphore(jobs * 2)

    def _run(data: bytes) -> int:
        try:
            return _flush(data)
        finally:
            inflight.release()

    def _submit(pool, data: bytes) -> None:
        if pool is None:
            futures.append(_flush(data))
        else:
            inflight.acquire()
            futures.append(pool.submit(_run, data))

    pool = ThreadPoolExecutor(max_workers=jobs) if jobs > 1 else None
    try:
        with open(input_path, "rb") as f:
            while True:
                chunk = f.read(chunk_size)
                if not chunk:
                    break
                chunk = carry + chunk
                cut = chunk.rfind(b"\n")
                if cut < 0:
                    carry = chunk
                    continue
                carry = chunk[cut + 1 :]
                _submit(pool, chunk[: cut + 1])
        if carry.strip():
            _submit(pool, carry)
        return sum(
            f if isinstance(f, int) else f.result() for f in futures
        )
    finally:
        if pool is not None:
            pool.shutdown(wait=True)


def import_events_http(
    input_path: str,
    url: str,
    access_key: str,
    channel: str | None = None,
    frame_events: int = 2000,
) -> int:
    """Bulk import over the wire-speed binary endpoint: stream the
    jsonl file in line-aligned chunks, pack each chunk into PIF1 frames
    (data/storage/frame.py) and POST them to ``/batch/events.bin`` on a
    keep-alive connection. 429 ``IngestBackpressure`` answers are
    retried after ``Retry-After``; connection drops reconnect and
    resend (exported lines carry event ids, so a resend that overlaps a
    partially committed request replays idempotently). Every request
    carries one ``X-PIO-Trace`` id minted for the import run, so the
    server-side trace ring stitches the whole bulk ingest into one
    client-correlatable trace family (``GET /traces.json``)."""
    import http.client as _hc
    import time as _time
    from urllib.parse import quote, urlsplit

    from predictionio_tpu_torch.data.storage import frame

    parts = urlsplit(url)
    if parts.scheme not in ("", "http"):
        raise CommandError(
            f"import --http supports http:// URLs only, got {url!r}"
        )
    host = parts.hostname or "127.0.0.1"
    port = parts.port or 7070
    path = "/batch/events.bin?accessKey=" + quote(access_key)
    if channel:
        path += "&channel=" + quote(channel)
    from predictionio_tpu_torch.obs import trace as obs_trace

    headers = {
        "Content-Type": "application/octet-stream",
        obs_trace.TRACE_HEADER: obs_trace.new_trace_id(),
    }

    conn = _hc.HTTPConnection(host, port, timeout=60)
    total = 0
    skipped = 0

    def _post(body: bytes) -> None:
        nonlocal conn, total
        for attempt in range(8):
            try:
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                payload = resp.read()
            except (OSError, _hc.HTTPException):
                conn.close()
                conn = _hc.HTTPConnection(host, port, timeout=60)
                if attempt == 7:
                    raise
                continue
            if resp.status == 429:
                try:
                    delay = float(resp.getheader("Retry-After") or 1.0)
                except ValueError:
                    delay = 1.0
                _time.sleep(min(delay, 5.0))
                continue
            if resp.status != 200:
                raise CommandError(
                    f"import --http: server answered {resp.status}: "
                    f"{payload[:200]!r}"
                )
            total += int(json.loads(payload).get("accepted", 0))
            return
        raise CommandError(
            "import --http: gave up after repeated backpressure"
        )

    def _send_chunk(data: bytes) -> None:
        nonlocal skipped
        events = []
        for line in data.split(b"\n"):
            line = line.strip()
            if not line:
                continue
            if line.startswith(b'{"$delete"'):
                skipped += 1  # tombstones are storage-internal
                continue
            events.append(json.loads(line))
        if events:
            _post(frame.encode_body(events, frame_events=frame_events))

    chunk_size = 8 << 20
    carry = b""
    try:
        with open(input_path, "rb") as f:
            while True:
                chunk = f.read(chunk_size)
                if not chunk:
                    break
                chunk = carry + chunk
                cut = chunk.rfind(b"\n")
                if cut < 0:
                    carry = chunk
                    continue
                carry = chunk[cut + 1 :]
                _send_chunk(chunk[: cut + 1])
        if carry.strip():
            _send_chunk(carry)
    finally:
        conn.close()
    if skipped:
        logger.warning(
            "import --http: skipped %d $delete tombstone lines", skipped
        )
    return total


# -- status (commands/Management.scala:56-160) ------------------------------


def status(storage: Storage | None = None) -> dict[str, Any]:
    """Storage bindings, devices and the event codec's path.

    The JAX package lists ``jax.devices()`` and ``jax.default_backend()``;
    the port lists the CUDA devices torch sees (``cuda:<i>``, without
    initialising CUDA) and names ``cuda`` as the default backend when
    there is one, else ``cpu``. ``event_codec`` says whether the native
    codec's library is loaded (``native``, with its path) or the
    pure-Python codec runs (``python``)."""
    import torch

    from predictionio_tpu_torch import native

    storage = storage or get_storage()
    storage.verify_all_data_objects()
    repos = {}
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        name, typ = storage.repository_source(repo)
        repos[repo] = {"source": name, "type": typ}
    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    lib = native.library_path()
    return {
        "storage": repos,
        "devices": [f"cuda:{i}" for i in range(n_cuda)] or ["cpu"],
        "default_backend": "cuda" if n_cuda else "cpu",
        "event_codec": {
            "path": "native" if lib is not None else "python",
            "library": str(lib) if lib is not None else None,
        },
    }
