"""Length-prefixed binary framing for wire-speed batch ingest.

``POST /batch/events.bin`` carries a stream of independent FRAMES, each
a columnar group of events, so the event server can commit group by
group as the bytes arrive instead of materializing one giant JSON body:

    body  := magic(4, b"PIF1") frame*
    frame := u32le payload_len | payload
    payload := u32le n_events | strcol * 10

A ``strcol`` is one string column over all n events — ONE length header
and ONE blob per column instead of one JSON key/value pair per event
(the per-event dict churn the JSON batch path pays):

    strcol := u32le blob_len | u32le * n cumulative end offsets | blob

Column order (empty string = absent):

    0 event            required
    1 entityType       required
    2 entityId         required
    3 targetEntityType
    4 targetEntityId
    5 eventTime        ISO-8601; empty -> server receive stamp
    6 eventId          empty -> server-generated hex id
    7 creationTime     ISO-8601; empty -> server receive stamp
    8 properties       JSON object bytes; empty -> {}
    9 extras           wire.py typed-codec JSON for the rare per-event
                       fields (tags, prId); empty -> none

The server decodes a frame straight into the columnar layout
``batch_insert``/group-commit already wants: :meth:`FrameBatch.render_jsonl`
emits storage-format JSONL byte-identical to
``json.dumps(Event.to_dict(for_api=False))`` for the jsonl/partitioned
splice-through path (one lock+append+fsync per frame), and
:meth:`FrameBatch.to_events` builds Event objects for every other
backend. Validation mirrors ``data/event.validate`` exactly; a frame is
all-or-nothing (validate everything, then commit once), and a torn or
oversized frame raises :class:`FrameError` before any byte reaches
storage. ``faults.fault_point("http.frame")`` fires per frame read so
the chaos matrix can tear or kill mid-stream.

Port of ``predictionio_tpu/data/storage/frame.py``: the same PIF1
layout, so :func:`encode_body` gives the same bytes in both packages and
either package's event server takes the other's frames.
"""

from __future__ import annotations

import binascii
import json
import os
import re
import struct
from json.encoder import encode_basestring_ascii as _esc
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from predictionio_tpu_torch import faults
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import (
    BUILTIN_ENTITY_TYPES,
    SPECIAL_EVENTS,
    Event,
    EventValidationError,
    format_time,
    parse_time,
)
from predictionio_tpu_torch.data.storage import wire

MAGIC = b"PIF1"
N_COLUMNS = 10
(
    COL_EVENT,
    COL_ENTITY_TYPE,
    COL_ENTITY_ID,
    COL_TARGET_ENTITY_TYPE,
    COL_TARGET_ENTITY_ID,
    COL_EVENT_TIME,
    COL_EVENT_ID,
    COL_CREATION_TIME,
    COL_PROPERTIES,
    COL_EXTRAS,
) = range(N_COLUMNS)

_U32 = struct.Struct("<I")

# a storage-canonical timestamp (format_time(dt, "us")) is embedded
# verbatim after a validity parse; anything else is re-rendered
_CANON_TIME = re.compile(
    r"\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}\.\d{6}"
    r"(?:Z|[+-]\d{2}:\d{2}(?::\d{2})?)"
)


def max_frame_bytes() -> int:
    """Per-frame payload cap (``PIO_FRAME_MAX_MB``, default 32)."""
    try:
        mb = float(os.environ.get("PIO_FRAME_MAX_MB", "32") or 32)
    except ValueError:
        mb = 32.0
    return max(1, int(mb * (1 << 20)))


class FrameError(ValueError):
    """Malformed framing — the whole request is rejected atomically
    (already-committed earlier frames stay committed; the erroring frame
    never reaches storage). ``code`` is the stable machine-readable name
    surfaced in the HTTP error body."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


class FrameEventError(FrameError):
    """An event inside an otherwise well-formed frame failed validation;
    ``index`` is its position within the frame."""

    def __init__(self, index: int, message: str):
        super().__init__("InvalidEvent", f"event[{index}]: {message}")
        self.index = index


# -- client side -------------------------------------------------------------


def encode_frame(events: Sequence[Mapping[str, Any]]) -> bytes:
    """One length-prefixed frame from API-shaped event dicts (the same
    JSON objects ``POST /batch/events.json`` takes). Timestamps are
    canonicalized client-side so the server's embed-verbatim fast path
    hits; tags/prId ride the wire.py typed codec in the extras column."""
    n = len(events)
    cols: list[list[bytes]] = [[] for _ in range(N_COLUMNS)]
    for d in events:
        cols[COL_EVENT].append(str(d.get("event", "")).encode())
        cols[COL_ENTITY_TYPE].append(str(d.get("entityType", "")).encode())
        cols[COL_ENTITY_ID].append(str(d.get("entityId", "")).encode())
        cols[COL_TARGET_ENTITY_TYPE].append(
            str(d.get("targetEntityType") or "").encode()
        )
        cols[COL_TARGET_ENTITY_ID].append(
            str(d.get("targetEntityId") or "").encode()
        )
        for col, key in (
            (COL_EVENT_TIME, "eventTime"),
            (COL_CREATION_TIME, "creationTime"),
        ):
            t = d.get(key)
            cols[col].append(
                format_time(parse_time(t), "us").encode() if t else b""
            )
        cols[COL_EVENT_ID].append(str(d.get("eventId") or "").encode())
        props = d.get("properties")
        if isinstance(props, DataMap):
            props = props.to_dict()
        cols[COL_PROPERTIES].append(
            json.dumps(props, separators=(",", ":")).encode()
            if props
            else b""
        )
        extras = {
            k: d[k] for k in ("tags", "prId") if d.get(k)
        }
        cols[COL_EXTRAS].append(wire.dumps(extras) if extras else b"")
    parts = [_U32.pack(n)]
    for items in cols:
        blob = b"".join(items)
        ends = np.cumsum(
            np.fromiter((len(b) for b in items), np.uint32, count=n),
            dtype=np.uint32,
        )
        parts.append(_U32.pack(len(blob)))
        parts.append(ends.astype("<u4").tobytes())
        parts.append(blob)
    payload = b"".join(parts)
    return _U32.pack(len(payload)) + payload


def encode_body(
    events: Sequence[Mapping[str, Any]], frame_events: int = 2000
) -> bytes:
    """A full request body: magic + one frame per ``frame_events`` chunk
    (each frame is one group commit on the server)."""
    parts = [MAGIC]
    for lo in range(0, len(events), frame_events):
        parts.append(encode_frame(events[lo : lo + frame_events]))
    return b"".join(parts)


# -- server side -------------------------------------------------------------


def _read_exact(stream, n: int, what: str) -> bytes:
    data = stream.read(n)
    while len(data) < n:
        more = stream.read(n - len(data))
        if not more:
            raise FrameError(
                "TornFrame",
                f"body ended mid-{what} ({len(data)}/{n} bytes)",
            )
        data += more
    return data


def read_frames(stream, limit: int | None = None) -> Iterable[bytes]:
    """Yield frame payloads incrementally off a request body stream
    (anything with ``read(n)`` and optionally ``remaining``). Raises
    :class:`FrameError` on bad magic, an oversized length header, or a
    frame torn by the body ending early."""
    limit = max_frame_bytes() if limit is None else limit
    magic = _read_exact(stream, len(MAGIC), "magic")
    if magic != MAGIC:
        raise FrameError("BadMagic", f"expected {MAGIC!r}, got {magic!r}")
    while getattr(stream, "remaining", 1) > 0:
        faults.fault_point("http.frame")
        hdr = stream.read(4)
        if not hdr:
            return  # clean end between frames (no remaining attr)
        if len(hdr) < 4:
            raise FrameError("TornFrame", "body ended mid-frame header")
        (size,) = _U32.unpack(hdr)
        if size < 4:
            raise FrameError("BadFrame", f"frame payload of {size} bytes")
        if size > limit:
            raise FrameError(
                "FrameTooLarge",
                f"frame of {size} bytes exceeds the {limit}-byte cap "
                "(PIO_FRAME_MAX_MB)",
            )
        remaining = getattr(stream, "remaining", None)
        if remaining is not None and size > remaining:
            raise FrameError(
                "TornFrame",
                f"frame declares {size} bytes but only {remaining} remain",
            )
        yield _read_exact(stream, size, "frame payload")


def decode_frame(payload: bytes) -> "FrameBatch":
    """Payload bytes -> :class:`FrameBatch`. Structural validation only
    (offsets in bounds, monotone, no trailing junk); event-level rules
    run in render_jsonl/to_events."""
    total = len(payload)
    if total < 4:
        raise FrameError("BadFrame", "frame shorter than its event count")
    (n,) = _U32.unpack_from(payload, 0)
    # 10 columns, each at least a 4-byte blob_len + 4n of offsets
    if n > (total - 4) // max(1, N_COLUMNS * 4):
        raise FrameError("BadFrame", f"event count {n} exceeds payload size")
    pos = 4
    cols: list[tuple[bytes, list[int]]] = []
    for _ in range(N_COLUMNS):
        if pos + 4 + 4 * n > total:
            raise FrameError("BadFrame", "truncated column header")
        (blob_len,) = _U32.unpack_from(payload, pos)
        pos += 4
        ends = np.frombuffer(payload, "<u4", count=n, offset=pos)
        pos += 4 * n
        if pos + blob_len > total:
            raise FrameError("BadFrame", "column blob overruns the frame")
        if n and (
            int(ends[-1]) != blob_len
            or bool((ends[1:] < ends[:-1]).any())
        ):
            raise FrameError("BadFrame", "non-monotone column offsets")
        cols.append((payload[pos : pos + blob_len], ends.tolist()))
        pos += blob_len
    if pos != total:
        raise FrameError("BadFrame", f"{total - pos} trailing bytes")
    return FrameBatch(n, cols)


def _split_bytes(blob: bytes, ends: list[int]) -> list[bytes]:
    out = []
    s = 0
    for e in ends:
        out.append(blob[s:e])
        s = e
    return out


def _split_str(blob: bytes, ends: list[int], col: int) -> list[str]:
    try:
        if blob.isascii():
            # byte offsets == char offsets: one decode, str slices
            text = blob.decode("ascii")
            out = []
            s = 0
            for e in ends:
                out.append(text[s:e])
                s = e
            return out
        return [b.decode("utf-8") for b in _split_bytes(blob, ends)]
    except UnicodeDecodeError as e:
        raise FrameError("BadFrame", f"column {col} is not UTF-8: {e}") from e


def _gen_ids(count: int) -> list[str]:
    """Bulk random 32-hex event ids (one urandom call, not per-uuid)."""
    if not count:
        return []
    pool = binascii.hexlify(os.urandom(16 * count)).decode("ascii")
    return [pool[i : i + 32] for i in range(0, 32 * count, 32)]


def _canon_time(s: str, i: int) -> str:
    """Validate an ISO-8601 timestamp and return its storage-canonical
    form (``format_time(..., "us")``). Already-canonical strings (the
    cooperating-client fast path) embed verbatim after a validity
    parse — a regex match alone would store impossible dates that break
    replay."""
    try:
        if _CANON_TIME.fullmatch(s):
            if s[-1] == "Z":
                parse_time(s)
                return s
            dt = parse_time(s)
            # a numeric zero offset renders as Z canonically
            return s if dt.utcoffset() else format_time(dt, "us")
        return format_time(parse_time(s), "us")
    except EventValidationError as e:
        raise FrameEventError(i, str(e)) from e


def _is_reserved(name: str) -> bool:
    return name[0] == "$" or name.startswith("pio_")


class FrameBatch:
    """One decoded frame: event count + the ten raw columns. The two
    exits — :meth:`render_jsonl` (splice backends) and :meth:`to_events`
    (everything else) — share the validation rules of
    ``data/event.validate`` and are all-or-nothing: any invalid event
    rejects the whole frame before a byte reaches storage."""

    __slots__ = ("n", "_cols")

    def __init__(self, n: int, cols: list[tuple[bytes, list[int]]]):
        self.n = n
        self._cols = cols

    def column_bytes(self, col: int) -> list[bytes]:
        return _split_bytes(*self._cols[col])

    def column_str(self, col: int) -> list[str]:
        blob, ends = self._cols[col]
        return _split_str(blob, ends, col)

    # -- shared validation pieces ------------------------------------------

    def _check_combo(
        self, i: int, ev: str, et: str, tet: str,
        allowed: frozenset | None,
    ) -> None:
        """The name checks that depend only on (event, entityType,
        targetEntityType) — memoizable per distinct combo."""
        if not ev:
            raise FrameEventError(i, "event must not be empty.")
        if allowed is not None and ev not in allowed:
            raise FrameEventError(
                i, f"event {ev} is not allowed by this access key"
            )
        if _is_reserved(ev) and ev not in SPECIAL_EVENTS:
            raise FrameEventError(
                i, f"{ev} is not a supported reserved event name."
            )
        if not et:
            raise FrameEventError(i, "entityType must not be empty string.")
        if _is_reserved(et) and et not in BUILTIN_ENTITY_TYPES:
            raise FrameEventError(
                i,
                f"The entityType {et} is not allowed. "
                "'pio_' is a reserved name prefix.",
            )
        if tet:
            if ev in SPECIAL_EVENTS:
                raise FrameEventError(
                    i, f"Reserved event {ev} cannot have targetEntity"
                )
            if _is_reserved(tet) and tet not in BUILTIN_ENTITY_TYPES:
                raise FrameEventError(
                    i,
                    f"The targetEntityType {tet} is not allowed. "
                    "'pio_' is a reserved name prefix.",
                )

    def _check_names(
        self, i: int, ev: str, et: str, eid: str, tet: str, tid: str,
        allowed: frozenset | None,
    ) -> None:
        self._check_combo(i, ev, et, tet, allowed)
        if not eid:
            raise FrameEventError(i, "entityId must not be empty string.")
        if bool(tet) != bool(tid):
            raise FrameEventError(
                i,
                "targetEntityType and targetEntityId must be "
                "specified together.",
            )

    def _props(self, i: int, raw: bytes) -> tuple[dict | None, str]:
        """properties column bytes -> (parsed dict or None, canonical
        JSON text). Always re-rendered through json.dumps: that both
        validates the client bytes ARE a JSON object and canonicalizes
        the rendering to the byte layout ``batch_insert`` produces."""
        if not raw or raw == b"{}":
            return None, "{}"
        try:
            # decode before loads: bytes input pays a per-call encoding
            # sniff inside the json module (UnicodeDecodeError is a
            # ValueError, so a bad encoding lands in the same except)
            obj = json.loads(raw.decode("utf-8"))
        except ValueError as e:
            raise FrameEventError(i, f"properties must be valid JSON: {e}")
        if not isinstance(obj, dict):
            raise FrameEventError(i, "properties must be a JSON object")
        for k in obj:
            if _is_reserved(k):
                raise FrameEventError(
                    i,
                    f"The property {k} is not allowed. "
                    "'pio_' is a reserved name prefix.",
                )
        return obj, json.dumps(obj)

    def _extras(self, i: int, raw: bytes) -> tuple[tuple, str | None]:
        try:
            x = wire.loads(raw)
            if not isinstance(x, dict):
                raise ValueError("extras must decode to an object")
            tags = tuple(x.get("tags") or ())
            pr_id = x.get("prId")
            if pr_id is not None and not isinstance(pr_id, str):
                raise ValueError("prId must be a string")
            if not all(isinstance(t, str) for t in tags):
                raise ValueError("tags must be strings")
        except (ValueError, TypeError) as e:
            raise FrameEventError(i, f"bad extras column: {e}")
        return tags, pr_id

    # -- exits --------------------------------------------------------------

    def render_jsonl(
        self,
        allowed_events: frozenset | None,
        stamp_iso: str,
    ) -> tuple[bytes, list[str], list[str]]:
        """Validate every event and render the storage-format JSONL blob
        for ``append_jsonl`` splice-through (byte-identical to what
        ``batch_insert`` would store). Returns (blob, event_ids,
        event_names); raises :class:`FrameEventError` on the first
        invalid event — nothing is returned for a partially-valid frame.
        ``stamp_iso`` fills missing eventTime/creationTime (one receive
        stamp per request, already storage-canonical)."""
        ev_l = self.column_str(COL_EVENT)
        et_l = self.column_str(COL_ENTITY_TYPE)
        eid_l = self.column_str(COL_ENTITY_ID)
        tet_l = self.column_str(COL_TARGET_ENTITY_TYPE)
        tid_l = self.column_str(COL_TARGET_ENTITY_ID)
        t_l = self.column_str(COL_EVENT_TIME)
        xid_l = self.column_str(COL_EVENT_ID)
        ct_l = self.column_str(COL_CREATION_TIME)
        props_l = self.column_bytes(COL_PROPERTIES)
        extras_l = self.column_bytes(COL_EXTRAS)
        fresh = iter(_gen_ids(sum(1 for x in xid_l if not x)))
        lines: list[str] = []
        ids: list[str] = []
        # per-frame memo caches: real batches repeat event names, entity
        # types, timestamps, and property shapes heavily, so each
        # DISTINCT value is validated/canonicalized once — this is what
        # holds the splice path at wire speed (a per-event json.loads +
        # parse_time would triple the cost of this loop)
        combo_memo: dict = {}
        props_memo: dict = {}
        time_memo: dict = {}
        stamp_esc = _esc(stamp_iso)
        for i in range(self.n):
            ev = ev_l[i]
            et = et_l[i]
            eid = eid_l[i]
            tet = tet_l[i]
            tid = tid_l[i]
            combo = (ev, et, tet)
            frag = combo_memo.get(combo)
            if frag is None:
                self._check_combo(i, ev, et, tet, allowed_events)
                head = (
                    '{"event": ' + _esc(ev)
                    + ', "entityType": ' + _esc(et)
                    + ', "entityId": '
                )
                tfrag = (
                    ', "targetEntityType": ' + _esc(tet)
                    + ', "targetEntityId": '
                ) if tet else None
                frag = combo_memo[combo] = (head, tfrag)
            head, tfrag = frag
            if not eid:
                raise FrameEventError(
                    i, "entityId must not be empty string."
                )
            if bool(tet) != bool(tid):
                raise FrameEventError(
                    i,
                    "targetEntityType and targetEntityId must be "
                    "specified together.",
                )
            raw = props_l[i]
            hit = props_memo.get(raw)
            if hit is None:
                obj, props_json = self._props(i, raw)
                hit = props_memo[raw] = (not obj, props_json)
            empty_props, props_json = hit
            if empty_props and ev == "$unset":
                raise FrameEventError(
                    i, "properties cannot be empty for $unset event"
                )
            t = t_l[i]
            if t:
                te = time_memo.get(t)
                if te is None:
                    te = time_memo[t] = _esc(_canon_time(t, i))
                t = te
            else:
                t = stamp_esc
            ct = ct_l[i]
            if ct:
                cte = time_memo.get(ct)
                if cte is None:
                    cte = time_memo[ct] = _esc(_canon_time(ct, i))
                ct = cte
            else:
                ct = stamp_esc
            xid = xid_l[i]
            if xid:
                xj = _esc(xid)
            else:
                xid = next(fresh)
                xj = '"' + xid + '"'  # generated ids are hex: no escaping
            # key order and ", "/": " separators match
            # json.dumps(Event.to_dict(for_api=False)) exactly — the
            # byte-parity contract with batch_insert's rendering
            # (t/ct/head/tfrag are pre-escaped via the memos above)
            if extras_l[i]:
                parts = [
                    head, _esc(eid),
                    ', "properties": ', props_json,
                    ', "eventTime": ', t,
                    ', "eventId": ', xj,
                ]
                if tfrag is not None:
                    parts += [tfrag, _esc(tid)]
                tags, pr_id = self._extras(i, extras_l[i])
                if tags:
                    parts += [', "tags": ', json.dumps(list(tags))]
                if pr_id is not None:
                    parts += [', "prId": ', _esc(pr_id)]
                parts += [', "creationTime": ', ct, "}"]
                lines.append("".join(parts))
            else:
                tail = tfrag + _esc(tid) if tfrag is not None else ""
                lines.append(
                    head + _esc(eid)
                    + ', "properties": ' + props_json
                    + ', "eventTime": ' + t
                    + ', "eventId": ' + xj
                    + tail
                    + ', "creationTime": ' + ct + "}"
                )
            ids.append(xid)
        blob = ("\n".join(lines) + "\n").encode() if lines else b""
        return blob, ids, ev_l

    def to_events(
        self,
        allowed_events: frozenset | None,
        stamp_iso: str,
    ) -> tuple[list[Event], list[str]]:
        """Validate and build Event objects for backends without an
        ``append_jsonl`` splice path (sqlite, memory, ...). Same rules
        and all-or-nothing semantics as :meth:`render_jsonl`."""
        ev_l = self.column_str(COL_EVENT)
        et_l = self.column_str(COL_ENTITY_TYPE)
        eid_l = self.column_str(COL_ENTITY_ID)
        tet_l = self.column_str(COL_TARGET_ENTITY_TYPE)
        tid_l = self.column_str(COL_TARGET_ENTITY_ID)
        t_l = self.column_str(COL_EVENT_TIME)
        xid_l = self.column_str(COL_EVENT_ID)
        ct_l = self.column_str(COL_CREATION_TIME)
        props_l = self.column_bytes(COL_PROPERTIES)
        extras_l = self.column_bytes(COL_EXTRAS)
        stamp = parse_time(stamp_iso)
        fresh = iter(_gen_ids(sum(1 for x in xid_l if not x)))
        events: list[Event] = []
        ids: list[str] = []
        for i in range(self.n):
            ev = ev_l[i]
            et = et_l[i]
            eid = eid_l[i]
            tet = tet_l[i]
            tid = tid_l[i]
            self._check_names(i, ev, et, eid, tet, tid, allowed_events)
            obj, _ = self._props(i, props_l[i])
            if ev == "$unset" and not obj:
                raise FrameEventError(
                    i, "properties cannot be empty for $unset event"
                )
            tags: tuple = ()
            pr_id = None
            if extras_l[i]:
                tags, pr_id = self._extras(i, extras_l[i])
            try:
                t = parse_time(t_l[i]) if t_l[i] else stamp
                ct = parse_time(ct_l[i]) if ct_l[i] else stamp
            except EventValidationError as e:
                raise FrameEventError(i, str(e)) from e
            xid = xid_l[i] or next(fresh)
            events.append(
                Event(
                    event=ev,
                    entity_type=et,
                    entity_id=eid,
                    target_entity_type=tet or None,
                    target_entity_id=tid or None,
                    properties=DataMap(obj or {}),
                    event_time=t,
                    tags=tags,
                    pr_id=pr_id,
                    creation_time=ct,
                    event_id=xid,
                )
            )
            ids.append(xid)
        return events, ids
