"""ctypes binding of the native event codec (``native/pio_native.cpp``).

Port of ``predictionio_tpu/native/__init__.py``: the same functions over
the same C++ source, with a binding of its own. The library is built
with ``g++`` at first use from the repo's ``native/pio_native.cpp`` into
``predictionio_tpu_torch/_build/`` (listed in ``.gitignore``), under a
name that carries a hash of the source, so an edited source is rebuilt
and a stale library is never loaded. Nothing is written under
``native/``, and the JAX package's library is never loaded. Public API:

- :func:`scan_events` -- columnar field spans for a JSONL event buffer,
- :func:`index_spans` -- dense string-id indexing over spans (BiMap build),
- :func:`parse_times` / :func:`extract_number` -- vectorized field decode,
- :func:`load_ratings_jsonl` -- one-call file -> (user_ids, item_ids,
  rows, cols, ratings) training-array loader,
- :func:`parse_events_jsonl` -- JSONL -> list[Event] with the native
  scanner for well-formed lines and the Python json fallback otherwise.

Every function has a pure-Python path, the codec's CPU twin, taken when
the library cannot be built or loaded: :func:`native_available` says
which path is active, :func:`library_path` names the loaded file, and a
fallback is logged at warning level. This is host code: nothing here
touches a device.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

logger = logging.getLogger(__name__)

# field slots -- keep in sync with PioField in native/pio_native.cpp
F_EVENT = 0
F_ENTITY_TYPE = 1
F_ENTITY_ID = 2
F_TARGET_ENTITY_TYPE = 3
F_TARGET_ENTITY_ID = 4
F_PROPERTIES = 5
F_EVENT_TIME = 6
F_PR_ID = 7
F_EVENT_ID = 8
F_TAGS = 9
F_CREATION_TIME = 10
N_FIELDS = 11

FLAG_FALLBACK = 1
FLAG_EMPTY = 2

_PKG = Path(__file__).resolve().parent.parent
#: the C++ source, shared with the JAX package and never written to
SOURCE = _PKG.parent / "native" / "pio_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_path: Path | None = None
_lib_tried = False


def _build(src: Path, out: Path) -> bool:
    """Compile ``src`` into ``out``: into a temporary name first, then
    renamed, so a concurrent process never loads a half-written file."""
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True,
            text=True,
            timeout=120,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.warning("native codec build unavailable: %s", e)
        return False
    if proc.returncode != 0:
        logger.warning("native codec build failed:\n%s", proc.stderr)
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def _library_file() -> Path | None:
    """The library's path under ``_build/`` for the current source, or
    None when the source is not beside the package."""
    try:
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    except OSError:
        return None
    return BUILD_DIR / f"libpio_native-{digest}.so"


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_path, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        so = _library_file()
        try:
            if so is None:
                logger.warning(
                    "native codec source %s not found: the pure-Python "
                    "codec runs", SOURCE,
                )
                return None
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                if not _build(SOURCE, so):
                    logger.warning("native codec unavailable: the pure-Python codec runs")
                    return None
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            logger.warning("native codec not loaded (%s): the pure-Python codec runs", e)
            return None

        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.pio_scan_events.restype = ctypes.c_long
        lib.pio_scan_events.argtypes = [
            ctypes.c_char_p, ctypes.c_long, i64p, i64p, u8p, ctypes.c_long,
            ctypes.c_long,
        ]
        lib.pio_index_spans.restype = ctypes.c_long
        lib.pio_index_spans.argtypes = [
            ctypes.c_char_p, i64p, i64p, ctypes.c_long, i32p, i64p,
        ]
        lib.pio_parse_times.restype = None
        lib.pio_parse_times.argtypes = [
            ctypes.c_char_p, i64p, i64p, ctypes.c_long, f64p,
        ]
        lib.pio_extract_number.restype = None
        lib.pio_extract_number.argtypes = [
            ctypes.c_char_p, i64p, i64p, ctypes.c_long, ctypes.c_char_p, f64p,
        ]
        lib.pio_route_ids.restype = None
        lib.pio_route_ids.argtypes = [
            ctypes.c_char_p, i64p, i64p, ctypes.c_long, ctypes.c_int32, i32p,
        ]
        lib.pio_splice_lines.restype = ctypes.c_long
        lib.pio_splice_lines.argtypes = [
            ctypes.c_char_p, i64p, i64p, ctypes.c_long, u8p, u8p,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long, u8p,
        ]
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.pio_hash64_spans.restype = None
        lib.pio_hash64_spans.argtypes = [
            ctypes.c_char_p, i64p, i64p, ctypes.c_long, u64p,
        ]
        _lib = lib
        _lib_path = so
        return _lib


def native_available() -> bool:
    """True when the C++ library is loaded, False on the pure-Python path."""
    return _load() is not None


def library_path() -> Path | None:
    """The loaded library's file, or None on the pure-Python path."""
    return _lib_path if _load() is not None else None


class ScannedEvents:
    """Columnar view of one scanned JSONL buffer: (offset, length) spans
    per line per field, plus per-line flags."""

    def __init__(self, buf: bytes, offs: np.ndarray, lens: np.ndarray,
                 flags: np.ndarray):
        self.buf = buf
        self.offs = offs  # [n, N_FIELDS] int64, -1 = absent
        self.lens = lens  # [n, N_FIELDS] int64
        self.flags = flags  # [n] uint8

    def __len__(self) -> int:
        return len(self.flags)

    def field_bytes(self, line: int, field: int) -> bytes | None:
        off = int(self.offs[line, field])
        if off < 0:
            return None
        return self.buf[off : off + int(self.lens[line, field])]

    def field_str(self, line: int, field: int) -> str | None:
        b = self.field_bytes(line, field)
        return None if b is None else b.decode("utf-8")


def scan_events(buf: bytes, n_threads: int = 0) -> ScannedEvents:
    """Scan a newline-delimited JSON event buffer into field spans.
    Lines needing the full json parser carry FLAG_FALLBACK.
    ``n_threads`` > 0 pins the native scanner's thread count (callers
    that already parallelize across buffers pass 1); 0 = auto."""
    n_lines = buf.count(b"\n") + (0 if buf.endswith(b"\n") or not buf else 1)
    n_lines = max(n_lines, 1)
    offs = np.empty((n_lines, N_FIELDS), dtype=np.int64)
    lens = np.empty((n_lines, N_FIELDS), dtype=np.int64)
    flags = np.empty(n_lines, dtype=np.uint8)
    lib = _load()
    if lib is not None:
        n = lib.pio_scan_events(
            buf, len(buf), offs.reshape(-1), lens.reshape(-1), flags,
            n_lines, n_threads,
        )
        if n >= 0:
            return ScannedEvents(buf, offs[:n], lens[:n], flags[:n])
    # pure-Python fallback: flag every non-empty line for the json path
    lines = buf.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    n = len(lines)
    offs = np.full((n, N_FIELDS), -1, dtype=np.int64)
    lens = np.zeros((n, N_FIELDS), dtype=np.int64)
    flags = np.full(n, FLAG_FALLBACK, dtype=np.uint8)
    for i, line in enumerate(lines):
        if not line.strip():
            flags[i] = FLAG_EMPTY
    return ScannedEvents(buf, offs, lens, flags)


def index_spans(
    buf: bytes, offs: np.ndarray, lens: np.ndarray
) -> tuple[np.ndarray, list[str]]:
    """Dense-index string spans (BiMap.stringInt analog). Returns
    (idx int32 [n] with -1 for absent spans, unique id strings in dense
    order)."""
    n = len(offs)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    idx = np.empty(n, dtype=np.int32)
    uniq_repr = np.empty(n, dtype=np.int64)
    lib = _load()
    if lib is not None:
        n_uniq = lib.pio_index_spans(buf, offs, lens, n, idx, uniq_repr)
        ids = [
            buf[offs[r] : offs[r] + lens[r]].decode("utf-8")
            for r in uniq_repr[:n_uniq]
        ]
        return idx, ids
    mapping: dict[bytes, int] = {}
    ids = []
    for i in range(n):
        if offs[i] < 0:
            idx[i] = -1
            continue
        key = buf[offs[i] : offs[i] + lens[i]]
        j = mapping.get(key)
        if j is None:
            j = len(mapping)
            mapping[key] = j
            ids.append(key.decode("utf-8"))
        idx[i] = j
    return idx, ids


def parse_times(buf: bytes, offs: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """ISO-8601 spans -> epoch seconds (NaN when absent/unparseable)."""
    n = len(offs)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    out = np.empty(n, dtype=np.float64)
    lib = _load()
    if lib is not None:
        lib.pio_parse_times(buf, offs, lens, n, out)
        return out
    from predictionio_tpu_torch.data.event import parse_time

    for i in range(n):
        if offs[i] < 0:
            out[i] = np.nan
            continue
        try:
            out[i] = parse_time(
                buf[offs[i] : offs[i] + lens[i]].decode("utf-8")
            ).timestamp()
        except Exception:
            out[i] = np.nan
    return out


def fnv1a32(data: bytes) -> int:
    """FNV-1a 32-bit -- the partition-routing hash (kept in lockstep with
    pio_route_ids in pio_native.cpp)."""
    h = 2166136261
    for b in data:
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


def route_id_bytes(s: bytes, n_partitions: int) -> int:
    """Partition of one event id: '<2 lowercase hex>-...' with value <
    n_partitions routes by the embedded partition, else FNV-1a 32 mod
    n_partitions (same rule as pio_route_ids)."""
    hexdigits = b"0123456789abcdef"
    if (
        len(s) >= 3
        and s[2:3] == b"-"
        and s[0] in hexdigits
        and s[1] in hexdigits
    ):
        pp = int(s[:2], 16)
        if pp < n_partitions:
            return pp
    return fnv1a32(s) % n_partitions


def route_ids(
    buf: bytes, offs: np.ndarray, lens: np.ndarray, n_partitions: int
) -> np.ndarray:
    """Vectorized partition routing of event-id spans; -1 for absent
    spans. The bulk-import hot loop (one native pass per blob)."""
    n = len(offs)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    out = np.empty(n, dtype=np.int32)
    lib = _load()
    if lib is not None:
        lib.pio_route_ids(buf, offs, lens, n, n_partitions, out)
        return out
    for i in range(n):
        if offs[i] < 0:
            out[i] = -1
        else:
            out[i] = route_id_bytes(
                buf[offs[i] : offs[i] + lens[i]], n_partitions
            )
    return out


def hash64_spans(
    buf: bytes, offs: np.ndarray, lens: np.ndarray
) -> np.ndarray:
    """FNV-1a 64 per span (0 for absent spans). Native when available;
    the Python fallback hashes the materialized bytes (same 0-for-absent
    contract, different hash function -- callers must only compare hashes
    produced by the same process)."""
    n = len(offs)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    out = np.empty(n, dtype=np.uint64)
    lib = _load()
    if lib is not None:
        lib.pio_hash64_spans(buf, offs, lens, n, out)
        return out
    for i in range(n):
        if offs[i] < 0:
            out[i] = 0
        else:
            out[i] = np.uint64(
                hash(buf[offs[i] : offs[i] + lens[i]]) & 0xFFFFFFFFFFFFFFFF
            )
    return out


def splice_lines(
    buf: bytes,
    starts: np.ndarray,
    ends: np.ndarray,
    want_id: np.ndarray,
    want_ct: np.ndarray,
    ids: bytes,
    ct_tail: bytes,
) -> bytes | None:
    """Assemble the import splice blob: each selected line span gets
    ``,"eventId":"<32 hex>"`` (where ``want_id``; 32 bytes per id from
    ``ids``, in order) and/or ``ct_tail`` inserted before its closing
    brace -- the per-line hot loop of ``pio import`` in one native pass.
    Returns the newline-joined blob, or None when the native library is
    unavailable or a line is malformed (caller uses its Python loop)."""
    lib = _load()
    if lib is None:
        return None
    n = len(starts)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    want_id = np.ascontiguousarray(want_id, dtype=np.uint8)
    want_ct = np.ascontiguousarray(want_ct, dtype=np.uint8)
    worst = int((ends - starts).sum()) + n * (13 + 34 + len(ct_tail) + 2) + 1
    out = np.empty(worst, dtype=np.uint8)
    wrote = lib.pio_splice_lines(
        buf, starts, ends, n, want_id, want_ct, ids, ct_tail,
        len(ct_tail), out,
    )
    if wrote < 0:
        return None
    return out[:wrote].tobytes()


def extract_number(
    buf: bytes, offs: np.ndarray, lens: np.ndarray, key: str
) -> np.ndarray:
    """Per-span numeric property extraction: value of ``key`` at the top
    level of each properties-object span (NaN when missing)."""
    n = len(offs)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    out = np.empty(n, dtype=np.float64)
    lib = _load()
    if lib is not None:
        lib.pio_extract_number(buf, offs, lens, n, key.encode(), out)
        return out
    for i in range(n):
        out[i] = np.nan
        if offs[i] < 0:
            continue
        try:
            v = json.loads(buf[offs[i] : offs[i] + lens[i]]).get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[i] = float(v)
        except Exception:
            pass
    return out


def parse_events_jsonl(data: bytes, scanned: "ScannedEvents | None" = None) -> list:
    """JSONL buffer -> list[Event]: native span scan for well-formed
    lines, json fallback for flagged ones (the import-path codec).
    Pass ``scanned`` to reuse a prior :func:`scan_events` of ``data``."""
    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event, parse_time

    if scanned is None:
        scanned = scan_events(data)
    buf = scanned.buf
    # plain-list span indexing: numpy scalar getitem per field per line
    # costs more than the slice+decode it addresses; tolist() once makes
    # the hot loop pure-Python-fast (this loop is the speed layer's
    # burst ceiling -- see realtime/tailer._poll_files)
    offs = scanned.offs.tolist()
    lens = scanned.lens.tolist()
    flags = scanned.flags.tolist()
    # timestamps and property shapes repeat heavily (splice batches
    # share one receive stamp; events of one kind share a schema):
    # parse each distinct string once per buffer. Safe for properties
    # because DataMap copies the top-level dict it is handed.
    tmemo: dict = {}
    pmemo: dict = {}
    events = []
    lines: list[bytes] | None = None  # lazily split, only if fallbacks occur
    for i, flag in enumerate(flags):
        if flag & FLAG_EMPTY:
            continue
        o = offs[i]
        ln = lens[i]
        if flag & FLAG_FALLBACK or o[F_EVENT] < 0 or (
            o[F_ENTITY_TYPE] < 0 or o[F_ENTITY_ID] < 0
        ):
            if lines is None:
                lines = data.split(b"\n")
            events.append(Event.from_json(lines[i].decode("utf-8")))
            continue
        po = o[F_PROPERTIES]
        props_raw = buf[po : po + ln[F_PROPERTIES]] if po >= 0 else None
        if props_raw:
            pobj = pmemo.get(props_raw)
            if pobj is None:
                pobj = pmemo[props_raw] = json.loads(
                    props_raw.decode("utf-8")
                )
        else:
            pobj = {}
        tgo = o[F_TAGS]
        tags_raw = buf[tgo : tgo + ln[F_TAGS]] if tgo >= 0 else None
        teo = o[F_TARGET_ENTITY_TYPE]
        tio = o[F_TARGET_ENTITY_ID]
        pro = o[F_PR_ID]
        ofs = o[F_EVENT]
        kwargs = dict(
            event=buf[ofs : ofs + ln[F_EVENT]].decode("utf-8"),
            entity_type=buf[
                o[F_ENTITY_TYPE] : o[F_ENTITY_TYPE] + ln[F_ENTITY_TYPE]
            ].decode("utf-8"),
            entity_id=buf[
                o[F_ENTITY_ID] : o[F_ENTITY_ID] + ln[F_ENTITY_ID]
            ].decode("utf-8"),
            target_entity_type=(
                buf[teo : teo + ln[F_TARGET_ENTITY_TYPE]].decode("utf-8")
                if teo >= 0 else None
            ),
            target_entity_id=(
                buf[tio : tio + ln[F_TARGET_ENTITY_ID]].decode("utf-8")
                if tio >= 0 else None
            ),
            properties=DataMap(pobj),
            pr_id=(
                buf[pro : pro + ln[F_PR_ID]].decode("utf-8")
                if pro >= 0 else None
            ),
            tags=tuple(json.loads(tags_raw)) if tags_raw else (),
        )
        to = o[F_EVENT_TIME]
        if to >= 0:
            t = buf[to : to + ln[F_EVENT_TIME]].decode("utf-8")
            dt = tmemo.get(t)
            if dt is None:
                dt = tmemo[t] = parse_time(t)
            kwargs["event_time"] = dt
        cto = o[F_CREATION_TIME]
        if cto >= 0:
            ct = buf[cto : cto + ln[F_CREATION_TIME]].decode("utf-8")
            dt = tmemo.get(ct)
            if dt is None:
                dt = tmemo[ct] = parse_time(ct)
            kwargs["creation_time"] = dt
        eo = o[F_EVENT_ID]
        if eo >= 0:
            kwargs["event_id"] = buf[eo : eo + ln[F_EVENT_ID]].decode(
                "utf-8"
            )
        events.append(Event(**kwargs))
    return events


def _span_type_mask(
    scanned: "ScannedEvents", field: int, wanted: str
) -> np.ndarray:
    """Boolean mask of lines whose ``field`` span equals ``wanted``,
    computed by dense-indexing the (few) distinct values."""
    idx, names = index_spans(
        scanned.buf, scanned.offs[:, field], scanned.lens[:, field]
    )
    ok = np.array([name == wanted for name in names], dtype=bool)
    if not len(ok):
        return np.zeros(len(scanned), dtype=bool)
    return (idx >= 0) & ok[np.clip(idx, 0, None)]


def load_ratings_jsonl(
    data: bytes,
    event_names: Sequence[str] | None = None,
    rating_key: str | None = "rating",
    default_ratings: dict[str, float] | None = None,
    entity_type: str | None = None,
    target_entity_type: str | None = None,
    override_ratings: dict[str, float] | None = None,
    scanned: "ScannedEvents | None" = None,
    n_threads: int = 0,
) -> tuple[list[str], list[str], np.ndarray, np.ndarray, np.ndarray]:
    """One call from a JSONL event buffer to ALS training arrays:
    (user_ids, item_ids, rows, cols, ratings) with dense indices -- the
    file -> device-array boundary (reference DataSource.readTraining +
    BiMap.stringInt, examples/scala-parallel-recommendation/
    custom-prepartor/src/main/scala/DataSource.scala:35-60).

    ``default_ratings`` maps event names to implicit values used when the
    ``rating_key`` property is absent; ``override_ratings`` maps event
    names to FORCED values that beat any property (the reference's
    ``case "buy" => 4.0`` rule -- DataSource.scala:55 ignores properties
    for buy events). ``entity_type``/``target_entity_type`` restrict
    lines the way the template DataSources do. Pass ``scanned`` to reuse
    a prior :func:`scan_events` of the same ``data`` (single-pass reads).
    """
    if scanned is None:
        scanned = scan_events(data, n_threads=n_threads)
    n = len(scanned)
    keep = np.ones(n, dtype=bool)
    keep &= (scanned.flags == 0) & (scanned.offs[:, F_ENTITY_ID] >= 0) & (
        scanned.offs[:, F_TARGET_ENTITY_ID] >= 0
    )
    if entity_type is not None:
        keep &= _span_type_mask(scanned, F_ENTITY_TYPE, entity_type)
    if target_entity_type is not None:
        keep &= _span_type_mask(scanned, F_TARGET_ENTITY_TYPE, target_entity_type)

    # event-name filter + implicit defaults need the event spans decoded;
    # dense-index the (few) distinct event names instead of per-line str
    ev_idx, ev_names = index_spans(
        scanned.buf, scanned.offs[:, F_EVENT], scanned.lens[:, F_EVENT]
    )
    if event_names is not None:
        allowed = np.array(
            [name in set(event_names) for name in ev_names], dtype=bool
        )
        if len(allowed):
            keep &= (ev_idx >= 0) & allowed[np.clip(ev_idx, 0, None)]
        else:
            keep &= False

    if rating_key is None:  # pure implicit: defaults only, no extraction
        ratings = np.full(n, np.nan, dtype=np.float64)
    else:
        ratings = extract_number(
            scanned.buf, scanned.offs[:, F_PROPERTIES],
            scanned.lens[:, F_PROPERTIES], rating_key,
        )
    if default_ratings and len(ev_names):
        defaults = np.array(
            [default_ratings.get(name, np.nan) for name in ev_names],
            dtype=np.float64,
        )
        line_default = np.where(
            ev_idx >= 0, defaults[np.clip(ev_idx, 0, None)], np.nan
        )
        ratings = np.where(np.isnan(ratings), line_default, ratings)
    if override_ratings and len(ev_names):
        forced = np.array(
            [override_ratings.get(name, np.nan) for name in ev_names],
            dtype=np.float64,
        )
        line_forced = np.where(
            ev_idx >= 0, forced[np.clip(ev_idx, 0, None)], np.nan
        )
        ratings = np.where(np.isnan(line_forced), ratings, line_forced)
    keep &= ~np.isnan(ratings)

    kept = np.flatnonzero(keep)
    rows, user_ids = index_spans(
        scanned.buf,
        scanned.offs[kept, F_ENTITY_ID],
        scanned.lens[kept, F_ENTITY_ID],
    )
    cols, item_ids = index_spans(
        scanned.buf,
        scanned.offs[kept, F_TARGET_ENTITY_ID],
        scanned.lens[kept, F_TARGET_ENTITY_ID],
    )
    vals = ratings[kept].astype(np.float32)

    # lines the scanner couldn't take (escaped ids etc.) go through the
    # json parser and merge into the same dense id spaces. Python-list
    # conversion happens ONLY on this rare path -- at 10^7 rows the lists
    # would cost gigabytes where the arrays cost megabytes.
    fallback = np.flatnonzero(scanned.flags == FLAG_FALLBACK)
    if len(fallback):
        rows = list(rows)
        cols = list(cols)
        vals = list(vals)
        user_map = {u: i for i, u in enumerate(user_ids)}
        item_map = {it: i for i, it in enumerate(item_ids)}
        lines = data.split(b"\n")
        for i in fallback:
            try:
                d = json.loads(lines[i])
            except Exception:
                continue
            if event_names is not None and d.get("event") not in set(event_names):
                continue
            if entity_type is not None and d.get("entityType") != entity_type:
                continue
            if (
                target_entity_type is not None
                and d.get("targetEntityType") != target_entity_type
            ):
                continue
            u, it = d.get("entityId"), d.get("targetEntityId")
            if not u or not it:
                continue
            v = (override_ratings or {}).get(d.get("event"))
            if v is None:
                v = (d.get("properties") or {}).get(rating_key)
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    v = (default_ratings or {}).get(d.get("event"))
            if v is None:
                continue
            rows.append(user_map.setdefault(u, len(user_map)))
            cols.append(item_map.setdefault(it, len(item_map)))
            vals.append(float(v))
        user_ids = user_ids + [u for u in user_map if user_map[u] >= len(user_ids)]
        item_ids = item_ids + [it for it in item_map if item_map[it] >= len(item_ids)]

    return (
        user_ids,
        item_ids,
        np.asarray(rows, dtype=np.int32),
        np.asarray(cols, dtype=np.int32),
        np.asarray(vals, dtype=np.float32),
    )


# chunk size for bounded-RSS bulk reads (the single definition; the
# jsonl backend aliases it): span tables cost ~176 bytes/line, so a
# whole-buffer scan of a multi-GB log rivals the log itself in RSS
SCAN_CHUNK_BYTES = 256 << 20


def _line_aligned_chunks(data: bytes, chunk_bytes: int):
    """Yield line-aligned slices of ~chunk_bytes (a line longer than the
    chunk extends its slice to the next newline)."""
    pos = 0
    n = len(data)
    while pos < n:
        end = min(pos + chunk_bytes, n)
        if end < n:
            cut = data.rfind(b"\n", pos, end)
            if cut < pos:
                nxt = data.find(b"\n", end)
                end = n if nxt < 0 else nxt + 1
            else:
                end = cut + 1
        yield data[pos:end]
        pos = end


class DenseMerge:
    """Merges per-chunk / per-partition ``(users, items, rows, cols,
    vals)`` results into ONE dense id space by remapping each piece's
    local indices -- the shared merge of the chunked loader, the jsonl
    fused clean+extract read, and the partitioned store's per-partition
    concatenation. Sound whenever the pieces' (user, item) pairs are
    meant to concatenate (no cross-piece last-write-wins needed)."""

    def __init__(self) -> None:
        self.user_map: dict[str, int] = {}
        self.item_map: dict[str, int] = {}
        self._rows: list = []
        self._cols: list = []
        self._vals: list = []

    def add(self, users_p, items_p, rows_p, cols_p, vals_p) -> None:
        ulut = np.fromiter(
            (self.user_map.setdefault(u, len(self.user_map))
             for u in users_p),
            np.int32,
            len(users_p),
        )
        ilut = np.fromiter(
            (self.item_map.setdefault(t, len(self.item_map))
             for t in items_p),
            np.int32,
            len(items_p),
        )
        if len(vals_p):
            self._rows.append(ulut[rows_p])
            self._cols.append(ilut[cols_p])
            self._vals.append(vals_p)

    def result(
        self,
    ) -> tuple[list[str], list[str], np.ndarray, np.ndarray, np.ndarray]:
        if not self._vals:
            return (
                list(self.user_map),
                list(self.item_map),
                np.empty(0, np.int32),
                np.empty(0, np.int32),
                np.empty(0, np.float32),
            )
        return (
            list(self.user_map),
            list(self.item_map),
            np.concatenate(self._rows),
            np.concatenate(self._cols),
            np.concatenate(self._vals),
        )


def load_ratings_jsonl_chunked(
    data: bytes,
    chunk_bytes: int | None = None,
    **kwargs,
) -> tuple[list[str], list[str], np.ndarray, np.ndarray, np.ndarray]:
    """:func:`load_ratings_jsonl` over line-aligned chunks, merging the
    per-chunk dense id spaces -- the bounded-RSS bulk training read.

    A single whole-buffer scan materializes [n_lines, 11] int64 span
    tables (~176 bytes/line: gigabytes at 10^7 events) next to the raw
    buffer; chunking keeps the span tables at O(chunk) while the merged
    outputs stay compact numpy arrays.
    """
    if chunk_bytes is None:
        chunk_bytes = SCAN_CHUNK_BYTES
    if len(data) <= chunk_bytes:
        return load_ratings_jsonl(data, **kwargs)
    merge = DenseMerge()
    for chunk in _line_aligned_chunks(data, chunk_bytes):
        merge.add(*load_ratings_jsonl(chunk, **kwargs))
    return merge.result()
