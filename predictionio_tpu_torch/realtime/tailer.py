"""Incremental event-log follower with a durable per-source cursor.

Port of ``predictionio_tpu/realtime/tailer.py``, copied whole with its
imports rewritten and one repair: a broken-lineage re-read that a poll
stops part way keeps filtering by the attach watermark to the end of the
file (``_REREAD``), where the JAX tailer delivers the rest of the file's
pre-attach history as new. Its cursor files are the JAX package's, so
either package's tailer resumes the other's. One tailer follows one (app,
channel) stream of an Events DAO and delivers each event at most once
across polls, restarts, log rotation, and torn trailing writes. The cursor mode is picked from the backend's
capabilities:

- **files** — the backend exposes ``tail_files()`` (jsonl, partitioned):
  per-file byte offsets, each keyed by ``(inode, mtime_ns, size)``
  lineage. A compaction/rotation replaces the inode (or shrinks the
  file below our offset); that breaks lineage, so the file is re-read
  from byte 0 with watermark + seen-id dedupe suppressing records that
  were already delivered or predate the attach point.
- **seq** — the backend answers ``tail_end()`` (sqlite rowid, postgres
  creationtime, memory insertion seq): the store hands us events past an
  opaque monotone cursor; boundary re-delivery is deduped by event id.
- **generic** — neither: fall back to ``change_token`` + full ``find``
  filtered by the attach watermark. Correct but O(store) per change;
  only the capability floor, every bundled backend has a better mode.

The cursor persists as JSON (tmp + atomic replace) so a restarted
process resumes exactly where it stopped — no double-counting, no
skipping. A fresh tailer attaches AT THE END of the stream (the batch
layer owns history; the speed layer only folds what arrives after
deploy), and ``reset()`` re-attaches at the end after a retrain.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from pathlib import Path

from predictionio_tpu_torch import faults
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.obs import metrics as obs_metrics
from predictionio_tpu_torch.obs import trace as obs_trace

logger = logging.getLogger(__name__)

# columnar/object split of the columnar poll mode's decode, per line
# (docs/observability.md): lines that went straight to arrays vs lines
# routed to the per-line object parser (mixed-stream fallbacks, chunks
# that failed or were fault-injected at tail.decode)
_m_col_lines = obs_metrics.counter(
    "pio_tailer_columnar_lines_total",
    "Log lines the columnar tail path decoded straight to arrays",
)
_m_col_fallback = obs_metrics.counter(
    "pio_tailer_columnar_fallback_lines_total",
    "Log lines the columnar tail path routed to the object parser",
)

_CURSOR_VERSION = 1
# cap for the events_behind estimate scan, per file
_BEHIND_SCAN_CAP = 4 * 1024 * 1024
# cap for one poll's read of a single file: far behind a burst the
# unread remainder can dwarf what the batch limit lets one poll deliver
_READ_CAP = 16 * 1024 * 1024
# a file cursor's ``mtime_ns`` while a broken-lineage re-read stopped part
# way through the file (the batch limit or the read cap): the rest of the
# re-read still filters by the attach watermark, or pre-attach history
# beyond the stop would deliver as new. Any other part-way cursor holds -1.
_REREAD = -2


@dataclasses.dataclass
class _FileCursor:
    """Byte offset into one log file plus the lineage it belongs to.

    ``offset`` is only meaningful for the file identified by ``ino``
    with a size that never went below ``offset`` — a new inode or a
    shrink means the log was rewritten and the offset is void."""

    offset: int
    ino: int
    mtime_ns: int
    size: int


def _end_offset(path: Path) -> int:
    """Offset just past the last complete line (trailing newline).

    Scans backwards in blocks so attaching to a log with a torn final
    line (a writer died mid-append) doesn't leave the cursor pointing
    into the torn bytes — the torn line re-delivers whole once the
    writer (or compaction) completes it."""
    try:
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            pos = size
            while pos > 0:
                step = min(65536, pos)
                f.seek(pos - step)
                block = f.read(step)
                nl = block.rfind(b"\n")
                if nl >= 0:
                    return pos - step + nl + 1
                pos -= step
            return 0
    except OSError:
        return 0


class TailedBatch:
    """What one :meth:`EventTailer.poll_columnar` returned: an ordered
    list of segments, each either a ``list[Event]`` (object path) or a
    :class:`colspans.ColumnarTail` (array path). Counts and freshness
    stamps are uniform across both so the speed layer never branches."""

    __slots__ = ("segments",)

    def __init__(self, segments: list):
        self.segments = [s for s in segments if _seg_len(s)]

    @property
    def n_events(self) -> int:
        return sum(_seg_len(s) for s in self.segments)

    def creation_timestamps(self) -> list[float]:
        """Epoch creation stamps of every delivered event (absent ones
        skipped) — the freshness-lineage input for observe_commit."""
        out: list[float] = []
        for s in self.segments:
            if isinstance(s, list):
                out.extend(
                    e.creation_time.timestamp()
                    for e in s
                    if e.creation_time is not None
                )
            else:
                ts = s.creation_ts
                out.extend(ts[~_np_isnan(ts)].tolist())
        return out


def _seg_len(seg) -> int:
    return seg.n_rows if hasattr(seg, "n_rows") else len(seg)


def _np_isnan(arr):
    import numpy as np

    return np.isnan(arr)


class EventTailer:
    """Follow one (app, channel) event stream with a durable cursor.

    ``cursor_path=None`` keeps the cursor in memory only (tests, bench);
    otherwise every poll that moved the cursor persists it atomically.

    ``columnar_config`` (a :class:`colspans.DecodeConfig`) arms the
    columnar poll mode: :meth:`poll_columnar` then decodes rate-shaped
    chunks straight to arrays instead of per-line Event objects.
    """

    def __init__(
        self,
        events,
        app_id: int,
        channel_id: int | None = None,
        cursor_path: str | Path | None = None,
        batch_limit: int = 5000,
        columnar_config=None,
    ):
        self._events = events
        self._app_id = app_id
        self._channel_id = channel_id
        self._cursor_path = Path(cursor_path) if cursor_path else None
        self._batch_limit = int(batch_limit)
        self._columnar_config = columnar_config
        if callable(getattr(events, "tail_files", None)):
            self.mode = "files"
        elif events.tail_end(app_id, channel_id) is not None:
            self.mode = "seq"
        else:
            self.mode = "generic"
        self._files: dict[str, _FileCursor] = {}
        self._seq: object | None = None
        self._token: object | None = None
        self._watermark: float = 0.0
        self._seen: set[str] = set()
        self._dirty = False
        if not self._load():
            self.reset()

    # -- cursor lifecycle ---------------------------------------------------

    def reset(self) -> None:
        """Re-attach at the current end of the stream.

        Called at first attach and after a retrain supersedes the fold-in
        state: everything up to now is (or will be) covered by the batch
        layer, so the speed layer starts clean from here."""
        self._seen = set()
        self._watermark = time.time()
        self._files = {}
        self._token = None
        if self.mode == "files":
            for path in self._events.tail_files(self._app_id, self._channel_id):
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                self._files[str(path)] = _FileCursor(
                    _end_offset(Path(path)), st.st_ino, st.st_mtime_ns, st.st_size
                )
        elif self.mode == "seq":
            self._seq = self._events.tail_end(self._app_id, self._channel_id)
        self._dirty = True
        self._save()

    def _load(self) -> bool:
        if self._cursor_path is None or not self._cursor_path.exists():
            return False
        # any corruption — torn/truncated JSON, valid JSON with the wrong
        # structure (non-dict, missing _FileCursor fields, non-numeric
        # watermark) — degrades to False: the caller re-attaches at the
        # watermark (reset()) instead of crashing the speed layer
        try:
            state = json.loads(self._cursor_path.read_text())
            if state.get("version") != _CURSOR_VERSION or state.get("mode") != self.mode:
                logger.warning(
                    "tailer cursor %s is for mode %r (we are %r); resetting",
                    self._cursor_path,
                    state.get("mode"),
                    self.mode,
                )
                return False
            watermark = float(state.get("watermark", 0.0))
            seen = set(state.get("seen", ()))
            seq = state.get("seq")
            files = {
                p: _FileCursor(c["offset"], c["ino"], c["mtime_ns"], c["size"])
                for p, c in state.get("files", {}).items()
            }
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            logger.warning(
                "corrupt tailer cursor %s; re-attaching at the watermark",
                self._cursor_path,
            )
            obs_metrics.counter(
                "pio_tailer_cursor_recovered",
                "Tailer restarts that discarded a corrupt cursor file",
            ).inc()
            return False
        self._watermark = watermark
        self._seen = seen
        self._seq = seq
        self._token = None  # change tokens don't survive restart; re-scan
        self._files = files
        return True

    def _save(self) -> None:
        if not self._dirty:
            return
        self._dirty = False
        if self._cursor_path is None:
            return
        state = {
            "version": _CURSOR_VERSION,
            "mode": self.mode,
            "watermark": self._watermark,
            "seq": self._seq,
            "files": {
                p: dataclasses.asdict(c) for p, c in self._files.items()
            },
            "seen": sorted(self._seen),
        }
        self._cursor_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self._cursor_path.with_name(self._cursor_path.name + ".tmp")
        tmp.write_text(json.dumps(state))
        faults.fault_point("storage.rename")
        os.replace(tmp, self._cursor_path)

    def persist(self) -> None:
        """Force the cursor to disk if it moved since the last save —
        the graceful-shutdown flush (the speed layer calls this on
        stop so a drained process re-attaches exactly where it left
        off instead of re-delivering the last batch window)."""
        self._save()

    # -- polling ------------------------------------------------------------

    def poll(self, limit: int | None = None) -> list[Event]:
        """Events appended since the last poll, at most ``limit``
        (default: the tailer's batch_limit). Persists the moved cursor
        before returning, so a crash after poll never re-delivers."""
        limit = self._batch_limit if limit is None else int(limit)
        if self.mode == "files":
            out = self._poll_files(limit)
        elif self.mode == "seq":
            out = self._poll_seq(limit)
        else:
            out = self._poll_generic(limit)
        self._save()
        return out

    def _mark_seen(self, event: Event) -> bool:
        """True if the event is new (and now remembered)."""
        eid = event.event_id
        if eid is None:
            return True
        if eid in self._seen:
            return False
        self._seen.add(eid)
        return True

    def _parse_line(self, raw: bytes) -> Event | None:
        line = raw.strip()
        if not line or line.startswith(b'{"$delete"'):
            return None
        try:
            return Event.from_json(line.decode("utf-8"))
        except (ValueError, KeyError, UnicodeDecodeError) as err:
            logger.warning("tailer: skipping unparseable log line: %s", err)
            return None

    def _read_file(self, path):
        """Open + fstat + capped read of one tailed file. Returns
        ``(st, fresh, start, buf, capped)`` or None when the file is
        unreadable or unchanged since the last poll."""
        key = str(path)
        try:
            f = open(path, "rb")
        except OSError:
            return None
        with f:
            # fstat AFTER open: a rotation between a stat and the open
            # could otherwise pair old lineage with new bytes
            st = os.fstat(f.fileno())
            cur = self._files.get(key)
            fresh = (
                cur is None
                or st.st_ino != cur.ino
                or st.st_size < cur.offset
            )
            rereading = not fresh and cur.mtime_ns == _REREAD
            if (
                not fresh
                and st.st_size == cur.size
                and st.st_mtime_ns == cur.mtime_ns
            ):
                return None  # unchanged since last poll
            start = 0 if fresh else cur.offset
            f.seek(start)
            # bound the read to the fstat'ed size: bytes appended
            # after the fstat belong to the next poll's lineage.
            # Also cap the read: far behind a burst, the remainder
            # can be 100s of MB while the batch limit only lets one
            # poll deliver a few MB of lines — reading it all every
            # poll would make catch-up quadratic in the backlog.
            to_read = max(0, st.st_size - start)
            capped = to_read > _READ_CAP
            buf = f.read(_READ_CAP if capped else to_read)
        # ``fresh`` from here on: the read filters by the watermark
        return st, fresh or rereading, start, buf, capped

    def _consume_object(
        self, key, st, buf, start, fresh, capped, remaining
    ) -> list[Event]:
        """Deliver one read buffer through the Event path and advance
        the file cursor (object poll mode, and the columnar mode's
        whole-chunk fallback)."""
        out: list[Event] = []
        consumed = 0
        truncated = capped
        # bulk fast path: hand every complete line in the buffer to
        # the native span scanner in one call (~an order of magnitude
        # cheaper than per-line Event.from_json — this is what keeps
        # seconds_behind bounded under a wire-speed ingest burst).
        # Bail to the per-line loop when the chunk carries tombstones
        # (the scanner has no $delete shape) or fails to parse.
        end = buf.rfind(b"\n") + 1
        chunk = buf[:end]
        parsed = None
        if chunk and b'"$delete"' not in chunk:
            if chunk.count(b"\n") > remaining:
                # trim to the remaining-limit'th newline; the rest of
                # the buffer is re-read on the next poll
                cut = -1
                for _ in range(remaining):
                    cut = chunk.find(b"\n", cut + 1)
                chunk = chunk[: cut + 1]
                truncated = True
            try:
                from predictionio_tpu_torch.data.storage import colspans

                parsed = colspans.parse_events(chunk)
            except (ValueError, KeyError, UnicodeDecodeError) as err:
                logger.warning(
                    "tailer: bulk parse failed, falling back "
                    "per-line: %s",
                    err,
                )
                parsed = None
                truncated = capped
        if parsed is not None:
            consumed = len(chunk)
            for event in parsed:
                if (
                    fresh
                    and event.creation_time.timestamp()
                    <= self._watermark
                ):
                    continue
                if self._mark_seen(event):
                    out.append(event)
            self._finish_file(key, st, start + consumed, truncated, fresh)
            return out
        pos = 0
        while pos < len(buf):
            nl = buf.find(b"\n", pos)
            if nl < 0:
                break  # torn trailing line: wait for the newline
            if len(out) >= remaining:
                truncated = True
                break
            raw = buf[pos:nl]
            pos = nl + 1
            consumed = pos
            event = self._parse_line(raw)
            if event is None:
                continue
            if fresh and event.creation_time.timestamp() <= self._watermark:
                # rewrite resurfaced pre-attach history; not ours
                continue
            if self._mark_seen(event):
                out.append(event)
        self._finish_file(key, st, start + consumed, truncated, fresh)
        return out

    def _poll_files(self, limit: int) -> list[Event]:
        out: list[Event] = []
        for path in self._events.tail_files(self._app_id, self._channel_id):
            if len(out) >= limit:
                break
            read = self._read_file(path)
            if read is None:
                continue
            st, fresh, start, buf, capped = read
            out.extend(
                self._consume_object(
                    str(path), st, buf, start, fresh, capped,
                    limit - len(out),
                )
            )
        return out

    # -- columnar poll mode -------------------------------------------------

    def poll_columnar(self, limit: int | None = None) -> TailedBatch:
        """Like :meth:`poll`, but rate-shaped chunks decode straight to
        :class:`colspans.ColumnarTail` arrays (no per-line Event
        objects). Cursor, rotation, torn-line, and dedupe semantics are
        identical to :meth:`poll`; streams the classifier can't take
        fall back to the object path per chunk or per line. Modes other
        than "files" (and degraded no-native installs) deliver the
        plain object poll wrapped in a one-segment batch."""
        from predictionio_tpu_torch import native

        limit = self._batch_limit if limit is None else int(limit)
        if (
            self.mode != "files"
            or self._columnar_config is None
            or not native.native_available()
        ):
            events = self.poll(limit)  # poll() persists the cursor
            return TailedBatch([events] if events else [])
        segments = self._poll_files_columnar(limit)
        self._save()
        return TailedBatch(segments)

    def _poll_files_columnar(self, limit: int) -> list:
        segments: list = []
        delivered = 0
        for path in self._events.tail_files(self._app_id, self._channel_id):
            if delivered >= limit:
                break
            read = self._read_file(path)
            if read is None:
                continue
            st, fresh, start, buf, capped = read
            key = str(path)
            remaining = limit - delivered
            if fresh:
                # broken lineage (rotation/compaction/attach): the re-read
                # from byte 0 needs watermark + per-event dedupe filtering,
                # which is exactly the object path's job
                segs = [
                    self._consume_object(
                        key, st, buf, start, True, capped, remaining
                    )
                ]
            else:
                segs = self._consume_columnar(
                    key, st, buf, start, capped, remaining
                )
            for seg in segs:
                n = _seg_len(seg)
                if n:
                    segments.append(seg)
                    delivered += n
        return segments

    def _consume_columnar(
        self, key, st, buf, start, capped, remaining
    ) -> list:
        """Deliver one read buffer through the span->array decoder.

        The complete-line prefix of the buffer goes to the decoder in
        one call; a chunk cut mid-line by the read cap hands only that
        clean prefix over and records an offset-only cursor for the
        remainder (no re-read of decoded bytes, no double-fold). Any
        decode failure — including an injected ``tail.decode`` fault —
        falls back to the object path for the whole chunk, counted in
        ``pio_tailer_columnar_fallback_lines_total``."""
        from predictionio_tpu_torch.data.storage import colspans

        end = buf.rfind(b"\n") + 1
        chunk = buf[:end]
        truncated = capped
        if not chunk:
            # torn-only buffer: wait for the writer to finish the line
            self._finish_file(key, st, start, truncated)
            return []
        if b'"$delete"' in chunk:
            # tombstones have no rate shape; the object path skips them
            return [
                self._consume_object(
                    key, st, buf, start, False, capped, remaining
                )
            ]
        if chunk.count(b"\n") > remaining:
            cut = -1
            for _ in range(remaining):
                cut = chunk.find(b"\n", cut + 1)
            chunk = chunk[: cut + 1]
            truncated = True
        t0 = time.perf_counter()
        try:
            faults.fault_point("tail.decode")
            tail = colspans.decode_tail(chunk, self._columnar_config)
        except Exception as err:
            logger.warning(
                "tailer: columnar decode failed, falling back to the "
                "object path: %s", err,
            )
            _m_col_fallback.inc(chunk.count(b"\n"))
            return [
                self._consume_object(
                    key, st, buf, start, False, capped, remaining
                )
            ]
        # seen-id dedupe must stay sequential (an id can repeat within
        # one chunk — replacement events — and across polls after a
        # rotation re-read); rows without an id always deliver
        drop: list[int] = []
        for i, eid in enumerate(tail.event_ids):
            if eid is None:
                continue
            if eid in self._seen:
                drop.append(i)
            else:
                self._seen.add(eid)
        if drop:
            import numpy as np

            keep = np.ones(tail.n_rows, dtype=bool)
            keep[drop] = False
            tail = tail.select(keep)
        fb_events: list[Event] = []
        if len(tail.fallback_lines):
            # mixed stream: the classifier routed these line numbers to
            # the object parser ($set payloads, non-rate events, odd
            # syntax) — same per-line loop the object path runs
            lines = chunk.split(b"\n")
            for i in tail.fallback_lines:
                event = self._parse_line(lines[i])
                if event is None:
                    continue
                if self._mark_seen(event):
                    fb_events.append(event)
        t1 = time.perf_counter()
        _m_col_lines.inc(tail.n_rows)
        _m_col_fallback.inc(len(tail.fallback_lines))
        tr = obs_trace.current_trace()
        if tr is not None:
            tr.add_span("tail.decode", t0, t1)
        self._finish_file(key, st, start + len(chunk), truncated)
        out: list = [tail]
        if fb_events:
            out.append(fb_events)
        return out

    def _finish_file(
        self, key, st, new_offset: int, truncated: bool, fresh: bool = False
    ) -> None:
        if truncated:
            # stop mid-file: record the offset but NOT the stat, so
            # the next poll re-reads the remainder
            self._files[key] = _FileCursor(
                new_offset, st.st_ino, _REREAD if fresh else -1, -1
            )
        else:
            self._files[key] = _FileCursor(
                new_offset, st.st_ino, st.st_mtime_ns, st.st_size
            )
        self._dirty = True

    def _poll_seq(self, limit: int) -> list[Event]:
        got = self._events.tail_events(
            self._app_id, self._channel_id, after=self._seq, limit=limit
        )
        if got is None:  # capability vanished (shouldn't happen)
            return []
        events, cursor = got
        if cursor != self._seq:
            self._seq = cursor
            self._dirty = True
        out = [e for e in events if self._mark_seen(e)]
        if out:
            self._dirty = True
        return out

    def _poll_generic(self, limit: int) -> list[Event]:
        token = self._events.change_token(self._app_id, self._channel_id)
        if token is not None and token == self._token:
            return []
        out: list[Event] = []
        truncated = False
        for event in self._events.find(self._app_id, self._channel_id):
            if event.creation_time.timestamp() <= self._watermark:
                continue
            if not self._mark_seen(event):
                continue
            out.append(event)
            if len(out) >= limit:
                truncated = True
                break
        if not truncated:
            # only advance the token when the scan was complete —
            # otherwise the rest of the backlog would be skipped
            self._token = token
        if out:
            self._dirty = True
        return out

    # -- staleness ----------------------------------------------------------

    def events_behind(self) -> int | None:
        """Estimated undelivered events (upper bound: deletes and
        replaced records count too), or None when unknowable cheaply."""
        if self.mode == "files":
            behind = 0
            for path in self._events.tail_files(self._app_id, self._channel_id):
                cur = self._files.get(str(path))
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                if (
                    cur is not None
                    and st.st_ino == cur.ino
                    and st.st_size == cur.size
                    and st.st_mtime_ns == cur.mtime_ns
                ):
                    continue
                start = (
                    cur.offset
                    if cur is not None
                    and st.st_ino == cur.ino
                    and st.st_size >= cur.offset
                    else 0
                )
                try:
                    with open(path, "rb") as f:
                        f.seek(start)
                        behind += f.read(_BEHIND_SCAN_CAP).count(b"\n")
                except OSError:
                    continue
            return behind
        if self.mode == "seq":
            end = self._events.tail_end(self._app_id, self._channel_id)
            if isinstance(end, int) and isinstance(self._seq, int):
                return max(0, end - self._seq)
            return None  # float cursors (postgres) aren't countable
        token = self._events.change_token(self._app_id, self._channel_id)
        return 0 if token is not None and token == self._token else None
