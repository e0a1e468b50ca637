"""Incremental event-log follower with a durable per-source cursor.

Port of ``predictionio_tpu/realtime/tailer.py``. One tailer follows one
(app, channel) stream of an Events DAO and delivers each event at most
once across polls and restarts. The cursor mode is picked from the
backend's capabilities:

- **seq** -- the backend answers ``tail_end()`` (sqlite rowid, memory
  insertion seq): the store hands us events past an opaque monotone
  cursor; boundary re-delivery is deduped by event id.
- **generic** -- neither: fall back to ``change_token`` + full ``find``
  filtered by the attach watermark. Correct but O(store) per change.

The JAX package's third mode, **files** (per-file byte offsets on a
store with ``tail_files()``: jsonl, partitioned), and its columnar
decode come with those stores (``ROADMAP.md`` queue 1, item 5); the
port has no such store yet, and a tailer handed one raises.

The cursor persists as JSON (tmp + atomic replace) in the JAX package's
format, so either package's tailer resumes the other's cursor file. A
fresh tailer attaches AT THE END of the stream (the batch layer owns
history; the speed layer only folds what arrives after deploy), and
``reset()`` re-attaches at the end after a retrain.
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path

from predictionio_tpu_torch import faults
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.obs import metrics as obs_metrics

logger = logging.getLogger(__name__)

_CURSOR_VERSION = 1


class TailedBatch:
    """What one :meth:`EventTailer.poll_columnar` returned: an ordered
    list of segments. On the port's stores every segment is a
    ``list[Event]`` (the object path); the JAX package's array segments
    come with its files mode."""

    __slots__ = ("segments",)

    def __init__(self, segments: list):
        self.segments = [s for s in segments if len(s)]

    @property
    def n_events(self) -> int:
        return sum(len(s) for s in self.segments)

    def creation_timestamps(self) -> list[float]:
        """Epoch creation stamps of every delivered event (absent ones
        skipped) -- the freshness-lineage input for observe_commit."""
        return [
            e.creation_time.timestamp()
            for s in self.segments
            for e in s
            if e.creation_time is not None
        ]


class EventTailer:
    """Follow one (app, channel) event stream with a durable cursor.

    ``cursor_path=None`` keeps the cursor in memory only (tests, bench);
    otherwise every poll that moved the cursor persists it atomically.
    """

    def __init__(
        self,
        events,
        app_id: int,
        channel_id: int | None = None,
        cursor_path: str | Path | None = None,
        batch_limit: int = 5000,
    ):
        self._events = events
        self._app_id = app_id
        self._channel_id = channel_id
        self._cursor_path = Path(cursor_path) if cursor_path else None
        self._batch_limit = int(batch_limit)
        if callable(getattr(events, "tail_files", None)):
            raise NotImplementedError(
                "tailing a file-log store (tail_files: jsonl, partitioned) is "
                "a later slice of the PyTorch port (ROADMAP.md queue 1, item 5)"
            )
        if events.tail_end(app_id, channel_id) is not None:
            self.mode = "seq"
        else:
            self.mode = "generic"
        self._files: dict[str, dict] = {}
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
        if self.mode == "seq":
            self._seq = self._events.tail_end(self._app_id, self._channel_id)
        self._dirty = True
        self._save()

    def _load(self) -> bool:
        if self._cursor_path is None or not self._cursor_path.exists():
            return False
        # any corruption -- torn/truncated JSON, valid JSON with the wrong
        # structure (non-dict, malformed file cursors, non-numeric
        # watermark) -- degrades to False: the caller re-attaches at the
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
            # the files mode's cursors, read as the JAX tailer reads them,
            # so a malformed one is corrupt in both packages
            files = {
                p: {k: c[k] for k in ("offset", "ino", "mtime_ns", "size")}
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
            "files": self._files,
            "seen": sorted(self._seen),
        }
        self._cursor_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self._cursor_path.with_name(self._cursor_path.name + ".tmp")
        tmp.write_text(json.dumps(state))
        faults.fault_point("storage.rename")
        os.replace(tmp, self._cursor_path)

    def persist(self) -> None:
        """Force the cursor to disk if it moved since the last save --
        the graceful-shutdown flush (the speed layer calls this on stop
        so a drained process re-attaches exactly where it left off)."""
        self._save()

    # -- polling ------------------------------------------------------------

    def poll(self, limit: int | None = None) -> list[Event]:
        """Events appended since the last poll, at most ``limit``
        (default: the tailer's batch_limit). Persists the moved cursor
        before returning, so a crash after poll never re-delivers."""
        limit = self._batch_limit if limit is None else int(limit)
        if self.mode == "seq":
            out = self._poll_seq(limit)
        else:
            out = self._poll_generic(limit)
        self._save()
        return out

    def poll_columnar(self, limit: int | None = None) -> TailedBatch:
        """:meth:`poll` wrapped in a one-segment :class:`TailedBatch`: what
        the JAX tailer delivers on the seq and generic modes."""
        events = self.poll(limit)  # poll() persists the cursor
        return TailedBatch([events] if events else [])

    def _mark_seen(self, event: Event) -> bool:
        """True if the event is new (and now remembered)."""
        eid = event.event_id
        if eid is None:
            return True
        if eid in self._seen:
            return False
        self._seen.add(eid)
        return True

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
            # only advance the token when the scan was complete --
            # otherwise the rest of the backlog would be skipped
            self._token = token
        if out:
            self._dirty = True
        return out

    # -- staleness ----------------------------------------------------------

    def events_behind(self) -> int | None:
        """Estimated undelivered events (upper bound: deletes and
        replaced records count too), or None when unknowable cheaply."""
        if self.mode == "seq":
            end = self._events.tail_end(self._app_id, self._channel_id)
            if isinstance(end, int) and isinstance(self._seq, int):
                return max(0, end - self._seq)
            return None
        token = self._events.change_token(self._app_id, self._channel_id)
        return 0 if token is not None and token == self._token else None
