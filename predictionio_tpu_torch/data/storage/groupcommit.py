"""Group-commit fsync coalescing for append-only event logs.

Port of ``predictionio_tpu/data/storage/groupcommit.py``, copied whole
with its imports rewritten.

The single-event ingest path (reference EventServer.scala:261-390 — its
production write path) was bottlenecked at one fsync per request:
~590 events/s regardless of CPU. Group commit keeps the durability
contract (a request is acked only after its bytes are known durable)
while letting ONE fsync cover every append that landed in the page
cache before it started — the classic WAL group-commit, per log file.

Protocol (per file):

1. writer appends + flushes under the file's append lock (data is in
   the page cache, ordered before any later fsync), then takes a
   sequence number with :meth:`FsyncCoalescer.note_write` while still
   holding that lock;
2. OUTSIDE the lock, the writer calls :meth:`wait_durable`. The first
   waiter becomes the syncer: it fsyncs the file once, covering every
   sequence number issued before the fsync started; the rest just wait.
   Under contention, N requests pay ~1 fsync, not N.

Rotation hooks: seal/compact/remove replace or delete the log file, so
a later ``open(path) + fsync`` would target the WRONG inode. Those
paths run under the append lock (no writes in flight), make the old
bytes durable themselves (fsync-before-rename, or deletion making
durability moot), and then call :meth:`mark_all_durable` so pending
waiters complete instead of fsyncing a replaced file.

Sync modes: the backends ack in one of two durability modes (the
``sync`` source property):

- ``always`` (default): ack after a covering fsync (the protocol
  above) — stronger than the reference, whose HBase WAL default is
  hflush (replica memory, not disk).
- ``interval[:ms]``: ack after write+flush — the bytes are in the OS
  page cache, so they survive a PROCESS crash (the reference's hflush
  semantics); a background :class:`CoalescerMap` thread fsyncs pending
  logs every ``ms`` (default 50), bounding the loss window on a kernel
  crash/power failure to one interval. Single-event REST ingest is
  fsync-bound sequentially (a lone client can never share its fsync),
  so this is the knob that lifts it to reference-parity throughput.
"""

from __future__ import annotations

import logging
import os
import threading

from predictionio_tpu_torch import faults

logger = logging.getLogger(__name__)


def parse_sync_mode(value: str | None) -> float | None:
    """``sync`` source property -> fsync interval in seconds, or None
    for always-fsync. Accepts ``always``, ``interval``, ``interval:ms``."""
    if value is None or value == "" or value == "always":
        return None
    if value == "interval":
        return 0.05
    if value.startswith("interval:"):
        import math

        ms = float(value.split(":", 1)[1])
        # nan would spin the syncer thread (wait(nan) returns
        # immediately); inf would never run it (unbounded loss window)
        if not (ms > 0) or math.isinf(ms):
            raise ValueError(
                f"sync interval must be positive and finite, got {value!r}"
            )
        return ms / 1e3
    raise ValueError(
        f"sync must be 'always', 'interval', or 'interval:<ms>', got {value!r}"
    )


class FsyncCoalescer:
    """One instance per log file; see module docstring for the protocol."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._seq = 0  # issued to writers after their flushed append
        self._synced = 0  # highest seq known durable
        self._syncing = False

    def backlog(self) -> int:
        """Appends acked to the page cache but not yet covered by an
        fsync — the group-commit queue depth this file contributes to
        the event server's backpressure stats."""
        with self._cond:
            return self._seq - self._synced

    def note_write(self) -> int:
        """Take a sequence number for an append already flushed to the
        page cache. Call while still holding the file's append lock (the
        number must order before any append that follows)."""
        with self._cond:
            self._seq += 1
            return self._seq

    def mark_all_durable(self) -> None:
        """All sequence numbers issued so far are durable (or moot):
        called by seal/compact/remove under the append lock after they
        fsync'ed (or deleted) the log themselves."""
        with self._cond:
            self._synced = self._seq
            self._cond.notify_all()

    def _fsync_and_mark(self, path, target: int) -> None:
        """The syncer body shared by ``wait_durable`` and ``sync_now``:
        fsync ``path`` (a missing file means it was rotated/removed —
        whoever replaced it owned durability, see module doc) and mark
        ``target`` durable. Caller must have set ``_syncing`` under the
        condition with ``target = self._seq``."""
        ok = False
        try:
            try:
                fd = os.open(str(path), os.O_RDONLY)
            except FileNotFoundError:
                ok = True
            else:
                try:
                    faults.fault_point("storage.fsync")
                    os.fsync(fd)
                    ok = True
                finally:
                    os.close(fd)
        finally:
            with self._cond:
                self._syncing = False
                if ok:
                    self._synced = max(self._synced, target)
                self._cond.notify_all()

    def wait_durable(self, my_seq: int, path) -> None:
        """Block until an fsync covering ``my_seq`` has completed,
        becoming the syncer if none is running. Raises the fsync's
        OSError to the syncer; other waiters retry with a new syncer."""
        while True:
            with self._cond:
                if self._synced >= my_seq:
                    return
                if self._syncing:
                    self._cond.wait()
                    continue
                self._syncing = True
                target = self._seq
            self._fsync_and_mark(path, target)

    def sync_now(self, path) -> None:
        """Fsync ``path`` if any issued sequence is not yet durable,
        without blocking on another syncer (the interval thread's
        entry point; a concurrent ``wait_durable`` syncer covers us)."""
        with self._cond:
            if self._synced >= self._seq or self._syncing:
                return
            self._syncing = True
            target = self._seq
        self._fsync_and_mark(path, target)


class CoalescerMap:
    """Thread-safe path -> FsyncCoalescer registry (one per client).

    With ``interval_s`` set, a daemon thread (started lazily on first
    ``get``) fsyncs every registered log with undurable appends each
    interval — the ``sync=interval`` mode's background syncer."""

    def __init__(self, interval_s: float | None = None) -> None:
        self._lock = threading.Lock()
        self._map: dict[str, FsyncCoalescer] = {}
        self._interval = interval_s
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def get(self, path) -> FsyncCoalescer:
        key = str(path)
        with self._lock:
            got = self._map.get(key)
            if got is None:
                got = self._map[key] = FsyncCoalescer()
            if (
                self._interval is not None
                and self._thread is None
            ):
                self._thread = threading.Thread(
                    target=self._interval_loop, daemon=True
                )
                self._thread.start()
            return got

    def stop(self) -> None:
        self._stop.set()

    def backlog(self) -> int:
        """Total undurable appends across every registered log."""
        with self._lock:
            committers = list(self._map.values())
        return sum(c.backlog() for c in committers)

    def sync_all(self) -> None:
        """Force-fsync every registered log now — the graceful-shutdown
        flush (server drain hooks): nothing acked may be lost to an
        uncovered coalescer window when the process exits."""
        with self._lock:
            items = list(self._map.items())
        for key, committer in items:
            committer.sync_now(key)

    def _interval_loop(self) -> None:
        while not self._stop.wait(self._interval):
            with self._lock:
                items = list(self._map.items())
            for key, committer in items:
                try:
                    committer.sync_now(key)
                except OSError:  # pragma: no cover - disk error: retry next tick
                    logger.exception("interval fsync of %s failed", key)
