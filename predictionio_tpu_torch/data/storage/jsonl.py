"""Append-log (JSON-lines) event backend.

Port of ``predictionio_tpu/data/storage/jsonl.py``, copied whole
with its imports rewritten: the files it writes are byte for byte
the JAX package's, so either package reads what the other wrote.

The file-backed analog of the reference's HBase event store
(storage/hbase/src/main/scala/.../HBEventsUtil.scala: table
``events_<appId>[_<ch>]``, log-structured writes): one ``.jsonl`` file per
(app, channel), writes append a put/delete record, reads replay the log
(last write per event id wins — LSM semantics without the compaction
daemon; ``remove`` drops the file, ``compact`` rewrites it).

Capability subset: Events only — like hbase in the reference
(SURVEY §2.3), metadata/models live in another source.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import uuid
from datetime import datetime
from pathlib import Path
from typing import Sequence

import numpy as np

try:  # advisory cross-process locks; Unix-only (this framework targets Linux)
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX fallback: thread lock only
    fcntl = None

from predictionio_tpu_torch import faults
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.obs import metrics as obs_metrics
from predictionio_tpu_torch.data.storage import base, columnar_cache
from predictionio_tpu_torch.data.storage.memory import query_events

logger = logging.getLogger(__name__)

# chunk size for bounded-RSS bulk reads: past this buffer size the
# columnar read proves cleanliness and extracts ratings in line-aligned
# chunks so peak RSS stays O(buffer + chunk), not O(buffer + spans).
# Defined once in native (span tables cost ~176 bytes/line).
from predictionio_tpu_torch.native import SCAN_CHUNK_BYTES  # noqa: E402


def fold_jsonl_file(
    path: Path, table: dict[str, Event], deleted: set[str] | None = None
) -> None:
    """Fold one event log into ``table``: records upsert by event id,
    ``{"$delete": id}`` markers pop — the shared last-write-wins replay
    used by the jsonl and partitioned backends. When ``deleted`` is given
    it accumulates the ids whose *final* state is deleted (a re-insert
    after a delete removes the id again)."""
    if not path.exists():
        return
    with open(path) as f:
        for raw in f:
            # only the FINAL line of a log can legitimately be torn (a
            # writer killed mid-append before its newline); a corrupt
            # line anywhere else is real damage and still raises
            complete = raw.endswith("\n")
            line = raw.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                if complete:
                    raise
                logger.warning(
                    "dropping torn trailing record in %s (writer died "
                    "mid-append; the event was never acked)", path
                )
                obs_metrics.counter(
                    "pio_storage_torn_tail_dropped_total",
                    "Torn (unacked) trailing log records dropped at replay",
                ).inc()
                break
            if "$delete" in rec:
                eid = rec["$delete"]
                table.pop(eid, None)
                if deleted is not None:
                    deleted.add(eid)
            else:
                e = Event.from_dict(rec)
                table[e.event_id] = e
                if deleted is not None:
                    deleted.discard(e.event_id)


def truncate_torn_tail(path: Path) -> int:
    """Crash recovery for an append-only log: if the final line lacks
    its newline (a writer was killed mid-append), truncate back to the
    last complete record; returns the bytes dropped.

    Must run BEFORE the first post-crash append — a new record written
    after torn bytes would concatenate into one corrupt MID-file line,
    which replay correctly refuses (only a final line may be torn).
    Dropping the tail is safe: acks happen after write+flush at minimum,
    and a completed flush puts the whole line in the page cache, which
    a process kill does not tear — so torn bytes are never acked."""
    try:
        with open(path, "r+b") as f:
            size = os.fstat(f.fileno()).st_size
            if size == 0:
                return 0
            f.seek(size - 1)
            if f.read(1) == b"\n":
                return 0
            pos = size
            last_nl = -1
            while pos > 0:
                step = min(65536, pos)
                f.seek(pos - step)
                block = f.read(step)
                nl = block.rfind(b"\n")
                if nl >= 0:
                    last_nl = pos - step + nl
                    break
                pos -= step
            keep = last_nl + 1
            f.truncate(keep)
            f.flush()
            os.fsync(f.fileno())
    except FileNotFoundError:
        return 0
    except OSError:  # pragma: no cover - unreadable log: replay will say
        return 0
    dropped = size - keep
    logger.warning(
        "truncated %d torn (unacked) trailing bytes of %s before "
        "reopening for append", dropped, path,
    )
    obs_metrics.counter(
        "pio_storage_torn_tail_truncated_total",
        "Torn trailing bytes truncated at append-reopen after a crash",
    ).inc()
    return dropped


def _maybe_blank_lines(buf: bytes) -> bool:
    """Cheap conservative probe for empty/whitespace-led lines. Stored
    records always start with '{', so a whitespace byte at a line start
    indicates (at worst) a blank line; false positives merely force a
    harmless compaction. Verbatim exports use this: the clean proof
    tolerates blank lines (FLAG_EMPTY), but an export's record count
    and output must not include non-records."""
    return buf.startswith((b"\n", b"\r", b" ", b"\t")) or any(
        p in buf for p in (b"\n\n", b"\n\r", b"\n ", b"\n\t")
    )


def has_delete_markers(buf: bytes) -> bool:
    """Delete MARKERS are whole records ``{"$delete": ...}`` — the probe
    anchors at line starts so a property VALUE containing "$delete"
    (which survives rewriting) can't look like one."""
    return buf.startswith(b'{"$delete"') or b'\n{"$delete"' in buf


def _clean_scan_check(scanned) -> tuple[bool, list[str], int]:
    """Cleanliness predicate over one WHOLE-buffer span scan: returns
    (dirty, unique ids, count of lines with a scanned id). Dirty when
    any id repeats or any line's id wasn't scannable (degraded
    pure-Python mode flags ALL lines, escaped ids flag a few) — either
    could hide a replacement. The chunked path applies the same rule
    with hash-based uniqueness (see _chunked_clean_extract) so it never
    materializes per-id strings; keep the two predicates in lockstep."""
    from predictionio_tpu_torch import native

    ids = scanned.offs[:, native.F_EVENT_ID]
    _, uniq = native.index_spans(
        scanned.buf, ids, scanned.lens[:, native.F_EVENT_ID]
    )
    n_with_id = int((ids >= 0).sum())
    n_lines = int((scanned.flags & native.FLAG_EMPTY == 0).sum())
    return (len(uniq) < n_with_id or n_with_id < n_lines), uniq, n_with_id


def prove_clean(buf: bytes):
    """Prove an event-log buffer replay-clean (no delete markers, unique
    event ids) so a columnar scan can treat it as a plain record set.

    Returns ``(needs_compact, scanned)`` where ``scanned`` is the native
    span scan (reusable by the ratings extraction) or None.
    """
    from predictionio_tpu_torch import native

    if not buf:
        return False, None
    if has_delete_markers(buf):
        return True, None
    scanned = native.scan_events(buf)
    dirty, _, _ = _clean_scan_check(scanned)
    return dirty, scanned


def prove_clean_chunked(buf: bytes, chunk_bytes: int | None = None):
    """Chunked :func:`prove_clean` for multi-GB logs: per-chunk span
    scans (O(chunk) memory) plus a global uniqueness check over 64-bit
    id hashes. A hash collision can only FALSELY flag dirty (forcing a
    harmless compaction) — two equal ids always collide, so a true
    duplicate is never missed. Returns ``(needs_compact, None)``; the
    span scan is not reusable by design (it never exists whole).
    """
    dirty, _ = _chunked_clean_extract(buf, None, chunk_bytes)
    return dirty, None


def _chunked_clean_extract(
    buf: bytes,
    filters: dict | None,
    chunk_bytes: int | None = None,
):
    """One chunked pass proving cleanliness AND (with ``filters``)
    extracting ratings from the same per-chunk span scans — the
    single-scan property of the whole-buffer path, at O(chunk) memory.

    Returns ``(dirty, result)``: dirty means a compaction is required
    and any partial extraction was discarded; result is the
    ``load_ratings_jsonl``-shaped tuple (or None when ``filters`` is
    None — prove-only mode, or when dirty)."""
    from predictionio_tpu_torch import native

    if chunk_bytes is None:
        chunk_bytes = SCAN_CHUNK_BYTES
    if not buf:
        return False, None
    if has_delete_markers(buf):
        return True, None
    hashes: list = []
    total_ids = 0
    merge = native.DenseMerge()
    for chunk in native._line_aligned_chunks(buf, chunk_bytes):
        scanned = native.scan_events(chunk)
        # same predicate as _clean_scan_check, but uniqueness runs over
        # native 64-bit span hashes — no per-id Python strings (millions
        # per chunk); a collision can only over-flag (harmless compact)
        ids_off = scanned.offs[:, native.F_EVENT_ID]
        has_id = ids_off >= 0
        n_with_id = int(has_id.sum())
        n_lines = int((scanned.flags & native.FLAG_EMPTY == 0).sum())
        if n_with_id < n_lines:
            return True, None  # unscannable / id-less line
        h = native.hash64_spans(
            chunk, ids_off, scanned.lens[:, native.F_EVENT_ID]
        )[has_id]
        if len(np.unique(h)) < n_with_id:
            return True, None  # intra-chunk duplicate
        total_ids += n_with_id
        hashes.append(h)
        if filters is None:
            continue
        merge.add(
            *native.load_ratings_jsonl(chunk, scanned=scanned, **filters)
        )
    if total_ids:
        all_hashes = np.concatenate(hashes)
        if len(np.unique(all_hashes)) < total_ids:
            return True, None  # cross-chunk duplicate (or hash collision)
    if filters is None:
        return False, None
    return False, merge.result()


class JSONLStorageClient:
    def __init__(self, config: dict | None = None):
        self.config = config or {}
        self.base_path = Path(
            self.config.get("path", "~/.pio_tpu/events")
        ).expanduser()
        self.base_path.mkdir(parents=True, exist_ok=True)
        self.lock = threading.RLock()
        # (mtime_ns, size) of logs last proven replay-clean (no delete
        # markers / duplicate ids): lets scan_ratings skip the uniqueness
        # pass — and, in degraded no-native mode, avoid re-compacting —
        # until the file changes
        self.clean_stat: dict[Path, tuple[int, int]] = {}
        # stricter cache for verbatim exports: proven clean AND free of
        # blank lines (clean_stat alone tolerates blanks)
        self.export_clean_stat: dict[Path, tuple[int, int]] = {}
        # per-file fsync group commit (see groupcommit.py): concurrent
        # ingest requests share fsyncs instead of paying one each. The
        # `sync` source property picks the durability mode: "always"
        # (default — ack after covering fsync) or "interval[:ms]" (ack
        # after flush, background fsync each interval — the reference's
        # HBase-WAL-hflush durability, lifting fsync-bound single-event
        # ingest)
        from predictionio_tpu_torch.data.storage.groupcommit import (
            CoalescerMap,
            parse_sync_mode,
        )

        self.sync_interval = parse_sync_mode(self.config.get("sync"))
        self.committers = CoalescerMap(self.sync_interval)
        # cached append-side file handles (data log opened "ab", lock
        # sidecar): reopening all three files per single-event insert
        # cost ~200us/event; entries revalidate by inode under the flock
        # (compact replaces the data file, remove unlinks the sidecar).
        # LRU-capped so a server hosting many apps/channels cannot crawl
        # toward the fd ulimit (eviction closes; revalidation reopens)
        self.append_fds: dict[str, object] = {}
        self.lock_fds: dict[str, object] = {}
        self.fd_cache_cap = int(self.config.get("fd_cache_cap", 128))

    def cache_fd(self, cache: dict, key: str, f) -> None:
        """Insert with LRU eviction (dicts iterate in insertion order;
        hits re-insert to refresh recency). Caller holds ``self.lock``."""
        cache.pop(key, None)
        cache[key] = f
        if len(cache) > self.fd_cache_cap:
            old_key = next(iter(cache))
            if old_key != key:
                old = cache.pop(old_key)
                try:
                    old.close()
                except OSError:  # pragma: no cover
                    pass

    def close(self) -> None:
        """Stop the interval syncer and drop cached handles (Storage.close)."""
        self.committers.stop()
        with self.lock:
            for cache in (self.append_fds, self.lock_fds):
                for f in cache.values():
                    try:
                        f.close()
                    except OSError:  # pragma: no cover
                        pass
                cache.clear()


class JSONLEvents(base.Events):
    def __init__(self, client: JSONLStorageClient):
        self._c = client

    def _file(self, app_id: int, channel_id: int | None) -> Path:
        name = f"events_{app_id}" + (
            f"_{channel_id}" if channel_id is not None else ""
        )
        return self._c.base_path / f"{name}.jsonl"

    @contextlib.contextmanager
    def _locked(self, app_id: int, channel_id: int | None):
        """Thread lock + cross-process flock on a sidecar ``.lock`` file.

        Two processes sharing one event dir (event server + trainer) must
        serialize append vs compact: a record appended mid-compact by
        another process would be dropped by the rewrite. The lock file is
        separate from the data file because ``compact`` atomically
        replaces the data file (a lock on the replaced inode would guard
        nothing).

        The sidecar handle is CACHED (open+flock+close per insert cost
        ~90us on the single-event hot path) and revalidated by inode
        after each acquisition: if another process ``remove``d the
        namespace (unlinking the sidecar), our lock is on a dead inode
        and a writer flocking the recreated file would run concurrently
        — detected by the stat mismatch, handle reopened, retried.
        """
        path = self._file(app_id, channel_id)
        with self._c.lock:
            if fcntl is None:
                yield path
                return
            lockpath = path.with_suffix(".jsonl.lock")
            key = str(lockpath)
            while True:
                lf = self._c.lock_fds.get(key)
                if lf is None:
                    lf = open(lockpath, "w")
                self._c.cache_fd(self._c.lock_fds, key, lf)
                fcntl.flock(lf, fcntl.LOCK_EX)
                try:
                    if os.stat(lockpath).st_ino == os.fstat(lf.fileno()).st_ino:
                        break
                except OSError:
                    pass
                fcntl.flock(lf, fcntl.LOCK_UN)
                lf.close()
                self._c.lock_fds.pop(key, None)
            try:
                yield path
            finally:
                try:
                    fcntl.flock(lf, fcntl.LOCK_UN)
                except (OSError, ValueError):
                    # evicted+closed by a nested _locked hitting the LRU
                    # cap: close already released the flock
                    pass

    def _append_fd(self, path: Path):
        """Cached ``"ab"`` handle for the data log, revalidated by inode
        (compact atomically replaces the file; a stale fd would append
        to the dead inode). Caller holds ``_locked``."""
        key = str(path)
        f = self._c.append_fds.get(key)
        if f is not None:
            try:
                if os.fstat(f.fileno()).st_ino == os.stat(key).st_ino:
                    self._c.cache_fd(self._c.append_fds, key, f)  # refresh
                    return f
            except (OSError, ValueError):
                pass
            self._c.append_fds.pop(key, None)
            try:
                f.close()
            except OSError:  # pragma: no cover
                pass
        # first open of this log in this process: recover from a torn
        # tail left by a crashed writer before any new bytes land
        truncate_torn_tail(path)
        f = open(path, "ab")
        self._c.cache_fd(self._c.append_fds, key, f)
        return f

    def _replay(self, app_id: int, channel_id: int | None) -> dict[str, Event]:
        """Fold the log: last record per event id wins."""
        table: dict[str, Event] = {}
        fold_jsonl_file(self._file(app_id, channel_id), table)
        return table

    def tail_files(
        self, app_id: int, channel_id: int | None = None
    ) -> list[Path]:
        """Log files a byte-offset tailer should follow, in replay order.
        One append-only log here; the file may not exist yet."""
        return [self._file(app_id, channel_id)]

    def change_token(
        self, app_id: int, channel_id: int | None = None
    ) -> object | None:
        """One stat: appends/compactions change (inode, mtime_ns, size),
        including writes by other processes sharing the directory."""
        try:
            st = self._file(app_id, channel_id).stat()
        except OSError:
            return ("absent",)
        return (st.st_ino, st.st_mtime_ns, st.st_size)

    def _append(self, app_id: int, channel_id: int | None, record: dict) -> None:
        self._append_group_committed(
            app_id, channel_id, (json.dumps(record) + "\n").encode()
        )

    def _append_group_committed(
        self, app_id: int, channel_id: int | None, blob: bytes
    ) -> None:
        """Append + flush under the lock, take a commit sequence, then
        wait for a covering fsync OUTSIDE the lock — so concurrent
        writers coalesce onto one fsync (ack still strictly after the
        bytes are durable). Safe across compact/remove: compact rewrites
        a fsync'ed replacement containing every locked-in append, and a
        removed file makes durability moot (see groupcommit.py)."""
        with self._locked(app_id, channel_id) as path:
            f = self._append_fd(path)
            # the buffer is empty here (every success path flushes), so
            # the on-disk size is the true pre-append length
            pre_size = os.fstat(f.fileno()).st_size
            try:
                faults.fault_point("storage.write")
                f.write(blob)
                f.flush()
            except Exception:
                # a failed write/flush can leave this blob (or a torn
                # prefix of it) buffered or partially on disk; a later
                # flush would resurrect an event the client saw FAIL,
                # and a torn tail line would corrupt replay. Evict the
                # handle, let close flush whatever it can, then roll the
                # log back to its pre-append length under the flock.
                self._c.append_fds.pop(str(path), None)
                try:
                    f.close()
                except (OSError, ValueError):
                    pass
                try:
                    with open(path, "ab") as g:
                        g.truncate(pre_size)
                except OSError:  # pragma: no cover - disk fully failed
                    logger.exception("could not roll back torn append")
                raise
            committer = self._c.committers.get(path)
            seq = committer.note_write()
        if self._c.sync_interval is None:
            committer.wait_durable(seq, path)
        # interval mode: the bytes are flushed to the page cache (they
        # survive a process crash — the reference's hflush durability);
        # the CoalescerMap's background thread fsyncs within one interval

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        with self._locked(app_id, channel_id) as path:
            path.touch()
        return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        with self._locked(app_id, channel_id) as path:
            existed = path.exists()
            path.unlink(missing_ok=True)
            columnar_cache.drop(path)
            f = self._c.append_fds.pop(str(path), None)
            if f is not None:
                f.close()
        # drop the lock sidecar too (after releasing the flock) so a
        # deleted app/channel leaves nothing behind. The cached-handle
        # eviction must run under the client lock: a concurrent _locked
        # in another thread may already hold this very handle, and
        # closing it out from under them would drop their flock
        # mid-append (later _locked calls detect the dead inode anyway)
        lockpath = self._file(app_id, channel_id).with_suffix(".jsonl.lock")
        with self._c.lock:
            lf = self._c.lock_fds.pop(str(lockpath), None)
            if lf is not None:
                lf.close()
            lockpath.unlink(missing_ok=True)
        return existed

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        event_id = event.event_id or uuid.uuid4().hex
        e = event.with_event_id(event_id)
        # for_api=False: keep creationTime and microsecond timestamps so
        # the replayed event is byte-identical to the inserted one
        self._append(app_id, channel_id, e.to_dict(for_api=False))
        return event_id

    def batch_insert(
        self, events, app_id: int, channel_id: int | None = None
    ) -> list[str]:
        """Bulk append: one lock acquisition, one write, one fsync for the
        whole batch — the import fast path (per-event fsync at 10^7-event
        scale would dominate the entire import)."""
        ids: list[str] = []
        lines: list[str] = []
        for event in events:
            event_id = event.event_id or uuid.uuid4().hex
            e = event.with_event_id(event_id)
            ids.append(event_id)
            lines.append(json.dumps(e.to_dict(for_api=False)))
        if not lines:
            return ids
        self._append_group_committed(
            app_id, channel_id, ("\n".join(lines) + "\n").encode()
        )
        return ids

    def commit_backlog(self) -> int:
        """Group-commit queue depth: appends flushed but not yet covered
        by an fsync (the event server's backpressure/stats probe)."""
        return self._c.committers.backlog()

    def sync_commits(self) -> None:
        """Force-fsync every open log now (drain-time flush)."""
        self._c.committers.sync_all()

    def append_jsonl(
        self, blob: bytes, app_id: int, channel_id: int | None = None
    ) -> None:
        """Append pre-rendered JSONL records in one locked write+fsync —
        the import splice-through fast path (cli/commands.import_events):
        the wire format IS the storage format, so validated lines skip the
        Event-object round trip entirely. Callers are responsible for
        per-line validity and eventId/creationTime presence."""
        if not blob:
            return
        if not blob.endswith(b"\n"):
            blob += b"\n"
        self._append_group_committed(app_id, channel_id, blob)

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None:
        with self._locked(app_id, channel_id):
            return self._replay(app_id, channel_id).get(event_id)

    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool:
        with self._locked(app_id, channel_id) as path:
            if event_id not in self._replay(app_id, channel_id):
                return False
            # append inline (not via _append): the flock is not reentrant
            # across two opens of the lock file in the same process
            with open(path, "a") as f:
                f.write(json.dumps({"$delete": event_id}) + "\n")
                f.flush()
                os.fsync(f.fileno())
            return True

    def _compact_locked(self, app_id: int, channel_id: int | None, path: Path) -> int:
        """Replay + rewrite + atomic replace. Caller holds ``_locked``."""
        table = self._replay(app_id, channel_id)
        tmp = path.with_suffix(".jsonl.tmp")
        with open(tmp, "w") as f:
            for e in table.values():
                f.write(json.dumps(e.to_dict(for_api=False)) + "\n")
            f.flush()
            # fsync BEFORE replace: previously-acked (durable) records
            # are being rewritten — replacing them with an unsynced file
            # would un-durable them for a crash window
            faults.fault_point("storage.fsync")
            os.fsync(f.fileno())
        faults.fault_point("storage.rename")
        tmp.replace(path)
        # the replaced log has a new (mtime_ns, size) so a cached
        # columnar block could never serve stale — dropping it just
        # reclaims the disk immediately
        columnar_cache.drop(path)
        return len(table)

    def compact(self, app_id: int, channel_id: int | None = None) -> int:
        """Rewrite the log to its live records; returns the live count.

        Holds the cross-process lock across replay+rewrite+replace so a
        concurrent writer in another process cannot append a record that
        the rewrite would drop.
        """
        with self._locked(app_id, channel_id) as path:
            return self._compact_locked(app_id, channel_id, path)

    def export_jsonl(self, app_id: int, channel_id: int | None, out) -> int:
        """Export splice-through: the storage format IS the wire format,
        so a replay-clean log streams to ``out`` verbatim (compacting
        first when it isn't) — no per-event Python objects, the inverse
        of ``append_jsonl``. Returns the record count."""
        def _stat(path: Path) -> tuple[int, int]:
            st = path.stat()
            return (st.st_mtime_ns, st.st_size)

        # snapshot under the lock; prove OUTSIDE it (the proof of an
        # immutable snapshot needs no lock, and a multi-GB chunked proof
        # under the client-wide lock would stall every ingest request —
        # the same pattern as scan_ratings' big path)
        with self._locked(app_id, channel_id) as path:
            buf = path.read_bytes() if path.exists() else b""
            if not buf:
                return 0
            snap_stat = _stat(path)
        if self._c.export_clean_stat.get(path) == snap_stat:
            needs_compact = False  # proven clean AND blank-free, unchanged
        else:
            if len(buf) > SCAN_CHUNK_BYTES:
                needs_compact, _ = prove_clean_chunked(buf)
            else:
                needs_compact, _ = prove_clean(buf)
            # the clean proof tolerates blank lines; a verbatim export
            # must not (they'd inflate the record count)
            if not needs_compact and _maybe_blank_lines(buf):
                needs_compact = True
        if needs_compact:
            with self._locked(app_id, channel_id) as path:
                if not path.exists():
                    # remove() interleaved while we proved outside the
                    # lock; compacting would resurrect an empty file for
                    # the deleted app
                    return 0
                self._compact_locked(app_id, channel_id, path)
                buf = path.read_bytes()
                if buf:
                    snap_stat = _stat(path)
        if buf:
            # compact output is clean and blank-free by construction
            self._c.export_clean_stat[path] = snap_stat
            self._c.clean_stat[path] = snap_stat
        out.write(buf)
        n_records = buf.count(b"\n")
        if buf and not buf.endswith(b"\n"):
            out.write(b"\n")
            n_records += 1
        return n_records

    def scan_ratings(
        self,
        app_id: int,
        channel_id: int | None = None,
        *,
        event_names=None,
        entity_type: str | None = None,
        target_entity_type: str | None = None,
        rating_key: str | None = "rating",
        default_ratings: dict[str, float] | None = None,
        override_ratings: dict[str, float] | None = None,
    ) -> base.RatingsBatch:
        """Columnar fast path: native byte scan of the raw log — no Python
        Event objects (the HBase-analog bulk training read; reference
        HBPEvents TableInputFormat scan, storage/hbase/.../HBPEvents.scala).

        Log semantics (last-write-wins per event id, ``$delete`` records)
        are restored by compacting first when the log isn't already
        append-only-unique; the common import->train flow appends unique
        inserts only, so the precondition is one cheap byte/span pass
        (reused for the ratings extraction — single scan when no
        compaction is needed).

        A columnar cache (see columnar_cache.py) sits in front of the
        whole path: a warm scan mmaps packed column blocks keyed by the
        log's (mtime_ns, size) and never reads the row log at all; a
        miss runs the row path below (the correctness oracle) and then
        publishes fresh blocks for the next scan.
        """
        from predictionio_tpu_torch import native

        # one lock acquisition across check + compact + re-read: releasing
        # between them would let a concurrent writer append a replacement
        # the re-read then double-counts
        def _stat(path: Path) -> tuple[int, int]:
            st = path.stat()
            return (st.st_mtime_ns, st.st_size)

        filters = dict(
            event_names=list(event_names) if event_names is not None else None,
            rating_key=rating_key,
            default_ratings=default_ratings,
            entity_type=entity_type,
            target_entity_type=target_entity_type,
            override_ratings=override_ratings,
        )
        use_cache = columnar_cache.enabled(self._c.config)
        if use_cache:
            # probe under the lock (stat + mmap are cheap); decode
            # outside it — the mapping snapshots the inode, so a
            # concurrent compact replacing the file can't corrupt us,
            # and its new stat just makes the next probe miss
            with self._locked(app_id, channel_id) as path:
                cb = None
                if path.exists():
                    st = _stat(path)
                    if st[1] > 0:
                        cb = columnar_cache.load(columnar_cache.cache_path(path))
                        if cb is not None and not cb.valid_for(st):
                            cb = None
            if cb is not None:
                try:
                    hit = cb.ratings(**filters)
                except Exception:  # corrupt payload bytes: fall back
                    logger.warning(
                        "columnar cache decode failed; using row scan",
                        exc_info=True,
                    )
                    hit = None
                if hit is not None:
                    users, items, rows, cols, vals = hit
                    return base.RatingsBatch(
                        entity_ids=users, target_ids=items,
                        rows=rows, cols=cols, vals=vals,
                    )
        served_stat = None
        with self._locked(app_id, channel_id) as path:
            buf = path.read_bytes() if path.exists() else b""
            snap_stat = _stat(path) if buf else None
            served_stat = snap_stat
            # multi-GB logs prove cleanliness and extract in line-aligned
            # chunks OUTSIDE the lock: whole-buffer span tables
            # (~176 B/line) would rival the 20M-event e2e's entire RSS
            # budget. The snapshot is immutable, so proof + extraction
            # of it are race-free; small logs keep the single-lock flow.
            scanned = None
            big = len(buf) > SCAN_CHUNK_BYTES
            if big:
                clean_cached = self._c.clean_stat.get(path) == snap_stat
            else:
                scanned = None
                if buf and self._c.clean_stat.get(path) == snap_stat:
                    needs_compact = False  # unchanged since proven clean
                else:
                    needs_compact, scanned = prove_clean(buf)
                if needs_compact:
                    # compact inline: the flock is not reentrant, so
                    # reuse the under-lock body, not compact()
                    self._compact_locked(app_id, channel_id, path)
                    buf = path.read_bytes()
                    scanned = None  # buf changed; rescan below
                if buf:
                    # post-compact (or just-proven-clean) logs stay
                    # clean until the file changes; record the stat so
                    # the next read skips the uniqueness pass
                    served_stat = _stat(path)
                    self._c.clean_stat[path] = served_stat
        if big:
            if clean_cached:
                res = native.load_ratings_jsonl_chunked(
                    buf, chunk_bytes=SCAN_CHUNK_BYTES, **filters
                )
            else:
                # ONE fused pass: per-chunk clean check + extraction on
                # the same span scans (the whole-buffer path's
                # single-scan property)
                dirty, res = _chunked_clean_extract(
                    buf, filters, SCAN_CHUNK_BYTES
                )
                if dirty:
                    with self._locked(app_id, channel_id) as path:
                        self._compact_locked(app_id, channel_id, path)
                        buf = path.read_bytes()
                        if buf:
                            served_stat = _stat(path)
                            self._c.clean_stat[path] = served_stat
                    # compact output is unique by construction
                    res = native.load_ratings_jsonl_chunked(
                        buf, chunk_bytes=SCAN_CHUNK_BYTES, **filters
                    )
                else:
                    self._c.clean_stat[path] = snap_stat
            users, items, rows, cols, vals = res
        else:
            users, items, rows, cols, vals = native.load_ratings_jsonl(
                buf, scanned=scanned, **filters
            )
        if use_cache and buf and served_stat is not None:
            # publish column blocks for the bytes just served, keyed by
            # the stat captured under the same lock as those bytes — a
            # concurrent append after release changes the stat, so the
            # pairing can never serve stale. Best-effort: a failed build
            # only costs the next scan its shortcut.
            try:
                blocks = columnar_cache.build_blocks(
                    buf, rating_key,
                    scanned=None if big else scanned,
                    chunk_bytes=SCAN_CHUNK_BYTES,
                )
                if blocks is not None:
                    columnar_cache.store(
                        columnar_cache.cache_path(path), served_stat, blocks
                    )
            except Exception:  # pragma: no cover - cache is optional
                logger.warning("columnar cache build failed", exc_info=True)
        return base.RatingsBatch(
            entity_ids=users, target_ids=items, rows=rows, cols=cols, vals=vals
        )

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type=...,
        target_entity_id=...,
        limit: int | None = None,
        reversed_order: bool = False,
    ) -> list[Event]:
        with self._locked(app_id, channel_id):
            events = list(self._replay(app_id, channel_id).values())
        return query_events(
            events,
            start_time,
            until_time,
            entity_type,
            entity_id,
            event_names,
            target_entity_type,
            target_entity_id,
            limit,
            reversed_order,
        )
