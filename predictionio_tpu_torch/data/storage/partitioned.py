"""Hash-partitioned, segment-rotated event backend — the scalable event store.

Port of ``predictionio_tpu/data/storage/partitioned.py``, copied whole
with its imports rewritten: the files it writes are byte for byte
the JAX package's, so either package reads what the other wrote.

The reference's big-data event path is HBase: one table per (app, channel),
row key = MD5(entityType+entityId) hash prefix + eventTime + uuid-low so
writes spread across regions, point gets address one region directly, and
scans prune by key/time range (reference
storage/hbase/src/main/scala/org/apache/predictionio/data/storage/hbase/HBEventsUtil.scala:54-133,
HBLEvents.scala:37, HBPEvents.scala:31-88). This backend keeps those scale
properties on a filesystem (local disk or a mounted DFS) with no region
servers:

- **Hash-spread writes.** Each (app, channel) namespace is split into P
  independent partition logs. Generated event ids embed their partition
  (``<pp>-<uuid>`` with pp = FNV-1a("entityType:entityId") % P), so an
  entity's generated events co-locate (the HBase row-prefix rule) and every
  point op addresses exactly one partition; ingest across entities fans out
  over P uncontended locks. Explicit foreign ids route by FNV-1a of the id
  itself (``native.route_id_bytes``; the hash is recorded in ``_meta.json``
  and verified on open), so a replacement always lands in the same
  partition as the original.
- **Segment rotation + time-pruned scans.** Each partition is an append-only
  ``active.jsonl`` sealed into an immutable ``seg_NNNNNN.jsonl`` at a size
  threshold. Sealing records the segment's [min, max] event-time (native
  span scan, no Python parse) in a sidecar, so time-windowed ``find``s skip
  disjoint segments wholesale — the analog of HBase's eventTime range scan.
- **Supersede-aware pruning.** Skipping a segment is only sound if nothing
  in it replaces or deletes a record in an earlier segment. Explicit-id
  inserts and deletes log their ids to a per-partition ``supersede.log``;
  sealing folds that list into the segment sidecar, and a pruned segment
  still *applies* its supersede set during replay (pops without parsing).
  Bulk ``append_jsonl`` into a non-empty partition cannot know what it
  replaces, so the segment it seals into is marked opaque = never pruned;
  ``compact`` rewrites partitions into exact, fully-prunable segments.
- **Parallel bulk reads.** ``find`` replays partitions on a thread pool;
  ``scan_ratings`` concatenates the partition logs and runs the native
  columnar codec once — the TableInputFormat-split analog feeding arrays,
  not per-record Python objects.

The partition count is fixed at namespace creation (persisted in
``_meta.json``; the stored value wins over config thereafter) because id
routing must stay stable for the life of the data.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor
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
from predictionio_tpu_torch.data.storage import base, columnar_cache
from predictionio_tpu_torch.data.storage.jsonl import (
    SCAN_CHUNK_BYTES,
    _chunked_clean_extract,
    fold_jsonl_file,
    has_delete_markers,
    prove_clean,
    prove_clean_chunked,
    truncate_torn_tail,
)
from predictionio_tpu_torch.data.storage.memory import query_events

_SEG_RE = re.compile(r"^seg_(\d{6})\.jsonl$")
MAX_PARTITIONS = 256  # two hex digits embed the partition in the event id


def _mkdir_racing(d: Path) -> None:
    """mkdir -p that tolerates a concurrent remove(): pathlib's exist_ok
    check itself races (os.mkdir raises FileExistsError, then is_dir()
    sees the dir already deleted again); retry until one state sticks."""
    for _ in range(20):
        try:
            d.mkdir(parents=True, exist_ok=True)
            return
        except (FileExistsError, FileNotFoundError):
            continue
    raise RuntimeError(  # pragma: no cover - pathological remove() storm
        f"could not create {d}: concurrent removals kept deleting it"
    )


class PartitionedStorageClient:
    def __init__(self, config: dict | None = None):
        self.config = dict(config or {})
        self.base_path = Path(
            self.config.get("path", "~/.pio_tpu/events_partitioned")
        ).expanduser()
        self.base_path.mkdir(parents=True, exist_ok=True)
        self.partitions = int(self.config.get("partitions", 8))
        if not 1 <= self.partitions <= MAX_PARTITIONS:
            raise ValueError(
                f"partitions must be in [1, {MAX_PARTITIONS}], "
                f"got {self.partitions}"
            )
        self.segment_bytes = int(
            self.config.get("segment_bytes", 64 * 1024 * 1024)
        )
        self.lock = threading.RLock()
        # per-partition-dir thread locks (cross-process safety comes from
        # the flock; a global lock here would serialize the parallel scans)
        self.path_locks: dict[str, threading.RLock] = {}
        # per-active-log fsync group commit (see groupcommit.py); the
        # `sync` source property selects always-fsync acks (default) or
        # interval mode (flush-acked, background fsync — the reference's
        # HBase-WAL-hflush durability)
        from predictionio_tpu_torch.data.storage.groupcommit import (
            CoalescerMap,
            parse_sync_mode,
        )

        self.sync_interval = parse_sync_mode(self.config.get("sync"))
        self.committers = CoalescerMap(self.sync_interval)
        # namespace dir -> (partition count, meta-file (inode, mtime_ns))
        # — the count is immutable for one life of the namespace; the
        # identity pair detects a remove()+recreate by another process
        self.ns_partitions: dict[str, tuple[int, tuple[int, int]]] = {}
        # namespace dir -> tuple of (path, mtime_ns, size) last proven
        # replay-clean (unique ids, no delete markers): lets scan_ratings
        # skip the uniqueness pass until any file changes
        self.clean_stat: dict[Path, tuple] = {}
        # active logs already checked for a torn tail this process life —
        # crash recovery runs once per log, before its first append
        self.torn_checked: set[str] = set()

    def close(self) -> None:
        """Stop the interval syncer thread (Storage.close)."""
        self.committers.stop()


class PartitionedEvents(base.Events):
    """Events DAO over hash-partitioned segment logs (capability subset:
    events only — like hbase in the reference, SURVEY §2.3)."""

    def __init__(self, client: PartitionedStorageClient):
        self._c = client

    # -- layout ------------------------------------------------------------

    def _ns_dir(self, app_id: int, channel_id: int | None) -> Path:
        name = f"events_{app_id}" + (
            f"_{channel_id}" if channel_id is not None else ""
        )
        return self._c.base_path / name

    ROUTING_HASH = "fnv1a32"  # must match native.route_id_bytes

    def _publish_meta(self, ns: Path, n: int) -> tuple[int, tuple[int, int]]:
        """Atomically create ``_meta.json`` with count ``n`` unless one
        already exists; returns (winning count, meta-file identity). The
        identity pair (inode, mtime_ns) is fstat'ed from the same open
        fd the count is read from, so it describes exactly the file that
        produced the count — a caller caching (count, identity) can't
        pair a stale count with a newer file. The routing hash is
        recorded alongside the partition count and verified on read —
        opening a store routed by a different hash must fail loudly, not
        silently misroute point ops (export + re-import migrates)."""
        meta = ns / "_meta.json"
        for _ in range(20):
            if not meta.exists():
                _mkdir_racing(ns)
                # per-process-unique temp name: a shared name would let
                # two first-initializers publish each other's
                # half-written file
                tmp = ns / f"_meta.json.tmp.{os.getpid()}.{uuid.uuid4().hex}"
                try:
                    tmp.write_text(
                        json.dumps(
                            {"partitions": n, "hash": self.ROUTING_HASH}
                        )
                    )
                    # atomic create-if-absent: a concurrent process may
                    # have written meta between the check and now —
                    # theirs wins
                    os.link(tmp, meta)
                except FileExistsError:
                    pass
                except FileNotFoundError:
                    # a concurrent remove() rmtree'd the dir (and our
                    # tmp with it) mid-publish; recreate and retry
                    continue
                finally:
                    tmp.unlink(missing_ok=True)
            try:
                with open(meta, "rb") as f:
                    st = os.fstat(f.fileno())
                    side = json.loads(f.read())
                ident = (st.st_ino, st.st_mtime_ns)
                break
            except FileNotFoundError:
                # a concurrent remove() deleted the namespace between
                # publish and read; republish for its new life
                continue
        else:  # pragma: no cover - pathological remove() storm
            raise RuntimeError(
                f"could not publish _meta.json for {ns.name}: "
                "concurrent removals kept deleting it"
            )
        stored_hash = side.get("hash", "<none>")
        if stored_hash != self.ROUTING_HASH:
            raise RuntimeError(
                f"event namespace {ns.name} was created with routing hash "
                f"{stored_hash!r}; this build routes with "
                f"{self.ROUTING_HASH!r} — export from a matching build and "
                "re-import to migrate"
            )
        return int(side["partitions"]), ident

    def _n_partitions(self, ns: Path) -> int:
        """Partition count for a namespace: the persisted value wins.

        Cached per client keyed by the meta file's identity (inode +
        mtime), so the hot write/read paths cost one stat and no client
        lock — and a cross-process remove()+recreate with a DIFFERENT
        count is detected (new meta file = new inode) instead of routing
        by the stale cached count."""
        meta = ns / "_meta.json"
        cached = self._c.ns_partitions.get(str(ns))
        if cached is not None:
            n, ident = cached
            try:
                st = meta.stat()
            except OSError:
                # namespace removed: the cached count must not let writes
                # recreate data dirs without a meta file (the slow path
                # re-publishes meta first, so first-writer-wins holds for
                # the new life)
                st = None
            if st is not None and (st.st_ino, st.st_mtime_ns) == ident:
                return n
            with self._c.lock:
                self._c.ns_partitions.pop(str(ns), None)
        with self._c.lock:
            n, ident = self._publish_meta(ns, self._c.partitions)
            self._c.ns_partitions[str(ns)] = (n, ident)
            return n

    def _ensure_meta_locked(self, ns: Path, n: int) -> None:
        """Write-site guard, called under the partition lock: a remove()
        that raced in between routing and locking left no ``_meta.json``
        — republish it with the count THIS write routed by, so the
        namespace's new life keeps a meta consistent with its first
        record. If another writer republished a different count first,
        our routing is stale: refuse rather than misroute."""
        won, _ = self._publish_meta(ns, n)
        if won != n:
            with self._c.lock:
                self._c.ns_partitions.pop(str(ns), None)
            raise RuntimeError(
                f"event namespace {ns.name} was recreated with "
                f"{won} partitions while a write routed by {n} was in "
                "flight; retry the write"
            )

    def _pdir(self, ns: Path, pp: int) -> Path:
        d = ns / f"p{pp:02x}"
        _mkdir_racing(d)
        return d

    def _tlock(self, pdir: Path) -> threading.RLock:
        with self._c.lock:
            return self._c.path_locks.setdefault(
                str(pdir), threading.RLock()
            )

    @contextlib.contextmanager
    def _locked(self, pdir: Path):
        """Per-partition thread lock + cross-process flock on the
        partition's sidecar lock file (append vs seal vs compact must
        serialize; the lock file is separate from the data because
        seal/compact replace inodes). Per-partition, not client-global, so
        scans of different partitions proceed in parallel."""
        with self._tlock(pdir):
            if fcntl is None:  # pragma: no cover - non-POSIX
                yield
                return
            lock_path = pdir / ".lock"
            for _ in range(100):
                # a remove() may have rmtree'd the dir between our _pdir
                # mkdir and this open (we were blocked on the thread lock
                # it held, or a cross-process remover's); recreate and
                # retry — the namespace's new life starts with whoever
                # acquires the lock next
                try:
                    lf = open(lock_path, "w")
                except FileNotFoundError:
                    _mkdir_racing(pdir)
                    continue
                fcntl.flock(lf, fcntl.LOCK_EX)
                # a cross-process remove() can unlink the lock file while
                # we block in flock: our lock is then on a dead inode and
                # a later writer flocking the RECREATED file would run
                # concurrently with us — verify the path still names our
                # inode before trusting the lock
                try:
                    st_path = os.stat(lock_path)
                except FileNotFoundError:
                    st_path = None
                st_fd = os.fstat(lf.fileno())
                if st_path is None or (
                    (st_path.st_dev, st_path.st_ino)
                    != (st_fd.st_dev, st_fd.st_ino)
                ):
                    fcntl.flock(lf, fcntl.LOCK_UN)
                    lf.close()
                    continue
                try:
                    yield
                    return
                finally:
                    fcntl.flock(lf, fcntl.LOCK_UN)
                    lf.close()
            raise RuntimeError(  # pragma: no cover - remove() storm
                f"could not acquire partition lock {lock_path}: "
                "concurrent removals kept deleting it"
            )

    @contextlib.contextmanager
    def _locked_all(self, ns: Path, n: int):
        """All partition locks, acquired in ascending order (deadlock-free
        against any other ordered acquirer) — the cross-partition snapshot
        for bulk reads."""
        with contextlib.ExitStack() as stack:
            for pp in range(n):
                stack.enter_context(self._locked(self._pdir(ns, pp)))
            yield

    @staticmethod
    def _segments(pdir: Path) -> list[Path]:
        return sorted(
            (p for p in pdir.iterdir() if _SEG_RE.match(p.name)),
            key=lambda p: p.name,
        )

    # -- routing -----------------------------------------------------------

    @staticmethod
    def _hash_pp(key: str, n: int) -> int:
        from predictionio_tpu_torch import native

        return native.fnv1a32(key.encode("utf-8")) % n

    @staticmethod
    def _route(event_id: str, n: int) -> int:
        """Partition of an event id — deterministic from the id alone, so
        gets, deletes, and replacements always address the same log.
        The rule (embedded ``<pp>-`` prefix else FNV-1a 32) is shared
        with the native bulk router (``native.route_id_bytes``)."""
        from predictionio_tpu_torch import native

        return native.route_id_bytes(event_id.encode("utf-8"), n)

    # -- sealing -----------------------------------------------------------

    def _read_supersedes(self, pdir: Path) -> list[str]:
        """Pending supersede ids for the active segment: ("X <id>" explicit
        insert | "D <id>" delete) per line."""
        log = pdir / "supersede.log"
        if not log.exists():
            return []
        ids: list[str] = []
        for line in log.read_text().splitlines():
            if line:
                ids.append(line.partition(" ")[2])
        return ids

    def _seal_locked(self, pdir: Path) -> None:
        """Rotate active into an immutable segment + sidecar. Caller holds
        the partition lock."""
        from predictionio_tpu_torch import native

        active = pdir / "active.jsonl"
        buf = active.read_bytes() if active.exists() else b""
        if not buf:
            return
        logged = self._read_supersedes(pdir)
        opaque = (pdir / "active.opaque").exists()
        scanned = native.scan_events(buf)
        nonempty = (scanned.flags & native.FLAG_EMPTY) == 0
        has_deletes = has_delete_markers(buf)
        # Validate logged supersede entries against the segment's actual
        # content: writes log the id BEFORE appending the record, so a
        # crash between the two leaves an orphan entry; folding it into
        # the sidecar unvalidated would pop a LIVE older version whenever
        # this segment is pruned. An entry counts only if its record (or
        # its delete marker) really is in the segment. The validation scan
        # runs only when there is something to validate — the bulk-ingest
        # path (no explicit ids, no deletes) skips it entirely.
        delete_idx: list[int] = []
        supersedes: list[str] = []
        if logged or has_deletes:
            delete_ids: set[str] = set()
            present: set[str] = set()
            lines = buf.split(b"\n")
            for i in range(len(scanned.flags)):
                if not nonempty[i]:
                    continue
                line = lines[i]
                eid = None
                if not line.startswith(b'{"$delete"'):
                    eid = scanned.field_str(i, native.F_EVENT_ID)
                if eid is None:
                    # one json.loads serves both probes: delete-marker
                    # detection (incl. markers the byte-prefix check
                    # missed, e.g. re-serialized with spaces) and the
                    # eventId of a line the span scanner couldn't decode
                    try:
                        rec = json.loads(line)
                    except ValueError:  # pragma: no cover - corrupt line
                        continue
                    if "$delete" in rec:
                        delete_ids.add(rec["$delete"])
                        delete_idx.append(i)
                        continue
                    eid = rec.get("eventId")
                if eid is not None:
                    present.add(eid)
            supersedes = sorted(
                {s for s in logged if s in present or s in delete_ids}
                | delete_ids
            )
        min_ts = max_ts = None
        if not opaque:
            times = native.parse_times(
                scanned.buf,
                scanned.offs[:, native.F_EVENT_TIME],
                scanned.lens[:, native.F_EVENT_TIME],
            )
            valid = nonempty & ~np.isnan(times)
            # lines without a parseable eventTime are either delete
            # markers (accounted: their ids are in the sidecar supersede
            # set, which a pruned segment still applies) or foreign
            # records we can't bound — any unaccounted one makes the
            # segment unprunable
            n_nan = int(nonempty.sum()) - int(valid.sum())
            if valid.any() and n_nan <= len(delete_idx):
                min_ts = float(times[valid].min())
                max_ts = float(times[valid].max())
            else:
                opaque = True
        segs = self._segments(pdir)
        n = (int(_SEG_RE.match(segs[-1].name).group(1)) + 1) if segs else 1
        seg = pdir / f"seg_{n:06d}.jsonl"
        side = {
            "min_ts": min_ts,
            "max_ts": max_ts,
            "supersedes": supersedes,
            "opaque": opaque,
        }
        # make the sealed bytes durable BEFORE the rename: group-committed
        # appends may still be awaiting their fsync, and once renamed
        # their coalescer would fsync a different (fresh) active file
        with open(active, "rb") as f:
            faults.fault_point("storage.fsync")
            os.fsync(f.fileno())
        faults.fault_point("storage.rename")
        active.rename(seg)
        # the rename preserves the file's bytes, size, and mtime, so a
        # columnar cache built for the active log stays valid — carry it
        # to the segment's name instead of rebuilding on the next scan
        columnar_cache.move(active, seg)
        self._c.committers.get(active).mark_all_durable()
        # atomic: a torn sidecar would otherwise poison every windowed
        # find of this partition (replay parses it)
        self._write_atomic(
            pdir / f"seg_{n:06d}.meta.json", json.dumps(side).encode()
        )
        (pdir / "supersede.log").unlink(missing_ok=True)
        (pdir / "active.opaque").unlink(missing_ok=True)

    def _maybe_seal_locked(self, pdir: Path) -> None:
        active = pdir / "active.jsonl"
        if active.exists() and active.stat().st_size >= self._c.segment_bytes:
            self._seal_locked(pdir)

    # -- replay ------------------------------------------------------------

    @staticmethod
    def _fold_file(path: Path, table: dict[str, Event]) -> None:
        fold_jsonl_file(path, table)

    def _replay_partition(
        self, pdir: Path, window: tuple[float | None, float | None] | None
    ) -> dict[str, Event]:
        """Fold one partition's logs, pruning sealed segments disjoint from
        ``window`` (epoch-seconds [start, until)); a pruned segment still
        applies its supersede set so replacements/deletes that were sealed
        past the window can't resurrect stale versions."""
        table: dict[str, Event] = {}
        for seg in self._segments(pdir):
            pruned = False
            if window is not None:
                side_path = pdir / (seg.stem + ".meta.json")
                side = None
                if side_path.exists():
                    try:
                        side = json.loads(side_path.read_text())
                    except ValueError:
                        # torn sidecar (pre-atomic-write data, or a torn
                        # filesystem): degrade to folding the segment —
                        # correct, just unpruned
                        side = None
                if side is not None:
                    if (
                        not side.get("opaque")
                        and side.get("min_ts") is not None
                        and side.get("max_ts") is not None
                    ):
                        qs, qu = window
                        disjoint = (
                            qu is not None and side["min_ts"] >= qu
                        ) or (qs is not None and side["max_ts"] < qs)
                        if disjoint:
                            for sid in side.get("supersedes", ()):
                                table.pop(sid, None)
                            pruned = True
            if not pruned:
                self._fold_file(seg, table)
        self._fold_file(pdir / "active.jsonl", table)
        return table

    # -- DAO contract ------------------------------------------------------

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        ns = self._ns_dir(app_id, channel_id)
        n = self._n_partitions(ns)
        for pp in range(n):
            self._pdir(ns, pp)
        return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        ns = self._ns_dir(app_id, channel_id)
        # resolve the partition count READ-ONLY, without holding the
        # client lock across the partition-lock acquisition below: every
        # other path orders partition-lock -> client-lock (_tlock between
        # partitions in _locked_all, the clean_stat update in
        # scan_ratings), so a remover holding the client lock while
        # acquiring partition locks would invert the order and deadlock
        # against a concurrent scan. And a remover must never go through
        # _n_partitions/_publish_meta — that would RECREATE the meta a
        # concurrent remover just deleted, making both return True and
        # leaving a phantom namespace behind.
        try:
            n = int(json.loads((ns / "_meta.json").read_text())["partitions"])
        except (OSError, ValueError, KeyError, TypeError):
            return False  # no (readable) meta: nothing to remove
        # hold every partition lock so an in-flight writer can't recreate
        # files mid-rmtree; a writer arriving AFTER the remove recreates
        # the namespace by design (insert auto-creates, republishing
        # _meta.json first). _locked_all itself recreates the partition
        # dirs, so "did it exist" is answered by the meta file, not the
        # directory — which also serializes concurrent removers: the
        # second one finds the meta gone and returns False.
        with self._locked_all(ns, n):
            had_meta = (ns / "_meta.json").exists()
            # writers mkdir their partition dir BEFORE blocking on its
            # lock (_pdir then _locked), so a racing insert can recreate
            # an (empty — the locks keep data out) dir mid-rmtree; retry
            # until the walk completes
            for _ in range(20):
                try:
                    shutil.rmtree(ns)
                    break
                except FileNotFoundError:
                    break
                except OSError:
                    continue
            else:
                shutil.rmtree(ns, ignore_errors=True)
            with self._c.lock:
                self._c.clean_stat.pop(ns, None)
                self._c.ns_partitions.pop(str(ns), None)
        return had_meta

    def _recover_torn_locked(self, pdir: Path) -> None:
        """Once per process per active log (caller holds the partition
        lock): drop a torn tail left by a crashed writer before the
        first new append lands after it."""
        key = str(pdir / "active.jsonl")
        if key not in self._c.torn_checked:
            self._c.torn_checked.add(key)
            truncate_torn_tail(Path(key))

    def _append_locked(self, pdir: Path, blob: bytes) -> None:
        self._recover_torn_locked(pdir)
        with open(pdir / "active.jsonl", "ab") as f:
            faults.fault_point("storage.write")
            f.write(blob)
            f.flush()
            faults.fault_point("storage.fsync")
            os.fsync(f.fileno())

    def _log_supersede_locked(
        self, pdir: Path, tag: str, eids: Sequence[str]
    ) -> None:
        """One write+fsync for the whole entry batch."""
        with open(pdir / "supersede.log", "a") as f:
            f.write("".join(f"{tag} {eid}\n" for eid in eids))
            f.flush()
            # fsync BEFORE the data append's fsync: if the record survives
            # a crash its supersede entry must too, or a later sealed
            # segment would be marked prunable without it and windowed
            # reads could resurrect the stale older version (the inverse
            # crash — entry without record — is validated away at seal)
            os.fsync(f.fileno())

    def insert(
        self, event: Event, app_id: int, channel_id: int | None = None
    ) -> str:
        ns = self._ns_dir(app_id, channel_id)
        n = self._n_partitions(ns)
        explicit = bool(event.event_id)
        if explicit:
            event_id = event.event_id
            pp = self._route(event_id, n)
        else:
            pp = self._hash_pp(f"{event.entity_type}:{event.entity_id}", n)
            event_id = f"{pp:02x}-{uuid.uuid4().hex}"
        e = event.with_event_id(event_id)
        pdir = self._pdir(ns, pp)
        line = (json.dumps(e.to_dict(for_api=False)) + "\n").encode()
        if explicit:
            # strict path: the supersede entry must be durable BEFORE the
            # record (ordering across two files — a coalesced fsync of
            # the data log could otherwise land first)
            with self._locked(pdir):
                self._ensure_meta_locked(ns, n)
                self._log_supersede_locked(pdir, "X", [event_id])
                self._append_locked(pdir, line)
                self._maybe_seal_locked(pdir)
            return event_id
        # generated-id hot path (the event server's single-event ingest):
        # append+flush under the lock, fsync via group commit outside it
        with self._locked(pdir):
            self._ensure_meta_locked(ns, n)
            committer, seq, active = self._append_group_committed_locked(
                pdir, line
            )
            self._maybe_seal_locked(pdir)
        if self._c.sync_interval is None:
            committer.wait_durable(seq, active)
        # interval mode: flushed to the page cache; the background
        # syncer makes it disk-durable within one interval
        return event_id

    def _append_group_committed_locked(
        self, pdir: Path, blob: bytes
    ) -> tuple:
        """Append + flush to the partition's active log under the (held)
        partition lock and take a commit sequence; returns (committer,
        seq, path) for the caller to ``wait_durable`` OUTSIDE the lock.
        The flush-before-note_write ordering and the outside-the-lock
        wait are the group-commit protocol's invariants (groupcommit.py);
        every group-committed append must go through here."""
        self._recover_torn_locked(pdir)
        active = pdir / "active.jsonl"
        with open(active, "ab") as f:
            faults.fault_point("storage.write")
            f.write(blob)
            f.flush()
        committer = self._c.committers.get(active)
        return committer, committer.note_write(), active

    def batch_insert(
        self, events, app_id: int, channel_id: int | None = None
    ) -> list[str]:
        """Bulk append: one lock acquisition + write + fsync per touched
        partition (the ingest fast path; per-event fsync would dominate)."""
        ns = self._ns_dir(app_id, channel_id)
        n = self._n_partitions(ns)
        ids: list[str] = []
        per_part: dict[int, list[bytes]] = {}
        per_part_x: dict[int, list[str]] = {}
        for event in events:
            explicit = bool(event.event_id)
            if explicit:
                event_id = event.event_id
                pp = self._route(event_id, n)
                per_part_x.setdefault(pp, []).append(event_id)
            else:
                pp = self._hash_pp(
                    f"{event.entity_type}:{event.entity_id}", n
                )
                event_id = f"{pp:02x}-{uuid.uuid4().hex}"
            ids.append(event_id)
            per_part.setdefault(pp, []).append(
                (json.dumps(
                    event.with_event_id(event_id).to_dict(for_api=False)
                ) + "\n").encode()
            )
        waits = []
        for pp, lines in per_part.items():
            pdir = self._pdir(ns, pp)
            xids = per_part_x.get(pp)
            if xids:
                # explicit ids: strict ordered fsyncs (see insert)
                with self._locked(pdir):
                    self._ensure_meta_locked(ns, n)
                    self._log_supersede_locked(pdir, "X", xids)
                    self._append_locked(pdir, b"".join(lines))
                    self._maybe_seal_locked(pdir)
                continue
            with self._locked(pdir):
                self._ensure_meta_locked(ns, n)
                waits.append(
                    self._append_group_committed_locked(pdir, b"".join(lines))
                )
                self._maybe_seal_locked(pdir)
        if self._c.sync_interval is None:
            for committer, seq, active in waits:
                committer.wait_durable(seq, active)
        return ids

    def commit_backlog(self) -> int:
        """Group-commit queue depth across partitions: appends flushed
        but not yet covered by an fsync (backpressure/stats probe)."""
        return self._c.committers.backlog()

    def append_jsonl(
        self, blob: bytes, app_id: int, channel_id: int | None = None
    ) -> None:
        """Import splice fast path: route pre-rendered JSONL lines to their
        partitions with one native span scan (no per-record Python objects)
        and one locked write+fsync per partition. Lines must each carry an
        eventId (cli import validates). A partition that already holds data
        gets its in-flight segment marked opaque — the import may replace
        ids we can't enumerate cheaply, so that segment is never pruned
        (``compact`` restores exact prunable segments)."""
        from predictionio_tpu_torch import native

        if not blob:
            return
        if not blob.endswith(b"\n"):
            blob += b"\n"
        ns = self._ns_dir(app_id, channel_id)
        n = self._n_partitions(ns)
        scanned = native.scan_events(blob)
        # line byte spans, vectorized (ends at each newline)
        ends = (
            np.flatnonzero(np.frombuffer(blob, np.uint8) == ord("\n")) + 1
        )
        starts = np.empty_like(ends)
        starts[0] = 0
        starts[1:] = ends[:-1]
        # one native pass routes every id span; fallback-flagged lines
        # (escaped ids, odd syntax) MUST take the json path — their raw
        # span bytes differ from the decoded id, so routing by the span
        # would diverge from get()/delete()'s routing of the decoded id
        routes = native.route_ids(
            blob,
            scanned.offs[:, native.F_EVENT_ID],
            scanned.lens[:, native.F_EVENT_ID],
            n,
        )
        routes[(scanned.flags & native.FLAG_FALLBACK) != 0] = -1
        empty = (scanned.flags & native.FLAG_EMPTY) != 0
        per_part: dict[int, list[bytes]] = {}
        for i in np.flatnonzero((routes < 0) & ~empty):
            rec = json.loads(blob[starts[i]:ends[i]])
            eid = rec.get("eventId")
            if eid is None:
                raise ValueError(
                    "append_jsonl line missing eventId "
                    "(required for partition routing)"
                )
            routes[i] = self._route(eid, n)
        # group line indexes by partition with one stable sort (O(n log n);
        # a flatnonzero per partition would rescan routes up to 256 times)
        order = np.argsort(routes, kind="stable")
        sorted_routes = routes[order]
        uniq, first = np.unique(sorted_routes, return_index=True)
        bounds = np.append(first, len(order))
        for k, pp in enumerate(uniq):
            if pp < 0:
                continue  # empty lines
            idx = order[bounds[k]:bounds[k + 1]]
            per_part[int(pp)] = [
                blob[starts[i]:ends[i]] for i in idx
            ]
        def write_part(pp: int, lines: list[bytes]) -> None:
            pdir = self._pdir(ns, pp)
            with self._locked(pdir):
                self._ensure_meta_locked(ns, n)
                active = pdir / "active.jsonl"
                nonempty = (
                    active.exists() and active.stat().st_size > 0
                ) or bool(self._segments(pdir))
                if nonempty:
                    (pdir / "active.opaque").touch()
                self._append_locked(pdir, b"".join(lines))
                self._maybe_seal_locked(pdir)

        if len(per_part) > 1:
            # fan the per-partition appends out on threads: each append
            # fsyncs its own active log, and P serial fsyncs (not the
            # byte writes) dominate bulk-import wall clock. Partition
            # locks keep each append's durability semantics identical
            # to the sequential loop; list() re-raises worker errors.
            with ThreadPoolExecutor(
                max_workers=min(len(per_part), os.cpu_count() or 4)
            ) as pool:
                list(
                    pool.map(lambda kv: write_part(*kv), per_part.items())
                )
        else:
            for pp, lines in per_part.items():
                write_part(pp, lines)

    def tail_files(
        self, app_id: int, channel_id: int | None = None
    ) -> list[Path]:
        """Log files a byte-offset tailer should follow: per partition the
        sealed segments (immutable once named ``seg_*``) then the active
        log. A seal moves bytes from active to a new segment path — the
        tailer sees the active file shrink (lineage break, re-read) and
        the new segment appear; its watermark dedupe skips the re-read of
        already-delivered records."""
        ns = self._ns_dir(app_id, channel_id)
        if not (ns / "_meta.json").exists():
            return []
        n = self._n_partitions(ns)
        out: list[Path] = []
        for pp in range(n):
            pdir = ns / f"p{pp:02x}"
            if not pdir.is_dir():
                continue
            out.extend(self._segments(pdir))
            out.append(pdir / "active.jsonl")
        return out

    def change_token(
        self, app_id: int, channel_id: int | None = None
    ) -> object | None:
        """Two stats per partition, no directory listings: the active
        log's (mtime_ns, size) sees appends, the partition dir's mtime
        sees seals/compactions/imports (they create or rename files)."""
        ns = self._ns_dir(app_id, channel_id)
        try:
            n = int(json.loads((ns / "_meta.json").read_text())["partitions"])
        except (OSError, ValueError, KeyError, TypeError):
            return ("absent",)
        toks: list = []
        for pp in range(n):
            pdir = ns / f"p{pp:02x}"
            try:
                st_d = pdir.stat()
                toks.append(st_d.st_mtime_ns)
            except OSError:
                toks.append(None)
                continue
            try:
                st_a = (pdir / "active.jsonl").stat()
                toks.append((st_a.st_mtime_ns, st_a.st_size))
            except OSError:
                toks.append(None)
        return tuple(toks)

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None:
        ns = self._ns_dir(app_id, channel_id)
        if not ns.exists():
            return None
        pdir = self._pdir(ns, self._route(event_id, self._n_partitions(ns)))
        with self._locked(pdir):
            return self._replay_partition(pdir, None).get(event_id)

    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool:
        ns = self._ns_dir(app_id, channel_id)
        if not ns.exists():
            return False
        n = self._n_partitions(ns)
        pdir = self._pdir(ns, self._route(event_id, n))
        with self._locked(pdir):
            if event_id not in self._replay_partition(pdir, None):
                return False
            self._ensure_meta_locked(ns, n)
            self._log_supersede_locked(pdir, "D", [event_id])
            self._append_locked(
                pdir, (json.dumps({"$delete": event_id}) + "\n").encode()
            )
        return True

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
        ns = self._ns_dir(app_id, channel_id)
        if not ns.exists():
            return []
        n = self._n_partitions(ns)
        window = None
        if start_time is not None or until_time is not None:
            window = (
                start_time.timestamp() if start_time is not None else None,
                until_time.timestamp() if until_time is not None else None,
            )

        def scan(pp: int) -> dict[str, Event]:
            pdir = self._pdir(ns, pp)
            with self._locked(pdir):
                return self._replay_partition(pdir, window)

        events: list[Event] = []
        if n == 1:
            events = list(scan(0).values())
        else:
            with ThreadPoolExecutor(
                max_workers=min(n, os.cpu_count() or 4)
            ) as pool:
                for table in pool.map(scan, range(n)):
                    events.extend(table.values())
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

    @staticmethod
    def _write_atomic(path: Path, blob: bytes) -> None:
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        tmp.replace(path)

    def _compact_partition_locked(self, pdir: Path) -> int:
        """Rewrite one partition to its live records in exact, bounded,
        supersede-free segments; returns the live count. Caller holds the
        partition lock.

        Crash-safe in two phases. Phase 1 publishes the COMPLETE live set
        (plus tombstones for ids whose final state is deleted, since the
        old segments still exist) into ``active.jsonl`` via tmp+rename —
        from that commit point, replay over [old segments + new active]
        is correct under any crash, because active folds last. Phase 2
        removes the old segments and re-establishes bounded sealed
        segments, each published via its own tmp+rename (a torn write
        never enters replay), truncating active only after every segment
        is durable; in every intermediate state replay sees either the
        full copy in active, or segments plus a redundant identical copy
        (which the next scan's uniqueness check compacts away)."""
        table: dict[str, Event] = {}
        deleted: set[str] = set()
        segs = self._segments(pdir)
        for seg in segs:
            fold_jsonl_file(seg, table, deleted)
        active = pdir / "active.jsonl"
        fold_jsonl_file(active, table, deleted)
        if not table and not deleted and not segs:
            return 0  # untouched partition: nothing to rewrite

        lines: dict[str, bytes] = {}
        times: dict[str, float] = {}
        for eid, e in table.items():
            lines[eid] = (json.dumps(e.to_dict(for_api=False)) + "\n").encode()
            times[eid] = e.event_time.timestamp()

        # phase 1 — commit point
        full = b"".join(
            (json.dumps({"$delete": eid}) + "\n").encode()
            for eid in sorted(deleted)
        ) + b"".join(lines.values())
        self._write_atomic(active, full)

        for seg in self._segments(pdir):
            (pdir / (seg.stem + ".meta.json")).unlink(missing_ok=True)
            columnar_cache.drop(seg)
            seg.unlink()
        (pdir / "supersede.log").unlink(missing_ok=True)
        (pdir / "active.opaque").unlink(missing_ok=True)

        # phase 2 — re-segment; full chunks become sealed segments, the
        # tail stays in active
        seg_n = 0
        chunk: list[str] = []
        size = 0

        def seal_chunk() -> None:
            nonlocal seg_n, chunk, size
            seg_n += 1
            seg = pdir / f"seg_{seg_n:06d}.jsonl"
            self._write_atomic(seg, b"".join(lines[eid] for eid in chunk))
            ts = [times[eid] for eid in chunk]
            self._write_atomic(
                pdir / f"seg_{seg_n:06d}.meta.json",
                json.dumps({
                    "min_ts": min(ts),
                    "max_ts": max(ts),
                    "supersedes": [],
                    "opaque": False,
                }).encode(),
            )
            chunk, size = [], 0

        for eid, line in lines.items():
            chunk.append(eid)
            size += len(line)
            if size >= self._c.segment_bytes:
                seal_chunk()
        self._write_atomic(
            active, b"".join(lines[eid] for eid in chunk)
        )
        # the rewritten active's columnar blocks (if any) describe the
        # pre-compaction bytes; the fresh (mtime_ns, size) could never
        # serve them stale, so dropping just reclaims the disk now
        columnar_cache.drop(active)
        # every live record is now in a fsync'ed file (segments + active
        # via _write_atomic): release any group-commit waiters
        self._c.committers.get(active).mark_all_durable()
        return len(table)

    def compact(self, app_id: int, channel_id: int | None = None) -> int:
        """Rewrite every partition to its live records; returns the live
        count."""
        ns = self._ns_dir(app_id, channel_id)
        if not ns.exists():
            return 0
        n = self._n_partitions(ns)
        total = 0
        for pp in range(n):
            pdir = self._pdir(ns, pp)
            with self._locked(pdir):
                total += self._compact_partition_locked(pdir)
        with self._c.lock:
            self._c.clean_stat.pop(ns, None)
        return total

    def export_jsonl(self, app_id: int, channel_id: int | None, out) -> int:
        """Export splice-through (see jsonl.export_jsonl): each partition
        streams its segments+active verbatim once proven replay-clean
        (compacted otherwise). Partition order is the export order —
        arbitrary, like the reference's RDD part files.

        Proven and streamed ONE PARTITION AT A TIME: each partition's
        lock is held only for its own read/prove/compact, and its buffer
        is written to ``out`` before the next partition is touched — so
        a multi-GB namespace stalls concurrent ingest on at most one
        partition at a time and peak RSS is one partition, not the
        store (the per-partition proofs are each sound on their own:
        ids route to exactly one partition, so replay-cleanliness is a
        per-partition property). Returns the record count."""
        ns = self._ns_dir(app_id, channel_id)
        if not ns.exists():
            return 0
        n = self._n_partitions(ns)
        total = 0
        for pp in range(n):
            buf = self._proven_clean_partition(ns, pp)
            if buf:
                out.write(buf)
                total += buf.count(b"\n")
        return total

    def _proven_clean_partition(self, ns: Path, pp: int) -> bytes:
        """One partition's buffer proven replay-clean and blank-line
        free (compacted under that partition's lock when the proof
        fails or is unavailable). Unlike ``_proven_clean_buffers_locked``
        this takes only the single partition lock and leaves the
        namespace-level clean_stat cache alone (the next scan_ratings
        re-proves from its own snapshot)."""
        from predictionio_tpu_torch import native
        from predictionio_tpu_torch.data.storage.jsonl import _maybe_blank_lines

        pdir = self._pdir(ns, pp)
        with self._locked(pdir):
            buf, _ = self._read_partition_locked(pdir)
            if not buf:
                return b""
            needs, _scan = (
                prove_clean(buf)
                if native.native_available()
                else (True, None)  # unprovable: compact
            )
            if not needs:
                needs = _maybe_blank_lines(buf)
            if needs:
                self._compact_partition_locked(pdir)
                buf, _ = self._read_partition_locked(pdir)
        return buf

    @staticmethod
    def _read_partition_locked(pdir: Path) -> tuple[bytes, list]:
        """Concatenated newline-normalized segment+active bytes plus the
        per-file pieces ``(path, mtime_ns, size, start, end)`` — stat for
        clean_stat / columnar-cache keys, [start, end) the file's span in
        the returned buffer; caller holds the partition lock. The
        replay-order invariant (segments sorted, active last) lives
        ONLY here — scan_ratings and export both read through it."""
        parts: list[bytes] = []
        stats: list = []
        pos = 0
        files = list(PartitionedEvents._segments(pdir))
        active = pdir / "active.jsonl"
        if active.exists():
            files.append(active)
        for path in files:
            b = path.read_bytes()
            if b and not b.endswith(b"\n"):
                b += b"\n"
            st = path.stat()
            stats.append(
                (str(path), st.st_mtime_ns, st.st_size, pos, pos + len(b))
            )
            pos += len(b)
            parts.append(b)
        return b"".join(parts), stats

    def _proven_clean_buffers_locked(
        self, ns: Path, n: int, forbid_blank_lines: bool = False
    ) -> tuple[list[bytes], list]:
        """Per-partition buffers proven replay-clean (dirty partitions
        compacted first), with the proof recorded in the clean_stat
        cache. Caller holds EVERY partition lock (_locked_all) for the
        whole prove -> compact -> re-read sequence: a writer cannot slip
        a duplicate id or delete marker between the compaction and the
        snapshot the cache trusts — which also makes trusting the
        post-compact state sound in degraded no-native mode, where
        uniqueness is unprovable but compaction just restored it by
        construction.

        ``forbid_blank_lines``: additionally compact partitions whose
        buffers may contain empty/whitespace lines (the clean proof
        tolerates them; a verbatim export must not, or its record count
        and output would include non-records). Returns (pbufs, scans,
        pieces) where scans[pp] is a reusable span scan or None and
        pieces[pp] lists the partition's per-file
        ``(path, mtime_ns, size, start, end)`` spans — the keys the
        columnar cache is addressed by."""
        from predictionio_tpu_torch import native
        from predictionio_tpu_torch.data.storage.jsonl import _maybe_blank_lines

        def read_all() -> tuple[list[bytes], list[list], tuple]:
            pbufs: list[bytes] = []
            pieces: list[list] = []
            stats: list = []
            for pp in range(n):
                buf, st = self._read_partition_locked(self._pdir(ns, pp))
                pbufs.append(buf)
                pieces.append(st)
                stats.extend(st)
            return pbufs, pieces, tuple(stats)

        pbufs, pieces, stat_key = read_all()
        scans: list = [None] * n
        if not any(pbufs):
            return pbufs, scans, pieces
        dirty_blanks = forbid_blank_lines and any(
            _maybe_blank_lines(b) for b in pbufs if b
        )
        if self._c.clean_stat.get(ns) != stat_key or dirty_blanks:
            compacted = False
            for pp in range(n):
                if not pbufs[pp]:
                    continue
                if not native.native_available():
                    needs, scans[pp] = True, None  # unprovable: compact
                elif len(pbufs[pp]) > SCAN_CHUNK_BYTES:
                    # big partitions prove in O(chunk) memory; the span
                    # scan is not retained (scan_ratings re-extracts
                    # through the chunked path)
                    needs, scans[pp] = prove_clean_chunked(pbufs[pp])
                else:
                    needs, scans[pp] = prove_clean(pbufs[pp])
                if forbid_blank_lines and not needs:
                    needs = _maybe_blank_lines(pbufs[pp])
                if needs:
                    self._compact_partition_locked(self._pdir(ns, pp))
                    compacted = True
            if compacted:
                pbufs, pieces, stat_key = read_all()
                scans = [None] * n
        with self._c.lock:
            self._c.clean_stat[ns] = stat_key
        return pbufs, scans, pieces

    # -- columnar bulk read ------------------------------------------------

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
        """Columnar fast path: scan every partition's log IN PARALLEL
        with the native codec (the ctypes call releases the GIL, so
        partitions parse on real threads — the TableInputFormat-split
        analog), then merge the per-partition dense id spaces.

        Soundness: each partition is proven replay-clean (unique ids, no
        delete markers; dirty partitions are compacted first, under every
        partition lock so no writer can race the proof), and ids route
        deterministically to exactly one partition — enforced at the
        write sites via the ``_meta.json`` guard — so the per-partition
        record sets are disjoint and the merge is a plain
        concatenation-with-remap, no cross-partition last-write-wins
        needed."""
        from predictionio_tpu_torch import native

        ns = self._ns_dir(app_id, channel_id)
        if not ns.exists():
            return base.RatingsBatch.empty()
        n = self._n_partitions(ns)

        use_cache = columnar_cache.enabled(self._c.config)
        with self._locked_all(ns, n):
            pbufs, scans, pieces = self._proven_clean_buffers_locked(ns, n)
        if not any(pbufs):
            return base.RatingsBatch.empty()
        # buffers are immutable snapshots: parse outside the locks
        live = [pp for pp in range(n) if pbufs[pp]]

        filters = dict(
            event_names=(
                list(event_names) if event_names is not None else None
            ),
            rating_key=rating_key,
            default_ratings=default_ratings,
            entity_type=entity_type,
            target_entity_type=target_entity_type,
            override_ratings=override_ratings,
        )

        def load_one(pp: int, n_threads: int = 0):
            buf = pbufs[pp]
            try:
                if use_cache:
                    return load_one_cached(pp, buf, n_threads)
                if scans[pp] is None and len(buf) > SCAN_CHUNK_BYTES:
                    # big partition: extract through line-aligned chunks
                    # so the span arrays are O(chunk), not O(partition)
                    # — with all partitions parsing in PARALLEL,
                    # whole-buffer spans multiplied to ~9 GB at the 20M
                    # north-star scale (measured round 5)
                    dirty, result = _chunked_clean_extract(buf, filters)
                    if not dirty:
                        return result
                    # freshly-compacted data flagged dirty can only be
                    # a hash collision: fall through to the exact path
                return native.load_ratings_jsonl(
                    buf, scanned=scans[pp], n_threads=n_threads, **filters
                )
            finally:
                # the snapshot is parsed; release it before the other
                # partitions finish (bounds peak RSS to live buffers)
                pbufs[pp] = None

        def load_one_cached(pp: int, buf: bytes, n_threads: int):
            """Per-FILE columnar cache: segments are immutable, so a
            sealed segment's blocks survive appends to active and only a
            compaction (which rewrites the files) invalidates them. The
            partition was just proven replay-clean as a whole, so each
            file's records are a plain unique set and merging the
            per-file results in replay order (segments sorted, active
            last) reproduces the whole-buffer scan's first-appearance
            dense id order exactly."""
            merge_p = native.DenseMerge()
            for (fpath, mtime_ns, size, s, e) in pieces[pp]:
                if s == e:
                    continue
                piece_stat = (mtime_ns, size)
                cpath = columnar_cache.cache_path(Path(fpath))
                res = None
                cb = columnar_cache.load(cpath)
                if cb is not None and cb.valid_for(piece_stat):
                    try:
                        res = cb.ratings(**filters)
                    except Exception:  # corrupt payload: row scan below
                        res = None
                if res is None:
                    piece = buf[s:e]
                    if len(piece) > SCAN_CHUNK_BYTES:
                        res = native.load_ratings_jsonl_chunked(
                            piece, chunk_bytes=SCAN_CHUNK_BYTES,
                            n_threads=n_threads, **filters
                        )
                    else:
                        res = native.load_ratings_jsonl(
                            piece, n_threads=n_threads, **filters
                        )
                    try:
                        blocks = columnar_cache.build_blocks(
                            piece, rating_key, chunk_bytes=SCAN_CHUNK_BYTES
                        )
                        if blocks is not None:
                            columnar_cache.store(cpath, piece_stat, blocks)
                    except Exception:  # pragma: no cover - cache optional
                        pass
                merge_p.add(*res)
            return merge_p.result()

        if len(live) == 1:
            results = [load_one(live[0])]
        else:
            # one native-scanner thread per pooled worker: the scanner is
            # itself multithreaded for big buffers, and cores x 8 threads
            # would thrash the parallelism this pool provides (passed as
            # an explicit argument — mutating the process environment from
            # here would race getenv in concurrent native scans, which is
            # undefined behavior in glibc)
            with ThreadPoolExecutor(
                max_workers=min(len(live), os.cpu_count() or 4)
            ) as pool:
                results = list(
                    pool.map(lambda pp: load_one(pp, n_threads=1), live)
                )

        merge = native.DenseMerge()
        for result in results:
            merge.add(*result)
        users, items, rows, cols, vals = merge.result()
        return base.RatingsBatch(
            entity_ids=users,
            target_ids=items,
            rows=rows,
            cols=cols,
            vals=vals,
        )

