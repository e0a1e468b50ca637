"""Epoch-fenced query-result cache: preserialized response bytes, LRU.

The serving read path pays gather -> score -> top-k -> JSON encode on
every request even when the model has not changed since the identical
query last ran. This cache stores the FINISHED response bytes keyed by
``(engine_variant, canonical_query_bytes, epoch)`` so a hit skips the
device dispatch, the serving join, and the encode entirely — the
cached-scoring-tier-in-front-of-the-model pattern of Google's ads
serving stack (PAPERS.md), with the invalidation problem solved exactly
rather than by TTL: the engine server bumps one epoch counter on EVERY
model swap (``/reload`` and speed-layer ``apply_patch`` alike), so a
cached entry is valid iff its epoch equals the served epoch. Stale
epochs become unreachable the instant the counter moves; ``sweep()``
reclaims their bytes.

Concurrency: the key space is split over N shards, each an OrderedDict
under its own lock, so concurrent handler threads rarely contend — the
hit path is one dict lookup + move_to_end under a shard lock. Capacity
is BYTES, not entries (responses vary from ~100 B to tens of KB);
eviction is per-shard LRU. Hit/miss/eviction counters are per-shard and
summed on read, keeping the hot path free of any global atomic.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict

__all__ = ["QueryCache", "canonical_query_bytes"]

# fixed per-entry bookkeeping estimate (key tuple, OrderedDict node,
# bytes object headers) added to the payload size when charging a shard
_ENTRY_OVERHEAD = 128


def canonical_query_bytes(body: dict) -> bytes:
    """Canonical bytes of a query body: key order and whitespace cannot
    fork cache entries for the same logical query. Raises TypeError for
    non-JSON-serializable bodies (the caller treats that as uncacheable).
    """
    return json.dumps(
        body, sort_keys=True, separators=(",", ":"), ensure_ascii=False
    ).encode("utf-8")


class _Shard:
    __slots__ = ("lock", "entries", "bytes", "hits", "misses", "evictions")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.entries: OrderedDict[tuple, bytes] = OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0


class QueryCache:
    """Sharded-lock, byte-capped LRU of preserialized response bytes."""

    def __init__(self, capacity_bytes: int, shards: int = 8):
        if capacity_bytes <= 0:
            raise ValueError("capacity_bytes must be positive")
        self.capacity_bytes = int(capacity_bytes)
        self._shards = [_Shard() for _ in range(max(1, int(shards)))]
        self._per_shard = max(
            _ENTRY_OVERHEAD + 1, self.capacity_bytes // len(self._shards)
        )

    def _shard(self, key: tuple) -> _Shard:
        return self._shards[hash(key) % len(self._shards)]

    def get(self, key: tuple) -> bytes | None:
        """Cached response bytes for the key, or None (LRU-touching)."""
        s = self._shard(key)
        with s.lock:
            payload = s.entries.get(key)
            if payload is None:
                s.misses += 1
                return None
            s.entries.move_to_end(key)
            s.hits += 1
            return payload

    def put(self, key: tuple, payload: bytes) -> None:
        """Insert (or refresh) an entry, evicting LRU past the shard's
        byte budget. Payloads too large for one shard are not cached."""
        size = len(payload) + len(key[1]) + _ENTRY_OVERHEAD
        s = self._shard(key)
        if size > self._per_shard:
            return
        with s.lock:
            old = s.entries.pop(key, None)
            if old is not None:
                s.bytes -= len(old) + len(key[1]) + _ENTRY_OVERHEAD
            s.entries[key] = payload
            s.bytes += size
            while s.bytes > self._per_shard and s.entries:
                k, v = s.entries.popitem(last=False)
                s.bytes -= len(v) + len(k[1]) + _ENTRY_OVERHEAD
                s.evictions += 1

    def sweep(self, current_epoch: int, variant: str | None = None) -> int:
        """Drop every entry whose epoch != ``current_epoch``.

        Correctness never needs this — a bumped epoch makes old entries
        unreachable by key — but the bytes they hold would otherwise only
        leave via LRU pressure. Called on every model swap (reload or
        fold-in patch). Returns how many entries were dropped.

        With ``variant`` set, only that tenant's partition is swept —
        a multi-tenant server reloading tenant A must leave tenant B's
        cached results (under B's own epoch) untouched."""
        dropped = 0
        for s in self._shards:
            with s.lock:
                stale = [
                    k for k in s.entries
                    if k[2] != current_epoch
                    and (variant is None or k[0] == variant)
                ]
                for k in stale:
                    v = s.entries.pop(k)
                    s.bytes -= len(v) + len(k[1]) + _ENTRY_OVERHEAD
                dropped += len(stale)
        return dropped

    def clear(self) -> None:
        for s in self._shards:
            with s.lock:
                s.entries.clear()
                s.bytes = 0

    def gauges(self) -> dict:
        """Aggregated operator gauges (engine server /stats.json)."""
        hits = misses = evictions = entries = nbytes = 0
        for s in self._shards:
            with s.lock:
                hits += s.hits
                misses += s.misses
                evictions += s.evictions
                entries += len(s.entries)
                nbytes += s.bytes
        lookups = hits + misses
        return {
            "cache_hits": hits,
            "cache_misses": misses,
            "cache_hit_rate": round(hits / lookups, 4) if lookups else 0.0,
            "cache_entries": entries,
            "cache_bytes": nbytes,
            "cache_capacity_bytes": self.capacity_bytes,
            "cache_evictions": evictions,
        }
