"""Event-server ingestion statistics.

Parity with the reference Stats/StatsActor
(data/.../api/Stats.scala:43-82, api/StatsActor.scala:36): per-minute
buckets counting (appId, event name, entityType, status) served at
``/stats.json`` when stats are enabled.

Unlike the reference (which grew its minute map forever), the live
window is BOUNDED: only the newest ``retention_minutes`` buckets are
kept and anything older is folded into a cumulative per-key total on
the way out, so a long-running event server holds ~24 h of minute
resolution at a fixed memory ceiling while ``get()`` still reports
exact all-time counts.

Port of ``predictionio_tpu/server/stats.py``.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from dataclasses import dataclass

# 24 h of minute buckets — the window an operator actually inspects;
# everything older collapses to one cumulative dict
DEFAULT_RETENTION_MINUTES = 1440


@dataclass(frozen=True)
class _Key:
    app_id: int
    status: int
    event: str
    entity_type: str


class Stats:
    def __init__(self, retention_minutes: int = DEFAULT_RETENTION_MINUTES) -> None:
        self.retention_minutes = int(retention_minutes)
        self._lock = threading.Lock()
        # minute bucket -> key -> count (live window)
        self._buckets: dict[int, dict[_Key, int]] = defaultdict(
            lambda: defaultdict(int)
        )
        # counts folded out of expired buckets; totals stay exact
        self._cumulative: dict[_Key, int] = defaultdict(int)
        # per-app accepted-write sequence + last ingest wall time: the
        # authoritative upstream numbers a realtime tailer's
        # events_behind / seconds_behind gauges compare against
        self._seq: dict[int, int] = defaultdict(int)
        self._last_ingest: dict[int, float] = {}
        self.start_time = time.time()

    def update(self, app_id: int, status: int, event: str, entity_type: str) -> None:
        now = time.time()
        minute = int(now // 60)
        with self._lock:
            self._buckets[minute][_Key(app_id, status, event, entity_type)] += 1
            if status == 201:  # accepted write
                self._seq[app_id] += 1
                self._last_ingest[app_id] = now
            self._fold_expired_locked(minute)

    def _fold_expired_locked(self, current_minute: int) -> None:
        """Fold buckets older than the retention window into the
        cumulative totals. Amortized O(1): traffic creates at most one
        new bucket per minute, so at most one usually expires per call —
        the loop only runs long after an idle gap, and then once."""
        horizon = current_minute - self.retention_minutes
        while self._buckets:
            oldest = min(self._buckets)
            if oldest > horizon:
                break
            for key, count in self._buckets.pop(oldest).items():
                self._cumulative[key] += count

    def bucket_count(self) -> int:
        with self._lock:
            return len(self._buckets)

    def history_series(self) -> dict:
        """The live minute buckets in the :mod:`obs.history` read shape:
        ``{series_key: {"kind": "delta", "points": [[t_ms, count], ...]}}``.
        Each point is one minute's accepted/rejected count per (app,
        status) — the event server registers this as a history provider,
        so ``/history.json`` (and the dashboard sparklines, ``pio top``)
        show ingest alongside the sampled process metrics. A point's
        timestamp is the minute's END (the bucket is complete then),
        matching the delta convention of sampled counters."""
        per_series: dict[str, list] = defaultdict(list)
        with self._lock:
            for minute in sorted(self._buckets):
                agg: dict[tuple[int, int], int] = defaultdict(int)
                for key, count in self._buckets[minute].items():
                    agg[(key.app_id, key.status)] += count
                for (app_id, status), count in sorted(agg.items()):
                    series = (
                        f'pio_stats_events{{app="{app_id}",status="{status}"}}'
                    )
                    per_series[series].append([(minute + 1) * 60_000, count])
        return {
            k: {"kind": "delta", "points": pts} for k, pts in per_series.items()
        }

    def get(self, app_id: int) -> dict:
        """Aggregate counts for one app: cumulative folded totals plus
        every live bucket (the reference reports previous-minute and
        cumulative views; cumulative is what its tests assert on)."""
        with self._lock:
            agg: dict[tuple, int] = defaultdict(int)
            for key, count in self._cumulative.items():
                if key.app_id == app_id:
                    agg[(key.status, key.event, key.entity_type)] += count
            for bucket in self._buckets.values():
                for key, count in bucket.items():
                    if key.app_id == app_id:
                        agg[(key.status, key.event, key.entity_type)] += count
            seq = self._seq.get(app_id, 0)
            last_ingest = self._last_ingest.get(app_id)
        return {
            "startTime": self.start_time,
            "statusCount": _group(agg, 0),
            "eventCount": _group(agg, 1),
            "entityTypeCount": _group(agg, 2),
            "lastEventSeq": seq,
            "lastIngestTime": last_ingest,
        }


def _group(agg: dict[tuple, int], ix: int) -> dict:
    out: dict = defaultdict(int)
    for key, count in agg.items():
        out[str(key[ix])] += count
    return dict(out)
