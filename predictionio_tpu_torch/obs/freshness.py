"""End-to-end freshness lineage: how long does an ingested event take
to influence a served answer?

Every path that makes new data servable calls :func:`observe_commit` at
the moment the swap actually COMMITS — the speed layer right after an
epoch-fenced ``apply_patch`` returns True, the engine server at the end
of a ``_load``/reload swap. Each event's ingest timestamp
(``Event.creation_time``, stamped by the event server / importer) is
measured against commit time, so the histogram records true
ingest-to-servable latency, not poll-loop latency: an event that waits
three fold-in intervals behind a breaker shows three intervals of
staleness.

Exports:

- ``pio_serving_freshness_seconds`` — histogram, one observation per
  event per commit; the ``serving.freshness`` SLO and the
  ``production_stack`` bench gate read this.
- ``pio_serving_last_commit_age_seconds`` — scrape-time gauge, age of
  the newest commit (any kind); goes flat-lining upward when fold-in
  stalls.
- :func:`block` — the ``freshness`` block on the engine server's
  ``/stats.json``.

Dependency-free and torch-free like the rest of ``obs/``.
"""

from __future__ import annotations

import threading
import time

from predictionio_tpu_torch.obs import metrics as _metrics

__all__ = ["HISTOGRAM", "observe_commit", "block", "reset"]

# seconds-scale buckets (1 ms .. ~4.7 h): freshness budgets live in the
# tens-of-seconds-to-minutes range, and a reload's batch-layer sample is
# train-duration-sized — the default sub-second latency buckets would
# clip everything past 10.5 s into one overflow cell
_BOUNDS = tuple(0.001 * 2**k for k in range(25))

HISTOGRAM = _metrics.histogram(
    "pio_serving_freshness_seconds",
    "Ingest-to-servable latency, observed per event at the fenced "
    "patch/reload commit",
    bounds=_BOUNDS,
)

_lock = threading.Lock()
_last_commit: dict | None = None


def _last_commit_age() -> float:
    with _lock:
        if _last_commit is None:
            return 0.0
        return max(0.0, time.time() - _last_commit["t"])


_metrics.gauge(
    "pio_serving_last_commit_age_seconds",
    "Seconds since new data last became servable (patch or reload)",
).set_function(_last_commit_age)


def observe_commit(
    event_times: list[float],
    kind: str,
    epoch: int | None = None,
    foldin_epoch: int | None = None,
    now: float | None = None,
) -> int:
    """Record that the events ingested at ``event_times`` (epoch
    seconds) became servable at ``now``. ``kind`` is ``"patch"`` (speed
    layer) or ``"reload"`` (full model swap). Returns the number of
    samples observed. No-op while obs is disabled."""
    global _last_commit
    if not _metrics.enabled():
        return 0
    now = time.time() if now is None else now
    observed = 0
    newest: float | None = None
    for t in event_times:
        try:
            lag = now - float(t)
        except (TypeError, ValueError):
            continue
        HISTOGRAM.observe(max(0.0, lag))
        observed += 1
        if newest is None or t > newest:
            newest = t
    if observed or kind == "reload":
        with _lock:
            _last_commit = {
                "t": now,
                "kind": kind,
                "events": observed,
                "epoch": epoch,
                "foldin_epoch": foldin_epoch,
                "newest_event_lag_s": (
                    round(max(0.0, now - newest), 6)
                    if newest is not None
                    else None
                ),
            }
    return observed


def block() -> dict:
    """The ``freshness`` block for ``/stats.json``."""
    if not _metrics.enabled():
        return {"enabled": False}
    summary = HISTOGRAM.summary()
    with _lock:
        last = dict(_last_commit) if _last_commit else None
    out = {
        "enabled": True,
        "ingest_to_servable_s": summary,
        "last_commit_age_s": round(_last_commit_age(), 3),
    }
    if last:
        last["age_s"] = round(max(0.0, time.time() - last.pop("t")), 3)
        out["last_commit"] = last
    return out


def reset() -> None:
    """Test hook: forget the last commit (the histogram lives in the
    metrics registry and is cleared with it)."""
    global _last_commit
    with _lock:
        _last_commit = None
