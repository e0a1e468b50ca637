"""Unified observability layer: metrics + request tracing.

Dependency-free instruments shared by every framework process
(data/.../api/Stats.scala in the reference only ever grew minute
buckets; this is the layer a production scoring tier actually needs —
per-stage latency histograms and queue-wait accounting, the
prerequisite arxiv 2501.10546 names for running at qps, and the
tracing-timeline argument of the TensorFlow system paper 1605.08695):

- :mod:`predictionio_tpu_torch.obs.metrics` — a process-global registry of
  counters, gauges, and log-bucketed latency histograms, rendered as
  Prometheus text format (``GET /metrics`` on every server) and merged
  as a compact ``obs`` block into the existing ``/stats.json`` payloads.
- :mod:`predictionio_tpu_torch.obs.trace` — per-request spans: each HTTP
  request gets a trace id (honoring ``X-PIO-Trace``), stage boundaries
  record spans, and a fixed-size ring retains the N slowest recent
  traces (``GET /traces.json``; waterfall table on the dashboard).
- :mod:`predictionio_tpu_torch.obs.device` — the device side of the story:
  the CUDA kernel builds made at first use, per-device memory gauges
  from the CUDA caching allocator, host<->device transfer byte
  accounting, and on-demand ``torch.profiler`` capture
  (``POST /profile``).
- :mod:`predictionio_tpu_torch.obs.progress` — live training progress via an
  atomic file written at checkpoint segment boundaries, read by
  ``pio status`` and the dashboard while a run is underway.
- :mod:`predictionio_tpu_torch.obs.slo` — declarative objectives over the
  metrics registry, judged with multi-window burn-rate alerting
  (``GET /slo.json``, ``pio_slo_*`` gauges, per-server default sets).
- :mod:`predictionio_tpu_torch.obs.freshness` — end-to-end ingest-to-servable
  latency, observed at the epoch-fenced patch/reload commit
  (``pio_serving_freshness_seconds``; ``freshness`` block on
  ``/stats.json``).
- :mod:`predictionio_tpu_torch.obs.history` — bounded ring-buffer time series
  over the metrics registry (counters as per-step deltas, gauges and
  histogram quantiles as samples), sampled on the SLO ticker's cadence
  (``GET /history.json``; dashboard sparklines; ``pio top``).
- :mod:`predictionio_tpu_torch.obs.incident` — the flight recorder: atomic
  incident bundles under ``$PIO_RUN_DIR/incidents/`` on SLO violation,
  unhandled exception, or ``POST /incident`` (``pio incidents``).

Instrumentation is ALWAYS-ON and cheap (<2% serving qps, gated by the
bench ``obs`` section); ``PIO_OBS=0`` turns every instrument into a
no-op for A/B measurement.

``device`` and ``progress`` are intentionally NOT imported here:
``obs.device`` must stay importable-but-inert in processes that never
touched CUDA,
and eagerly importing it from every ``obs`` user would register its
instruments even where they can never fire. Import them explicitly.
"""

from predictionio_tpu_torch.obs import metrics, trace  # noqa: F401
from predictionio_tpu_torch.obs import freshness, history, incident, slo  # noqa: F401

__all__ = [
    "metrics",
    "trace",
    "slo",
    "freshness",
    "history",
    "incident",
    "device",
    "progress",
]
