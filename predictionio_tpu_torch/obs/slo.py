"""SLO engine: declarative objectives judged over sliding windows with
multi-window burn-rate alerting.

PRs 7/9 built the raw signals (counters, histograms, gauges); nothing
*judged* them. This module closes the loop: an :class:`Slo` binds a
signal to an objective ("99% of queries under 250 ms", "99.9% of
requests non-5xx", "`seconds_behind` under 60 s", "this counter stays
zero") and a :class:`SloRegistry` evaluates every registered objective
on a tick, reducing each to the same primitive — a cumulative
(good, total) series sampled over time. State is decided the SRE way,
with TWO window lengths against the error budget:

- **burn rate** = (bad/total over a window) / (1 - objective): 1.0
  means the error budget is being consumed exactly at the sustainable
  rate; 14.4 means a 30-day budget gone in 2 days.
- **violated** — burn over threshold in BOTH the fast (default 5 m) and
  slow (default 1 h) windows: the condition is real and still
  happening. This is the page/alert condition; each transition into it
  lands in the alert ring.
- **burning** — budget consumed faster than sustainable (burn > 1 in
  either window) or a fast-window spike that the slow window has not
  confirmed; watch it, don't page.
- **ok** — everything else.

Evaluation is tick-based (default every 5 s, `PIO_SLO_INTERVAL_S`), NOT
per-request: the serving hot path is untouched, so the existing <2% obs
overhead gate covers the SLO engine by construction. ``PIO_OBS=0`` (or
``obs.metrics.set_enabled(False)``) makes the engine inert along with
the rest of obs. Everything is dependency-free and importable before
torch, like the rest of ``obs/``.

Windows and budgets read their defaults from env at construction —
``PIO_SLO_FAST_WINDOW_S`` / ``PIO_SLO_SLOW_WINDOW_S`` /
``PIO_SLO_BURN_THRESHOLD`` plus the per-objective knobs in the
``install_*`` default sets below — so ``bench.py production_stack``
(and any operator) can rescale the whole engine without code.

The clock is injectable end to end (registry and specs), so the golden
tests pin exact alert/clear transitions against a synthetic clock — no
wall-clock flakiness, the same discipline as ``common/breaker.py``.
"""

from __future__ import annotations

import math
import os
import threading
import time
from bisect import bisect_left
from collections import deque

from predictionio_tpu_torch.obs import metrics as _metrics

__all__ = [
    "OK",
    "BURNING",
    "VIOLATED",
    "Slo",
    "AvailabilitySlo",
    "LatencySlo",
    "BoundSlo",
    "ZeroCounterSlo",
    "SloRegistry",
    "REGISTRY",
    "register",
    "unregister",
    "document",
    "active_violations",
    "trace_tags",
    "install_engine_slos",
    "install_event_server_slos",
    "install_speed_layer_slos",
]

OK = "ok"
BURNING = "burning"
VIOLATED = "violated"
_STATE_CODE = {OK: 0, BURNING: 1, VIOLATED: 2}

# burn rates are unbounded (a zero-tolerance objective burns at
# infinity); gauges and JSON cap at this sentinel so the exports stay
# finite and sortable
_BURN_CAP = 1e6


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _read_value(source) -> float:
    """A signal source is a callable, a metric instance (``.value()``),
    or a list of either (summed — e.g. the two ``reason``-labeled 503
    counters feeding one budget)."""
    if isinstance(source, (list, tuple)):
        return float(sum(_read_value(s) for s in source))
    if callable(source) and not hasattr(source, "value"):
        return float(source() or 0.0)
    return float(source.value())


class Slo:
    """One objective. Subclasses define :meth:`_read`, which returns the
    CUMULATIVE (good, total, current) reading; the base class owns the
    sample ring, window deltas, burn rates, and the state machine.

    ``objective`` is the good-fraction target (0 < objective <= 1);
    ``1 - objective`` is the error budget. ``objective=1.0`` means zero
    tolerance: any bad unit burns at infinity (capped for export).
    """

    kind = "slo"

    def __init__(
        self,
        name: str,
        objective: float,
        description: str = "",
        fast_window_s: float | None = None,
        slow_window_s: float | None = None,
        burn_threshold: float | None = None,
    ):
        if not 0.0 < objective <= 1.0:
            raise ValueError(f"objective must be in (0, 1], got {objective}")
        self.name = name
        self.objective = float(objective)
        self.description = description
        self.fast_window_s = (
            _env_float("PIO_SLO_FAST_WINDOW_S", 300.0)
            if fast_window_s is None
            else float(fast_window_s)
        )
        self.slow_window_s = (
            _env_float("PIO_SLO_SLOW_WINDOW_S", 3600.0)
            if slow_window_s is None
            else float(slow_window_s)
        )
        self.slow_window_s = max(self.slow_window_s, self.fast_window_s)
        self.burn_threshold = (
            _env_float("PIO_SLO_BURN_THRESHOLD", 14.4)
            if burn_threshold is None
            else float(burn_threshold)
        )
        self.state = OK
        # (t, good_cum, total_cum) readings; pruned past the slow window
        self._samples: deque[tuple[float, float, float]] = deque()
        self._current: float | None = None

    # -- subclass contract ---------------------------------------------------
    def _read(self) -> tuple[float, float, float | None]:
        """(good_cum, total_cum, current_display_value)."""
        raise NotImplementedError

    # -- window math ---------------------------------------------------------
    def _window_delta(self, now: float, window_s: float) -> tuple[float, float]:
        """(bad, total) accrued inside ``[now - window_s, now]``.

        The start-of-window reading is the newest sample at or before
        the boundary; a series younger than the window falls back to its
        first sample (the window "grows in" instead of reporting zeros).
        """
        if not self._samples:
            return 0.0, 0.0
        end = self._samples[-1]
        start = self._samples[0]
        boundary = now - window_s
        for s in self._samples:
            if s[0] <= boundary:
                start = s
            else:
                break
        bad_delta = (end[2] - end[1]) - (start[2] - start[1])
        total_delta = end[2] - start[2]
        # counters are monotone, but a registry clear / server restart
        # can step a reading backwards — clamp instead of going negative
        return max(0.0, bad_delta), max(0.0, total_delta)

    def _burn(self, bad: float, total: float) -> float:
        if total <= 0.0:
            return 0.0
        err = bad / total
        budget = 1.0 - self.objective
        if budget <= 0.0:
            return math.inf if bad > 0 else 0.0
        return err / budget

    def evaluate(self, now: float) -> dict:
        """Record one reading and judge the objective. Returns the
        per-SLO document served on ``/slo.json``."""
        good, total, current = self._read()
        self._current = current
        self._samples.append((now, good, total))
        horizon = now - self.slow_window_s
        while len(self._samples) > 2 and self._samples[1][0] <= horizon:
            self._samples.popleft()

        bad_f, total_f = self._window_delta(now, self.fast_window_s)
        bad_s, total_s = self._window_delta(now, self.slow_window_s)
        burn_f = self._burn(bad_f, total_f)
        burn_s = self._burn(bad_s, total_s)

        if burn_f >= self.burn_threshold and burn_s >= self.burn_threshold:
            self.state = VIOLATED
        elif max(burn_f, burn_s) > 1.0:
            self.state = BURNING
        else:
            self.state = OK

        doc = {
            "name": self.name,
            "kind": self.kind,
            "description": self.description,
            "objective": self.objective,
            "state": self.state,
            "burn_fast": round(min(burn_f, _BURN_CAP), 4),
            "burn_slow": round(min(burn_s, _BURN_CAP), 4),
            "sli_fast": round(1.0 - bad_f / total_f, 6) if total_f else None,
            "sli_slow": round(1.0 - bad_s / total_s, 6) if total_s else None,
            "bad_fast": bad_f,
            "total_fast": total_f,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "burn_threshold": self.burn_threshold,
        }
        if current is not None:
            doc["current"] = round(current, 6)
        return doc


class AvailabilitySlo(Slo):
    """Ratio of non-bad units over total units, both cumulative counters
    (e.g. 5xx over requests). ``bad`` and ``total`` are metric instances
    / callables / lists thereof (summed)."""

    kind = "availability"

    def __init__(self, name, total, bad, objective=0.999, **kw):
        super().__init__(name, objective, **kw)
        self._total = total
        self._bad = bad

    def _read(self):
        total = _read_value(self._total)
        bad = min(_read_value(self._bad), total)
        return total - bad, total, None


class LatencySlo(Slo):
    """Fraction of observations at or under ``threshold_s``, read from a
    fixed-bucket :class:`obs.metrics.Histogram`. The threshold is
    quantized UP to the nearest bucket bound (the log layout steps ~2x),
    so the objective is judged against ``effective_threshold_s`` — both
    are exported. ``current`` is the cumulative interpolated percentile
    at ``display_quantile`` (display only; state comes from the windowed
    good/total ratio)."""

    kind = "latency"

    def __init__(self, name, hist, threshold_s, objective=0.99,
                 display_quantile: float = 0.99, **kw):
        super().__init__(name, objective, **kw)
        self._hist = hist
        self.threshold_s = float(threshold_s)
        # values <= bounds[i] live in cells 0..i (metrics.observe uses
        # bisect_left), so "good" is the cumulative count through the
        # first bound >= threshold
        idx = bisect_left(hist.bounds, self.threshold_s)
        self._good_cells = min(idx + 1, len(hist.bounds))
        self.effective_threshold_s = hist.bounds[
            min(idx, len(hist.bounds) - 1)
        ]
        self.display_quantile = float(display_quantile)

    def _read(self):
        counts, _, n = self._hist.merged()
        good = float(sum(counts[: self._good_cells]))
        current = _metrics._percentile_from_counts(
            counts, n, self.display_quantile, self._hist.bounds
        )
        return good, float(n), current

    def evaluate(self, now):
        doc = super().evaluate(now)
        doc["threshold_s"] = self.threshold_s
        doc["effective_threshold_s"] = self.effective_threshold_s
        return doc


class BoundSlo(Slo):
    """A gauge-shaped signal that must stay at or under ``bound`` —
    freshness, staleness, queue depth. Tick-sampled: each evaluation
    reads ``value_fn()`` and scores the tick good/bad, so the SLI is the
    fraction of evaluation ticks within bound (time-weighted at the
    registry's tick interval)."""

    kind = "bound"

    def __init__(self, name, value_fn, bound, objective=0.95, **kw):
        super().__init__(name, objective, **kw)
        self._value_fn = value_fn
        self.bound = float(bound)
        self._good_ticks = 0
        self._total_ticks = 0

    def _read(self):
        v = _read_value(self._value_fn)
        self._total_ticks += 1
        if v <= self.bound:
            self._good_ticks += 1
        return float(self._good_ticks), float(self._total_ticks), v

    def evaluate(self, now):
        doc = super().evaluate(now)
        doc["bound"] = self.bound
        return doc


class ZeroCounterSlo(Slo):
    """A counter that must never move (acked-event loss, data
    corruption). Zero tolerance: a tick that sees the counter advance
    burns at infinity, so the objective goes VIOLATED immediately, decays
    to BURNING once the bad tick ages out of the fast window, and clears
    when it leaves the slow window."""

    kind = "counter_zero"

    def __init__(self, name, counter, objective=1.0, **kw):
        super().__init__(name, objective, **kw)
        self._counter = counter
        self._last: float | None = None
        self._good_ticks = 0
        self._total_ticks = 0

    def _read(self):
        cur = _read_value(self._counter)
        moved = self._last is not None and cur > self._last
        self._last = cur
        self._total_ticks += 1
        if not moved:
            self._good_ticks += 1
        return float(self._good_ticks), float(self._total_ticks), cur


class SloRegistry:
    """Process-global set of objectives plus the evaluation loop.

    ``register`` replaces by name (a redeployed server re-installs its
    default set; the stale spec — and its closed-over readers — drop
    out). A lazy daemon ticker drives periodic evaluation on the global
    registry; test registries pass a synthetic ``clock`` and call
    :meth:`evaluate_all` directly.
    """

    def __init__(self, clock=time.time, interval_s: float | None = None):
        self._clock = clock
        self.interval_s = (
            _env_float("PIO_SLO_INTERVAL_S", 5.0)
            if interval_s is None
            else float(interval_s)
        )
        self._lock = threading.Lock()
        self._slos: dict[str, Slo] = {}
        self._alerts: deque[dict] = deque(maxlen=256)
        self._last_eval = 0.0
        self._last_docs: list[dict] = []
        self._violations: tuple[str, ...] = ()
        self._latency_slos: tuple[LatencySlo, ...] = ()
        self._ticker: threading.Thread | None = None
        # flight-recorder tap: called with each transition dict that
        # lands in VIOLATED, after the active-violation set is updated
        # (obs.incident installs itself here; tests leave it None)
        self.on_violation = None

    # -- membership ----------------------------------------------------------
    def register(self, slo: Slo) -> Slo:
        with self._lock:
            self._slos[slo.name] = slo
            self._latency_slos = tuple(
                s for s in self._slos.values() if isinstance(s, LatencySlo)
            )
        return slo

    def unregister(self, name: str) -> None:
        with self._lock:
            self._slos.pop(name, None)
            self._latency_slos = tuple(
                s for s in self._slos.values() if isinstance(s, LatencySlo)
            )

    def clear(self) -> None:
        with self._lock:
            self._slos.clear()
            self._alerts.clear()
            self._latency_slos = ()
            self._violations = ()
            self._last_docs = []
            self._last_eval = 0.0

    def names(self) -> list[str]:
        with self._lock:
            return list(self._slos)

    # -- evaluation ----------------------------------------------------------
    def evaluate_all(self, now: float | None = None) -> dict:
        """Evaluate every objective once; updates ``pio_slo_*`` gauges,
        the alert ring, and the active-violation set. Returns the
        ``/slo.json`` document."""
        if not _metrics.enabled():
            return {"enabled": False, "slos": [], "alerts": []}
        now = self._clock() if now is None else now
        with self._lock:
            slos = list(self._slos.values())
        docs: list[dict] = []
        violated: list[str] = []
        fired: list[dict] = []
        for s in slos:
            was = s.state
            try:
                doc = s.evaluate(now)
            except Exception as e:  # a dead reader must not kill the tick
                doc = {
                    "name": s.name, "kind": s.kind, "state": s.state,
                    "error": f"{type(e).__name__}: {e}",
                }
                docs.append(doc)
                continue
            docs.append(doc)
            if s.state == VIOLATED:
                violated.append(s.name)
            if s.state != was:
                transition = {
                    "t": round(now, 3),
                    "slo": s.name,
                    "from": was,
                    "to": s.state,
                    "burn_fast": doc.get("burn_fast"),
                    "burn_slow": doc.get("burn_slow"),
                }
                with self._lock:
                    self._alerts.append(transition)
                if s.state == VIOLATED:
                    fired.append(transition)
                    _metrics.counter(
                        "pio_slo_alerts_total",
                        "Transitions into the violated (alerting) state",
                        slo=s.name,
                    ).inc()
            _metrics.gauge(
                "pio_slo_state",
                "SLO state (0=ok, 1=burning, 2=violated)",
                slo=s.name,
            ).set(_STATE_CODE[s.state])
            for window, burn in (
                ("fast", doc.get("burn_fast")),
                ("slow", doc.get("burn_slow")),
            ):
                if burn is not None:
                    _metrics.gauge(
                        "pio_slo_burn_rate",
                        "Error-budget burn rate over the window "
                        "(1.0 = sustainable)",
                        slo=s.name, window=window,
                    ).set(burn)
            if doc.get("sli_slow") is not None:
                _metrics.gauge(
                    "pio_slo_sli",
                    "Good-fraction SLI over the slow window",
                    slo=s.name,
                ).set(doc["sli_slow"])
        with self._lock:
            self._violations = tuple(violated)
            self._last_eval = now
            self._last_docs = docs
            alerts = list(self._alerts)
        hook = self.on_violation
        if hook is not None:
            # fire AFTER the violation set is published so the flight
            # recorder sees traces tagged against the new violation
            for transition in fired:
                try:
                    hook(transition)
                except Exception:
                    pass
        return {
            "enabled": True,
            "now": round(now, 3),
            "interval_s": self.interval_s,
            "slos": docs,
            "alerts": alerts,
        }

    def document(self, max_age_s: float = 1.0) -> dict:
        """The ``/slo.json`` body; re-evaluates when the cached
        evaluation is older than ``max_age_s`` (scrapes between ticker
        firings see fresh state without doubling the sample rate)."""
        if not _metrics.enabled():
            return {"enabled": False, "slos": [], "alerts": []}
        now = self._clock()
        with self._lock:
            fresh = now - self._last_eval < max_age_s and self._last_docs
            docs, alerts = list(self._last_docs), list(self._alerts)
            last = self._last_eval
        if fresh:
            return {
                "enabled": True,
                "now": round(last, 3),
                "interval_s": self.interval_s,
                "slos": docs,
                "alerts": alerts,
            }
        return self.evaluate_all(now)

    # -- violation taps (trace tagging, satellite 2) -------------------------
    def active_violations(self) -> tuple[str, ...]:
        return self._violations

    def trace_tags(self, duration_s: float) -> list[str]:
        """SLO names this finished request is evidence for: every
        objective currently in VIOLATED, plus any latency objective
        whose threshold this request individually blew (even while the
        aggregate still holds)."""
        tags = list(self._violations)
        for s in self._latency_slos:
            if (
                duration_s > s.effective_threshold_s
                and s.name not in tags
            ):
                tags.append(s.name)
        return tags

    # -- ticker --------------------------------------------------------------
    def ensure_ticker(self) -> None:
        """Start the background evaluation thread once (daemon; global
        registry only). No-op when obs is disabled at call time or
        ``PIO_SLO_TICK=0``."""
        if self._ticker is not None or not _metrics.enabled():
            return
        if os.environ.get("PIO_SLO_TICK", "1") == "0":
            return
        with self._lock:
            if self._ticker is not None:
                return
            t = threading.Thread(
                target=self._tick_loop, name="slo-ticker", daemon=True
            )
            self._ticker = t
        t.start()

    def _tick_loop(self) -> None:  # pragma: no cover - timing loop
        while True:
            time.sleep(self.interval_s)
            try:
                if _metrics.enabled() and self._slos:
                    self.evaluate_all()
                if _metrics.enabled():
                    # the metrics history sampler rides this ticker
                    # (same default cadence; its own step guard decides)
                    from predictionio_tpu_torch.obs import history as _history

                    _history.maybe_sample()
            except Exception:
                pass  # the ticker must survive any reader


REGISTRY = SloRegistry()


def register(slo: Slo) -> Slo:
    REGISTRY.ensure_ticker()
    return REGISTRY.register(slo)


def unregister(name: str) -> None:
    REGISTRY.unregister(name)


def document() -> dict:
    return REGISTRY.document()


def active_violations() -> tuple[str, ...]:
    return REGISTRY.active_violations()


def trace_tags(duration_s: float) -> list[str]:
    return REGISTRY.trace_tags(duration_s)


# -- default SLO sets --------------------------------------------------------
#
# Each server installs its set at construction; names are stable so a
# redeploy replaces rather than duplicates. Budgets are env-tunable —
# the runbook table in docs/operations.md names every knob.


def install_engine_slos(server) -> list[Slo]:
    """Engine server defaults: p99 query latency, 5xx availability, the
    warmup/deadline 503 budget, and ingest-to-servable freshness."""
    reg = _metrics.REGISTRY
    requests = reg.counter(
        "pio_http_requests_total", "Requests handled", server="engine"
    )
    errors = reg.counter(
        "pio_http_errors_total", "Requests answered with 5xx", server="engine"
    )
    unavailable = [
        reg.counter(
            "pio_query_unavailable_total", "Queries 503'd while unavailable",
            reason=reason,
        )
        for reason in ("swap", "deadline")
    ]
    from predictionio_tpu_torch.obs import freshness as _freshness

    slos = [
        LatencySlo(
            "engine.latency",
            server._m_serving,
            threshold_s=_env_float("PIO_SLO_SERVING_MS", 250.0) / 1e3,
            objective=_env_float("PIO_SLO_SERVING_OBJECTIVE", 0.99),
            description="Queries served under the latency budget",
        ),
        AvailabilitySlo(
            "engine.availability",
            total=requests,
            bad=errors,
            objective=_env_float("PIO_SLO_ENGINE_AVAILABILITY", 0.999),
            description="Non-5xx fraction of engine-server requests",
        ),
        AvailabilitySlo(
            "engine.unavailable_503",
            total=requests,
            bad=unavailable,
            objective=_env_float("PIO_SLO_UNAVAILABLE_OBJECTIVE", 0.99),
            description="Budget for warmup-fence and deadline 503s",
        ),
        LatencySlo(
            "serving.freshness",
            _freshness.HISTOGRAM,
            threshold_s=_env_float("PIO_SLO_FRESHNESS_S", 30.0),
            objective=_env_float("PIO_SLO_FRESHNESS_OBJECTIVE", 0.95),
            description="Ingest-to-servable latency at the fenced commit",
        ),
    ]
    return [register(s) for s in slos]


def install_variant_slos(variant) -> list[Slo]:
    """Per-tenant latency objective for one mount of a multi-tenant
    engine server: same budget knobs as ``engine.latency``, observed on
    the mount's ``variant=``-labeled histogram and named
    ``engine.latency[<mount>]`` so one noisy tenant pages as itself
    rather than as the process aggregate. Solo deploys never install
    these — their names and series stay byte-identical."""
    slos = [
        LatencySlo(
            f"engine.latency[{variant.name}]",
            variant._m_serving_v,
            threshold_s=_env_float("PIO_SLO_SERVING_MS", 250.0) / 1e3,
            objective=_env_float("PIO_SLO_SERVING_OBJECTIVE", 0.99),
            description=(
                f"Queries for mount {variant.name!r} served under the "
                "latency budget"
            ),
        ),
    ]
    return [register(s) for s in slos]


def install_router_slos(router_server) -> list[Slo]:
    """Router-tier defaults: non-5xx availability and end-to-end p99 on
    the router's own HTTP histogram. The latency budget defaults to the
    serving budget (the router should be invisible); ``PIO_SLO_ROUTER_MS``
    overrides it when hedging headroom is wanted."""
    reg = _metrics.REGISTRY
    requests = reg.counter(
        "pio_http_requests_total", "Requests handled", server="router"
    )
    errors = reg.counter(
        "pio_http_errors_total", "Requests answered with 5xx", server="router"
    )
    slos = [
        AvailabilitySlo(
            "router.availability",
            total=requests,
            bad=errors,
            objective=_env_float("PIO_SLO_ROUTER_AVAILABILITY", 0.999),
            description="Non-5xx fraction of router-tier requests",
        ),
        LatencySlo(
            "router.latency",
            router_server.app._m_request,
            threshold_s=_env_float(
                "PIO_SLO_ROUTER_MS", _env_float("PIO_SLO_SERVING_MS", 250.0)
            ) / 1e3,
            objective=_env_float("PIO_SLO_ROUTER_OBJECTIVE", 0.99),
            description="Routed queries under the latency budget "
                        "(hedging absorbs stragglers)",
        ),
    ]
    return [register(s) for s in slos]


def install_event_server_slos(server) -> list[Slo]:
    """Event server defaults: ingest availability + group-commit
    latency."""
    reg = _metrics.REGISTRY
    requests = reg.counter(
        "pio_http_requests_total", "Requests handled", server="eventserver"
    )
    errors = reg.counter(
        "pio_http_errors_total", "Requests answered with 5xx",
        server="eventserver",
    )
    slos = [
        AvailabilitySlo(
            "ingest.availability",
            total=requests,
            bad=errors,
            objective=_env_float("PIO_SLO_INGEST_AVAILABILITY", 0.999),
            description="Non-5xx fraction of event-server requests",
        ),
        LatencySlo(
            "ingest.group_commit",
            server._m_group_commit,
            threshold_s=_env_float("PIO_SLO_GROUP_COMMIT_MS", 100.0) / 1e3,
            objective=_env_float("PIO_SLO_GROUP_COMMIT_OBJECTIVE", 0.99),
            description="Batch group-commit windows under the budget",
        ),
        BoundSlo(
            "ingest.backpressure",
            lambda: server._budget.utilization(),
            bound=_env_float("PIO_SLO_INGEST_INFLIGHT_UTIL", 0.9),
            objective=_env_float("PIO_SLO_INGEST_INFLIGHT_OBJECTIVE", 0.95),
            description=(
                "In-flight ingest byte budget utilization stays under "
                "the shed threshold (sustained saturation means clients "
                "are seeing 429s)"
            ),
        ),
    ]
    return [register(s) for s in slos]


def install_speed_layer_slos(layer) -> list[Slo]:
    """Speed-layer defaults: bounded ``seconds_behind`` + a fold-in
    breaker open-time budget. On a multi-tenant engine server each
    mount's layer gets its own pair, suffixed ``[<mount>]`` — solo
    deploys keep the unsuffixed names."""
    breaker = layer.breaker
    vn = getattr(layer.server, "variant_name", None)
    sfx = f"[{vn}]" if vn else ""

    def _seconds_behind() -> float:
        try:
            return float(layer.gauges()["seconds_behind"])
        except Exception:
            return 0.0

    slos = [
        BoundSlo(
            f"realtime.seconds_behind{sfx}",
            _seconds_behind,
            bound=_env_float("PIO_SLO_SECONDS_BEHIND", 60.0),
            objective=_env_float("PIO_SLO_SECONDS_BEHIND_OBJECTIVE", 0.95),
            description="Serving staleness vs the event log stays bounded",
        ),
        BoundSlo(
            f"realtime.breaker_open{sfx}",
            lambda: 1.0 if breaker.state != "closed" else 0.0,
            bound=0.5,
            objective=_env_float("PIO_SLO_BREAKER_OBJECTIVE", 0.9),
            description="Fold-in circuit breaker open-time budget",
        ),
    ]
    return [register(s) for s in slos]
