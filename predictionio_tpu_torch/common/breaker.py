"""Circuit breaker: trip on repeated failures, half-open with backoff.

A copy of ``predictionio_tpu/common/breaker.py``.

Used by the speed layer around fold-in (realtime/speed_layer.py): after
``failure_threshold`` consecutive failures the breaker OPENS and the
caller stops attempting the guarded operation — the engine keeps serving
the last good epoch-fenced model instead of burning a failing path on
every poll tick. After an exponential-backoff-with-jitter delay the
breaker HALF-OPENS: exactly one trial call is allowed through; success
closes the breaker, failure re-opens it with a doubled backoff (capped).

State and transitions are exported through obs (``pio_breaker_state``,
``pio_breaker_transitions_total``, ``pio_breaker_failures_total``) so
``/metrics`` and ``pio status --json`` show a tripped breaker directly.

Deterministic for tests: the jitter RNG is seeded and the clock is
injectable.
"""

from __future__ import annotations

import logging
import random
import threading
import time

from predictionio_tpu_torch.obs import metrics as obs_metrics

logger = logging.getLogger(__name__)

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


def backoff_interval(
    attempt: int,
    *,
    base_s: float,
    max_s: float,
    jitter: float,
    rng: random.Random,
) -> float:
    """The shared retry-backoff policy: ``base * 2^(attempt-1)`` capped
    at ``max_s``, then jittered by ``±jitter``. ``attempt`` is 1-based
    (attempt 1 waits ~``base_s``). Used by the breaker's open interval
    (and, in the JAX package, the fleet supervisor's crash-restart
    schedule) — one policy, one set of semantics to reason about."""
    raw = base_s * (2 ** max(0, attempt - 1))
    raw = min(raw, max_s)
    return raw * (1.0 + jitter * rng.uniform(-1.0, 1.0))


class CircuitBreaker:
    def __init__(
        self,
        name: str,
        failure_threshold: int = 3,
        base_backoff_s: float = 1.0,
        max_backoff_s: float = 60.0,
        jitter: float = 0.2,
        seed: int = 0,
        clock=time.monotonic,
    ) -> None:
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.base_backoff_s = float(base_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opens = 0  # consecutive opens since last success (backoff exp)
        self._retry_at = 0.0
        self.failures_total = 0
        self.trips_total = 0
        self._gauge().set(0)

    def _gauge(self):
        return obs_metrics.gauge(
            "pio_breaker_state",
            "Circuit breaker state (0=closed, 1=open, 2=half_open)",
            breaker=self.name,
        )

    def _transition(self, to: str) -> None:
        """Caller holds the lock."""
        if to == self._state:
            return
        logger.warning("breaker %s: %s -> %s", self.name, self._state, to)
        self._state = to
        self._gauge().set(_STATE_CODE[to])
        obs_metrics.counter(
            "pio_breaker_transitions_total",
            "Circuit breaker state transitions",
            breaker=self.name, to=to,
        ).inc()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def backoff_s(self) -> float:
        """Current open-interval length: base * 2^(opens-1), jittered."""
        return backoff_interval(
            self._opens,
            base_s=self.base_backoff_s,
            max_s=self.max_backoff_s,
            jitter=self.jitter,
            rng=self._rng,
        )

    def allow(self) -> bool:
        """May the guarded operation run now? OPEN: no until the backoff
        deadline passes, then the breaker half-opens. HALF_OPEN admits
        trials until a verdict is recorded — with a single-threaded
        caller (the speed-layer loop) that is exactly one in-flight
        trial; the first ``record_failure`` re-opens, ``record_success``
        closes."""
        with self._lock:
            if self._state in (CLOSED, HALF_OPEN):
                return True
            if self._clock() >= self._retry_at:
                self._transition(HALF_OPEN)
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._opens = 0
            self._transition(CLOSED)

    def record_failure(self) -> None:
        self.failures_total += 1
        obs_metrics.counter(
            "pio_breaker_failures_total",
            "Failures observed by the circuit breaker",
            breaker=self.name,
        ).inc()
        with self._lock:
            self._consecutive_failures += 1
            if self._state == HALF_OPEN or (
                self._state == CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._open()

    def _open(self) -> None:
        """Caller holds the lock."""
        self._opens += 1
        self.trips_total += 1
        self._retry_at = self._clock() + self.backoff_s()
        self._transition(OPEN)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "failures_total": self.failures_total,
                "trips_total": self.trips_total,
                "retry_in_s": max(0.0, self._retry_at - self._clock())
                if self._state == OPEN
                else 0.0,
            }
