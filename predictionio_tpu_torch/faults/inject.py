"""Deterministic, seeded fault injection for crash/chaos testing.

The framework is a registry of NAMED fault points threaded through the
storage backends, the HTTP servers, the speed layer, and the training
loop (:data:`KNOWN_POINTS` is the catalogue; docs/robustness.md the
operator view). Each call site does::

    from predictionio_tpu_torch import faults
    ...
    faults.fault_point("storage.fsync")

which is a no-op (one module-global ``is None`` check) unless a
:class:`FaultPlan` is active. A plan is a list of :class:`FaultRule`\\ s;
each rule names a point (exact, or a ``prefix.*`` wildcard), a trigger,
and an action:

- triggers: ``nth=N`` (the Nth matching call, 1-based), ``p=0.25``
  (seeded Bernoulli per call — deterministic for a given ``seed``), or
  always; ``times=K`` bounds total firings.
- actions: ``raise[=ExcName[,msg]]`` (default: :class:`FaultError`, an
  OSError subclass so the injected failure flows through the same
  error-handling the real fault would), ``sleep=ms`` (latency
  injection), ``kill`` (SIGKILL the process at the point — the
  in-protocol stand-in for kill-9/power loss, used by the crash-recovery
  and chaos tests).

Activation: the ``PIO_FAULTS`` env var (parsed once at import —
subprocess chaos children inherit it), or in-process via
:func:`install` / :func:`injected`. Env grammar, semicolon-separated::

    point[:trigger[,trigger...]][:action]

e.g. ``PIO_FAULTS="storage.fsync:nth=3:raise=OSError"`` or
``"storage.write:p=0.01,seed=7,times=2:sleep=50;http.read:nth=5:kill"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import random
import signal
import threading
import time

from predictionio_tpu_torch.obs import metrics as obs_metrics

logger = logging.getLogger(__name__)


class FaultError(OSError):
    """Default injected exception. An OSError subclass on purpose: the
    I/O-shaped fault points (write/fsync/rename/socket) are guarded by
    OSError handling in production code, and the injection must prove
    THOSE paths out, not invent a novel error type they'd never see."""


# The catalogue of fault points threaded through the codebase. Injection
# works at any name (call sites are authoritative), but docs and tests
# key off this registry.
KNOWN_POINTS: dict[str, str] = {
    "storage.write": "event-log append write+flush (jsonl/partitioned)",
    "storage.fsync": "durability fsyncs: group-commit coalescer, compact, "
                     "partitioned seal",
    "storage.rename": "atomic tmp->final publishes: compact, partitioned "
                      "seal, tailer cursor, checkpoint",
    "storage.sqlite.commit": "sqlite event-insert transaction commit",
    "colcache.store": "columnar-cache block write+fsync+rename publish",
    "http.accept": "server socket accept (all HTTP servers)",
    "http.read": "request read/parse on an accepted connection",
    "http.frame": "binary ingest frame read off the request body "
                  "(/batch/events.bin, data/storage/frame.py)",
    "serve.query": "engine-server per-query scoring entry",
    "serve.batch_dispatch": "micro-batcher batch_predict device dispatch",
    "device.dispatch": "fused ALS training-program dispatch "
                       "(single-chip and sharded)",
    "train.checkpoint": "ALS checkpoint snapshot write",
    "foldin.fold": "speed-layer incremental fold-in solve",
    "tail.decode": "columnar tail span->array decode of one polled "
                   "chunk (realtime/tailer.py; a raise falls the chunk "
                   "back to the object parser, counted in "
                   "pio_tailer_columnar_fallback_lines_total)",
    "http.drain": "graceful-drain entry on an HTTP server "
                  "(HTTPApp.begin_drain)",
    "supervisor.spawn": "fleet-supervisor child (re)spawn "
                        "(server/supervisor.py)",
    "serve.model_mmap": "model-file mmap attempt at deploy/reload "
                        "(models/modelfile.py; a raise falls the load "
                        "back to a plain byte read, counted in "
                        "pio_model_mmap_fallback_total)",
    "router.forward": "router-tier forward of one query attempt to one "
                      "replica (server/router.py; a raise ejects the "
                      "replica and retries on another, counted in "
                      "pio_router_retries_total)",
    "router.probe": "router-tier /readyz probe of one replica "
                    "(server/router.py; a raise ejects the replica "
                    "until a later probe round re-admits it)",
    "train.prep_cache": "packed-prep cache publish (core/prep_cache.py "
                        "store; a raise skips the publish — training is "
                        "unaffected and the next train falls back to a "
                        "clean rebuild)",
}

_EXCEPTIONS: dict[str, type[BaseException]] = {
    "FaultError": FaultError,
    "OSError": OSError,
    "IOError": OSError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
    "TimeoutError": TimeoutError,
    "ConnectionError": ConnectionError,
    "ConnectionResetError": ConnectionResetError,
}


@dataclasses.dataclass
class FaultRule:
    """One point's trigger + action. Mutable call/fire counters live on
    the rule; the owning plan's lock serializes them."""

    point: str
    nth: int | None = None          # fire on the Nth matching call (1-based)
    probability: float | None = None
    seed: int = 0
    times: int | None = None        # max total firings (None = unlimited)
    action: str = "raise"           # "raise" | "sleep" | "kill"
    exc: type[BaseException] = FaultError
    message: str = ""
    sleep_ms: float = 0.0

    def __post_init__(self) -> None:
        if self.action not in ("raise", "sleep", "kill"):
            raise ValueError(f"unknown fault action {self.action!r}")
        self._rng = random.Random(self.seed)
        self.calls = 0
        self.fired = 0

    def matches(self, point: str) -> bool:
        if self.point.endswith(".*"):
            return point.startswith(self.point[:-1]) or point == self.point[:-2]
        return point == self.point

    def should_fire(self) -> bool:
        """Advance this rule's call counter; True when the trigger trips
        (caller holds the plan lock)."""
        self.calls += 1
        if self.times is not None and self.fired >= self.times:
            return False
        if self.nth is not None and self.calls != self.nth:
            return False
        if self.probability is not None and self._rng.random() >= self.probability:
            return False
        self.fired += 1
        return True


class FaultPlan:
    """An ordered rule list; the first matching rule that trips wins."""

    def __init__(self, rules: list[FaultRule] | tuple[FaultRule, ...]):
        self.rules = list(rules)
        self._lock = threading.Lock()
        self.fired: dict[str, int] = {}

    def on_call(self, point: str) -> FaultRule | None:
        with self._lock:
            for rule in self.rules:
                if rule.matches(point) and rule.should_fire():
                    self.fired[point] = self.fired.get(point, 0) + 1
                    return rule
        return None

    def fire_count(self, point: str | None = None) -> int:
        with self._lock:
            if point is not None:
                return self.fired.get(point, 0)
            return sum(self.fired.values())


def parse_rule(spec: str) -> FaultRule:
    """``point[:trigger[,trigger...]][:action]`` -> FaultRule."""
    parts = [p.strip() for p in spec.strip().split(":")]
    if not parts or not parts[0]:
        raise ValueError(f"fault rule needs a point name: {spec!r}")
    kwargs: dict = {"point": parts[0]}
    action_part = None
    for part in parts[1:]:
        if not part or part == "always":
            continue
        head = part.split("=", 1)[0].split(",", 1)[0]
        if head in ("raise", "sleep", "kill"):
            action_part = part
            continue
        for term in part.split(","):
            k, _, v = term.partition("=")
            k = k.strip()
            if k == "nth":
                kwargs["nth"] = int(v)
            elif k == "p":
                kwargs["probability"] = float(v)
            elif k == "seed":
                kwargs["seed"] = int(v)
            elif k == "times":
                kwargs["times"] = int(v)
            else:
                raise ValueError(f"unknown fault trigger {term!r} in {spec!r}")
    if action_part is not None:
        name, _, arg = action_part.partition("=")
        kwargs["action"] = name
        if name == "sleep":
            kwargs["sleep_ms"] = float(arg)
        elif name == "raise" and arg:
            exc_name, _, msg = arg.partition(",")
            try:
                kwargs["exc"] = _EXCEPTIONS[exc_name]
            except KeyError:
                raise ValueError(
                    f"unknown fault exception {exc_name!r}; one of "
                    f"{sorted(_EXCEPTIONS)}"
                ) from None
            kwargs["message"] = msg
    return FaultRule(**kwargs)


def parse_plan(spec: str) -> FaultPlan:
    rules = [parse_rule(s) for s in spec.split(";") if s.strip()]
    return FaultPlan(rules)


def plan_from_env() -> FaultPlan | None:
    spec = os.environ.get("PIO_FAULTS", "").strip()
    if not spec:
        return None
    plan = parse_plan(spec)
    logger.warning(
        "PIO_FAULTS active: %d fault rule(s) — %s",
        len(plan.rules), [r.point for r in plan.rules],
    )
    return plan


_active: FaultPlan | None = plan_from_env()


def active_plan() -> FaultPlan | None:
    return _active


def install(plan: FaultPlan) -> FaultPlan:
    """Activate a plan process-wide (test API). Returns it."""
    global _active
    _active = plan
    return plan


def clear() -> None:
    global _active
    _active = None


@contextlib.contextmanager
def injected(*rules: FaultRule | str):
    """Context-managed plan: ``with faults.injected("storage.fsync:nth=2")``.
    Accepts rule specs or FaultRule instances."""
    global _active
    plan = FaultPlan(
        [r if isinstance(r, FaultRule) else parse_rule(r) for r in rules]
    )
    prev = _active
    install(plan)
    try:
        yield plan
    finally:
        _active = prev


def fault_point(name: str) -> None:
    """The injection hook. Compiled down to one global load + None check
    when no plan is active — the <1% disabled-overhead gate in
    ``bench.py robustness`` measures exactly this path."""
    plan = _active
    if plan is None:
        return
    rule = plan.on_call(name)
    if rule is None:
        return
    obs_metrics.counter(
        "pio_faults_injected_total", "Faults fired by the active FaultPlan",
        point=name, action=rule.action,
    ).inc()
    if rule.action == "sleep":
        logger.warning("fault %s: injected %gms latency", name, rule.sleep_ms)
        time.sleep(rule.sleep_ms / 1e3)
        return
    if rule.action == "kill":
        logger.warning("fault %s: SIGKILL (injected crash)", name)
        os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(60)  # pragma: no cover - never survives the signal
        return
    logger.warning("fault %s: raising %s", name, rule.exc.__name__)
    raise rule.exc(rule.message or f"injected fault at {name}")
