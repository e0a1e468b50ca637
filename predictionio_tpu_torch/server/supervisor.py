"""Self-healing fleet supervisor: crash-restart with seeded backoff.

``pio start-all --supervise`` (and ``pio supervise``) runs this parent
instead of the fire-and-forget detached bring-up: it spawns the fleet,
keeps the ``Popen`` handles (so crashes are reaped with a real exit
status instead of lingering as zombies), and monitors each child two
ways — pid liveness via ``poll()`` and HTTP ``/healthz`` probes whose
per-boot instance id + pid prove WHICH process answered.

A dead or persistently-unhealthy child is restarted on the shared
exponential-backoff-with-jitter policy (``common/breaker.py``'s
``backoff_interval`` — seeded per service, so restart timing is
deterministic under test). A service that crashes ``flap_max`` times
within ``flap_window_s`` is declared ``broken``: the supervisor stops
respawning it and fires a flight-recorder incident bundle
(``obs/incident.py``) for the operator.

State is exported three ways:

- ``pio_supervisor_restarts_total`` / ``pio_supervisor_state`` metrics
  in this process's obs registry (scrapeable when ``--supervise-port``
  mounts the obs routes);
- an atomically-written ``supervisor.json`` under the run dir, which
  ``pio status`` (plain and ``--json``) renders per service;
- the structured ``services()`` snapshot for in-process callers.

Clock, sleep, spawn, and probe are injectable — the crash/backoff/flap
state machine is unit-testable without processes.

Port of ``predictionio_tpu/server/supervisor.py``: the same states,
knobs (``PIO_SUPERVISE_*``), metrics and ``supervisor.json``, so either
package's ``status`` renders the other's fleet. This process never
touches the card: neither it nor ``cli/daemon.py`` imports ``torch`` at
module level (a ``/metrics`` scrape of ``stats_app`` and the default
prep-cache path load it, and start no CUDA context), and every child
(the services and the scheduled ``train``) is a fresh interpreter
started by ``cli/daemon.py``, each with its own CUDA context.
"""

from __future__ import annotations

import collections
import logging
import os
import random
import signal
import subprocess
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable

from predictionio_tpu_torch import faults
from predictionio_tpu_torch.cli import daemon
from predictionio_tpu_torch.common.breaker import backoff_interval
from predictionio_tpu_torch.obs import incident as obs_incident
from predictionio_tpu_torch.obs import metrics as obs_metrics

logger = logging.getLogger(__name__)

# child states
STARTING = "starting"      # spawned, waiting for first healthy probe
UP = "up"                  # healthy
RESTARTING = "restarting"  # crashed; waiting out the backoff interval
BROKEN = "broken"          # flapped past the budget; operator required
STOPPED = "stopped"        # shut down by the supervisor

_STATE_CODE = {UP: 0, STARTING: 1, RESTARTING: 2, BROKEN: 3, STOPPED: 4}


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _describe_exit(rc: int | None) -> str:
    if rc is None:
        return "unknown"
    if rc < 0:
        try:
            return f"signal {-rc} ({signal.Signals(-rc).name})"
        except ValueError:
            return f"signal {-rc}"
    return f"exit code {rc}"


@dataclass
class ServiceSpec:
    """One supervised service: how to spawn it and where to probe it.

    ``spawn`` (tests) overrides the default ``pio``-verb spawn; it must
    return a Popen-like handle (``pid``, ``poll()``, ``terminate()``,
    ``kill()``, ``wait()``).
    """

    name: str
    argv: list[str] = field(default_factory=list)
    host: str = "127.0.0.1"
    port: int = 0
    spawn: Callable[[], Any] | None = None
    boot_timeout_s: float = 90.0


class _Child:
    """Mutable per-service supervision state."""

    def __init__(self, spec: ServiceSpec, seed: int):
        self.spec = spec
        self.state = STOPPED
        self.proc: Any | None = None
        self.pid: int | None = None
        self.instance: str | None = None
        self.restarts = 0                # respawns after the first start
        self.attempt = 0                 # consecutive failures -> backoff exp
        self.last_exit: str | None = None
        self.next_retry_at: float | None = None
        self.last_backoff_s: float | None = None
        self.boot_deadline = 0.0
        self.stable_at = 0.0
        self.health_fails = 0
        self.crash_times: collections.deque[float] = collections.deque()
        # per-service seeded jitter stream: restart timing is a pure
        # function of (seed, service name, crash sequence)
        self.rng = random.Random(seed ^ zlib.crc32(spec.name.encode()))


class Supervisor:
    """Spawns, probes, restarts, and reports on a service fleet."""

    def __init__(
        self,
        specs: list[ServiceSpec],
        *,
        poll_interval: float | None = None,
        base_backoff_s: float | None = None,
        max_backoff_s: float | None = None,
        jitter: float = 0.2,
        flap_max: int | None = None,
        flap_window_s: float | None = None,
        stable_s: float | None = None,
        health_fail_threshold: int | None = None,
        seed: int | None = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        probe: Callable[[ServiceSpec], dict | None] | None = None,
        retrain: "RetrainScheduler | None" = None,
    ):
        self.poll_interval = (
            poll_interval
            if poll_interval is not None
            else _env_float("PIO_SUPERVISE_POLL_S", 0.5)
        )
        self.base_backoff_s = (
            base_backoff_s
            if base_backoff_s is not None
            else _env_float("PIO_SUPERVISE_BACKOFF_S", 0.5)
        )
        self.max_backoff_s = (
            max_backoff_s
            if max_backoff_s is not None
            else _env_float("PIO_SUPERVISE_MAX_BACKOFF_S", 30.0)
        )
        self.jitter = float(jitter)
        self.flap_max = int(
            flap_max
            if flap_max is not None
            else _env_float("PIO_SUPERVISE_FLAP_N", 5)
        )
        self.flap_window_s = (
            flap_window_s
            if flap_window_s is not None
            else _env_float("PIO_SUPERVISE_FLAP_WINDOW_S", 60.0)
        )
        self.stable_s = (
            stable_s
            if stable_s is not None
            else _env_float("PIO_SUPERVISE_STABLE_S", 30.0)
        )
        self.health_fail_threshold = int(
            health_fail_threshold
            if health_fail_threshold is not None
            else _env_float("PIO_SUPERVISE_HEALTH_FAILS", 3)
        )
        if seed is None:
            seed = int(_env_float("PIO_SUPERVISE_SEED", 0))
        self.seed = seed
        self._clock = clock
        self._sleep = sleep
        self._probe_fn = probe
        self._children = [_Child(spec, seed) for spec in specs]
        self.retrain = retrain
        self._stop_event = threading.Event()
        self._dirty = True
        self._lock = threading.RLock()

    # -- metrics -----------------------------------------------------------

    @staticmethod
    def _m_restarts(name: str):
        return obs_metrics.counter(
            "pio_supervisor_restarts_total",
            "Child restarts performed by the fleet supervisor",
            service=name,
        )

    @staticmethod
    def _g_state(name: str):
        return obs_metrics.gauge(
            "pio_supervisor_state",
            "Supervised service state "
            "(0=up, 1=starting, 2=restarting, 3=broken, 4=stopped)",
            service=name,
        )

    def _set_state(self, child: _Child, state: str) -> None:
        if state != child.state:
            logger.info(
                "supervisor: %s %s -> %s", child.spec.name, child.state, state
            )
        child.state = state
        self._g_state(child.spec.name).set(float(_STATE_CODE[state]))
        self._dirty = True

    # -- spawn / probe -----------------------------------------------------

    def _spawn(self, child: _Child) -> Any:
        faults.fault_point("supervisor.spawn")
        if child.spec.spawn is not None:
            return child.spec.spawn()
        return daemon.spawn_service(child.spec.name, child.spec.argv)

    def _probe(self, child: _Child) -> dict | None:
        if self._probe_fn is not None:
            return self._probe_fn(child.spec)
        if not child.spec.port:
            return None
        return daemon.probe_health(
            child.spec.host, child.spec.port, timeout=1.0
        )

    def _launch(self, child: _Child, now: float) -> None:
        try:
            proc = self._spawn(child)
        except Exception as exc:
            child.last_exit = f"spawn failed: {exc}"
            logger.warning(
                "supervisor: spawn of %s failed: %s", child.spec.name, exc
            )
            self._on_down(child, now)
            return
        child.proc = proc
        child.pid = getattr(proc, "pid", None)
        child.instance = None
        child.health_fails = 0
        child.boot_deadline = now + child.spec.boot_timeout_s
        if child.spec.spawn is None and child.pid is not None:
            daemon._pid_file(child.spec.name).write_text(str(child.pid))
            daemon.write_service_record(
                child.spec.name, child.spec.argv,
                child.spec.host, child.spec.port,
            )
        self._set_state(child, STARTING)

    def _reap(self, child: _Child) -> None:
        proc = child.proc
        child.proc = None
        if proc is not None:
            try:
                proc.wait(timeout=0)
            except Exception:
                pass

    def _on_down(self, child: _Child, now: float) -> None:
        """A child died (or its spawn failed): schedule the restart, or
        declare it broken when it is flapping."""
        self._reap(child)
        child.instance = None
        child.crash_times.append(now)
        while child.crash_times and (
            now - child.crash_times[0] > self.flap_window_s
        ):
            child.crash_times.popleft()
        if len(child.crash_times) >= self.flap_max:
            self._set_state(child, BROKEN)
            child.next_retry_at = None
            logger.error(
                "supervisor: %s flapping (%d crashes in %.0fs) -> broken",
                child.spec.name, len(child.crash_times), self.flap_window_s,
            )
            try:
                obs_incident.record(
                    f"supervisor-flap-{child.spec.name}",
                    note=(
                        f"{child.spec.name} crashed "
                        f"{len(child.crash_times)} times within "
                        f"{self.flap_window_s:.0f}s; last exit: "
                        f"{child.last_exit}"
                    ),
                    context=self._service_doc(child),
                    force=True,
                )
            except Exception:
                logger.exception("supervisor: incident dump failed")
            return
        child.attempt += 1
        delay = backoff_interval(
            child.attempt,
            base_s=self.base_backoff_s,
            max_s=self.max_backoff_s,
            jitter=self.jitter,
            rng=child.rng,
        )
        child.last_backoff_s = delay
        child.next_retry_at = now + delay
        self._set_state(child, RESTARTING)
        logger.warning(
            "supervisor: %s down (%s); restart #%d in %.2fs",
            child.spec.name, child.last_exit, child.restarts + 1, delay,
        )

    # -- the state machine -------------------------------------------------

    def start_all(self, wait_healthy_s: float | None = None) -> None:
        """Bring the fleet up in order, waiting (bounded) for each child
        to turn healthy before the next — same sequencing as the
        detached ``pio start-all``. A child that fails to boot is left
        to the run loop's backoff/flap machinery."""
        with self._lock:
            for child in self._children:
                now = self._clock()
                self._launch(child, now)
                if child.state != STARTING:
                    continue
                deadline = self._clock() + (
                    wait_healthy_s
                    if wait_healthy_s is not None
                    else child.spec.boot_timeout_s
                )
                while self._clock() < deadline:
                    self.step()
                    if child.state != STARTING:
                        break
                    if self._stop_event.is_set():
                        return
                    self._sleep(min(0.1, self.poll_interval))
            self._write_state()

    def step(self, now: float | None = None) -> None:
        """One supervision pass over every child. Separated from
        :meth:`run` so tests drive the machine with a fake clock."""
        with self._lock:
            if now is None:
                now = self._clock()
            for child in self._children:
                self._step_child(child, now)
            # the retrain child is deliberately NOT a supervised service:
            # its exits are expected and must not feed the flap detector
            if self.retrain is not None:
                try:
                    self.retrain.tick(now)
                except Exception:
                    logger.exception("supervisor: retrain tick failed")
                if self.retrain.dirty:
                    self.retrain.dirty = False
                    self._dirty = True
            if self._dirty:
                self._write_state()

    def _step_child(self, child: _Child, now: float) -> None:
        if child.state in (BROKEN, STOPPED):
            return
        if child.state == RESTARTING:
            if child.next_retry_at is not None and now >= child.next_retry_at:
                child.restarts += 1
                self._m_restarts(child.spec.name).inc()
                child.next_retry_at = None
                self._launch(child, now)
            return
        # STARTING or UP: pid liveness first — poll() both detects and
        # reaps the exit, giving a real status for last_exit
        rc = child.proc.poll() if child.proc is not None else None
        if child.proc is not None and rc is not None:
            child.last_exit = _describe_exit(rc)
            self._on_down(child, now)
            return
        doc = self._probe(child)
        healthy = (
            doc is not None
            and (child.pid is None or doc.get("pid") == child.pid)
        )
        if healthy:
            child.health_fails = 0
            if child.state == STARTING:
                child.instance = doc.get("instance")
                child.stable_at = now + self.stable_s
                self._set_state(child, UP)
            elif child.attempt and now >= child.stable_at:
                # stayed healthy past the stability window: the backoff
                # schedule resets (next crash waits ~base again)
                child.attempt = 0
                self._dirty = True
            return
        if child.state == STARTING:
            if now >= child.boot_deadline:
                child.last_exit = (
                    f"boot timeout ({child.spec.boot_timeout_s:.0f}s "
                    "without a healthy probe)"
                )
                self._terminate_child(child)
                self._on_down(child, now)
            return
        # UP but probe failed: tolerate transient blips, restart a hung
        # child past the threshold
        child.health_fails += 1
        if child.health_fails >= self.health_fail_threshold:
            child.last_exit = (
                f"unhealthy ({child.health_fails} consecutive failed "
                "/healthz probes with the process alive)"
            )
            self._terminate_child(child)
            self._on_down(child, now)

    def _terminate_child(self, child: _Child, grace: float | None = None
                         ) -> None:
        proc = child.proc
        if proc is None:
            return
        if grace is None:
            grace = daemon.drain_grace()
        try:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=grace)
                except Exception:
                    proc.kill()
                    proc.wait()
        except Exception:
            pass

    def run(self) -> None:
        """Supervise until :meth:`request_stop` (or a signal handler the
        CLI wires to it) fires, then shut the fleet down."""
        try:
            while not self._stop_event.is_set():
                self.step()
                self._stop_event.wait(self.poll_interval)
        finally:
            self.stop()

    def request_stop(self) -> None:
        self._stop_event.set()

    def stop(self) -> None:
        """Graceful fleet shutdown in REVERSE bring-up order (engine
        before event server, so speed-layer/fold-in dependencies drain
        cleanly): SIGTERM (-> child drain), escalate after the drain
        grace."""
        self._stop_event.set()
        with self._lock:
            if self.retrain is not None:
                self.retrain.stop()
            for child in reversed(self._children):
                if child.state in (STOPPED,):
                    continue
                self._terminate_child(child)
                self._reap(child)
                if child.spec.spawn is None:
                    daemon._pid_file(child.spec.name).unlink(missing_ok=True)
                    daemon._record_file(child.spec.name).unlink(
                        missing_ok=True
                    )
                self._set_state(child, STOPPED)
            self._write_state()

    # -- reporting ---------------------------------------------------------

    def _service_doc(self, child: _Child) -> dict:
        now = self._clock()
        return {
            "state": child.state,
            "pid": child.pid if child.proc is not None else None,
            "port": child.spec.port or None,
            "instance": child.instance,
            "restarts": child.restarts,
            "last_exit": child.last_exit,
            "last_backoff_s": (
                round(child.last_backoff_s, 3)
                if child.last_backoff_s is not None
                else None
            ),
            "next_retry_in_s": (
                round(max(0.0, child.next_retry_at - now), 3)
                if child.next_retry_at is not None
                else None
            ),
        }

    def services(self) -> dict[str, dict]:
        with self._lock:
            return {
                child.spec.name: self._service_doc(child)
                for child in self._children
            }

    def state_doc(self) -> dict:
        doc = {
            "pid": os.getpid(),
            "updated": time.time(),
            "services": self.services(),
        }
        if self.retrain is not None:
            doc["retrain"] = self.retrain.doc()
        return doc

    def _write_state(self) -> None:
        """Atomic supervisor.json under the run dir — what ``pio
        status`` renders without talking to this process."""
        self._dirty = False
        try:
            import json

            path = state_file()
            tmp = path.with_suffix(".json.tmp")
            tmp.write_text(json.dumps(self.state_doc(), indent=2))
            tmp.replace(path)
        except OSError:
            logger.exception("supervisor: state write failed")


class RetrainScheduler:
    """Cadenced warm retrain driven by the supervisor loop.

    Each due tick spawns ``pio train`` (warm-start + prep-cache hot
    path) as a NON-supervised child — its exits are expected, so it
    must never feed the flap detector — then, on success, POSTs
    ``/reload`` to every engine replica (epoch-fenced: the engine swaps
    to the newest COMPLETED instance). Ticks are serialized: while a
    retrain is running nothing else is spawned, and a crashed retrain
    just counts a failure and waits for the next cadence tick (the
    prep cache + checkpoint make the retry cheap).

    With ``slo_driven`` the interval adapts to the ``serving.freshness``
    SLO: while it burns, the interval halves (down to ``floor_s``); once
    it is ok again the interval decays back toward the configured base.
    A tick is skipped (counted) when the speed-layer watermark
    (``events_folded + events_behind`` from the engine's ``/stats.json``)
    hasn't moved — no new events means retraining buys nothing.

    Clock, spawn, stats/SLO fetch, and reload are injectable for tests
    and for in-process drills (bench.py production_stack).
    """

    def __init__(
        self,
        interval_s: float,
        *,
        train_argv: list[str],
        engine_ports: tuple[int, ...] | list[int] = (),
        host: str = "127.0.0.1",
        slo_driven: bool = False,
        floor_s: float | None = None,
        slo_name: str = "serving.freshness",
        spawn: Callable[[], Any] | None = None,
        clock: Callable[[], float] = time.monotonic,
        fetch_stats: Callable[[], dict | None] | None = None,
        fetch_slo: Callable[[], dict | None] | None = None,
        post_reload: Callable[[], int] | None = None,
    ):
        self.base_interval_s = float(interval_s)
        self.interval_s = float(interval_s)
        self.floor_s = (
            float(floor_s) if floor_s is not None
            else max(1.0, self.base_interval_s / 8.0)
        )
        self.train_argv = list(train_argv)
        self.engine_ports = tuple(int(p) for p in engine_ports)
        self.host = host
        self.slo_driven = bool(slo_driven)
        self.slo_name = slo_name
        self._spawn = spawn
        self._clock = clock
        self._fetch_stats = fetch_stats
        self._fetch_slo = fetch_slo
        self._post_reload = post_reload
        self._proc: Any | None = None
        self._started_at = 0.0
        self._pending_watermark: float | None = None
        self._last_watermark: float | None = None
        self._next_slo_check = 0.0
        self.next_at = self._clock() + self.interval_s
        self.runs = 0
        self.skips = 0
        self.failures = 0
        self.last_run: dict | None = None
        self.dirty = True
        self._g_interval().set(self.interval_s)

    # -- metrics -----------------------------------------------------------

    @staticmethod
    def _m(kind: str):
        return obs_metrics.counter(
            f"pio_retrain_{kind}_total",
            {
                "runs": "Scheduled retrains that completed successfully",
                "skips": "Scheduled retrains skipped (watermark unmoved)",
                "failures": "Scheduled retrains that exited non-zero",
            }[kind],
        )

    @staticmethod
    def _g_interval():
        return obs_metrics.gauge(
            "pio_retrain_interval_s",
            "Current retrain cadence (adapts under --retrain-slo)",
        )

    # -- default I/O (real fleet) ------------------------------------------

    def _http_json(self, port: int, path: str, post: bool = False):
        import json as _json
        import urllib.request

        req = urllib.request.Request(
            f"http://{self.host}:{port}{path}",
            method="POST" if post else "GET",
            data=b"{}" if post else None,
            headers={"Content-Type": "application/json"} if post else {},
        )
        try:
            with urllib.request.urlopen(req, timeout=5.0) as resp:
                return _json.loads(resp.read().decode())
        except Exception:
            return None

    def _watermark(self) -> float | None:
        """Speed-layer progress marker; None -> unknown (never skip)."""
        doc = (
            self._fetch_stats() if self._fetch_stats is not None
            else (
                self._http_json(self.engine_ports[0], "/stats.json")
                if self.engine_ports else None
            )
        )
        if not isinstance(doc, dict):
            return None
        rt = doc.get("realtime")
        if not isinstance(rt, dict):
            return None
        if "events_folded" not in rt and "events_behind" not in rt:
            # batch-only serving (speed layer off) reports no counters:
            # a constant 0.0 here would skip every tick after the first
            # successful run — unknown progress must retrain on cadence
            return None
        try:
            return float(rt.get("events_folded", 0)) + float(
                rt.get("events_behind", 0)
            )
        except (TypeError, ValueError):
            return None

    def _slo_state(self) -> str | None:
        doc = (
            self._fetch_slo() if self._fetch_slo is not None
            else (
                self._http_json(self.engine_ports[0], "/slo.json")
                if self.engine_ports else None
            )
        )
        if not isinstance(doc, dict):
            return None
        for s in doc.get("slos", []):
            if s.get("name") == self.slo_name:
                return s.get("state")
        return None

    def _reload_all(self) -> int:
        if self._post_reload is not None:
            return int(self._post_reload())
        n = 0
        for port in self.engine_ports:
            if self._http_json(port, "/reload", post=True) is not None:
                n += 1
        return n

    # -- the cadence machine -----------------------------------------------

    def _set_interval(self, value: float) -> None:
        value = min(self.base_interval_s, max(self.floor_s, value))
        if value != self.interval_s:
            logger.info(
                "retrain: interval %.1fs -> %.1fs (slo %s)",
                self.interval_s, value, self.slo_name,
            )
            self.interval_s = value
            self._g_interval().set(value)
            self.dirty = True

    def _adapt(self, now: float) -> None:
        if now < self._next_slo_check:
            return
        self._next_slo_check = now + max(
            1.0, min(5.0, self.interval_s / 4.0)
        )
        state = self._slo_state()
        if state in ("burning", "violated"):
            self._set_interval(self.interval_s / 2.0)
            # pull the next run forward: a burn shouldn't wait out the
            # remainder of a long idle interval
            self.next_at = min(self.next_at, now + self.interval_s)
        elif state == "ok":
            self._set_interval(self.interval_s * 1.5)

    def tick(self, now: float | None = None) -> None:
        if now is None:
            now = self._clock()
        if self._proc is not None:
            rc = self._proc.poll()
            if rc is None:
                return  # serialized: one retrain at a time
            self._finish(rc, now)
            return
        if self.slo_driven:
            self._adapt(now)
        if now < self.next_at:
            return
        wm = self._watermark()
        if wm is not None and self._last_watermark is not None and (
            wm <= self._last_watermark
        ):
            self.skips += 1
            self._m("skips").inc()
            self.last_run = {
                "t": time.time(), "ok": True, "skipped": True,
                "watermark": wm,
            }
            self.next_at = now + self.interval_s
            self.dirty = True
            return
        self._pending_watermark = wm
        try:
            if self._spawn is not None:
                self._proc = self._spawn()
            else:
                self._proc = daemon.spawn_service("retrain", self.train_argv)
        except Exception as exc:
            self.failures += 1
            self._m("failures").inc()
            self.last_run = {
                "t": time.time(), "ok": False,
                "exit": f"spawn failed: {exc}",
            }
            self.next_at = now + self.interval_s
            self.dirty = True
            return
        self._started_at = now
        self.dirty = True

    def _finish(self, rc: int, now: float) -> None:
        self._proc = None
        ok = rc == 0
        reloaded = 0
        if ok:
            self.runs += 1
            self._m("runs").inc()
            self._last_watermark = self._pending_watermark
            reloaded = self._reload_all()
        else:
            self.failures += 1
            self._m("failures").inc()
        self.last_run = {
            "t": time.time(),
            "ok": ok,
            "exit": _describe_exit(rc),
            "wall_s": round(now - self._started_at, 3),
            "reloaded": reloaded,
        }
        self.next_at = now + self.interval_s
        self.dirty = True

    def doc(self) -> dict:
        now = self._clock()
        return {
            "state": "running" if self._proc is not None else "idle",
            "interval_s": round(self.interval_s, 3),
            "base_interval_s": round(self.base_interval_s, 3),
            "slo_driven": self.slo_driven,
            "next_in_s": (
                None if self._proc is not None
                else round(max(0.0, self.next_at - now), 3)
            ),
            "runs": self.runs,
            "skips": self.skips,
            "failures": self.failures,
            "last_run": self.last_run,
        }

    def stop(self) -> None:
        proc = self._proc
        self._proc = None
        if proc is not None and proc.poll() is None:
            try:
                proc.terminate()
                try:
                    proc.wait(timeout=daemon.drain_grace())
                except Exception:
                    proc.kill()
                    proc.wait()
            except Exception:
                pass


def state_file():
    return daemon.run_dir() / "supervisor.json"


def read_state() -> dict | None:
    """The last supervisor.json, or None. Reports ``live`` by checking
    the recorded supervisor pid."""
    path = state_file()
    if not path.exists():
        return None
    try:
        import json

        doc = json.loads(path.read_text())
    except (ValueError, OSError):
        return None
    if not isinstance(doc, dict):
        return None
    doc["live"] = bool(doc.get("pid")) and daemon._alive(int(doc["pid"]))
    return doc


def stats_app(supervisor: Supervisor, host: str, port: int):
    """Optional obs endpoint for the supervisor process itself:
    ``/stats.json`` (the state doc), plus the standard obs routes
    (``/metrics`` carries ``pio_supervisor_*``) and health routes."""
    from predictionio_tpu_torch.server import http

    router = http.Router()
    router.add(
        "GET", "/stats.json",
        lambda _req: http.Response.json(supervisor.state_doc()),
    )
    http.add_obs_routes(router)
    return http.HTTPApp(router, host=host, port=port, name="supervisor")
