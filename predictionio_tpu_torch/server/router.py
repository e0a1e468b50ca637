"""Scale-out serving router: one front tier over N engine replicas.

``pio route`` binds this server in front of a replica set of engine
servers (spawned by ``pio start-all --replicas N`` on consecutive
ports) and spreads ``/queries.json`` — bare, ``/<variant>/queries.json``
path-prefix, and ``X-PIO-Variant`` header forms — across them. The
pieces, in the order a request meets them:

- **Affinity**: the routing key is the canonical query byte string
  (``server/query_cache.canonical_query_bytes`` — the same bytes that
  key the replica-side query cache), salted with the variant name, on a
  consistent-hash ring with virtual nodes. A given query always prefers
  the same replica, so each replica's query cache stays hot instead of
  every replica holding a cold copy of everything.
- **Spill**: when the preferred replica is ejected or saturated
  (inflight >= ``PIO_ROUTER_SATURATION``), the router spills to
  power-of-two-choices least-inflight among the available replicas —
  bounded herding without a global scan.
- **Health**: a probe thread polls each replica's ``/readyz`` every
  ``PIO_ROUTER_PROBE_INTERVAL_S``. The per-boot instance id in the
  probe doc makes membership explicit: a restarted replica (new
  instance) is admitted as a NEW member with fresh stats, immediately —
  it is not the flaky old one still serving its ejection backoff.
  Passively, any connect error / injected fault / 5xx ejects the
  replica breaker-style with seeded exponential backoff
  (``common/breaker.backoff_interval``); re-admission requires both the
  backoff to expire AND a ready probe.
- **Retry**: a failed attempt is retried on a different replica (up to
  ``PIO_ROUTER_RETRIES`` extra attempts), counted in
  ``pio_router_retries_total``. Replica 4xx responses (invalid query,
  unknown variant) are NOT failures — they pass through byte-identical,
  so multi-tenant clients cannot tell the router from a replica.
- **Hedging**: queries are read-only, so after an adaptive delay (the
  observed latency quantile ``PIO_ROUTER_HEDGE_QUANTILE``, clamped to
  [``PIO_ROUTER_HEDGE_MIN_MS``, ``PIO_ROUTER_HEDGE_MAX_MS``]) the
  router fires ONE duplicate attempt at a different replica and the
  first response wins — the Tail-at-Scale move that turns a straggling
  replica's p99 into roughly the healthy p95 + a healthy-replica
  round trip. ``PIO_ROUTER_HEDGE=0`` disables.

Observability: ``pio_router_{requests,retries,hedges,hedge_wins,
ejections}_total``, per-replica inflight/p99/ready gauges, a hedge
win-ratio gauge, availability + p99 SLOs
(``obs/slo.install_router_slos``), and a ``/stats.json`` replicas
block that ``pio status``/``pio top`` render as per-replica sub-rows.

Port of ``predictionio_tpu/server/router.py``: the same ring, knobs
(``PIO_ROUTER_*``), metrics and ``/stats.json``, so a router of either
package fronts replicas of either. It is host code only and imports no
``torch``: the replicas behind it each hold their own CUDA context.
"""

from __future__ import annotations

import bisect
import collections
import hashlib
import json
import logging
import os
import random
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from http.client import HTTPConnection

from predictionio_tpu_torch import faults
from predictionio_tpu_torch.common.breaker import backoff_interval
from predictionio_tpu_torch.obs import metrics as obs_metrics
from predictionio_tpu_torch.obs import slo as obs_slo
from predictionio_tpu_torch.server.http import (
    HTTPApp,
    Request,
    Response,
    Router,
    add_obs_routes,
)
from predictionio_tpu_torch.server.query_cache import canonical_query_bytes

logger = logging.getLogger(__name__)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


# replica states
UNPROBED = "unprobed"  # boot: never answered a probe yet
READY = "ready"
EJECTED = "ejected"

_VNODES = 64  # virtual nodes per replica on the hash ring
_LATENCY_WINDOW = 512  # per-replica success-latency samples kept


def _hash64(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")


class _AttemptError(Exception):
    """One forwarding attempt failed. Carries the replica 5xx response
    (if there was one) so an all-replicas-down request can still pass
    the last real answer — e.g. a 503 warming fence with its
    Retry-After — through to the client."""

    def __init__(self, reason: str, status: int = 0, body: bytes = b"",
                 headers: dict[str, str] | None = None):
        super().__init__(reason)
        self.status = status
        self.body = body
        self.headers = headers or {}


class Replica:
    """One engine-server backend: address, probed identity, breaker
    state, and a small keep-alive connection pool."""

    def __init__(self, name: str, host: str, port: int, *, seed: int = 0,
                 timeout_s: float = 30.0):
        self.name = name
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self.instance: str | None = None
        self.state = UNPROBED
        self.inflight = 0
        self.requests = 0
        self.failures = 0
        self.ejections = 0
        self.eject_attempt = 0
        self.retry_at = 0.0  # monotonic; re-admission gate while ejected
        self.latencies: collections.deque[float] = collections.deque(
            maxlen=_LATENCY_WINDOW
        )
        # per-replica RNG: deterministic backoff jitter under a fixed
        # pool seed, decorrelated across replicas
        self.rng = random.Random(seed ^ _hash64(name.encode()))
        self._conns: list[HTTPConnection] = []
        self._conns_lock = threading.Lock()
        self._g_inflight = obs_metrics.gauge(
            "pio_router_replica_inflight",
            "Requests in flight at this replica via the router",
            replica=name,
        )
        self._g_p99 = obs_metrics.gauge(
            "pio_router_replica_p99_ms",
            "Observed p99 forward latency to this replica (ms)",
            replica=name,
        )
        self._g_ready = obs_metrics.gauge(
            "pio_router_replica_ready",
            "1 when the replica is admitted, 0 when ejected/unprobed",
            replica=name,
        )
        self._g_ready.set(0.0)

    # -- connection pool ---------------------------------------------------

    def acquire(self) -> HTTPConnection:
        with self._conns_lock:
            if self._conns:
                return self._conns.pop()
        return HTTPConnection(self.host, self.port, timeout=self.timeout_s)

    def release(self, conn: HTTPConnection) -> None:
        with self._conns_lock:
            if len(self._conns) < 64:
                self._conns.append(conn)
                return
        conn.close()

    def close_conns(self) -> None:
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except Exception:
                pass

    # -- stats -------------------------------------------------------------

    def p99_ms(self) -> float:
        if not self.latencies:
            return 0.0
        xs = sorted(self.latencies)
        return xs[min(len(xs) - 1, int(0.99 * len(xs)))] * 1e3

    def stats(self) -> dict:
        return {
            "host": self.host,
            "port": self.port,
            "instance": self.instance,
            "state": self.state,
            "inflight": self.inflight,
            "requests": self.requests,
            "failures": self.failures,
            "ejections": self.ejections,
            "p99Ms": round(self.p99_ms(), 3),
        }


class ReplicaPool:
    """The membership + balancing core: consistent-hash ring with
    pow2-choices spill, passive breaker ejection, active instance-aware
    re-admission. All state transitions run under one lock — the
    per-request work inside it is a ring lookup and counter bumps."""

    def __init__(self, replicas: list[Replica], *, seed: int = 0,
                 saturation: int | None = None,
                 eject_base_s: float | None = None,
                 eject_max_s: float | None = None,
                 clock=time.monotonic):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.replicas = list(replicas)
        self.by_name = {r.name: r for r in self.replicas}
        if len(self.by_name) != len(self.replicas):
            raise ValueError("duplicate replica names")
        self.saturation = (
            saturation if saturation is not None
            else _env_int("PIO_ROUTER_SATURATION", 32)
        )
        self.eject_base_s = (
            eject_base_s if eject_base_s is not None
            else _env_float("PIO_ROUTER_EJECT_BACKOFF_S", 0.5)
        )
        self.eject_max_s = (
            eject_max_s if eject_max_s is not None
            else _env_float("PIO_ROUTER_EJECT_MAX_S", 30.0)
        )
        self.clock = clock
        self.lock = threading.Lock()
        self.rng = random.Random(seed)
        self._m_ejections = {
            r.name: obs_metrics.counter(
                "pio_router_ejections_total",
                "Replica ejections (passive failure or failed probe)",
                replica=r.name,
            )
            for r in self.replicas
        }
        # the ring is keyed on replica NAME (stable across restarts):
        # a respawned replica takes back the same hash ranges, so the
        # keys it re-warms are the keys it will keep serving
        points: list[tuple[int, str]] = []
        for r in self.replicas:
            for v in range(_VNODES):
                points.append((_hash64(f"{r.name}#{v}".encode()), r.name))
        points.sort()
        self._ring_points = [p for p, _ in points]
        self._ring_names = [n for _, n in points]

    # -- selection ---------------------------------------------------------

    def _ring_order(self, key: bytes):
        """Distinct replicas in ring order starting at the key's point."""
        start = bisect.bisect_left(self._ring_points, _hash64(key))
        seen: set[str] = set()
        n = len(self._ring_names)
        for i in range(n):
            name = self._ring_names[(start + i) % n]
            if name not in seen:
                seen.add(name)
                yield self.by_name[name]

    def pick(self, key: bytes, exclude: frozenset | set = frozenset()
             ) -> Replica | None:
        """The routing decision: hash-preferred replica when it is
        admitted and unsaturated, else pow2-choices least-inflight among
        the admitted replicas. None when nothing is admitted."""
        with self.lock:
            avail = [
                r for r in self.replicas
                if r.state == READY and r.name not in exclude
            ]
            if not avail:
                return None
            avail_names = {r.name for r in avail}
            for r in self._ring_order(key):
                if r.name in avail_names:
                    if r.inflight < self.saturation:
                        return r
                    break  # preferred is saturated: spill
            if len(avail) == 1:
                return avail[0]
            a, b = self.rng.sample(avail, 2)
            return a if a.inflight <= b.inflight else b

    def pick_other(self, exclude: frozenset | set) -> Replica | None:
        """Least-inflight admitted replica outside ``exclude`` — the
        hedge/retry target (affinity is pointless on a duplicate)."""
        with self.lock:
            avail = [
                r for r in self.replicas
                if r.state == READY and r.name not in exclude
            ]
            if not avail:
                return None
            if len(avail) == 1:
                return avail[0]
            a, b = self.rng.sample(avail, 2)
            return a if a.inflight <= b.inflight else b

    def available_count(self, exclude: frozenset | set = frozenset()) -> int:
        with self.lock:
            return sum(
                1 for r in self.replicas
                if r.state == READY and r.name not in exclude
            )

    # -- accounting --------------------------------------------------------

    def begin(self, replica: Replica) -> None:
        with self.lock:
            replica.inflight += 1
            replica.requests += 1
            replica._g_inflight.set(float(replica.inflight))

    def record_success(self, replica: Replica, elapsed_s: float) -> None:
        with self.lock:
            replica.inflight -= 1
            replica._g_inflight.set(float(replica.inflight))
            replica.latencies.append(elapsed_s)
            replica._g_p99.set(replica.p99_ms())
            # real traffic succeeding resets the breaker escalation
            replica.eject_attempt = 0

    def record_failure(self, replica: Replica, reason: str) -> None:
        with self.lock:
            replica.inflight -= 1
            replica._g_inflight.set(float(replica.inflight))
            self._eject_locked(replica, reason)

    def _eject_locked(self, replica: Replica, reason: str) -> None:
        replica.failures += 1
        if replica.state == EJECTED:
            return  # already serving its backoff; don't escalate per-probe
        replica.state = EJECTED
        replica.ejections += 1
        replica.eject_attempt += 1
        backoff = backoff_interval(
            replica.eject_attempt,
            base_s=self.eject_base_s,
            max_s=self.eject_max_s,
            jitter=0.2,
            rng=replica.rng,
        )
        replica.retry_at = self.clock() + backoff
        replica._g_ready.set(0.0)
        self._m_ejections[replica.name].inc()
        replica.close_conns()
        logger.warning(
            "router ejected replica %s (%s); re-admission in >= %.2fs",
            replica.name, reason, backoff,
        )

    # -- active probing ----------------------------------------------------

    def probe_one(self, replica: Replica, probe=None) -> None:
        """One ``/readyz`` round for one replica. Ready probes admit;
        anything else ejects. An instance change on a ready probe is a
        NEW member — admitted immediately with fresh stats, bypassing
        the dead predecessor's backoff."""
        from predictionio_tpu_torch.cli import daemon as _daemon

        probe = probe or _daemon.probe_ready
        doc = None
        try:
            faults.fault_point("router.probe")
            doc = probe(replica.host, replica.port, timeout=2.0)
        except Exception:
            doc = None
        with self.lock:
            now = self.clock()
            if doc is not None and doc.get("ready"):
                instance = doc.get("instance")
                if instance != replica.instance:
                    # restarted replica: new member, fresh breaker + stats
                    replica.instance = instance
                    replica.latencies.clear()
                    replica.eject_attempt = 0
                    replica.retry_at = 0.0
                elif replica.state == EJECTED and now < replica.retry_at:
                    return  # same instance, still serving its backoff
                if replica.state != READY:
                    logger.info(
                        "router admitted replica %s (instance %s)",
                        replica.name, instance,
                    )
                replica.state = READY
                replica._g_ready.set(1.0)
            else:
                self._eject_locked(replica, "probe failed")

    def probe_all(self, probe=None) -> None:
        for r in self.replicas:
            self.probe_one(r, probe=probe)

    def stats(self) -> dict:
        with self.lock:
            return {r.name: r.stats() for r in self.replicas}


def parse_replica_spec(spec: str, index: int) -> tuple[str, str, int]:
    """``[name=]host:port`` -> (name, host, port); default name
    ``engine-<index>`` matches what ``pio start-all --replicas`` spawns."""
    name = f"engine-{index}"
    if "=" in spec:
        name, spec = spec.split("=", 1)
    host, _, port_s = spec.rpartition(":")
    if not host or not port_s.isdigit():
        raise ValueError(f"replica spec {spec!r} is not [name=]host:port")
    return name, host, int(port_s)


class RouterServer:
    """The ``pio route`` daemon: a ReplicaPool behind an event-loop
    HTTPApp, with a probe thread and a hedging forwarder."""

    # headers copied from the winning replica response to the client
    # (everything the engine uses to steer client behavior)
    _PASS_HEADERS = ("retry-after",)

    def __init__(
        self,
        replicas: list[tuple[str, str, int]],
        host: str = "0.0.0.0",
        port: int = 8100,
        *,
        reuse_port: bool = False,
        probe_interval_s: float | None = None,
        hedge: bool | None = None,
        seed: int = 0,
        probe=None,
    ):
        timeout_s = _env_float("PIO_ROUTER_FORWARD_TIMEOUT_S", 30.0)
        self.pool = ReplicaPool([
            Replica(name, rhost, rport, seed=seed, timeout_s=timeout_s)
            for name, rhost, rport in replicas
        ])
        self.probe_interval_s = (
            probe_interval_s if probe_interval_s is not None
            else _env_float("PIO_ROUTER_PROBE_INTERVAL_S", 1.0)
        )
        self.hedge_enabled = (
            hedge if hedge is not None
            else os.environ.get("PIO_ROUTER_HEDGE", "1") != "0"
        )
        self.hedge_quantile = _env_float("PIO_ROUTER_HEDGE_QUANTILE", 0.95)
        self.hedge_min_s = _env_float("PIO_ROUTER_HEDGE_MIN_MS", 5.0) / 1e3
        self.hedge_max_s = _env_float("PIO_ROUTER_HEDGE_MAX_MS", 1000.0) / 1e3
        self.max_retries = _env_int("PIO_ROUTER_RETRIES", 2)
        self._probe = probe
        self._probe_stop = threading.Event()
        self._probe_thread: threading.Thread | None = None
        # attempts (primary + hedge + retry) run here, so a handler
        # thread blocked in futures_wait never starves the attempts it
        # is waiting on
        handler_threads = _env_int("PIO_HTTP_HANDLER_THREADS", 16)
        self._executor = ThreadPoolExecutor(
            max_workers=max(4, handler_threads * 2),
            thread_name_prefix="router-fwd",
        )
        # router-level latency window: the adaptive hedge delay source
        self._latencies: collections.deque[float] = collections.deque(
            maxlen=2048
        )
        self._lat_lock = threading.Lock()

        self._m_requests = obs_metrics.counter(
            "pio_router_requests_total", "Queries routed (all variants)"
        )
        self._m_retries = obs_metrics.counter(
            "pio_router_retries_total",
            "Attempts re-sent to another replica after a failure",
        )
        self._m_hedges = obs_metrics.counter(
            "pio_router_hedges_total",
            "Duplicate attempts fired after the adaptive hedge delay",
        )
        self._m_hedge_wins = obs_metrics.counter(
            "pio_router_hedge_wins_total",
            "Hedged attempts that answered before the primary",
        )
        self._g_hedge_ratio = obs_metrics.gauge(
            "pio_router_hedge_win_ratio",
            "hedge wins / hedges fired (0 when no hedges yet)",
        )
        self._g_hedge_ratio.set_function(self._hedge_win_ratio)

        router = Router()
        router.add("POST", "/queries.json", self._route_bare)
        router.add("GET", "/stats.json", self._stats_route)
        add_obs_routes(router)
        # registered LAST so /stats.json and the obs routes win first
        router.add("POST", "/<variant>/queries.json", self._route_variant)
        self.app = HTTPApp(
            router,
            host=host,
            port=port,
            reuse_port=reuse_port,
            name="router",
            handler_threads=handler_threads,
            ready_check=self._ready_reason,
        )
        self.start_time = time.time()
        self._slos = obs_slo.install_router_slos(self)

    # -- lifecycle ---------------------------------------------------------

    def start(self, background: bool = True) -> int:
        """Probe once synchronously (so /readyz is meaningful the moment
        the port answers), start the probe thread, then serve."""
        self.pool.probe_all(probe=self._probe)
        self._probe_thread = threading.Thread(
            target=self._probe_loop, daemon=True, name="router-probe"
        )
        self._probe_thread.start()
        self.app.add_shutdown_hook(self._shutdown)
        return self.app.start(background=background)

    def stop(self) -> None:
        self.app.stop()
        self._shutdown()

    def _shutdown(self) -> None:
        self._probe_stop.set()
        self._executor.shutdown(wait=False)
        for r in self.pool.replicas:
            r.close_conns()

    def _probe_loop(self) -> None:
        while not self._probe_stop.wait(self.probe_interval_s):
            try:
                self.pool.probe_all(probe=self._probe)
            except Exception:  # pragma: no cover - probe must never die
                logger.exception("router probe round failed")

    def _ready_reason(self) -> str | None:
        n = self.pool.available_count()
        if n > 0:
            return None
        total = len(self.pool.replicas)
        return f"no ready replicas (0/{total} admitted)"

    # -- hedging -----------------------------------------------------------

    def _hedge_win_ratio(self) -> float:
        hedges = self._m_hedges.value()
        return (self._m_hedge_wins.value() / hedges) if hedges else 0.0

    def _observe_latency(self, elapsed_s: float) -> None:
        with self._lat_lock:
            self._latencies.append(elapsed_s)

    def hedge_delay_s(self) -> float:
        """Adaptive delay: the observed forward-latency quantile,
        clamped. Until enough samples exist, the max — hedging blind
        would double load exactly when every replica is cold."""
        with self._lat_lock:
            if len(self._latencies) < 16:
                return self.hedge_max_s
            xs = sorted(self._latencies)
        q = xs[min(len(xs) - 1, int(self.hedge_quantile * len(xs)))]
        return min(self.hedge_max_s, max(self.hedge_min_s, q))

    # -- forwarding --------------------------------------------------------

    def _attempt(self, replica: Replica, path: str, body: bytes,
                 headers: dict[str, str]) -> tuple[int, bytes, dict]:
        """One forward to one replica. 2xx-4xx pass through (the replica
        answered; a 400/404 is the CLIENT's problem). Connect errors,
        injected faults, and 5xx are attempt failures: the replica is
        ejected and _AttemptError carries any 5xx body for last-resort
        pass-through."""
        self.pool.begin(replica)
        start = time.perf_counter()
        conn = None
        try:
            faults.fault_point("router.forward")
            conn = replica.acquire()
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            status = resp.status
            rhdrs = {
                k: resp.getheader(k)
                for k in self._PASS_HEADERS
                if resp.getheader(k) is not None
            }
        except Exception as exc:
            if conn is not None:
                conn.close()
            self.pool.record_failure(replica, f"{type(exc).__name__}: {exc}")
            raise _AttemptError(f"{replica.name}: {exc}") from exc
        if status >= 500:
            conn.close()
            self.pool.record_failure(replica, f"HTTP {status}")
            raise _AttemptError(
                f"{replica.name}: HTTP {status}", status=status,
                body=data, headers=rhdrs,
            )
        elapsed = time.perf_counter() - start
        replica.release(conn)
        self.pool.record_success(replica, elapsed)
        self._observe_latency(elapsed)
        return status, data, rhdrs

    def forward(self, key: bytes, path: str, body: bytes,
                headers: dict[str, str]) -> Response:
        """Route one query: primary by affinity, hedge after the
        adaptive delay, retry failures on other replicas, first good
        response wins."""
        self._m_requests.inc()
        primary = self.pool.pick(key)
        if primary is None:
            return Response.error("no ready replicas", 503)
        futures = {
            self._executor.submit(self._attempt, primary, path, body,
                                  headers): (primary, False)
        }
        tried = {primary.name}
        hedged = False
        retries_left = self.max_retries
        last_err: _AttemptError | None = None
        while futures:
            timeout = None
            if (
                self.hedge_enabled
                and not hedged
                and self.pool.available_count(exclude=tried) > 0
            ):
                timeout = self.hedge_delay_s()
            done, _pending = futures_wait(
                set(futures), timeout=timeout, return_when=FIRST_COMPLETED
            )
            if not done:
                # hedge timer expired with the primary still in flight
                hedged = True
                rep = self.pool.pick_other(tried)
                if rep is not None:
                    tried.add(rep.name)
                    self._m_hedges.inc()
                    futures[self._executor.submit(
                        self._attempt, rep, path, body, headers
                    )] = (rep, True)
                continue
            for fut in done:
                _rep, is_hedge = futures.pop(fut)
                try:
                    status, data, rhdrs = fut.result()
                except _AttemptError as exc:
                    if exc.status:  # keep the most recent real 5xx
                        last_err = exc
                    elif last_err is None or not last_err.status:
                        last_err = exc
                    if not futures and retries_left > 0:
                        rep = self.pool.pick_other(tried)
                        if rep is not None:
                            retries_left -= 1
                            tried.add(rep.name)
                            self._m_retries.inc()
                            futures[self._executor.submit(
                                self._attempt, rep, path, body, headers
                            )] = (rep, False)
                    continue
                if is_hedge:
                    self._m_hedge_wins.inc()
                # an abandoned sibling attempt finishes in the executor
                # and records its own replica stats; its bytes are
                # dropped — queries are read-only, so that is safe
                return Response(status=status, body=data, headers=rhdrs)
        if last_err is not None and last_err.status:
            return Response(
                status=last_err.status, body=last_err.body,
                headers=last_err.headers,
            )
        return Response.error(
            f"all replicas failed: {last_err}", 502,
        )

    # -- routes ------------------------------------------------------------

    def _affinity_key(self, variant: str, body_bytes: bytes) -> bytes:
        """Variant-salted canonical query bytes — the same
        canonicalization that keys the replica-side query cache, so
        affinity and cache locality agree. Unparseable bodies hash raw
        (the replica will 400 them; they still route consistently)."""
        try:
            body = json.loads(body_bytes)
            canon = (
                canonical_query_bytes(body)
                if isinstance(body, dict) else body_bytes
            )
        except ValueError:
            canon = body_bytes
        return variant.encode() + b"\x00" + canon

    def _route_bare(self, request: Request) -> Response:
        variant = request.headers.get("x-pio-variant", "")
        headers = {"Content-Type": "application/json"}
        if variant:
            headers["X-PIO-Variant"] = variant
        return self.forward(
            self._affinity_key(variant, request.body),
            "/queries.json", request.body, headers,
        )

    def _route_variant(self, request: Request) -> Response:
        variant = request.path_params["variant"]
        return self.forward(
            self._affinity_key(variant, request.body),
            f"/{variant}/queries.json", request.body,
            {"Content-Type": "application/json"},
        )

    def _stats_route(self, _req: Request) -> Response:
        return Response.json(self.stats())

    def stats(self) -> dict:
        hedges = self._m_hedges.value()
        return {
            "server": "router",
            "instance": self.app.instance_id,
            "uptime_s": round(time.time() - self.start_time, 3),
            "replicas": self.pool.stats(),
            "routing": {
                "requests": self._m_requests.value(),
                "retries": self._m_retries.value(),
                "hedge_enabled": self.hedge_enabled,
                "hedge_delay_ms": round(self.hedge_delay_s() * 1e3, 3),
                "hedges": hedges,
                "hedge_wins": self._m_hedge_wins.value(),
                "hedge_win_ratio": round(self._hedge_win_ratio(), 4),
            },
            "obs": obs_metrics.stats_block(),
        }
