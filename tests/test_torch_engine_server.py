"""The port's engine server (``predictionio_tpu_torch/server/engine_server.py``
on the port's ``HTTPApp``), on the CPU, serving instances the JAX package
trained.

The port's copies of ``tests/test_servers.py``'s ``TestEngineServer``,
``TestMicroBatchedServing``, ``TestFeedbackLoop``, ``TestReloadUnderLoad``,
``TestQueryCacheUnit``, ``TestQueryCacheServing`` and
``TestGracefulDegradation``, and of the cases of
``tests/test_serving_batch.py`` and ``tests/test_multitenant.py``. The JAX
package's ``run_train`` writes every instance (the originals' events,
ranks and iterations) into sqlite + localfs storage under a temporary
``PIO_FS_BASEDIR``; the port opens the same storage and serves with
``device="cpu"``, where K2's plain version scores.

Two bars hold throughout: the port's batched answers are byte-identical
to its solo ones, and the port's answers equal the JAX ``EngineServer``'s
on the same instance (same item lists, scores within rtol 1e-5: the two
packages sum the dot products in different orders), with the batcher on
and off. Where an original pads batches to a power of two or times a jit
dispatch, the copy holds the port's own rule instead: no padding, and a
dispatch probe that times a device round trip.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.cli import commands
from predictionio_tpu.core import EngineParams
from predictionio_tpu.core.workflow import run_train
from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.data.event import Event
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.models import similarproduct as jsim
from predictionio_tpu.server.engine_server import EngineServer as JaxEngineServer
from predictionio_tpu_torch import faults
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.models import recommendation as trec
from predictionio_tpu_torch.models import similarproduct as tsim
from predictionio_tpu_torch.obs import metrics as obs_metrics
from predictionio_tpu_torch.obs import slo as obs_slo
from predictionio_tpu_torch.server.engine_server import EngineServer, _MicroBatcher
from predictionio_tpu_torch.server.http import HTTPApp, Response, Router

DTYPES = ["float32", "bfloat16", "int8"]


# -- helpers -------------------------------------------------------------------


def http(method, url, body=None, headers=None):
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        payload = e.read()
        try:
            return e.code, json.loads(payload or b"{}")
        except json.JSONDecodeError:
            return e.code, {"raw": payload.decode()}


def http_full(method, url, body=None, headers=None):
    """Like http() but also returns response headers (Retry-After)."""
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read() or b"{}"), dict(resp.headers)
    except urllib.error.HTTPError as e:
        payload = e.read()
        try:
            parsed = json.loads(payload or b"{}")
        except json.JSONDecodeError:
            parsed = {"raw": payload.decode()}
        return e.code, parsed, dict(e.headers)


def _post_raw(url: str, body, headers=None) -> tuple[int, bytes]:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST"
    )
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=15) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _concurrent_post(port, queries) -> dict[str, tuple[int, bytes]]:
    results: dict[str, tuple[int, bytes]] = {}
    barrier = threading.Barrier(len(queries))

    def one(q):
        barrier.wait(timeout=10)
        results[json.dumps(q)] = _post_raw(
            f"http://127.0.0.1:{port}/queries.json", q
        )

    threads = [threading.Thread(target=one, args=(q,)) for q in queries]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return results


def _same_answer(got: dict, want: dict) -> None:
    """The port's answer against the JAX server's: same items, scores
    within rtol 1e-5."""
    got, want = got["itemScores"], want["itemScores"]
    assert [x["item"] for x in got] == [x["item"] for x in want]
    np.testing.assert_allclose(
        [x["score"] for x in got], [x["score"] for x in want],
        rtol=1e-5, atol=1e-6,
    )


class _Store:
    """A sqlite + localfs store under one basedir, written by the JAX
    package and read by the port."""

    def __init__(self, basedir):
        self.env = {"PIO_FS_BASEDIR": str(basedir)}
        self.jax = jstorage.Storage(env=self.env)

    def port_storage(self) -> tstorage.Storage:
        return tstorage.Storage(env=self.env)

    def rate_app(self, name: str, seed: int = 0, users: int = 12,
                 per_user: int = 6, items: int = 8) -> dict:
        info = commands.app_new(name, storage=self.jax)
        rng = np.random.default_rng(seed)
        batch = [
            Event(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item",
                target_entity_id=f"i{int(rng.integers(0, items))}",
                properties={"rating": float(rng.integers(1, 6))},
            )
            for u in range(users) for _ in range(per_user)
        ]
        self.jax.get_events().batch_insert(batch, info["id"])
        return info

    def train(self, engine, ep, engine_id: str) -> str:
        """The JAX package's run_train; the datasource reads the
        storage singleton."""
        jstorage.set_storage(self.jax)
        try:
            return run_train(engine, ep, engine_id=engine_id, storage=self.jax)
        finally:
            jstorage.set_storage(None)

    def close(self) -> None:
        self.jax.close()


def _rec_params(app_name: str, storage_dtype: str = "float32",
                rank: int = 4, iters: int = 3) -> EngineParams:
    return EngineParams(
        datasource=("", jrec.DataSourceParams(app_name=app_name)),
        algorithms=[("als", jrec.ALSAlgorithmParams(
            rank=rank, num_iterations=iters, storage_dtype=storage_dtype,
        ))],
    )


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    s = _Store(tmp_path_factory.mktemp("engine_server"))
    s.rate_app("ServeApp")
    yield s
    s.close()


@pytest.fixture(scope="module")
def serve_iid(store):
    return store.train(jrec.engine(), _rec_params("ServeApp"), "serve")


@pytest.fixture()
def deployed_engine(store, serve_iid):
    """The port's server on the JAX-trained 'serve' instance."""
    ts = store.port_storage()
    engine = trec.engine()
    instance = ts.get_metadata_engine_instances().get(serve_iid)
    server = EngineServer(
        engine, instance, storage=ts, host="127.0.0.1", port=0,
        server_key="secret", device="cpu",
    )
    port = server.start()
    yield {
        "base": f"http://127.0.0.1:{port}",
        "server": server,
        "storage": ts,
        "engine": engine,
        "retrain": lambda dtype="float32": store.train(
            jrec.engine(), _rec_params("ServeApp", dtype), "serve"
        ),
    }
    server.stop()
    ts.close()


def _server(d, **kw) -> EngineServer:
    """Another port server over the deployed instance."""
    return EngineServer(
        d["engine"], d["server"].instance, storage=d["storage"],
        host="127.0.0.1", port=0, device="cpu", **kw,
    )


# -- TestEngineServer ----------------------------------------------------------


class TestEngineServer:
    def test_status_page(self, deployed_engine):
        status, body = http("GET", deployed_engine["base"] + "/")
        assert status == 200
        assert body["status"] == "alive"
        assert body["requestCount"] == 0
        assert body["device"] == "cpu"

    def test_query(self, deployed_engine):
        base = deployed_engine["base"]
        status, body = http("POST", f"{base}/queries.json", {"user": "u1", "num": 3})
        assert status == 200
        assert len(body["itemScores"]) == 3
        status, page = http("GET", base + "/")
        assert page["requestCount"] == 1
        assert page["lastServingSec"] > 0

    def test_query_unknown_user(self, deployed_engine):
        status, body = http(
            "POST", deployed_engine["base"] + "/queries.json", {"user": "zz"}
        )
        assert status == 200 and body["itemScores"] == []

    def test_bad_query(self, deployed_engine):
        status, body = http(
            "POST", deployed_engine["base"] + "/queries.json", [1, 2]
        )
        assert status == 400

    def test_reload_hot_swaps_latest(self, deployed_engine):
        base = deployed_engine["base"]
        old_id = deployed_engine["server"].instance.id
        # unauthorized without key
        status, _ = http("POST", f"{base}/reload")
        assert status == 401
        # train a new instance, then reload with key
        deployed_engine["retrain"]()
        status, _ = http("POST", f"{base}/reload?accessKey=secret")
        assert status == 200
        assert deployed_engine["server"].instance.id != old_id

    def test_reload_onto_int8_instance_serves(self, deployed_engine):
        """An int8-trained instance round-trips through persistence and
        /reload: the hot-swapped model carries quantized factors + scales
        and answers queries."""
        base = deployed_engine["base"]
        old_id = deployed_engine["server"].instance.id
        deployed_engine["retrain"]("int8")
        status, _ = http("POST", f"{base}/reload?accessKey=secret")
        assert status == 200
        server = deployed_engine["server"]
        assert server.instance.id != old_id
        [model] = server.models
        assert model.user_factors.dtype == np.int8
        assert model.user_scales is not None
        status, body = http("POST", f"{base}/queries.json", {"user": "u1", "num": 3})
        assert status == 200
        assert len(body["itemScores"]) == 3

    def test_plugins_endpoint(self, deployed_engine):
        status, body = http("GET", deployed_engine["base"] + "/plugins.json")
        assert status == 200 and "plugins" in body

    def test_status_page_html_for_browsers(self, deployed_engine):
        """Accept: text/html gets the reference's HTML status render
        (CreateServer.scala:443-467); API clients keep JSON."""
        req = urllib.request.Request(
            deployed_engine["base"] + "/",
            headers={"Accept": "text/html,application/xhtml+xml"},
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith("text/html")
            page = resp.read().decode()
        assert "Engine:" in page and "Algorithms" in page
        assert "ALSAlgorithm" in page or "als" in page

    def test_serving_error_posts_remote_log(self, deployed_engine):
        """A failing query POSTs logPrefix + {engineInstance, message} to
        log_url (CreateServer.scala:422-433, :596-618)."""
        received: list[bytes] = []
        got_one = threading.Event()
        catcher_router = Router()

        @catcher_router.route("POST", "/log")
        def catch(request):
            received.append(request.body)
            got_one.set()
            return Response.json({})

        catcher = HTTPApp(catcher_router, host="127.0.0.1", port=0)
        log_port = catcher.start()
        server = deployed_engine["server"]
        server.log_url = f"http://127.0.0.1:{log_port}/log"
        server.log_prefix = "PIO: "
        try:
            status, _ = http(
                "POST",
                deployed_engine["base"] + "/queries.json",
                {"user": "u1", "num": "not-a-number"},
            )
            assert status in (400, 500)
            assert got_one.wait(timeout=10), "remote log never arrived"
            body = received[0].decode()
            assert body.startswith("PIO: ")
            payload = json.loads(body[len("PIO: "):])
            assert payload["engineInstance"]["id"] == server.instance.id
            assert "Query" in payload["message"]
        finally:
            server.log_url = None
            catcher.stop()


# -- the port against the JAX server -------------------------------------------


PARITY_QUERIES = [
    {"user": "u0", "num": 1},
    {"user": "u1", "num": 3},
    {"user": "u2", "num": 5},
    {"user": "u3", "num": 3},
    {"user": "zz", "num": 3},
    {"user": "u4", "num": 2},
    {"user": "u5", "num": 3},
    {"user": "u6", "num": 8},
]


@pytest.mark.parametrize("batch_window_ms", [0.0, 25.0])
def test_port_answers_equal_the_jax_servers(store, serve_iid, batch_window_ms):
    """The port's HTTP answers, batcher on and off, against the JAX
    ``EngineServer`` on the same instance."""
    ts = store.port_storage()
    jax_server = JaxEngineServer(
        jrec.engine(), store.jax.get_metadata_engine_instances().get(serve_iid),
        storage=store.jax, host="127.0.0.1", port=0,
    )
    server = EngineServer(
        trec.engine(), ts.get_metadata_engine_instances().get(serve_iid),
        storage=ts, host="127.0.0.1", port=0, device="cpu",
        batch_window_ms=batch_window_ms, dispatch_cost_s=10.0,
    )
    port = server.start()
    try:
        results = _concurrent_post(port, PARITY_QUERIES)
        for q in PARITY_QUERIES:
            status, body = results[json.dumps(q)]
            assert status == 200, (q, body)
            _same_answer(json.loads(body), jax_server.handle_query(dict(q)))
    finally:
        server.stop()
        ts.close()


# -- TestMicroBatchedServing ---------------------------------------------------


class TestMicroBatchedServing:
    def test_batched_results_match_per_request(self, deployed_engine):
        """Concurrent queries through a batch-window server must return
        exactly what per-request serving returns, while actually
        coalescing device calls (batch_predict invocations < queries)."""
        batched = _server(
            deployed_engine, batch_window_ms=25.0,
            dispatch_cost_s=10.0,  # pin window-wait mode (probe-independent)
        )
        port = batched.start()
        algo = batched.algorithms[0]
        calls = []
        real_bp = type(algo).batch_predict
        users = [f"u{i}" for i in range(8)]
        expected = {
            u: _post_raw(
                deployed_engine["base"] + "/queries.json", {"user": u, "num": 3}
            )
            for u in users
        }

        def counting_bp(self_, model, queries):
            calls.append(len(queries))
            return real_bp(self_, model, queries)

        type(algo).batch_predict = counting_bp
        try:
            results = _concurrent_post(port, [{"user": u, "num": 3} for u in users])
            for u in users:
                status, body = results[json.dumps({"user": u, "num": 3})]
                assert status == 200
                # K2 is batch-invariant: the same bytes as per-request
                assert body == expected[u][1], u
            # no padding: the batches hold exactly the queries
            assert sum(calls) == len(users)
            assert len(calls) < len(users), (
                f"no batching happened: {len(calls)} calls for {len(users)}"
            )
            # bookkeeping counted every query
            assert batched.status()["requestCount"] == len(users)
        finally:
            type(algo).batch_predict = real_bp
            batched.stop()

    def test_batching_amortizes_per_call_dispatch(self, deployed_engine):
        """The design claim: when each DEVICE CALL carries a fixed,
        device-serialized cost, batching N concurrent queries into one
        call multiplies throughput. Simulated with an 80ms per-call tax
        behind a lock (device calls serialize on the device queue, unlike
        a parallel sleep)."""
        device_lock = threading.Lock()

        def run(batch_window_ms):
            server = _server(
                deployed_engine, batch_window_ms=batch_window_ms,
                dispatch_cost_s=10.0,  # pin window-wait mode
            )
            algo = server.algorithms[0]
            real_p, real_bp = type(algo).predict, type(algo).batch_predict

            def taxed_predict(self_, model, q):
                with device_lock:
                    time.sleep(0.08)
                return real_p(self_, model, q)

            def taxed_batch(self_, model, queries):
                with device_lock:  # per CALL, like serialized dispatch
                    time.sleep(0.08)
                return real_bp(self_, model, queries)

            type(algo).predict = taxed_predict
            type(algo).batch_predict = taxed_batch
            port = server.start()
            try:
                users = [f"u{i}" for i in range(8)]

                def round_trip():
                    threads = [
                        threading.Thread(
                            target=http,
                            args=("POST",
                                  f"http://127.0.0.1:{port}/queries.json",
                                  {"user": u, "num": 3}),
                        )
                        for u in users
                    ]
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join(timeout=60)

                round_trip()  # warm
                t0 = time.perf_counter()
                round_trip()
                return time.perf_counter() - t0
            finally:
                type(algo).predict = real_p
                type(algo).batch_predict = real_bp
                server.stop()

        unbatched = run(0.0)
        batched = run(40.0)
        # 8 concurrent x 80ms serialized per-call tax: unbatched pays
        # ~8 calls (~0.64s); batched ~1-2 calls + the 40ms window
        assert batched < unbatched / 2, (unbatched, batched)

    def test_bypass_mode_lone_query_skips_window(self, deployed_engine):
        """Load-aware policy: the batcher stays engaged on fast-dispatch
        attachments, but a lone query takes the single-item fast path
        and must NOT pay the configured window."""
        server = _server(
            deployed_engine, batch_window_ms=500.0, dispatch_cost_s=0.0,
        )
        assert server.batcher is not None and server.batcher.engaged
        port = server.start()
        try:
            http("POST", f"http://127.0.0.1:{port}/queries.json",
                 {"user": "u1", "num": 3})  # warm
            t0 = time.perf_counter()
            status, _body = http(
                "POST", f"http://127.0.0.1:{port}/queries.json",
                {"user": "u1", "num": 3},
            )
            took = time.perf_counter() - t0
            assert status == 200
            assert took < 0.25, (
                f"lone query took {took:.3f}s with a 0.5s window: the "
                "bypass did not kick in"
            )
        finally:
            server.stop()

    def test_bypass_mode_still_batches_under_serialized_dispatch(
        self, deployed_engine
    ):
        """With the window bypassed, batches must still form naturally:
        requests that queue behind an in-flight (serialized) device call
        coalesce into the next call."""
        device_lock = threading.Lock()
        server = _server(
            deployed_engine,
            # 5 ms dispatch under the 10 ms window -> drain-only batching
            batch_window_ms=10.0, dispatch_cost_s=0.005,
        )
        assert server.batcher.engaged and not server.batcher._window_wait
        algo = server.algorithms[0]
        real_bp = type(algo).batch_predict
        calls = []

        def taxed_batch(self_, model, queries):
            with device_lock:  # per CALL, like serialized dispatch
                time.sleep(0.08)
            calls.append(len(queries))
            return real_bp(self_, model, queries)

        type(algo).batch_predict = taxed_batch
        port = server.start()
        try:
            users = [f"u{i}" for i in range(8)]

            def round_trip():
                threads = [
                    threading.Thread(
                        target=http,
                        args=("POST", f"http://127.0.0.1:{port}/queries.json",
                              {"user": u, "num": 3}),
                    )
                    for u in users
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)

            round_trip()  # warm
            calls.clear()
            round_trip()
            # 8 concurrent queries behind 80ms serialized calls: natural
            # batching must coalesce them into far fewer calls
            assert len(calls) <= 4, (
                f"no natural batching: {len(calls)} calls for {len(users)}"
            )
            assert sum(calls) <= len(users)  # no padding rows
        finally:
            type(algo).batch_predict = real_bp
            server.stop()

    def test_bad_query_does_not_poison_batchmates(self, deployed_engine):
        batched = _server(
            deployed_engine, batch_window_ms=25.0, dispatch_cost_s=10.0,
        )
        port = batched.start()
        try:
            results: dict = {}

            def one(name, payload):
                results[name] = http(
                    "POST", f"http://127.0.0.1:{port}/queries.json", payload
                )

            threads = [
                threading.Thread(target=one, args=("good", {"user": "u1", "num": 3})),
                threading.Thread(target=one, args=("bad", {"user": "u2", "num": "x"})),
                threading.Thread(target=one, args=("good2", {"user": "u3", "num": 2})),
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert results["good"][0] == 200
            assert len(results["good"][1]["itemScores"]) == 3
            assert results["good2"][0] == 200
            assert results["bad"][0] in (400, 500)
        finally:
            batched.stop()

    def test_dispatch_probe_times_a_device_round_trip(self, deployed_engine):
        """The port's probe: a one-element op on the server's device,
        median of a few rounds -- positive and far below a window."""
        import torch

        cost = _MicroBatcher._measure_dispatch(torch.device("cpu"))
        assert 0.0 < cost < 0.05
        server = _server(deployed_engine, batch_window_ms=2.0)
        try:
            assert server.batcher.dispatch_cost_s > 0.0
            assert obs_metrics.gauge(
                "pio_batch_dispatch_cost_seconds"
            ).value() == server.batcher.dispatch_cost_s
        finally:
            server.stop()

    def test_dispatch_probe_failure_raises(self, deployed_engine, monkeypatch):
        """A probe that cannot run one op on the device does not start
        a server (the JAX probe logs and assumes fast)."""
        def broken(device, rounds=5):
            raise RuntimeError("CUDA error: device lost")

        monkeypatch.setattr(_MicroBatcher, "_measure_dispatch",
                            staticmethod(broken))
        with pytest.raises(RuntimeError, match="device lost"):
            _server(deployed_engine, batch_window_ms=2.0)


# -- test_serving_batch.py -----------------------------------------------------


@pytest.fixture(scope="module")
def parity_instances(store):
    """{dtype: instance id} of the 'parity' engine, one per storage dtype."""
    store.rate_app("ParityApp")
    return {
        dtype: store.train(
            jrec.engine(), _rec_params("ParityApp", dtype), f"parity-{dtype}"
        )
        for dtype in DTYPES
    }


def _expected_bytes(engine, inst, storage) -> dict[str, tuple[int, bytes]]:
    """Serve PARITY_QUERIES one at a time through a server with no
    batcher."""
    server = EngineServer(
        engine, inst, storage=storage, host="127.0.0.1", port=0, device="cpu"
    )
    port = server.start()
    try:
        assert server.batcher is None
        return {
            json.dumps(q): _post_raw(f"http://127.0.0.1:{port}/queries.json", q)
            for q in PARITY_QUERIES
        }
    finally:
        server.stop()


def _batched_server(engine, inst, storage):
    # dispatch_cost_s pins window-wait mode so concurrent queries
    # reliably coalesce regardless of the probe on this machine
    server = EngineServer(
        engine, inst, storage=storage, host="127.0.0.1", port=0, device="cpu",
        batch_window_ms=25.0, dispatch_cost_s=10.0,
    )
    return server, server.start()


@pytest.mark.parametrize("dtype", DTYPES)
def test_byte_identical_responses(store, parity_instances, dtype):
    """Same wire bytes batched and unbatched, per storage dtype, with
    mixed query shapes coalesced into one device batch."""
    ts = store.port_storage()
    engine = trec.engine()
    inst = ts.get_metadata_engine_instances().get(parity_instances[dtype])
    expected = _expected_bytes(engine, inst, ts)
    jax_server = JaxEngineServer(
        jrec.engine(),
        store.jax.get_metadata_engine_instances().get(parity_instances[dtype]),
        storage=store.jax, host="127.0.0.1", port=0,
    )
    server, port = _batched_server(engine, inst, ts)
    algo = server.algorithms[0]
    real_bp = type(algo).batch_predict
    batches: list[list[int]] = []

    def counting_bp(self_, model, queries):
        batches.append([int(q.num) for _, q in queries])
        return real_bp(self_, model, queries)

    type(algo).batch_predict = counting_bp
    try:
        results = _concurrent_post(port, PARITY_QUERIES)
        for q in PARITY_QUERIES:
            key = json.dumps(q)
            status, body = results[key]
            assert status == 200, (q, body)
            assert body == expected[key][1], f"batched bytes diverge for {q}"
            _same_answer(json.loads(body), jax_server.handle_query(dict(q)))
        coalesced = [b for b in batches if len(b) > 1]
        assert coalesced, f"no coalesced batch formed: {batches}"
        # mixed shapes really shared a dispatch
        assert any(len(set(b)) > 1 for b in coalesced), batches
    finally:
        type(algo).batch_predict = real_bp
        server.stop()
        ts.close()


def test_batch_of_three_answers_as_three_solo_queries(deployed_engine):
    """No padding: a batch of 3 goes to batch_predict as exactly 3
    queries and answers each as its solo call does, bit for bit."""
    server = deployed_engine["server"]
    algo, model = server.algorithms[0], server.models[0]
    queries = [
        (0, trec.Query(user="u1", num=3)),
        (1, trec.Query(user="u2", num=5)),
        (2, trec.Query(user="u3", num=1)),
    ]
    seen = []
    real_bp = type(algo).batch_predict

    def recording_bp(self_, m, qs):
        seen.append(len(qs))
        return real_bp(self_, m, qs)

    type(algo).batch_predict = recording_bp
    try:
        from concurrent.futures import Future

        futs = [Future() for _ in queries]
        items = [
            (f, time.perf_counter(), None, q, server._default_variant)
            for f, (_, q) in zip(futs, queries)
        ]
        server._score_batch_group(server._default_variant, items)
        batched = [f.result(timeout=10)[0] for f in futs]
    finally:
        type(algo).batch_predict = real_bp
    assert seen == [3]
    for (_, q), got in zip(queries, batched):
        assert got == algo.predict(model, q)


def test_failing_batchmate_retried_individually(store, parity_instances):
    """A batch-level dispatch failure falls back to per-query scoring
    through the same predict: every batchmate still gets its exact
    unbatched response."""
    ts = store.port_storage()
    engine = trec.engine()
    inst = ts.get_metadata_engine_instances().get(parity_instances["float32"])
    expected = _expected_bytes(engine, inst, ts)
    server, port = _batched_server(engine, inst, ts)
    algo = server.algorithms[0]
    real_bp = type(algo).batch_predict
    failed = []

    def flaky_bp(self_, model, queries):
        if len(queries) > 1:  # batch dispatch blows up; retries are B=1
            failed.append(len(queries))
            raise RuntimeError("device OOM on batched dispatch")
        return real_bp(self_, model, queries)

    type(algo).batch_predict = flaky_bp
    try:
        results = _concurrent_post(port, PARITY_QUERIES)
        assert failed, "no multi-query batch was ever dispatched"
        for q in PARITY_QUERIES:
            key = json.dumps(q)
            status, body = results[key]
            assert status == 200, (q, body)
            assert body == expected[key][1], q
    finally:
        type(algo).batch_predict = real_bp
        server.stop()
        ts.close()


def _set(entity_type, entity_id, props):
    return Event(
        event="$set", entity_type=entity_type, entity_id=entity_id,
        properties=props,
    )


def _interaction(name, user, item):
    return Event(
        event=name, entity_type="user", entity_id=user,
        target_entity_type="item", target_entity_id=item,
    )


class TestPerQueryFiltersInBatch:
    """Business rules are per-query even when queries share a device
    dispatch: blackList hits vanish from exactly the queries that asked,
    and a filtered query byte-matches its own solo result. (The JAX
    file's ecommerce case waits for the port's ecommerce template.)"""

    @pytest.fixture(scope="class")
    def similar(self, store):
        info = commands.app_new("SimBatchApp", storage=store.jax)
        rng = np.random.default_rng(1)
        batch = [
            _set("item", f"i{i}", {"categories": ["even" if i % 2 == 0 else "odd"]})
            for i in range(12)
        ]
        for u in range(30):
            batch.append(_set("user", f"u{u}", {}))
            for _ in range(8):
                i = int(rng.integers(0, 6)) * 2 + (u % 2)
                batch.append(_interaction("view", f"u{u}", f"i{i}"))
        store.jax.get_events().batch_insert(batch, info["id"])
        ep = EngineParams(
            datasource=("", jsim.DataSourceParams(app_name="SimBatchApp")),
            algorithms=[("als", jsim.ALSAlgorithmParams(rank=4, num_iterations=4))],
        )
        iid = store.train(jsim.engine(), ep, "sim-batch")
        ts = store.port_storage()
        server = EngineServer(
            tsim.engine(), ts.get_metadata_engine_instances().get(iid),
            storage=ts, host="127.0.0.1", port=0, device="cpu",
        )
        yield server
        server.stop()
        ts.close()

    def test_blacklist_applies_per_query(self, similar):
        algo, model = similar.algorithms[0], similar.models[0]
        q_black = tsim.Query(items=["i0"], num=5, blackList=["i2", "i4"])
        q_plain = tsim.Query(items=["i0"], num=5)
        q_cat = tsim.Query(items=["i0"], num=5, categories=["odd"])
        got = dict(
            algo.batch_predict(model, [(0, q_black), (1, q_plain), (2, q_cat)])
        )
        black_items = [s.item for s in got[0].itemScores]
        assert "i2" not in black_items and "i4" not in black_items
        assert all(int(s.item[1:]) % 2 == 1 for s in got[2].itemScores)
        # the un-filtered batchmate is untouched by its neighbors'
        # filters — identical to its own solo prediction, scores and all
        solo = algo.predict(model, q_plain)
        assert [(s.item, s.score) for s in got[1].itemScores] == [
            (s.item, s.score) for s in solo.itemScores
        ]
        # and the filtered one matches ITS solo prediction too
        solo_black = algo.predict(model, q_black)
        assert [(s.item, s.score) for s in got[0].itemScores] == [
            (s.item, s.score) for s in solo_black.itemScores
        ]


# -- TestFeedbackLoop ----------------------------------------------------------


class TestFeedbackLoop:
    def test_predict_event_posted_back(self, store):
        """Deploy with feedback: a query must produce a pio_pr predict
        event in the event store (reference CreateServer.scala:514-577).
        The event server is the JAX package's: the port has none yet."""
        from predictionio_tpu.server.event_server import EventServer

        info = commands.app_new("FbApp", storage=store.jax)
        batch = [
            Event(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}",
                properties={"rating": float((u + i) % 5 + 1)},
            )
            for u in range(6) for i in range(4)
        ]
        store.jax.get_events().batch_insert(batch, info["id"])
        es = EventServer(storage=store.jax, host="127.0.0.1", port=0)
        es_port = es.start()
        iid = store.train(
            jrec.engine(), _rec_params("FbApp", rank=2, iters=2), "fb"
        )
        ts = store.port_storage()
        server = EngineServer(
            trec.engine(), ts.get_metadata_engine_instances().get(iid),
            storage=ts, host="127.0.0.1", port=0, device="cpu",
            feedback=True,
            event_server_url=f"http://127.0.0.1:{es_port}",
            access_key=info["access_key"],
        )
        port = server.start()
        try:
            status, body = http(
                "POST", f"http://127.0.0.1:{port}/queries.json", {"user": "u1"}
            )
            assert status == 200 and body["prId"]
            deadline = time.time() + 5
            feedback_events = []
            while time.time() < deadline and not feedback_events:
                feedback_events = store.jax.get_events().find(
                    info["id"], entity_type="pio_pr"
                )
                time.sleep(0.05)
            assert feedback_events, "no feedback event arrived"
            fe = feedback_events[0]
            assert fe.event == "predict"
            assert fe.pr_id == body["prId"]
            assert fe.properties["query"]["user"] == "u1"
        finally:
            server.stop()
            es.stop()
            ts.close()
            # the JAX event server registers a process-wide history
            # provider; leave none behind for later files on this worker
            from predictionio_tpu.obs import history as jax_history

            jax_history.unregister_provider("ingest_stats")


# -- TestReloadUnderLoad -------------------------------------------------------


class TestReloadUnderLoad:
    def test_queries_survive_concurrent_reloads(self, deployed_engine):
        """Hot-swap must never surface a torn model to in-flight queries:
        hammer /queries.json from worker threads while /reload swaps
        instances; every response must be a well-formed 200."""
        base = deployed_engine["base"]
        # a second completed instance so reload has something to swap to
        deployed_engine["retrain"]()
        stop = threading.Event()
        errors: list = []

        def hammer():
            while not stop.is_set():
                try:
                    status, body = http(
                        "POST", f"{base}/queries.json", {"user": "u1", "num": 2}
                    )
                    if status != 200 or "itemScores" not in body:
                        errors.append((status, body))
                except Exception as e:  # noqa: BLE001 - collect, then fail
                    errors.append(repr(e))

        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            futures = [pool.submit(hammer) for _ in range(3)]
            try:
                for _ in range(10):
                    status, _ = http("POST", f"{base}/reload?accessKey=secret")
                    assert status == 200
            finally:
                stop.set()  # or a failed assert deadlocks pool shutdown
            for f in futures:
                f.result(timeout=30)
        assert not errors, errors[:3]

    def test_concurrent_first_queries_on_a_cold_server(self, deployed_engine):
        """No warmup: the first queries arrive together on handler
        threads and the batcher's worker, all racing to upload the factor
        tables (``device_factors`` uploads under a lock). Every answer is
        the one the same server gives a lone query afterwards. Each
        server gets a fresh instance: decoded model files are shared
        process-wide, so a served instance is already on the device."""
        users = [f"u{i}" for i in range(8)]
        queries = [{"user": u, "num": 3} for u in users]
        for window in (0.0, 25.0):
            iid = deployed_engine["retrain"]()
            cold = EngineServer(
                deployed_engine["engine"],
                deployed_engine["storage"].get_metadata_engine_instances().get(iid),
                storage=deployed_engine["storage"], host="127.0.0.1", port=0,
                device="cpu", batch_window_ms=window, dispatch_cost_s=10.0,
            )
            assert cold.models[0]._device is None  # nothing uploaded yet
            port = cold.start()
            try:
                results = _concurrent_post(port, queries)
                for q in queries:
                    status, body = results[json.dumps(q)]
                    assert status == 200, (window, q, body)
                    assert (status, body) == _post_raw(
                        f"http://127.0.0.1:{port}/queries.json", q
                    ), (window, q)
            finally:
                cold.stop()


# -- TestQueryCacheUnit --------------------------------------------------------


class TestQueryCacheUnit:
    def _cache(self, capacity=64 * 1024, shards=1):
        from predictionio_tpu_torch.server.query_cache import QueryCache

        return QueryCache(capacity, shards=shards)

    def _key(self, i, epoch=0):
        from predictionio_tpu_torch.server.query_cache import canonical_query_bytes

        return ("default", canonical_query_bytes({"user": f"u{i}"}), epoch)

    def test_canonical_bytes_key_order_insensitive(self):
        from predictionio_tpu_torch.server.query_cache import canonical_query_bytes

        a = canonical_query_bytes({"user": "u1", "num": 3})
        b = canonical_query_bytes({"num": 3, "user": "u1"})
        assert a == b

    def test_put_get_counters(self):
        cache = self._cache()
        k = self._key(1)
        assert cache.get(k) is None
        cache.put(k, b'{"ok":1}')
        assert cache.get(k) == b'{"ok":1}'
        g = cache.gauges()
        assert g["cache_hits"] == 1 and g["cache_misses"] == 1
        assert g["cache_entries"] == 1
        assert g["cache_hit_rate"] == 0.5
        assert g["cache_bytes"] > len(b'{"ok":1}')  # payload + key + overhead

    def test_eviction_under_pressure(self):
        """Byte cap enforced per shard: filling far past capacity evicts
        LRU entries, keeps bytes under the cap, and counts evictions."""
        cache = self._cache(capacity=8 * 1024, shards=1)
        payload = b"x" * 512
        for i in range(50):
            cache.put(self._key(i), payload)
        g = cache.gauges()
        assert g["cache_bytes"] <= 8 * 1024
        assert 0 < g["cache_entries"] < 50
        assert g["cache_evictions"] == 50 - g["cache_entries"]
        assert cache.get(self._key(0)) is None  # oldest evicted
        assert cache.get(self._key(49)) == payload  # newest retained

    def test_get_refreshes_lru_order(self):
        cache = self._cache(capacity=8 * 1024, shards=1)
        payload = b"x" * 512
        cache.put(self._key(0), payload)
        for i in range(1, 11):
            cache.put(self._key(i), payload)
            cache.get(self._key(0))  # keep key 0 hot
        assert cache.get(self._key(0)) == payload

    def test_oversized_payload_skipped(self):
        cache = self._cache(capacity=4 * 1024, shards=1)
        cache.put(self._key(1), b"y" * 8 * 1024)  # larger than the shard
        assert cache.gauges()["cache_entries"] == 0

    def test_sweep_drops_stale_epochs(self):
        cache = self._cache()
        for i, epoch in enumerate((0, 0, 1, 2)):
            cache.put(self._key(i, epoch=epoch), b"z")
        dropped = cache.sweep(2)
        assert dropped == 3
        g = cache.gauges()
        assert g["cache_entries"] == 1
        assert cache.get(self._key(3, epoch=2)) == b"z"


# -- TestQueryCacheServing -----------------------------------------------------


@pytest.fixture()
def cached_engine(deployed_engine):
    """A second EngineServer over the already-trained instance with the
    query-result cache enabled (no retrain; construction is cheap)."""
    d = deployed_engine
    server = _server(d, server_key="secret", query_cache_mb=4)
    port = server.start()
    yield {**d, "base": f"http://127.0.0.1:{port}", "server": server}
    server.stop()


class TestQueryCacheServing:
    def _count_predict(self, server):
        """Wrap the deployed algorithm's predict with a call counter
        (the kernel call skip is the point of a hit)."""
        algo = server.algorithms[0]
        calls = []
        orig = algo.predict

        def counting(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        algo.predict = counting
        return calls

    def test_hit_serves_identical_bytes_without_recompute(self, cached_engine):
        server = cached_engine["server"]
        url = cached_engine["base"] + "/queries.json"
        calls = self._count_predict(server)
        _, b1 = _post_raw(url, {"user": "u1", "num": 3})
        _, b2 = _post_raw(url, {"user": "u1", "num": 3})
        assert b1 == b2
        assert len(calls) == 1  # second request never touched the model
        g = server.query_cache.gauges()
        assert g["cache_hits"] == 1 and g["cache_entries"] == 1
        # the canonical key ignores body key order: still a hit
        _, b3 = _post_raw(url, {"num": 3, "user": "u1"})
        assert b3 == b1 and len(calls) == 1

    def test_hits_count_in_request_count(self, cached_engine):
        url = cached_engine["base"] + "/queries.json"
        _post_raw(url, {"user": "u1", "num": 3})
        _post_raw(url, {"user": "u1", "num": 3})
        status, page = http("GET", cached_engine["base"] + "/")
        assert status == 200 and page["requestCount"] == 2

    def test_stats_route_exposes_cache_gauges(self, cached_engine):
        url = cached_engine["base"] + "/queries.json"
        _post_raw(url, {"user": "u1", "num": 3})
        _post_raw(url, {"user": "u1", "num": 3})
        status, body = http("GET", cached_engine["base"] + "/stats.json")
        assert status == 200
        cache = body["cache"]
        assert cache["enabled"] is True
        assert cache["cache_hits"] == 1 and cache["cache_misses"] == 1
        assert cache["cache_hit_rate"] == 0.5
        assert cache["cache_entries"] == 1 and cache["cache_bytes"] > 0

    def test_stats_route_reports_disabled_without_cache(self, deployed_engine):
        status, body = http("GET", deployed_engine["base"] + "/stats.json")
        assert status == 200
        assert body["cache"] == {"enabled": False}
        assert body["device"]["torch"] and "transfer_bytes" in body["device"]

    def test_reload_invalidates(self, cached_engine):
        server = cached_engine["server"]
        url = cached_engine["base"] + "/queries.json"
        calls = self._count_predict(server)
        _post_raw(url, {"user": "u1", "num": 3})
        assert len(calls) == 1
        cached_engine["retrain"]()
        status, _ = http("POST", cached_engine["base"] + "/reload?accessKey=secret")
        assert status == 200
        # the reload re-wraps algorithms; recount on the fresh object
        calls2 = self._count_predict(server)
        _post_raw(url, {"user": "u1", "num": 3})
        assert len(calls2) == 1  # recomputed: pre-reload entry swept
        assert server.query_cache.gauges()["cache_entries"] == 1

    def test_cacheable_false_bypasses_cache(self, cached_engine):
        server = cached_engine["server"]
        url = cached_engine["base"] + "/queries.json"
        server.algorithms[0].cacheable_query = lambda q: False
        calls = self._count_predict(server)
        _, b1 = _post_raw(url, {"user": "u1", "num": 3})
        _, b2 = _post_raw(url, {"user": "u1", "num": 3})
        assert b1 == b2
        assert len(calls) == 2  # both recomputed
        assert server.query_cache.gauges()["cache_entries"] == 0

    def test_recommendation_algorithm_default_cacheable(self):
        algo = trec.ALSAlgorithm(trec.ALSAlgorithmParams())
        assert algo.cacheable_query(trec.Query(user="u1")) is True
        assert tsim.SumScoreServing().cacheable_query(tsim.Query(items=["i"]))

    def test_warmup_compiles_per_algorithm(self, deployed_engine):
        assert deployed_engine["server"].warmup() == 1


# -- TestGracefulDegradation ---------------------------------------------------


class TestGracefulDegradation:
    def test_reload_in_flight_keeps_serving_old_model(self, deployed_engine):
        """Hold a /reload open and prove the OLD model keeps answering
        200 for the whole swap window — prepare_deploy runs off the
        server lock and the swap itself is atomic."""
        server = deployed_engine["server"]
        base = deployed_engine["base"]
        entered = threading.Event()
        release = threading.Event()
        orig_load = server._load

        def slow_load(instance):
            entered.set()
            assert release.wait(10)
            return orig_load(instance)

        server._load = slow_load
        try:
            t = threading.Thread(
                target=http, args=("POST", base + "/reload?accessKey=secret"),
            )
            t.start()
            assert entered.wait(10)
            status, body, _ = http_full(
                "POST", base + "/queries.json", {"user": "u1", "num": 3}
            )
            assert status == 200 and body["itemScores"]
        finally:
            release.set()
            server._load = orig_load
        t.join(timeout=30)
        status, body, _ = http_full(
            "POST", base + "/queries.json", {"user": "u1", "num": 3}
        )
        assert status == 200 and body["itemScores"]

    def test_query_deadline_times_out_to_503(self, deployed_engine):
        server = _server(deployed_engine, query_deadline_ms=150.0)
        port = server.start()
        try:
            base = f"http://127.0.0.1:{port}"
            # fast query under the deadline serves normally
            status, body, _ = http_full(
                "POST", base + "/queries.json", {"user": "u1", "num": 3}
            )
            assert status == 200
            with faults.injected("serve.query:sleep=600"):
                status, body, headers = http_full(
                    "POST", base + "/queries.json", {"user": "u1", "num": 3}
                )
            assert status == 503
            assert headers.get("Retry-After") == "1"
            assert "deadline" in json.dumps(body)
            # deadline overruns must not poison later queries
            status, body, _ = http_full(
                "POST", base + "/queries.json", {"user": "u1", "num": 3}
            )
            assert status == 200 and body["itemScores"]
        finally:
            server.stop()

    def test_batcher_failure_falls_back_to_unbatched(self, deployed_engine):
        """A dead batcher worker degrades to unbatched serving -- the same
        predict on the same device, never a plain version."""
        server = _server(
            deployed_engine, batch_window_ms=25.0, dispatch_cost_s=10.0,
        )
        port = server.start()
        fallback_counter = obs_metrics.counter(
            "pio_batcher_fallback_total",
            "Queries served unbatched after a micro-batcher failure",
        )
        before = fallback_counter.value()
        try:

            def broken_submit(body):
                raise RuntimeError("batch worker failed")

            server.batcher.submit = broken_submit
            status, body, _ = http_full(
                "POST", f"http://127.0.0.1:{port}/queries.json",
                {"user": "u1", "num": 3},
            )
            assert status == 200 and body["itemScores"]
            assert fallback_counter.value() == before + 1
        finally:
            server.stop()

    def test_batcher_query_errors_still_propagate(self, deployed_engine):
        """Only infrastructure failures fall back; a bad query through
        the batcher stays a 400, not a silent unbatched retry."""
        server = _server(
            deployed_engine, batch_window_ms=25.0, dispatch_cost_s=10.0,
        )
        port = server.start()
        try:
            status, _, _ = http_full(
                "POST", f"http://127.0.0.1:{port}/queries.json", [1, 2]
            )
            assert status == 400
        finally:
            server.stop()

    def test_warmup_blocks_queries_while_running(self, deployed_engine):
        server = deployed_engine["server"]
        base = deployed_engine["base"]
        server._swapping.set()  # what warmup() holds while building
        try:
            status, _, headers = http_full(
                "POST", base + "/queries.json", {"user": "u1"}
            )
            assert status == 503 and headers.get("Retry-After") == "1"
        finally:
            server._swapping.clear()
        status, _, _ = http_full("POST", base + "/queries.json", {"user": "u1"})
        assert status == 200

    def test_warmup_failure_raises(self, deployed_engine):
        """The port's warmup raises (the JAX one logs and goes on): a
        server that cannot score does not start. The fence is lifted."""
        server = _server(deployed_engine)
        algo = server.algorithms[0]

        def broken(model, queries):
            raise RuntimeError("kernel launch failed")

        algo.batch_predict = broken
        try:
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                server.warmup()
            assert not server._swapping.is_set()
        finally:
            server.stop()

    def test_drain_lets_in_flight_queries_finish(self, deployed_engine):
        """drain(): a query in flight when the drain begins still gets
        its 200; the batcher stops afterwards."""
        server = _server(deployed_engine, batch_window_ms=2.0,
                         dispatch_cost_s=0.0)
        algo = server.algorithms[0]
        entered, release = threading.Event(), threading.Event()
        real_p = algo.predict

        def slow_predict(model, q):
            entered.set()
            assert release.wait(10)
            return real_p(model, q)

        algo.predict = slow_predict
        port = server.start()
        result = {}
        t = threading.Thread(target=lambda: result.update(r=http(
            "POST", f"http://127.0.0.1:{port}/queries.json",
            {"user": "u1", "num": 3},
        )))
        t.start()
        assert entered.wait(10)
        drainer = threading.Thread(target=server.drain)
        drainer.start()
        time.sleep(0.1)
        release.set()
        t.join(timeout=30)
        drainer.join(timeout=30)
        assert result["r"][0] == 200 and len(result["r"][1]["itemScores"]) == 3
        assert not server.batcher.active
        server.stop()


# -- test_multitenant.py -------------------------------------------------------


MT_QUERIES = [{"user": f"u{u}", "num": 3} for u in range(12)] + [
    {"user": "zz", "num": 2}
]


@pytest.fixture(scope="module")
def tenant_instances(store):
    """{dtype: instance id} of per-dtype tenant engines (seed 11)."""
    out = {}
    for dtype in DTYPES:
        store.rate_app(f"Par{dtype}", seed=11)
        out[dtype] = store.train(
            jrec.engine(), _rec_params(f"Par{dtype}", dtype), f"par-{dtype}"
        )
    return out


class TestByteIdenticalVsSolo:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_variant_responses_match_solo(self, store, tenant_instances, dtype):
        ts = store.port_storage()
        inst = ts.get_metadata_engine_instances().get(tenant_instances[dtype])
        solo = EngineServer(
            trec.engine(), inst, storage=ts, host="127.0.0.1", port=0,
            device="cpu",
        )
        multi = EngineServer(
            trec.engine(), inst, storage=ts, host="127.0.0.1", port=0,
            device="cpu",
            extra_variants=[("b", trec.engine(), inst), ("c", trec.engine(), inst)],
        )
        sp = solo.start()
        mp = multi.start()
        try:
            for q in MT_QUERIES:
                _, want = _post_raw(f"http://127.0.0.1:{sp}/queries.json", q)
                # bare path (default tenant), path prefix, and header
                # routing must all return the solo bytes exactly
                for url, headers in (
                    (f"http://127.0.0.1:{mp}/queries.json", None),
                    (f"http://127.0.0.1:{mp}/b/queries.json", None),
                    (f"http://127.0.0.1:{mp}/queries.json", {"X-PIO-Variant": "c"}),
                ):
                    status, got = _post_raw(url, q, headers)
                    assert status == 200
                    assert got == want, (dtype, q, url)
        finally:
            solo.stop()
            multi.stop()
            ts.close()


@pytest.fixture()
def multi_tenant(store, tenant_instances):
    ts = store.port_storage()
    inst = ts.get_metadata_engine_instances().get(tenant_instances["float32"])
    server = EngineServer(
        trec.engine(), inst, storage=ts, host="127.0.0.1", port=0,
        device="cpu", query_cache_mb=4.0,
        extra_variants=[("b", trec.engine(), inst), ("c", trec.engine(), inst)],
    )
    port = server.start()
    yield {"server": server, "base": f"http://127.0.0.1:{port}", "storage": ts}
    server.stop()
    ts.close()


class TestRoutingAndIsolation:
    def test_unknown_variant_404s(self, multi_tenant):
        base = multi_tenant["base"]
        status, _ = _post_raw(f"{base}/nope/queries.json", MT_QUERIES[0])
        assert status == 404
        status, _ = _post_raw(
            f"{base}/queries.json", MT_QUERIES[0], {"X-PIO-Variant": "nope"}
        )
        assert status == 404

    def test_stats_has_per_variant_rows(self, multi_tenant):
        base = multi_tenant["base"]
        for q in MT_QUERIES[:3]:
            _post_raw(f"{base}/b/queries.json", q)
        with urllib.request.urlopen(f"{base}/stats.json", timeout=10) as r:
            body = json.loads(r.read())
        rows = body["variants"]
        assert set(rows) >= {"default", "b", "c"}
        assert rows["b"]["requestCount"] == 3
        assert rows["c"]["requestCount"] == 0

    def test_reload_of_one_tenant_leaves_others_untouched(self, multi_tenant):
        server = multi_tenant["server"]
        base = multi_tenant["base"]
        # warm every tenant's cache partition with the same query
        for prefix in ("", "/b", "/c"):
            status, _ = _post_raw(f"{base}{prefix}/queries.json", MT_QUERIES[0])
            assert status == 200
        epochs = {n: v._epoch for n, v in server.variants.items()}
        entries_before = server.query_cache.gauges()["cache_entries"]
        status, _ = _post_raw(f"{base}/b/reload", {})
        assert status == 200
        assert server.variants["b"]._epoch == epochs["b"] + 1
        assert server.variants["default"]._epoch == epochs["default"]
        assert server.variants["c"]._epoch == epochs["c"]
        # only b's partition was swept
        assert server.query_cache.gauges()["cache_entries"] == entries_before - 1
        # default and c still answer from cache (hit count moves)
        hits0 = server.query_cache.gauges()["cache_hits"]
        status, _ = _post_raw(f"{base}/queries.json", MT_QUERIES[0])
        assert status == 200
        status, _ = _post_raw(f"{base}/c/queries.json", MT_QUERIES[0])
        assert status == 200
        assert server.query_cache.gauges()["cache_hits"] == hits0 + 2

    def test_per_variant_latency_slos_installed(self, multi_tenant):
        names = set(obs_slo.REGISTRY.names())
        assert {"engine.latency[default]", "engine.latency[b]",
                "engine.latency[c]"} <= names


# -- two-stage retrieval ------------------------------------------------------


def _two_stage_on(monkeypatch):
    """Route the 8-item ServeApp catalog through two-stage retrieval: a
    k' of k (oversample 1) is below the catalog at num <= 4."""
    monkeypatch.setenv("PIO_RETRIEVAL_THRESHOLD", "1")
    monkeypatch.setenv("PIO_RETRIEVAL_OVERSAMPLE", "1")


def _traced_query(base: str, body: dict, trace_id: str) -> list[str]:
    """POST a query carrying ``X-PIO-Trace``; its trace's span names. The
    ring keeps the slowest recent traces, so it is emptied first."""
    from predictionio_tpu_torch.obs import trace as obs_trace

    obs_trace.TRACES.clear()
    status, _ = http("POST", base + "/queries.json", body, {"X-PIO-Trace": trace_id})
    assert status == 200
    status, body = http("GET", base + "/traces.json")
    assert status == 200
    mine = [t for t in body["traces"] if t["traceId"] == trace_id]
    assert mine, body["traces"]
    return [sp["name"] for sp in mine[0]["spans"]]


class TestTwoStageServing:
    """The JAX server's two-stage hooks on the port's server: the
    ``retrieval`` block of /stats.json, the per-dispatch stage split as
    ``dispatch.shortlist`` / ``dispatch.rescore`` spans, drained on every
    dispatch so it never leaks into the next request."""

    def test_stats_json_carries_the_retrieval_block(self, deployed_engine):
        from predictionio_tpu_torch.ops import retrieval

        status, body = http("GET", deployed_engine["base"] + "/stats.json")
        assert status == 200
        assert set(body["retrieval"]) == set(retrieval.stats_block())
        assert body["retrieval"]["threshold"] == retrieval.retrieval_threshold()

    def test_traced_solo_request_carries_the_stage_spans(self, deployed_engine, monkeypatch):
        from predictionio_tpu_torch.ops import retrieval

        _two_stage_on(monkeypatch)
        before = retrieval.stats_block()["two_stage_queries"]
        names = _traced_query(deployed_engine["base"], {"user": "u1", "num": 2},
                              "5eed000000000001")
        assert retrieval.stats_block()["two_stage_queries"] == before + 1
        assert "dispatch.shortlist" in names and "dispatch.rescore" in names

    def test_sub_threshold_request_has_no_stage_spans(self, deployed_engine):
        names = _traced_query(deployed_engine["base"], {"user": "u1", "num": 2},
                              "5eed000000000002")
        assert "serve" in names
        assert not {"dispatch.shortlist", "dispatch.rescore"} & set(names)

    @pytest.mark.parametrize("size", [1, 3])
    def test_batched_dispatch_spans_and_no_leak(self, deployed_engine, monkeypatch, size):
        """A batch (and the lone-query fast path) carries the spans on
        each traced request; the split is drained on the dispatching
        thread, so a sub-threshold dispatch after it carries none."""
        from concurrent.futures import Future

        from predictionio_tpu_torch.obs import trace as obs_trace
        from predictionio_tpu_torch.ops import retrieval

        server = deployed_engine["server"]
        variant = server._default_variant

        def dispatch(users):
            traces = [obs_trace.Trace("test") for _ in users]
            futs = [Future() for _ in users]
            server._score_batch_group(variant, [
                (f, time.perf_counter(), tr, trec.Query(user=u, num=2), variant)
                for f, tr, u in zip(futs, traces, users)
            ])
            for f in futs:
                assert f.result(timeout=10)[0].itemScores
            return [{name for name, _, _ in tr.spans} for tr in traces]

        users = ["u1", "u2", "u3"][:size]
        _two_stage_on(monkeypatch)
        for names in dispatch(users):
            assert {"dispatch.shortlist", "dispatch.rescore"} <= names
        assert retrieval.take_stage_split() is None  # drained by the dispatch
        monkeypatch.delenv("PIO_RETRIEVAL_THRESHOLD")
        for names in dispatch(users):
            assert not {"dispatch.shortlist", "dispatch.rescore"} & names


# -- the deploy CLI ------------------------------------------------------------


def test_deploy_flags_reach_the_server(store, serve_iid, monkeypatch, tmp_path):
    """``deploy``'s serving flags build the server they name; --workers
    is the worker set's parent's (``cmd_deploy``), so ``deploy_server``
    builds the one process's server whatever it says, and ``cmd_deploy``
    refuses it without a port of its own; --realtime is ported (the speed
    layer, started by ``cmd_deploy``) and builds the server as well."""
    from predictionio_tpu_torch.cli import main as tcli

    monkeypatch.setenv("PIO_FS_BASEDIR", store.env["PIO_FS_BASEDIR"])
    monkeypatch.setenv("PIO_SERVER_CONF", str(tmp_path / "absent.conf"))
    for k in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(k)
    tstorage.set_storage(None)
    try:
        base = ["deploy", "--engine-instance-id", serve_iid, "--ip", "127.0.0.1",
                "--port", "0", "--device", "cpu"]
        server = tcli.deploy_server(tcli.build_parser().parse_args(
            base + ["--batch-window-ms", "2", "--query-cache-mb", "8",
                    "--log-url", "http://127.0.0.1:1/log", "--log-prefix", "P: "]
        ))
        try:
            assert server.batcher is not None and server.query_cache is not None
            assert server.log_url == "http://127.0.0.1:1/log"
            assert server.log_prefix == "P: "
            assert server.device.type == "cpu"
        finally:
            server.stop()
        args = tcli.build_parser().parse_args(base + ["--workers", "2"])
        server = tcli.deploy_server(args)
        try:
            assert server.device.type == "cpu" and server.batcher is None
        finally:
            server.stop()
        assert tcli.cmd_deploy(args) == 1  # --port 0: a worker set needs a port
        server = tcli.deploy_server(tcli.build_parser().parse_args(
            base + ["--realtime", "1"]))
        server.stop()
    finally:
        tstorage.get_storage().close()
        tstorage.set_storage(None)
