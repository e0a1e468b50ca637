"""The port's observability layer (``predictionio_tpu_torch/obs/``), on
the CPU: histogram math vs numpy, concurrent update integrity, Prometheus
text golden, trace-ring retention semantics, the /metrics +
/traces.json endpoints live over a real socket on the port's engine
server, and the device layer restated for torch.

The port's copies of ``tests/test_obs.py`` (its bounded ingestion-stats
window and event-server endpoints wait for the port's event server: the
endpoint cases run against the port's engine server instead) and of
``tests/test_obs_device.py``, restated for torch: the memory gauges
export zeros with ``supported = 0`` in a process that has not
initialised CUDA, ``count_transfer`` is fed by each model's
``device_factors``, ``profile_capture`` writes a ``torch.profiler``
Chrome trace, and the kernel-build count stays flat after warmup."""

from __future__ import annotations

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.core.workflow import save_instance
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.models import recommendation as trec
from predictionio_tpu_torch.obs import device as obs_device
from predictionio_tpu_torch.obs import metrics, progress, trace
from predictionio_tpu_torch.obs.metrics import (
    BUCKET_BOUNDS,
    Histogram,
    Registry,
    _percentile_from_counts,
    parse_prometheus,
)
from predictionio_tpu_torch.server.engine_server import EngineServer
from predictionio_tpu_torch.server.http import HTTPApp, Router, add_obs_routes


def _get(url: str, headers: dict | None = None):
    req = urllib.request.Request(url, method="GET")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, resp.headers, resp.read()


class TestHistogram:
    def test_percentiles_vs_numpy(self):
        """Interpolated percentiles land within one ~2x bucket of the
        exact sample percentile, across a 6-decade lognormal spread."""
        rng = np.random.default_rng(7)
        vals = rng.lognormal(mean=-7.0, sigma=1.2, size=20_000)
        h = Histogram("t_seconds", "")
        for v in vals:
            h.observe(float(v))
        for q in (0.50, 0.90, 0.99):
            est = h.percentile(q)
            true = float(np.percentile(vals, q * 100))
            assert 0.45 * true <= est <= 2.2 * true, (q, est, true)

    def test_zero_and_overflow(self):
        h = Histogram("t_seconds", "")
        h.observe(0.0)
        h.observe(-3.0)  # clamped to the zero bucket, not dropped
        h.observe(1e9)  # far past the last bound -> overflow cell
        counts, total, n = h.merged()
        assert n == 3
        assert counts[0] == 2
        assert counts[-1] == 1
        # overflow percentile interpolates within [last bound, 2x last]
        p99 = _percentile_from_counts(counts, n, 0.99)
        assert BUCKET_BOUNDS[-1] < p99 <= BUCKET_BOUNDS[-1] * 2

    def test_custom_bounds(self):
        """Count-shaped histograms (batch sizes) use their own buckets
        instead of the latency layout."""
        h = Histogram("batch", "", bounds=(1, 2, 4, 8))
        for size in (1, 1, 3, 8, 30):
            h.observe(float(size))
        counts, total, n = h.merged()
        assert len(counts) == 5
        assert counts == [2, 0, 1, 1, 1]
        assert total == 43.0 and n == 5

    def test_concurrent_updates_lose_nothing(self):
        """8 threads hammering one histogram: every observation lands
        exactly once (striped locks, no torn counts)."""
        h = Histogram("stress_seconds", "")
        per_thread = 25_000

        def work():
            for _ in range(per_thread):
                h.observe(1e-3)

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        counts, total, n = h.merged()
        assert n == 8 * per_thread
        assert sum(counts) == 8 * per_thread
        assert abs(total - 8 * per_thread * 1e-3) < 1e-6

    def test_percentile_empty(self):
        assert Histogram("e_seconds", "").percentile(0.5) == 0.0


class TestPrometheus:
    def test_render_golden(self):
        """Exact text-format output for a small registry: HELP/TYPE once
        per family, cumulative buckets, +Inf, _sum/_count."""
        reg = Registry()
        reg.counter("c_total", "test counter", role="x").inc(2)
        reg.gauge("g_val", "test gauge").set(1.5)
        h = reg.histogram("h_seconds", "test hist", bounds=(1.0, 2.0))
        for v in (0.5, 1.5, 9.25):
            h.observe(v)
        assert reg.render_prometheus().decode() == (
            "# HELP c_total test counter\n"
            "# TYPE c_total counter\n"
            'c_total{role="x"} 2\n'
            "# HELP g_val test gauge\n"
            "# TYPE g_val gauge\n"
            "g_val 1.5\n"
            "# HELP h_seconds test hist\n"
            "# TYPE h_seconds histogram\n"
            'h_seconds_bucket{le="1"} 1\n'
            'h_seconds_bucket{le="2"} 2\n'
            'h_seconds_bucket{le="+Inf"} 3\n'
            "h_seconds_sum 11.25\n"
            "h_seconds_count 3\n"
        )

    def test_parse_round_trip(self):
        reg = Registry()
        reg.counter("a_total").inc(5)
        reg.gauge("b_val", labelled="yes").set(0.25)
        parsed = parse_prometheus(reg.render_prometheus())
        assert parsed["a_total"] == 5.0
        assert parsed['b_val{labelled="yes"}'] == 0.25

    def test_get_or_create_and_type_conflict(self):
        reg = Registry()
        assert reg.counter("x_total", app="1") is reg.counter(
            "x_total", app="1"
        )
        assert reg.counter("x_total", app="2") is not reg.counter(
            "x_total", app="1"
        )
        with pytest.raises(TypeError):
            reg.gauge("x_total", app="1")

    def test_stats_block_prefix_filter(self):
        """Only pio_-named metrics ride /stats.json; scratch instruments
        (the bench's) stay out."""
        reg = Registry()
        reg.counter("pio_things_total").inc(3)
        reg.histogram("bench_scratch_seconds").observe(0.1)
        block = reg.stats_block()
        assert block == {"pio_things_total": 3}

    def test_histogram_summary_shape(self):
        reg = Registry()
        h = reg.histogram("pio_x_seconds")
        for _ in range(100):
            h.observe(1e-3)
        s = reg.stats_block()["pio_x_seconds"]
        assert s["count"] == 100
        assert set(s) == {"count", "sum", "p50", "p90", "p99"}
        # all mass in one bucket: every percentile inside its bounds
        assert 512e-6 <= s["p50"] <= 1024e-6 * 2


class TestDisabled:
    def test_disabled_instruments_are_noops(self):
        reg = Registry()
        c = reg.counter("d_total")
        g = reg.gauge("d_val")
        h = reg.histogram("d_seconds")
        ring = trace.TraceRing(capacity=4)
        tr = trace.Trace("x")
        tr.finish(200)
        prior = metrics.enabled()
        try:
            metrics.set_enabled(False)
            c.inc()
            g.set(9.0)
            h.observe(1.0)
            ring.offer(tr)
            assert c.value() == 0
            assert g.value() == 0.0
            assert h.merged()[2] == 0
            assert ring.snapshot() == []
            metrics.set_enabled(True)
            c.inc()
            assert c.value() == 1
        finally:
            metrics.set_enabled(prior)


class TestTrace:
    def test_trace_id_honored_and_lazily_minted(self):
        tr = trace.Trace("x", trace_id="cafe")
        assert tr.trace_id == "cafe"
        tr2 = trace.Trace("y")
        tid = tr2.trace_id
        assert len(tid) == 16 and tid == tr2.trace_id
        assert tid != trace.Trace("z").trace_id

    def test_span_offsets(self):
        tr = trace.Trace("POST /q", t0=100.0)
        tr.add_span("stage", 100.25, 100.5)
        tr.finish(200)
        d = tr.to_dict()
        assert d["status"] == 200
        span = d["spans"][0]
        assert span["name"] == "stage"
        assert span["offsetMs"] == 250.0
        assert span["durationMs"] == 250.0

    def test_span_context_manager(self):
        tr = trace.Trace("x")
        with tr.span("inner"):
            pass
        assert tr.to_dict()["spans"][0]["name"] == "inner"

    def test_ring_keeps_slowest(self):
        """Capacity 4: durations 5,1,2,3 all admitted; 4 evicts the
        fastest (1); a faster-than-floor trace is rejected."""
        ring = trace.TraceRing(capacity=4, max_age_s=3600)

        def offer(duration):
            tr = trace.Trace(f"d{duration}")
            tr.duration_s = float(duration)
            tr.status = 200
            ring.offer(tr)

        for d in (5, 1, 2, 3):
            offer(d)
        offer(4)
        snap = ring.snapshot()
        assert [t["durationMs"] for t in snap] == [5000, 4000, 3000, 2000]
        offer(0.5)  # below the retained floor: rejected
        assert len(ring.snapshot()) == 4
        offer(10)  # evicts the current fastest (2)
        assert [t["durationMs"] for t in ring.snapshot()] == [
            10_000, 5000, 4000, 3000,
        ]

    def test_ring_age_pruning(self):
        import time as _time

        ring = trace.TraceRing(capacity=8, max_age_s=10.0)
        old = trace.Trace("old", t0=_time.perf_counter() - 3600)
        old.duration_s = 9.0
        fresh = trace.Trace("fresh")
        fresh.duration_s = 0.001
        ring.offer(old)
        ring.offer(fresh)
        names = [t["name"] for t in ring.snapshot()]
        assert names == ["fresh"]

    def test_current_trace_thread_local(self):
        tr = trace.Trace("x")
        trace.set_current_trace(tr)
        try:
            assert trace.current_trace() is tr
            seen = []
            t = threading.Thread(
                target=lambda: seen.append(trace.current_trace())
            )
            t.start()
            t.join()
            assert seen == [None]
        finally:
            trace.set_current_trace(None)


# -- endpoints, on the port's engine server -------------------------------------


def _engine_server(tmp_path, **kw) -> EngineServer:
    """A port engine server (not started) on a 6-user, 5-item CPU model."""
    storage = tstorage.Storage(env={"PIO_FS_BASEDIR": str(tmp_path)})
    engine = trec.engine()
    ep = engine.params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": 2}}]}
    )
    rng = np.random.default_rng(3)
    model = trec.model_from_numpy(
        [f"u{i}" for i in range(6)], [f"i{j}" for j in range(5)],
        rng.standard_normal((6, 2)).astype(np.float32),
        rng.standard_normal((5, 2)).astype(np.float32),
    )
    iid = save_instance(engine, ep, [model], engine_id="obs", storage=storage)
    return EngineServer(
        engine, storage.get_metadata_engine_instances().get(iid),
        storage=storage, host="127.0.0.1", port=0, device="cpu", **kw,
    )


def _query(base: str, body: dict, headers: dict | None = None) -> int:
    req = urllib.request.Request(
        f"{base}/queries.json", data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        resp.read()
        return resp.status


@pytest.fixture()
def obs_engine_server(tmp_path):
    server = _engine_server(tmp_path)
    port = server.start()
    yield {"base": f"http://127.0.0.1:{port}", "server": server}
    server.stop()
    server.storage.close()


class TestEndpoints:
    def test_metrics_endpoint(self, obs_engine_server):
        base = obs_engine_server["base"]
        assert _query(base, {"user": "u1", "num": 2}) == 200
        status, headers, body = _get(f"{base}/metrics")
        assert status == 200
        assert headers["Content-Type"].startswith("text/plain; version=0.0.4")
        parsed = parse_prometheus(body)
        assert parsed['pio_http_requests_total{server="engine"}'] >= 1
        assert any(k.startswith("pio_serving_seconds_count") for k in parsed)

    def test_stats_json_obs_block(self, obs_engine_server):
        base = obs_engine_server["base"]
        assert _query(base, {"user": "u1", "num": 2}) == 200
        status, _, body = _get(f"{base}/stats.json")
        assert status == 200
        payload = json.loads(body)
        # additive: the legacy fields survive, obs summaries ride along
        assert payload["status"] == "alive" and "obs" in payload
        assert any(k.startswith("pio_http_request_seconds")
                   for k in payload["obs"])

    def test_traces_endpoint_and_header_propagation(self, obs_engine_server):
        base = obs_engine_server["base"]
        trace.TRACES.clear()
        assert _query(base, {"user": "u1", "num": 2},
                      {"X-PIO-Trace": "feedbeef00000001"}) == 200
        status, _, body = _get(f"{base}/traces.json")
        assert status == 200
        traces = json.loads(body)["traces"]
        mine = [t for t in traces if t["traceId"] == "feedbeef00000001"]
        assert mine, traces
        names = [s["name"] for s in mine[0]["spans"]]
        assert "http.read_parse" in names
        assert "serve" in names
        assert mine[0]["status"] == 200


class TestMicroBatcherMetrics:
    def test_batch_metrics_populated(self, tmp_path):
        """A forced-engaged micro-batcher records batch sizes, queue
        waits, and dispatch timings; the engaged gauge reads 1."""
        server = _engine_server(
            tmp_path, batch_window_ms=40.0, dispatch_cost_s=0.005,
        )
        h_size = metrics.histogram("pio_batch_size")
        h_wait = metrics.histogram("pio_batch_queue_wait_seconds")
        size_before = h_size.merged()[2]
        wait_before = h_wait.merged()[2]
        port = server.start()
        try:
            assert server.batcher.engaged
            assert metrics.gauge("pio_batch_engaged").value() == 1.0
            threads = [
                threading.Thread(
                    target=_query,
                    args=(f"http://127.0.0.1:{port}", {"user": f"u{i}", "num": 3}),
                )
                for i in range(4)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            server.stop()
            server.storage.close()
        assert h_size.merged()[2] > size_before
        assert h_wait.merged()[2] >= wait_before + 4
        assert metrics.gauge("pio_batch_dispatch_cost_seconds").value() \
            == 0.005


# -- obs/device.py, restated for torch ------------------------------------------


class TestBuildTracker:
    """The counterpart of the JAX compile tracker: kernels/_build.py
    reports each first-use build of a CUDA source. Here the build itself
    is stubbed (no nvcc on this machine); the accounting is real."""

    @pytest.fixture()
    def fake_build(self, tmp_path, monkeypatch):
        from predictionio_tpu_torch.kernels import _build

        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build, "_libs", {})
        monkeypatch.setattr(_build, "_name_locks", {})
        monkeypatch.setattr(_build, "build_info", {})
        compiled = []

        def fake_compile(src, out):
            compiled.append(src.name)
            out.write_bytes(b"")
            return {"seconds": 0.25, "log": "", "cached": False}

        monkeypatch.setattr(_build, "_compile", fake_compile)
        monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
        return _build, compiled

    def test_one_compile_per_source_then_flat(self, fake_build):
        _build, compiled = fake_build
        before = obs_device.compile_snapshot().get(
            "topk", {"calls": 0, "compiles": 0, "cache_hits": 0}
        )
        for _ in range(5):  # first use builds; every later call is a hit
            _build.load("topk")  # in memory: no count at all
        after = obs_device.compile_snapshot()["topk"]
        assert compiled == ["topk.cu"]
        assert after["compiles"] - before["compiles"] == 1
        assert after["calls"] - before["calls"] == 1
        # a new process finds the library on disk: a cache hit, no nvcc
        _build._libs.clear()
        _build.load("topk")
        again = obs_device.compile_snapshot()["topk"]
        assert compiled == ["topk.cu"]
        assert again["cache_hits"] - after["cache_hits"] == 1
        assert again["compiles"] == after["compiles"]

    def test_counters_exported(self, fake_build):
        _build, _ = fake_build
        _build.load("als_solve")
        rendered = metrics.render_prometheus().decode()
        assert 'pio_jit_compiles_total{fn="als_solve"}' in rendered
        assert "pio_jit_compile_seconds_count" in rendered

    def test_disabled_is_a_passthrough(self):
        metrics.set_enabled(False)
        try:
            obs_device.count_build("test.disabled", 1.0, compiled=True)
            assert "test.disabled" not in obs_device.compile_snapshot()
        finally:
            metrics.set_enabled(True)

    def test_flat_after_warmup_under_load(self, tmp_path):
        """Warmup, then queries at batch sizes 1..8: no build is counted
        (the port compiles nothing per shape; on the CPU nothing builds
        at all)."""
        server = _engine_server(tmp_path, batch_window_ms=25.0,
                                dispatch_cost_s=10.0)
        assert server.warmup() == 1
        snap = obs_device.compile_snapshot()
        port = server.start()
        try:
            for n in (1, 3, 8):
                threads = [
                    threading.Thread(
                        target=_query,
                        args=(f"http://127.0.0.1:{port}",
                              {"user": f"u{i % 6}", "num": 1 + i % 4}),
                    )
                    for i in range(n)
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
        finally:
            server.stop()
            server.storage.close()
        assert obs_device.compile_snapshot() == snap


class TestTransferAccounting:
    def test_device_factors_feed_count_transfer(self, tmp_path):
        """The deploy model put is counted once, at the model's first
        score (which warmup makes happen), with the factor tables'
        bytes."""
        server = _engine_server(tmp_path)
        try:
            [model] = server.models
            before = obs_device.transfer_totals().get("h2d.serve.model_put", 0)
            assert server.warmup() == 1
            after = obs_device.transfer_totals()["h2d.serve.model_put"]
            assert after - before == (
                model.user_factors.nbytes + model.item_factors.nbytes
            )
            server.warmup()  # tables already up: nothing moves
            assert obs_device.transfer_totals()["h2d.serve.model_put"] == after
            rendered = metrics.render_prometheus().decode()
            assert ('pio_device_transfer_bytes_total{direction="h2d",'
                    'op="serve.model_put"}') in rendered
        finally:
            server.stop()
            server.storage.close()

    def test_similar_product_catalog_counted(self):
        from predictionio_tpu_torch.data.bimap import BiMap
        from predictionio_tpu_torch.models import similarproduct as tsim

        model = tsim.SimilarProductModel(
            item_index=BiMap({"a": 0, "b": 1, "c": 2}),
            item_factors=np.ones((3, 4), np.float32),
            categories={},
        )
        before = obs_device.transfer_totals().get("h2d.serve.model_put", 0)
        model.device_factors(torch.device("cpu"))
        model.device_factors(torch.device("cpu"))
        after = obs_device.transfer_totals()["h2d.serve.model_put"]
        assert after - before == 3 * 4 * 4


@pytest.fixture()
def obs_app():
    """A bare server mounting only the obs routes — the surface every
    framework server shares."""
    router = Router()
    add_obs_routes(router)
    app = HTTPApp(router, host="127.0.0.1", port=0, name="obstest")
    port = app.start(background=True)
    yield f"http://127.0.0.1:{port}"
    app.stop()


class TestDeviceEndpoints:
    def test_memory_gauges_on_live_metrics(self, obs_app):
        """Per-device memory gauges are present on /metrics over a real
        socket: a process that has not initialised CUDA exports zeros
        plus a supported=0 flag, never missing, and never initialises
        CUDA for a scrape."""
        status, _, body = _get(f"{obs_app}/metrics")
        assert status == 200
        parsed = parse_prometheus(body)
        mem = {k: v for k, v in parsed.items()
               if k.startswith("pio_device_memory_bytes")}
        assert mem, sorted(parsed)
        assert {k.split('kind="')[1].rstrip('"}') for k in mem} == {
            "in_use", "reserved", "peak", "limit",
        }
        assert all(v == 0 for v in mem.values()), mem
        supported = {k: v for k, v in parsed.items()
                     if k.startswith("pio_device_memory_stats_supported")}
        assert supported and all(v == 0 for v in supported.values())
        assert any(k.startswith("pio_device_count") for k in parsed)
        assert not torch.cuda.is_initialized()

    def test_device_block_on_the_cpu(self):
        block = obs_device.device_block()
        assert block["torch"] == torch.__version__
        assert block["devices"] and all(
            d["memory"] is None for d in block["devices"]
        )
        assert isinstance(block["transfer_bytes"], dict)
        assert isinstance(block["jit"], dict)

    def test_traces_json_limit_and_since_ms(self, obs_app):
        trace.TRACES.clear()
        for i, dur in enumerate((0.5, 0.3, 0.1)):
            tr = trace.Trace(f"fabricated.{i}")
            tr.finish(200)
            tr.duration_s = dur
            trace.TRACES.offer(tr)
        status, _, body = _get(f"{obs_app}/traces.json")
        assert status == 200
        assert len(json.loads(body)["traces"]) == 3

        status, _, body = _get(f"{obs_app}/traces.json?limit=2")
        traces = json.loads(body)["traces"]
        # slowest-first ordering survives the cap
        assert [t["name"] for t in traces] == ["fabricated.0", "fabricated.1"]

        # all fabricated traces started just now: a future cutoff drops
        # them all, a past cutoff keeps them all
        far_future_ms = (trace.Trace("x").wall_start + 3600.0) * 1000.0
        status, _, body = _get(f"{obs_app}/traces.json?since_ms={far_future_ms}")
        assert json.loads(body)["traces"] == []
        status, _, body = _get(f"{obs_app}/traces.json?since_ms=0&limit=1")
        assert len(json.loads(body)["traces"]) == 1

        with pytest.raises(urllib.error.HTTPError) as err:
            _get(f"{obs_app}/traces.json?limit=nope")
        assert err.value.code == 400


class TestProgressFile:
    def test_atomic_under_concurrent_reader(self, tmp_path):
        """A reader polling the progress file while a writer republishes
        continuously never sees a torn/partial document."""
        path = str(tmp_path / "progress.json")
        pub = progress.ProgressPublisher(100, path=path, mesh="single")
        pub.publish(1)
        stop = threading.Event()
        errors: list[Exception] = []

        def writer():
            i = 2
            while not stop.is_set():
                pub.publish(i, rmse=1.0 / i, events_per_s=1e6,
                            segment_wall_s=0.5, checkpoint_epoch=i)
                i += 1

        def reader():
            while not stop.is_set():
                try:
                    doc = progress.read_progress(path)
                    # read_progress returns None only for missing or
                    # corrupt files; the file exists from the start
                    assert doc is not None
                    assert doc["total_iterations"] == 100
                    assert doc["state"] == "running"
                except Exception as e:  # pragma: no cover
                    errors.append(e)
                    return

        threads = [threading.Thread(target=writer),
                   threading.Thread(target=reader),
                   threading.Thread(target=reader)]
        for t in threads:
            t.start()
        import time as _time

        _time.sleep(0.4)
        stop.set()
        for t in threads:
            t.join()
        assert not errors, errors[0]
        # no stray tmp files leak from the atomic replace loop
        leftovers = [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
        assert leftovers == []

    def test_liveness(self, tmp_path):
        path = str(tmp_path / "p.json")
        pub = progress.ProgressPublisher(10, path=path)
        pub.publish(3)
        doc = progress.read_progress(path)
        assert progress.is_live(doc)  # our own pid, fresh
        assert doc["iteration"] == 3 and doc["eta_s"] is not None
        pub.done()
        assert not progress.is_live(progress.read_progress(path))
        # dead writer -> not live even in "running" state
        pub2 = progress.ProgressPublisher(10, path=path)
        pub2.publish(1)
        doc = progress.read_progress(path)
        doc["pid"] = 2 ** 30  # no such process
        assert not progress.is_live(doc)

    def test_corrupt_file_reads_as_none(self, tmp_path):
        path = tmp_path / "p.json"
        path.write_text("{not json")
        assert progress.read_progress(str(path)) is None
        assert progress.read_progress(str(tmp_path / "absent.json")) is None

    def test_tol_run_reports_bounds_not_predictions(self, tmp_path):
        """Under --tol the configured count is an upper bound: a live
        doc flags eta_is_bound, and a plateau stop pins
        total_iterations to the count actually run."""
        path = str(tmp_path / "p.json")
        pub = progress.ProgressPublisher(100, path=path, tol=1e-3,
                                         mesh="single")
        pub.publish(10)
        doc = progress.read_progress(path)
        assert doc["configured_iterations"] == 100
        assert doc["tol"] == 1e-3
        assert doc["eta_is_bound"] is True
        assert doc["early_stopped"] is False
        pub.done(12, early_stopped=True)
        doc = progress.read_progress(path)
        assert doc["state"] == "done"
        assert doc["early_stopped"] is True
        assert doc["total_iterations"] == 12
        assert doc["configured_iterations"] == 100
        assert doc["eta_is_bound"] is False
        # without --tol the ETA is a prediction, never flagged a bound
        pub2 = progress.ProgressPublisher(100, path=path, mesh="single")
        pub2.publish(10)
        doc = progress.read_progress(path)
        assert doc["eta_is_bound"] is False and doc["tol"] is None



class TestProfileSmoke:
    def test_capture_writes_a_chrome_trace(self, tmp_path):
        """A bounded torch.profiler capture (CPU activity here) writes
        a Chrome trace under the directory it reports."""
        out = str(tmp_path / "trace")
        summary = obs_device.profile_capture(0.2, out_dir=out, burn=True)
        assert summary["trace_dir"] == out
        assert summary["files"] > 0 and summary["bytes"] > 0
        path = os.path.join(out, obs_device.TRACE_FILE)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        assert any("mm" in str(e.get("name", "")) for e in events)

    def test_profile_route(self, obs_app, tmp_path):
        out = str(tmp_path / "route")
        req = urllib.request.Request(
            f"{obs_app}/profile?seconds=0.1&out={out}", data=b"", method="POST"
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 200
            assert json.loads(resp.read())["trace_dir"] == out
        assert os.path.exists(os.path.join(out, obs_device.TRACE_FILE))

    def test_concurrent_capture_refused(self, tmp_path):
        import time as _time

        first_started = threading.Event()
        results: list = []

        def long_capture():
            first_started.set()
            results.append(
                obs_device.profile_capture(
                    0.6, out_dir=str(tmp_path / "a"), burn=False
                )
            )

        t = threading.Thread(target=long_capture)
        t.start()
        first_started.wait()
        _time.sleep(0.1)  # let it take the lock
        with pytest.raises(RuntimeError):
            obs_device.profile_capture(0.1, out_dir=str(tmp_path / "b"))
        t.join()
        assert results and results[0]["trace_dir"].endswith("a")


class Test503TraceRegression:
    def test_swap_503_records_unavailable_span(self, tmp_path):
        """Queries rejected during a warmup-overlap swap must leave a
        trace (serve.unavailable span, status 503) in /traces.json."""
        server = _engine_server(tmp_path)
        port = server.start()
        try:
            trace.TRACES.clear()
            server._swapping.set()
            with pytest.raises(urllib.error.HTTPError) as err:
                _query(f"http://127.0.0.1:{port}", {"user": "u1", "num": 3})
            assert err.value.code == 503
            server._swapping.clear()

            status, _, body = _get(f"http://127.0.0.1:{port}/traces.json")
            assert status == 200
            traces = json.loads(body)["traces"]
            rejected = [
                t for t in traces
                if any(s["name"] == "serve.unavailable"
                       for s in t.get("spans", []))
            ]
            assert rejected, traces
            assert rejected[0]["status"] == 503
        finally:
            server.stop()
            server.storage.close()
