"""The port's SLO engine (``predictionio_tpu_torch/obs/slo.py``), on the
CPU: golden multi-window burn-rate transitions against a synthetic clock
(no wall-clock flakiness), zero-tolerance counter decay,
latency-threshold bucket quantization, the PIO_OBS=0 inert path, reader
failure isolation, violation trace-tagging, and the batch side of the
freshness lineage on the port's engine server.

The port's copy of ``tests/test_slo.py``. Its speed-layer cases (ingest
-> fold-in patch commit, and the superseded-fold epoch-fence regression)
wait for the port's speed layer, a later slice.
"""

from __future__ import annotations

import numpy as np
import pytest

from predictionio_tpu_torch.core.workflow import save_instance
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.models import recommendation as trec
from predictionio_tpu_torch.obs import freshness, metrics
from predictionio_tpu_torch.obs import slo as slo_mod
from predictionio_tpu_torch.obs.slo import (
    BURNING,
    OK,
    VIOLATED,
    AvailabilitySlo,
    BoundSlo,
    LatencySlo,
    SloRegistry,
    ZeroCounterSlo,
)
from predictionio_tpu_torch.server.engine_server import EngineServer


class _Ctr:
    """Manual cumulative counter standing in for a metric instance."""

    def __init__(self):
        self.v = 0.0

    def value(self):
        return self.v


def _clock(t=0.0):
    state = {"t": t}

    def now():
        return state["t"]

    now.state = state
    return now


# ---------------------------------------------------------------------------
# golden burn-rate transitions (synthetic clock, exact tick-by-tick)
# ---------------------------------------------------------------------------


class TestBurnRateGolden:
    def test_availability_full_lifecycle(self):
        """100 req / 10 s ticks, objective 90%, burn threshold 5 (i.e.
        violated at >= 50% errors in BOTH windows), fast 30 s / slow
        120 s. Error burst from t=30: the exact transition times are

        - t=30  first bad tick     -> burning (fast burn 3.33)
        - t=40  both windows >= 5  -> violated
        - t=70  fast window clears -> burning (slow still 4.29)
        - t=160 slow window drains -> ok
        """
        total, bad = _Ctr(), _Ctr()
        s = AvailabilitySlo(
            "t.avail", total=total, bad=bad, objective=0.9,
            fast_window_s=30.0, slow_window_s=120.0, burn_threshold=5.0,
        )
        reg = SloRegistry(clock=_clock(), interval_s=10.0)
        reg.register(s)

        def tick(t, good_n, bad_n):
            total.v += good_n + bad_n
            bad.v += bad_n
            return reg.evaluate_all(now=t)

        expected = {
            0: OK, 10: OK, 20: OK,
            30: BURNING,
            40: VIOLATED, 50: VIOLATED, 60: VIOLATED,
            70: BURNING, 80: BURNING, 90: BURNING, 100: BURNING,
            110: BURNING, 120: BURNING, 130: BURNING, 140: BURNING,
            150: BURNING,
            160: OK,
        }
        for t in range(0, 170, 10):
            if 30 <= t <= 50:
                doc = tick(float(t), 0, 100)
            else:
                doc = tick(float(t), 100, 0)
            got = doc["slos"][0]["state"]
            assert got == expected[t], (t, doc["slos"][0])

        # the alert ring recorded exactly the four transitions, in order
        transitions = [(a["slo"], a["from"], a["to"], a["t"])
                       for a in doc["alerts"]]
        assert transitions == [
            ("t.avail", OK, BURNING, 30.0),
            ("t.avail", BURNING, VIOLATED, 40.0),
            ("t.avail", VIOLATED, BURNING, 70.0),
            ("t.avail", BURNING, OK, 160.0),
        ]

        # exported gauges track the final state
        assert metrics.gauge("pio_slo_state", slo="t.avail").value() == 0.0
        assert metrics.counter(
            "pio_slo_alerts_total", slo="t.avail"
        ).value() >= 1

    def test_exact_burn_numbers_at_violation(self):
        """At the t=40 violation tick: fast window err = 200/300, slow
        err = 200/400 -> burns 20/3 and 5.0 against budget 0.1."""
        total, bad = _Ctr(), _Ctr()
        s = AvailabilitySlo(
            "t.burn", total=total, bad=bad, objective=0.9,
            fast_window_s=30.0, slow_window_s=120.0, burn_threshold=5.0,
        )
        reg = SloRegistry(clock=_clock(), interval_s=10.0)
        reg.register(s)
        for t, (g, b) in zip(
            (0.0, 10.0, 20.0, 30.0, 40.0),
            ((100, 0), (100, 0), (100, 0), (0, 100), (0, 100)),
        ):
            total.v += g + b
            bad.v += b
            doc = reg.evaluate_all(now=t)["slos"][0]
        assert doc["state"] == VIOLATED
        # doc burns are rounded to 4 decimals
        assert doc["burn_fast"] == pytest.approx(200 / 300 / 0.1, rel=1e-4)
        assert doc["burn_slow"] == pytest.approx(5.0, rel=1e-6)
        assert doc["sli_fast"] == pytest.approx(1 / 3, abs=1e-5)
        assert doc["sli_slow"] == pytest.approx(0.5, abs=1e-6)

    def test_young_series_grows_in(self):
        """A series younger than the window judges what it has instead
        of reporting zeros: 100% errors on the very first ticks must
        already read as a full-rate burn."""
        total, bad = _Ctr(), _Ctr()
        s = AvailabilitySlo(
            "t.young", total=total, bad=bad, objective=0.9,
            fast_window_s=300.0, slow_window_s=3600.0, burn_threshold=5.0,
        )
        reg = SloRegistry(clock=_clock(), interval_s=10.0)
        reg.register(s)
        total.v, bad.v = 100.0, 100.0
        reg.evaluate_all(now=0.0)
        total.v, bad.v = 200.0, 200.0
        doc = reg.evaluate_all(now=10.0)["slos"][0]
        assert doc["state"] == VIOLATED
        assert doc["burn_fast"] == pytest.approx(10.0)

    def test_counter_reset_clamps_instead_of_negative(self):
        """A registry clear / server restart stepping cumulative
        counters backwards must clamp to zero, not alert on negative
        deltas."""
        total, bad = _Ctr(), _Ctr()
        s = AvailabilitySlo(
            "t.reset", total=total, bad=bad, objective=0.9,
            fast_window_s=30.0, slow_window_s=120.0, burn_threshold=5.0,
        )
        reg = SloRegistry(clock=_clock(), interval_s=10.0)
        reg.register(s)
        total.v = 1000.0
        reg.evaluate_all(now=0.0)
        total.v = 50.0  # restart: counter went backwards
        doc = reg.evaluate_all(now=10.0)["slos"][0]
        assert doc["state"] == OK
        assert doc["burn_fast"] == 0.0


class TestZeroCounterDecay:
    def test_single_bump_violated_then_burning_then_ok(self):
        """One acked-loss event: page immediately (zero tolerance),
        decay to burning once the bad tick ages out of the fast window,
        clear when it leaves the slow window."""
        c = _Ctr()
        s = ZeroCounterSlo(
            "t.zero", c,
            fast_window_s=30.0, slow_window_s=120.0,
        )
        reg = SloRegistry(clock=_clock(), interval_s=10.0)
        reg.register(s)
        expected = {
            0: OK, 10: OK, 20: OK,
            30: VIOLATED, 40: VIOLATED, 50: VIOLATED,
            60: BURNING, 70: BURNING, 80: BURNING, 90: BURNING,
            100: BURNING, 110: BURNING, 120: BURNING, 130: BURNING,
            140: BURNING,
            150: OK, 160: OK,
        }
        for t in range(0, 170, 10):
            if t == 30:
                c.v += 1  # the one loss
            doc = reg.evaluate_all(now=float(t))["slos"][0]
            assert doc["state"] == expected[t], (t, doc)
            assert doc["current"] == c.v
        # an infinite burn exports as the finite cap, not inf/NaN
        c.v += 1
        doc = reg.evaluate_all(now=170.0)["slos"][0]
        assert doc["state"] == VIOLATED
        assert doc["burn_fast"] == slo_mod._BURN_CAP


# ---------------------------------------------------------------------------
# latency SLO: bucket quantization
# ---------------------------------------------------------------------------


class TestLatencyQuantization:
    def test_threshold_quantizes_up_to_bucket_bound(self):
        h = metrics.Histogram("t_lat_seconds", "", bounds=(0.1, 0.2, 0.4))
        s = LatencySlo(
            "t.lat", h, threshold_s=0.25, objective=0.8,
            fast_window_s=30.0, slow_window_s=120.0, burn_threshold=5.0,
        )
        assert s.threshold_s == 0.25
        assert s.effective_threshold_s == 0.4  # quantized UP
        reg = SloRegistry(clock=_clock(), interval_s=10.0)
        reg.register(s)
        reg.evaluate_all(now=0.0)  # baseline tick: windows are deltas
        # 9 fast + 1 slow: 10% error rate vs 20% budget -> ok. The 0.3s
        # observation sits between threshold and effective bound: GOOD.
        for _ in range(8):
            h.observe(0.05)
        h.observe(0.3)
        h.observe(5.0)
        doc = reg.evaluate_all(now=10.0)["slos"][0]
        assert doc["state"] == OK
        assert doc["bad_fast"] == 1.0 and doc["total_fast"] == 10.0
        assert doc["threshold_s"] == 0.25
        assert doc["effective_threshold_s"] == 0.4
        # every request since the last tick blows the bound; the slow
        # window still carries the good head -> burning, not violated
        for _ in range(8):
            h.observe(5.0)
        doc = reg.evaluate_all(now=20.0)["slos"][0]
        assert doc["state"] == BURNING
        assert doc["bad_fast"] == 9.0 and doc["total_fast"] == 18.0

    def test_burn_math_against_budget(self):
        h = metrics.Histogram("t_lat2_seconds", "", bounds=(0.1, 0.2, 0.4))
        s = LatencySlo(
            "t.lat2", h, threshold_s=0.25, objective=0.8,
            fast_window_s=30.0, slow_window_s=120.0, burn_threshold=5.0,
        )
        reg = SloRegistry(clock=_clock(), interval_s=10.0)
        reg.register(s)
        reg.evaluate_all(now=0.0)  # baseline tick
        for _ in range(9):
            h.observe(0.05)
        for _ in range(9):
            h.observe(5.0)
        doc = reg.evaluate_all(now=10.0)["slos"][0]
        assert doc["burn_fast"] == pytest.approx(0.5 / 0.2, rel=1e-4)
        assert doc["state"] == BURNING


class TestBoundSlo:
    def test_tick_sampled_fraction(self):
        vals = iter([10.0, 10.0, 100.0, 10.0])
        s = BoundSlo(
            "t.bound", lambda: next(vals), bound=60.0, objective=0.6,
            fast_window_s=30.0, slow_window_s=120.0, burn_threshold=5.0,
        )
        reg = SloRegistry(clock=_clock(), interval_s=10.0)
        reg.register(s)
        states = [
            reg.evaluate_all(now=float(t))["slos"][0]
            for t in range(0, 40, 10)
        ]
        # the bad tick spikes the window to 1-of-2 out of bound (burn
        # 1.25 vs the 40% budget); the next good tick dilutes it back
        assert [d["state"] for d in states] == [OK, OK, BURNING, OK]
        assert states[2]["current"] == 100.0
        assert states[2]["bound"] == 60.0


# ---------------------------------------------------------------------------
# registry semantics: disable, reader failure, replace, trace tags
# ---------------------------------------------------------------------------


class TestRegistrySemantics:
    def test_obs_disabled_makes_engine_inert(self):
        total, bad = _Ctr(), _Ctr()
        reg = SloRegistry(clock=_clock(), interval_s=10.0)
        reg.register(AvailabilitySlo("t.off", total=total, bad=bad))
        prior = metrics.enabled()
        try:
            metrics.set_enabled(False)
            assert reg.evaluate_all() == {
                "enabled": False, "slos": [], "alerts": [],
            }
            assert reg.document() == {
                "enabled": False, "slos": [], "alerts": [],
            }
        finally:
            metrics.set_enabled(prior)
        assert reg.evaluate_all(now=0.0)["enabled"] is True

    def test_dead_reader_does_not_kill_the_tick(self):
        total, bad = _Ctr(), _Ctr()
        total.v = 10.0
        reg = SloRegistry(clock=_clock(), interval_s=10.0)

        def boom():
            raise RuntimeError("reader gone")

        reg.register(AvailabilitySlo("t.dead", total=boom, bad=bad))
        reg.register(AvailabilitySlo("t.live", total=total, bad=bad))
        docs = reg.evaluate_all(now=0.0)["slos"]
        by_name = {d["name"]: d for d in docs}
        assert "RuntimeError" in by_name["t.dead"]["error"]
        assert by_name["t.live"]["state"] == OK

    def test_register_replaces_by_name(self):
        reg = SloRegistry(clock=_clock(), interval_s=10.0)
        a = AvailabilitySlo("t.same", total=_Ctr(), bad=_Ctr())
        b = AvailabilitySlo("t.same", total=_Ctr(), bad=_Ctr())
        reg.register(a)
        reg.register(b)
        assert reg.names() == ["t.same"]
        reg.unregister("t.same")
        assert reg.names() == []

    def test_trace_tags_violations_and_slow_requests(self):
        h = metrics.Histogram("t_tag_seconds", "", bounds=(0.1, 0.2))
        reg = SloRegistry(clock=_clock(), interval_s=10.0)
        reg.register(LatencySlo(
            "t.tag.lat", h, threshold_s=0.2, objective=0.9,
            fast_window_s=30.0, slow_window_s=120.0,
        ))
        zero = _Ctr()
        reg.register(ZeroCounterSlo(
            "t.tag.zero", zero,
            fast_window_s=30.0, slow_window_s=120.0,
        ))
        reg.evaluate_all(now=0.0)
        # nothing violated: only an individually-slow request tags
        assert reg.trace_tags(0.05) == []
        assert reg.trace_tags(0.5) == ["t.tag.lat"]
        zero.v = 1.0
        reg.evaluate_all(now=10.0)
        assert reg.active_violations() == ("t.tag.zero",)
        assert reg.trace_tags(0.5) == ["t.tag.zero", "t.tag.lat"]
        reg.unregister("t.tag.lat")
        assert reg.trace_tags(0.5) == ["t.tag.zero"]


# ---------------------------------------------------------------------------
# freshness lineage, batch side, on the port's engine server
# ---------------------------------------------------------------------------


@pytest.fixture()
def deployed(tmp_path):
    """A deployed recommendation engine on the port (a 10-user, 6-item
    CPU model recorded as a COMPLETED instance)."""
    storage = tstorage.Storage(env={"PIO_FS_BASEDIR": str(tmp_path)})
    engine = trec.engine()
    ep = engine.params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": 4}}]}
    )
    rng = np.random.default_rng(0)
    model = trec.model_from_numpy(
        [f"u{u}" for u in range(10)], [f"i{i}" for i in range(6)],
        rng.standard_normal((10, 4)).astype(np.float32),
        rng.standard_normal((6, 4)).astype(np.float32),
    )
    iid = save_instance(engine, ep, [model], engine_id="slo-e2e", storage=storage)
    freshness.reset()
    server = EngineServer(
        engine, storage.get_metadata_engine_instances().get(iid),
        storage=storage, host="127.0.0.1", port=0, device="cpu",
    )
    port = server.start()
    yield {"base": f"http://127.0.0.1:{port}", "server": server}
    server.stop()
    storage.close()


class TestFreshnessLineage:
    def test_reload_records_batch_layer_freshness(self, deployed):
        """Deploying a trained model is itself a commit: the reload path
        stamps the train watermark into the lineage."""
        with freshness._lock:
            last = dict(freshness._last_commit or {})
        assert last.get("kind") == "reload"
        block = freshness.block()
        assert block["enabled"] is True
        assert block["last_commit"]["kind"] == "reload"

    def test_installed_default_slos_present(self, deployed):
        names = slo_mod.REGISTRY.names()
        for expected in (
            "engine.latency", "engine.availability",
            "engine.unavailable_503", "serving.freshness",
        ):
            assert expected in names
        doc = slo_mod.REGISTRY.evaluate_all()
        by_name = {d["name"]: d for d in doc["slos"]}
        # the freshness objective judges the seconds-scale histogram
        assert by_name["serving.freshness"]["effective_threshold_s"] >= \
            by_name["serving.freshness"]["threshold_s"]
