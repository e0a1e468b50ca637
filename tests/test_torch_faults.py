"""The port's fault-injection framework (``predictionio_tpu_torch/
faults/``), on the CPU: rule grammar, triggers, wildcard matching, env
activation, the injected() test API, and the circuit breaker
(``common/breaker.py``) whose backoff the fleet supervisor's restarts
and the speed layer's retries draw.

The port's copy of ``tests/test_faults.py``."""

from __future__ import annotations

import pytest

from predictionio_tpu_torch import faults
from predictionio_tpu_torch.common.breaker import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    CircuitBreaker,
)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.clear()
    yield
    faults.clear()


class TestRuleGrammar:
    def test_point_only_defaults_to_always_raise(self):
        r = faults.parse_rule("storage.fsync")
        assert r.point == "storage.fsync"
        assert r.action == "raise" and r.exc is faults.FaultError
        assert r.nth is None and r.probability is None and r.times is None

    def test_full_spec(self):
        r = faults.parse_rule(
            "http.read:p=0.25,seed=7,times=2:raise=ConnectionResetError,boom"
        )
        assert r.probability == 0.25 and r.seed == 7 and r.times == 2
        assert r.exc is ConnectionResetError and r.message == "boom"

    def test_sleep_action(self):
        r = faults.parse_rule("serve.query:nth=3:sleep=250")
        assert r.nth == 3 and r.action == "sleep" and r.sleep_ms == 250.0

    def test_kill_action(self):
        assert faults.parse_rule("storage.write:kill").action == "kill"

    def test_bad_specs_rejected(self):
        for bad in ("", ":nth=1", "p.x:wat=1", "p.x:raise=NoSuchError"):
            with pytest.raises(ValueError):
                faults.parse_rule(bad)

    def test_plan_splits_on_semicolons(self):
        plan = faults.parse_plan(
            "storage.fsync:nth=2 ; http.read:sleep=1 ;"
        )
        assert [r.point for r in plan.rules] == ["storage.fsync", "http.read"]

    def test_known_points_catalogue_is_nonempty_and_described(self):
        assert len(faults.KNOWN_POINTS) >= 10
        assert all(desc for desc in faults.KNOWN_POINTS.values())


class TestTriggers:
    def test_noop_without_plan(self):
        faults.fault_point("storage.fsync")  # must not raise

    def test_nth_fires_exactly_once(self):
        with faults.injected("storage.fsync:nth=3") as plan:
            faults.fault_point("storage.fsync")
            faults.fault_point("storage.fsync")
            with pytest.raises(faults.FaultError):
                faults.fault_point("storage.fsync")
            faults.fault_point("storage.fsync")  # past nth: silent
        assert plan.fire_count("storage.fsync") == 1

    def test_times_bounds_always_rule(self):
        with faults.injected("storage.write:times=2") as plan:
            for _ in range(2):
                with pytest.raises(faults.FaultError):
                    faults.fault_point("storage.write")
            faults.fault_point("storage.write")
        assert plan.fire_count() == 2

    def test_probability_is_seeded_deterministic(self):
        def run(seed):
            fired = []
            with faults.injected(f"p.x:p=0.5,seed={seed}:sleep=0") as plan:
                for _ in range(32):
                    faults.fault_point("p.x")
                fired.append(plan.fire_count())
            return fired[0]

        a, b = run(7), run(7)
        assert a == b and 0 < a < 32
        assert run(8) != a or run(9) != a  # not constant across seeds

    def test_wildcard_prefix_matches_family(self):
        with faults.injected("storage.*:times=2") as plan:
            with pytest.raises(faults.FaultError):
                faults.fault_point("storage.write")
            faults.fault_point("http.read")  # different family
            with pytest.raises(faults.FaultError):
                faults.fault_point("storage.rename")
            faults.fault_point("storage.fsync")  # times exhausted
        assert plan.fire_count() == 2

    def test_first_matching_rule_wins(self):
        with faults.injected(
            "storage.fsync:times=1:sleep=0", "storage.*:raise"
        ):
            faults.fault_point("storage.fsync")  # sleep rule eats it
            with pytest.raises(faults.FaultError):
                faults.fault_point("storage.fsync")  # falls to wildcard

    def test_custom_exception_and_message(self):
        with faults.injected("x.y:raise=TimeoutError,too slow"):
            with pytest.raises(TimeoutError, match="too slow"):
                faults.fault_point("x.y")


class TestActivation:
    def test_env_plan(self, monkeypatch):
        monkeypatch.setenv("PIO_FAULTS", "a.b:nth=1;c.d:sleep=5")
        plan = faults.plan_from_env()
        assert [r.point for r in plan.rules] == ["a.b", "c.d"]
        monkeypatch.setenv("PIO_FAULTS", "   ")
        assert faults.plan_from_env() is None

    def test_injected_restores_previous_plan(self):
        outer = faults.install(faults.parse_plan("o.o:times=1"))
        with faults.injected("i.i:times=1"):
            assert faults.active_plan() is not outer
        assert faults.active_plan() is outer

    def test_install_and_clear(self):
        plan = faults.install(faults.parse_plan("x.x"))
        assert faults.active_plan() is plan
        faults.clear()
        assert faults.active_plan() is None

    def test_injection_increments_obs_counter(self):
        from predictionio_tpu_torch.obs import metrics as obs_metrics

        c = obs_metrics.counter(
            "pio_faults_injected_total",
            "Faults fired by the active FaultPlan",
            point="obs.probe", action="sleep",
        )
        before = c.value()
        with faults.injected("obs.probe:times=1:sleep=0"):
            faults.fault_point("obs.probe")
        assert c.value() == before + 1


class TestPortFaultPoints:
    """Every fault point the JAX package reaches in a ported module is
    reached by the port's copy too: a ``PIO_FAULTS`` plan naming it fires
    (the single-process cases of ``tests/test_modelfile.py`` and
    ``tests/test_storage.py``'s fault matrix)."""

    def test_env_plan_fires_in_a_ported_module(self, monkeypatch, tmp_path):
        from predictionio_tpu_torch.data.storage import base, localfs

        monkeypatch.setenv("PIO_FAULTS", "storage.rename:nth=1:raise=OSError")
        faults.install(faults.plan_from_env())
        models = localfs.LocalFSModels(
            localfs.LocalFSStorageClient({"path": str(tmp_path)}))
        with pytest.raises(OSError):
            models.insert(base.Model("m", b"payload"))
        assert faults.active_plan().fire_count("storage.rename") == 1

    def test_mmap_fault_falls_back_to_bytes(self, tmp_path):
        import numpy as np

        from predictionio_tpu_torch.models import modelfile
        from predictionio_tpu_torch.models.recommendation import model_from_numpy
        from predictionio_tpu_torch.obs import metrics as obs_metrics

        rng = np.random.default_rng(7)
        m = model_from_numpy([f"u{i}" for i in range(40)], [f"i{i}" for i in range(16)],
                             rng.normal(size=(40, 4)).astype(np.float32),
                             rng.normal(size=(16, 4)).astype(np.float32))
        p = tmp_path / "model.bin"
        p.write_bytes(modelfile.serialize([("arrays", m)], "t"))
        ctr = obs_metrics.counter(
            "pio_model_mmap_fallback_total",
            "model file loads that fell back from mmap to a byte read",
        )
        before = ctr.value()
        with faults.injected("serve.model_mmap:nth=1:raise=OSError") as plan:
            mf = modelfile.load_path(p)
        assert plan.fire_count("serve.model_mmap") == 1
        assert ctr.value() == before + 1
        np.testing.assert_array_equal(mf.entries()[0][1].user_factors, m.user_factors)
        modelfile.load_path(p)  # no plan: mmap, not counted
        assert ctr.value() == before + 1

    @pytest.mark.parametrize("point", ["storage.fsync", "storage.rename"])
    def test_localfs_publish_fault_leaves_no_model(self, tmp_path, point):
        from predictionio_tpu_torch.data.storage import base, localfs

        models = localfs.LocalFSModels(
            localfs.LocalFSStorageClient({"path": str(tmp_path)}))
        models.insert(base.Model("m", b"old"))
        with faults.injected(f"{point}:nth=1:raise=OSError") as plan:
            with pytest.raises(OSError):
                models.insert(base.Model("m", b"new"))
        assert plan.fire_count(point) == 1
        assert models.get("m").models == b"old"  # the publish never tore it
        models.insert(base.Model("m", b"new"))
        assert models.get("m").models == b"new"

    def test_sqlite_commit_fault_inserts_nothing(self, tmp_path):
        from predictionio_tpu_torch.data.event import Event
        from predictionio_tpu_torch.data.storage import sqlite

        client = sqlite.SQLiteStorageClient({"path": str(tmp_path / "e.db")})
        events = sqlite.SQLiteEvents(client)
        ev = [Event(event="rate", entity_type="user", entity_id=f"u{n}",
                    target_entity_type="item", target_entity_id="i",
                    properties={"rating": 1.0}) for n in range(3)]
        with faults.injected("storage.sqlite.commit:nth=2") as plan:
            events.batch_insert(ev[:1], 1)
            with pytest.raises(faults.FaultError):
                events.batch_insert(ev[1:], 1)
        assert plan.fire_count("storage.sqlite.commit") == 1
        assert [e.entity_id for e in events.find(1)] == ["u0"]
        client.close()

    @staticmethod
    def _file_log(kind, tmp_path, **cfg):
        from predictionio_tpu_torch.data.storage import jsonl, partitioned

        if kind == "jsonl":
            return jsonl.JSONLEvents(jsonl.JSONLStorageClient(
                {"path": str(tmp_path / "ev"), **cfg}))
        return partitioned.PartitionedEvents(partitioned.PartitionedStorageClient(
            {"path": str(tmp_path / "pev"), "partitions": 2, **cfg}))

    @staticmethod
    def _rate(user):
        from predictionio_tpu_torch.data.event import Event

        return Event(event="rate", entity_type="user", entity_id=user,
                     target_entity_type="item", target_entity_id="i",
                     properties={"rating": 1.0})

    @pytest.mark.parametrize("kind", ["jsonl", "partitioned"])
    def test_file_log_write_fault_rolls_the_append_back(self, tmp_path, kind):
        events = self._file_log(kind, tmp_path)
        events.insert(self._rate("u0"), 1)
        with faults.injected("storage.write:nth=1") as plan:
            with pytest.raises(faults.FaultError):
                events.insert(self._rate("u1"), 1)
        assert plan.fire_count("storage.write") == 1
        events.insert(self._rate("u2"), 1)
        assert sorted(e.entity_id for e in events.find(1)) == ["u0", "u2"]

    @pytest.mark.parametrize("kind", ["jsonl", "partitioned"])
    def test_file_log_fsync_fault_fails_the_ack(self, tmp_path, kind):
        """An always-fsync append whose covering fsync fails is not acked
        (the insert raises); the next append's fsync covers it."""
        events = self._file_log(kind, tmp_path)
        with faults.injected("storage.fsync:nth=1") as plan:
            with pytest.raises(faults.FaultError):
                events.insert(self._rate("u1"), 1)
        assert plan.fire_count("storage.fsync") == 1
        events.insert(self._rate("u2"), 1)
        assert "u2" in {e.entity_id for e in events.find(1)}

    @pytest.mark.parametrize("kind", ["jsonl", "partitioned"])
    def test_file_log_rename_fault_keeps_the_log(self, tmp_path, kind):
        """A failed rename (jsonl's compaction, partitioned's seal) leaves
        every acked event readable."""
        events = self._file_log(kind, tmp_path, segment_bytes=200)
        with faults.injected("storage.rename:nth=1") as plan:
            with pytest.raises(faults.FaultError):
                events.insert(self._rate("u0"), 1)
                events.insert(self._rate("u0"), 1)  # partitioned: seals here
                events.compact(1)  # jsonl: renames here
        assert plan.fire_count("storage.rename") == 1
        events.insert(self._rate("u1"), 1)
        assert {"u0", "u1"} <= {e.entity_id for e in events.find(1)}

    def test_tail_decode_fault_takes_the_object_path(self, tmp_path):
        from predictionio_tpu_torch.data.storage import colspans
        from predictionio_tpu_torch.realtime import EventTailer

        events = self._file_log("jsonl", tmp_path)
        events.insert(self._rate("pre"), 1)
        t = EventTailer(events, 1, columnar_config=colspans.DecodeConfig())
        events.insert(self._rate("u1"), 1)
        with faults.injected("tail.decode:nth=1") as plan:
            batch = t.poll_columnar()
        assert plan.fire_count("tail.decode") == 1
        assert [s for s in batch.segments if not isinstance(s, list)] == []
        assert [e.entity_id for s in batch.segments for e in s] == ["u1"]

    @pytest.mark.parametrize("tol,nth,fires", [(0.0, 1, 1), (0.0, 2, 0), (1e-12, 3, 1)])
    def test_device_dispatch_fires_in_als_train(self, tol, nth, fires):
        """Once a training (the JAX package's one fused dispatch), or once
        an iteration when ``tol > 0`` asks for per-iteration segments."""
        import numpy as np

        from predictionio_tpu_torch.ops import als

        rng = np.random.default_rng(3)
        rows = rng.integers(0, 12, 60).astype(np.int32)
        cols = rng.integers(0, 9, 60).astype(np.int32)
        vals = rng.integers(1, 6, 60).astype(np.float32)
        data = als.build_ratings_data(rows, cols, vals, 12, 9)
        params = als.ALSParams(rank=3, iterations=4, reg=0.1, seed=1)
        with faults.injected(f"device.dispatch:nth={nth}") as plan:
            if fires:
                with pytest.raises(faults.FaultError):
                    als.als_train(data, params, tol=tol, device="cpu")
            else:
                als.als_train(data, params, tol=tol, device="cpu")
        assert plan.fire_count("device.dispatch") == fires

    @pytest.mark.parametrize("tol,fires", [(0.0, 1), (1e-12, 0)])
    def test_device_dispatch_at_zero_iterations(self, tol, fires):
        """At ``iterations=0`` the JAX package still dispatches its fused
        program once when ``tol <= 0``, and no segment when ``tol > 0``."""
        import numpy as np

        from predictionio_tpu_torch.ops import als

        rng = np.random.default_rng(4)
        rows = rng.integers(0, 12, 60).astype(np.int32)
        cols = rng.integers(0, 9, 60).astype(np.int32)
        vals = rng.integers(1, 6, 60).astype(np.float32)
        data = als.build_ratings_data(rows, cols, vals, 12, 9)
        params = als.ALSParams(rank=3, iterations=0, reg=0.1, seed=1)
        with faults.injected("device.dispatch:nth=1") as plan:
            if fires:
                with pytest.raises(faults.FaultError):
                    als.als_train(data, params, tol=tol, device="cpu")
            else:
                als.als_train(data, params, tol=tol, device="cpu")
        assert plan.fire_count("device.dispatch") == fires


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class TestCircuitBreaker:
    def _breaker(self, **kw):
        clock = FakeClock()
        kw.setdefault("failure_threshold", 3)
        kw.setdefault("base_backoff_s", 2.0)
        kw.setdefault("jitter", 0.0)
        return CircuitBreaker("test", clock=clock, **kw), clock

    def test_trips_after_threshold_consecutive_failures(self):
        b, _ = self._breaker()
        for _ in range(2):
            b.record_failure()
        assert b.state == CLOSED and b.allow()
        b.record_failure()
        assert b.state == OPEN and not b.allow()

    def test_success_resets_consecutive_count(self):
        b, _ = self._breaker()
        b.record_failure()
        b.record_failure()
        b.record_success()
        b.record_failure()
        b.record_failure()
        assert b.state == CLOSED

    def test_half_open_then_close_on_success(self):
        b, clock = self._breaker()
        for _ in range(3):
            b.record_failure()
        assert not b.allow()
        clock.t += 2.0  # past base backoff (jitter=0)
        assert b.allow()
        assert b.state == HALF_OPEN
        b.record_success()
        assert b.state == CLOSED and b.allow()

    def test_half_open_failure_doubles_backoff(self):
        b, clock = self._breaker()
        for _ in range(3):
            b.record_failure()
        clock.t += 2.0
        assert b.allow()  # half-open trial
        b.record_failure()  # trial failed: re-open with doubled backoff
        assert b.state == OPEN
        clock.t += 2.0
        assert not b.allow()  # 2s is no longer enough
        clock.t += 2.0  # 4s total: 2 * base
        assert b.allow()

    def test_backoff_capped(self):
        b, clock = self._breaker(max_backoff_s=5.0)
        for _ in range(3):
            b.record_failure()
        for _ in range(6):  # many re-opens: backoff would be 2*2^6 uncapped
            clock.t += 5.0
            assert b.allow()
            b.record_failure()
        assert b.snapshot()["retry_in_s"] <= 5.0

    def test_jitter_is_seeded_and_bounded(self):
        vals = set()
        for _ in range(2):
            b = CircuitBreaker(
                "j", base_backoff_s=10.0, jitter=0.2, seed=3,
                clock=FakeClock(),
            )
            vals.add(round(b.backoff_s(), 9))
        assert len(vals) == 1  # same seed, same jitter
        assert 8.0 <= vals.pop() <= 12.0

    def test_snapshot_shape(self):
        b, _ = self._breaker()
        snap = b.snapshot()
        assert snap == {
            "state": CLOSED,
            "consecutive_failures": 0,
            "failures_total": 0,
            "trips_total": 0,
            "retry_in_s": 0.0,
        }

    def test_same_policy_as_the_jax_breaker(self):
        """One seed, one failure sequence: the port's breaker and
        ``backoff_interval`` give the JAX package's numbers."""
        import random

        from predictionio_tpu.common import breaker as jbreaker
        from predictionio_tpu_torch.common import breaker

        for attempt in range(1, 9):
            a, b = random.Random(5), random.Random(5)
            assert breaker.backoff_interval(attempt, base_s=0.5, max_s=30.0, jitter=0.2,
                                            rng=a) == jbreaker.backoff_interval(
                attempt, base_s=0.5, max_s=30.0, jitter=0.2, rng=b)
        ours = CircuitBreaker("p", base_backoff_s=2.0, jitter=0.3, seed=9, clock=FakeClock())
        theirs = jbreaker.CircuitBreaker("p", base_backoff_s=2.0, jitter=0.3, seed=9,
                                         clock=FakeClock())
        for _ in range(5):
            ours.record_failure()
            theirs.record_failure()
            assert ours.snapshot() == theirs.snapshot()
