"""The port's fault-injection framework (``predictionio_tpu_torch/
faults/``), on the CPU: rule grammar, triggers, wildcard matching, env
activation, and the injected() test API.

The port's copy of ``tests/test_faults.py``. Its circuit-breaker cases
test ``common/breaker.py``, which serves the JAX package's router and
storage client, slices the port has not reached."""

from __future__ import annotations

import pytest

from predictionio_tpu_torch import faults


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
