"""The port's SelfCleaningDataSource (``tests/test_self_cleaning.py``
restated for ``predictionio_tpu_torch``; mirrors reference
core/src/test/scala/.../SelfCleaningDataSourceTest coverage: window
filtering, property compression, de-duplication, persisted cleaning)."""

import json
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from predictionio_tpu_torch.core.self_cleaning import (
    EventWindow,
    SelfCleaningDataSource,
    clean_events,
    compress_properties,
    parse_duration,
    remove_duplicates,
    window_events,
)
from predictionio_tpu_torch.data.event import Event

@pytest.fixture()
def storage():
    """A fresh in-memory store of the port, installed as its singleton."""
    from predictionio_tpu_torch.data import storage as tstorage

    s = tstorage.test_storage()
    tstorage.set_storage(s)
    yield s
    tstorage.set_storage(None)


NOW = datetime(2020, 6, 1, tzinfo=timezone.utc)


def _ev(name, minutes_ago, entity="u1", props=None, entity_type="user"):
    return Event(
        event=name,
        entity_type=entity_type,
        entity_id=entity,
        properties=props or {},
        event_time=NOW - timedelta(minutes=minutes_ago),
    )


class TestParseDuration:
    def test_units(self):
        assert parse_duration("3 days") == timedelta(days=3)
        assert parse_duration("12h") == timedelta(hours=12)
        assert parse_duration("30 seconds") == timedelta(seconds=30)
        assert parse_duration("5 minutes") == timedelta(minutes=5)
        assert parse_duration("1500ms") == timedelta(milliseconds=1500)

    def test_invalid(self):
        with pytest.raises(ValueError):
            parse_duration("three days")
        with pytest.raises(ValueError):
            parse_duration("3 fortnights")


class TestWindow:
    def test_drops_old_plain_events(self):
        evs = [_ev("view", 10), _ev("view", 120)]
        out = window_events(evs, EventWindow(duration="1 hour"), now=NOW)
        assert out == [evs[0]]

    def test_property_events_survive_window(self):
        evs = [_ev("$set", 999, props={"a": 1}), _ev("$unset", 999, props={"a": None})]
        out = window_events(evs, EventWindow(duration="1 hour"), now=NOW)
        assert len(out) == 2

    def test_no_duration_is_identity(self):
        evs = [_ev("view", 10_000)]
        assert window_events(evs, EventWindow()) == evs


class TestCompress:
    def test_set_unset_replay(self):
        evs = [
            _ev("$set", 30, props={"a": 1, "b": 2}),
            _ev("$unset", 20, props={"b": None}),
            _ev("$set", 10, props={"c": 3}),
            _ev("view", 5),
        ]
        out = compress_properties(evs)
        sets = [e for e in out if e.event == "$set"]
        assert len(sets) == 1
        assert sets[0].properties.to_dict() == {"a": 1, "c": 3}
        assert sets[0].event_time == NOW - timedelta(minutes=10)
        assert [e for e in out if e.event == "view"]

    def test_later_set_wins(self):
        evs = [_ev("$set", 30, props={"a": 1}), _ev("$set", 10, props={"a": 9})]
        (out,) = compress_properties(evs)
        assert out.properties.to_dict() == {"a": 9}

    def test_entities_kept_separate(self):
        evs = [
            _ev("$set", 30, entity="u1", props={"a": 1}),
            _ev("$set", 20, entity="u2", props={"a": 2}),
            _ev("$set", 10, entity="u1", entity_type="item", props={"a": 3}),
        ]
        out = compress_properties(evs)
        assert len(out) == 3  # (user,u1), (user,u2), (item,u1)

    def test_single_set_passes_through_unchanged(self):
        e = _ev("$set", 30, props={"a": 1}).with_event_id("keep-me")
        (out,) = compress_properties([e])
        assert out.event_id == "keep-me"


class TestDedup:
    def test_duplicates_collapse_to_earliest(self):
        e1 = _ev("view", 30).with_event_id("first")
        e2 = _ev("view", 10).with_event_id("second")
        out = remove_duplicates([e2, e1])
        assert len(out) == 1
        assert out[0].event_id == "first"

    def test_distinct_events_survive(self):
        evs = [_ev("view", 30), _ev("buy", 30), _ev("view", 30, entity="u2")]
        assert len(remove_duplicates(evs)) == 3


class TestCleanEvents:
    def test_full_pipeline(self):
        evs = [
            _ev("$set", 9999, props={"a": 1}),
            _ev("$set", 9998, props={"b": 2}),
            _ev("view", 9997),  # outside window -> dropped
            _ev("view", 10),
            _ev("view", 10),  # duplicate
        ]
        window = EventWindow(
            duration="1 day", remove_duplicates=True, compress_properties=True
        )
        out = clean_events(evs, window, now=NOW)
        names = sorted(e.event for e in out)
        assert names == ["$set", "view"]
        set_ev = next(e for e in out if e.event == "$set")
        assert set_ev.properties.to_dict() == {"a": 1, "b": 2}

    def test_none_window_is_identity(self):
        evs = [_ev("view", 9999)]
        assert clean_events(evs, None, now=NOW) == evs


class TestPersistedCleaning:
    def _setup(self, storage):
        from predictionio_tpu_torch.data.storage import App

        app_id = storage.get_metadata_apps().insert(App(id=0, name="cleanapp"))
        app = storage.get_metadata_apps().get(app_id)
        dao = storage.get_events()
        dao.init(app.id)
        ids = []
        for e in [
            _ev("$set", 9999, props={"a": 1}),
            _ev("$set", 9998, props={"b": 2}),
            _ev("view", 9997),
            _ev("view", 10),
        ]:
            ids.append(dao.insert(e, app.id))
        return app, dao, ids

    def test_clean_persisted(self, storage):
        app, dao, _ = self._setup(storage)

        class DS(SelfCleaningDataSource):
            app_name = "cleanapp"
            event_window = EventWindow(duration="1 day", compress_properties=True)

        inserted, deleted = DS().clean_persisted_events(storage=storage, now=NOW)
        remaining = dao.find(app_id=app.id)
        names = sorted(e.event for e in remaining)
        assert names == ["$set", "view"]
        assert inserted == 1  # the compacted $set
        assert deleted == 3  # two original $sets + the out-of-window view
        set_ev = next(e for e in remaining if e.event == "$set")
        assert set_ev.properties.to_dict() == {"a": 1, "b": 2}

    def test_no_window_noop(self, storage):
        app, dao, _ = self._setup(storage)

        class DS(SelfCleaningDataSource):
            app_name = "cleanapp"
            event_window = None

        assert DS().clean_persisted_events(storage=storage, now=NOW) == (0, 0)
        assert len(dao.find(app_id=app.id)) == 4

    def test_read_cleaned_events_does_not_mutate_store(self, storage):
        app, dao, _ = self._setup(storage)

        class DS(SelfCleaningDataSource):
            app_name = "cleanapp"
            event_window = EventWindow(duration="1 day", compress_properties=True)

        out = DS().read_cleaned_events(storage=storage, now=NOW)
        assert sorted(e.event for e in out) == ["$set", "view"]
        assert len(dao.find(app_id=app.id)) == 4


# --- the port against the JAX package on the same seeded events ---

_WINDOWS = [
    None,
    ("30 minutes", False, False),
    ("30 minutes", True, False),
    ("30 minutes", False, True),
    ("2 hours", True, True),
]


def _seeded(cls, seed, n=80):
    """Property, delete and plain events over a few entities, with
    duplicates that differ only in id and times, from a numpy seed."""
    rng = np.random.default_rng(seed)
    t0 = NOW - timedelta(hours=3)
    out = []
    for k in range(n):
        kind = ("$set", "$unset", "$delete", "rate", "view", "buy")[int(rng.integers(0, 6))]
        etype = "item" if rng.random() < 0.3 else "user"
        eid = f"{etype[0]}{int(rng.integers(0, 5))}"
        t = t0 + timedelta(minutes=int(rng.integers(0, 180)), seconds=k)
        kw = {}
        if kind == "$set":
            props = {"a": int(rng.integers(0, 9)), "b": f"s{int(rng.integers(0, 3))}"}
        elif kind == "$unset":
            props = {("a", "b")[int(rng.integers(0, 2))]: None}
        elif kind == "rate":
            props = {"rating": float(rng.integers(1, 6))}
        else:
            props = {}
        if kind in ("rate", "view", "buy"):
            etype, eid = "user", f"u{int(rng.integers(0, 5))}"
            kw = {"target_entity_type": "item",
                  "target_entity_id": f"i{int(rng.integers(0, 4))}"}
        out.append(cls(event=kind, entity_type=etype, entity_id=eid, properties=props,
                       event_time=t, creation_time=t + timedelta(seconds=1),
                       event_id=f"e{k:03d}", **kw))
    for k in rng.choice(n, size=n // 4, replace=False):  # duplicates up to ids/times
        e = out[int(k)]
        t = e.event_time + timedelta(minutes=int(rng.integers(1, 20)))
        out.append(cls(event=e.event, entity_type=e.entity_type, entity_id=e.entity_id,
                       target_entity_type=e.target_entity_type,
                       target_entity_id=e.target_entity_id,
                       properties=e.properties.to_dict(), event_time=t,
                       creation_time=t, event_id=f"d{int(k):03d}"))
    return out


def _canon(events):
    return [json.dumps(e.to_dict(for_api=False), sort_keys=True) for e in events]


def _window(mod, spec):
    if spec is None:
        return None
    duration, dedup, compress = spec
    return mod.EventWindow(duration=duration, remove_duplicates=dedup,
                           compress_properties=compress)


class TestAgainstTheJaxPackage:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_the_folds_equal_the_jax_packages(self, seed):
        from predictionio_tpu.core import self_cleaning as jsc
        from predictionio_tpu.data.event import Event as JEvent

        from predictionio_tpu_torch.core import self_cleaning as tsc

        tev, jev = _seeded(Event, seed), _seeded(JEvent, seed)
        assert _canon(tev) == _canon(jev)
        assert _canon(tsc.compress_properties(tev)) == _canon(jsc.compress_properties(jev))
        assert _canon(tsc.remove_duplicates(tev)) == _canon(jsc.remove_duplicates(jev))
        for spec in _WINDOWS:
            tw, jw = _window(tsc, spec), _window(jsc, spec)
            if tw is not None:
                assert (_canon(tsc.window_events(tev, tw, now=NOW))
                        == _canon(jsc.window_events(jev, jw, now=NOW)))
            assert (_canon(tsc.clean_events(tev, tw, now=NOW))
                    == _canon(jsc.clean_events(jev, jw, now=NOW)))

    @pytest.mark.parametrize("spec", _WINDOWS)
    def test_a_persisted_clean_leaves_the_jax_packages_store(self, spec):
        from predictionio_tpu.core import self_cleaning as jsc
        from predictionio_tpu.data import storage as jstorage
        from predictionio_tpu.data.event import Event as JEvent

        from predictionio_tpu_torch.core import self_cleaning as tsc
        from predictionio_tpu_torch.data import storage as tstorage

        def run(storage_mod, sc, cls):
            s = storage_mod.test_storage()
            app_id = s.get_metadata_apps().insert(storage_mod.App(0, "cleanapp"))
            dao = s.get_events()
            dao.init(app_id)
            original = _seeded(cls, 7)
            for e in original:
                dao.insert(e, app_id)
            ds = type("DS", (sc.SelfCleaningDataSource,),
                      {"app_name": "cleanapp", "event_window": _window(sc, spec)})
            counts = ds().clean_persisted_events(storage=s, now=NOW)
            ids = {e.event_id for e in original}
            # a compacted event gets a fresh random id: compare it without one
            left = sorted(
                json.dumps({k: v for k, v in e.to_dict(for_api=False).items()
                            if k != "eventId" or v in ids}, sort_keys=True)
                for e in dao.find(app_id=app_id))
            return counts, left

        assert run(tstorage, tsc, Event) == run(jstorage, jsc, JEvent)
