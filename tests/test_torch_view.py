"""The port's deprecated batch views (``tests/test_view.py`` restated for
``predictionio_tpu_torch``; reference data/.../view/*.scala)."""

import json
import warnings
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App
from predictionio_tpu_torch.data.view import (
    DataView,
    EventSeq,
    LBatchView,
    PBatchView,
    ViewPredicates,
)

T0 = datetime(2016, 1, 1, tzinfo=timezone.utc)


@pytest.fixture()
def storage():
    """A fresh in-memory store of the port, installed as its singleton."""
    from predictionio_tpu_torch.data import storage as tstorage

    s = tstorage.test_storage()
    tstorage.set_storage(s)
    yield s
    tstorage.set_storage(None)


@pytest.fixture()
def app_with_events(storage):
    app_id = storage.get_metadata_apps().insert(App(0, "ViewApp"))
    events = storage.get_events()
    events.init(app_id)
    for i, e in enumerate(
        [
            Event(event="$set", entity_type="user", entity_id="u1",
                  properties={"a": 1, "b": 2}),
            Event(event="$set", entity_type="user", entity_id="u1",
                  properties={"a": 3}),
            Event(event="$unset", entity_type="user", entity_id="u1",
                  properties={"b": None}),
            Event(event="$set", entity_type="item", entity_id="i1",
                  properties={"price": 9}),
            Event(event="rate", entity_type="user", entity_id="u1",
                  target_entity_type="item", target_entity_id="i1",
                  properties={"rating": 4.0}),
        ]
    ):
        events.insert(
            Event(**{**e.__dict__, "event_time": T0 + timedelta(minutes=i)}),
            app_id,
        )
    return app_id


class TestLBatchView:
    def test_emits_deprecation_warning(self, app_with_events, storage):
        with pytest.warns(DeprecationWarning):
            LBatchView(app_with_events, storage=storage)

    def test_aggregate_properties_replays_ops(self, app_with_events, storage):
        with pytest.warns(DeprecationWarning):
            view = LBatchView(app_with_events, storage=storage)
        props = view.aggregate_properties(entity_type="user")
        assert set(props) == {"u1"}
        assert dict(props["u1"]) == {"a": 3}  # b unset, a overwritten

    def test_time_window(self, app_with_events, storage):
        with pytest.warns(DeprecationWarning):
            view = LBatchView(
                app_with_events,
                until_time=T0 + timedelta(minutes=1, seconds=30),
                storage=storage,
            )
        assert len(view.events) == 2

    def test_pbatchview_is_alias(self, app_with_events, storage):
        with pytest.warns(DeprecationWarning):
            view = PBatchView(app_with_events, storage=storage)
        assert dict(view.aggregate_properties("item")["i1"]) == {"price": 9}


class TestEventSeq:
    def test_filter_and_fold(self, app_with_events, storage):
        with pytest.warns(DeprecationWarning):
            view = LBatchView(app_with_events, storage=storage)
            rates = view.events.filter(event_name="rate")
            assert len(rates) == 1
            counts = view.events.filter(entity_type="user").aggregate_by_entity_ordered(
                0, lambda acc, e: acc + 1
            )
        assert counts == {"u1": 4}

    def test_predicates(self):
        e = Event(event="rate", entity_type="user", entity_id="u1")
        with pytest.warns(DeprecationWarning):
            assert ViewPredicates.event_name("rate")(e)
            assert not ViewPredicates.entity_type("item")(e)
            assert ViewPredicates.start_time(None)(e)


class TestDataView:
    def test_typed_projection_drops_none(self, app_with_events, storage):
        with pytest.warns(DeprecationWarning):
            view = LBatchView(app_with_events, storage=storage)
            rows = DataView.create(
                view.events,
                lambda e: (e.entity_id, e.properties["rating"])
                if e.event == "rate"
                else None,
            )
        assert rows == [("u1", 4.0)]


class TestRegressions:
    def test_mutable_init_not_shared_across_entities(self, app_with_events, storage):
        """A mutable fold init (e.g. a list the op appends to) must be
        copied per entity, not shared."""
        with pytest.warns(DeprecationWarning):
            view = LBatchView(app_with_events, storage=storage)
            out = view.events.aggregate_by_entity_ordered(
                [], lambda acc, e: (acc.append(e.event), acc)[1]
            )
        assert set(out) == {"u1", "i1"}
        assert out["i1"] == ["$set"]
        assert out["u1"] == ["$set", "$set", "$unset", "rate"]


# --- the port against the JAX package on the same seeded store ---

def _seeded(cls, seed, n=60):
    """$set/$unset/$delete and rate/view events over a few entities, from a
    numpy seed, with explicit ids and times."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        kind = ("$set", "$unset", "$delete", "rate", "view")[int(rng.integers(0, 5))]
        etype = "item" if rng.random() < 0.4 else "user"
        eid = f"{etype[0]}{int(rng.integers(0, 4))}"
        kw = {}
        if kind == "$set":
            props = {"a": int(rng.integers(0, 9)), "b": float(rng.integers(0, 3))}
        elif kind == "$unset":
            props = {("a", "b")[int(rng.integers(0, 2))]: None}
        elif kind == "rate":
            props = {"rating": float(rng.integers(1, 6))}
        else:
            props = {}
        if kind in ("rate", "view"):
            etype, eid = "user", f"u{int(rng.integers(0, 4))}"
            kw = {"target_entity_type": "item",
                  "target_entity_id": f"i{int(rng.integers(0, 4))}"}
        t = T0 + timedelta(minutes=int(rng.integers(0, 120)), seconds=k)
        out.append(cls(event=kind, entity_type=etype, entity_id=eid, properties=props,
                       event_time=t, creation_time=t, event_id=f"e{k:03d}", **kw))
    return out


def _views(seed, **window):
    """The same events in each package's memory store, read through its
    LBatchView and PBatchView: ((port L, port P), (JAX L, JAX P))."""
    from predictionio_tpu.data import storage as jstorage
    from predictionio_tpu.data import view as jview
    from predictionio_tpu.data.event import Event as JEvent

    from predictionio_tpu_torch.data import storage as tstorage
    from predictionio_tpu_torch.data import view as tview

    out = []
    for storage_mod, view_mod, cls in ((tstorage, tview, Event),
                                       (jstorage, jview, JEvent)):
        s = storage_mod.test_storage()
        app_id = s.get_metadata_apps().insert(storage_mod.App(0, "ViewApp"))
        s.get_events().init(app_id)
        for e in _seeded(cls, seed):
            s.get_events().insert(e, app_id)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            out.append((view_mod.LBatchView(app_id, storage=s, **window),
                        view_mod.PBatchView(app_id, storage=s, **window)))
    return out


def _canon(events):
    return [json.dumps(e.to_dict(for_api=False), sort_keys=True) for e in events]


def _read(view, data_view):
    """Everything a caller reads off one view, as canonical JSON."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        props = {et or "*": {eid: dict(dm) for eid, dm in
                             view.aggregate_properties(et).items()}
                 for et in ("user", "item", None)}
        rates = view.events.filter(event_name="rate")
        late = view.events.filter(start_time=T0 + timedelta(hours=1),
                                  predicate=lambda e: e.entity_type == "user")
        ordered = view.events.aggregate_by_entity_ordered(
            [], lambda acc, e: (acc.append([e.event, e.event_id]), acc)[1])
        rows = data_view.create(
            view.events,
            lambda e: (e.entity_id, e.target_entity_id, e.properties["rating"])
            if e.event == "rate" else None)
    return json.dumps({"events": _canon(view.events), "props": props,
                       "rates": _canon(rates), "late": _canon(late),
                       "ordered": ordered, "rows": rows}, sort_keys=True)


class TestAgainstTheJaxPackage:
    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("window", [
        {},
        {"start_time": T0 + timedelta(minutes=30)},
        {"until_time": T0 + timedelta(minutes=90)},
    ])
    def test_views_read_what_the_jax_packages_read(self, seed, window):
        from predictionio_tpu.data import view as jview

        from predictionio_tpu_torch.data import view as tview

        (tl, tp), (jl, jp) = _views(seed, **window)
        assert len(tl.events) > 0
        assert _read(tl, tview.DataView) == _read(jl, jview.DataView)
        assert _read(tp, tview.DataView) == _read(jp, jview.DataView)
