"""The port's file-log stores against the JAX package's on the same bytes.

A jsonl log, a partitioned namespace (``_meta.json`` with its hash,
``active.jsonl``, sealed ``seg_NNNNNN.jsonl`` with their time sidecars,
``supersede.log``) and a columnar cache file written by either package
read the same in the other: ``find``, ``scan_ratings``' arrays and
``export_jsonl``'s bytes are equal, and so are the files each package
writes for the same operations (ids aside: generated ids are random but
keep the ``<pp>-<uuid>`` form, routed by FNV-1a). The files-mode tailer
cursor is held across the packages in ``tests/test_torch_realtime_files.py``.
"""

from __future__ import annotations

import io
import json
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import columnar_cache as jcolumnar_cache
from predictionio_tpu.data.storage import jsonl as jjsonl
from predictionio_tpu.data.storage import partitioned as jpartitioned
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import columnar_cache, jsonl, partitioned

APP = 3
T0 = datetime(2021, 5, 1, tzinfo=timezone.utc)


def _events(cls, n=120, seed=5):
    """Rates with explicit ids and times, a few replacements, ``$set``
    and ``buy`` lines, from a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        u, i = int(rng.integers(0, 17)), int(rng.integers(0, 11))
        out.append(cls(event="rate", entity_type="user", entity_id=f"u{u}",
                       target_entity_type="item", target_entity_id=f"i{i}",
                       properties={"rating": float(rng.integers(1, 6))},
                       event_time=T0 + timedelta(minutes=k), event_id=f"e{k:04d}",
                       creation_time=T0 + timedelta(minutes=k, seconds=1)))
    for k in range(0, n, 10):  # replacements: the last write wins
        out.append(cls(event="rate", entity_type="user", entity_id=f"u{k % 17}",
                       target_entity_type="item", target_entity_id="i0",
                       properties={"rating": 1.0}, event_time=T0 + timedelta(hours=9, minutes=k),
                       event_id=f"e{k:04d}",
                       creation_time=T0 + timedelta(hours=9, minutes=k)))
    out.append(cls(event="$set", entity_type="item", entity_id="i3",
                   properties={"genre": "x"}, event_time=T0, event_id="set0",
                   creation_time=T0))
    out.append(cls(event="buy", entity_type="user", entity_id="u1",
                   target_entity_type="item", target_entity_id="i9",
                   event_time=T0 + timedelta(days=1), event_id="buy0",
                   creation_time=T0 + timedelta(days=1)))
    return out


def _stores(kind, path):
    """(port DAO, JAX DAO) over one directory."""
    if kind == "jsonl":
        return (jsonl.JSONLEvents(jsonl.JSONLStorageClient({"path": str(path)})),
                jjsonl.JSONLEvents(jjsonl.JSONLStorageClient({"path": str(path)})))
    cfg = {"path": str(path), "partitions": 4, "segment_bytes": 2048}
    return (partitioned.PartitionedEvents(partitioned.PartitionedStorageClient(cfg)),
            jpartitioned.PartitionedEvents(jpartitioned.PartitionedStorageClient(cfg)))


def _obs(events):
    return sorted(json.dumps(e.to_dict(for_api=False), sort_keys=True) for e in events)


def _ratings(batch):
    return (list(batch.entity_ids), list(batch.target_ids), batch.rows.tolist(),
            batch.cols.tolist(), batch.vals.tolist())


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file() and not p.name.endswith(".lock")}


SCAN = dict(event_names=["rate", "buy"], override_ratings={"buy": 4.0})


@pytest.mark.parametrize("kind", ["jsonl", "partitioned"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_store_one_package_writes_reads_the_same_in_the_other(tmp_path, kind, writer):
    port, jax = _stores(kind, tmp_path / "ev")
    w, cls = (jax, JEvent) if writer == "jax" else (port, Event)
    for e in _events(cls):
        w.insert(e, APP)
    w.delete("e0005", APP)
    assert _obs(port.find(APP)) == _obs(jax.find(APP))
    assert port.get("e0007", APP).to_dict(for_api=False) == (
        jax.get("e0007", APP).to_dict(for_api=False))
    assert port.get("e0005", APP) is None and jax.get("e0005", APP) is None
    window = dict(start_time=T0 + timedelta(minutes=30), until_time=T0 + timedelta(minutes=70))
    assert _obs(port.find(APP, **window)) == _obs(jax.find(APP, **window))
    assert _ratings(port.scan_ratings(APP, **SCAN)) == _ratings(jax.scan_ratings(APP, **SCAN))
    out_p, out_j = io.BytesIO(), io.BytesIO()
    assert port.export_jsonl(APP, None, out_p) == jax.export_jsonl(APP, None, out_j)
    assert out_p.getvalue() == out_j.getvalue()


@pytest.mark.parametrize("kind", ["jsonl", "partitioned"])
def test_both_packages_write_the_same_files(tmp_path, kind):
    """The same inserts, deletes and compaction leave byte-identical
    files: logs, meta, segment sidecars, supersede logs, caches."""
    trees = {}
    for name, (port, jax) in (("port", _stores(kind, tmp_path / "p")),
                              ("jax", _stores(kind, tmp_path / "j"))):
        dao, cls = (port, Event) if name == "port" else (jax, JEvent)
        evs = _events(cls)
        for e in evs[:100]:
            dao.insert(e, APP)
        dao.delete("e0003", APP)
        for e in evs[100:]:
            dao.insert(e, APP)
        dao.scan_ratings(APP, **SCAN)  # proves clean, publishes the caches
        trees[name] = tmp_path / name[0]
    port_files, jax_files = _files(trees["port"]), _files(trees["jax"])
    assert port_files.keys() == jax_files.keys()
    for rel in port_files:
        if rel.endswith(columnar_cache.SUFFIX):
            # the header keys the cache to its log's mtime: equal but for it
            for blob in (port_files, jax_files):
                hlen = int.from_bytes(blob[rel][8:16], "little")
                hdr = json.loads(blob[rel][16:16 + hlen])
                hdr.pop("mtime_ns")
                blob[rel] = json.dumps(hdr).encode() + blob[rel][16 + hlen:]
        assert port_files[rel] == jax_files[rel], rel


@pytest.mark.parametrize("kind", ["jsonl", "partitioned"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_columnar_cache_one_package_writes_serves_the_other(tmp_path, kind, writer):
    """A warm scan in one package leaves cache files; the other package's
    warm scan maps them (no row read) and returns the same arrays."""
    port, jax = _stores(kind, tmp_path / "ev")
    for e in _events(JEvent if writer == "jax" else Event):
        (jax if writer == "jax" else port).insert(e, APP)
    (jax if writer == "jax" else port).compact(APP)
    first = (jax if writer == "jax" else port).scan_ratings(APP, **SCAN)
    caches = sorted((tmp_path / "ev").rglob("*" + columnar_cache.SUFFIX))
    assert caches
    reader, mod = (port, columnar_cache) if writer == "jax" else (jax, jcolumnar_cache)
    for c in caches:
        blocks = mod.load(c)
        assert blocks is not None and blocks.rating_key == "rating"
    loads = []
    real = mod.load

    def counted(path):
        loads.append(path)
        return real(path)

    mod.load = counted
    try:
        second = reader.scan_ratings(APP, **SCAN)
    finally:
        mod.load = real
    assert loads  # served from the other package's cache files
    assert _ratings(second) == _ratings(first)


def test_partition_routing_is_the_jax_packages():
    """Event ids route to the same partition: the ``<pp>-`` prefix, else
    FNV-1a of the id; generated ids embed FNV-1a of the entity."""
    ids = [f"{k:02x}-x" for k in range(8)] + [f"e{k}" for k in range(300)] + ["ü-ß", ""]
    for n in (1, 3, 8, 256):
        assert [partitioned.PartitionedEvents._route(i, n) for i in ids] == [
            jpartitioned.PartitionedEvents._route(i, n) for i in ids]
        keys = [f"user:u{k}" for k in range(100)]
        assert [partitioned.PartitionedEvents._hash_pp(k, n) for k in keys] == [
            jpartitioned.PartitionedEvents._hash_pp(k, n) for k in keys]


def test_generated_ids_keep_the_partition_form(tmp_path):
    port, jax = _stores("partitioned", tmp_path / "ev")
    e = Event(event="rate", entity_type="user", entity_id="u42",
              target_entity_type="item", target_entity_id="i1", properties={"rating": 2.0})
    eid = port.insert(e, APP)
    pp, _, rest = eid.partition("-")
    assert len(pp) == 2 and len(rest) == 32
    assert int(pp, 16) == jpartitioned.PartitionedEvents._hash_pp("user:u42", 4)
    assert jax.get(eid, APP).entity_id == "u42"
