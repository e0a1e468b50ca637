"""Two-stage retrieval in the port (``predictionio_tpu_torch/ops/retrieval.py``)
on the CPU, where K4 and K5 run their plain versions.

First, every single-device case of ``tests/test_retrieval.py`` restated
for the port: ``TestShortlistRecall`` (all three coarse modes),
``TestRescoreExactness``, the int8 summed-rows case of
``TestSatelliteOps``, ``TestTemplateTwoStage``'s recommendation and
similar-product cases (f32 and int8, threshold forced to 64, tile 128,
probe every 1), ``TestSubThresholdParity`` and ``TestStageSplit``. Then
the port against the JAX package on the same seeded numpy inputs: the
coarse tiles bit-equal (dense and int8 tables, a tile that does not
divide I), ``int8_dot`` shortlists bit-equal, ``int8`` and ``bf16``
shortlists within rtol 1e-5 with ids equal outside near ties, each
rescore form's ids equal and scores within rtol 1e-5 (the JAX rescore
dequantizes before its product, the port multiplies the int8 scale after
the sum as K2 does), and each template's two-stage ``batch_predict``
equal to the JAX package's on the same model (items; scores rtol 1e-5,
``tests/test_retrieval.py``'s ``_assert_same_results`` bar).

Not here, and waiting for their slices: ``TestMeshCoarse`` (the mesh
coarse ring and sharded two-stage serving, multi-GPU) and
``TestTemplateTwoStage``'s recommended-user and e-commerce cases (those
templates are not ported yet). The kernels themselves run only on the
card: ``chip_smoke.py`` phases ``k4``, ``k5``, ``retrieval``.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.models import similarproduct as jsim
from predictionio_tpu.ops import retrieval as jret
from predictionio_tpu.ops.als import quantize_rows
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models import recommendation as rec
from predictionio_tpu_torch.models import similarproduct as sp
from predictionio_tpu_torch.ops import retrieval
from predictionio_tpu_torch.ops.retrieval import CoarseCatalog
from predictionio_tpu_torch.ops.topk import gather_top_k_batch, sum_rows_top_k_batch
from predictionio_tpu_torch.server import jsonx

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6


def _dense(i, d, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(i, d)).astype(np.float32)


def _int8(i, d, seed=0):
    q, s = quantize_rows(_dense(i, d, seed))
    return np.array(q), np.array(s)


def _t(table):
    """A host table as CPU tensors (the int8 pair stays a pair)."""
    if isinstance(table, tuple):
        return tuple(torch.from_numpy(np.array(a)) for a in table)
    return torch.from_numpy(np.array(table))


def _exact_top(q, v, scales, k):
    """Numpy exact reference: ids of the top-k dequantized dot scores."""
    vf = v.astype(np.float32)
    if scales is not None:
        vf = vf * scales[:, None]
    sc = q @ vf.T
    return np.argsort(-sc, axis=1, kind="stable")[:, :k]


def _recall(cand, exact):
    cand = np.asarray(cand)
    hits = sum(
        len(set(cand[b].tolist()) & set(exact[b].tolist()))
        for b in range(exact.shape[0])
    )
    return hits / exact.size


def _near_tie_ids_ok(ids_a, ids_b, s_b) -> bool:
    """Ids of one row equal outside runs of adjacent scores closer than
    RTOL; inside a run the id sets match, except in the run that reaches
    the last position, which may hold other near-tied ids."""
    if np.array_equal(ids_a, ids_b):
        return True
    n = len(ids_b)
    close = np.abs(np.diff(s_b)) <= RTOL * np.maximum(np.abs(s_b[:-1]), np.abs(s_b[1:])) + ATOL
    start = 0
    for j in range(1, n + 1):
        if j == n or not close[j - 1]:
            if set(ids_a[start:j].tolist()) != set(ids_b[start:j].tolist()) and j != n:
                return False
            start = j
    return len(set(ids_a.tolist())) == n


# -- the JAX package's single-device cases, restated -----------------------------


class TestShortlistRecall:
    """Coarse pass coverage across storage modes; tile=256 on a 4096-row
    catalog forces the scan through 16 tiles (merge path exercised)."""

    @pytest.mark.parametrize("mode", ["bf16", "int8", "int8_dot"])
    def test_recall_at_default_oversample(self, mode):
        v, s = _int8(4096, 16, seed=1)
        q = _dense(8, 16, seed=2)
        exact = _exact_top(q, v, s, 8)
        cat = CoarseCatalog((v, s), tile=256, mode=mode)
        _, cand = cat.shortlist(q, 64)  # 8x oversample of k=8
        assert tuple(cand.shape) == (8, 64)
        assert _recall(cand, exact) >= 0.999

    def test_dense_catalog_bf16_copy(self):
        v = _dense(2048, 12, seed=3)
        q = _dense(4, 12, seed=4)
        exact = _exact_top(q, v, None, 8)
        cat = CoarseCatalog(v, tile=512)
        assert cat.mode == "bf16"
        _, cand = cat.shortlist(q, 64)
        assert _recall(cand, exact) >= 0.999

    def test_pad_tile_ids_never_returned(self):
        # 200 rows pad to one 256-wide tile; a 256-wide shortlist has
        # only 200 eligible rows, so 56 slots per row must come back -1
        v = _dense(200, 8, seed=5)
        cat = CoarseCatalog(v, tile=256)
        s, cand = cat.shortlist(_dense(3, 8, seed=6), 256)
        cand, s = cand.numpy(), s.numpy()
        valid = cand[cand >= 0]
        assert valid.max() < 200
        assert (cand < 0).sum() == 3 * 56
        assert (s[cand < 0] == np.float32(retrieval.NEG_INF)).all()
        for row in cand:
            vr = row[row >= 0]
            assert len(set(vr.tolist())) == vr.size  # no duplicates

    def test_shortlist_k_bucketing(self, monkeypatch):
        monkeypatch.setenv("PIO_RETRIEVAL_OVERSAMPLE", "8")
        monkeypatch.setenv("PIO_RETRIEVAL_TILE", str(1 << 18))
        # pow2(8 * pow2(k)); capped by the catalog's pow2 envelope
        assert retrieval.shortlist_k(5, 1 << 20) == 64
        assert retrieval.shortlist_k(8, 1 << 20) == 64
        assert retrieval.shortlist_k(9, 1 << 20) == 128
        assert retrieval.shortlist_k(8, 100) == 64  # pow2(100) = 128 > 64
        assert retrieval.shortlist_k(64, 80) == 128  # catalog envelope

    def test_engagement_threshold(self, monkeypatch):
        monkeypatch.setenv("PIO_RETRIEVAL_THRESHOLD", "1000")
        assert not retrieval.engaged(999)
        assert retrieval.engaged(1000)
        monkeypatch.setenv("PIO_RETRIEVAL_THRESHOLD", "0")
        assert not retrieval.engaged(10**9)  # <= 0 disables entirely


class TestRescoreExactness:
    """The rescore stage restricted to a full-coverage candidate set
    reproduces the exact ops' ranking -- in the port bit for bit, since
    K5 scores with K2's arithmetic."""

    def test_rescore_gather_matches_exact(self):
        for table in (_dense(256, 8, seed=7), _int8(256, 8, seed=7)):
            U = _t(_dense(32, 8, seed=8))
            V = _t(table)
            uixs = np.arange(4, dtype=np.int32)
            es, ei = gather_top_k_batch(uixs, U, V, k=8)
            # candidates = the whole catalog, shuffled per row
            rng = np.random.default_rng(9)
            cand = np.stack([rng.permutation(256) for _ in range(4)]).astype(np.int32)
            s, ids = retrieval.rescore_gather_top_k_batch(uixs, U, V, cand, k=8)
            np.testing.assert_array_equal(ids, ei.numpy())
            np.testing.assert_array_equal(s.view(np.int32), es.numpy().view(np.int32))

    def test_rescore_sum_rows_matches_exact(self):
        table = _t(_int8(200, 8, seed=10))
        ixs = np.array([[0, 3, 7, 0], [5, 5, 9, 0]], np.int32)
        w = np.array([[1, 1, 1, 0], [1, 0.5, 1, 0]], np.float32)
        es, ei = sum_rows_top_k_batch(ixs, w, table, k=8)
        cand = np.tile(np.arange(200, dtype=np.int32), (2, 1))
        s, ids = retrieval.rescore_sum_rows_top_k_batch(ixs, w, table, cand, k=8)
        np.testing.assert_array_equal(ids, ei.numpy())
        np.testing.assert_array_equal(s.view(np.int32), es.numpy().view(np.int32))

    def test_padded_candidates_report_minus_one(self):
        v = _t(_dense(64, 4, seed=11))
        q = _dense(2, 4, seed=12)
        cand = np.full((2, 16), -1, np.int32)
        cand[:, :3] = [[1, 2, 3], [10, 11, 12]]
        s, ids = retrieval.rescore_top_k_batch(q, v, cand, k=8)
        assert (ids[:, 3:] == -1).all()
        assert (s[:, 3:] == np.float32(retrieval.NEG_INF)).all()
        assert set(ids[0, :3].tolist()) == {1, 2, 3}

    def test_rescore_host_matches_device_rescore(self):
        v, sc = _int8(128, 8, seed=13)
        q = _dense(3, 8, seed=14)
        cand = np.stack(
            [np.random.default_rng(b).permutation(128)[:32] for b in range(3)]
        ).astype(np.int32)
        hs, hi = retrieval.rescore_host(q, v, sc, cand, 8)
        ds, di = retrieval.rescore_top_k_batch(q, _t((v, sc)), cand, k=8)
        np.testing.assert_array_equal(hi, di)
        np.testing.assert_allclose(hs, ds, rtol=1e-5, atol=1e-6)

    def test_near_ties_preserve_score_multiset(self):
        """Adversarial near-ties: 512 rows drawn from 16 archetypes plus
        1e-6 noise. Ids may legitimately differ between paths at equal
        scores, so compare the sorted score arrays instead."""
        rng = np.random.default_rng(15)
        arch = rng.normal(size=(16, 8)).astype(np.float32)
        v = (
            arch[rng.integers(0, 16, size=512)]
            + rng.normal(scale=1e-6, size=(512, 8))
        ).astype(np.float32)
        q = _dense(4, 8, seed=16)
        cat = CoarseCatalog(v, tile=128, mode="bf16")
        _, cand = cat.shortlist(q, 256)
        s, _ = retrieval.rescore_top_k_batch(q, _t(v), cand, k=16)
        full = np.tile(np.arange(512, dtype=np.int32), (4, 1))
        es, _ = retrieval.rescore_top_k_batch(q, _t(v), full, k=16)
        np.testing.assert_allclose(
            np.sort(s, axis=1), np.sort(np.asarray(es), axis=1),
            rtol=1e-4, atol=1e-5,
        )


class TestSatelliteOps:
    def test_sum_rows_accepts_int8_pair(self):
        vq, vs = _int8(96, 8, seed=17)
        dense = vq.astype(np.float32) * vs[:, None]
        ixs = np.array([[0, 5], [9, 9]], np.int32)
        w = np.ones((2, 2), np.float32)
        ds, di = sum_rows_top_k_batch(ixs, w, _t(dense), k=8)
        qs, qi = sum_rows_top_k_batch(ixs, w, _t((vq, vs)), k=8)
        np.testing.assert_array_equal(qi.numpy(), di.numpy())
        np.testing.assert_allclose(qs.numpy(), ds.numpy(), rtol=1e-5, atol=1e-6)


def _rec_models(i=512, d=8, users=16, int8=False, seed=22):
    """The same recommendation model in both packages."""
    U = _dense(users, d, seed=seed)
    if int8:
        V, S = _int8(i, d, seed=seed + 1)
    else:
        V, S = _dense(i, d, seed=seed + 1), None
    uids = [f"u{j}" for j in range(users)]
    iids = [f"i{j}" for j in range(i)]
    jm = jrec.ALSModel(user_index=JBiMap.from_dense(uids), item_index=JBiMap.from_dense(iids),
                       user_factors=U, item_factors=V, item_scales=S)
    tm = rec.ALSModel(user_index=BiMap.from_dense(uids), item_index=BiMap.from_dense(iids),
                      user_factors=U, item_factors=V, item_scales=S)
    return jm, tm


def _sim_models(n=512, d=8, int8=False, seed=23):
    if int8:
        vq, vs = _int8(n, d, seed=seed)
    else:
        vq, vs = _dense(n, d, seed=seed), None
    ids = [f"i{j}" for j in range(n)]
    jm = jsim.SimilarProductModel(item_index=JBiMap.from_dense(ids), item_factors=vq,
                                  categories={}, item_scales=vs)
    tm = sp.SimilarProductModel(item_index=BiMap.from_dense(ids), item_factors=vq,
                                categories={}, item_scales=vs)
    return jm, tm


def _rec_algo():
    algo = rec.ALSAlgorithm(rec.ALSAlgorithmParams())
    algo.device = CPU
    return algo


def _sim_algo():
    algo = sp.ALSAlgorithm(sp.ALSAlgorithmParams())
    algo.device = CPU
    return algo


def _assert_same_results(exact, two_stage, rtol=1e-4, atol=1e-5):
    """Same item lists, scores within tests/test_retrieval.py's bar
    (rtol 1e-4, atol 1e-5) or the one given."""
    assert len(exact) == len(two_stage)
    for (ix_a, ra), (ix_b, rb) in zip(
        sorted(exact, key=lambda t: t[0]),
        sorted(two_stage, key=lambda t: t[0]),
    ):
        assert ix_a == ix_b
        assert [x.item for x in ra.itemScores] == [x.item for x in rb.itemScores]
        np.testing.assert_allclose(
            [x.score for x in ra.itemScores], [x.score for x in rb.itemScores],
            rtol=rtol, atol=atol,
        )


REC_QUERIES = [
    (0, dict(user="u0", num=5)),
    (1, dict(user="u3", num=3)),
    (2, dict(user="zz", num=4)),  # unknown user in batch
    (3, dict(user="u7", num=8)),
]


def _two_stage_env(monkeypatch):
    monkeypatch.setenv("PIO_RETRIEVAL_THRESHOLD", "64")
    monkeypatch.setenv("PIO_RETRIEVAL_TILE", "128")  # multi-tile
    monkeypatch.setenv("PIO_RETRIEVAL_PROBE_EVERY", "1")


class TestTemplateTwoStage:
    """Each template's batch_predict, exact vs two-stage (threshold forced
    below the fixture catalogs): identical ids, matching scores; and the
    port's two-stage answers equal the JAX package's on the same model."""

    @pytest.mark.parametrize("int8", [False, True])
    def test_recommendation(self, monkeypatch, int8):
        jm, tm = _rec_models(int8=int8)
        algo = _rec_algo()
        queries = [(i, rec.Query(**q)) for i, q in REC_QUERIES]
        exact = algo.batch_predict(tm, queries)
        _two_stage_env(monkeypatch)
        before = retrieval.stats_block()
        two = algo.batch_predict(tm, queries)
        after = retrieval.stats_block()
        assert after["two_stage_queries"] == before["two_stage_queries"] + 3
        assert after["probes"] == before["probes"] + 1
        _assert_same_results(exact, two)
        jalgo = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams())
        jtwo = jalgo.batch_predict(jm, [(i, jrec.Query(**q)) for i, q in REC_QUERIES])
        _assert_same_results(jtwo, two, RTOL, ATOL)

    @pytest.mark.parametrize("int8", [False, True])
    def test_similarproduct_with_boundary_exclusions(self, monkeypatch, int8):
        jm, tm = _sim_models(int8=int8)
        algo = _sim_algo()
        # blackList the exact top results so the answer must come from
        # DEEPER in the shortlist than the unfiltered top-num
        probe = algo.batch_predict(tm, [(0, sp.Query(items=["i0"], num=6))])[0][1]
        top_ids = [x.item for x in probe.itemScores]
        spec = [
            (0, dict(items=["i0"], num=4, blackList=top_ids)),
            (1, dict(items=["i1", "i2"], num=5)),
            (2, dict(items=["i3"], num=3, whiteList=[f"i{j}" for j in range(40)])),
        ]
        queries = [(i, sp.Query(**q)) for i, q in spec]
        exact = algo.batch_predict(tm, queries)
        _two_stage_env(monkeypatch)
        before = retrieval.stats_block()
        two = algo.batch_predict(tm, queries)
        after = retrieval.stats_block()
        _assert_same_results(exact, two)
        # the blackListed query's answers avoid the exact top ids
        got = [x.item for x in dict(two)[0].itemScores]
        assert not set(got) & set(top_ids)
        # two simple queries went two-stage, the whiteList one stayed exact
        assert after["two_stage_queries"] == before["two_stage_queries"] + 2
        assert after["exact_queries"] == before["exact_queries"] + 1
        jalgo = jsim.ALSAlgorithm(jsim.ALSAlgorithmParams())
        jtwo = jalgo.batch_predict(jm, [(i, jsim.Query(**q)) for i, q in spec])
        _assert_same_results(jtwo, two, RTOL, ATOL)


class TestSubThresholdParity:
    def test_small_catalogs_never_touch_two_stage(self):
        """Below the default threshold the two-stage counter does not move
        and the answer is K2's, byte for byte, as with two-stage off."""
        _, tm = _rec_models(i=128)
        algo = _rec_algo()
        q = [(0, rec.Query(user="u0", num=4))]
        before = retrieval.stats_block()["two_stage_queries"]
        out = algo.batch_predict(tm, q)
        assert retrieval.stats_block()["two_stage_queries"] == before
        assert len(out[0][1].itemScores) == 4
        U, V = tm.device_factors(CPU)
        s, i = gather_top_k_batch(np.array([0], np.int32), U, V, 4)
        assert [x.item for x in out[0][1].itemScores] == [f"i{j}" for j in i[0].tolist()]
        assert [x.score for x in out[0][1].itemScores] == s[0].tolist()

    def test_sub_threshold_bytes_equal_two_stage_off(self, monkeypatch):
        for jm, tm in (_rec_models(), _rec_models(int8=True)):
            algo = _rec_algo()
            queries = [(i, rec.Query(**q)) for i, q in REC_QUERIES]
            below = algo.batch_predict(tm, queries)
            monkeypatch.setenv("PIO_RETRIEVAL_THRESHOLD", "0")
            off = algo.batch_predict(tm, queries)
            monkeypatch.delenv("PIO_RETRIEVAL_THRESHOLD")
            for (_, a), (_, b) in zip(below, off):
                assert jsonx.dumps_bytes(dataclasses.asdict(a)) == jsonx.dumps_bytes(
                    dataclasses.asdict(b))
            assert tm._coarse is None  # never built below the threshold

    def test_stats_block_shape(self):
        block = retrieval.stats_block()
        assert {"threshold", "oversample", "two_stage_queries",
                "exact_queries", "shortlist_size", "probe_recall"} <= set(block)
        assert set(block) == set(jret.stats_block())


class TestStageSplit:
    def test_take_stage_split_drains(self):
        v = _dense(300, 8, seed=27)
        cat = CoarseCatalog(v, tile=256)
        retrieval.take_stage_split()  # drain anything earlier
        _, cand = cat.shortlist(_dense(2, 8, seed=28), 32)
        retrieval.rescore_top_k_batch(_dense(2, 8, seed=28), _t(v), cand, k=8)
        split = retrieval.take_stage_split()
        assert split is not None
        assert split.get("shortlist", 0) > 0
        assert split.get("rescore", 0) > 0
        assert retrieval.take_stage_split() is None  # drained


# -- the port against the JAX package ------------------------------------------

TABLES = {
    "dense": lambda: _dense(1000, 16, seed=31),
    "int8": lambda: _int8(1000, 16, seed=31),
}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint8 if a.dtype.itemsize == 1 else np.uint32)


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("mode", ["int8", "int8_dot", "bf16"])
def test_coarse_tiles_bit_equal_to_the_jax_package(table, mode):
    """Tiles, scales and ids as the JAX package builds them: 1000 rows in
    tiles of 384 (the last one padded), bit for bit."""
    t = TABLES[table]()
    jc = jret.CoarseCatalog(t, tile=384, mode=mode)
    tc = CoarseCatalog(t, tile=384, mode=mode)
    assert (tc.tile, tc.mode, tc.num_rows) == (jc.tile, jc.mode, jc.num_rows)
    tiles = tc._tiles.view(torch.int16) if mode == "bf16" else tc._tiles
    np.testing.assert_array_equal(_bits(tiles.numpy()), _bits(np.asarray(jc._tiles)))
    if mode == "bf16":
        assert tc._scales is None and jc._scales is None
    else:
        np.testing.assert_array_equal(_bits(tc._scales.numpy()), _bits(np.asarray(jc._scales)))
    np.testing.assert_array_equal(tc.ids(), np.asarray(jc._ids))
    assert tc.nbytes() == jc.nbytes() - np.asarray(jc._ids).nbytes


def test_auto_mode_as_the_jax_package_off_a_tpu():
    assert CoarseCatalog(_dense(300, 4)).mode == "bf16"
    assert CoarseCatalog(_int8(300, 4)).mode == "int8"


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("mode", ["int8", "int8_dot", "bf16"])
def test_shortlists_match_the_jax_package(table, mode):
    """int8_dot sums int8 x int8 in int32 (exact), so its shortlist is
    bit-equal to the JAX package's; int8 and bf16 sum f32 in another
    order: scores within rtol 1e-5, ids equal outside near ties."""
    t = TABLES[table]()
    q = _dense(6, 16, seed=32)
    q[3] *= 1e-3  # a small query: int8_dot's quantization scale
    js, ji = jret.CoarseCatalog(t, tile=384, mode=mode).shortlist(q, 128)
    ts, ti = CoarseCatalog(t, tile=384, mode=mode).shortlist(q, 128)
    ts, ti = ts.numpy(), ti.numpy()
    if mode == "int8_dot":
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts.view(np.int32), np.asarray(js).view(np.int32))
    else:
        np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)
        for b in range(len(q)):
            assert _near_tie_ids_ok(ti[b], ji[b], js[b]), b


def test_k_at_or_above_the_catalog_matches_the_jax_package():
    """k' >= I: every row, then (NEG_INF, -1), as the JAX scan leaves it."""
    t = _int8(200, 8, seed=33)
    q = _dense(3, 8, seed=34)
    js, ji = jret.CoarseCatalog(t, tile=256, mode="int8_dot").shortlist(q, 256)
    ts, ti = CoarseCatalog(t, tile=256, mode="int8_dot").shortlist(q, 256)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_rescore_forms_match_the_jax_package(storage):
    """Each query form on candidates with -1 slots: ids equal, scores
    within rtol 1e-5."""
    V = _dense(400, 8, seed=35) if storage == "float32" else _int8(400, 8, seed=35)
    U = _dense(20, 8, seed=36) if storage == "float32" else _int8(20, 8, seed=36)
    rng = np.random.default_rng(37)
    cand = np.stack([rng.permutation(400)[:64] for _ in range(5)]).astype(np.int32)
    cand[:, 50:] = -1
    uixs = np.array([0, 3, 3, 19, 7], np.int32)
    vecs = _dense(5, 8, seed=38)
    row_ixs = np.array([[1, 2, 0], [4, 0, 0], [9, 9, 8], [10, 11, 12], [0, 0, 0]], np.int32)
    w = np.array([[1, 1, 0], [1, 0, 0], [1, 0.5, 1], [1, 1, 1], [1, 0, 0]], np.float32)
    jV = V
    pairs = [
        (jret.rescore_gather_top_k_batch(uixs, U, jV, cand, k=10),
         retrieval.rescore_gather_top_k_batch(uixs, _t(U), _t(V), cand, k=10)),
        (jret.rescore_top_k_batch(vecs, jV, cand, k=10),
         retrieval.rescore_top_k_batch(vecs, _t(V), cand, k=10)),
        (jret.rescore_sum_rows_top_k_batch(row_ixs, w, jV, cand, k=10),
         retrieval.rescore_sum_rows_top_k_batch(row_ixs, w, _t(V), cand, k=10)),
    ]
    for (js, ji), (ts, ti) in pairs:
        np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)
        for b in range(len(cand)):
            assert _near_tie_ids_ok(ti[b], np.asarray(ji)[b], np.asarray(js)[b])


def test_k4_plan():
    # the pair (the two-launch baseline), reached at any k' <= K4_MAX_K
    plan = retrieval.k4_plan(8, 10_000_000, 32, 128, sm_count=132, route="pair")
    assert (plan.route, plan.rb, plan.K, plan.S, plan.S2) == ("pair", 8, 128, 512, 2048)
    assert plan.W % retrieval.K4_TILE_THREADS == 0
    assert plan.nblk == -(-10_000_000 // plan.W) and plan.nblk * plan.W >= 10_000_000
    # a wide shortlist narrows the block's query rows to fit shared memory
    big = retrieval.k4_plan(64, 1_000_000, 32, retrieval.K4_MAX_K, sm_count=132, route="pair")
    assert big.route == "pair" and big.rb == 1 and big.S == 16384
    assert retrieval.k4_tile_smem(big.rb, big.S, 32) <= retrieval.K4_SMEM_CAP
    assert retrieval.k4_plan(1, 300, 8, 256, route="pair").nblk == 1
    # so does the stream route's: one query row a block at k' = 8,192
    big = retrieval.k4_plan(64, 1_000_000, 32, retrieval.K4_MAX_K, sm_count=132)
    assert big.route == "stream" and big.rb == 1 and big.S == 16384
    assert big.smem <= retrieval.K4_SMEM_CAP
    assert retrieval.k4_plan(1, 300, 8, 256).nblk == 1
    with pytest.raises(ValueError, match="K4_MAX_K"):
        retrieval.k4_plan(1, 10**6, 32, retrieval.K4_MAX_K + 1)
    # the warp route: one block an SM over the query groups, whole rounds a
    # warp, every warp at least 4 K rows, the workspace O(B * nblk * K)
    for B, I, k, groups in ((1, 10**6, 128, 1), (8, 10**6, 32, 1), (8, 10**7, 128, 1),
                            (64, 10**6, 128, 8), (64, 10**7, 32, 8)):
        for mode in retrieval.MODES:
            w = retrieval.k4_plan(B, I, 32, k, sm_count=132, mode=mode)
            assert (w.route, w.rb, w.K, w.nw) == ("warp", min(8, B), k, 8)
            assert w.nblk * groups <= 132 and w.nblk == -(-I // w.W)  # one wave
            assert w.W % (retrieval.K4_ROUND_ROWS * w.nw) == 0
            assert w.W // w.nw >= min(4 * k, -(-I // w.nw))
            assert w.smem == retrieval.k4_smem("warp", w.rb, w.nw, 32, mode, w.stages, k)
            assert w.smem <= retrieval.K4_SMEM_CAP and 2 <= w.stages <= retrieval.K4_MAX_STAGES
            assert B * w.nblk * w.K * 8 <= (8 * 132 + B) * w.K * 8
            stage = retrieval._warp_stage_bytes(32, mode)
            assert min(w.nw, w.rb) * w.mcols * w.nblk * 8 <= w.nw * w.stages * stage
    # 1M rows at B = 8: 131 blocks of 8 warps, 960 rows a warp
    w = retrieval.k4_plan(8, 10**6, 32, 128, sm_count=132)
    assert (w.nblk, w.W, w.nw, w.mcols) == (131, 7680, 8, 8)
    # wide rows take fewer warps, so that the rings fit shared memory
    assert retrieval.k4_plan(8, 10**6, 128, 128, sm_count=132).nw == 5
    assert retrieval.k4_plan(1, 200, 32, 128).nblk == 1
    with pytest.raises(ValueError, match="warp route"):
        retrieval.k4_plan(1, 10**6, 32, 256, route="warp")


@pytest.mark.parametrize("k, route", [(1, "warp"), (32, "warp"), (128, "warp"),
                                      (129, "stream"), (256, "stream"), (1024, "stream"),
                                      (8192, "stream")])
def test_k4_route(k, route):
    """k' <= K4_WARP_MAX_K takes the warp route, larger k' the stream
    route, each one launch, and k' above K4_MAX_K is refused."""
    assert retrieval.k4_route(k) == route
    assert retrieval.k4_launches(k) == 1


@pytest.mark.parametrize("k", [0, retrieval.K4_MAX_K + 1])
def test_k4_route_refuses(k):
    with pytest.raises(ValueError, match="K4_MAX_K"):
        retrieval.k4_route(k)


def test_k4_constants_match_the_kernel_source():
    import re
    from pathlib import Path

    src = (Path(retrieval.__file__).resolve().parent.parent / "csrc" / "retrieval.cu").read_text()
    consts = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["MAX_K"] == retrieval.K4_MAX_K
    assert consts["WARP_MAX_K"] == retrieval.K4_WARP_MAX_K
    assert consts["WARP_THREADS"] == retrieval.K4_WARP_THREADS
    assert 32 * consts["LANE_ROWS"] == retrieval.K4_ROUND_ROWS
    assert consts["QUEUE"] == retrieval.K4_QUEUE
    assert consts["MERGE_MAX_COLS"] == retrieval.K4_MERGE_MAX_COLS
    assert consts["MAX_STAGES"] == retrieval.K4_MAX_STAGES
    assert consts["TILE_THREADS"] == retrieval.K4_TILE_THREADS
    assert consts["RADIX"] == retrieval.K4_RADIX


def test_k4_cpu_calls_launch_no_kernel():
    """CPU tensors take the plain version: no call is counted on a mode,
    a route or the kernel launches; the stream-route baseline needs CUDA."""
    cat = CoarseCatalog(_dense(300, 8), tile=128, mode="bf16")
    counters = [retrieval.coarse_topk.launches, retrieval.coarse_topk.kernel_launches,
                *retrieval.coarse_topk.modes.values(), *retrieval.coarse_topk.routes.values()]
    before = [c.value for c in counters]
    cat.shortlist(_dense(2, 8, seed=1), 16)
    assert [c.value for c in counters] == before
    assert set(retrieval.coarse_topk.routes) == {"warp", "stream"}
    with pytest.raises(ValueError, match="device"):
        retrieval._coarse_topk_stream(torch.zeros((1, 8)), cat._tiles, None, 300, 16, "bf16")


# -- a numpy model of K4's warp route, held to the plain version --------------------


def _keys(s: np.ndarray) -> np.ndarray:
    """order_key's unsigned image of f32 scores, as uint64."""
    b = np.ascontiguousarray(s, dtype=np.float32).view(np.int32).astype(np.int64)
    key = np.where(b < 0, b ^ 0x7FFFFFFF, b)
    return ((key & 0xFFFFFFFF) ^ 0x80000000).astype(np.uint64)


def _composites(s: np.ndarray) -> list:
    """``order_key(s) << 32 | ~i`` for each row's scores, as Python ints."""
    i = np.arange(s.shape[-1], dtype=np.uint64)
    c = (_keys(s) << np.uint64(32)) | (~i & np.uint64(0xFFFFFFFF))
    return [[int(x) for x in row] for row in c]


def _score_of(c: int) -> float:
    key = ((c >> 32) ^ 0x80000000) & 0xFFFFFFFF
    key = key - (1 << 32) if key >= 1 << 31 else key
    bits = key ^ 0x7FFFFFFF if key < 0 else key
    return float(np.array([bits], np.int32).view(np.float32)[0])


def _model_scores(q, tiles, scales, num_rows, mode) -> np.ndarray:
    """The plain version's coarse scores of every catalog row, op for op
    (d in order, each product and partial sum rounded; int8_dot exact
    int32 sums), ``[B, num_rows]``."""
    D = tiles.shape[2]
    v = tiles.reshape(-1, D)[:num_rows]
    if mode == "int8_dot":
        qi = retrieval.quantize_queries(q).to(torch.int32)
        vi = v.to(torch.int32)
        acc = torch.zeros((q.shape[0], num_rows), dtype=torch.int32)
        for d in range(D):
            acc = acc + qi[:, d, None] * vi[None, :, d]
        sc = acc.to(torch.float32) * scales.reshape(-1)[:num_rows][None, :]
    else:
        vf = v.to(torch.float32)
        sc = torch.zeros((q.shape[0], num_rows), dtype=torch.float32)
        for d in range(D):
            sc = sc + q[:, d, None] * vf[None, :, d]
        if scales is not None:
            sc = sc * scales.reshape(-1)[:num_rows][None, :]
    return sc.numpy()


def _flush(lst, queue, L):
    return sorted(lst + queue, reverse=True)[:L]


def _kth(lst, K) -> int:
    return lst[K - 1] if len(lst) >= K else 0


def _model_warp_route(comps, plan, num_rows: int, k: int) -> list:
    """One query through the warp route as the kernel runs it: each block's
    warps stream their rows 64 a round (round-robin over the warps, one
    schedule of many) and admit composites above their threshold into a
    queue flushed past 64 entries (and at its last round) into a list of
    L = max(K, 32). The threshold: the list's K-th, the largest K-th any
    warp of the block published, and the smallest of the warps' ceil(K /
    nw)-th entries. The block keeps the top K of its warps' lists; the
    merge admits entries at or above the largest list K-th, column by
    column in batches of mcols, until a column admits nothing."""
    K, L, nw, R = plan.K, max(plan.K, 32), plan.nw, retrieval.K4_ROUND_ROWS
    floor = (int(_keys(np.float32([retrieval.NEG_INF]))[0]) << 32) | 0xFFFFFFFF
    share = -(-K // nw)
    blocks = []
    for x in range(plan.nblk):
        shared, pub = floor, [floor] * nw
        ranges = [(x * plan.W + w * (plan.W // nw), min(x * plan.W + (w + 1) * (plan.W // nw),
                                                        num_rows)) for w in range(nw)]
        state = [{"lst": [], "q": [], "th": floor} for _ in range(nw)]
        rounds = max(-(-(e - b) // R) if e > b else 0 for b, e in ranges)
        for j in range(rounds):
            for w, (b, e) in enumerate(ranges):
                st, i0 = state[w], b + j * R
                if i0 >= e:
                    continue
                st["th"] = max(st["th"], shared, min(pub))
                st["q"] += [c for c in comps[i0:min(i0 + R, e)] if c > st["th"]]
                if len(st["q"]) > retrieval.K4_QUEUE - R or (i0 + R >= e and st["q"]):
                    st["lst"] = _flush(st["lst"], st["q"], L)
                    kth = _kth(st["lst"], K)
                    st["q"], st["th"] = [], max(st["th"], kth)
                    if kth > floor:
                        shared = max(shared, kth)
                    if len(st["lst"]) >= share:
                        pub[w] = max(pub[w], st["lst"][share - 1])
        best = sorted(sum((st["lst"] for st in state), []), reverse=True)[:K]
        blocks.append(best + [0] * (K - len(best)))
    bound = max(b[K - 1] for b in blocks)
    th = bound - 1 if bound > floor else floor
    lst, queue, done = [], [], False
    for p0 in range(0, K, plan.mcols):
        for p in range(p0, p0 + plan.mcols):
            col = [b[p] for b in blocks]
            any_in = False
            for l0 in range(0, len(col), R):
                got = [c for c in col[l0:l0 + R] if c > th]
                queue += got
                any_in |= bool(got)
                if len(queue) > retrieval.K4_QUEUE - R:
                    lst, queue = _flush(lst, queue, L), []
                    th = max(th, _kth(lst, K))
            if not any_in:
                done = True
                break
        if done:
            break
    lst = _flush(lst, queue, L)[:k]
    return lst + [0] * (k - len(lst))


def _crafted_catalogs(mode: str):
    """(catalog, num_rows) cases: 50 distinct integer rows repeated (exact
    ties at every k' boundary) with a NaN row (row 777) and rows scoring
    at or below -1e30 (against the positive queries of the test); and 100
    random rows, 3 of them at or below -1e30, for k' >= I."""
    rng = np.random.default_rng(40)
    base = rng.integers(-3, 4, (50, 8)).astype(np.float32)
    out = []
    for f, low, tile in ((base[np.arange(5000) % 50], [11, 2047, 4990], 1024),
                         (_dense(100, 8, seed=42), [5, 50, 99], 64)):
        if mode == "bf16":
            f[low] = 0.0
            f[low, 0] = -3e33
            if len(f) > 777:
                f[777, 5] = np.nan
            out.append((CoarseCatalog(f, tile=tile, mode="bf16"), len(f)))
        else:
            vq = np.clip(np.rint(f * 30), -127, 127).astype(np.int8)
            vs = np.full(len(f), 0.5, np.float32)
            vq[low] = 0
            vq[low, 0] = -127
            vs[low] = 1e30
            if len(f) > 777:
                vs[777] = np.nan
            out.append((CoarseCatalog((vq, vs), tile=tile, mode=mode), len(f)))
    return out


@pytest.mark.parametrize("mode", ["int8", "int8_dot", "bf16"])
@pytest.mark.parametrize("B", [1, 8, 64])
def test_warp_route_model_bit_equal_to_the_plain_version(mode, B):
    """The warp route's partition (blocks, warps, rounds), its admission
    against shared thresholds and its pruned column merge give the plain
    version's answer bit for bit: ties at every k' boundary, a NaN row,
    rows at or below -1e30, k' >= I, at the plans k4_plan makes."""
    q = torch.from_numpy(np.abs(_dense(B, 8, seed=43)) + 0.25)
    for cat, n in _crafted_catalogs(mode):
        for k in (1, 17, 32, 100, 128):
            plan = retrieval.k4_plan(B, n, 8, k, sm_count=132, mode=mode)
            assert plan.route == "warp"
            s_p, i_p = retrieval.coarse_topk_reference(q, cat._tiles, cat._scales, n, k, mode)
            comps = _composites(_model_scores(q, cat._tiles, cat._scales, n, mode))
            for b in range(B):
                got = _model_warp_route(comps[b], plan, n, k)
                ids = [~c & 0xFFFFFFFF if c else -1 for c in got]
                sc = np.float32([_score_of(c) if c else retrieval.NEG_INF for c in got])
                np.testing.assert_array_equal(np.int32(ids), i_p[b].numpy(), err_msg=f"{k} {b}")
                np.testing.assert_array_equal(sc.view(np.int32), s_p[b].numpy().view(np.int32))
            # the crafted rows are in play: a NaN scale gives a NaN score,
            # first; the bf16 copy of a NaN value is a negative NaN (0xFFFF),
            # whose score sorts below -1e30 and never enters; nor do the
            # low rows
            ids = i_p.numpy()
            if n == 5000:
                assert (ids[:, 0] == 777).all() if mode != "bf16" else (ids != 777).all()
            elif k >= n:
                assert ((ids == -1).sum(axis=1) == k - 97).all()


def test_coarse_catalog_caches_drop_when_pickled():
    _, tm = _rec_models(i=300)
    tm.coarse_catalog(CPU)
    tm.device_factors(CPU)
    back = pickle.loads(pickle.dumps(tm))
    assert back._coarse is None and back._device is None
    assert back.coarse_catalog(CPU).num_rows == 300
    _, sm = _sim_models(n=300)
    sm.coarse_catalog(CPU)
    assert pickle.loads(pickle.dumps(sm))._coarse is None
