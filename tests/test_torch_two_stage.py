"""Two-stage retrieval as one call (``ops/retrieval.py two_stage_top_k``)
on the CPU, where it runs K4's and K5's plain versions.

First the port against the JAX package on the same seeded numpy inputs:
``two_stage_top_k`` against the JAX ``CoarseCatalog.shortlist`` followed
by its ``rescore_*_top_k_batch``, for each query form, f32 and int8
item tables, every coarse mode, B in {1, 3, 8} and k' in {32, 128, 256,
512}: ids equal outside runs of near-tied scores and scores within rtol
1e-5 (the bar of ``tests/test_torch_retrieval.py``: the JAX package sums
in another order), bit-equal ids on a catalog of exact ties, and k'
past the catalog (-1 shortlist slots). Then numpy models of what the card
runs: the stream route's queues, flushes under the lock, thinning and radix cuts,
block-end sort and last-block merge, and the fused epilogue's selection,
each held bit for bit to the plain version at the plans ``k4_plan``
makes; ``k4_plan`` within 227 KB for every k' up to 8,192 at B up to 64;
the stage split and counters of a call; and each template's two-stage
branch served by ``two_stage_top_k``. The kernels themselves run only on
the card: ``chip_smoke.py`` phases ``k4``, ``retrieval``, ``retimes``.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import retrieval as jret
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models import ecommerce as ec
from predictionio_tpu_torch.models import recommendation as rec
from predictionio_tpu_torch.models import recommendeduser as ru
from predictionio_tpu_torch.models import similarproduct as sp
from predictionio_tpu_torch.ops import retrieval
from predictionio_tpu_torch.ops.retrieval import CoarseCatalog
from tests.test_torch_retrieval import (  # shared helpers: tables, near ties, composites
    ATOL,
    RTOL,
    _composites,
    _crafted_catalogs,
    _dense,
    _int8,
    _keys,
    _model_scores,
    _near_tie_ids_ok,
    _score_of,
    _t,
)

CPU = torch.device("cpu")


def _f32(table) -> np.ndarray:
    return table[0].astype(np.float32) * table[1][:, None] if isinstance(table, tuple) else table


# -- the port against the JAX package ---------------------------------------------

I_ROWS, D, TILE = 1000, 16, 512
I_SMALL = 300  # k' = 512 runs past it: -1 slots in the shortlist
USERS = 40


def _case(storage: str, seed: int, rows: int = I_ROWS):
    table = _dense(rows, D, seed) if storage == "float32" else _int8(rows, D, seed)
    users = _dense(USERS, D, seed + 1) if storage == "float32" else _int8(USERS, D, seed + 1)
    return table, users


def _queries(form: str, B: int, table, users, seed: int):
    """(coarse queries [B, D] f32, port kwargs, the JAX rescore call)."""
    rng = np.random.default_rng(seed)
    rows = table[0].shape[0] if isinstance(table, tuple) else table.shape[0]
    if form == "gather":
        uixs = rng.choice(USERS, B, replace=False).astype(np.int32)
        q = _f32(users)[uixs]
        kw = dict(user_ixs=uixs, user_factors=_t(users))

        def jax(cand, k):
            return jret.rescore_gather_top_k_batch(uixs, users, table, cand, k)
    elif form == "vectors":
        q = _dense(B, D, seed + 2)
        kw = dict(vectors=q)

        def jax(cand, k):
            return jret.rescore_top_k_batch(q, table, cand, k)
    else:
        ixs = rng.integers(0, rows, (B, 4)).astype(np.int32)
        w = np.ones((B, 4), np.float32)
        w[::2, 3] = 0.0  # weight-0 padding, as the templates pad
        q = (_f32(table)[ixs] * w[:, :, None]).sum(axis=1)
        kw = dict(row_ixs=ixs, row_weights=w)

        def jax(cand, k):
            return jret.rescore_sum_rows_top_k_batch(ixs, w, table, cand, k)
    return q.astype(np.float32), kw, jax


@pytest.mark.parametrize("kp", [32, 128, 256, 512])
@pytest.mark.parametrize("storage", ["float32", "int8"])
@pytest.mark.parametrize("form", ["gather", "vectors", "sum_rows"])
def test_two_stage_matches_the_jax_package(form, storage, kp):
    """``two_stage_top_k`` against the JAX shortlist then rescore, every
    coarse mode and B in {1, 3, 8}: the best k = k' / 8 with ids equal
    outside near ties and scores within rtol 1e-5. On the 300-row catalog
    at k' = 512 the call asks for all k' (K5 takes k <= S): the slots past
    the catalog's rows are (-1e30, -1) in both, and the best k' / 8 are
    held as above (the rest score near 0, where the JAX rescore's
    dequantize-first order leaves more than atol 1e-6 between them)."""
    k = max(1, kp // 8)
    for rows in (I_ROWS, I_SMALL):
        table, users = _case(storage, 50 + kp, rows)
        for mode in ("int8", "int8_dot", "bf16"):
            jc = jret.CoarseCatalog(table, tile=TILE, mode=mode)
            tc = CoarseCatalog(table, tile=TILE, mode=mode)
            for B in (1, 3, 8):
                q, kw, jax = _queries(form, B, table, users, 60 + B)
                kwant = kp if kp > rows else k
                _, cand = jc.shortlist(q, kp)
                js, ji = jax(cand, kwant)
                ts, ti = retrieval.two_stage_top_k(tc, q, kp, kwant, form, _t(table), **kw)
                assert ts.shape == ti.shape == (B, kwant)
                js, ji = np.asarray(js), np.asarray(ji)
                np.testing.assert_allclose(ts[:, :k], js[:, :k], rtol=RTOL, atol=ATOL)
                for b in range(B):
                    assert _near_tie_ids_ok(ti[b, :k], ji[b, :k], js[b, :k]), (mode, B, b)
                if kp > rows:
                    for got_s, got_i in ((ts, ti), (js, ji)):
                        assert (got_i[:, rows:] == -1).all() and (got_s[:, rows:] == -1e30).all()
                        assert (got_i[:, :rows] >= 0).all()


@pytest.mark.parametrize("storage", ["float32", "int8"])
@pytest.mark.parametrize("form", ["gather", "vectors", "sum_rows"])
def test_two_stage_ties_match_the_jax_package_bit_for_bit(form, storage):
    """A catalog of 25 distinct small-integer rows repeated: exact sums in
    any order, so every score ties with many others. Shortlist order
    (the lower id first on a tie) and rescore order (shortlist order on
    a tie) are the JAX package's, ids and scores bit for bit."""
    base = np.random.default_rng(70).integers(-3, 4, (25, D)).astype(np.float32)
    dense = base[np.arange(I_ROWS) % 25]
    table = dense if storage == "float32" else (dense.astype(np.int8),
                                                np.ones(I_ROWS, np.float32))
    users = base[:15] if storage == "float32" else (base[:15].astype(np.int8),
                                                     np.ones(15, np.float32))
    for mode in ("int8_dot", "bf16"):
        jc = jret.CoarseCatalog(table, tile=TILE, mode=mode)
        tc = CoarseCatalog(table, tile=TILE, mode=mode)
        for B, kp in ((1, 32), (3, 128), (8, 256)):
            rng = np.random.default_rng(71 + B)
            if form == "gather":
                uixs = rng.choice(15, B, replace=False).astype(np.int32)
                q = _f32(users)[uixs]
                kw = dict(user_ixs=uixs, user_factors=_t(users))
                js, ji = jret.rescore_gather_top_k_batch(uixs, users, table,
                                                         jc.shortlist(q, kp)[1], kp // 4)
            elif form == "vectors":
                q = base[rng.integers(0, 25, B)]
                kw = dict(vectors=q)
                js, ji = jret.rescore_top_k_batch(q, table, jc.shortlist(q, kp)[1], kp // 4)
            else:
                ixs = rng.integers(0, I_ROWS, (B, 2)).astype(np.int32)
                w = np.ones((B, 2), np.float32)
                q = (dense[ixs] * w[:, :, None]).sum(axis=1)
                kw = dict(row_ixs=ixs, row_weights=w)
                js, ji = jret.rescore_sum_rows_top_k_batch(ixs, w, table,
                                                           jc.shortlist(q, kp)[1], kp // 4)
            ts, ti = retrieval.two_stage_top_k(tc, q, kp, kp // 4, form, _t(table), **kw)
            np.testing.assert_array_equal(ti, np.asarray(ji))
            np.testing.assert_array_equal(ts.view(np.int32), np.asarray(js).view(np.int32))


def test_two_stage_notes_both_stages_and_counts():
    """One call: both stages in the split (summing to the call), the
    two-stage query count, the shortlist size; no kernel counted on the
    CPU."""
    table = _dense(600, 8, 80)
    cat = CoarseCatalog(table, tile=256)
    retrieval.take_stage_split()
    before = retrieval.stats_block()
    counters = [retrieval.coarse_topk.launches, retrieval.coarse_topk.kernel_launches,
                retrieval.rescore_top_k.launches, retrieval.rescore_top_k.kernel_launches,
                retrieval.two_stage_top_k.launches]
    seen = [c.value for c in counters]
    q = _dense(3, 8, 81)
    s, ids = retrieval.two_stage_top_k(cat, q, 64, 8, "vectors", _t(table), vectors=q)
    assert isinstance(s, np.ndarray) and s.dtype == np.float32 and ids.dtype == np.int32
    split = retrieval.take_stage_split()
    assert split["shortlist"] > 0 and split["rescore"] > 0
    after = retrieval.stats_block()
    assert after["two_stage_queries"] == before["two_stage_queries"] + 3
    assert after["shortlist_size"]["count"] == before["shortlist_size"]["count"] + 1
    assert [c.value for c in counters] == seen
    assert set(retrieval.two_stage_top_k.routes) == {"warp", "stream"}
    with pytest.raises(ValueError, match="device"):
        retrieval._coarse_topk_pair(torch.zeros((1, 8)), cat._tiles, None, 600, 16, "bf16")
    with pytest.raises(ValueError, match="query form"):
        retrieval.two_stage_top_k(cat, q, 64, 8, "rows", _t(table))


# -- each template's two-stage branch -------------------------------------------------


def test_templates_serve_two_stage_through_two_stage_top_k(monkeypatch):
    """The four templates' two-stage branches call ``two_stage_top_k``,
    once a dispatch, with their query form."""
    calls = []
    real = retrieval.two_stage_top_k

    def spy(catalog, queries, kp, k, form, item_factors, **kw):
        calls.append(form)
        return real(catalog, queries, kp, k, form, item_factors, **kw)

    monkeypatch.setattr(retrieval, "two_stage_top_k", spy)
    monkeypatch.setenv("PIO_RETRIEVAL_THRESHOLD", "64")
    monkeypatch.setenv("PIO_RETRIEVAL_TILE", "128")
    monkeypatch.setenv("PIO_RETRIEVAL_PROBE_EVERY", "0")
    n = 512
    ids = [f"i{j}" for j in range(n)]
    users = [f"u{j}" for j in range(8)]
    vf, uf = _dense(n, 8, 90), _dense(8, 8, 91)
    algo = rec.ALSAlgorithm(rec.ALSAlgorithmParams())
    algo.device = CPU
    model = rec.ALSModel(user_index=BiMap.from_dense(users), item_index=BiMap.from_dense(ids),
                         user_factors=uf, item_factors=vf, item_scales=None)
    out = algo.batch_predict(model, [(0, rec.Query(user="u0", num=4)),
                                     (1, rec.Query(user="u1", num=3))])
    assert calls == ["gather"] and len(out[0][1].itemScores) == 4
    salgo = sp.ALSAlgorithm(sp.ALSAlgorithmParams())
    salgo.device = CPU
    smodel = sp.SimilarProductModel(item_index=BiMap.from_dense(ids), item_factors=vf,
                                    categories={}, item_scales=None)
    salgo.batch_predict(smodel, [(0, sp.Query(items=["i0"], num=4))])
    assert calls[-1] == "sum_rows"
    ralgo = ru.ALSAlgorithm(ru.ALSAlgorithmParams())
    ralgo.device = CPU
    rmodel = ru.RecommendedUserModel(followed_index=BiMap.from_dense([f"u{j}" for j in range(n)]),
                                     followed_factors=vf)
    ralgo.batch_predict(rmodel, [(0, ru.Query(users=["u0", "u1"], num=4))])
    assert calls[-1] == "sum_rows"
    ealgo = ec.ECommAlgorithm(ec.ECommAlgorithmParams(app_name="", rank=4, num_iterations=4,
                                                      unseen_only=False))
    ealgo.device = CPU
    emodel = ec.ECommModel(user_index=BiMap.from_dense(users), item_index=BiMap.from_dense(ids),
                           user_factors=uf, item_factors=vf, categories={})
    ealgo.batch_predict(emodel, [(0, ec.Query(user="u0", num=4))])
    assert calls == ["gather", "sum_rows", "sum_rows", "vectors"]


# -- k4_plan: every k' fits an H100's 227 KB ------------------------------------------


def test_k4_plan_fits_shared_memory_at_every_k_prime():
    """Every k' up to 8,192 (powers of two, either side of them, and the
    route boundary), B up to 64, each coarse mode, ranks 8 to 128, K4
    alone and fused with each item-table dtype: the block's shared memory
    within 227 KB, W whole rounds of every warp, the grid within one wave
    of 132 SMs where it can be, the merge's staged columns within the
    rings, and one launch."""
    kps = sorted({1, 17, 127, 128, 129, 8191, 8192,
                  *(1 << p for p in range(14)), *((1 << p) + 1 for p in range(1, 13))})
    kps = [k for k in kps if k <= retrieval.K4_MAX_K]
    for kp, B, mode, dim, v_dtype in itertools.product(
            kps, (1, 2, 3, 8, 9, 64), retrieval.MODES, (8, 10, 32, 128), (-1, 0, 1, 2)):
        for I in (300, 10**6):
            plan = retrieval.k4_plan(B, I, dim, kp, sm_count=132, mode=mode, v_dtype=v_dtype)
            assert plan.route == retrieval.k4_route(kp)
            assert plan.smem == retrieval.k4_smem(plan.route, plan.rb, plan.nw, dim, mode,
                                                  plan.stages, kp, v_dtype)
            assert plan.smem <= retrieval.K4_SMEM_CAP, (kp, B, mode, dim, v_dtype)
            assert plan.W % (retrieval.K4_ROUND_ROWS * plan.nw) == 0
            assert plan.nblk == -(-I // plan.W) and plan.K == retrieval._pow2(kp)
            groups = -(-B // plan.rb)
            assert plan.nblk * groups <= max(132, groups)
            ring = retrieval._k4_ring(dim, mode, plan.stages, v_dtype)
            staged = plan.mcols * plan.nblk * 8
            assert (min(plan.nw, plan.rb) * staged <= plan.nw * ring if plan.route == "warp"
                    else staged <= ring)
            assert 1 <= plan.mcols <= min(plan.K, retrieval.K4_MERGE_MAX_COLS)
            if v_dtype >= 0:
                assert ring >= retrieval.k5_epilogue_bytes(dim, v_dtype)
            if plan.route == "stream":
                assert plan.S == retrieval.k4_stream_cap(plan.K) >= 2 * plan.K
                assert plan.rb * dim * 4 <= plan.nw * plan.rb * retrieval.K4_QUEUE * 8
            assert retrieval.k4_launches(kp) == 1
    # the stream route's query rows a block shrink with k' (D = 32, bf16)
    assert [retrieval.k4_plan(8, 10**6, 32, kp).rb for kp in (256, 512, 1024, 2048, 4096, 8192)] \
        == [8, 8, 4, 2, 1, 1]


# -- numpy models of the stream route and the fused epilogue ---------------------------


FLOOR = (int(_keys(np.float32([retrieval.NEG_INF]))[0]) << 32) | 0xFFFFFFFF
REPORT_FLOOR = np.float32(-5e29)


def _model_cut(row: list, keep: int):
    """cut_row as the warp runs it: 8 bits a pass from the top, a
    histogram of the entries matching the prefix so far, lane l holding
    bins 255 - 8l .. 248 - 8l, an inclusive prefix over the lanes to find
    the lane and bin of the want-th largest; stop once its bin holds one
    entry, then keep the entries at or above it, in order."""
    prefix = mask = 0
    want = keep
    for shift in range(56, -1, -8):
        hist = [0] * 256
        for v in row:
            if v & mask == prefix:
                hist[(v >> shift) & 255] += 1
        c = [[hist[255 - 8 * lane - j] for j in range(8)] for lane in range(32)]
        tot = [sum(x) for x in c]
        incl = list(itertools.accumulate(tot))
        here = [lane for lane in range(32) if incl[lane] - tot[lane] < want <= incl[lane]]
        assert len(here) == 1
        lane = here[0]
        run = incl[lane] - tot[lane]
        for j in range(8):
            if run + c[lane][j] >= want:
                digit, above, count = 255 - 8 * lane - j, run, c[lane][j]
                break
            run += c[lane][j]
        want -= above
        prefix |= digit << shift
        mask |= 0xFF << shift
        if count == 1:
            break
    kth = next(v for v in row if v & mask == prefix)
    kept = [v for v in row if v >= kth]
    assert len(kept) == keep and kth == sorted(row, reverse=True)[keep - 1]
    return kept, kth


def _model_thin(row: list, lo_keep: int, hi_keep: int):
    """thin_row: 32 samples (lane l's at l * n / 32) sorted descending, a
    pivot sample picked to leave about (lo_keep + hi_keep) / 2 entries
    above it, moved one sample at a time (three tries) until the count
    above it lands in [lo_keep, hi_keep]; None when it does not."""
    n = len(row)
    if n < 64 or hi_keep - lo_keep < n // 16:
        return None
    smp = sorted((row[lane * n // 32] for lane in range(32)), reverse=True)
    r = ((lo_keep + hi_keep) // 2 * 32) // n - 1
    for _ in range(3):
        r = max(0, min(31, r))
        t = smp[r]
        above = sum(v > t for v in row)
        if above < lo_keep:
            r += 1
        elif above > hi_keep:
            r -= 1
        else:
            return [v for v in row if v > t], t
    return None


def _model_flush(st: dict, queue: list, K: int, cap: int) -> int:
    """stream_flush under the query's lock: when the queue's entries
    above the threshold could overflow the buffer, thin it to between K
    and cap - QUEUE entries above a sampled pivot, or else cut it to its
    best K; the pivot (or the least kept) is the new threshold."""
    if len(st["buf"]) + sum(v > st["thr"] for v in queue) > cap:
        thin = _model_thin(st["buf"], K, cap - retrieval.K4_QUEUE)
        if thin is None:
            st["buf"], st["thr"] = _model_cut(st["buf"], K)
            st["cuts"] += 1
        else:
            st["buf"], st["thr"] = thin
            st["thins"] += 1
        assert sum(v >= st["thr"] for v in st["buf"]) >= K  # none below it is in the top K
    st["buf"] += [v for v in queue if v > st["thr"]]
    assert len(st["buf"]) <= cap
    return st["thr"]


def _model_stream_route(comps: list, plan, num_rows: int, k: int, stats: dict) -> list:
    """One query through the stream route as the kernel runs it: each
    block's warps stream their rows 64 a round (round-robin over the
    warps: one order of the flushes the lock allows), admitting above
    their threshold (the block's, re-read each round) into queues flushed
    past 64 (and at their last round) into the block's buffer; at block
    end the buffer is cut to K and sorted. The last block's warp streams
    the lists column by column from the bound on the global K-th, in
    batches of mcols, through its queue into the buffer, until a column
    admits nothing; the buffer is cut to k' and sorted."""
    K, nw, R, Q = plan.K, plan.nw, retrieval.K4_ROUND_ROWS, retrieval.K4_QUEUE
    cap = retrieval.k4_stream_cap(K)
    blocks = []
    for x in range(plan.nblk):
        st = {"buf": [], "thr": FLOOR, "cuts": 0, "thins": 0}
        ranges = [(x * plan.W + w * (plan.W // nw),
                   min(x * plan.W + (w + 1) * (plan.W // nw), num_rows)) for w in range(nw)]
        th, queues = [FLOOR] * nw, [[] for _ in range(nw)]
        rounds = max(-(-(e - b) // R) if e > b else 0 for b, e in ranges)
        for j in range(rounds):
            for w, (b, e) in enumerate(ranges):
                i0 = b + j * R
                if i0 >= e:
                    continue
                th[w] = max(th[w], st["thr"])
                queues[w] += [c for c in comps[i0:min(i0 + R, e)] if c > th[w]]
                if len(queues[w]) > Q - R or (i0 + R >= e and queues[w]):
                    th[w] = max(th[w], _model_flush(st, queues[w], K, cap))
                    queues[w] = []
        buf = st["buf"]
        if len(buf) > K:
            buf, _ = _model_cut(buf, K)
        stats["cuts"] += st["cuts"]
        stats["thins"] += st["thins"]
        best = sorted(buf, reverse=True)
        blocks.append(best + [0] * (K - len(best)))
    bound = max(b[K - 1] for b in blocks)
    th = bound - 1 if bound > FLOOR else FLOOR
    st = {"buf": [], "thr": th, "cuts": 0, "thins": 0}
    queue, done = [], False
    for p0 in range(0, K, plan.mcols):
        for p in range(p0, p0 + plan.mcols):
            col = [b[p] for b in blocks]
            any_in = False
            for l0 in range(0, len(col), R):
                got = [v for v in col[l0:l0 + R] if v > th]
                queue += got
                any_in |= bool(got)
                if len(queue) > Q - R:
                    th = max(th, _model_flush(st, queue, K, cap))
                    queue = []
            if not any_in:
                done = True
                break
        if done:
            break
    if queue:
        _model_flush(st, queue, K, cap)
    buf = st["buf"]
    if len(buf) > k:
        buf, _ = _model_cut(buf, k)
    out = sorted(buf, reverse=True)
    return out + [0] * (k - len(out))


def _model_epilogue(exact: np.ndarray, cand: np.ndarray, k: int, warp_route: bool):
    """The fused epilogue's selection for one query: shortlist position j
    < k' gets composite(exact score, j), -1e30 for an empty slot. On the
    warp route each composite goes to output position rank (the number
    of composites above it); on the stream route the k' are cut to their
    best k (the radix cut), which are sorted. Output position r gives the
    score and, above -5e29, the id of the composite's shortlist
    position."""
    s = np.where(cand >= 0, exact, np.float32(retrieval.NEG_INF)).astype(np.float32)
    comps = _composites(s[None, :])[0]
    if warp_route:
        out = [0] * k
        for c in comps:
            rank = sum(o > c for o in comps)
            if rank < k:
                out[rank] = c
    else:
        kept = _model_cut(comps, k)[0] if len(comps) > k else comps
        out = sorted(kept, reverse=True)
    scores = np.float32([_score_of(c) for c in out])
    ids = np.int32([cand[~c & 0xFFFFFFFF] if sc > REPORT_FLOOR else -1
                    for c, sc in zip(out, scores)])
    return scores, ids


def _exact_scores(cat: CoarseCatalog, q: torch.Tensor, cand: torch.Tensor) -> np.ndarray:
    """K5's scores of the shortlist (the vectors form on the catalog's own
    f32 rows): d in order, each product and sum rounded."""
    vals = cat._tiles.reshape(-1, cat.dim).to(torch.float32)
    if cat._scales is not None:
        sc = cat._scales.reshape(-1)
    rows = vals[cand.clamp_min(0).long()]
    out = torch.zeros(cand.shape, dtype=torch.float32)
    for d in range(cat.dim):
        out = out + q[:, d, None] * rows[:, :, d]
    if cat._scales is not None:
        out = out * sc[cand.clamp_min(0).long()]
    return out.numpy()


@pytest.mark.parametrize("mode", ["int8", "int8_dot", "bf16"])
@pytest.mark.parametrize("sm_count", [132, 3])
def test_stream_route_model_bit_equal_to_the_plain_version(mode, sm_count):
    """The stream route's partition, admissions against the block's
    threshold, flushes that thin (or cut) the buffer, block-end cut and sort and pruned column
    merge give the plain version's shortlist bit for bit -- ties at every
    k' boundary, a NaN row, rows at or below -1e30, k' >= I -- at the
    plans k4_plan makes (three SMs: long blocks, so buffers are thinned). The
    fused epilogue's selection on that shortlist (the warp route's rank
    placement, the stream route's cut and sort) is the plain K5's."""
    B = 3
    q = torch.from_numpy(np.abs(_dense(B, 8, seed=43)) + 0.25)
    stats = {"cuts": 0, "thins": 0}
    for cat, n in _crafted_catalogs(mode):
        for kp in (17, 129, 256, 600):
            kp = min(kp, cat.tile)
            plan = retrieval.k4_plan(B, n, 8, kp, sm_count=sm_count, mode=mode, route="stream")
            s_p, i_p = retrieval.coarse_topk_reference(q, cat._tiles, cat._scales, n, kp, mode)
            comps = _composites(_model_scores(q, cat._tiles, cat._scales, n, mode))
            for b in range(B):
                got = _model_stream_route(comps[b], plan, n, kp, stats)
                ids = np.int32([~c & 0xFFFFFFFF if c else -1 for c in got])
                sc = np.float32([_score_of(c) if c else retrieval.NEG_INF for c in got])
                np.testing.assert_array_equal(ids, i_p[b].numpy(), err_msg=f"{kp} {b}")
                np.testing.assert_array_equal(sc.view(np.int32), s_p[b].numpy().view(np.int32))
            # the fused epilogue on the plain shortlist, against the plain K5
            k = max(1, kp // 4)
            vals = cat._tiles.reshape(-1, 8)[:n]
            table = (vals, cat._scales.reshape(-1)[:n]) if cat._scales is not None else vals
            ps, pi = retrieval.rescore_top_k_reference("vectors", table, i_p, k, vectors=q)
            exact = _exact_scores(cat, q, i_p)
            for b in range(B):
                es, ei = _model_epilogue(exact[b], i_p[b].numpy(), k,
                                         kp <= retrieval.K4_WARP_MAX_K)
                np.testing.assert_array_equal(ei, pi[b].numpy(), err_msg=f"{kp} {b}")
                np.testing.assert_array_equal(es.view(np.int32), ps[b].numpy().view(np.int32))
    if sm_count == 3:
        assert stats["thins"] > 0  # the long blocks thin their buffers


def test_cut_and_thin_models_keep_the_best():
    """cut_row's model on distinct composites with long common prefixes
    (tied scores, neighbouring ids) and spread ones: it keeps exactly the
    `keep` largest and returns the least of them."""
    rng = np.random.default_rng(44)
    tied = _composites(np.float32([np.full(700, 1.5)]))[0]
    spread = _composites(rng.normal(size=(1, 900)).astype(np.float32))[0]
    mixed = _composites(np.float32([rng.integers(-2, 3, 1000)]))[0]
    for row in (tied, spread, mixed):
        order = list(rng.permutation(len(row)))
        shuffled = [row[i] for i in order]
        for keep in (1, 2, 31, 256, len(row) - 1):
            kept, kth = _model_cut(shuffled, keep)
            assert sorted(kept) == sorted(row, reverse=True)[:keep][::-1]
        thin = _model_thin(shuffled, len(row) // 3, len(row) // 2)
        assert thin is not None  # the samples land in a window this wide
        kept, t = thin
        assert len(row) // 3 <= len(kept) <= len(row) // 2
        assert sorted(kept) == sorted(row, reverse=True)[:len(kept)][::-1]
        assert all(v > t for v in kept)
