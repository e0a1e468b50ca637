"""Exact item-item cosine top-n (``predictionio_tpu_torch/ops/cosine_sim.py``,
K6) against the JAX package's ``ops/cosine_sim.py``, on the CPU.

``tests/test_cosine_sim.py`` restated on the port, then both packages on
the same seeded numpy triples. Tolerances and their reasons:

- integer values (the template's view counts): scores bit for bit and
  ids equal, the ids of ``-inf`` padding included -- every Gram sum is an
  exact f32 integer, the norms are the same host numpy, and the division
  is one IEEE operation;
- fractional values: scores within atol 1e-5 (the JAX package's own bar,
  ``tests/test_cosine_sim.py``), ids equal outside runs of near-tied
  scores;
- a numpy model of K6 (its CSR/CSC layout, heaviest-first row order,
  column passes, user-ordered sums and composite-key selection) against
  the plain version: bit for bit on integer values, atol 1e-5 on
  fractional ones.

The kernel itself runs only on the card (``chip_smoke.py`` phase ``k6``
holds it to the plain version there); here a CPU call launches nothing.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import cosine_sim as jcs
from predictionio_tpu_torch.ops import cosine_sim as tcs


def _exact_cosine(dense):
    norms = np.linalg.norm(dense, axis=0)
    a = dense / np.maximum(norms, 1e-12)[None, :]
    sim = a.T @ a
    np.fill_diagonal(sim, -np.inf)
    sim[:, norms == 0] = -np.inf
    return sim


def _port(*a, **kw):
    return tcs.item_similarity_topn(*a, device="cpu", **kw)


class TestItemSimilarity:
    """tests/test_cosine_sim.py on the port."""

    def test_matches_numpy_exact(self):
        rng = np.random.default_rng(0)
        num_u, num_i, nnz = 40, 17, 300
        rows = rng.integers(0, num_u, nnz)
        cols = rng.integers(0, num_i, nnz)
        vals = rng.random(nnz).astype(np.float32)
        dense = np.zeros((num_u, num_i), np.float32)
        np.add.at(dense, (rows, cols), vals)
        scores, ids = _port(rows, cols, vals, num_u, num_i, top_n=5)
        exact = _exact_cosine(dense)
        for i in range(num_i):
            want = np.sort(exact[i])[::-1][:5]
            np.testing.assert_allclose(scores[i], want, atol=1e-5)

    def test_blocking_invariant(self):
        rng = np.random.default_rng(1)
        num_u, num_i, nnz = 30, 50, 400
        rows = rng.integers(0, num_u, nnz)
        cols = rng.integers(0, num_i, nnz)
        vals = np.ones(nnz, np.float32)
        s1, i1 = _port(rows, cols, vals, num_u, num_i, top_n=3, block=8)
        s2, i2 = _port(rows, cols, vals, num_u, num_i, top_n=3, block=64)
        np.testing.assert_allclose(s1, s2, atol=1e-6)

    def test_empty_item_excluded(self):
        rows = np.array([0, 1, 0, 1])
        cols = np.array([0, 0, 1, 2])
        vals = np.ones(4, np.float32)
        scores, ids = _port(rows, cols, vals, 2, 4, top_n=3)
        for i in range(4):
            for s, j in zip(scores[i], ids[i]):
                if np.isfinite(s):
                    assert j != 3
        assert not np.isfinite(scores[3]).any()


def _triples(seed: int, num_u: int, num_i: int, nnz: int, kind: str, empty: int = 3,
             repeat: float = 0.1):
    """Seeded triples; the last ``empty`` items get no interaction, and a
    ``repeat`` share of the draws repeat the first (user, item) pair."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, num_u, nnz)
    cols = rng.integers(0, max(1, num_i - empty), nnz)
    dup = rng.random(nnz) < repeat
    rows[dup], cols[dup] = rows[0], cols[0]
    if kind == "int":
        vals = rng.integers(1, 6, nnz).astype(np.float32)
    else:
        vals = rng.random(nnz).astype(np.float32)
    return rows, cols, vals


def _ids_match_outside_ties(s_got, i_got, s_want, i_want, atol=1e-5) -> None:
    for r in range(s_want.shape[0]):
        for p in np.nonzero(i_got[r] != i_want[r])[0]:
            near = [q for q in (p - 1, p + 1) if 0 <= q < s_want.shape[1]]
            assert any(abs(s_want[r, q] - s_want[r, p]) <= atol for q in near), (r, p)


@pytest.mark.parametrize("top_n", [1, 20, 128, 500])
@pytest.mark.parametrize("shape", [(60, 30, 500), (200, 140, 3000)])
def test_integer_counts_bit_equal_to_the_jax_package(shape, top_n):
    num_u, num_i, nnz = shape
    rows, cols, vals = _triples(3, num_u, num_i, nnz, "int")
    sj, ij = jcs.item_similarity_topn(rows, cols, vals, num_u, num_i, top_n=top_n)
    st, it = _port(rows, cols, vals, num_u, num_i, top_n=top_n)
    assert st.shape == np.asarray(sj).shape == (num_i, min(top_n, num_i - 1))
    np.testing.assert_array_equal(st.view(np.int32), np.asarray(sj).view(np.int32))
    np.testing.assert_array_equal(it, np.asarray(ij))
    # the empty items' rows: all -inf, ids 0, 1, 2, ... (lax.top_k's order)
    assert np.isneginf(st[-1]).all()
    np.testing.assert_array_equal(it[-1], np.arange(st.shape[1]))


@pytest.mark.parametrize("top_n", [1, 7, 40])
def test_fractional_values_within_atol_of_the_jax_package(top_n):
    rows, cols, vals = _triples(4, 150, 90, 2500, "float")
    sj, ij = (np.asarray(a) for a in jcs.item_similarity_topn(rows, cols, vals, 150, 90,
                                                                top_n=top_n))
    st, it = _port(rows, cols, vals, 150, 90, top_n=top_n)
    fin = np.isfinite(sj)
    assert (np.isfinite(st) == fin).all()
    np.testing.assert_allclose(st[fin], sj[fin], atol=1e-5)
    _ids_match_outside_ties(st, it, sj, ij)


@pytest.mark.parametrize("block,chunk", [(1, 8), (7, 16), (64, 1024), (256, 33)])
def test_block_and_chunk_change_only_the_layout(block, chunk):
    rows, cols, vals = _triples(5, 70, 45, 900, "int")
    s0, i0 = _port(rows, cols, vals, 70, 45, top_n=6)
    s1, i1 = _port(rows, cols, vals, 70, 45, top_n=6, block=block, user_chunk=chunk)
    np.testing.assert_array_equal(s1.view(np.int32), s0.view(np.int32))
    np.testing.assert_array_equal(i1, i0)


@pytest.mark.parametrize("num_i", [0, 1, 2])
@pytest.mark.parametrize("top_n", [1, 5])
def test_tiny_catalogs_and_top_n_at_or_above_I(num_i, top_n):
    rows = np.array([0, 1, 1, 2])
    cols = np.array([0, 0, 1, 1]) % max(1, num_i)
    vals = np.array([1, 2, 1, 3], np.float32)
    if num_i == 0:
        rows, cols, vals = rows[:0], cols[:0], vals[:0]
    sj, ij = jcs.item_similarity_topn(rows, cols, vals, 3, num_i, top_n=top_n)
    st, it = _port(rows, cols, vals, 3, num_i, top_n=top_n)
    assert st.shape == np.asarray(sj).shape and it.dtype == np.int32
    np.testing.assert_array_equal(st.view(np.int32), np.asarray(sj).view(np.int32))
    np.testing.assert_array_equal(it, np.asarray(ij))


def test_duplicate_triples_are_summed():
    rows = np.array([0, 0, 0, 1, 1, 2])
    cols = np.array([0, 0, 1, 0, 1, 1])
    vals = np.array([1, 2, 1, 1, 1, 4], np.float32)
    s, i = _port(rows, cols, vals, 3, 2, top_n=1)
    # columns (3, 1, 0) and (1, 1, 4): cos = 4 / (sqrt(10) sqrt(18))
    want = np.float32(4.0) / np.maximum(np.sqrt(np.float32(10)) * np.sqrt(np.float32(18)),
                                        np.float32(1e-12))
    assert s[0, 0] == want and i[0, 0] == 1 and s[1, 0] == want and i[1, 0] == 0


def test_reference_on_the_cpu_equals_the_entry_point():
    rows, cols, vals = _triples(6, 50, 40, 600, "float")
    s0, i0 = _port(rows, cols, vals, 50, 40, top_n=9, block=16)
    s1, i1 = tcs.item_similarity_topn_reference(rows, cols, vals, 50, 40, top_n=9, block=16)
    np.testing.assert_array_equal(s1.view(np.int32), s0.view(np.int32))
    np.testing.assert_array_equal(i1, i0)


def test_cpu_calls_launch_no_kernel():
    before = tcs.item_similarity_topn.launches.value
    rows, cols, vals = _triples(7, 20, 10, 100, "int")
    _port(rows, cols, vals, 20, 10)
    assert tcs.item_similarity_topn.launches.value == before


# -- K6's layout, route and selection, modelled in numpy ------------------------

_CU = Path(tcs.__file__).resolve().parent.parent / "csrc" / "cosine_sim.cu"


def _cu_consts() -> dict:
    src = _CU.read_text()
    consts = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    consts["DROW"] = consts["DK"] + int(re.search(r"constexpr int DROW = DK \+ (\d+);",
                                                  src).group(1))
    return consts


def test_k6_constants_match_the_kernel_source():
    consts = _cu_consts()
    assert consts["PASS_COLS"] == tcs.K6_PASS_COLS
    assert consts["SELECT_MAX_N"] == tcs.K6_SELECT_MAX_N
    assert consts["DM"] == consts["DN"] == tcs.K6_DENSE_TILE
    assert consts["DK"] == tcs.K6_DENSE_K and consts["DK"] % 32 == 0  # mma's k32 steps
    # a full pass of f32 columns fits the 227 KB a block may use
    assert consts["PASS_COLS"] * 4 <= 232_448
    # the dense stage: each thread copies two 16-byte chunks of each tile a
    # stage; ldmatrix rows stay 16-byte aligned; the ring fits two blocks an SM
    assert consts["DM"] * consts["DK"] // 16 == 2 * consts["DTHREADS"]
    assert consts["DROW"] % 16 == 0
    assert 2 * consts["DSTAGES"] * (consts["DM"] + consts["DN"]) * consts["DROW"] <= 228 * 1024


def test_k6_route():
    cols = np.array([0, 1, 1])
    assert tcs.k6_route(cols, np.array([1, 2, 53], np.float32), 2) == "atomic"
    assert tcs.k6_route(cols, np.array([1, 2.5, 3], np.float32), 2) == "ordered"
    # a column whose squared norm reaches 2^24: partial sums no longer exact
    assert tcs.k6_route(np.array([0]), np.array([4096], np.float32), 1) == "ordered"
    assert tcs.k6_route(np.array([0, 0]), np.array([2896, 2896], np.float32), 1) == "atomic"
    assert tcs.k6_route(cols[:0], np.zeros(0, np.float32), 3) == "atomic"


@pytest.mark.parametrize("top_n", [129, 300, "I-1"])
def test_top_n_above_the_select_limit_equal_to_the_jax_package(top_n):
    """F3: any top_n, clamped to I - 1 as the JAX package clamps it; the
    scores route's answers bit for bit on integer counts."""
    num_u, num_i = 400, 340
    rows, cols, vals = _triples(10, num_u, num_i, 6000, "int")
    n = num_i - 1 if top_n == "I-1" else top_n
    sj, ij = jcs.item_similarity_topn(rows, cols, vals, num_u, num_i, top_n=n)
    st, it = _port(rows, cols, vals, num_u, num_i, top_n=n)
    assert st.shape == np.asarray(sj).shape == (num_i, n)
    np.testing.assert_array_equal(st.view(np.int32), np.asarray(sj).view(np.int32))
    np.testing.assert_array_equal(it, np.asarray(ij))


@pytest.mark.parametrize("num_i,want", [(1, 1), (2, 2), (26_744, 10_037), (120_000, 2_236),
                                        (1 << 28, 1), (1 << 29, 1)])
def test_scores_route_chunk_rows(num_i, want):
    """The scratch chunk [R, I] f32 holds at most 1 GiB: R = floor(2^30 /
    4 I), at least one row, at most I."""
    r = tcs.k6_chunk_rows(num_i)
    assert r == want
    assert r * 4 * num_i <= (1 << 30) or r == 1
    assert r == num_i or (r + 1) * 4 * num_i > (1 << 30)


def test_cosine_layout():
    rows, cols, vals = tcs._dedupe(*_triples(8, 30, 20, 300, "int"), 30, 20)
    lay = tcs.cosine_layout(rows, cols, vals, 30, 20)
    dense = np.zeros((30, 20), np.float32)
    dense[rows, cols] = vals
    for u in range(30):  # CSR: each user's items ascending with their values
        q0, q1 = lay.user_ptr[u], lay.user_ptr[u + 1]
        np.testing.assert_array_equal(lay.user_items[q0:q1], np.nonzero(dense[u])[0])
        np.testing.assert_array_equal(lay.user_vals[q0:q1], dense[u][dense[u] > 0])
    for i in range(20):  # CSC: each item's users ascending with their values
        p0, p1 = lay.item_ptr[i], lay.item_ptr[i + 1]
        np.testing.assert_array_equal(lay.item_users[p0:p1], np.nonzero(dense[:, i])[0])
        np.testing.assert_array_equal(lay.item_vals[p0:p1], dense[:, i][dense[:, i] > 0])
    deg = (dense > 0).sum(1)
    np.testing.assert_array_equal(lay.work, [(deg * (dense[:, i] > 0)).sum() for i in range(20)])
    assert sorted(lay.row_order.tolist()) == list(range(20))
    assert (np.diff(lay.work[lay.row_order]) <= 0).all()  # heaviest first
    assert int(lay.work.sum()) == int((deg ** 2).sum())  # sum_u deg(u)^2 multiply-adds
    # the atomic route's packed entries: item << 16 | value, one int32 each
    packed = lay.user_packed.view(np.uint32)
    np.testing.assert_array_equal(packed >> 16, lay.user_items)
    np.testing.assert_array_equal((packed & 0xFFFF).astype(np.uint16).view(np.int16),
                                  lay.user_vals)
    # a catalog this small: the cost model finds no split worth a launch
    assert lay.threshold == tcs.k6_threshold(20) and len(lay.heavy) == 0
    assert lay.light_users is lay.item_users and lay.light_order is lay.row_order


@pytest.mark.parametrize("threshold", [0, 12, 10_000])
def test_cosine_layout_heavy_split(threshold):
    """The heavy users (degree >= T, with an entry), their entries as the
    dense operand's triples, the light CSC of the others, its work and
    heaviest-first order."""
    num_u, num_i = 50, 40
    rows, cols, vals = tcs._dedupe(*_triples(11, num_u, num_i, 900, "int", repeat=0.0),
                                     num_u, num_i)
    lay = tcs.cosine_layout(rows, cols, vals, num_u, num_i, threshold=threshold)
    dense = np.zeros((num_u, num_i), np.float32)
    dense[rows, cols] = vals
    deg = (dense > 0).sum(1)
    heavy = np.nonzero((deg >= threshold) & (deg > 0))[0]
    assert lay.threshold == threshold
    np.testing.assert_array_equal(lay.heavy, heavy)
    a = np.zeros((num_i, len(heavy)), np.int64)  # the operand's triples
    a[lay.heavy_items, lay.heavy_cols] = lay.heavy_vals
    np.testing.assert_array_equal(a, dense[heavy].T.astype(np.int64))
    light = np.setdiff1d(np.arange(num_u), heavy)
    for i in range(num_i):
        p0, p1 = lay.light_ptr[i], lay.light_ptr[i + 1]
        want = light[dense[light, i] > 0]
        np.testing.assert_array_equal(lay.light_users[p0:p1], want)
        np.testing.assert_array_equal(lay.light_vals[p0:p1], dense[want, i])
    np.testing.assert_array_equal(
        lay.light_work, [(deg[light] * (dense[light, i] > 0)).sum() for i in range(num_i)])
    assert (np.diff(lay.light_work[lay.light_order]) <= 0).all()
    assert sorted(lay.light_order.tolist()) == list(range(num_i))
    # the full CSC and its order stay
    np.testing.assert_array_equal(lay.work, [(deg * (dense[:, i] > 0)).sum()
                                             for i in range(num_i)])


@pytest.mark.parametrize("num_i,top,packs", [(50, 3, True), (65_535, 3, True),
                                              (65_536, 3, False), (50, 4_095, True),
                                              (50, -4_095, True), (50, 2.5, False)])
def test_packed_entries(num_i, top, packs):
    """One int32 an entry (item << 16 | value & 0xFFFF) on the atomic route
    (integers below 4,096 in magnitude: norm^2 < 2^24) where item ids fit
    16 bits with 65,535 left free (I <= 65,535); the kernel reads them
    instead of the two arrays. Negative values keep their sign through the
    int16 view."""
    rows = np.array([0, 0, 1, 2])
    cols = np.array([0, num_i - 1, 3, num_i - 1])
    vals = np.array([1, top, -2, 1], np.float32)
    lay = tcs.cosine_layout(rows, cols, vals, 3, num_i, threshold=10 ** 9)
    assert (lay.user_packed is not None) == packs
    if packs:
        p = lay.user_packed.view(np.uint32)
        np.testing.assert_array_equal(p >> 16, cols)
        np.testing.assert_array_equal((p & 0xFFFF).astype(np.uint16).view(np.int16), vals)


def test_heavy_split_needs_the_atomic_route_and_s8_values():
    rows, cols = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
    for v, split in ((127, True), (128, False), (-128, True), (-129, False)):
        vals = np.array([v, 1, 1, 1], np.float32)
        lay = tcs.cosine_layout(rows, cols, vals, 2, 2, threshold=0)
        assert (lay.threshold is not None) == split and (len(lay.heavy) > 0) == split
    lay = tcs.cosine_layout(rows, cols, np.array([1.5, 1, 1, 1], np.float32), 2, 2, threshold=0)
    assert lay.route == "ordered" and lay.threshold is None and len(lay.heavy) == 0


def test_cost_model_threshold():
    """T(I) = ceil(I sqrt(2 sparse / mma)), grows with I; the split is taken
    only when the heavy users' sparse time beats the dense stage's."""
    t = [tcs.k6_threshold(i) for i in (1, 1000, 26_744, 120_000)]
    assert t == sorted(t) and t[0] >= 1
    ratio = np.sqrt(2 * tcs.K6_SPARSE_ADDS_PER_S / tcs.K6_MMA_OPS_PER_S)
    assert t[2] == int(np.ceil(26_744 * ratio))
    assert not tcs._split_pays(np.zeros(0, np.int64), 26_744)
    # the ML-20M views' heavy users at T: 1,625 users of degree >= 1,024
    assert tcs._split_pays(np.full(1625, 2000), 26_744)
    assert not tcs._split_pays(np.full(3, t[2]), 26_744)


def _order_key(s: np.ndarray) -> np.ndarray:
    b = s.view(np.int32).astype(np.int64)
    key = np.where(b < 0, b ^ 0x7FFFFFFF, b)
    return (key & 0xFFFFFFFF) ^ 0x80000000


def _heavy_gram(lay, num_i: int) -> np.ndarray:
    """The dense stage's G: an int64 Gram of the heavy users' values."""
    a = np.zeros((num_i, len(lay.heavy)), np.int64)
    a[lay.heavy_items, lay.heavy_cols] = lay.heavy_vals
    return a @ a.T


def _k6_model(lay, norms, num_i: int, top_n: int, pass_cols: int, dense: bool = True,
              chunk: int | None = None):
    """K6 in numpy, block by block. With heavy users on the atomic route
    (and ``dense``), each chunk's rows start from the heavy users' int64
    Gram (the dense stage, converted to f32) and add the light users;
    otherwise they start from zeros and add every user. Per item row (the
    heaviest-first order, cut into chunks of R rows) and column pass, the
    row's users in order add their items' products into G (f32, each
    product and sum rounded). Select mode (top_n <= 128): each warp scores
    its chunks of 32 E columns into composites and keeps its top g when a
    chunk beats the last entry; the warps' lists fold pairwise; the first
    top_n are written. Scores mode: the masked scores go into the chunk's
    scratch row, then the rows are selected in lax.top_k order."""
    use_dense = dense and lay.route == "atomic" and len(lay.heavy) > 0
    if use_dense:
        ptr, users, uvals, order = lay.light_ptr, lay.light_users, lay.light_vals, lay.light_order
        gh = _heavy_gram(lay, num_i)
    else:
        ptr, users, uvals, order = lay.item_ptr, lay.item_users, lay.item_vals, lay.row_order
    warps = 16 if lay.route == "atomic" else 32
    scores_route = top_n > tcs.K6_SELECT_MAX_N
    if chunk is None:
        chunk = tcs.k6_chunk_rows(num_i) if (use_dense or scores_route) else num_i
    g = max(32, 1 << max(0, top_n - 1).bit_length())
    width = g  # columns a warp takes at a time (32 E)
    out_s = np.zeros((num_i, top_n), np.float32)
    out_i = np.zeros((num_i, top_n), np.int32)
    for r0 in range(0, num_i, chunk):
        part = order[r0:r0 + chunk]
        scratch = np.zeros((len(part), num_i), np.float32)
        for b, row in enumerate(part):
            rn = norms[row]
            best = [np.zeros(g, np.uint64) for _ in range(warps)]
            for c0 in range(0, num_i, pass_cols):
                cw = min(pass_cols, num_i - c0)
                G = gh[row, c0:c0 + cw].astype(np.float32) if use_dense else np.zeros(cw,
                                                                                      np.float32)
                for p in range(ptr[row], ptr[row + 1]):
                    u, w = users[p], uvals[p]
                    q0, q1 = lay.user_ptr[u], lay.user_ptr[u + 1]
                    x = lay.user_items[q0:q1].astype(np.int64) - c0
                    keep = (x >= 0) & (x < cw)
                    G[x[keep]] = G[x[keep]] + np.float32(w) * lay.user_vals[q0:q1][keep]
                j = c0 + np.arange(cw)
                nj = norms[c0:c0 + cw]
                s = G / np.maximum(np.float32(rn) * nj, np.float32(1e-12))
                s[(j == row) | ~(nj > 0) | ~(rn > 0)] = -np.inf
                if scores_route:
                    scratch[b, c0:c0 + cw] = s
                    continue
                comp = (_order_key(s.astype(np.float32)).astype(np.uint64) << np.uint64(32)) | (
                    (~j.astype(np.int64)) & 0xFFFFFFFF).astype(np.uint64)
                for w in range(warps):
                    for base in range(w * width, cw, warps * width):
                        piece = comp[base:base + width]
                        if piece.max() > best[w][-1]:
                            best[w] = np.sort(np.concatenate([best[w], piece]))[::-1][:g]
            if scores_route:
                continue
            half = warps // 2
            while half:
                for w in range(half):
                    best[w] = np.sort(np.concatenate([best[w], best[w + half]]))[::-1][:g]
                half //= 2
            top = best[0][:top_n]
            ids = (~(top & np.uint64(0xFFFFFFFF)).astype(np.uint32)).astype(np.int32)
            key = (top >> np.uint64(32)).astype(np.uint32) ^ np.uint32(0x80000000)
            key = key.view(np.int32)
            out_s[row] = np.where(key < 0, key ^ 0x7FFFFFFF, key).astype(np.int32).view(
                np.float32)
            out_i[row] = ids
        if scores_route:
            s, i = tcs.top_k_rows_reference(torch.from_numpy(scratch), top_n)
            out_s[part], out_i[part] = s.numpy(), i.numpy()
    return out_s, out_i


@pytest.mark.parametrize("kind,pass_cols,top_n", [
    ("int", 57344, 5), ("int", 16, 5), ("int", 7, 40), ("float", 16, 3), ("float", 57344, 33),
    ("int", 16, 129), ("float", 57344, 49),
])
def test_numpy_model_of_k6_matches_the_plain_version(kind, pass_cols, top_n):
    num_u, num_i = 60, 50
    rows, cols, vals = tcs._dedupe(*_triples(9, num_u, num_i, 700, kind), num_u, num_i)
    norms = tcs.column_norms(cols, vals, num_i)
    lay = tcs.cosine_layout(rows, cols, vals, num_u, num_i)
    assert lay.route == ("atomic" if kind == "int" else "ordered")
    top_n = tcs.clamp_top_n(top_n, num_i)
    sm, im = _k6_model(lay, norms, num_i, top_n, min(pass_cols, num_i))
    sp, ip = tcs.item_similarity_topn_reference(rows, cols, vals, num_u, num_i, top_n=top_n)
    if kind == "int":
        np.testing.assert_array_equal(sm.view(np.int32), sp.view(np.int32))
        np.testing.assert_array_equal(im, ip)
    else:
        fin = np.isfinite(sp)
        assert (np.isfinite(sm) == fin).all()
        np.testing.assert_allclose(sm[fin], sp[fin], atol=1e-5)
        _ids_match_outside_ties(sm, im, sp, ip)


def _split_cases():
    """(name, threshold, top value): T = 0 (every user heavy), T above the
    largest degree (none), the cost model's T forced, and counts at the s8
    boundary (127: split; 128: no split)."""
    return [("T=0", 0, 5), ("T>max", 10_000, 5), ("cost model T", None, 5),
            ("count 127", 0, 127), ("count 128", 0, 128)]


@pytest.mark.parametrize("top_n", [20, 131])
@pytest.mark.parametrize("case", _split_cases(), ids=[c[0] for c in _split_cases()])
def test_numpy_model_of_the_heavy_split_bit_equal(case, top_n):
    """The dense stage's int64 Gram of the heavy users, then the light
    users in order: bit-equal to the plain version and to the JAX package
    on integer counts, in one chunk and in chunks of 7 rows, in column
    passes."""
    name, threshold, top = case
    num_u, num_i = 90, 140
    rows, cols, vals = _triples(12, num_u, num_i, 2500, "int", repeat=0.0)
    # a skewed degree profile: a few heavy users, a tail of light ones
    rows = np.minimum((np.random.default_rng(14).pareto(1.2, len(rows)) * 4).astype(np.int64),
                      num_u - 1)
    vals[:3] = top  # after dedupe some entry holds `top` or more (summed repeats)
    rows, cols, vals = tcs._dedupe(rows, cols, vals, num_u, num_i)
    if top >= 127:  # the boundary: make the largest count exactly `top`
        vals = np.minimum(vals, top).astype(np.float32)
        assert vals.max() == top
    norms = tcs.column_norms(cols, vals, num_i)
    t = tcs.k6_threshold(num_i) if threshold is None else threshold
    lay = tcs.cosine_layout(rows, cols, vals, num_u, num_i, threshold=t)
    assert lay.route == "atomic"
    deg = np.bincount(rows, minlength=num_u)
    want_h = 0 if top > 127 else int(((deg >= t) & (deg > 0)).sum())
    assert len(lay.heavy) == want_h
    if name == "T=0":
        assert want_h == int((deg > 0).sum())
    if name == "cost model T":
        assert 0 < want_h < int((deg > 0).sum())
    sp, ip = tcs.item_similarity_topn_reference(rows, cols, vals, num_u, num_i, top_n=top_n)
    sj, ij = jcs.item_similarity_topn(rows, cols, vals, num_u, num_i, top_n=top_n)
    np.testing.assert_array_equal(sp.view(np.int32), np.asarray(sj).view(np.int32))
    np.testing.assert_array_equal(ip, np.asarray(ij))
    for chunk, pass_cols in ((None, 57344), (7, 33)):
        sm, im = _k6_model(lay, norms, num_i, top_n, min(pass_cols, num_i), chunk=chunk)
        np.testing.assert_array_equal(sm.view(np.int32), sp.view(np.int32))
        np.testing.assert_array_equal(im, ip)


# -- the dense stage's tiles and fragments, modelled in numpy --------------------


def _ldmatrix_x4(smem: np.ndarray, addr: np.ndarray) -> np.ndarray:
    """ldmatrix.m8n8.x4.b16: lane l supplies the address of row l % 8 of
    matrix l // 8; lane T receives, in register j, the 32-bit word T % 4 of
    row T // 4 of matrix j. Returns [32 lanes, 4 registers] of 4 bytes."""
    lanes = np.arange(32)
    out = np.empty((32, 4, 4), np.uint8)
    for j in range(4):
        a = addr[8 * j + lanes // 4] + 4 * (lanes % 4)
        out[:, j] = smem[a[:, None] + np.arange(4)]
    return out.view(np.int8)


def _mma_s8(acc: np.ndarray, af: np.ndarray, b0: np.ndarray, b1: np.ndarray) -> None:
    """mma.m16n8k32.row.col.s32.s8.s8.s32 on [32, 4] accumulators, by the
    PTX fragment layouts (g = lane / 4, t = lane % 4): A register r holds
    row g + 8 (r & 1), columns 4 t + 16 (r >> 1) + 0..3; B registers 0 and
    1 hold column g, rows 4 t + 0..3 and 16 + 4 t + 0..3; accumulator e
    holds row g + 8 (e >> 1), column 2 t + (e & 1)."""
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for r in range(4):
        A[(g + 8 * (r & 1))[:, None], (4 * t + 16 * (r >> 1))[:, None] + np.arange(4)] = af[:, r]
    B[(4 * t)[:, None] + np.arange(4), g[:, None]] = b0
    B[(16 + 4 * t)[:, None] + np.arange(4), g[:, None]] = b1
    D = A @ B
    for e in range(4):
        acc[:, e] += D[g + 8 * (e >> 1), 2 * t + (e & 1)]


def _gram_model(a_pad: np.ndarray, rows: np.ndarray, num_i: int, c: dict) -> np.ndarray:
    """gram_s8_kernel in numpy, thread by thread where the index arithmetic
    lives: each block's cp.async chunks into its stage (A's rows gathered
    through ``rows``, zero filled past n_rows), every warp's ldmatrix
    addresses, the mma fragments, and the epilogue's stores; unwritten
    entries stay NaN."""
    DM, DN, DK, DROW, DT = c["DM"], c["DN"], c["DK"], c["DROW"], c["DTHREADS"]
    i_pad, h_pad = a_pad.shape
    n_rows = len(rows)
    flat = a_pad.view(np.uint8)
    out = np.full((n_rows, num_i), np.nan, np.float32)
    lanes = np.arange(32)
    for by in range(-(-n_rows // DM)):
        for bx in range(i_pad // DN):
            m0, n0 = by * DM, bx * DN
            acc = np.zeros((8, 4, 4, 32, 4), np.int64)  # warp, i, j, lane, e
            for kt in range(h_pad // DK):
                As = np.zeros(DM * DROW, np.uint8)
                Bs = np.zeros(DN * DROW, np.uint8)
                for tid in range(DT):
                    for i in range(2):
                        ch = tid + DT * i
                        r, k16 = ch >> 2, (ch & 3) * 16
                        k0 = kt * DK + k16
                        if m0 + r < n_rows:
                            As[r * DROW + k16:r * DROW + k16 + 16] = flat[rows[m0 + r], k0:k0 + 16]
                        Bs[r * DROW + k16:r * DROW + k16 + 16] = flat[n0 + r, k0:k0 + 16]
                for warp in range(8):
                    wm, wn = warp >> 2, warp & 3
                    for kk in range(DK // 32):
                        af = [_ldmatrix_x4(As, (wm * 64 + i * 16 + (lanes & 7)
                                                + ((lanes >> 3) & 1) * 8) * DROW
                                           + kk * 32 + (lanes >> 4) * 16) for i in range(4)]
                        bf = [_ldmatrix_x4(Bs, (wn * 32 + jp * 16 + (lanes & 7)
                                                + (lanes >> 4) * 8) * DROW
                                           + kk * 32 + ((lanes >> 3) & 1) * 16) for jp in range(2)]
                        for i in range(4):
                            for j in range(4):
                                _mma_s8(acc[warp, i, j], af[i], bf[j >> 1][:, (j & 1) * 2],
                                        bf[j >> 1][:, (j & 1) * 2 + 1])
            g, tig = lanes >> 2, lanes & 3
            for warp in range(8):
                wm, wn = warp >> 2, warp & 3
                for i in range(4):
                    for h in range(2):
                        m = m0 + wm * 64 + i * 16 + g + 8 * h
                        for j in range(4):
                            for e in range(2):
                                n = n0 + wn * 32 + j * 8 + tig * 2 + e
                                ok = (m < n_rows) & (n < num_i)
                                out[m[ok], n[ok]] = acc[warp, i, j, ok, 2 * h + e]
    return out


@pytest.mark.parametrize("num_i,num_h,n_rows", [(150, 70, 140), (97, 33, 5)])
def test_numpy_model_of_the_dense_stage_tiles_and_fragments(num_i, num_h, n_rows):
    """At I and H that are not multiples of the tiles (padded with zeros
    to I_pad, H_pad), the kernel's cp.async, ldmatrix, mma and store index
    arithmetic writes every [n_rows, I] entry once, equal to the int64
    Gram of the gathered rows; heavy_operand builds the padded operand."""
    c = _cu_consts()
    rng = np.random.default_rng(13)
    dense = np.where(rng.random((num_i, num_h)) < 0.3,
                     rng.integers(-128, 128, (num_i, num_h)), 0).astype(np.int8)
    items, cols = np.nonzero(dense)
    lay = tcs.CosineLayout(**{**{f: None for f in tcs.CosineLayout._fields},
                              "heavy": np.arange(num_h, dtype=np.int32),
                              "heavy_items": items.astype(np.int32),
                              "heavy_cols": cols.astype(np.int32),
                              "heavy_vals": dense[items, cols]})
    a_pad = tcs.heavy_operand(lay, num_i, "cpu").numpy()
    assert a_pad.shape == (-(-num_i // c["DN"]) * c["DN"], -(-num_h // c["DK"]) * c["DK"])
    np.testing.assert_array_equal(a_pad[:num_i, :num_h], dense)
    assert not a_pad[num_i:].any() and not a_pad[:, num_h:].any()
    rows = rng.permutation(num_i)[:n_rows].astype(np.int32)
    got = _gram_model(a_pad, rows, num_i, c)
    want = dense[rows].astype(np.int64) @ dense.astype(np.int64).T
    np.testing.assert_array_equal(got, want.astype(np.float32))
    ref = tcs.gram_s8_reference(torch.from_numpy(a_pad), torch.from_numpy(rows), num_i)
    np.testing.assert_array_equal(ref.numpy(), want.astype(np.float32))
