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


def _triples(seed: int, num_u: int, num_i: int, nnz: int, kind: str, empty: int = 3):
    """Seeded triples; the last ``empty`` items get no interaction, and a
    tenth of the draws repeat an earlier (user, item) pair."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, num_u, nnz)
    cols = rng.integers(0, max(1, num_i - empty), nnz)
    dup = rng.random(nnz) < 0.1
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


def test_k6_constants_match_the_kernel_source():
    src = (Path(tcs.__file__).resolve().parent.parent / "csrc" / "cosine_sim.cu").read_text()
    consts = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["PASS_COLS"] == tcs.K6_PASS_COLS
    assert consts["MAX_TOP_N"] == tcs.K6_MAX_TOP_N
    # a full pass of f32 columns fits the 227 KB a block may use
    assert consts["PASS_COLS"] * 4 <= 232_448


def test_k6_route():
    cols = np.array([0, 1, 1])
    assert tcs.k6_route(cols, np.array([1, 2, 53], np.float32), 2) == "atomic"
    assert tcs.k6_route(cols, np.array([1, 2.5, 3], np.float32), 2) == "ordered"
    # a column whose squared norm reaches 2^24: partial sums no longer exact
    assert tcs.k6_route(np.array([0]), np.array([4096], np.float32), 1) == "ordered"
    assert tcs.k6_route(np.array([0, 0]), np.array([2896, 2896], np.float32), 1) == "atomic"
    assert tcs.k6_route(cols[:0], np.zeros(0, np.float32), 3) == "atomic"


def test_k6_refuses_top_n_above_its_limit():
    """Checked before anything reaches the device: no silent plain run."""
    with pytest.raises(tcs.K6TopNError):
        tcs.cosine_topn_kernel({"norms": torch.zeros(200)}, 200, tcs.K6_MAX_TOP_N + 1,
                               "atomic")


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


def _order_key(s: np.ndarray) -> np.ndarray:
    b = s.view(np.int32).astype(np.int64)
    key = np.where(b < 0, b ^ 0x7FFFFFFF, b)
    return (key & 0xFFFFFFFF) ^ 0x80000000


def _k6_model(lay, norms, num_i: int, top_n: int, pass_cols: int, warps: int = 32):
    """K6 in numpy, block by block: per item row (heaviest first) and
    column pass, the row's users in order add their items' products into
    G (f32, each product and sum rounded); each warp scores its chunks of
    32 E columns into composites and keeps its top g when a chunk beats
    the last entry; the warps' lists fold pairwise; the first top_n are
    written."""
    g = max(32, 1 << max(0, top_n - 1).bit_length())
    width = g  # columns a warp takes at a time (32 E)
    out_s = np.zeros((num_i, top_n), np.float32)
    out_i = np.zeros((num_i, top_n), np.int32)
    for row in lay.row_order:
        rn = norms[row]
        best = [np.zeros(g, np.uint64) for _ in range(warps)]
        for c0 in range(0, num_i, pass_cols):
            cw = min(pass_cols, num_i - c0)
            G = np.zeros(cw, np.float32)
            for p in range(lay.item_ptr[row], lay.item_ptr[row + 1]):
                u, w = lay.item_users[p], lay.item_vals[p]
                q0, q1 = lay.user_ptr[u], lay.user_ptr[u + 1]
                x = lay.user_items[q0:q1].astype(np.int64) - c0
                keep = (x >= 0) & (x < cw)
                G[x[keep]] = G[x[keep]] + np.float32(w) * lay.user_vals[q0:q1][keep]
            j = c0 + np.arange(cw)
            nj = norms[c0:c0 + cw]
            s = G / np.maximum(np.float32(rn) * nj, np.float32(1e-12))
            s[(j == row) | ~(nj > 0) | ~(rn > 0)] = -np.inf
            comp = (_order_key(s.astype(np.float32)).astype(np.uint64) << np.uint64(32)) | (
                (~j.astype(np.int64)) & 0xFFFFFFFF).astype(np.uint64)
            for w in range(warps):
                for base in range(w * width, cw, warps * width):
                    chunk = comp[base:base + width]
                    if chunk.max() > best[w][-1]:
                        best[w] = np.sort(np.concatenate([best[w], chunk]))[::-1][:g]
        half = warps // 2
        while half:
            for w in range(half):
                best[w] = np.sort(np.concatenate([best[w], best[w + half]]))[::-1][:g]
            half //= 2
        top = best[0][:top_n]
        ids = (~(top & np.uint64(0xFFFFFFFF)).astype(np.uint32)).astype(np.int32)
        key = (top >> np.uint64(32)).astype(np.uint32) ^ np.uint32(0x80000000)
        key = key.view(np.int32)
        out_s[row] = np.where(key < 0, key ^ 0x7FFFFFFF, key).astype(np.int32).view(np.float32)
        out_i[row] = ids
    return out_s, out_i


@pytest.mark.parametrize("kind,pass_cols,top_n", [
    ("int", 57344, 5), ("int", 16, 5), ("int", 7, 40), ("float", 16, 3), ("float", 57344, 33),
])
def test_numpy_model_of_k6_matches_the_plain_version(kind, pass_cols, top_n):
    num_u, num_i = 60, 50
    rows, cols, vals = tcs._dedupe(*_triples(9, num_u, num_i, 700, kind), num_u, num_i)
    norms = tcs.column_norms(cols, vals, num_i)
    lay = tcs.cosine_layout(rows, cols, vals, num_u, num_i)
    assert lay.route == ("atomic" if kind == "int" else "ordered")
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
