"""The port's ALS ops (``predictionio_tpu_torch.ops.als``) against the JAX
package's, on the CPU.

On CPU tensors K1's wrapper runs its plain PyTorch version
(``solve_bucket_reference`` + ``_scatter_rows``), which is what the CUDA
kernel is held to on the card (chip_smoke.py). Both packages get the
same numpy inputs. Tolerances and their reasons:

- bucket layouts: bit-identical (the same numpy operations);
- one bucket's solve: rtol=2e-4, atol=2e-5 (the bar of
  ``tests/test_als.py::test_solve_matches_numpy_reference``): the two
  packages sum the normal equations and factor them in different orders;
  bf16 compute rounds the same values at the same points in both, so it
  is held to the same bar (int8 storage at bf16 compute: see
  ``test_solve_bucket_explicit_matches_jax``);
- ``quantize_rows`` / ``_scatter_rows`` on the same f32 rows: bit for bit;
- a whole training from the same injected init: f32 factors within
  rtol=5e-4, atol=5e-5 (``tests/test_als.py:188``); with int8 or bf16
  storage a last-bit difference can flip a quantization step, so those
  are held by train RMSE within ``e_jax * 1.01 + 0.01``;
- implicit feedback: ``compute_gram`` within rtol=1e-5, atol=1e-6 *
  max|G| (two float32 matrix products, summed in other orders); an
  implicit bucket solve and half-step within rtol=5e-4, atol=5e-5
  (``tests/test_als.py:205``: the port adds the regularizer before the
  Gramian, as the training path does, the standalone JAX solve after
  it); an indefinite system is NaN for NaN in both, and its int8
  write-back zeros with scale 1; a whole implicit training from one
  init within rtol=5e-4, atol=5e-5 (f32), or per-row cosine >= 0.999
  with the same NaN rows (bf16 and int8 storage);
- K1's routes on the card: the rule (``k1_route``) and the launches it
  implies, exactly; the split route's order of sums, stated in plain
  torch, within atol 1e-5 + rtol 1e-4 * max|x| per solve of the plain
  version (chip_smoke.py's per-solve bar, where the kernels are run).
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.models.modelfile import tensor_to_numpy
from predictionio_tpu_torch.ops import als as tals

SMALL_WIDTHS = (2, 4, 8)  # small enough that a few rows segment


def _coo(seed: int, n_rows: int, n_cols: int, nnz: int, hot: bool = True):
    """Random COO ratings (unique pairs, half-star values); with ``hot``,
    row 0 and column 1 take many more entries than the widest bucket."""
    rng = np.random.default_rng(seed)
    pairs = rng.choice(n_rows * n_cols, size=nnz, replace=False)
    rows, cols = (pairs // n_cols).astype(np.int32), (pairs % n_cols).astype(np.int32)
    if hot:
        extra_c = np.setdiff1d(np.arange(n_cols), cols[rows == 0])
        extra_r = np.setdiff1d(np.arange(1, n_rows), rows[cols == 1])
        rows = np.concatenate([rows, np.zeros(len(extra_c), np.int32),
                               extra_r.astype(np.int32)])
        cols = np.concatenate([cols, extra_c.astype(np.int32),
                               np.ones(len(extra_r), np.int32)])
    vals = (rng.integers(1, 11, len(rows)) / 2.0).astype(np.float32)
    return rows, cols, vals


def _same_buckets(jb, tb):
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        for name in ("row_ids", "col_ids", "ratings", "mask"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        assert (a.seg_row is None) == (b.seg_row is None)
        if a.seg_row is not None:
            assert a.seg_row.dtype == b.seg_row.dtype
            assert np.array_equal(a.seg_row, b.seg_row)


@pytest.mark.parametrize("segment", [True, False])
@pytest.mark.parametrize("widths", [SMALL_WIDTHS, jals.DEFAULT_BUCKETS])
def test_build_padded_buckets_bit_identical(segment, widths):
    rows, cols, vals = _coo(0, 40, 30, 300)
    jb = jals.build_padded_buckets(rows, cols, vals, widths, segment)
    tb = tals.build_padded_buckets(rows, cols, vals, widths, segment)
    _same_buckets(jb, tb)
    if segment and widths == SMALL_WIDTHS:
        assert any(b.seg_row is not None for b in tb)


def test_build_ratings_data_bit_identical():
    rows, cols, vals = _coo(1, 25, 35, 200)
    jd = jals.build_ratings_data(rows, cols, vals, 27, 36, SMALL_WIDTHS)
    td = tals.build_ratings_data(rows, cols, vals, 27, 36, SMALL_WIDTHS)
    assert (jd.num_rows, jd.num_cols) == (td.num_rows, td.num_cols) == (27, 36)
    for name in ("rows", "cols", "vals"):
        assert np.array_equal(getattr(jd, name), getattr(td, name))
    _same_buckets(jd.row_buckets, td.row_buckets)
    _same_buckets(jd.col_buckets, td.col_buckets)
    assert tals.build_padded_buckets(rows[:0], cols[:0], vals[:0]) == []


def test_segment_offsets():
    assert tals.segment_offsets(None, 3, 3).tolist() == [0, 1, 2, 3]
    seg = np.array([0, 0, 0, 1, 2, 2], np.int32)
    assert tals.segment_offsets(seg, 3, 6).tolist() == [0, 3, 4, 6]
    # a solved row with no table rows gets an empty range
    assert tals.segment_offsets(np.array([0, 2], np.int32), 3, 2).tolist() == [0, 1, 1, 2]
    with pytest.raises(ValueError, match="decreases"):
        tals.segment_offsets(np.array([0, 1, 0], np.int32), 2, 3)
    with pytest.raises(ValueError, match="out of range"):
        tals.segment_offsets(np.array([0, 3], np.int32), 2, 2)
    with pytest.raises(ValueError):
        tals.segment_offsets(None, 2, 3)


def _tables(x: np.ndarray, storage: str):
    """(jax table, torch table) holding the same bits."""
    jx = jals.to_storage(jnp.asarray(x), storage)
    if storage == "int8":
        q, s = (np.asarray(a) for a in jx)
        return jx, (torch.from_numpy(q.copy()), torch.from_numpy(s.copy()))
    if storage == "bfloat16":
        bits = np.asarray(jx).view(np.int16).copy()
        return jx, torch.from_numpy(bits).view(torch.bfloat16)
    return jx, torch.from_numpy(x.copy())


def _bucket(rng, n_other: int, B: int, K: int, empty_row: bool = True):
    """A padded bucket: each row rates 1..K distinct columns, packed to
    the front; row 1 (with ``empty_row``) rates nothing."""
    col = np.zeros((B, K), np.int32)
    rat = np.zeros((B, K), np.float32)
    msk = np.zeros((B, K), np.float32)
    for b in range(B):
        n = 0 if (empty_row and b == 1) else int(rng.integers(1, K + 1))
        col[b, :n] = rng.choice(n_other, n, replace=False)
        rat[b, :n] = rng.integers(1, 11, n) / 2.0
        msk[b, :n] = 1.0
    return col, rat, msk


def _bf16(a) -> np.ndarray:
    """bf16 rounding (to nearest even) of float32 values, as float64."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().double().numpy()


def _solve_float64(gw, g, rat, msk, reg, weighted):
    """Explicit normal equations ``A = sum (w*gw) g^T`` (its lower
    triangle, as a Cholesky reads it) and ``b = sum bf16(r) g`` of
    gathered rows ``[B, K, D]``, solved in float64."""
    A = np.tril(np.einsum("bki,bkj->bij", gw * msk[..., None], g))
    A = A + np.swapaxes(A, 1, 2) - A * np.eye(g.shape[-1])
    b = np.einsum("bk,bki->bi", _bf16(rat * msk), g)
    n = msk.sum(axis=1)
    lam = np.where(n > 0, reg * (n if weighted else 1.0), 1.0)
    A += lam[:, None, None] * np.eye(g.shape[-1])
    return np.linalg.solve(A, b[..., None])[..., 0]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("rank", [4, 20])
def test_solve_bucket_explicit_matches_jax(rank, storage, compute):
    """Every storage dtype, at f32 and bf16 compute, against the JAX
    package -- except int8 storage at bf16 compute. There the JAX program
    states ``g = bf16(bf16(q) * bf16(s))`` (ops/als.py _read_rows), which
    the port computes, but XLA's CPU compiler drops that last rounding on
    the right operand of both products: it computes ``A = sum bf16(g') w
    g'^T`` and ``b = sum r g'`` with ``g' = q * bf16(s)`` unrounded (its
    optimized HLO; the results differ by bf16 rounding times the
    condition number, up to 6% here). So in that case the JAX result is
    held to a float64 restatement of what XLA computes, and the port to
    a float64 restatement of the stated program, both at the 2e-4 bar."""
    rng = np.random.default_rng(rank)
    other = (rng.standard_normal((30, rank)) / np.sqrt(rank)).astype(np.float32)
    jt, tt = _tables(other, storage)
    col, rat, msk = _bucket(rng, 30, 12, 16)
    for weighted in (True, False):
        want = np.asarray(jals.solve_bucket_explicit(
            jt, jnp.asarray(col), jnp.asarray(rat), jnp.asarray(msk), 0.1,
            weighted_reg=weighted, compute_dtype=compute))
        got = tals.solve_bucket_explicit(
            tt, col, rat, msk, 0.1, weighted_reg=weighted, compute_dtype=compute)
        assert np.all(got[1].numpy() == 0.0)  # the empty row solves to 0
        if storage == "int8" and compute == "bfloat16":
            q, s = (np.asarray(a) for a in jt)
            raw = q[col].astype(np.float64) * _bf16(s[col])[..., None]
            stated = _solve_float64(_bf16(raw), _bf16(raw), rat, msk, 0.1, weighted)
            xla_cpu = _solve_float64(_bf16(raw), raw, rat, msk, 0.1, weighted)
            np.testing.assert_allclose(got.numpy(), stated, rtol=2e-4, atol=2e-5)
            np.testing.assert_allclose(want, xla_cpu, rtol=2e-4, atol=2e-5)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_segmented_bucket_solve_and_write_back(storage):
    """A hot row split over 3 table rows, a plain row and a row with no
    ratings; written back into a storage table as the trainer does."""
    rank = 6
    rng = np.random.default_rng(7)
    other = (rng.standard_normal((40, rank)) / np.sqrt(rank)).astype(np.float32)
    jt, tt = _tables(other, storage)
    col, rat, msk = _bucket(rng, 40, 6, 8, empty_row=False)
    msk[4:] = 0.0  # solved row 2 (table rows 4, 5) has no ratings at all
    rat[4:] = 0.0
    seg_row = np.array([0, 0, 0, 1, 2, 2], np.int32)
    params = jals.ALSParams(rank=rank, reg=0.05, compute_dtype="float32",
                            storage_dtype=storage)
    want = np.asarray(jals._solve_bucket_step(
        jt, None, jnp.asarray(col), jnp.asarray(rat), jnp.asarray(msk),
        jnp.asarray(seg_row), params, 3))
    seg_start = torch.from_numpy(tals.segment_offsets(seg_row, 3, 6))
    row_ids = torch.tensor([4, 0, 2], dtype=torch.int32)
    target = tals.to_storage(torch.zeros((5, rank)), storage)
    x = tals.solve_bucket(
        tt, torch.from_numpy(col), torch.from_numpy(rat), torch.from_numpy(msk),
        seg_start, 0.05, target=target, row_ids=row_ids)
    np.testing.assert_allclose(x.numpy(), want, rtol=2e-4, atol=2e-5)
    assert np.all(x[2].numpy() == 0.0)
    # the write-back is _scatter_rows of x, in the JAX package's bits too
    jtarget = jals._scatter_rows(
        jals.to_storage(jnp.zeros((5, rank)), storage), jnp.asarray(row_ids.numpy()),
        jnp.asarray(x.numpy()))
    got = tals.host_factors(target)
    exp = jals.host_factors(jtarget)
    assert np.array_equal(_bits(got[0]), _bits(exp[0]))
    if storage == "int8":
        assert np.array_equal(got[1], exp[1])


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def test_quantize_rows_ties_round_half_to_even():
    s = np.float32(2.0 ** -3)
    row = np.array([127, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5], np.float32) * s
    x = np.stack([row, np.zeros(8, np.float32), -row[::-1]])
    jq, js = jals.quantize_rows(jnp.asarray(x))
    tq, ts = tals.quantize_rows(torch.from_numpy(x))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert tq[0].tolist() == [127, 0, 2, 2, 0, -2, 126, -4]
    assert ts[1].item() == 1.0  # an all-zero row gets scale 1


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_scatter_rows_bit_equal(storage):
    rng = np.random.default_rng(3)
    base = rng.standard_normal((9, 5)).astype(np.float32)
    x = rng.standard_normal((4, 5)).astype(np.float32) * 3
    ids = np.array([8, 0, 3, 5], np.int32)
    jt, tt = _tables(base, storage)
    tals._scatter_rows(tt, torch.from_numpy(ids), torch.from_numpy(x))
    jt = jals._scatter_rows(jt, jnp.asarray(ids), jnp.asarray(x))
    got, exp = tals.host_factors(tt), jals.host_factors(jt)
    assert np.array_equal(_bits(got[0]), _bits(exp[0]))
    if storage == "int8":
        assert np.array_equal(got[1], exp[1])


def _train_both(storage: str, iterations: int = 3, tol: float = 0.0):
    rows, cols, vals = _coo(11, 30, 24, 260)
    n_rows, n_cols, rank = 30, 24, 6
    rng = np.random.default_rng(5)
    U0 = (rng.standard_normal((n_rows, rank)) / np.sqrt(rank)).astype(np.float32)
    V0 = (rng.standard_normal((n_cols, rank)) / np.sqrt(rank)).astype(np.float32)
    kw = dict(rank=rank, iterations=iterations, reg=0.05, storage_dtype=storage,
              bucket_widths=SMALL_WIDTHS)
    jd = jals.build_ratings_data(rows, cols, vals, n_rows, n_cols, SMALL_WIDTHS)
    JU, JV = jals.als_train(jd, jals.ALSParams(**kw), warm_start=(U0, V0), tol=tol)
    jinfo = dict(jals.LAST_TRAIN_INFO)
    td = tals.build_ratings_data(rows, cols, vals, n_rows, n_cols, SMALL_WIDTHS)
    TU, TV = tals.als_train(td, tals.ALSParams(**kw), warm_start=(U0, V0), tol=tol,
                            device="cpu")
    tinfo = dict(tals.LAST_TRAIN_INFO)
    e_jax = jals.rmse(JU, JV, rows, cols, vals)
    e_port = tals.rmse(TU, TV, rows, cols, vals)
    return (JU, JV), (TU, TV), e_jax, e_port, jinfo, tinfo


def test_als_train_f32_matches_jax_from_the_same_init():
    (JU, JV), (TU, TV), e_jax, e_port, _, info = _train_both("float32")
    np.testing.assert_allclose(TU.numpy(), np.asarray(JU), rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(TV.numpy(), np.asarray(JV), rtol=5e-4, atol=5e-5)
    assert abs(e_port - e_jax) <= 1e-4 * e_jax
    assert info == {"iterations_run": 3, "early_stopped": False,
                    "final_rmse": None, "warm_start": True}


@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
def test_als_train_reduced_storage_rmse_matches_jax(storage):
    (JU, _), (TU, _), e_jax, e_port, _, _ = _train_both(storage)
    assert e_port < e_jax * 1.01 + 0.01
    assert e_jax < e_port * 1.01 + 0.01
    assert (TU[0] if storage == "int8" else TU).dtype == getattr(torch, storage)


def test_als_train_tol_stops_where_jax_stops():
    *_, e_jax, e_port, jinfo, tinfo = _train_both("float32", iterations=12, tol=2e-2)
    assert jinfo["early_stopped"] and tinfo["early_stopped"]
    assert tinfo["iterations_run"] == jinfo["iterations_run"] < 12
    assert tinfo["final_rmse"] == pytest.approx(jinfo["final_rmse"], rel=1e-4)
    assert e_port == pytest.approx(e_jax, rel=1e-4)


def test_warm_start_nan_rows_keep_the_cold_draw():
    rows, cols, vals = _coo(2, 10, 8, 40, hot=False)
    data = tals.build_ratings_data(rows, cols, vals, 10, 8)
    p = tals.ALSParams(rank=3, iterations=0, seed=9)
    U_cold, V_cold = tals.als_train(data, p, device="cpu")
    warm_u = np.full((10, 3), np.nan, np.float32)
    warm_u[4] = [1.0, 2.0, 3.0]
    U, V = tals.als_train(data, p, warm_start=(warm_u, np.full((8, 3), np.nan)),
                          device="cpu")
    assert U[4].tolist() == [1.0, 2.0, 3.0]
    keep = np.arange(10) != 4
    assert torch.equal(U[keep], U_cold[keep]) and torch.equal(V, V_cold)
    # the cold draw is the seed's, scale 1/sqrt(rank)
    gen = torch.Generator().manual_seed(9)
    assert torch.equal(U_cold, tals.init_factors(10, 3, gen))


def test_rmse_and_predict_pairs_match_jax():
    rng = np.random.default_rng(4)
    U = rng.standard_normal((7, 5)).astype(np.float32)
    V = rng.standard_normal((6, 5)).astype(np.float32)
    rows = rng.integers(0, 7, 50).astype(np.int32)
    cols = rng.integers(0, 6, 50).astype(np.int32)
    vals = rng.standard_normal(50).astype(np.float32)
    for storage in ("float32", "int8"):
        (ju, tu), (jv, tv) = _tables(U, storage), _tables(V, storage)
        np.testing.assert_allclose(
            tals.predict_pairs(tu, tv, rows, cols).numpy(),
            np.asarray(jals.predict_pairs(ju, jv, rows, cols)), rtol=1e-5, atol=1e-6)
        assert tals.rmse(tu, tv, rows, cols, vals, chunk=16) == pytest.approx(
            jals.rmse(ju, jv, rows, cols, vals), rel=1e-5)


def test_unported_training_options_raise(monkeypatch, tmp_path):
    rows, cols, vals = _coo(3, 6, 5, 12, hot=False)
    data = tals.build_ratings_data(rows, cols, vals)
    # implicit feedback is ported: it trains
    U, V = tals.als_train(data, tals.ALSParams(implicit=True, iterations=1), device="cpu")
    assert bool(torch.isfinite(U).all()) and bool(torch.isfinite(V).all())
    # so is checkpointing (core/checkpoint.py): the env vars no longer
    # raise; they checkpoint and resume, bit-identical to a plain run
    U0, V0 = tals.als_train(data, tals.ALSParams(iterations=4), device="cpu")
    monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.setenv("PIO_CHECKPOINT_EVERY", "2")
    U1, V1 = tals.als_train(data, tals.ALSParams(iterations=4), device="cpu")
    assert len(list(tmp_path.glob("als-*.npz"))) == 1
    monkeypatch.delenv("PIO_CHECKPOINT_EVERY")
    monkeypatch.setenv("PIO_RESUME", "1")
    U2, V2 = tals.als_train(data, tals.ALSParams(iterations=4), device="cpu")
    assert tals.LAST_TRAIN_INFO["iterations_run"] == 2
    for a, b in ((U0, U1), (V0, V1), (U0, U2), (V0, V2)):
        assert torch.equal(a, b)


def test_solve_bucket_checks_its_arguments():
    t = torch.zeros((4, 3))
    col = torch.zeros((2, 2), dtype=torch.int32)
    r = torch.zeros((2, 2))
    with pytest.raises(ValueError, match="compute_dtype"):
        tals.solve_bucket(t, col, r, r, torch.arange(3, dtype=torch.int32), 0.1,
                          compute_dtype="float16")
    with pytest.raises(ValueError, match="row_ids"):
        tals.solve_bucket(t, col, r, r, torch.arange(3, dtype=torch.int32), 0.1,
                          target=torch.zeros((4, 3)))
    # ALSParams keeps every field of the JAX package's, with its defaults
    jfields = jals.ALSParams.__dataclass_fields__
    tfields = tals.ALSParams.__dataclass_fields__
    assert list(tfields) == list(jfields)
    assert all(tfields[f].default == jfields[f].default for f in jfields)
    assert tensor_to_numpy(tals.dense_factors(tals.to_storage(t, "int8"))).shape == (4, 3)


# -- implicit feedback (Hu-Koren-Volinsky) ------------------------------------


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_compute_gram_matches_jax(storage, compute):
    rng = np.random.default_rng(31)
    x = (rng.standard_normal((50, 7)) / np.sqrt(7)).astype(np.float32)
    jt, tt = _tables(x, storage)
    want = np.asarray(jals.compute_gram(jt, compute))
    got = tals.compute_gram(tt, compute)
    assert got.dtype == torch.float32 and got.shape == (7, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def _implicit_float64(gl, gr, gram, rat, msk, reg, alpha, weighted, round_wg):
    """The bf16-compute implicit system of gathered rows ``gl``, ``gr``
    ``[B, K, D]`` (float64) solved in float64: ``A = gram + sum
    wg gr^T + lam I`` (its lower triangle, as a Cholesky reads it) with
    ``wg = bf16(alpha r m) gl``, rounded to bf16 when ``round_wg``, and
    ``b = sum bf16((1 + alpha r) m) gr``."""
    w = _bf16((np.float32(alpha) * rat) * msk)
    r = _bf16((np.float32(1.0) + np.float32(alpha) * rat) * msk)
    wg = w[..., None] * gl
    A = np.tril(np.einsum("bki,bkj->bij", _bf16(wg) if round_wg else wg, gr))
    A = A + np.swapaxes(A, 1, 2) - A * np.eye(gr.shape[-1])
    b = np.einsum("bk,bki->bi", r, gr)
    n = msk.sum(axis=1)
    lam = np.where(n > 0, reg * (n if weighted else 1.0), 1.0)
    A += lam[:, None, None] * np.eye(gr.shape[-1]) + np.asarray(gram, np.float64)
    return np.linalg.solve(A, b[..., None])[..., 0]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_solve_bucket_implicit_matches_jax(storage, compute):
    """Every storage dtype at f32 and bf16 compute, weighted and plain
    reg, against the JAX package's standalone implicit solve.

    At bf16 compute each package is held to a float64 restatement of
    what it computes instead (as in
    :func:`test_solve_bucket_explicit_matches_jax`). The JAX program
    states ``vw = vg * w`` in bf16, which the port computes, but XLA's
    CPU compiler keeps that product unrounded in float32; with the
    implicit weight ``w = alpha * r`` (not 0/1) the two differ by bf16
    rounding times the condition number, up to 5% here. With int8
    storage XLA also leaves the right operand's gather ``q * bf16(s)``
    unrounded (the explicit case's finding)."""
    rank = 5
    rng = np.random.default_rng(41)
    other = (rng.standard_normal((30, rank)) / np.sqrt(rank)).astype(np.float32)
    jt, tt = _tables(other, storage)
    col, rat, msk = _bucket(rng, 30, 12, 16)
    rat = rat * 2  # view counts 1..10
    jgram = jals.compute_gram(jt, compute)
    tgram = tals.compute_gram(tt, compute)
    for weighted in (False, True):
        want = np.asarray(jals.solve_bucket_implicit(
            jt, jgram, jnp.asarray(col), jnp.asarray(rat), jnp.asarray(msk), 0.1, 1.5,
            weighted_reg=weighted, compute_dtype=compute))
        got = tals.solve_bucket_implicit(
            tt, tgram, col, rat, msk, 0.1, 1.5, weighted_reg=weighted,
            compute_dtype=compute)
        assert np.all(got[1].numpy() == 0.0)  # the empty row solves to 0
        if compute == "bfloat16":
            if storage == "int8":
                q, s = (np.asarray(a) for a in jt)
                right = q[col].astype(np.float64) * _bf16(s[col])[..., None]
                g = _bf16(right)
            else:
                g = right = _bf16(tals.dense_factors(tt).numpy()[col])
            args = (tgram.double().numpy(), rat, msk, 0.1, 1.5, weighted)
            stated = _implicit_float64(g, g, *args, round_wg=True)
            xla_cpu = _implicit_float64(g, right, *args, round_wg=False)
            np.testing.assert_allclose(got.numpy(), stated, rtol=5e-4, atol=5e-5)
            np.testing.assert_allclose(want, xla_cpu, rtol=5e-4, atol=5e-5)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("weighted", [False, True])
def test_implicit_segmented_half_step_matches_jax(storage, weighted):
    """The training path's implicit bucket solve: a hot row over 3 table
    rows, a plain row and an empty one, the Gramian of the whole other
    table added after the regularizer (``_finish_bucket_solve``), then
    the write-back of the solved rows in the JAX package's bits."""
    rank = 6
    rng = np.random.default_rng(17)
    other = (rng.standard_normal((40, rank)) / np.sqrt(rank)).astype(np.float32)
    jt, tt = _tables(other, storage)
    col, rat, msk = _bucket(rng, 40, 6, 8, empty_row=False)
    msk[4:] = 0.0
    rat[4:] = 0.0
    seg_row = np.array([0, 0, 0, 1, 2, 2], np.int32)
    params = jals.ALSParams(rank=rank, reg=0.05, implicit=True, alpha=2.5,
                            implicit_weighted_reg=weighted, storage_dtype=storage)
    want = np.asarray(jals._solve_bucket_step(
        jt, jals.compute_gram(jt), jnp.asarray(col), jnp.asarray(rat),
        jnp.asarray(msk), jnp.asarray(seg_row), params, 3))
    seg_start = torch.from_numpy(tals.segment_offsets(seg_row, 3, 6))
    row_ids = torch.tensor([4, 0, 2], dtype=torch.int32)
    target = tals.to_storage(torch.zeros((5, rank)), storage)
    x = tals.solve_bucket(
        tt, torch.from_numpy(col), torch.from_numpy(rat), torch.from_numpy(msk),
        seg_start, 0.05, weighted_reg=weighted, target=target, row_ids=row_ids,
        implicit=True, alpha=2.5, gram=tals.compute_gram(tt))
    np.testing.assert_allclose(x.numpy(), want, rtol=5e-4, atol=5e-5)
    jtarget = jals._scatter_rows(
        jals.to_storage(jnp.zeros((5, rank)), storage), jnp.asarray(row_ids.numpy()),
        jnp.asarray(x.numpy()))
    got, exp = tals.host_factors(target), jals.host_factors(jtarget)
    assert np.array_equal(_bits(got[0]), _bits(exp[0]))
    if storage == "int8":
        assert np.array_equal(got[1], exp[1])


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_indefinite_implicit_row_is_nan_like_jax(storage):
    """Ratings [-1, -1, -1, 1] at alpha 5 (dislikes) make A indefinite:
    both packages solve the row to NaN, NaN for NaN, and leave its
    neighbours finite; an int8 write-back stores q = 0 with scale 1."""
    other = np.eye(4, dtype=np.float32)
    jt, tt = _tables(other, storage)
    col = np.array([[0, 1, 2, 3], [0, 1, 0, 0]], np.int32)
    rat = np.array([[-1, -1, -1, 1], [3, 1, 0, 0]], np.float32)
    msk = np.array([[1, 1, 1, 1], [1, 1, 0, 0]], np.float32)
    want = np.asarray(jals.solve_bucket_implicit(
        jt, jals.compute_gram(jt), jnp.asarray(col), jnp.asarray(rat),
        jnp.asarray(msk), 0.01, 5.0))
    target = tals.to_storage(torch.ones((3, 4)), storage)
    got = tals.solve_bucket(
        tt, torch.from_numpy(col), torch.from_numpy(rat), torch.from_numpy(msk),
        torch.arange(3, dtype=torch.int32), 0.01, weighted_reg=False, target=target,
        row_ids=torch.tensor([2, 0], dtype=torch.int32), implicit=True, alpha=5.0,
        gram=tals.compute_gram(tt)).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0]).all() and np.isfinite(got[1]).all()
    np.testing.assert_allclose(got[1], want[1], rtol=5e-4, atol=5e-5)
    jtarget = jals._scatter_rows(jals.to_storage(jnp.ones((3, 4)), storage),
                                 jnp.asarray([2, 0], jnp.int32), jnp.asarray(got))
    (tv, ts), (jv, js) = tals.host_factors(target), jals.host_factors(jtarget)
    if storage == "int8":
        assert tv[2].tolist() == np.asarray(jv)[2].tolist() == [0, 0, 0, 0]
        assert ts[2] == np.asarray(js)[2] == 1.0
        assert np.array_equal(tv, np.asarray(jv)) and np.array_equal(ts, np.asarray(js))
    else:
        t32 = tals.dense_factors(target).numpy()
        assert np.isnan(t32[2]).all() and np.array_equal(t32[0], got[1].astype(
            np.float32) if storage == "float32" else t32[0])


def _like_coo(seed: int, n_users: int, n_items: int):
    """Implicit signals: view counts 1..6, and a few dislikes (-1)."""
    rows, cols, _ = _coo(seed, n_users, n_items, n_users * 6, hot=False)
    rng = np.random.default_rng(seed)
    vals = rng.integers(1, 7, len(rows)).astype(np.float32)
    return rows, cols, vals


def _train_implicit_both(storage: str, alpha: float, vals_fn=None, iterations: int = 3):
    rows, cols, vals = _like_coo(13, 28, 20)
    if vals_fn is not None:
        vals = vals_fn(vals)
    n_rows, n_cols, rank = 28, 20, 5
    rng = np.random.default_rng(8)
    U0 = (rng.standard_normal((n_rows, rank)) / np.sqrt(rank)).astype(np.float32)
    V0 = (rng.standard_normal((n_cols, rank)) / np.sqrt(rank)).astype(np.float32)
    kw = dict(rank=rank, iterations=iterations, reg=0.05, implicit=True, alpha=alpha,
              storage_dtype=storage, bucket_widths=SMALL_WIDTHS)
    jd = jals.build_ratings_data(rows, cols, vals, n_rows, n_cols, SMALL_WIDTHS)
    JU, JV = jals.als_train(jd, jals.ALSParams(**kw), warm_start=(U0, V0))
    td = tals.build_ratings_data(rows, cols, vals, n_rows, n_cols, SMALL_WIDTHS)
    TU, TV = tals.als_train(td, tals.ALSParams(**kw), warm_start=(U0, V0), device="cpu")
    jx = [np.asarray(jals.dense_factors(t)) for t in (JU, JV)]
    tx = [tals.dense_factors(t).numpy() for t in (TU, TV)]
    return jx, tx


def test_als_train_implicit_f32_matches_jax_from_the_same_init():
    (JU, JV), (TU, TV) = _train_implicit_both("float32", alpha=2.0)
    np.testing.assert_allclose(TU, JU, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(TV, JV, rtol=5e-4, atol=5e-5)


def _row_cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(1) / np.maximum(
        np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-30)


@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
def test_als_train_implicit_reduced_storage_matches_jax(storage):
    (JU, JV), (TU, TV) = _train_implicit_both(storage, alpha=2.0)
    for j, t in ((JU, TU), (JV, TV)):
        assert np.array_equal(np.isnan(j).any(1), np.isnan(t).any(1))
        ok = ~np.isnan(j).any(1)
        assert _row_cosines(j[ok], t[ok]).min() >= 0.999


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_als_train_implicit_dislikes_nan_rows_like_jax(storage):
    """Dislikes (-1) at alpha 5 make some users' systems indefinite: one
    iteration leaves those user rows NaN in both packages, and every
    solved item row NaN too (the next half-step's Gramian of U is NaN);
    the other user rows agree as in the other implicit trainings. int8
    storage writes a NaN row back as zeros with scale 1, so there the
    same users come back as zero rows and the items stay finite."""
    def with_dislikes(vals):
        out = vals.copy()
        out[::3] = -1.0
        return out

    (JU, JV), (TU, TV) = _train_implicit_both(storage, alpha=5.0,
                                              vals_fn=with_dislikes, iterations=1)
    for j, t in ((JU, TU), (JV, TV)):
        assert np.array_equal(np.isnan(j), np.isnan(t))
    if storage == "int8":
        nan_u = ~TU.any(1)
        assert np.array_equal(nan_u, ~JU.any(1)) and np.isfinite(TV).all()
    else:
        nan_u = np.isnan(TU).any(1)
        assert np.isnan(TV).all()
    assert 0 < nan_u.sum() < len(nan_u)
    if storage == "float32":
        np.testing.assert_allclose(TU[~nan_u], JU[~nan_u], rtol=5e-4, atol=5e-5)
    else:
        assert _row_cosines(JU[~nan_u], TU[~nan_u]).min() >= 0.999


# -- K1's routes on the card (csrc/als_solve.cu): the rule and its sums --------


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("D", [1, 32, 33, 128])
def test_k1_route_by_rank_and_bucket_shape(D, segmented):
    """The warp route up to WARP_MAX_RANK (one launch when every solved
    row is one table row, two for a segmented bucket); the block kernel,
    one launch, above it."""
    R, B = (50, 80) if segmented else (50, 50)
    want = ("split" if segmented else "warp") if D <= 32 else "block"
    assert tals.k1_route(D, R, B) == want
    assert tals.k1_launches(D, R, B) == (2 if want == "split" else 1)


def test_k1_route_refuses_ranks_out_of_range():
    for D in (0, tals.MAX_RANK + 1):
        with pytest.raises(ValueError, match="ranks"):
            tals.k1_route(D, 4, 4)


def test_k1_route_bound_matches_the_kernel_source():
    src = (Path(tals.__file__).resolve().parent.parent / "csrc" / "als_solve.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["WARP_MAX_D"]) == tals.WARP_MAX_RANK == 32
    assert int(consts["MAX_D"]) == tals.MAX_RANK


@pytest.mark.parametrize("rank", [6, 20, 33])
def test_k1_launches_per_iteration_of_a_segmented_layout(rank):
    """One launch per bucket, two for each segmented bucket on the warp
    route: the count an iteration's ``solve_bucket.launches`` moves by on
    the card. The layout of ``_train_both`` (hot row 0 and column 1
    segment over the widest bucket) is the JAX package's too."""
    rows, cols, vals = _coo(11, 30, 24, 260)
    td = tals.build_ratings_data(rows, cols, vals, 30, 24, SMALL_WIDTHS)
    jd = jals.build_ratings_data(rows, cols, vals, 30, 24, SMALL_WIDTHS)
    buckets = td.row_buckets + td.col_buckets
    segmented = sum(b.seg_row is not None for b in buckets)
    assert segmented == 2  # the hot row and the hot column
    got = sum(tals.k1_launches(rank, len(b.row_ids), b.col_ids.shape[0]) for b in buckets)
    assert got == len(buckets) + (segmented if rank <= tals.WARP_MAX_RANK else 0)
    assert got == sum(tals.k1_launches(rank, len(b.row_ids), b.col_ids.shape[0])
                      for b in jd.row_buckets + jd.col_buckets)


def test_block_entry_point_needs_cuda():
    t = torch.zeros((4, 3))
    col = torch.zeros((2, 2), dtype=torch.int32)
    r = torch.zeros((2, 2))
    with pytest.raises(ValueError, match="device"):
        tals._solve_bucket_block(t, col, r, r, torch.arange(3, dtype=torch.int32), 0.1)


def _segmented_bucket(rng, counts, K: int, n_other: int):
    """(col, rat, msk, seg_start) of a bucket whose solved row r has
    ``counts[r]`` entries over ceil(n / K) >= 1 consecutive table rows."""
    nseg = [max(1, -(-n // K)) for n in counts]
    seg_start = np.concatenate([[0], np.cumsum(nseg)]).astype(np.int32)
    B = int(seg_start[-1])
    col = np.zeros((B * K,), np.int32)
    rat = np.zeros((B * K,), np.float32)
    msk = np.zeros((B * K,), np.float32)
    for r, n in enumerate(counts):
        for s0 in range(0, n, K):  # each segment packed to its front
            m = min(K, n - s0)
            lo = int(seg_start[r]) * K + s0
            col[lo:lo + m] = rng.integers(0, n_other, m)
            rat[lo:lo + m] = rng.integers(1, 11, m) / 2.0
            msk[lo:lo + m] = 1.0
    return col.reshape(B, K), rat.reshape(B, K), msk.reshape(B, K), seg_start


def _split_route_sum(other, col, rat, msk, seg_start, reg, weighted, implicit, alpha, gram):
    """The warp route's two launches on a segmented bucket, stated in
    plain torch (f32): each table row's A, b and n, then each solved
    row's segments summed in segment order starting from the first
    partial (no +0.0 start), regularized, the Gramian added after the
    regularizer (implicit), solved by Cholesky."""
    w, r = tals._bucket_weights(rat, msk, torch.float32, implicit, alpha)
    g = tals._read_rows(other, col.long(), torch.float32)
    A_t = torch.bmm((g * w[..., None]).transpose(1, 2), g)
    b_t = torch.bmm(r[:, None, :], g)[:, 0]
    n_t = msk.sum(1)
    R, D = seg_start.shape[0] - 1, g.shape[-1]
    A, b, n = torch.zeros((R, D, D)), torch.zeros((R, D)), torch.zeros(R)
    for i in range(R):
        s0, s1 = int(seg_start[i]), int(seg_start[i + 1])
        if s1 > s0:
            A[i], b[i], n[i] = A_t[s0], b_t[s0], n_t[s0]
        for s in range(s0 + 1, s1):
            A[i], b[i], n[i] = A[i] + A_t[s], b[i] + b_t[s], n[i] + n_t[s]
    lam = torch.where(n > 0, reg * n if weighted else torch.full_like(n, reg),
                      torch.ones_like(n))
    A = A + lam[:, None, None] * torch.eye(D)
    if implicit:
        A = A + gram
    return tals._cholesky_solve(A, b)


@pytest.mark.parametrize("implicit", [False, True])
def test_split_route_summation_matches_the_plain_version(implicit):
    """Rows of 1, 2 and 33 segments (and an empty one) at D = 20: the
    split route's order of sums against ``solve_bucket_reference`` (per
    table row, then ``index_add_`` over the segments), each solve within
    atol 1e-5 + rtol 1e-4 * max|x| of its row (normwise, chip_smoke.py's
    per-solve bar); the empty row exact zeros in both."""
    D, K = 20, 8
    rng = np.random.default_rng(23)
    other = torch.from_numpy(
        (rng.standard_normal((300, D)) / np.sqrt(D)).astype(np.float32))
    counts = [5, 12, 33 * K - 3, 0, 7, 2 * K]
    col, rat, msk, seg_start = (torch.from_numpy(a) for a in
                                _segmented_bucket(rng, counts, K, 300))
    assert np.diff(seg_start.numpy()).tolist() == [1, 2, 33, 1, 1, 2]
    if implicit:
        rat = rat * 2
    gram = tals.compute_gram(other) if implicit else None
    weighted = not implicit
    got = _split_route_sum(other, col, rat, msk, seg_start, 0.05, weighted, implicit,
                           1.5, gram)
    want = tals.solve_bucket_reference(
        other, col, rat, msk, 0.05, tals.seg_rows(seg_start, col.shape[0]), len(counts),
        weighted_reg=weighted, implicit=implicit, alpha=1.5, gram=gram)
    err = (got.double() - want.double()).abs().amax(dim=1)
    assert bool((err <= 1e-5 + 1e-4 * want.double().abs().amax(dim=1)).all())
    assert bool((got[3] == 0).all()) and bool((want[3] == 0).all())
    assert bool(torch.isfinite(got).all())
