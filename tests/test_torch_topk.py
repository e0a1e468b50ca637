"""The port's K2 (``predictionio_tpu_torch.ops.topk``) against the JAX
package's ``gather_top_k_batch`` and ``sum_rows_top_k_batch`` (K2's
summed-rows mode), on the CPU.

On CPU tensors the port's wrapper runs its plain PyTorch version, which
is what the CUDA kernel is held to on the card (chip_smoke.py). Both
packages get the same numpy inputs, bit for bit (bf16 tables are handed
over as their bits). Tolerances: exact-integer inputs (every score an
exact f32 sum) must agree bit for bit in ids and scores, ties, signed
zeros and NaN included; random-normal inputs within rtol=1e-5,
atol=1e-6 (the two sum the D products in different orders), with ids
equal outside runs of near-tied scores, where the id sets must match.
The same bars hold the summed-rows mode on row-normalized catalogs
(f32 and the int8 pair); within the port, a summed-rows query is bit
for bit the same alone or in a batch, and at L or 2L weight-0 padding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.models import filters as jfilters
from predictionio_tpu.ops import als as jals
from predictionio_tpu.ops import topk as jtopk
from predictionio_tpu_torch.ops import als as tals
from predictionio_tpu_torch.ops import topk as ttopk

DTYPES = ("float32", "bfloat16", "int8")
PAIRS = [(u, v) for u in DTYPES for v in DTYPES]
N_USERS, N_ITEMS = 30, 40
RTOL, ATOL = 1e-5, 1e-6


def _tables(rng, dtype: str, rows: int, rank: int, exact: bool, nan_row=None):
    """(jax table, torch table) with identical bits."""
    if dtype == "int8":
        if exact:
            q = rng.integers(-8, 9, (rows, rank)).astype(np.int8)
            s = (2.0 ** rng.integers(-2, 3, rows)).astype(np.float32)
        else:
            jq, js = jals.quantize_rows(
                jnp.asarray(rng.standard_normal((rows, rank), dtype=np.float32))
            )
            q, s = np.asarray(jq), np.asarray(js)
        return (jnp.asarray(q), jnp.asarray(s)), (
            torch.from_numpy(q.copy()), torch.from_numpy(s.copy()),
        )
    if exact:
        x = rng.integers(-3, 4, (rows, rank)).astype(np.float32)
    else:
        x = rng.standard_normal((rows, rank), dtype=np.float32)
    if nan_row is not None:
        x[nan_row, 0] = np.nan
    if dtype == "bfloat16":
        jx = jnp.asarray(x, dtype=jnp.bfloat16)
        bits = np.asarray(jx).view(np.int16).copy()
        return jx, torch.from_numpy(bits).view(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _both(ixs, jt_users, jt_items, tt_users, tt_items, k, mask=None):
    """Both packages' answers at ``k``. The JAX side is asked once for
    the whole catalog and sliced: ``lax.top_k``'s prefix is k-invariant
    (the contract batch_predict's pow2 k rests on), and each distinct k
    would be another XLA compile."""
    n = jtopk.catalog_rows(jt_items)
    js, ji = jtopk.gather_top_k_batch(
        ixs, jt_users, jt_items, k=n,
        exclude_mask=None if mask is None else jnp.asarray(mask),
    )
    ts, ti = ttopk.gather_top_k_batch(
        torch.from_numpy(ixs), tt_users, tt_items, k,
        exclude_mask=None if mask is None else torch.from_numpy(mask),
    )
    k = min(k, n)
    return np.asarray(js)[:, :k], np.asarray(ji)[:, :k], ts.numpy(), ti.numpy()


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """f32 arrays equal bit for bit; any NaN equals any NaN."""
    na, nb = np.isnan(a), np.isnan(b)
    return np.array_equal(na, nb) and np.array_equal(
        a[~na].view(np.int32), b[~nb].view(np.int32)
    )


def _ids_match_outside_near_ties(ids_a, ids_b, scores_b) -> bool:
    """Row ids equal, except inside runs of adjacent scores closer than
    RTOL (relative), where the sets must match; the run reaching the end
    of the row may hold other near-tied ids."""
    n = len(ids_b)
    close = np.abs(np.diff(scores_b)) <= RTOL * np.maximum(
        np.abs(scores_b[:-1]), np.abs(scores_b[1:])) + ATOL
    start = 0
    for j in range(1, n + 1):
        if j == n or not close[j - 1]:
            if j != n and set(ids_a[start:j]) != set(ids_b[start:j]):
                return False
            start = j
    return len(set(ids_a.tolist())) == n


@pytest.mark.parametrize("udt,vdt", PAIRS)
def test_exact_inputs_bitwise(udt, vdt):
    rng = np.random.default_rng(100 + PAIRS.index((udt, vdt)))
    for rank in (3, 8, 20):
        ju, tu = _tables(rng, udt, N_USERS, rank, exact=True)
        # a NaN factor gives every user one NaN score (dense catalogs)
        jv, tv = _tables(rng, vdt, N_ITEMS, rank, exact=True,
                         nan_row=None if vdt == "int8" else 5)
        ixs = rng.integers(0, N_USERS, 7).astype(np.int32)
        mask = rng.random(N_ITEMS) < 0.25
        for k in (1, 4, 16, N_ITEMS, N_ITEMS + 5):
            for m in (None, mask):
                js, ji, ts, ti = _both(ixs, ju, jv, tu, tv, k, m)
                what = f"D={rank} k={k} mask={m is not None}"
                assert ts.shape == (7, min(k, N_ITEMS)), what
                assert ti.dtype == np.int32 and ts.dtype == np.float32
                np.testing.assert_array_equal(ti, ji, err_msg=what)
                assert _same_bits(ts, js), what


@pytest.mark.parametrize("udt,vdt", PAIRS)
def test_random_inputs_within_tolerance(udt, vdt):
    rng = np.random.default_rng(7 + DTYPES.index(udt) * 3 + DTYPES.index(vdt))
    ju, tu = _tables(rng, udt, N_USERS, 20, exact=False)
    jv, tv = _tables(rng, vdt, N_ITEMS, 20, exact=False)
    ixs = rng.integers(0, N_USERS, 9).astype(np.int32)
    mask = rng.random(N_ITEMS) < 0.25
    for k in (4, N_ITEMS):
        for m in (None, mask):
            js, ji, ts, ti = _both(ixs, ju, jv, tu, tv, k, m)
            np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)
            for r in range(len(ixs)):
                assert _ids_match_outside_near_ties(ti[r], ji[r], js[r])


@pytest.mark.parametrize("udt,vdt", PAIRS)
def test_row_is_batch_size_invariant(udt, vdt):
    rng = np.random.default_rng(11)
    _, tu = _tables(rng, udt, N_USERS, 20, exact=False)
    _, tv = _tables(rng, vdt, N_ITEMS, 20, exact=False)
    ixs = torch.from_numpy(rng.integers(0, N_USERS, 17).astype(np.int32))
    s17, i17 = ttopk.gather_top_k_batch(ixs, tu, tv, 16)
    for r in (0, 8, 16):
        s1, i1 = ttopk.gather_top_k_batch(ixs[r:r + 1], tu, tv, 16)
        assert torch.equal(i1[0], i17[r])
        assert torch.equal(s1[0].view(torch.int32), s17[r].view(torch.int32))


def _crafted_rows() -> np.ndarray:
    """Score rows of ties, signed zeros, NaN of both signs and infinities."""
    rng = np.random.default_rng(3)
    rows = rng.integers(-2, 3, (5, 50)).astype(np.float32)
    rows[0] = np.tile(np.array([-0.0, 0.0, -0.0], np.float32), 17)[:50]
    rows[1, ::7] = np.nan
    rows[1, 3::11] = np.array([-1], np.int32).view(np.float32)[0]  # -NaN
    rows[2, ::5] = np.inf
    rows[2, 2::9] = -np.inf
    rows[3] = 0.0
    return rows


@pytest.mark.parametrize("k", [1, 3, 4, 16, 50])
def test_selection_order_matches_lax_top_k(k):
    rows = _crafted_rows()
    js, ji = jax.lax.top_k(jnp.asarray(rows), k)
    ts, ti = ttopk.top_k_rows(torch.from_numpy(rows), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(
        ts.numpy().view(np.int32), np.asarray(js).view(np.int32)
    )


def test_signed_zero_order():
    # lax.top_k ranks +0.0 above -0.0; a float sort would keep index order
    _, ids = ttopk.top_k_rows(torch.tensor([[-0.0, 0.0, -0.0]]), 3)
    assert ids.tolist() == [[1, 0, 2]]


def test_quantize_rows_matches_jax():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((64, 20), dtype=np.float32) * 10.0 ** rng.integers(
        -3, 4, (64, 1))).astype(np.float32)
    x[3] = 0.0  # all-zero row -> scale 1
    x[7, 2] = 127.0 * 3.0
    jq, js = jals.quantize_rows(jnp.asarray(x))
    tq, ts = tals.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    np.testing.assert_array_equal(
        tals.dequantize_rows(tq, ts).numpy(),
        np.asarray(jals.dequantize_rows(jq, js)),
    )


def test_table_helpers():
    q = torch.zeros((6, 4), dtype=torch.int8)
    s = torch.ones(6)
    assert tals.table_rows((q, s)) == 6 and tals.table_dim((q, s)) == 4
    assert ttopk.catalog_rows((q, s)) == 6
    dense = torch.zeros((5, 3), dtype=torch.bfloat16)
    assert tals.table_rows(dense) == 5 and tals.table_dim(dense) == 3
    values, scales = tals.host_factors(dense)
    assert values.dtype.names == ("bfloat16",) and scales is None


def test_host_indices_are_range_checked_before_a_launch():
    with pytest.raises(IndexError):
        ttopk._user_ixs([0, 30], 30, torch.device("cpu"))


def test_kernel_inputs_are_checked_before_a_launch():
    with pytest.raises(ValueError, match="scales"):
        ttopk._split(torch.zeros((3, 2), dtype=torch.int8), "items")
    with pytest.raises(ValueError, match="contiguous"):
        ttopk._split(torch.zeros((2, 3)).T, "items")
    with pytest.raises(ValueError, match="float32/bfloat16/int8"):
        ttopk._split(torch.zeros((3, 2), dtype=torch.float64), "items")
    values, scales, code = ttopk._split(
        (torch.zeros((3, 2), dtype=torch.int8), torch.ones(3)), "items")
    assert code == 2 and scales.shape == (3,)


def test_kernel_build_needs_nvcc(monkeypatch):
    from predictionio_tpu_torch.kernels import _build

    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.nvcc_path()
    count = _build.LaunchCount()
    count.add()
    count.add()
    assert count.value == 2
    count.reset()
    assert count.value == 0


# -- K2's summed-rows mode (ops/topk.py:135 sum_rows_top_k_batch) -------------


def _catalog(rng, storage: str, exact: bool):
    """(jax table, torch table): a row-normalized catalog as the cosine
    templates build it (JAX ``normalized_device_factors``), or for
    ``exact`` a small-integer f32 catalog whose every score is exact."""
    if exact:
        x = rng.integers(-3, 4, (N_ITEMS, 8)).astype(np.float32)
        return jnp.asarray(x), torch.from_numpy(x.copy())
    x = rng.standard_normal((N_ITEMS, 8), dtype=np.float32)
    if storage == "int8":
        q, s = (np.asarray(a) for a in jals.quantize_rows(jnp.asarray(x)))
        (jq, js), _ = jfilters.normalized_device_factors(q, s)
        jq, js = np.asarray(jq), np.asarray(js)
        return (jnp.asarray(jq), jnp.asarray(js)), (
            torch.from_numpy(jq.copy()), torch.from_numpy(js.copy()))
    table, _ = jfilters.normalized_device_factors(x)
    return table, torch.from_numpy(np.asarray(table).copy())


def _query_rows(rng, batch: int, width: int):
    """[B, L] row lists of 1..L distinct items, right-padded with
    weight-0 copies of row 0 (the template's padding)."""
    ixs = np.zeros((batch, width), np.int32)
    w = np.zeros((batch, width), np.float32)
    for b in range(batch):
        n = int(rng.integers(1, width + 1))
        ixs[b, :n] = rng.choice(N_ITEMS, n, replace=False)
        w[b, :n] = 1.0
    return ixs, w


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("storage,exact", [("float32", True), ("float32", False),
                                           ("int8", False)])
def test_sum_rows_matches_jax(storage, exact, masked):
    rng = np.random.default_rng(60 + 2 * DTYPES.index(storage) + exact)
    jv, tv = _catalog(rng, storage, exact)
    mask = (rng.random(N_ITEMS) < 0.25) if masked else None
    for width in (1, 4, 16):
        ixs, w = _query_rows(rng, 6, width)
        js, ji = jtopk.sum_rows_top_k_batch(
            jnp.asarray(ixs), jnp.asarray(w), jv, k=N_ITEMS,
            exclude_mask=None if mask is None else jnp.asarray(mask))
        js, ji = np.asarray(js), np.asarray(ji)
        for k in (4, 16, N_ITEMS):
            ts, ti = ttopk.sum_rows_top_k_batch(
                ixs, w, tv, k, None if mask is None else torch.from_numpy(mask))
            ts, ti = ts.numpy(), ti.numpy()
            assert ts.shape == ti.shape == (6, k) and ti.dtype == np.int32
            if exact:
                np.testing.assert_array_equal(ti, ji[:, :k])
                assert _same_bits(ts, js[:, :k])
                continue
            np.testing.assert_allclose(ts, js[:, :k], rtol=RTOL, atol=ATOL)
            for r in range(len(ixs)):
                assert _ids_match_outside_near_ties(ti[r], ji[r, :k], js[r, :k])


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_sum_rows_batch_and_padding_invariant(storage):
    """A query's bits alone equal its row in a batch, and padding its row
    list from L to 2L with weight-0 copies of row 0 changes no bit."""
    rng = np.random.default_rng(71)
    _, tv = _tables(rng, storage, N_ITEMS, 12, exact=False)
    ixs, w = _query_rows(rng, 9, 4)
    s9, i9 = ttopk.sum_rows_top_k_batch(ixs, w, tv, 16)
    pad = np.zeros_like(ixs)
    s2l, i2l = ttopk.sum_rows_top_k_batch(
        np.concatenate([ixs, pad], 1), np.concatenate([w, pad.astype(np.float32)], 1),
        tv, 16)
    assert torch.equal(i2l, i9) and torch.equal(s2l.view(torch.int32), s9.view(torch.int32))
    for r in (0, 4, 8):
        s1, i1 = ttopk.sum_rows_top_k_batch(ixs[r:r + 1], w[r:r + 1], tv, 16)
        assert torch.equal(i1[0], i9[r])
        assert torch.equal(s1[0].view(torch.int32), s9[r].view(torch.int32))


def test_sum_rows_checks_its_arguments():
    tv = torch.zeros((N_ITEMS, 4))
    with pytest.raises(IndexError):
        ttopk._indices([[0, N_ITEMS]], N_ITEMS, torch.device("cpu"))
    assert ttopk._indices([[1, 2]], N_ITEMS, torch.device("cpu")).shape == (1, 2)
    s, i = ttopk.sum_rows_top_k_batch(np.zeros((2, 0), np.int32),
                                      np.zeros((2, 0), np.float32), tv, 3)
    assert s.shape == (2, 3) and bool((s == 0).all())  # L = 0: a zero query


@pytest.mark.parametrize("storage", DTYPES)
def test_catalog_norms_matches_jax(storage):
    rng = np.random.default_rng(81)
    jt, tt = _tables(rng, storage, N_ITEMS, 10, exact=False)
    got = ttopk.catalog_norms(tt)
    assert got.dtype == torch.float32 and got.shape == (N_ITEMS,)
    np.testing.assert_allclose(got.numpy(), np.asarray(jtopk.catalog_norms(jt)),
                               rtol=1e-6, atol=1e-7)
