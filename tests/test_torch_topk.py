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

import re
from pathlib import Path

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


# -- K2's tile route (csrc/topk.cu tile_topk_kernel + merge_topk_kernel) -------
#
# The kernel cannot run here; its selection can. _tile_then_merge states
# it in plain torch, step for step and lane for lane: a warp's register is
# a [..., 32] tensor, a shuffle a gather over its last axis (source lanes
# modulo 32, as __shfl_sync takes them). The same composites; per
# 128-item chunk, for g <= 32, groups of g sorted, adjacent groups
# merged and registers packed down to one group, else a full bitonic
# sort; chunks folded into the tile's list; each tile's top g written;
# then the merge block's 32 warps (for g <= 32 reading the row's lists in
# order, 1,024 composites a round; else folding lists w, w + 32, ...)
# and the warps' lists folded pairwise, halving. Held bit for bit to
# top_k_rows_reference and to lax.top_k on crafted rows, it checks the
# networks' masks and shuffle sources and the claim that the top k of the
# tiles' top k's is the row's top k in lax.top_k order.

_PAD = torch.iinfo(torch.int64).min  # the kernel's composite 0, no item's
_LANE = torch.arange(32)
_MERGE_WARPS = 32  # csrc/topk.cu MERGE_WARPS
_MERGE_LOADS = ttopk.K2_MERGE_CAP // (32 * _MERGE_WARPS)  # LOADS
_GROUP_MAX_G = 32  # GROUP_MAX_G


def _composites(scores: torch.Tensor) -> torch.Tensor:
    """The kernel's u64 composite ``order_key << 32 | ~i`` minus 2^63, as
    int64: the same order, and the kernel's 0 becomes int64's minimum."""
    key = ttopk.order_key(scores).to(torch.int64)
    i = torch.arange(scores.shape[1], dtype=torch.int64)
    return key * 2**32 + (2**32 - 1 - i)


def _order_key_inverse(keys: torch.Tensor) -> torch.Tensor:
    """The f32 scores whose ``order_key`` is ``keys`` (int32), as the
    kernel's composite_score recovers them: the key maps negative floats
    by ``bits ^ 0x7FFFFFFF``, an involution on them, so it is its own
    inverse."""
    keys = keys.to(torch.int32)
    return torch.where(keys < 0, keys ^ 0x7FFFFFFF, keys).view(torch.float32)


def _lane_stage(v, m: int, s: int):
    o = v[..., _LANE ^ m]
    return torch.where((_LANE & s) == 0, torch.maximum(v, o), torch.minimum(v, o))


def _sort_groups(v, g: int):
    size = 2
    while size <= g:
        v = _lane_stage(v, size - 1, size // 2)
        s = size // 4
        while s > 0:
            v = _lane_stage(v, s, s)
            s //= 2
        size *= 2
    return v


def _merge_pairs(v, g: int):
    v = _lane_stage(v, 2 * g - 1, g)
    s = g // 2
    while s > 0:
        v = _lane_stage(v, s, s)
        s //= 2
    return v


def _pack_pairs(a, b, g: int):
    return torch.where((_LANE & g) != 0, b[..., (_LANE - g) % 32], a)


def _top_of_groups(v, g: int):
    n = 32 // g
    while n > 1:
        v = _merge_pairs(v, g)
        if n > 2:
            v = v[..., (_LANE + (_LANE & ~(g - 1))) % 32]  # compact_pairs
        n //= 2
    return v


def _fold_group(best, w, g: int):
    r = torch.maximum(best, w[..., (g - 1 - _LANE) % 32])
    s = g // 2
    while s > 0:
        r = _lane_stage(r, s, s)
        s //= 2
    return r


def _stage(a, size: int, stride: int):
    """warp_stage on [..., 32 * E] lists in entry order (x = lane + 32 * e):
    x and x ^ stride exchange, the lower index ending with the larger
    where x's ``size`` bit is clear."""
    x = torch.arange(a.shape[-1])
    lo = x[(x & stride) == 0]
    hi = lo + stride
    desc = (lo & size) == 0
    u, v = a[..., lo], a[..., hi]
    big, small = torch.maximum(u, v), torch.minimum(u, v)
    a[..., lo] = torch.where(desc, big, small)
    a[..., hi] = torch.where(desc, small, big)


def _sort(a):
    n, size = a.shape[-1], 2
    while size <= n:
        stride = size // 2
        while stride > 0:
            _stage(a, size, stride)
            stride //= 2
        size *= 2


def _fold(best, w):
    """warp_fold: the top n of two sorted lists, sorted."""
    n = best.shape[-1]
    best[:] = torch.maximum(best, w.flip(-1))
    stride = n // 2
    while stride > 0:
        _stage(best, 2 * n, stride)
        stride //= 2


def _tile_lists(comp, route) -> list:
    """Each tile's top g (tile_topk_kernel)."""
    B, I = comp.shape
    g, W, C = route.group, route.width, ttopk.K2_CHUNK
    lists = []
    for tile in range(route.tiles):
        best = None
        for c0 in range(tile * W, min(I, (tile + 1) * W), C):
            cand = torch.full((B, C), _PAD)
            n = min(C, I - c0)
            cand[:, :n] = comp[:, c0:c0 + n]
            if g <= _GROUP_MAX_G:
                c = _sort_groups(cand.view(B, 4, 32), g)
                if g < 32:
                    c = _merge_pairs(c, g)
                    two = _merge_pairs(torch.stack(
                        [_pack_pairs(c[:, 0], c[:, 1], g), _pack_pairs(c[:, 2], c[:, 3], g)],
                        1), g)
                    top = _top_of_groups(_pack_pairs(two[:, 0], two[:, 1], g), g)
                else:
                    top = _fold_group(_fold_group(c[:, 0], c[:, 1], g),
                                      _fold_group(c[:, 2], c[:, 3], g), g)
                best = top if best is None else _fold_group(best, top, g)
            else:
                _sort(cand)
                if best is None:
                    best = cand
                else:
                    _fold(best, cand)
        lists.append(best[:, :g])
    return lists


def _merge(lists, g: int, k: int):
    """The row's top k of its tiles' lists (merge_topk_kernel)."""
    B, T = lists[0].shape[0], len(lists)
    flat = torch.cat(lists, 1)
    if g <= 32:
        loads = torch.full((B, _MERGE_LOADS * 32 * _MERGE_WARPS), _PAD)
        loads[:, :T * g] = flat
        loads = loads.view(B, _MERGE_LOADS, _MERGE_WARPS, 32)
        warps = _top_of_groups(loads[:, 0], g)
        for r in range(1, _MERGE_LOADS):
            if r * 32 * _MERGE_WARPS < T * g:
                warps = _fold_group(warps, _top_of_groups(loads[:, r], g), g)
        fold = _fold_group
    else:
        warps = torch.full((B, _MERGE_WARPS, g), _PAD)
        for w in range(min(T, _MERGE_WARPS)):
            warps[:, w] = lists[w]
            for t in range(w + _MERGE_WARPS, T, _MERGE_WARPS):
                _fold(warps[:, w], lists[t])

        def fold(a, b, g):
            a = a.clone()
            _fold(a, b)
            return a
    half = _MERGE_WARPS // 2
    while half > 0:
        warps[:, :half] = fold(warps[:, :half], warps[:, half:2 * half], g)
        half //= 2
    return warps[:, 0, :k]


def _tile_then_merge(scores: torch.Tensor, k: int):
    """The tile route's selection on a [B, I] f32 score matrix."""
    B, I = scores.shape
    route = ttopk.k2_route(k, I, B)
    assert route.name == "tile"
    top = _merge(_tile_lists(_composites(scores), route), route.group, k)
    assert bool((top > _PAD).all()), "a padding composite won"
    ids = 2**32 - 1 - (top & 0xFFFFFFFF)
    return _order_key_inverse((top >> 32).to(torch.int32)), ids.to(torch.int32)


def _tile_rows(rng, I: int) -> np.ndarray:
    """Rows of ties across tile boundaries, NaN of both signs, signed
    zeros, infinities, and masked items (-1e30) outnumbering the rest."""
    rows = rng.integers(-2, 3, (7, I)).astype(np.float32)
    rows[0] = 1.0  # one tie over the whole row: the lowest indices win
    rows[1] = np.resize(np.array([-0.0, 0.0, -0.0], np.float32), I)
    rows[2, ::7] = np.nan
    rows[2, 3::11] = np.array([-1], np.int32).view(np.float32)[0]  # -NaN
    rows[3, ::5] = np.inf
    rows[3, 2::9] = -np.inf
    rows[4] = ttopk.NEG_INF  # masked, but for a few
    rows[4, rng.choice(I, min(I, 3), replace=False)] = 0.5
    rows[5, 120:136] = 7.0  # a tie straddling the first chunk boundary
    rows[5, I - 1] = 7.0
    rows[6] = rng.standard_normal(I).astype(np.float32)
    return rows


@pytest.mark.parametrize("I,k", [
    (50, 1), (50, 4), (50, 50),  # one tile, partial, k up to the whole row
    (1000, 1), (1000, 3), (1000, 4), (1000, 16), (1000, 100),  # I % 128 != 0
    (5000, 9), (5000, 17), (5000, 33), (5000, 65),  # 40 tiles: warps fold two lists each
    (17000, 128),  # 256-item tiles: two chunks folded a tile
    (300_000, 16),  # 512-item tiles: chunks folded by groups; 10 merge rounds
])
def test_tile_then_merge_matches_the_reference_and_lax(I, k):
    rng = np.random.default_rng(I * 1000 + k)
    rows = _tile_rows(rng, I)
    s, i = _tile_then_merge(torch.from_numpy(rows), k)
    rs, ri = ttopk.top_k_rows_reference(torch.from_numpy(rows), k)
    np.testing.assert_array_equal(i.numpy(), ri.numpy())
    np.testing.assert_array_equal(s.numpy().view(np.int32), rs.numpy().view(np.int32))
    js, ji = jax.lax.top_k(jnp.asarray(rows), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(s.numpy().view(np.int32), np.asarray(js).view(np.int32))


def test_tile_then_merge_on_seeded_random_rows():
    """Seeded rows from a small alphabet (many ties) at random I and k."""
    rng = np.random.default_rng(11)
    for _ in range(12):
        I = int(rng.integers(1, 700))
        k = int(rng.integers(1, min(I, ttopk.K2_TILE_MAX_K) + 1))
        alphabet = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 2.5,
                             ttopk.NEG_INF, 1e-45, -1e-45], np.float32)
        rows = alphabet[rng.integers(0, len(alphabet), (3, I))]
        s, i = _tile_then_merge(torch.from_numpy(rows), k)
        rs, ri = ttopk.top_k_rows_reference(torch.from_numpy(rows), k)
        assert torch.equal(i, ri), (I, k)
        assert torch.equal(s.view(torch.int32), rs.view(torch.int32)), (I, k)


def test_order_key_inverse_round_trips():
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-45, -1e-45,
                        1.17e-38, -1.17e-38, ttopk.NEG_INF, 1.0, -1.0,
                        np.finfo(np.float32).max, -np.finfo(np.float32).max], np.float32)
    bits = np.concatenate([
        special.view(np.int32),
        np.array([-1, 0x7FC00001, 0x7F800001, -0x00000001 - 0x7FFFFF, 1, -0x80000000],
                 np.int64).astype(np.int32),  # NaN payloads, -0.0's bits, smallest subnormal
        np.random.default_rng(3).integers(-2**31, 2**31, 4096).astype(np.int32),
    ])
    x = torch.from_numpy(bits.copy()).view(torch.float32)
    back = _order_key_inverse(ttopk.order_key(x))
    np.testing.assert_array_equal(back.view(torch.int32).numpy(), bits)


def test_k2_route_at_the_cap_and_past_it():
    cap, I = ttopk.K2_TILE_MAX_K, 26_744
    at = ttopk.k2_route(cap, I, 1)
    assert at == ttopk.K2Route("tile", 256, 128, 105)
    assert ttopk.k2_route(cap + 1, I, 1).name == "select"
    assert ttopk.k2_route(4, I, 1) == ttopk.K2Route("tile", 128, 4, 209)
    assert ttopk.k2_route(4, I, 64) == ttopk.k2_route(4, I, 1)
    assert ttopk.k2_launches(4, I, 1) == ttopk.k2_launches(4, I, 1, summed=True) == 2
    assert ttopk.k2_launches(cap + 1, I, 1) == 2
    assert ttopk.k2_launches(cap + 1, I, 1, summed=True) == 3


def test_k2_route_below_one_tile():
    assert ttopk.k2_route(4, 50, 1) == ttopk.K2Route("tile", 128, 4, 1)
    assert ttopk.k2_route(50, 50, 7) == ttopk.K2Route("tile", 128, 64, 1)
    with pytest.raises(ValueError):
        ttopk.k2_route(51, 50, 1)
    with pytest.raises(ValueError):
        ttopk.k2_route(0, 50, 1)


@pytest.mark.parametrize("I", [1, 127, 128, 129, 4096, 26_744, 1_000_003])
def test_k2_route_width_is_the_narrowest_that_fits_the_merge(I):
    for k in (1, 2, 3, 4, 16, 17, 32, 64, 100, 128):
        if k > I:
            continue
        r = ttopk.k2_route(k, I, 1)
        assert r.width % ttopk.K2_CHUNK == 0 and r.tiles == -(-I // r.width)
        assert r.group >= k and r.group & (r.group - 1) == 0 and r.group < 2 * k
        assert r.tiles * r.group <= ttopk.K2_MERGE_CAP
        if r.width > ttopk.K2_CHUNK:
            assert -(-I // (r.width // 2)) * r.group > ttopk.K2_MERGE_CAP


def test_k2_constants_match_the_kernel_source():
    import re
    from pathlib import Path

    src = (Path(ttopk.__file__).resolve().parent.parent / "csrc" / "topk.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["TILE_MAX_K"]) == ttopk.K2_TILE_MAX_K == 128
    assert int(consts["TILE_I"]) == ttopk.K2_CHUNK
    assert int(consts["MERGE_CAP"]) == ttopk.K2_MERGE_CAP
    assert int(consts["MERGE_THREADS"]) // 32 == _MERGE_WARPS
    assert int(consts["GROUP_MAX_G"]) == _GROUP_MAX_G


def test_select_route_entry_points_need_cuda():
    items = torch.zeros((5, 2))
    with pytest.raises(ValueError, match="device"):
        ttopk._gather_top_k_select([0], items, items, 2)
    with pytest.raises(ValueError, match="device"):
        ttopk._sum_rows_top_k_select([[0]], [[1.0]], items, 2)
    for fn in (ttopk.gather_top_k_batch, ttopk.sum_rows_top_k_batch):
        assert set(fn.routes) == {"tile", "select"}


def test_cpu_calls_launch_no_kernel():
    """CPU tensors take the plain version: no call is counted on a route,
    and no kernel launch (the C entries count those as they launch)."""
    rng = np.random.default_rng(5)
    items = torch.from_numpy(rng.standard_normal((40, 3)).astype(np.float32))
    counters = [c for fn in (ttopk.gather_top_k_batch, ttopk.sum_rows_top_k_batch,
                             ttopk.top_k_similar)
                for c in (fn.launches, fn.kernel_launches, *fn.routes.values())]
    before = [c.value for c in counters]
    ttopk.gather_top_k_batch([0, 3], items, items, 4)
    ttopk.sum_rows_top_k_batch([[0, 1]], [[1.0, 0.0]], items, 4)
    ttopk.top_k_rows(items, 2)
    ttopk.top_k_items(items[0], items, 3)
    ttopk.top_k_similar(items[1], items, 3)
    assert [c.value for c in counters] == before


def test_cu_entries_count_every_launch():
    """Each extern "C" entry takes the launch counter, and every kernel
    launch in csrc/topk.cu is counted: after each ``<<<`` the next
    ``counted(launched)`` comes before any return but a launch-free
    branch's, so ``kernel_launches`` moves with what really launched."""
    src = (Path(ttopk.__file__).parent.parent / "csrc" / "topk.cu").read_text()
    entries = re.findall(r"^int (pio_k2_\w+)\(([^)]*)\)", src, re.M)
    assert {name for name, _ in entries} == {
        "pio_k2_select", "pio_k2_gather_top_k", "pio_k2_sum_rows_top_k",
        "pio_k2_tile_top_k", "pio_k2_tile_sum_rows_top_k", "pio_k2_cosine_top_k"}
    for name, params in entries:
        assert "int* launched, void* stream" in " ".join(params.split()), name
    body = src[src.index("cudaError_t counted(int* launched)"):]
    launches = [m.start() for m in re.finditer(r"<<<", body)]
    assert len(launches) == 11  # tile 1, merge 3, score 3, select 1, sum rows 3
    step = re.compile(r"return\s+(?:\(int\))?(\w+)|counted\(launched\)")
    for a in launches:
        # the first return or count after the launch: a count (or a
        # return of one), past branches that launched nothing
        for m in step.finditer(body, a):
            if m.group(1) != "cudaErrorInvalidValue":
                assert m.group(1) in (None, "counted"), body[a:m.end()]
                break
        else:
            raise AssertionError(f"uncounted launch: {body[a:a + 80]}")


# -- top_k_items and top_k_similar (K2 at B = 1, and K2's cosine mode) ---------


def test_top_k_items_matches_jax():
    """tests/test_als.py:409-421 on both packages."""
    V = np.diag([1.0, 2.0, 3.0, 4.0]).astype(np.float32)
    u = np.ones(4, np.float32)
    js, ji = jtopk.top_k_items(jnp.asarray(u), jnp.asarray(V), k=2)
    ts, ti = ttopk.top_k_items(torch.from_numpy(u), torch.from_numpy(V), 2)
    assert ti.tolist() == [3, 2] == np.asarray(ji).tolist()
    assert ts.tolist() == [4.0, 3.0] == np.asarray(js).tolist()
    mask = np.array([0, 0, 0, 1])
    _, ti = ttopk.top_k_items(torch.from_numpy(u), torch.from_numpy(V), 2,
                              exclude_mask=torch.from_numpy(mask))
    assert 3 not in ti.tolist()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_top_k_items_on_every_catalog_form(dtype, exact, masked):
    rng = np.random.default_rng(31)
    jt, tt = _tables(rng, dtype, N_ITEMS, 6, exact)
    u = (rng.integers(-3, 4, 6) if exact else rng.standard_normal(6)).astype(np.float32)
    mask = (rng.random(N_ITEMS) < 0.3) if masked else None
    n = N_ITEMS
    js, ji = jtopk.top_k_items(jnp.asarray(u), jt, k=n,
                               exclude_mask=None if mask is None else jnp.asarray(mask))
    ts, ti = ttopk.top_k_items(torch.from_numpy(u), tt, n,
                               exclude_mask=None if mask is None else torch.from_numpy(mask))
    js, ji = np.asarray(js), np.asarray(ji)
    # row 0 of the batched wrapper, bit for bit
    bs, bi = ttopk.top_k_items_batch(torch.from_numpy(u)[None], tt, n,
                                     exclude_mask=None if mask is None else
                                     torch.from_numpy(mask))
    assert _same_bits(ts.numpy(), bs[0].numpy()) and ti.tolist() == bi[0].tolist()
    if exact:
        assert _same_bits(ts.numpy(), js) and ti.numpy().tolist() == ji.tolist()
    else:
        np.testing.assert_allclose(ts.numpy(), js, rtol=RTOL, atol=ATOL)
        assert _ids_match_outside_near_ties(ti.numpy(), ji, js)


def _cosine_stated(v: np.ndarray, values: np.ndarray, norms, mask, k: int):
    """K2's cosine mode stated in plain torch, operation by operation as
    csrc/topk.cu computes it: each dot product over d = 0..D-1 in order
    (every product and partial sum rounded, from +0.0), the query norm as
    an f32 sum of squares then sqrt, one rounded product norm_i * ||v||,
    max with 1e-12, one IEEE division, the mask to -1e30, a stable sort
    on the order key."""
    V = torch.from_numpy(values.astype(np.float32))
    q = torch.from_numpy(v.astype(np.float32))
    dots = torch.zeros(V.shape[0])
    for d in range(V.shape[1]):
        dots = dots + V[:, d] * q[d]
    qn = torch.sqrt((q * q).sum())
    n = torch.linalg.vector_norm(V, dim=1) if norms is None else torch.from_numpy(norms)
    s = dots / torch.clamp(n * qn, min=1e-12)
    if mask is not None:
        s = torch.where(torch.from_numpy(mask).bool(), torch.tensor(-1e30), s)
    keys = ttopk.order_key(s)
    order = torch.sort(keys, descending=True, stable=True).indices[:k]
    return s[order], order.to(torch.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_norms", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_top_k_similar_matches_jax_and_its_stated_arithmetic(dtype, with_norms, masked):
    """tests/test_als.py:428 and tests/test_retrieval.py:200 on both
    packages, every catalog form: ids equal outside near ties and scores
    within rtol 1e-5 of the JAX package's; bit for bit equal to the
    arithmetic csrc/topk.cu states."""
    rng = np.random.default_rng(32)
    jt, tt = _tables(rng, dtype, N_ITEMS, 8, exact=False)
    tvals = (tt[0] if dtype == "int8" else tt).to(torch.float32)
    v = tvals[3].numpy().copy()
    v_j = np.asarray((jt[0] if dtype == "int8" else jt)[3]).astype(np.float32)
    assert np.array_equal(v, v_j)
    mask = np.zeros(N_ITEMS, np.bool_)
    if masked:
        mask[[3, 7, 11]] = True
    tn = ttopk.catalog_norms(tt) if with_norms else None
    jn = jtopk.catalog_norms(jt) if with_norms else None
    js, ji = jtopk.top_k_similar(jnp.asarray(v), jt, N_ITEMS,
                                 exclude_mask=jnp.asarray(mask) if masked else None,
                                 norms=jn)
    ts, ti = ttopk.top_k_similar(torch.from_numpy(v), tt, N_ITEMS,
                                 exclude_mask=torch.from_numpy(mask) if masked else None,
                                 norms=tn)
    js, ji = np.asarray(js), np.asarray(ji)
    np.testing.assert_allclose(ts.numpy(), js, rtol=RTOL, atol=ATOL)
    assert _ids_match_outside_near_ties(ti.numpy(), ji, js)
    ss, si = _cosine_stated(v, tvals.numpy(), None if tn is None else tn.numpy(),
                            mask if masked else None, N_ITEMS)
    assert _same_bits(ts.numpy(), ss.numpy()) and ti.tolist() == si.tolist()
    if masked:
        assert not set(ti[:N_ITEMS - 3].tolist()) & {3, 7, 11}
    assert (ts[ts > -1e29] <= 1.0 + 1e-5).all()


def test_top_k_similar_excludes_self_and_zero_rows():
    """tests/test_als.py:428 (self excluded by the mask, scores <= 1),
    plus a zero row and a zero query: max(norm * ||v||, 1e-12) keeps
    every score finite, and crafted exact ties keep lax.top_k's order."""
    rng = np.random.default_rng(6)
    V = rng.normal(size=(8, 4)).astype(np.float32)
    V[5] = 0.0
    V[6] = V[1] * 2.0  # the same direction as row 1
    mask = np.zeros(8, np.float32)
    mask[2] = 1
    js, ji = jtopk.top_k_similar(jnp.asarray(V[2]), jnp.asarray(V), k=8,
                                 exclude_mask=jnp.asarray(mask))
    ts, ti = ttopk.top_k_similar(torch.from_numpy(V[2]), torch.from_numpy(V), 8,
                                 exclude_mask=torch.from_numpy(mask))
    assert 2 not in ti.tolist()[:7] and ti.tolist() == np.asarray(ji).tolist()
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)
    zs, zi = ttopk.top_k_similar(torch.zeros(4), torch.from_numpy(V), 8)
    assert torch.isfinite(zs).all() and zi.tolist() == list(range(8))  # all +0.0: index order


def test_top_k_similar_precomputed_norms():
    """tests/test_retrieval.py:200 on the port."""
    v = np.random.default_rng(18).normal(size=(80, 8)).astype(np.float32)
    t = torch.from_numpy(v)
    norms = ttopk.catalog_norms(t)
    np.testing.assert_allclose(norms.numpy(), np.linalg.norm(v, axis=1), rtol=1e-6)
    s0, i0 = ttopk.top_k_similar(t[3], t, 8)
    s1, i1 = ttopk.top_k_similar(t[3], t, 8, norms=norms)
    assert i0.tolist() == i1.tolist()
    np.testing.assert_allclose(s0.numpy(), s1.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="norms"):
        ttopk.top_k_similar(t[3], t, 8, norms=norms[:5])
