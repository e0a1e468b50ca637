"""The port's stacked candidate trainings (K1s, ``ops/als.py
als_train_sweep``) against the JAX package's, on the CPU.

On CPU tensors K1s's wrapper runs its plain version
(``solve_bucket_sweep_reference``: ``solve_bucket_reference`` +
``_scatter_rows`` a candidate at a time), which is what the CUDA kernel is
held to on the card (chip_smoke.py, where candidate c must also be
bit-identical to its training alone). Both packages get the same numpy
inputs: the port's stacked, zero-padded initial factors go straight into
the JAX package's vmapped device loop ``_train_fused_sweep`` with its own
``_device_bucket_arrays``. Tolerances and their reasons:

- float32 storage: factors within rtol=5e-4, atol=5e-5
  (``tests/test_als.py:188``): the two packages sum and factor the normal
  equations in other orders;
- int8 storage: dense factors within rtol=0.05, atol=0.02
  (``tests/test_als.py:372``): a last-bit difference flips a
  quantization step;
- bf16 storage and compute: within rtol=0.05, atol=0.05
  (``tests/test_als.py:388``);
- the padded columns of a mixed-rank sweep: exactly zero in both;
- a sweep against the same candidates trained one by one in the port:
  bit for bit (the plain version takes the same operations).
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.ops import als as tals

ROOT = Path(__file__).resolve().parent.parent


def _ratings(seed: int = 5, n_rows: int = 40, n_cols: int = 25, nnz: int = 700):
    """Random ratings with a hot row and column (segmented buckets at the
    small widths below)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, nnz).astype(np.int32)
    cols = rng.integers(0, n_cols, nnz).astype(np.int32)
    rows[:60] = 0
    cols[60:120] = 1
    vals = rng.integers(1, 6, nnz).astype(np.float32)
    return rows, cols, vals, n_rows, n_cols


WIDTHS = (4, 16)


def _both_layouts(seed: int = 5):
    rows, cols, vals, nr, nc = _ratings(seed)
    t = tals.build_ratings_data(rows, cols, vals, nr, nc, bucket_widths=WIDTHS)
    j = jals.build_ratings_data(rows, cols, vals, nr, nc, bucket_widths=WIDTHS)
    return t, j


def _jax_sweep(jdata, params_list, U0, V0):
    """The JAX package's device loop from the port's stacked init."""
    import dataclasses

    base = params_list[0]
    rank_max = max(p.rank for p in params_list)
    jparams = [jals.ALSParams(**{f.name: getattr(p, f.name)
                                 for f in dataclasses.fields(jals.ALSParams)
                                 if hasattr(p, f.name)}) for p in params_list]
    static = dataclasses.replace(jparams[0], iterations=0, reg=0.0, alpha=0.0,
                                 rank=rank_max)
    U, V = jals._train_fused_sweep(
        jals.to_storage(jnp.asarray(U0.numpy()), base.storage_dtype),
        jals.to_storage(jnp.asarray(V0.numpy()), base.storage_dtype),
        jnp.asarray([p.reg for p in params_list], jnp.float32),
        jnp.asarray([p.alpha for p in params_list], jnp.float32),
        jals._device_bucket_arrays(jdata.row_buckets),
        jals._device_bucket_arrays(jdata.col_buckets),
        static,
        base.iterations,
    )
    return U, V


def _dense(table) -> np.ndarray:
    """A stacked storage table of either package as float32 numpy."""
    if isinstance(table, tuple):
        q, s = table
        if isinstance(q, torch.Tensor):
            return (q.to(torch.float32) * s[..., None]).numpy()
        return np.asarray(q, np.float32) * np.asarray(s)[..., None]
    if isinstance(table, torch.Tensor):
        return table.to(torch.float32).numpy()
    return np.asarray(table, np.float32)


SWEEPS = {
    # name: (candidates as (rank, reg, alpha, seed), ALSParams extras, rtol, atol)
    "explicit_f32_lambda": ([(6, 0.02, 1.0, 3), (6, 0.1, 1.0, 4), (6, 0.3, 1.0, 5)],
                            {}, 5e-4, 5e-5),
    "explicit_f32_mixed_ranks": ([(4, 0.05, 1.0, 3), (6, 0.05, 1.0, 4), (6, 0.2, 1.0, 5)],
                                 {}, 5e-4, 5e-5),
    "implicit_f32_alpha": ([(5, 0.05, 0.5, 3), (5, 0.05, 2.0, 3)],
                           {"implicit": True}, 5e-4, 5e-5),
    "implicit_f32_mixed_ranks": ([(3, 0.05, 1.0, 3), (5, 0.1, 1.0, 4), (5, 0.05, 2.0, 5)],
                                 {"implicit": True}, 5e-4, 5e-5),
    "explicit_int8": ([(6, 0.01, 1.0, 3), (6, 0.1, 1.0, 4)],
                      {"storage_dtype": "int8"}, 0.05, 0.02),
    "explicit_int8_mixed_ranks": ([(4, 0.05, 1.0, 3), (6, 0.05, 1.0, 4), (6, 0.2, 1.0, 5)],
                                  {"storage_dtype": "int8"}, 0.05, 0.02),
    "implicit_int8": ([(5, 0.05, 0.5, 3), (5, 0.1, 2.0, 4)],
                      {"implicit": True, "storage_dtype": "int8"}, 0.05, 0.02),
    "explicit_bf16": ([(6, 0.01, 1.0, 3), (6, 0.1, 1.0, 4)],
                      {"storage_dtype": "bfloat16", "compute_dtype": "bfloat16"},
                      0.05, 0.05),
}


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_matches_jax_device_loop(name):
    """The sweep's device loop on K1s's entry-major stacks (``sweep_init``
    and ``_train_sweep`` keep ``[N, C, D]`` in memory, int8 scales ``[N,
    C]``) against the JAX package's; and bit for bit against the same
    loop on contiguous ``[C, N, D]`` stacks."""
    cands, extra, rtol, atol = SWEEPS[name]
    tdata, jdata = _both_layouts()
    params = [tals.ALSParams(rank=r, iterations=3, reg=reg, alpha=a, seed=s,
                             bucket_widths=WIDTHS, **extra)
              for r, reg, a, s in cands]
    U0, V0 = tals.sweep_init(tdata, params, torch.device("cpu"))
    assert tals.is_entry_major(U0) and tals.is_entry_major(V0)
    Ut, Vt = tals._train_sweep(tdata, params, U0, V0)
    assert tals.is_entry_major(Ut) and tals.is_entry_major(Vt)
    Uj, Vj = _jax_sweep(jdata, params, U0, V0)
    for t, j in ((Ut, Uj), (Vt, Vj)):
        a, b = _dense(t), _dense(j)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
        for c, p in enumerate(params):  # padded columns: exact zeros in both
            assert (a[c, :, p.rank:] == 0).all() and (b[c, :, p.rank:] == 0).all()
    # the same loop on [C, N, D] stacks, candidate-major
    base = params[0]
    regs = torch.tensor([p.reg for p in params], dtype=torch.float32)
    alphas = torch.tensor([p.alpha for p in params], dtype=torch.float32)
    U = tals.to_storage(U0.contiguous(), base.storage_dtype)
    V = tals.to_storage(V0.contiguous(), base.storage_dtype)
    assert not tals.is_entry_major(U)
    rb = tals.device_buckets(tdata.row_buckets, torch.device("cpu"))
    cb = tals.device_buckets(tdata.col_buckets, torch.device("cpu"))
    for _ in range(base.iterations):
        tals._half_step(U, V, rb, base, regs, alphas)
        tals._half_step(V, U, cb, base, regs, alphas)
    assert _same(U, Ut) and _same(V, Vt)


def test_sweep_equals_candidates_trained_one_by_one():
    """A same-rank sweep on the plain version is, candidate for
    candidate, the port's own ``als_train`` from the same seed."""
    tdata, _ = _both_layouts()
    params = [tals.ALSParams(rank=6, iterations=3, reg=reg, seed=s, bucket_widths=WIDTHS)
              for reg, s in ((0.02, 3), (0.1, 4), (0.3, 5))]
    for p, (U, V) in zip(params, tals.als_train_sweep(tdata, params, device="cpu")):
        U1, V1 = tals.als_train(tdata, p, device="cpu")
        assert torch.equal(U, U1) and torch.equal(V, V1)


def test_mixed_rank_sweep_returns_each_candidate_at_its_rank():
    tdata, _ = _both_layouts()
    params = [tals.ALSParams(rank=r, iterations=2, reg=0.05, seed=3,
                             storage_dtype="int8", bucket_widths=WIDTHS)
              for r in (4, 6, 6)]
    out = tals.als_train_sweep(tdata, params, device="cpu")
    for p, (U, V) in zip(params, out):
        assert U[0].shape == (tdata.num_rows, p.rank) and U[1].shape == (tdata.num_rows,)
        assert V[0].shape == (tdata.num_cols, p.rank)
        assert U[0].dtype == torch.int8


def test_cost_model_splits_ranks_like_the_jax_package(monkeypatch):
    """Ranks 4 and 12 cost more padded than 1.5x exact: both packages
    train them as one sweep per rank (each a sweep of one)."""
    tdata, _ = _both_layouts()
    params = [tals.ALSParams(rank=r, iterations=2, reg=0.05, seed=3, bucket_widths=WIDTHS)
              for r in (4, 12)]
    groups = []
    real = tals._train_sweep

    def spy(data, plist, U0, V0):
        groups.append([p.rank for p in plist])
        return real(data, plist, U0, V0)

    monkeypatch.setattr(tals, "_train_sweep", spy)
    tals.als_train_sweep(tdata, params, device="cpu")
    assert groups == [[4], [12]]
    padded = [tals.ALSParams(rank=r, iterations=2, reg=0.05, seed=3, bucket_widths=WIDTHS)
              for r in (10, 12, 12, 12)]
    groups.clear()
    tals.als_train_sweep(tdata, padded, device="cpu")
    assert groups == [[10, 12, 12, 12]]


def test_sweep_groups_are_the_cost_models():
    """The shipped recommendation sweep (ranks 5/10/10/20) trains as
    three groups, C = 1, 2, 1; ranks 10/12/12/12 pad into one; one rank
    is one group."""
    def groups(ranks):
        return tals.sweep_groups([tals.ALSParams(rank=r, reg=0.05) for r in ranks])

    assert groups([5, 10, 10, 20]) == [[0], [1, 2], [3]]
    assert groups([10, 12, 12, 12]) == [[0, 1, 2, 3]]
    assert groups([6, 6, 6]) == [[0, 1, 2]]
    assert groups([20, 5]) == [[1], [0]]


def test_sweep_rejects_what_the_jax_package_rejects():
    """tests/test_evaluation.py:368's cases, with the same messages."""
    data = tals.build_ratings_data(
        np.asarray([0, 1], np.int32), np.asarray([0, 1], np.int32),
        np.asarray([1.0, 2.0], np.float32), 2, 2,
    )
    cases = [
        ([tals.ALSParams(iterations=3), tals.ALSParams(iterations=5)], "static program shape"),
        ([tals.ALSParams(rank=4, reg=0.0), tals.ALSParams(rank=8, reg=0.0)], "reg > 0"),
        ([], "must not be empty"),
        ([tals.ALSParams(storage_dtype="int8"), tals.ALSParams()], "storage_dtype"),
    ]
    jdata = jals.build_ratings_data(
        np.asarray([0, 1], np.int32), np.asarray([0, 1], np.int32),
        np.asarray([1.0, 2.0], np.float32), 2, 2,
    )
    for plist, msg in cases:
        with pytest.raises(ValueError, match=msg):
            tals.als_train_sweep(data, plist, device="cpu")
        jlist = [jals.ALSParams(rank=p.rank, iterations=p.iterations, reg=p.reg,
                                storage_dtype=p.storage_dtype) for p in plist]
        with pytest.raises(ValueError, match=msg):
            jals.als_train_sweep(jdata, jlist)


def test_solve_bucket_sweep_plain_is_per_candidate_solve_bucket():
    """K1s's plain version writes, for each candidate, what K1's plain
    version writes for that candidate alone, bit for bit."""
    tdata, _ = _both_layouts()
    C, N, D = 3, tdata.num_cols, 5
    gen = torch.Generator().manual_seed(0)
    other = torch.randn((C, N, D), generator=gen)
    regs = torch.tensor([0.01, 0.1, 1.0])
    for b in tals.device_buckets(tdata.row_buckets, torch.device("cpu")):
        target = torch.zeros((C, tdata.num_rows, D))
        tals.solve_bucket_sweep(other, b.col_ids, b.ratings, b.mask, b.seg_start,
                                regs, target, b.row_ids)
        for c in range(C):
            alone = torch.zeros((tdata.num_rows, D))
            tals.solve_bucket(other[c], b.col_ids, b.ratings, b.mask, b.seg_start,
                              float(regs[c]), target=alone, row_ids=b.row_ids)
            assert torch.equal(target[c], alone)


def test_batched_gram_is_each_candidates_gram():
    gen = torch.Generator().manual_seed(1)
    stack = torch.randn((3, 50, 6), generator=gen)
    batched = tals.compute_gram(stack)
    for c in range(3):
        torch.testing.assert_close(batched[c], tals.compute_gram(stack[c]),
                                   rtol=1e-6, atol=1e-6)


def test_sweep_wrapper_refuses_cpu_tensors_on_the_card_path():
    """The kernel path takes CUDA tensors only: there is no fallback."""
    tdata, _ = _both_layouts()
    b = tals.device_buckets(tdata.row_buckets, torch.device("cpu"))[0]
    other = torch.zeros((2, tdata.num_cols, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        tals._solve_on_card(None, tals.solve_bucket_sweep.launches, other, b.col_ids,
                            b.ratings, b.mask, b.seg_start, 0.0, True, "float32",
                            torch.zeros((2, tdata.num_rows, 4)), b.row_ids, False,
                            False, 1.0, None, regs=torch.ones(2), alphas=torch.ones(2))


def test_cu_candidate_cap_matches_python():
    src = (ROOT / "predictionio_tpu_torch" / "csrc" / "als_solve.cu").read_text()
    assert int(re.search(r"constexpr int MAX_C = (\d+);", src).group(1)) == tals.MAX_CANDIDATES
    # the C entry takes the candidate arguments the wrapper passes
    entry = src[src.index('extern "C" int pio_k1_solve_bucket'):]
    entry = entry[:entry.index("{")]
    assert entry.count(",") + 1 == 30


# -- K1s's plan (csrc/als_solve.cu k1s_plan) ------------------------------------------


def _needed(C: int, D: int) -> set:
    """Every sum a sweep of C candidates at rank D makes for a row:
    (candidate, i, k) for A's lower triangle (k <= i < D) and b (i = D)."""
    return {(c, i, k) for c in range(C) for i in range(D + 1) for k in range(min(i + 1, D))}


@pytest.mark.parametrize("D", range(1, 33))
def test_k1s_plan_blocks_cover_every_sum_once(D):
    """For C = 1..8 (and 33, 100): the plan's chunks of candidates, each
    lane's blocks as the kernel assigns them (``k1s_lane_blocks``), cut to
    the trapezoid, make every (candidate, A entry, b entry) exactly once;
    a lane owns at most K1S_MAX_NB blocks, and a warp's tile fits its
    shared-memory budget."""
    for C in (*range(1, 9), 33, 100):
        plan = tals.k1s_plan(C, D)
        assert plan.S in tals.K1S_SHAPES and 1 <= plan.nb <= tals.K1S_MAX_NB
        assert plan.chunks * plan.cw >= C > (plan.chunks - 1) * plan.cw
        assert 4 * tals.k1s_warp_floats(plan.S, D, plan.cw) <= tals.K1S_WARP_SMEM
        assert 1 <= plan.warps <= tals.K1S_MAX_WARPS
        assert plan.warps == 1 or plan.warps * 4 * tals.k1s_warp_floats(
            plan.S, D, plan.cw) <= tals.K1S_BLOCK_SMEM
        made = []
        for chunk in range(plan.chunks):
            c0 = chunk * plan.cw
            cn = min(plan.cw, C - c0)
            for owned in tals.k1s_lane_blocks(plan, D, cn):
                assert len(owned) <= plan.nb
                for c, i0, j0 in owned:
                    made += [(c0 + c, i, k)
                             for i in range(i0, i0 + plan.S) for k in range(j0, j0 + plan.S)
                             if i <= D and k < D and k <= i]
        assert len(made) == len(set(made)) and set(made) == _needed(C, D)


@pytest.mark.parametrize("C,D,expect", [
    (1, 5, (1, 1, 1, 1)),   # the shipped sweep's rank-5 group: 20 sums, one a lane
    (2, 10, (2, 1, 4, 1)),  # its rank-10 group: both candidates in one warp
    (1, 20, (1, 1, 4, 1)),  # its rank-20 group
    (4, 20, (4, 1, 4, 3)),  # chip_smoke.py's ML-20M lambda sweep
    (8, 20, (4, 2, 4, 3)),
    (2, 32, (2, 1, 4, 3)),
    (3, 32, (2, 2, 4, 3)),
])
def test_k1s_plan_at_known_shapes(C, D, expect):
    """(cw, chunks, S, nb) at the shapes the evaluation path and
    chip_smoke.py run: 4 x 4 blocks (0.5 shared words a product) from
    rank 10 up; 1 x 1 where 20 sums would leave 4 x 4 blocks on 2 lanes."""
    p = tals.k1s_plan(C, D)
    assert (p.cw, p.chunks, p.S, p.nb) == expect


def test_cu_k1s_constants_match_python():
    src = (ROOT / "predictionio_tpu_torch" / "csrc" / "als_solve.cu").read_text()
    for name in ("K1S_MAX_NB", "K1S_WARP_SMEM", "K1S_BLOCK_SMEM", "K1S_MAX_WARPS",
                 "K1S_THREAD_SYSTEMS"):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == \
            getattr(tals, name), name
    # the plan tries the block sides of K1S_SHAPES, doubling from 1
    assert "for (int S = 1; S <= 4; S *= 2)" in src and tals.K1S_SHAPES == (1, 2, 4)
    # the entry takes the arguments the wrapper passes; its launches are _SWEEP_CODES
    entry = src[src.index('extern "C" int pio_k1s_sweep'):]
    entry = entry[:entry.index("{")]
    assert entry.count(",") + 1 == 26
    enum = re.search(r"enum SweepLaunch \{([^}]*)\}", src).group(1)
    codes = dict(re.findall(r"SWEEP_(\w+) = (\d+)", enum))
    assert tals._SWEEP_CODES == {"split": (int(codes["PARTIALS"]), int(codes["FINISH"])),
                                 "block": (int(codes["BLOCK"]),)}


@pytest.mark.parametrize("D,route,launches", [(1, "split", 2), (20, "split", 2),
                                               (32, "split", 2), (33, "block", 1),
                                               (128, "block", 1)])
def test_k1s_routes(D, route, launches):
    """Up to rank 32 a sweep's bucket takes two launches, segmented or
    not (the accumulation, then the finish); above, K1's block kernel on
    the candidate axis, one."""
    for R, B in ((10, 10), (10, 14)):
        assert tals.k1s_route(D, R, B) == route
        assert tals.k1s_launches(D, R, B) == launches
    with pytest.raises(ValueError):
        tals.k1s_route(129, 1, 1)


def test_k1s_finish_by_systems():
    """The finish takes a thread a system from K1S_THREAD_SYSTEMS systems
    (rows x candidates) up: the ML-20M users' K = 128 bucket at C = 4;
    a warp a row for an ML-1M fold's buckets."""
    assert tals.k1s_finish(101_601, 4) == "thread"
    assert tals.k1s_finish(4_270, 2) == "warp"
    assert tals.k1s_finish(tals.K1S_THREAD_SYSTEMS, 1) == "thread"
    assert tals.k1s_finish(tals.K1S_THREAD_SYSTEMS - 1, 1) == "warp"


def test_entry_major_keeps_values_and_views():
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((3, 7, 5), generator=gen)
    em = tals.entry_major(x)
    assert torch.equal(em, x) and tals.is_entry_major(em) and not tals.is_entry_major(x)
    assert em.transpose(0, 1).is_contiguous()
    q, s = tals.to_storage(x, "int8")
    eq, es = tals.entry_major((q, s))
    assert torch.equal(eq, q) and torch.equal(es, s) and tals.is_entry_major((eq, es))
    assert tals.entry_major(em).data_ptr() == em.data_ptr()  # already so: no copy
    assert torch.equal(tals._candidate(em, 1), x[1])


def test_sweep_wrapper_refuses_candidate_major_stacks(monkeypatch):
    """K1s on the card takes entry-major stacks only: a [C, N, D]
    contiguous stack is refused before any launch, not copied."""
    tdata, _ = _both_layouts()
    b = tals.device_buckets(tdata.row_buckets, torch.device("cpu"))[0]
    other = torch.zeros((2, tdata.num_cols, 4))
    target = tals.entry_major(torch.zeros((2, tdata.num_rows, 4)))
    with pytest.raises(ValueError, match="entry-major"):
        tals._sweep_table(other, "other", 2)
    with pytest.raises(ValueError, match="unsupported device"):
        tals._sweep_on_card(other, b.col_ids, b.ratings, b.mask, b.seg_start, torch.ones(2),
                            torch.ones(2), target, b.row_ids, True, "float32", False, None)
