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
    "explicit_bf16": ([(6, 0.01, 1.0, 3), (6, 0.1, 1.0, 4)],
                      {"storage_dtype": "bfloat16", "compute_dtype": "bfloat16"},
                      0.05, 0.05),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_matches_jax_device_loop(name):
    cands, extra, rtol, atol = SWEEPS[name]
    tdata, jdata = _both_layouts()
    params = [tals.ALSParams(rank=r, iterations=3, reg=reg, alpha=a, seed=s,
                             bucket_widths=WIDTHS, **extra)
              for r, reg, a, s in cands]
    U0, V0 = tals.sweep_init(tdata, params, torch.device("cpu"))
    Ut, Vt = tals._train_sweep(tdata, params, U0, V0)
    Uj, Vj = _jax_sweep(jdata, params, U0, V0)
    for t, j in ((Ut, Uj), (Vt, Vj)):
        a, b = _dense(t), _dense(j)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
        for c, p in enumerate(params):  # padded columns: exact zeros in both
            assert (a[c, :, p.rank:] == 0).all() and (b[c, :, p.rank:] == 0).all()


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
