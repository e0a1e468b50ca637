"""Alternating Least Squares on PyTorch + CUDA: explicit and implicit
feedback.

Port of ``predictionio_tpu/ops/als.py`` (single card):

- host layout: ratings -> degree-bucketed padded neighbour lists
  (:func:`build_padded_buckets`, :func:`build_ratings_data`), numpy code
  copied operation for operation, so both packages build the same bytes;
- factor tables: dense ``[N, D]`` float32/bfloat16 tensors or, for
  ``storage_dtype="int8"``, the pair ``(values int8 [N, D], scales
  float32 [N])`` with ``row = values * scale`` (per-row max-abs/127);
- K1, the fused bucket solve (:func:`solve_bucket`): gather the
  opposite factor rows a bucket names, accumulate ``A = sum w v v^T``
  and ``b = sum r v`` in float32, add a hot row's segments, regularize
  (implicit feedback: also add ``Y^T Y``, :func:`compute_gram`),
  Cholesky-solve, and write the solved rows back into the storage table.
  On CUDA tensors it launches the hand-written kernels of
  ``csrc/als_solve.cu`` by the route :func:`k1_route` picks (one warp a
  row at ranks <= :data:`WARP_MAX_RANK`, a segmented bucket in two
  launches; one block a row above); on CPU tensors it runs the plain
  PyTorch version beside them (:func:`solve_bucket_reference` +
  :func:`_scatter_rows`). There is no fallback from one to the other;
- :func:`als_train`: iterations -> half-steps -> K1 on each bucket, with
  the bucket arrays uploaded once and the factor tables updated in
  place;
- K1s and :func:`als_train_sweep`: C candidate trainings (per-candidate
  reg, alpha, seed and rank, zero-padded to the largest) on stacked
  tables kept entry-major (``[N, C, D]`` in memory, seen as ``[C, N, D]``
  views), each bucket's launches of a half-step serving all of them
  (:func:`solve_bucket_sweep`: one warp a table row for a chunk of
  candidates with register-blocked products, :func:`k1s_plan`, into a
  workspace; then the solve, a thread a system or a warp a row,
  :func:`k1s_finish`).

The random init cannot reproduce ``jax.random``'s bits: parity runs feed
both packages the same initial factors through ``warm_start`` (or, for a
sweep, to its device loop ``_train_sweep``). The prep cache
(``core/prep_cache.py``) hands :func:`als_train` buckets read from a
mapped file, or rebuilt by :func:`splice_padded_buckets` after an
appended tail; they are uploaded without being written or aliased.

An indefinite system (implicit feedback with negative ratings, e.g. the
similar-product template's dislikes) solves to an all-NaN row, as the
JAX package's failed Cholesky gives, and an int8 write-back stores such a
row as zeros with scale 1. The port reproduces this; it does not fix it.
"""

from __future__ import annotations

import ctypes
import logging
import time
import warnings
from dataclasses import dataclass, field, replace
from typing import Sequence

import numpy as np
import torch

from predictionio_tpu_torch import faults
from predictionio_tpu_torch.core import checkpoint as ckpt
from predictionio_tpu_torch.kernels import _build
from predictionio_tpu_torch.models.modelfile import tensor_to_numpy
from predictionio_tpu_torch.obs import metrics as obs_metrics
from predictionio_tpu_torch.obs import progress as obs_progress
from predictionio_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

# ops/als.py DEFAULT_BUCKETS: the template's ``bucket_widths`` default
DEFAULT_BUCKETS = (8, 32, 128, 512, 2048)
#: the largest rank K1 solves (ranks 10-128 are in use)
MAX_RANK = 128
#: the largest rank K1's warp route takes (csrc/als_solve.cu WARP_MAX_D);
#: the templates' ranks (10, 20) are below it
WARP_MAX_RANK = 32
#: candidates one K1s launch takes (csrc/als_solve.cu MAX_C)
MAX_CANDIDATES = 65535
#: K1s's plan (csrc/als_solve.cu, the same names): register blocks a lane
#: owns at most, the block sides tried, a warp's and a block's shared bytes
#: at most, and warps (rows) a block at most
K1S_MAX_NB = 4
K1S_SHAPES = (1, 2, 4)
K1S_WARP_SMEM = 49152
K1S_BLOCK_SMEM = 49152
K1S_MAX_WARPS = 8
#: systems (solved row, candidate) of a bucket from which K1s's finish
#: takes a thread a system; below, a warp a row (csrc/als_solve.cu)
K1S_THREAD_SYSTEMS = 16384

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_STORAGE_DTYPES = ("float32", "bfloat16", "int8")


# ---------------------------------------------------------------------------
# Host-side layout: COO ratings -> degree-bucketed padded neighbour lists
# ---------------------------------------------------------------------------


@dataclass
class PaddedBucket:
    """One degree bucket of padded per-row neighbour lists (static shapes).

    When ``seg_row`` is None each table row solves one matrix row
    (``B == len(row_ids)``). Otherwise the bucket is **segmented**: rows
    whose degree exceeds the bucket width are split across several
    consecutive table rows, ``seg_row[i]`` maps table row i to its index
    in ``row_ids``, and the solve sums the segments' normal equations
    before solving -- hot rows train on all their ratings."""

    row_ids: np.ndarray  # [R] int32 -- which row (user/item) each entry solves
    col_ids: np.ndarray  # [B, K] int32 -- rated column indices, 0-padded
    ratings: np.ndarray  # [B, K] float32 -- rating values, 0-padded
    mask: np.ndarray  # [B, K] float32 -- 1 for real entries, 0 for padding
    seg_row: np.ndarray | None = None  # [B] int32 into row_ids, or None

    @property
    def width(self) -> int:
        return self.col_ids.shape[1]


@dataclass
class RatingsData:
    """COO ratings plus both row-major layouts, ready for ALS."""

    rows: np.ndarray  # [N] int32 user indices
    cols: np.ndarray  # [N] int32 item indices
    vals: np.ndarray  # [N] float32 ratings
    num_rows: int
    num_cols: int
    row_buckets: list[PaddedBucket] = field(default_factory=list)
    col_buckets: list[PaddedBucket] = field(default_factory=list)


def build_padded_buckets(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    bucket_widths: Sequence[int] = DEFAULT_BUCKETS,
    segment: bool = True,
) -> list[PaddedBucket]:
    """Group rows by degree into padded buckets.

    Rows whose degree exceeds the largest width are segmented across
    several table rows of the largest bucket (exact training).
    ``segment=False`` is the opt-in lossy cap: such rows keep their
    ``width`` highest-|rating| entries. Buckets are ordered by width,
    rows by id."""
    if len(rows) == 0:
        return []
    order = np.argsort(rows, kind="stable")
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    uniq, starts, counts = np.unique(rows_s, return_index=True, return_counts=True)
    # within-row rank of every entry (entry index - row start)
    rank = np.arange(len(rows_s)) - np.repeat(starts, counts)
    inv = np.repeat(np.arange(len(uniq)), counts)  # entry -> uniq row index

    max_width = int(max(bucket_widths))
    n_over = int((counts > max_width).sum())
    if n_over and not segment:
        logger.warning(
            "ALS bucketing: %d rows exceed max degree %d; keeping the "
            "%d highest-|rating| entries for those rows (segment=False)",
            n_over, max_width, max_width,
        )
        # per-row descending-|rating| order: sort by (row, -|val|), then
        # recompute ranks; entries ranked past the width are dropped
        order2 = np.lexsort((-np.abs(vals_s), rows_s))
        rows_s, cols_s, vals_s = rows_s[order2], cols_s[order2], vals_s[order2]
        rank = np.arange(len(rows_s)) - np.repeat(starts, counts)
        inv = np.repeat(np.arange(len(uniq)), counts)
        keep = rank < max_width
        rows_s, cols_s, vals_s = rows_s[keep], cols_s[keep], vals_s[keep]
        rank, inv = rank[keep], inv[keep]
        counts = np.minimum(counts, max_width)

    buckets: list[PaddedBucket] = []
    widths = sorted(set(int(w) for w in bucket_widths))
    for wi, width in enumerate(widths):
        lo = widths[wi - 1] if wi > 0 else 0
        last = wi == len(widths) - 1
        sel = (counts > lo) if last else (counts > lo) & (counts <= width)
        idx = np.nonzero(sel)[0]
        if len(idx) == 0:
            continue
        buckets.append(
            _fill_bucket_class(width, last, counts, uniq, idx, rank, inv, cols_s, vals_s)
        )
    return buckets


def _fill_bucket_class(
    width: int,
    last: bool,
    counts: np.ndarray,
    uniq: np.ndarray,
    idx: np.ndarray,
    rank: np.ndarray,
    inv: np.ndarray,
    cols_s: np.ndarray,
    vals_s: np.ndarray,
) -> PaddedBucket:
    """Materialize one width class from row-sorted entry arrays.

    ``counts``/``uniq`` describe the distinct rows of the entry set;
    ``idx`` selects this class's rows within ``uniq``; ``rank`` is each
    entry's within-row rank and ``inv`` its ``uniq`` index; ``cols_s``/
    ``vals_s`` are the entries sorted stably by row. A hot row's
    segments take consecutive table rows, so ``seg_row`` never
    decreases -- what lets K1 give one block to each solved row."""
    R = len(idx)
    # per selected row: number of width-sized segments (1 unless hot)
    nseg = (
        np.maximum(1, -(-counts[idx] // width)) if last else np.ones(R, np.int64)
    )
    seg_base = np.concatenate([[0], np.cumsum(nseg)])
    B = int(seg_base[-1])

    # entry -> (segment table row, within-segment position)
    rowpos = np.full(len(uniq), -1, np.int64)
    rowpos[idx] = np.arange(R)
    pos = rowpos[inv]
    m = pos >= 0
    seg_of_entry = seg_base[pos[m]] + rank[m] // width
    within = rank[m] % width

    col_ids = np.zeros((B, width), dtype=np.int32)
    ratings = np.zeros((B, width), dtype=np.float32)
    mask = np.zeros((B, width), dtype=np.float32)
    col_ids[seg_of_entry, within] = cols_s[m]
    ratings[seg_of_entry, within] = vals_s[m]
    mask[seg_of_entry, within] = 1.0

    seg_row = None
    if last and B > R:
        seg_row = np.repeat(np.arange(R, dtype=np.int32), nseg)
    return PaddedBucket(
        row_ids=uniq[idx].astype(np.int32),
        col_ids=col_ids,
        ratings=ratings,
        mask=mask,
        seg_row=seg_row,
    )


def splice_padded_buckets(
    old_buckets: Sequence[PaddedBucket],
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    delta_rows: np.ndarray,
    bucket_widths: Sequence[int] = DEFAULT_BUCKETS,
) -> list[PaddedBucket]:
    """Rebuild padded buckets after a splice, only where it changed them.

    ``rows``/``cols``/``vals`` are the full post-splice COO arrays (old
    entries in their stream order with the delta entries spliced in);
    ``delta_rows`` are the row indices of just the delta entries;
    ``old_buckets`` is the pack of the pre-splice arrays at the same
    ``bucket_widths``. The width classes that could have changed -- the
    current and previous class of every row the delta touches -- are
    rebuilt from the full arrays, restricted to their member rows,
    through :func:`_fill_bucket_class`, the fill of a fresh build; the
    other classes reuse the old bucket arrays as they are. A class's
    arrays depend only on its member rows' entry sequences, which the
    splice leaves alone for an untouched row, so the result is
    bit-identical to :func:`build_padded_buckets` of the full arrays.
    Delta entries may reference existing rows or new rows past the old
    maximum only (the prep cache's appended-ids invariant).
    ``segment=True`` only."""
    if len(rows) == 0:
        return []
    if len(delta_rows) == 0 and old_buckets:
        return list(old_buckets)
    widths = sorted(set(int(w) for w in bucket_widths))
    n_w = len(widths)
    warr = np.asarray(widths)
    bc = np.bincount(rows)
    uniq_all = np.flatnonzero(bc)
    counts_all = bc[uniq_all]
    # width class of every present row: the first width >= its count,
    # clamped to the (segmenting) last class -- the (lo, width] selection
    # of the full build
    cls = np.minimum(np.searchsorted(warr, counts_all, side="left"), n_w - 1)

    touched = np.unique(delta_rows)
    pos_t = np.searchsorted(uniq_all, touched)
    affected = set(int(c) for c in cls[pos_t])
    old_counts_t = counts_all[pos_t] - np.bincount(
        delta_rows, minlength=int(bc.shape[0])
    )[touched]
    existed = old_counts_t > 0
    if existed.any():
        affected |= set(
            int(c) for c in np.minimum(
                np.searchsorted(warr, old_counts_t[existed], side="left"), n_w - 1
            )
        )

    old_by_width = {b.width: b for b in old_buckets}
    out: list[PaddedBucket] = []
    for wi, width in enumerate(widths):
        sel = cls == wi
        if not sel.any():
            continue
        if wi not in affected and width in old_by_width:
            out.append(old_by_width[width])
            continue
        member = np.zeros(bc.shape[0], dtype=bool)
        member[uniq_all[sel]] = True
        m_ent = member[rows]
        sub_rows = rows[m_ent]
        order = np.argsort(sub_rows, kind="stable")
        rows_s = sub_rows[order]
        cols_s = cols[m_ent][order]
        vals_s = vals[m_ent][order]
        uniq, starts, counts = np.unique(rows_s, return_index=True, return_counts=True)
        rank = np.arange(len(rows_s)) - np.repeat(starts, counts)
        inv = np.repeat(np.arange(len(uniq)), counts)
        out.append(
            _fill_bucket_class(
                width, wi == n_w - 1, counts, uniq, np.arange(len(uniq)),
                rank, inv, cols_s, vals_s,
            )
        )
    return out


def build_ratings_data(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    num_rows: int | None = None,
    num_cols: int | None = None,
    bucket_widths: Sequence[int] = DEFAULT_BUCKETS,
    segment: bool = True,
) -> RatingsData:
    rows = np.asarray(rows, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    vals = np.asarray(vals, dtype=np.float32)
    num_rows = int(num_rows if num_rows is not None else rows.max() + 1)
    num_cols = int(num_cols if num_cols is not None else cols.max() + 1)
    return RatingsData(
        rows=rows,
        cols=cols,
        vals=vals,
        num_rows=num_rows,
        num_cols=num_cols,
        row_buckets=build_padded_buckets(rows, cols, vals, bucket_widths, segment),
        col_buckets=build_padded_buckets(cols, rows, vals, bucket_widths, segment),
    )


def segment_offsets(seg_row, num_solved_rows: int, num_table_rows: int) -> np.ndarray:
    """``[R + 1]`` int32 offsets: solved row r sums table rows
    ``[off[r], off[r + 1])``. ``seg_row=None`` means one table row per
    solved row. Raises ValueError unless the segments of each solved row
    are consecutive table rows (``seg_row`` never decreases) -- the
    layout :func:`_fill_bucket_class` builds and K1 relies on."""
    R = int(num_solved_rows)
    if seg_row is None:
        if num_table_rows != R:
            raise ValueError(
                f"an unsegmented bucket solves each of its {num_table_rows} "
                f"table rows, not {R}"
            )
        return np.arange(R + 1, dtype=np.int32)
    seg = np.asarray(seg_row, dtype=np.int64).reshape(-1)
    if seg.shape[0] != num_table_rows:
        raise ValueError(f"seg_row has {seg.shape[0]} entries for {num_table_rows} table rows")
    if seg.size and (seg.min() < 0 or seg.max() >= R):
        raise ValueError(f"seg_row out of range [0, {R})")
    if np.any(np.diff(seg) < 0):
        raise ValueError(
            "seg_row decreases: K1 sums the segments of a solved row from "
            "consecutive table rows"
        )
    counts = np.bincount(seg, minlength=R)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def seg_rows(seg_start: torch.Tensor, num_table_rows: int) -> torch.Tensor | None:
    """The inverse of :func:`segment_offsets`: int64 ``seg_row [B]`` on
    the offsets' device, or None when every solved row is one table row."""
    R = seg_start.shape[0] - 1
    counts = (seg_start[1:] - seg_start[:-1]).to(torch.int64)
    if num_table_rows == R and bool((counts == 1).all()):
        return None
    return torch.repeat_interleave(torch.arange(R, device=seg_start.device), counts)


# ---------------------------------------------------------------------------
# Factor tables: dense or the int8 (values, per-row scales) pair
# ---------------------------------------------------------------------------


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 factors ``[..., N, D]`` -> ``(int8 [..., N, D], f32 [..., N])``
    per-row scales. All-zero rows get scale 1 (quantize to exact zeros).
    ``torch.round`` rounds half to even, as ``jnp.round`` does. Both
    divisions are true divisions: PyTorch's CUDA ``div`` by a Python
    scalar multiplies by its reciprocal, which rounds differently, so the
    127 is a tensor here. A NaN row gets scale 1 and quantizes to zeros,
    as XLA converts NaN to int8 (a NaN cast to int8 is undefined in
    PyTorch, so it is zeroed first)."""
    x = x.to(torch.float32)
    m = x.abs().amax(dim=-1)
    scale = m / torch.full_like(m, 127.0)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    v = torch.round(x / scale[..., None])
    q = torch.where(torch.isnan(v), torch.zeros_like(v), v).to(torch.int8)
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dt: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` in dtype ``dt`` (the product is
    taken in ``dt``, as the JAX package takes it)."""
    return q.to(dt) * scale[..., None].to(dt)


def to_storage(x: torch.Tensor, storage_dtype: str):
    """f32 factors -> their storage representation (tensor or int8 pair)."""
    if storage_dtype == "int8":
        return quantize_rows(x)
    if storage_dtype not in _STORAGE_DTYPES:
        raise ValueError(f"storage_dtype must be one of {_STORAGE_DTYPES}")
    return x.to(getattr(torch, storage_dtype))


def dense_factors(table, dt: torch.dtype = torch.float32) -> torch.Tensor:
    """A whole factor table as a dense tensor of dtype ``dt``."""
    if isinstance(table, tuple):
        return dequantize_rows(table[0], table[1], dt)
    return table.to(dt)


def host_factors(table) -> tuple[np.ndarray, np.ndarray | None]:
    """Factor table -> host arrays ``(values, scales)``: scales is the
    [N] f32 per-row array for the int8 pair, None for dense dtypes.
    bfloat16 values come back as :data:`~predictionio_tpu_torch.models.
    modelfile.BFLOAT16` (numpy has no bfloat16 of its own)."""
    if isinstance(table, tuple):
        return tensor_to_numpy(table[0]), tensor_to_numpy(table[1])
    return tensor_to_numpy(table), None


def table_rows(table) -> int:
    """Row count of a factor table in either representation."""
    return (table[0] if isinstance(table, tuple) else table).shape[0]


def table_dim(table) -> int:
    """Factor dimension (rank) of a table in either representation."""
    return (table[0] if isinstance(table, tuple) else table).shape[1]


def slice_rows(table, n: int):
    """First ``n`` rows of a factor table, preserving representation."""
    if isinstance(table, tuple):
        return (table[0][:n], table[1][:n])
    return table[:n]


def _read_rows(table, ids: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Gather ``table[ids]`` as dtype ``dt``, dequantizing int8 tables in
    ``dt`` after the gather."""
    if isinstance(table, tuple):
        q, s = table
        return dequantize_rows(q[ids], s[ids], dt)
    return table[ids].to(dt)


def _scatter_rows(target, row_ids: torch.Tensor, x: torch.Tensor) -> None:
    """Write freshly solved f32 rows ``x`` into the storage-format table,
    requantizing for int8 storage -- K1's write-back, in plain PyTorch.
    In place (the JAX package returns new arrays): the solve of one
    half-step reads the other table only."""
    ids = row_ids.to(torch.int64)
    if isinstance(target, tuple):
        tq, ts = target
        q, s = quantize_rows(x)
        tq.index_copy_(0, ids, q)
        ts.index_copy_(0, ids, s)
        return
    target.index_copy_(0, ids, x.to(target.dtype))


# ---------------------------------------------------------------------------
# K1: the fused bucket solve -- plain version and kernel wrapper
# ---------------------------------------------------------------------------


def _bucket_weights(ratings: torch.Tensor, mask: torch.Tensor, dt: torch.dtype,
                    implicit: bool = False, alpha: float = 1.0):
    """Per-entry Gramian weight ``w`` and rhs weight ``r``, each rounded
    to the compute dtype. Explicit: ``w = mask``, ``r = rating * mask``.
    Implicit (Hu-Koren-Volinsky confidence ``1 + alpha * r``): ``w =
    alpha * rating * mask``, ``r = (1 + alpha * rating) * mask``."""
    if implicit:
        return ((alpha * ratings) * mask).to(dt), ((1.0 + alpha * ratings) * mask).to(dt)
    return mask.to(dt), (ratings * mask).to(dt)


def compute_gram(factors, compute_dtype: str = "float32") -> torch.Tensor:
    """``Y^T Y`` ``[D, D]`` float32 of a whole factor table, read in the
    compute dtype (the implicit-feedback term). A bf16 value times a bf16
    value is exact in float32, so the float32 product of the upcast
    table is the JAX package's bf16 product with float32 accumulation.
    A plain matrix product outside any kernel (the JAX package leaves it
    to XLA): ``torch.matmul``, TF32 off on the card. A ``[C, N, D]``
    stack of candidates' tables gives their ``[C, D, D]`` Gramians in one
    batched product."""
    y = dense_factors(factors, _COMPUTE_DTYPES[compute_dtype]).to(torch.float32)
    return y.transpose(-2, -1) @ y


def _cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve; a system whose Cholesky fails (a pivot that is
    not > 0, NaN included) solves to an all-NaN row, as the JAX package's
    ``cho_factor`` / ``cho_solve`` gives."""
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b[:, :, None], L)[:, :, 0]
    failed = (info > 0) | ~(L.diagonal(dim1=-2, dim2=-1) > 0).all(dim=-1)
    return torch.where(failed[:, None], torch.full_like(x, float("nan")), x)


def solve_bucket_reference(
    other,
    col_ids: torch.Tensor,
    ratings: torch.Tensor,
    mask: torch.Tensor,
    reg: float,
    seg_row: torch.Tensor | None = None,
    num_solved_rows: int | None = None,
    weighted_reg: bool = True,
    compute_dtype: str = "float32",
    gather_chunk_bytes: int = 2 << 30,
    implicit: bool = False,
    alpha: float = 1.0,
    gram: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of K1: ``x [R, D]`` float32.

    Gathers ``other[col_ids]`` (dequantizing int8 in ``compute_dtype``),
    builds ``A = (v*w)^T v`` and ``b = r^T v`` with ``bmm`` in float32
    (``w``, ``r``: :func:`_bucket_weights`), index-adds the segments of
    hot rows, adds ``reg * (n or 1) * I`` (the identity where ``n ==
    0``), then with ``implicit`` the ``[D, D]`` ``gram``, in that order
    (``_finish_bucket_solve``), and solves by Cholesky
    (:func:`_cholesky_solve`: a failed factorization gives NaN). The
    ``[B, K, D]`` gather is taken in chunks of at most
    ``gather_chunk_bytes`` (``_gramian_rhs_gathered``)."""
    dt = _COMPUTE_DTYPES[compute_dtype]
    B, K = col_ids.shape
    D = table_dim(other)
    device = col_ids.device
    if implicit and gram is None:
        raise ValueError("an implicit solve needs gram (compute_gram of other)")
    w, r = _bucket_weights(ratings, mask, dt, implicit, alpha)
    itemsize = torch.empty((), dtype=dt).element_size()
    if B * K * D * itemsize <= gather_chunk_bytes or B <= 1:
        chunk = max(B, 1)
    else:
        chunk = max(1, gather_chunk_bytes // (K * D * itemsize))
    A = torch.empty((B, D, D), dtype=torch.float32, device=device)
    b = torch.empty((B, D), dtype=torch.float32, device=device)
    ids = col_ids.to(torch.int64)
    for lo in range(0, B, chunk):
        hi = min(B, lo + chunk)
        vg = _read_rows(other, ids[lo:hi], dt)  # [c, K, D]
        vw = (vg * w[lo:hi, :, None]).to(torch.float32)
        vg = vg.to(torch.float32)
        A[lo:hi] = torch.bmm(vw.transpose(1, 2), vg)
        b[lo:hi] = torch.bmm(r[lo:hi, None, :].to(torch.float32), vg)[:, 0]
    n = mask.sum(dim=1)
    if seg_row is not None:
        R = int(num_solved_rows)
        seg = seg_row.to(torch.int64)
        A = torch.zeros((R, D, D), dtype=A.dtype, device=device).index_add_(0, seg, A)
        b = torch.zeros((R, D), dtype=b.dtype, device=device).index_add_(0, seg, b)
        n = torch.zeros((R,), dtype=n.dtype, device=device).index_add_(0, seg, n)
    lam = reg * n if weighted_reg else torch.full_like(n, reg)
    lam = torch.where(n > 0, lam, torch.ones_like(lam))
    A = A + lam[:, None, None] * torch.eye(D, dtype=torch.float32, device=device)
    if implicit:
        A = A + gram.to(torch.float32)[None, :, :]
    return _cholesky_solve(A, b)


def k1_route(D: int, R: int, B: int) -> str:
    """Which of K1's kernels solve a bucket of rank ``D`` with ``R``
    solved rows over ``B`` table rows: ``"warp"`` (one launch, a warp per
    solved row) for ``D <= WARP_MAX_RANK`` where ``B <= R`` (every solved
    row one table row at most, as in an unsegmented bucket); ``"split"``
    (two launches: a warp per table row writes its partial sums, then a
    warp per solved row adds its segments' and solves) for ``D <=
    WARP_MAX_RANK`` where ``B > R``; ``"block"`` (one launch, a
    256-thread block per solved row) for ``WARP_MAX_RANK < D <=
    MAX_RANK``."""
    if not 1 <= D <= MAX_RANK:
        raise ValueError(f"K1 solves ranks 1..{MAX_RANK}, got {D}")
    if D > WARP_MAX_RANK:
        return "block"
    return "warp" if B <= R else "split"


# csrc/als_solve.cu enum Launch: each route's kernels, in launch order
_LAUNCH_CODES = {"block": (0,), "warp": (1,), "split": (2, 3)}


def k1_launches(D: int, R: int, B: int) -> int:
    """K1's kernel launches for one bucket (:func:`k1_route`): what
    ``solve_bucket.launches`` counts."""
    return len(_LAUNCH_CODES[k1_route(D, R, B)])


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def k1s_row_blocks(S: int, D: int, I: int) -> int:
    """Column blocks of row block ``I`` in K1s's ``S x S`` blocking of one
    candidate's sums: rows 0 .. D-1 hold A's lower triangle (``k <= i``),
    row D holds b (csrc/als_solve.cu ``k1s_row_blocks``)."""
    return min(-(-D // S), min(I * S + S - 1, D) // S + 1)


def k1s_blocks(S: int, D: int) -> int:
    """``S x S`` blocks covering one candidate's ``(D + 1) x D`` lower
    trapezoid of sums (``csrc/als_solve.cu k1s_blocks``)."""
    return sum(k1s_row_blocks(S, D, I) for I in range(-(-(D + 1) // S)))


def _k1s_record(S: int, D: int) -> int:
    return _round_up(D + 1, 4) + _round_up(D, S)


def k1s_warp_floats(S: int, D: int, cw: int) -> int:
    """A K1s warp's shared floats: its tile of 32 entries' records, then
    the weights and the int8 scales, ``[32, cw]`` each."""
    return 32 * cw * _k1s_record(S, D) + 64 * cw


@dataclass(frozen=True)
class K1sPlan:
    """K1s's plan of a sweep's accumulation (csrc/als_solve.cu
    ``k1s_plan``): a warp sums one table row for ``cw`` candidates,
    ``chunks`` chunks of them on the grid's second axis; each lane owns
    ``nb`` blocks of ``S x S`` sums; ``warps`` table rows a block."""

    cw: int
    chunks: int
    S: int
    nb: int
    warps: int


def k1s_plan(C: int, D: int) -> K1sPlan:
    """The plan of a sweep of ``C`` candidates at rank ``D <= 32``, the
    formula of csrc/als_solve.cu ``k1s_plan``: for each block side S in
    :data:`K1S_SHAPES`, the most candidates a warp takes (at most 32) with
    at most :data:`K1S_MAX_NB` blocks a lane and a tile within
    :data:`K1S_WARP_SMEM` bytes, split into chunks of equal size; an entry
    costs ``nb * max(S * S, 8 * S)`` a chunk (a lane's S*S FMAs a block,
    four warp FMAs an SM clock, against its 2S shared words, one 32-word
    wavefront a clock) times the chunks. The cheapest S wins, the larger
    on a tie."""
    if not 1 <= D <= WARP_MAX_RANK or C < 1:
        raise ValueError(f"K1s plans C >= 1 candidates at ranks 1..{WARP_MAX_RANK}")
    best, best_cost = None, None
    for S in K1S_SHAPES:
        nblk = k1s_blocks(S, D)
        cw = min(C, 32, 32 * K1S_MAX_NB // nblk)
        while cw > 0 and 4 * k1s_warp_floats(S, D, cw) > K1S_WARP_SMEM:
            cw -= 1
        if cw == 0:
            continue
        chunks = -(-C // cw)
        cw = -(-C // chunks)
        nb = -(-(cw * nblk) // 32)
        cost = nb * max(S * S, 8 * S) * chunks
        if best_cost is None or cost <= best_cost:
            best, best_cost = (cw, chunks, S, nb), cost
    cw, chunks, S, nb = best
    warps = max(1, min(K1S_MAX_WARPS, K1S_BLOCK_SMEM // (4 * k1s_warp_floats(S, D, cw))))
    return K1sPlan(cw, chunks, S, nb, warps)


def k1s_lane_blocks(plan: K1sPlan, D: int, cn: int) -> list[list[tuple[int, int, int]]]:
    """For each lane of a K1s warp serving ``cn`` candidates, its blocks
    ``(candidate, i0, j0)`` in the order it owns them: block ``u = lane +
    32 q`` of the chunk's blocks, candidate after candidate, each
    candidate's row blocks in order (csrc/als_solve.cu ``sweep_block``)."""
    S, nblk = plan.S, k1s_blocks(plan.S, D)
    lanes = []
    for lane in range(32):
        owned = []
        for q in range(plan.nb):
            u = lane + 32 * q
            if u >= cn * nblk:
                continue
            c, b = divmod(u, nblk)
            I = 0
            while b >= k1s_row_blocks(S, D, I):
                b -= k1s_row_blocks(S, D, I)
                I += 1
            owned.append((c, I * S, b * S))
        lanes.append(owned)
    return lanes


def entry_major(table):
    """A stacked table ``[C, N, D]`` (int8 pair: ``([C, N, D], [C, N])``)
    as K1s keeps it: ``[N, C, D]`` in memory (scales ``[N, C]``), so one
    entry's C candidate rows are contiguous, seen through a ``[C, N, D]``
    view. A copy unless the table is laid out so already."""
    if isinstance(table, tuple):
        return entry_major(table[0]), table[1].t().contiguous().t()
    return table.transpose(0, 1).contiguous().transpose(0, 1)


def is_entry_major(table) -> bool:
    """Is the ``[C, N, D]`` stack (or int8 pair) K1s's layout?"""
    if isinstance(table, tuple):
        return is_entry_major(table[0]) and table[1].t().is_contiguous()
    return table.dim() == 3 and table.transpose(0, 1).is_contiguous()


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("als_solve")
    if not getattr(lib, "_pio_typed", False):
        lib.pio_k1_solve_bucket.argtypes = [
            _I,  # launch (_LAUNCH_CODES)
            _P, _I, _P,  # other values, dtype code, scales
            _P, _P, _P, _P,  # col_ids, ratings, mask, seg_start
            _I, _I, _I, _I,  # R, B, K, D
            ctypes.c_float, _I, _I,  # reg, weighted, bf16 compute
            _I, ctypes.c_float, _P,  # implicit, alpha, gram (or NULL)
            _P, _P,  # workspace (or NULL), x out (or NULL)
            _P, _I, _P, _P,  # target values, dtype code, scales, row_ids
            _I, _P, _P,  # candidates C, regs [C] (or NULL), alphas [C] (or NULL)
            _I, _I,  # rows of one candidate's other / target table
            _P,  # stream
        ]
        lib.pio_k1_solve_bucket.restype = _I
        lib.pio_k1s_sweep.argtypes = [
            _I,  # launch (_SWEEP_CODES)
            _P, _I, _P,  # other values, dtype code, scales
            _P, _P, _P, _P,  # col_ids, ratings, mask, seg_start
            _I, _I, _I, _I, _I,  # R, B, K, D, C
            _I, _I, _I,  # weighted, bf16 compute, implicit
            _P, _P, _P, _P,  # regs [C], alphas [C], gram (or NULL), workspace (or NULL)
            _P, _I, _P, _P,  # target values, dtype code, scales, row_ids
            _P,  # plan out: 5 ints (or NULL)
            _P,  # stream
        ]
        lib.pio_k1s_sweep.restype = _I
        lib._pio_typed = True
    return lib


def _split_table(table, name: str, candidates: int = 0):
    """(values, scales or None, dtype code), checked for the kernel: an
    ``[N, D]`` table, or with ``candidates`` C > 0 a ``[C, N, D]`` stack
    (int8 scales ``[C, N]``)."""
    values, scales = table if isinstance(table, tuple) else (table, None)
    code = _DTYPE_CODE.get(values.dtype)
    lead = (candidates,) if candidates else ()
    if (code is None or values.dim() != 2 + len(lead)
            or tuple(values.shape[:len(lead)]) != lead or not values.is_contiguous()):
        shape = "[C, N, D]" if lead else "[N, D]"
        raise ValueError(
            f"{name}: expected a contiguous {shape} float32/bfloat16/int8 "
            f"tensor, got {values.dtype} {tuple(values.shape)}"
        )
    if (code == 2) != (scales is not None):
        raise ValueError(f"{name}: int8 values come with f32 scales, others without")
    if scales is not None and (
        scales.dtype != torch.float32 or scales.shape != values.shape[:-1]
        or not scales.is_contiguous()
    ):
        raise ValueError(f"{name}: scales must be contiguous float32 {tuple(values.shape[:-1])}")
    return values, scales, code


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if (t.dtype != dtype or tuple(t.shape) != shape or t.device != device
            or not t.is_contiguous()):
        raise ValueError(
            f"{name}: expected contiguous {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )


def solve_bucket(
    other,
    col_ids: torch.Tensor,
    ratings: torch.Tensor,
    mask: torch.Tensor,
    seg_start: torch.Tensor,
    reg: float,
    weighted_reg: bool = True,
    compute_dtype: str = "float32",
    target=None,
    row_ids: torch.Tensor | None = None,
    return_x: bool = True,
    gather_chunk_bytes: int = 2 << 30,
    implicit: bool = False,
    alpha: float = 1.0,
    gram: torch.Tensor | None = None,
):
    """K1: one bucket's solve, with its write-back.

    ``other``: the opposite factor table (dense f32/bf16 ``[N, D]`` or the
    int8 pair), D <= 128. ``col_ids`` int32, ``ratings``/``mask`` float32
    ``[B, K]``; ``seg_start`` int32 ``[R + 1]`` from
    :func:`segment_offsets` (solved row r sums table rows ``seg_start[r]``
    to ``seg_start[r + 1]``). With ``target`` (a storage table of the
    solved side) and ``row_ids`` (int32 ``[R]``), solved row r is written
    into ``target[row_ids[r]]`` in place: a cast for f32/bf16, the
    per-row max-abs/127 requantize for int8. ``target`` must not be
    ``other`` (U is solved from V and V from U). ``implicit`` solves the
    Hu-Koren-Volinsky system with confidence ``1 + alpha * rating`` and
    the float32 ``[D, D]`` ``gram`` of ``other`` (:func:`compute_gram`);
    ``weighted_reg`` is then the caller's ``implicit_weighted_reg``.
    Returns ``x [R, D]`` float32 when ``return_x``, else None.

    CPU tensors take :func:`solve_bucket_reference` + :func:`_scatter_rows`;
    CUDA tensors launch the kernels of the route :func:`k1_route` picks
    (``csrc/als_solve.cu``; a segmented bucket on the warp route takes a
    ``[B, D(D+3)/2 + 2]`` float32 workspace from torch's allocator) or
    raise. ``solve_bucket.launches`` counts kernel launches. As with K2's
    device indices, the values of ``col_ids``, ``seg_start`` and
    ``row_ids`` on the card are the caller's to keep in range:
    :func:`device_buckets` builds them from checked host arrays."""
    _check_solve_args(compute_dtype, target, row_ids, implicit, gram)
    device = col_ids.device
    if device.type == "cpu":
        R = seg_start.shape[0] - 1
        x = solve_bucket_reference(
            other, col_ids, ratings, mask, reg,
            seg_rows(seg_start, col_ids.shape[0]), R, weighted_reg,
            compute_dtype, gather_chunk_bytes, implicit, alpha, gram,
        )
        if target is not None:
            _scatter_rows(target, row_ids, x)
        return x if return_x else None
    return _solve_on_card(None, solve_bucket.launches, other, col_ids, ratings, mask,
                          seg_start, reg, weighted_reg, compute_dtype, target, row_ids,
                          return_x, implicit, alpha, gram)


def _solve_bucket_block(other, col_ids, ratings, mask, seg_start, reg,
                        weighted_reg: bool = True, compute_dtype: str = "float32",
                        target=None, row_ids=None, return_x: bool = True,
                        implicit: bool = False, alpha: float = 1.0, gram=None):
    """K1's block kernel at any rank <= 128, whatever :func:`k1_route`
    picks: the same-run baseline and bit-exact check of the warp route
    for ``chip_smoke.py``. The port never calls it. CUDA tensors only;
    counts its launches in ``_solve_bucket_block.launches``."""
    _check_solve_args(compute_dtype, target, row_ids, implicit, gram)
    return _solve_on_card("block", _solve_bucket_block.launches, other, col_ids, ratings,
                          mask, seg_start, reg, weighted_reg, compute_dtype, target,
                          row_ids, return_x, implicit, alpha, gram)


def _check_solve_args(compute_dtype, target, row_ids, implicit, gram) -> None:
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}")
    if target is not None and row_ids is None:
        raise ValueError("a write-back target needs row_ids")
    if implicit and gram is None:
        raise ValueError("an implicit solve needs gram (compute_gram of other)")


def _solve_on_card(route, counter, other, col_ids, ratings, mask, seg_start, reg,
                   weighted_reg, compute_dtype, target, row_ids, return_x, implicit,
                   alpha, gram, regs=None, alphas=None):
    """K1's launches on CUDA tensors: ``route`` (:func:`k1_route`'s pick
    when None), each launch checked and added to ``counter``. With
    ``regs`` (a ``[C]`` float32 tensor) it is K1s: ``other``, ``target``
    and ``gram`` carry a leading candidate axis of C, ``alphas`` is
    ``[C]`` float32, and one launch a kernel serves every candidate."""
    device = col_ids.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    C = 1 if regs is None else regs.shape[0]
    o_vals, o_scales, o_code = _split_table(other, "other", C if regs is not None else 0)
    B, K = col_ids.shape
    R = seg_start.shape[0] - 1
    D = o_vals.shape[-1]
    if not 1 <= D <= MAX_RANK:
        raise ValueError(f"K1 solves ranks 1..{MAX_RANK}, got {D}")
    route = route or k1_route(D, R, B)
    for t, name in ((o_vals, "other"), (o_scales, "other scales")):
        if t is not None and t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")
    _check(col_ids, "col_ids", torch.int32, (B, K), device)
    _check(ratings, "ratings", torch.float32, (B, K), device)
    _check(mask, "mask", torch.float32, (B, K), device)
    _check(seg_start, "seg_start", torch.int32, (R + 1,), device)
    lead = () if regs is None else (C,)
    if regs is not None:
        if not 1 <= C <= MAX_CANDIDATES:
            raise ValueError(f"K1s takes 1..{MAX_CANDIDATES} candidates, got {C}")
        _check(regs, "regs", torch.float32, (C,), device)
        _check(alphas, "alphas", torch.float32, (C,), device)
    if implicit:
        _check(gram, "gram", torch.float32, lead + (D, D), device)
    t_vals = t_scales = None
    t_code = 0
    if target is not None:
        t_vals, t_scales, t_code = _split_table(target, "target", len(lead) and C)
        if t_vals.shape[-1] != D:
            raise ValueError("target and other differ in rank")
        for t, name in ((t_vals, "target"), (t_scales, "target scales")):
            if t is not None and t.device != device:
                raise ValueError(f"{name} on {t.device}, expected {device}")
        if t_vals.data_ptr() == o_vals.data_ptr():
            raise ValueError("K1 cannot write back into the table it reads")
        _check(row_ids, "row_ids", torch.int32, (R,), device)
    x = torch.empty(lead + (R, D), dtype=torch.float32, device=device) if return_x else None
    if R == 0:
        return x
    # the split route's partials; freed to torch's allocator after the
    # launches are queued, reused only by later work on the same stream
    ws = (torch.empty(lead + (B, D * (D + 3) // 2 + 2), dtype=torch.float32,
                      device=device)
          if route == "split" else None)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for launch in _LAUNCH_CODES[route]:
            err = lib.pio_k1_solve_bucket(
                launch, o_vals.data_ptr(), o_code,
                None if o_scales is None else o_scales.data_ptr(),
                col_ids.data_ptr(), ratings.data_ptr(), mask.data_ptr(),
                seg_start.data_ptr(), R, B, K, D,
                float(reg), int(bool(weighted_reg)), int(compute_dtype == "bfloat16"),
                int(bool(implicit)), float(alpha), gram.data_ptr() if implicit else None,
                None if ws is None else ws.data_ptr(),
                None if x is None else x.data_ptr(),
                None if t_vals is None else t_vals.data_ptr(), t_code,
                None if t_scales is None else t_scales.data_ptr(),
                None if target is None else row_ids.data_ptr(),
                C, None if regs is None else regs.data_ptr(),
                None if alphas is None else alphas.data_ptr(),
                o_vals.shape[-2], 0 if t_vals is None else t_vals.shape[-2],
                stream,
            )
            _build.check(err, f"solve_bucket kernel launch ({route} route)")
            counter.add()
    return x


solve_bucket.launches = _build.LaunchCount()
_solve_bucket_block.launches = _build.LaunchCount()
obs_metrics.gauge(
    "pio_k1_kernel_launches", "Kernels K1's solves launched on the card, "
    "since the process started",
).set_function(lambda: float(solve_bucket.launches.value))


def _candidate(table, c: int, rank: int | None = None):
    """Candidate ``c``'s ``[N, D]`` table of a ``[C, N, D]`` stack,
    keeping the representation: a view, or with ``rank`` a contiguous
    copy of its first ``rank`` columns (and of its int8 scales)."""
    if rank is None:
        return (table[0][c], table[1][c]) if isinstance(table, tuple) else table[c]
    if isinstance(table, tuple):
        return (table[0][c, :, :rank].contiguous(), table[1][c].contiguous())
    return table[c, :, :rank].contiguous()


def k1s_route(D: int, R: int, B: int) -> str:
    """Which of K1s's kernels solve a sweep's bucket of rank ``D`` (with
    ``R`` solved rows over ``B`` table rows): ``"split"`` up to rank 32
    (two launches: a warp per table row writes each candidate's partial
    sums, then the finish, :func:`k1s_finish`); ``"block"`` (K1's block
    kernel with the candidates on the grid's second axis, one launch) for
    ``WARP_MAX_RANK < D <= MAX_RANK``."""
    if not 1 <= D <= MAX_RANK:
        raise ValueError(f"K1s solves ranks 1..{MAX_RANK}, got {D}")
    return "split" if D <= WARP_MAX_RANK else "block"


# csrc/als_solve.cu enum SweepLaunch: each K1s route's kernels, in launch order
_SWEEP_CODES = {"split": (0, 1), "block": (2,)}


def k1s_finish(R: int, C: int) -> str:
    """Which kernel finishes a K1s bucket of ``R`` solved rows for ``C``
    candidates: ``"thread"`` (a thread a system, 32 systems a warp: the
    throughput of many systems) from :data:`K1S_THREAD_SYSTEMS` systems
    up, else ``"warp"`` (a warp a row, D lanes a candidate: the latency of
    few)."""
    return "thread" if R * C >= K1S_THREAD_SYSTEMS else "warp"


def k1s_launches(D: int, R: int, B: int) -> int:
    """K1s's kernel launches for one bucket (:func:`k1s_route`): what
    ``solve_bucket_sweep.launches`` counts."""
    return len(_SWEEP_CODES[k1s_route(D, R, B)])


def solve_bucket_sweep(
    other,
    col_ids: torch.Tensor,
    ratings: torch.Tensor,
    mask: torch.Tensor,
    seg_start: torch.Tensor,
    regs: torch.Tensor,
    target,
    row_ids: torch.Tensor,
    weighted_reg: bool = True,
    compute_dtype: str = "float32",
    gather_chunk_bytes: int = 2 << 30,
    implicit: bool = False,
    alphas: torch.Tensor | None = None,
    gram: torch.Tensor | None = None,
) -> None:
    """K1s: one bucket's solve and write-back for C candidates at once.

    ``other`` and ``target``: ``[C, N, D]`` stacks of the candidates'
    tables (dense, or the int8 pair ``([C, N, D], [C, N])``); ``regs``
    and ``alphas``: ``[C]`` float32 on the tables' device; ``gram``:
    ``[C, D, D]`` float32 (implicit). The bucket arrays are
    :func:`solve_bucket`'s, shared by every candidate. Candidate c's
    rows are what :func:`solve_bucket` writes for that candidate alone.

    CPU tensors take :func:`solve_bucket_sweep_reference` (any layout).
    CUDA tensors must be entry-major stacks (:func:`entry_major`, as
    :func:`sweep_init` makes them) and launch the kernels of the route
    :func:`k1s_route` picks, once for all candidates, or raise.
    ``solve_bucket_sweep.launches`` counts kernel launches;
    ``solve_bucket_sweep.last_plan`` is the C entry's :class:`K1sPlan` of
    the latest launch at ``D <= WARP_MAX_RANK``."""
    _check_solve_args(compute_dtype, target, row_ids, implicit, gram)
    if alphas is None:
        alphas = torch.ones_like(regs)
    if col_ids.device.type == "cpu":
        solve_bucket_sweep_reference(
            other, col_ids, ratings, mask, seg_start, regs, target, row_ids,
            weighted_reg, compute_dtype, gather_chunk_bytes, implicit, alphas, gram,
        )
        return None
    _sweep_on_card(other, col_ids, ratings, mask, seg_start, regs, alphas, target, row_ids,
                   weighted_reg, compute_dtype, implicit, gram)
    return None


solve_bucket_sweep.launches = _build.LaunchCount()
solve_bucket_sweep.last_plan = None


def _sweep_on_card(other, col_ids, ratings, mask, seg_start, regs, alphas, target, row_ids,
                   weighted_reg, compute_dtype, implicit, gram) -> None:
    """K1s's launches on CUDA tensors (:func:`k1s_route`), each checked
    and counted in ``solve_bucket_sweep.launches``."""
    device = col_ids.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    C = regs.shape[0]
    if not 1 <= C <= MAX_CANDIDATES:
        raise ValueError(f"K1s takes 1..{MAX_CANDIDATES} candidates, got {C}")
    o_vals, o_scales, o_code = _sweep_table(other, "other", C)
    t_vals, t_scales, t_code = _sweep_table(target, "target", C)
    B, K = col_ids.shape
    R = seg_start.shape[0] - 1
    D = o_vals.shape[-1]
    if not 1 <= D <= MAX_RANK:
        raise ValueError(f"K1s solves ranks 1..{MAX_RANK}, got {D}")
    if t_vals.shape[-1] != D:
        raise ValueError("target and other differ in rank")
    if t_vals.data_ptr() == o_vals.data_ptr():
        raise ValueError("K1s cannot write back into the table it reads")
    for t, name in ((o_vals, "other"), (o_scales, "other scales"), (t_vals, "target"),
                    (t_scales, "target scales")):
        if t is not None and t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")
    _check(col_ids, "col_ids", torch.int32, (B, K), device)
    _check(ratings, "ratings", torch.float32, (B, K), device)
    _check(mask, "mask", torch.float32, (B, K), device)
    _check(seg_start, "seg_start", torch.int32, (R + 1,), device)
    _check(row_ids, "row_ids", torch.int32, (R,), device)
    _check(regs, "regs", torch.float32, (C,), device)
    _check(alphas, "alphas", torch.float32, (C,), device)
    if implicit:
        _check(gram, "gram", torch.float32, (C, D, D), device)
    if R == 0:
        return
    route = k1s_route(D, R, B)
    # the split route's partials; freed to torch's allocator after the
    # launches are queued, reused only by later work on the same stream
    ws = (torch.empty((C, B, D * (D + 3) // 2 + 2), dtype=torch.float32, device=device)
          if route == "split" else None)
    plan = (ctypes.c_int * 5)()
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for launch in _SWEEP_CODES[route]:
            err = lib.pio_k1s_sweep(
                launch, o_vals.data_ptr(), o_code,
                None if o_scales is None else o_scales.data_ptr(),
                col_ids.data_ptr(), ratings.data_ptr(), mask.data_ptr(),
                seg_start.data_ptr(), R, B, K, D, C,
                int(bool(weighted_reg)), int(compute_dtype == "bfloat16"), int(bool(implicit)),
                regs.data_ptr(), alphas.data_ptr(), gram.data_ptr() if implicit else None,
                None if ws is None else ws.data_ptr(),
                t_vals.data_ptr(), t_code, None if t_scales is None else t_scales.data_ptr(),
                row_ids.data_ptr(), plan, stream,
            )
            _build.check(err, f"solve_bucket_sweep kernel launch ({route} route)")
            solve_bucket_sweep.launches.add()
    if route != "block":
        solve_bucket_sweep.last_plan = K1sPlan(*plan)


def _sweep_table(table, name: str, C: int):
    """(values, scales or None, dtype code) of an entry-major ``[C, N, D]``
    stack (:func:`entry_major`), checked for K1s."""
    values, scales = table if isinstance(table, tuple) else (table, None)
    code = _DTYPE_CODE.get(values.dtype)
    if (code is None or values.dim() != 3 or values.shape[0] != C
            or not values.transpose(0, 1).is_contiguous()):
        raise ValueError(
            f"{name}: expected an entry-major [C, N, D] float32/bfloat16/int8 stack "
            f"(ops/als.py entry_major) with C = {C}, got {values.dtype} "
            f"{tuple(values.shape)} strides {values.stride()}"
        )
    if (code == 2) != (scales is not None):
        raise ValueError(f"{name}: int8 values come with f32 scales, others without")
    if scales is not None and (
        scales.dtype != torch.float32 or scales.shape != values.shape[:-1]
        or not scales.t().is_contiguous()
    ):
        raise ValueError(f"{name}: scales must be entry-major float32 {tuple(values.shape[:-1])}")
    return values, scales, code


def _solve_bucket_sweep_grid(other, col_ids, ratings, mask, seg_start, regs, target, row_ids,
                             weighted_reg: bool = True, compute_dtype: str = "float32",
                             implicit: bool = False, alphas=None, gram=None) -> None:
    """K1s's earlier design: K1's launches (:func:`k1_route`) with the
    candidates on the grid's second axis, on contiguous ``[C, N, D]``
    stacks -- the same-run baseline and bit-exact check of
    :func:`solve_bucket_sweep` for ``chip_smoke.py``. The port never calls
    it. CUDA tensors only; counts its launches in
    ``_solve_bucket_sweep_grid.launches``."""
    _check_solve_args(compute_dtype, target, row_ids, implicit, gram)
    if alphas is None:
        alphas = torch.ones_like(regs)
    _solve_on_card(None, _solve_bucket_sweep_grid.launches, other, col_ids, ratings, mask,
                   seg_start, 0.0, weighted_reg, compute_dtype, target, row_ids,
                   False, implicit, 1.0, gram, regs=regs, alphas=alphas)


_solve_bucket_sweep_grid.launches = _build.LaunchCount()


def solve_bucket_sweep_reference(other, col_ids, ratings, mask, seg_start, regs,
                                 target, row_ids, weighted_reg: bool = True,
                                 compute_dtype: str = "float32",
                                 gather_chunk_bytes: int = 2 << 30,
                                 implicit: bool = False, alphas=None, gram=None) -> None:
    """The plain PyTorch version of K1s, same contract as
    :func:`solve_bucket_sweep`: for each candidate in turn,
    :func:`solve_bucket_reference` on its tables with its reg and alpha,
    then :func:`_scatter_rows` into its target."""
    R = seg_start.shape[0] - 1
    seg = seg_rows(seg_start, col_ids.shape[0])
    for c in range(regs.shape[0]):
        x = solve_bucket_reference(
            _candidate(other, c), col_ids, ratings, mask, float(regs[c]), seg, R,
            weighted_reg, compute_dtype, gather_chunk_bytes, implicit,
            1.0 if alphas is None else float(alphas[c]),
            None if gram is None else gram[c],
        )
        _scatter_rows(_candidate(target, c), row_ids, x)


def solve_bucket_explicit(
    factors_other,
    col_ids,
    ratings,
    mask,
    reg: float,
    weighted_reg: bool = True,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """Solve one padded, unsegmented bucket's normal equations:
    ``A_u = sum v v^T + reg * (n_u if weighted_reg else 1) * I``,
    ``b_u = sum r v``; returns ``x [B, D]`` float32 on the table's
    device (the public single-bucket solve, through K1)."""
    return _solve_unsegmented(factors_other, col_ids, ratings, mask, reg,
                              weighted_reg=weighted_reg, compute_dtype=compute_dtype)


def _solve_unsegmented(factors_other, col_ids, ratings, mask, reg: float, **kwargs):
    """K1 on one unsegmented bucket given as arrays of any origin: moved to
    the table's device in K1's dtypes, one table row per solved row."""
    values = factors_other[0] if isinstance(factors_other, tuple) else factors_other
    device = values.device
    col_ids = torch.as_tensor(col_ids, device=device).to(torch.int32).contiguous()
    ratings = torch.as_tensor(ratings, device=device).to(torch.float32).contiguous()
    mask = torch.as_tensor(mask, device=device).to(torch.float32).contiguous()
    seg_start = torch.arange(col_ids.shape[0] + 1, dtype=torch.int32, device=device)
    return solve_bucket(factors_other, col_ids, ratings, mask, seg_start, reg, **kwargs)


def solve_bucket_implicit(
    factors_other,
    gram,
    col_ids,
    ratings,
    mask,
    reg: float,
    alpha: float,
    weighted_reg: bool = False,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """Implicit-feedback solve of one padded, unsegmented bucket
    (Hu-Koren-Volinsky; MLlib ``trainImplicit``): confidence ``c = 1 +
    alpha * r``, ``A_u = Y^T Y + sum alpha r v v^T + reg * (n_u if
    weighted_reg else 1) * I``, ``b_u = sum (1 + alpha r) v``, with
    ``gram = Y^T Y`` over the whole opposite table (:func:`compute_gram`).
    Returns ``x [B, D]`` float32 on the table's device, through K1, which
    adds the regularizer before the Gramian as the training path does
    (the JAX package's standalone solve adds ``gram + A_c + lam I``: the
    same sum, rounded in another order)."""
    values = factors_other[0] if isinstance(factors_other, tuple) else factors_other
    gram = torch.as_tensor(gram, device=values.device).to(torch.float32).contiguous()
    return _solve_unsegmented(factors_other, col_ids, ratings, mask, reg,
                              weighted_reg=weighted_reg, compute_dtype=compute_dtype,
                              implicit=True, alpha=alpha, gram=gram)


# ---------------------------------------------------------------------------
# Training loop
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ALSParams:
    """The JAX package's ``ALSParams``, every field kept so variants and
    persisted params read the same. The sharded-trainer budget belongs to
    a later slice."""

    rank: int = 10
    iterations: int = 10
    reg: float = 0.01
    implicit: bool = False
    alpha: float = 1.0
    weighted_reg: bool = True  # explicit path: ALS-WR reg * n_u scaling
    implicit_weighted_reg: bool = False  # implicit path default: plain reg*I
    seed: int = 7
    compute_dtype: str = "float32"
    # dtype the factor tables are stored in between solves; every solve
    # accumulates and solves in float32
    storage_dtype: str = "float32"
    bucket_widths: tuple[int, ...] = DEFAULT_BUCKETS
    # bound on the plain version's [B, K, D] gather temp (K1 itself never
    # materializes it)
    gather_chunk_bytes: int = 2 << 30
    sharded_gather_budget_bytes: int = 8 << 30


def sharded_budget_kwarg(value: int | None) -> dict:
    """ALSParams kwargs fragment the templates use: include
    ``sharded_gather_budget_bytes`` only when engine params override it."""
    return {} if value is None else {"sharded_gather_budget_bytes": int(value)}


def init_factors(num: int, rank: int, generator: torch.Generator,
                 device: torch.device | str = "cpu",
                 scale: float | None = None) -> torch.Tensor:
    """``scale * N(0, 1)`` factors ``[num, rank]`` float32, scale
    ``1/sqrt(rank)`` by default, drawn from ``generator`` on its own
    device and moved to ``device``."""
    scale = scale if scale is not None else 1.0 / np.sqrt(rank)
    x = torch.randn((num, rank), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * scale).to(device)


def _warm_init(cold: torch.Tensor, warm) -> torch.Tensor:
    """Merge a warm-start factor table into the cold init: ``warm`` is a
    full-size float32 array with NaN rows marking "no prior factors --
    keep the cold draw"."""
    if warm is None:
        return cold
    warm = torch.as_tensor(np.asarray(warm, dtype=np.float32), device=cold.device)
    if warm.shape != cold.shape:
        raise ValueError(f"warm start shape {tuple(warm.shape)} != {tuple(cold.shape)}")
    return torch.where(torch.isnan(warm), cold, warm)


@dataclass
class DeviceBucket:
    """One bucket's arrays on the device, uploaded once per training."""

    row_ids: torch.Tensor  # [R] int32
    col_ids: torch.Tensor  # [B, K] int32
    ratings: torch.Tensor  # [B, K] float32
    mask: torch.Tensor  # [B, K] float32
    seg_start: torch.Tensor  # [R + 1] int32


def device_buckets(buckets: Sequence[PaddedBucket],
                   device: torch.device) -> list[DeviceBucket]:
    """Upload bucket arrays once, with each bucket's segment offsets."""
    out = []
    for b in buckets:
        seg_start = segment_offsets(b.seg_row, len(b.row_ids), b.col_ids.shape[0])
        out.append(DeviceBucket(*(
            host_tensor(a, device)
            for a in (b.row_ids, b.col_ids, b.ratings, b.mask, seg_start)
        )))
    return out


def host_tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``. A read-only array (a
    prep cache entry's mapped block) is copied, never written through or
    kept aliased: the copy to the card drops the host view at once, and
    on the CPU the tensor owns a copy, so evicting the entry cannot pull
    the mapping from under a training."""
    a = np.ascontiguousarray(a)
    if a.flags.writeable:
        return torch.from_numpy(a).to(device)
    if device.type == "cpu":
        return torch.from_numpy(a.copy())
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(a).to(device)


def _half_step(target, other, buckets: Sequence[DeviceBucket], params: ALSParams,
               regs: torch.Tensor | None = None, alphas: torch.Tensor | None = None) -> None:
    """Solve every bucket of one side from ``other`` and write the rows
    into ``target`` in place: K1 on each bucket, or K1s when ``regs``
    (and ``alphas``, ``[C]`` float32) are given and the tables are
    ``[C, N, D]`` candidate stacks. Implicit feedback first computes
    ``other``'s Gramian (batched over the candidates), once for the
    half-step."""
    gram = compute_gram(other, params.compute_dtype) if params.implicit else None
    weighted = params.implicit_weighted_reg if params.implicit else params.weighted_reg
    for b in buckets:
        if regs is None:
            solve_bucket(
                other, b.col_ids, b.ratings, b.mask, b.seg_start, params.reg,
                weighted_reg=weighted, compute_dtype=params.compute_dtype,
                target=target, row_ids=b.row_ids, return_x=False,
                gather_chunk_bytes=params.gather_chunk_bytes,
                implicit=params.implicit, alpha=params.alpha, gram=gram,
            )
        else:
            solve_bucket_sweep(
                other, b.col_ids, b.ratings, b.mask, b.seg_start, regs, target,
                b.row_ids, weighted_reg=weighted, compute_dtype=params.compute_dtype,
                gather_chunk_bytes=params.gather_chunk_bytes,
                implicit=params.implicit, alphas=alphas, gram=gram,
            )


# Diagnostics of the most recent als_train run in this process:
# {"iterations_run", "early_stopped", "final_rmse", "warm_start"}. A
# test/bench hook, not an API -- read it right after the call.
LAST_TRAIN_INFO: dict = {}


def _iterate(U, V, row_buckets, col_buckets, params: ALSParams, n: int) -> None:
    """``n`` ALS iterations in place: a half-step of U, then one of V."""
    for _ in range(n):
        _half_step(U, V, row_buckets, params)
        _half_step(V, U, col_buckets, params)


def als_train(
    data: RatingsData,
    params: ALSParams,
    checkpoint_cfg=None,
    warm_start=None,
    tol: float = 0.0,
    progress_extra: dict | None = None,
    device: str | torch.device | None = None,
):
    """Run ALS on ``device`` (CUDA unless the CPU is asked for); returns
    ``(user_factors, item_factors)`` in storage form.

    The cold init draws U then V from one CPU ``torch.Generator`` seeded
    with ``params.seed``, so the CPU and a card start from the same
    factors. ``warm_start`` is an optional ``(U0, V0)`` pair of full-size
    float32 arrays; NaN rows keep the cold draw. ``tol > 0`` stops when
    the per-segment train RMSE improves by less than ``tol``.
    ``params.implicit`` trains Hu-Koren-Volinsky implicit feedback on the
    same K1 launches.

    Checkpointing (``checkpoint_cfg``, else the ``PIO_CHECKPOINT_*`` /
    ``PIO_RESUME`` env vars; ``core/checkpoint.py``): the iterations run
    as segments of ``every``, and the storage-form (U, V) is saved
    atomically after each segment but the last. K1 runs one iteration at
    a time either way, so a segmented run makes the launches of a
    one-shot run in the same order: bit-identical. ``resume`` loads the
    latest fingerprint-matched snapshot onto ``device`` and continues
    from its iteration. Each segment publishes the train progress file
    (``obs/progress.py``), with its RMSE when ``tol > 0`` or the
    publisher is enabled."""
    device = resolve_device(device)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(params.seed))
    U0 = init_factors(data.num_rows, params.rank, gen, device)
    V0 = init_factors(data.num_cols, params.rank, gen, device)
    U0 = _warm_init(U0, warm_start[0] if warm_start is not None else None)
    V0 = _warm_init(V0, warm_start[1] if warm_start is not None else None)
    U = to_storage(U0, params.storage_dtype)
    V = to_storage(V0, params.storage_dtype)
    row_buckets = device_buckets(data.row_buckets, device)
    col_buckets = device_buckets(data.col_buckets, device)

    cfg = checkpoint_cfg if checkpoint_cfg is not None else ckpt.from_env()
    start_iter = 0
    fingerprint = None
    if cfg is not None and cfg.active:
        fingerprint = ckpt.data_fingerprint(data.rows, data.cols, data.vals,
                                            replace(params, iterations=0), mesh="single")
        if cfg.resume:
            snap = ckpt.load_checkpoint(cfg, fingerprint)
            if snap is not None and snap.iteration <= params.iterations:
                U = ckpt.table_to_device(snap.U, device)
                V = ckpt.table_to_device(snap.V, device)
                start_iter = snap.iteration

    nnz = len(data.vals)
    prog = obs_progress.ProgressPublisher(
        params.iterations, tol=tol, mesh="single", trainer="single",
        warm_start=warm_start is not None, **(progress_extra or {}),
    )
    t0 = time.perf_counter()
    k1_before = solve_bucket.launches.value
    final_rmse = None
    ckpt_every = cfg.every if (cfg is not None and cfg.every > 0) else 0
    prog.publish(start_iter)
    if tol <= 0.0 and ckpt_every <= 0:
        # where the JAX package dispatches its fused program once for the
        # whole training (even at 0 iterations)
        faults.fault_point("device.dispatch")
        _iterate(U, V, row_buckets, col_buckets, params, params.iterations - start_iter)
        it = params.iterations
    else:
        # segments of the checkpoint cadence, or of one iteration when
        # only the tol early stop asks for them; one dispatch each
        every = ckpt_every or 1
        it = start_iter
        epochs = 0
        prev_rmse = None
        while it < params.iterations:
            seg = min(every, params.iterations - it)
            faults.fault_point("device.dispatch")
            t_seg = time.perf_counter()
            _iterate(U, V, row_buckets, col_buckets, params, seg)
            it += seg
            if ckpt_every > 0 and it < params.iterations:
                ckpt.save_checkpoint(cfg, fingerprint, U, V, it, params.seed,
                                     mesh="single")
                epochs += 1
            seg_wall = time.perf_counter() - t_seg
            seg_rmse = (rmse(U, V, data.rows, data.cols, data.vals)
                        if (tol > 0.0 or prog.enabled) else None)
            if seg_rmse is not None:
                final_rmse = seg_rmse
            prog.publish(
                it, rmse=seg_rmse,
                events_per_s=nnz * seg / seg_wall if seg_wall > 0 else None,
                segment_wall_s=seg_wall, checkpoint_epoch=epochs,
            )
            if tol > 0.0 and final_rmse is not None:
                if prev_rmse is not None and abs(prev_rmse - final_rmse) < tol:
                    logger.info(
                        "ALS early stop at iteration %d/%d: RMSE plateau "
                        "|%.6f - %.6f| < tol=%g",
                        it, params.iterations, prev_rmse, final_rmse, tol,
                    )
                    break
                prev_rmse = final_rmse
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # K1's launches in this run, as its counter saw them (0 on the CPU)
    k1_launches = solve_bucket.launches.value - k1_before
    prog.done(it, early_stopped=it < params.iterations, k1_launches=k1_launches)
    LAST_TRAIN_INFO.clear()
    LAST_TRAIN_INFO.update(
        iterations_run=it - start_iter,
        early_stopped=it < params.iterations,
        final_rmse=final_rmse,
        warm_start=warm_start is not None,
    )
    total = time.perf_counter() - t0
    obs_metrics.histogram(
        "pio_als_train_seconds", "Whole-run ALS training time", path="single",
    ).observe(total)
    if it > start_iter:
        obs_metrics.histogram(
            "pio_als_halfstep_seconds",
            "Derived per-half-step time of the fused sharded ALS loop",
            mode="single",
        ).observe(total / (2 * (it - start_iter)))
    return U, V


# ALSParams fields a sweep's candidates must share (ops/als.py:1158): the
# rest -- reg, alpha, seed and rank -- may differ per candidate
_SWEEP_STATIC = (
    "iterations", "implicit", "weighted_reg",
    "implicit_weighted_reg", "compute_dtype", "storage_dtype",
    "bucket_widths", "gather_chunk_bytes",
)


def als_train_sweep(data: RatingsData, params_list: Sequence[ALSParams],
                    device: str | torch.device | None = None) -> list:
    """Train every candidate of ``params_list`` at once on ``device``
    (CUDA unless the CPU is asked for): K1s, each bucket's launches of a
    half-step serving all candidates. Returns per-candidate ``(U, V)`` in
    storage form at each candidate's own rank.

    The JAX package's rules, kept exactly: candidates must share the
    static fields (``_SWEEP_STATIC``) or a ValueError names the ones that
    differ; ``reg``, ``alpha``, ``seed`` and ``rank`` may vary. A rank-r
    candidate trains inside the largest rank with its columns >= r
    zero at init, and they stay exactly zero (the regularizer lifts the
    dead block to ``lam I``, so mixed ranks need ``reg > 0``). When
    padding every candidate to the largest rank would cost more than 1.5x
    the exact work (``len(ranks) * rank_max**2 > 1.5 * sum(r**2)``), the
    candidates split into one sweep per rank.

    Candidate c starts from the factors :func:`als_train` draws for its
    seed (U then V from one CPU ``torch.Generator``), zero-padded, so on
    the card candidate c is bit-identical to ``als_train`` of c alone
    at the same rank."""
    if not params_list:
        raise ValueError("params_list must not be empty")
    base = params_list[0]
    for p in params_list[1:]:
        diffs = [f for f in _SWEEP_STATIC if getattr(p, f) != getattr(base, f)]
        if diffs:
            raise ValueError(
                "als_train_sweep candidates must share the static program "
                f"shape; differing fields: {diffs} (sweep reg/alpha/seed/"
                "rank instead, or run separate trainings)"
            )
    if len({p.rank for p in params_list}) > 1 and any(p.reg <= 0 for p in params_list):
        # the padded columns' dead block is lifted to lam*I by the
        # regularizer; reg == 0 would leave it singular
        raise ValueError(
            "rank-sweep candidates need reg > 0 (the zero-padded factor "
            "block is kept solvable by the regularizer)"
        )
    device = resolve_device(device)
    out: list = [None] * len(params_list)
    for idx in sweep_groups(params_list):
        group = [params_list[i] for i in idx]
        U0, V0 = sweep_init(data, group, device)
        U, V = _train_sweep(data, group, U0, V0)
        for c, i in enumerate(idx):
            out[i] = (_candidate(U, c, group[c].rank), _candidate(V, c, group[c].rank))
    return out


def sweep_groups(params_list: Sequence[ALSParams]) -> list[list[int]]:
    """The candidates' indices, one list per stacked training: all of
    them, or one list per rank when padding every candidate to the
    largest rank would cost more than 1.5x the exact work
    (``len(ranks) * rank_max**2 > 1.5 * sum(r**2)``, the JAX package's
    cost model)."""
    ranks = [p.rank for p in params_list]
    exact = sum(r * r for r in ranks)
    if len(set(ranks)) > 1 and len(ranks) * max(ranks) ** 2 > 1.5 * exact:
        return [[i for i, r in enumerate(ranks) if r == rank] for rank in sorted(set(ranks))]
    return [list(range(len(ranks)))]


def sweep_init(data: RatingsData, params_list: Sequence[ALSParams],
               device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The stacked float32 initial factors ``([C, rows, D], [C, cols,
    D])`` of a sweep on ``device``, entry-major (:func:`entry_major`):
    candidate c's :func:`als_train` draw for its seed and rank,
    zero-padded to the largest rank D."""
    rank_max = max(p.rank for p in params_list)
    U0, V0 = [], []
    for p in params_list:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(p.seed))
        pad = (0, rank_max - p.rank)
        U0.append(torch.nn.functional.pad(init_factors(data.num_rows, p.rank, gen, device), pad))
        V0.append(torch.nn.functional.pad(init_factors(data.num_cols, p.rank, gen, device), pad))
    return torch.stack(U0, dim=1).transpose(0, 1), torch.stack(V0, dim=1).transpose(0, 1)


def _train_sweep(data: RatingsData, params_list: Sequence[ALSParams],
                 U0: torch.Tensor, V0: torch.Tensor):
    """The sweep's device loop (``_train_fused_sweep``'s counterpart)
    from stacked float32 initial factors ``[C, rows, D]`` / ``[C, cols,
    D]`` on the device it runs on: ``base.iterations`` iterations, each
    a :func:`_half_step` of U then of V through K1s. Returns the stacked
    ``(U, V)`` in storage form at the sweep's rank, entry-major
    (:func:`entry_major`)."""
    base = params_list[0]
    device = U0.device
    regs = torch.tensor([p.reg for p in params_list], dtype=torch.float32, device=device)
    alphas = torch.tensor([p.alpha for p in params_list], dtype=torch.float32,
                          device=device)
    # copies: the loop updates the tables in place, and the caller's
    # initial factors stay as they were
    U = entry_major(to_storage(U0.clone(), base.storage_dtype))
    V = entry_major(to_storage(V0.clone(), base.storage_dtype))
    row_buckets = device_buckets(data.row_buckets, device)
    col_buckets = device_buckets(data.col_buckets, device)
    for _ in range(base.iterations):
        _half_step(U, V, row_buckets, base, regs, alphas)
        _half_step(V, U, col_buckets, base, regs, alphas)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return U, V


def predict_pairs(U, V, rows, cols) -> torch.Tensor:
    """Scores for explicit (row, col) pairs: ``sum(U[r] * V[c], -1)`` in
    float32 (int8 tables dequantize at the gather)."""
    device = (U[0] if isinstance(U, tuple) else U).device
    r = host_tensor(rows, device).to(torch.int64)
    c = host_tensor(cols, device).to(torch.int64)
    u = _read_rows(U, r, torch.float32)
    v = _read_rows(V, c, torch.float32)
    return (u * v).sum(dim=-1)


def rmse(U, V, rows, cols, vals, chunk: int = 4_000_000) -> float:
    """Train RMSE over the COO ratings, chunked over the pairs."""
    device = (U[0] if isinstance(U, tuple) else U).device
    n = len(vals)
    total = 0.0
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        pred = predict_pairs(U, V, rows[lo:hi], cols[lo:hi])
        want = host_tensor(np.asarray(vals[lo:hi], np.float32), device)
        total += float(((pred - want) ** 2).sum())
    return float(np.sqrt(total / n))
