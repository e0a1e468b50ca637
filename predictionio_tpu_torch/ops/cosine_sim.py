"""Item-item cosine similarity from raw interactions, kept sparse: K6.

Port of ``predictionio_tpu/ops/cosine_sim.py`` (the similar-product
template's DIMSUM variant, reference
``examples/experimental/scala-parallel-similarproduct-dimsum``, whose
``RowMatrix.columnSimilarities(threshold)`` samples; this computes the
exact column cosines). :func:`item_similarity_topn` keeps the JAX
signature and defaults (``top_n=20, block=256, user_chunk=1024``, :111)
and its clamps; ``block`` and ``user_chunk`` change nothing but the plain
version's layout. ``_dedupe`` and the column norms (``np.add.at`` in f32,
then ``np.sqrt``) stay host numpy, as in the JAX package.

On a CUDA device it launches the hand-written kernel
``csrc/cosine_sim.cu`` (K6, replacing ``:73 _block_topn``): one block an
item row over CSR (by user) and CSC (by item) copies of the deduped
triples, the row's Gram entries in shared memory, the top n selected
there (:func:`cosine_layout` builds what it reads). On the CPU it runs
the plain PyTorch version, :func:`item_similarity_topn_reference`, which
states the JAX program as written: dense ``[chunk, I]`` tiles scattered
from the chunked triples, ``G += tile_b^T @ tile`` (f32: ``resolve_device``
keeps TF32 off on the card), the same
masks, then a stable sort on the order key. There is no fallback from one
to the other.

K6 takes one of two accumulation routes (:func:`k6_route`): ``atomic``
when every value is an integer and every squared column norm is below
2^24 (the template's view counts), where every partial sum is exact and
the scores are bit-equal to any exact summation; ``ordered`` otherwise,
summing each Gram entry in user order (deterministic; within 1e-5 of a
dense product, the JAX package's own bar). ``top_n`` above
:data:`K6_MAX_TOP_N` raises :class:`K6TopNError` on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from predictionio_tpu_torch.kernels import _build
from predictionio_tpu_torch.ops.topk import top_k_rows_reference
from predictionio_tpu_torch.utils.device import resolve_device

# csrc/cosine_sim.cu's constants, repeated (tests hold them equal):
K6_PASS_COLS = 57344  # PASS_COLS: columns one pass keeps in shared memory
K6_MAX_TOP_N = 128  # MAX_TOP_N: the largest top_n the kernel selects
#: squared column norms below this keep integer Gram sums exact in f32
_EXACT_LIMIT = float(1 << 24)


class K6TopNError(ValueError):
    """``top_n`` above :data:`K6_MAX_TOP_N` asked of the card."""


def _dedupe(rows, cols, vals, num_users, num_items):
    """Combine duplicate (user, item) entries by summation (matrix build
    semantics of np.add.at in the previous dense path)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    flat = rows * num_items + cols
    order = np.argsort(flat, kind="stable")
    flat, vals = flat[order], vals[order]
    boundaries = np.concatenate([[True], flat[1:] != flat[:-1]])
    starts = np.nonzero(boundaries)[0]
    summed = np.add.reduceat(vals, starts) if len(vals) else vals
    uflat = flat[starts] if len(vals) else flat
    return (
        (uflat // num_items).astype(np.int32),
        (uflat % num_items).astype(np.int32),
        summed.astype(np.float32),
    )


def _chunk_triples(rows, cols, vals, num_users, chunk: int):
    """Bucket user-sorted triples into [n_chunks, max_nnz] padded arrays.
    Padding scatters to a dummy tile row (local id == chunk)."""
    n_chunks = max(1, (num_users + chunk - 1) // chunk)
    chunk_of = rows // chunk
    counts = np.bincount(chunk_of, minlength=n_chunks)
    max_nnz = max(1, int(counts.max()) if len(counts) else 1)
    r = np.full((n_chunks, max_nnz), chunk, dtype=np.int32)  # dummy row
    c = np.zeros((n_chunks, max_nnz), dtype=np.int32)
    v = np.zeros((n_chunks, max_nnz), dtype=np.float32)
    # triples are already user-sorted from _dedupe
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for b in range(n_chunks):
        lo, hi = offsets[b], offsets[b + 1]
        n = hi - lo
        r[b, :n] = rows[lo:hi] - b * chunk
        c[b, :n] = cols[lo:hi]
        v[b, :n] = vals[lo:hi]
    return r, c, v


def column_norms(cols, vals, num_items: int) -> np.ndarray:
    """``[I]`` f32 column norms as the JAX package makes them:
    ``np.add.at`` of ``vals * vals`` in f32, then ``np.sqrt``."""
    norms = np.zeros(num_items, dtype=np.float32)
    np.add.at(norms, cols, vals * vals)
    return np.sqrt(norms)


def clamp_top_n(top_n: int, num_items: int) -> int:
    """``min(top_n, max(1, I - 1))``, the JAX package's clamp."""
    return int(min(top_n, max(1, num_items - 1)))


class CosineLayout(NamedTuple):
    """What K6 reads, built on the host from deduped, user-sorted
    triples: CSR by user (``user_ptr`` [U + 1] int64, ``user_items``,
    ``user_vals``), CSC by item (``item_ptr`` [I + 1] int64,
    ``item_users`` ascending within an item, ``item_vals``), the rows
    heaviest first (``row_order``: by ``work`` = the sum of each row's
    users' degrees, the multiply-adds the row costs), and the route."""

    user_ptr: np.ndarray
    user_items: np.ndarray
    user_vals: np.ndarray
    item_ptr: np.ndarray
    item_users: np.ndarray
    item_vals: np.ndarray
    row_order: np.ndarray
    work: np.ndarray
    route: str


def k6_route(cols, vals, num_items: int) -> str:
    """``"atomic"`` when every value is an integer and every squared
    column norm (summed in float64) is below 2^24, so every product and
    partial Gram sum is an exact f32 integer whatever the order; else
    ``"ordered"``."""
    vals = np.asarray(vals, dtype=np.float32)
    if len(vals) and not np.array_equal(vals, np.rint(vals)):
        return "ordered"
    sq = np.bincount(np.asarray(cols, np.int64), weights=np.asarray(vals, np.float64) ** 2,
                     minlength=num_items)
    return "atomic" if (sq.max() if len(sq) else 0.0) < _EXACT_LIMIT else "ordered"


def cosine_layout(rows, cols, vals, num_users: int, num_items: int) -> CosineLayout:
    """K6's host layout of deduped triples (:func:`_dedupe` output: sorted
    by user, then item)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    deg_u = np.bincount(rows, minlength=num_users).astype(np.int64)
    user_ptr = np.zeros(num_users + 1, np.int64)
    np.cumsum(deg_u, out=user_ptr[1:])
    order = np.argsort(cols, kind="stable")  # users stay ascending per item
    item_ptr = np.zeros(num_items + 1, np.int64)
    np.cumsum(np.bincount(cols, minlength=num_items), out=item_ptr[1:])
    work = np.bincount(cols, weights=deg_u[rows].astype(np.float64),
                       minlength=num_items).astype(np.int64)
    return CosineLayout(
        user_ptr=user_ptr,
        user_items=cols.astype(np.int32),
        user_vals=vals,
        item_ptr=item_ptr,
        item_users=rows[order].astype(np.int32),
        item_vals=vals[order],
        row_order=np.argsort(-work, kind="stable").astype(np.int32),
        work=work,
        route=k6_route(cols, vals, num_items),
    )


def _empty(num_items: int, top_n: int):
    return np.zeros((num_items, top_n), np.float32), np.zeros((num_items, top_n), np.int32)


def item_similarity_topn(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    num_users: int,
    num_items: int,
    top_n: int = 20,
    block: int = 256,
    user_chunk: int = 1024,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-N cosine neighbors per item from (user, item, value)
    interaction triples. Returns (scores [I, N], ids [I, N]) as numpy;
    entries with score == -inf are padding (items with < N valid
    neighbors). ``device``: CUDA unless the CPU is asked for; CUDA
    launches K6, the CPU runs :func:`item_similarity_topn_reference`."""
    device = resolve_device(device)
    if num_items == 0:
        return _empty(0, top_n)
    rows, cols, vals = _dedupe(rows, cols, vals, num_users, num_items)
    norms = column_norms(cols, vals, num_items)
    top_n = clamp_top_n(top_n, num_items)
    if device.type == "cpu":
        return _plain_topn(rows, cols, vals, norms, num_users, num_items, top_n,
                           block, user_chunk, device)
    if top_n < 1:
        return _empty(num_items, 0)
    layout = cosine_layout(rows, cols, vals, num_users, num_items)
    scores, ids = cosine_topn_kernel(upload_layout(layout, norms, device), num_items, top_n,
                                     layout.route)
    return scores.cpu().numpy(), ids.cpu().numpy()


item_similarity_topn.launches = _build.LaunchCount()


# -- the plain version ---------------------------------------------------------


def plain_block_topn(chunk_r: torch.Tensor, chunk_c: torch.Tensor, chunk_v: torch.Tensor,
                     norms: torch.Tensor, start: int, num_items: int, chunk: int,
                     block: int, top_n: int):
    """``_block_topn`` in plain PyTorch, on the tensors' device: (scores
    ``[block, top_n]``, ids) of item rows ``start .. start + block``."""
    device = norms.device
    G = torch.zeros((block, num_items), dtype=torch.float32, device=device)
    flat = torch.empty((chunk + 1) * num_items, dtype=torch.float32, device=device)
    for b in range(chunk_r.shape[0]):
        flat.zero_()
        flat.index_add_(0, chunk_r[b].long() * num_items + chunk_c[b].long(), chunk_v[b])
        tile = flat.view(chunk + 1, num_items)[:chunk]  # dummy row dropped
        G += tile[:, start:start + block].T @ tile
    row_ids = start + torch.arange(block, device=device)
    row_norms = norms[torch.clamp(row_ids, max=num_items - 1)]
    sim = G / torch.clamp(row_norms[:, None] * norms[None, :], min=1e-12)
    col_ids = torch.arange(num_items, device=device)
    neg = torch.tensor(float("-inf"), device=device)
    sim = torch.where(col_ids[None, :] == row_ids[:, None], neg, sim)
    sim = torch.where(norms[None, :] > 0, sim, neg)
    sim = torch.where(row_norms[:, None] > 0, sim, neg)
    return top_k_rows_reference(sim, top_n)


def plain_inputs(rows, cols, vals, num_users: int, num_items: int, block: int,
                 user_chunk: int, device):
    """(chunk_r, chunk_c, chunk_v, chunk, block) tensors on ``device`` for
    :func:`plain_block_topn`, with the JAX package's clamps."""
    chunk = int(min(user_chunk, max(8, num_users)))
    block = int(max(1, min(block, num_items)))
    r, c, v = _chunk_triples(rows, cols, vals, num_users, chunk)
    return (torch.from_numpy(r).to(device), torch.from_numpy(c).to(device),
            torch.from_numpy(v).to(device), chunk, block)


def _plain_topn(rows, cols, vals, norms, num_users, num_items, top_n, block,
                user_chunk, device):
    if top_n < 1:
        return _empty(num_items, 0)
    chunk_r, chunk_c, chunk_v, chunk, block = plain_inputs(
        rows, cols, vals, num_users, num_items, block, user_chunk, device)
    norms_d = torch.from_numpy(norms).to(device)
    out_s, out_i = [], []
    for start in range(0, num_items, block):
        # clamp so the final block stays in range (its overlap rows are
        # recomputed and trimmed below)
        first = min(start, max(0, num_items - block))
        s, i = plain_block_topn(chunk_r, chunk_c, chunk_v, norms_d, first, num_items,
                                chunk, block, top_n)
        out_s.append(s.cpu().numpy()[start - first:])
        out_i.append(i.cpu().numpy()[start - first:])
    return np.concatenate(out_s)[:num_items], np.concatenate(out_i)[:num_items]


def item_similarity_topn_reference(rows, cols, vals, num_users: int, num_items: int,
                                   top_n: int = 20, block: int = 256,
                                   user_chunk: int = 1024, device="cpu"):
    """The plain PyTorch version of :func:`item_similarity_topn` on
    ``device``: the JAX program as written, block by block."""
    if num_items == 0:
        return _empty(0, top_n)
    rows, cols, vals = _dedupe(rows, cols, vals, num_users, num_items)
    norms = column_norms(cols, vals, num_items)
    return _plain_topn(rows, cols, vals, norms, num_users, num_items,
                       clamp_top_n(top_n, num_items), block, user_chunk,
                       torch.device(device))


# -- the CUDA kernel -------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("cosine_sim")
    if not getattr(lib, "_pio_typed", False):
        lib.pio_k6_cosine_topn.argtypes = [
            _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
            ctypes.POINTER(ctypes.c_int), _P,
        ]
        lib.pio_k6_cosine_topn.restype = _I
        lib.pio_k6_pass_cols.restype = _I
        lib.pio_k6_max_top_n.restype = _I
        lib._pio_typed = True
    return lib


def upload_layout(layout: CosineLayout, norms: np.ndarray, device) -> dict:
    """The layout's arrays and the norms as tensors on ``device``."""
    return {name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for name, a in (("row_order", layout.row_order), ("item_ptr", layout.item_ptr),
                            ("item_users", layout.item_users),
                            ("item_vals", layout.item_vals), ("user_ptr", layout.user_ptr),
                            ("user_items", layout.user_items),
                            ("user_vals", layout.user_vals), ("norms", norms))}


def cosine_topn_kernel(dev: dict, num_items: int, top_n: int, route: str,
                       pass_cols: int = K6_PASS_COLS, rows: int | None = None):
    """One K6 launch over the rows of the uploaded layout ``dev``
    (:func:`upload_layout`): ``([I, top_n] f32 scores, [I, top_n] int32
    ids)`` on the device. ``pass_cols`` below :data:`K6_PASS_COLS` forces
    column passes (for tests of that path at a small catalog); ``rows``
    launches only the first rows of the heaviest-first order (the others
    are left unwritten: for timing the slowest blocks alone). Counts one
    launch on :func:`item_similarity_topn`."""
    device = dev["norms"].device
    if not 1 <= top_n <= min(K6_MAX_TOP_N, num_items):
        raise K6TopNError(
            f"K6 selects 1 <= top_n <= {K6_MAX_TOP_N} (and <= I = {num_items}); "
            f"got top_n={top_n}"
        )
    if route not in ("atomic", "ordered"):
        raise ValueError(f"unknown K6 route {route!r}")
    pass_cols = int(min(pass_cols, num_items))
    rows = num_items if rows is None else int(rows)
    if not 1 <= rows <= num_items:
        raise ValueError(f"K6 launches 1 <= rows <= {num_items}, got {rows}")
    scores = torch.empty((num_items, top_n), dtype=torch.float32, device=device)
    ids = torch.empty((num_items, top_n), dtype=torch.int32, device=device)
    launched = ctypes.c_int(0)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pio_k6_cosine_topn(
            dev["row_order"].data_ptr(), rows, dev["item_ptr"].data_ptr(),
            dev["item_users"].data_ptr(), dev["item_vals"].data_ptr(),
            dev["user_ptr"].data_ptr(), dev["user_items"].data_ptr(),
            dev["user_vals"].data_ptr(), dev["norms"].data_ptr(), num_items, top_n,
            pass_cols, 1 if route == "atomic" else 0, scores.data_ptr(), ids.data_ptr(),
            ctypes.byref(launched), stream,
        )
    _build.check(err, f"K6 {route} launch")
    item_similarity_topn.launches.add(launched.value)
    return scores, ids
