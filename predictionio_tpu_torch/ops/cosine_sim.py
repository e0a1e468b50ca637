"""Item-item cosine similarity from raw interactions, kept sparse: K6.

Port of ``predictionio_tpu/ops/cosine_sim.py`` (the similar-product
template's DIMSUM variant, reference
``examples/experimental/scala-parallel-similarproduct-dimsum``, whose
``RowMatrix.columnSimilarities(threshold)`` samples; this computes the
exact column cosines). :func:`item_similarity_topn` keeps the JAX
signature and defaults (``top_n=20, block=256, user_chunk=1024``, :111)
and its clamps: any ``top_n``, clamped to ``I - 1``; ``block`` and
``user_chunk`` change nothing but the plain version's layout.
``_dedupe`` and the column norms (``np.add.at`` in f32, then
``np.sqrt``) stay host numpy, as in the JAX package.

On a CUDA device it launches the hand-written kernels of
``csrc/cosine_sim.cu`` (K6, replacing ``:73 _block_topn``) over CSR (by
user) and CSC (by item) copies of the deduped triples, which
:func:`cosine_layout` builds. On the CPU it runs the plain PyTorch
version, :func:`item_similarity_topn_reference`, which states the JAX
program as written: dense ``[chunk, I]`` tiles scattered from the
chunked triples, ``G += tile_b^T @ tile`` (f32: ``resolve_device`` keeps
TF32 off on the card), the same masks, then a stable sort on the order
key. There is no fallback from one to the other.

K6's accumulation route (:func:`k6_route`) is chosen by the data:
``atomic`` when every value is an integer and every squared column norm
is below 2^24 (the template's view counts), where every partial sum is
exact and the scores are bit-equal to any exact summation; ``ordered``
otherwise, summing each Gram entry in user order (deterministic; within
1e-5 of a dense product, the JAX package's own bar).

On the atomic route with every value in [-128, 127], the layout splits
off the *heavy* users, ``deg(u) >= T`` (:func:`k6_threshold`, a cost
model of this card), when the model finds the split worth its scratch
traffic. Their part of the Gram runs first as a dense s8 product on the
tensor cores (the dense stage, ``gram_s8_kernel``: an item-major
``[I_pad, H_pad]`` s8 operand scattered on the device, int32 sums,
exact), written into an f32 scratch of row chunks of at most 1 GiB
(:func:`k6_chunk_rows`); the sparse stage (``cosine_topn_kernel``) then
starts each row from its chunk row and adds the light users only. With
no heavy user (``H = 0``: the ordered route, larger values, a small
catalog or a flat degree profile) no dense launch happens.

``top_n`` up to :data:`K6_SELECT_MAX_N` is selected inside the sparse
stage (one launch when there is no dense stage). Larger ``top_n`` takes
the scores route: the sparse stage writes each row's masked scores into
the scratch chunk and K2's ``select_kernel`` (``ops/topk.py
select_rows``) picks them in ``lax.top_k`` order. Launch counts:
``item_similarity_topn.launches`` counts every launch, and
``item_similarity_topn.stages`` each stage's (``dense``, ``sparse``,
``select``).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from predictionio_tpu_torch.kernels import _build
from predictionio_tpu_torch.ops.topk import select_rows, top_k_rows_reference
from predictionio_tpu_torch.utils.device import resolve_device

# csrc/cosine_sim.cu's constants, repeated (tests hold them equal):
K6_PASS_COLS = 57344  # PASS_COLS: columns one pass keeps in shared memory
K6_SELECT_MAX_N = 128  # SELECT_MAX_N: top_n above it takes the scores route
K6_DENSE_TILE = 128  # DM == DN: the dense stage's output tile; I_pad is a multiple
K6_DENSE_K = 64  # DK: heavy users a pipeline stage; H_pad is a multiple
#: bytes of the f32 scratch chunk ``[R, I]`` (dense Gram rows, scores)
K6_SCRATCH_BYTES = 1 << 30
#: squared column norms below this keep integer Gram sums exact in f32
_EXACT_LIMIT = float(1 << 24)
#: the largest I whose item ids pack into 16 bits (65,535 marks no entry)
_PACK_MAX_I = 65535

# The heavy split's cost model: rates of this card's two stages, measured by
# chip_smoke.py's k6 phase on the ML-20M views (run of 2026-10-17, NVIDIA
# H100 80GB HBM3, 700 W power limit).
#: the dense stage: 2.381e12 s8 operations (2 I I_pad H_pad) in 5.228 ms
K6_MMA_OPS_PER_S = 4.55e14
#: the sparse stage's marginal rate: the 1.002e10 multiply-adds of the heavy
#: users (T = 1,036) cost it 20.159 - 9.556 ms (H = 0 against the split)
K6_SPARSE_ADDS_PER_S = 9.46e11
#: one dense launch at the ML-100K views' shape (I = 1,719, H = 350), whose
#: operations take 0.005 ms at the rate above, took 0.024 ms
K6_DENSE_LAUNCH_S = 1.9e-5
#: the scratch chunk read back by the sparse stage: the HBM3 data-sheet rate
K6_SCRATCH_BYTES_PER_S = 3.35e12


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


def k6_chunk_rows(num_items: int) -> int:
    """R: item rows of one scratch chunk, ``floor(2^30 / (4 I))`` (at most
    1 GiB of f32), at least 1 and at most I."""
    return int(max(1, min(num_items, K6_SCRATCH_BYTES // (4 * max(1, num_items)))))


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def k6_threshold(num_items: int) -> int:
    """T(I): the degree from which a user costs the sparse stage (``deg^2``
    multiply-adds at :data:`K6_SPARSE_ADDS_PER_S`) more than its column of
    the dense stage (``2 I^2`` s8 operations at :data:`K6_MMA_OPS_PER_S`):
    ``ceil(I sqrt(2 sparse / mma))``."""
    return max(1, math.ceil(num_items * math.sqrt(2.0 * K6_SPARSE_ADDS_PER_S
                                                  / K6_MMA_OPS_PER_S)))


def _split_pays(heavy_deg: np.ndarray, num_items: int) -> bool:
    """The heavy users' sparse time against the dense stage's: its s8
    operations over the padded operand (its writes are in the measured
    rate), the chunks read back (``4 I^2`` bytes), and a launch a chunk."""
    if not len(heavy_deg):
        return False
    saved = float((heavy_deg.astype(np.float64) ** 2).sum()) / K6_SPARSE_ADDS_PER_S
    i_pad = _pad(num_items, K6_DENSE_TILE)
    cost = (2.0 * num_items * i_pad * _pad(len(heavy_deg), K6_DENSE_K) / K6_MMA_OPS_PER_S
            + 4.0 * num_items * num_items / K6_SCRATCH_BYTES_PER_S
            + K6_DENSE_LAUNCH_S * -(-num_items // k6_chunk_rows(num_items)))
    return saved > cost


def _s8_values(vals: np.ndarray) -> bool:
    return not len(vals) or bool(vals.min() >= -128 and vals.max() <= 127)


class CosineLayout(NamedTuple):
    """What K6 reads, built on the host from deduped, user-sorted
    triples: CSR by user (``user_ptr`` [U + 1] int64, ``user_items``,
    ``user_vals``; ``user_packed``, each entry as one int32 ``item << 16 |
    (value & 0xFFFF)``, on the atomic route where I <= 65,535, else None:
    the route's values are integers below 4,096 in magnitude), CSC by item (``item_ptr`` [I + 1] int64,
    ``item_users`` ascending within an item, ``item_vals``), the rows
    heaviest first (``row_order``: by ``work`` = the sum of each row's
    users' degrees, the multiply-adds the row costs), and the route.

    The heavy split: ``threshold`` (T, or None where no split is allowed:
    the ordered route, or a value outside [-128, 127]), ``heavy`` (the
    users of degree >= T with an entry, ascending; empty when the cost
    model finds the split not worth it), their entries as the dense
    operand's triples (``heavy_items``, ``heavy_cols`` = index in
    ``heavy``, ``heavy_vals`` int8), and the light CSC (``light_ptr``,
    ``light_users``, ``light_vals``: each item's other users) with its
    ``light_work`` and ``light_order``. With no heavy user the light
    fields are the full CSC's arrays."""

    user_ptr: np.ndarray
    user_items: np.ndarray
    user_vals: np.ndarray
    user_packed: np.ndarray | None
    item_ptr: np.ndarray
    item_users: np.ndarray
    item_vals: np.ndarray
    row_order: np.ndarray
    work: np.ndarray
    route: str
    threshold: int | None
    heavy: np.ndarray
    heavy_items: np.ndarray
    heavy_cols: np.ndarray
    heavy_vals: np.ndarray
    light_ptr: np.ndarray
    light_users: np.ndarray
    light_vals: np.ndarray
    light_work: np.ndarray
    light_order: np.ndarray


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


def _csc(item_of, users, deg_u, num_items: int):
    """(ptr, work, order) of CSC entries (``item_of`` ascending, ``users``
    ascending within an item): work = each item's users' degrees summed,
    order = heaviest first."""
    ptr = np.zeros(num_items + 1, np.int64)
    np.cumsum(np.bincount(item_of, minlength=num_items), out=ptr[1:])
    work = np.bincount(item_of, weights=deg_u[users].astype(np.float64),
                       minlength=num_items).astype(np.int64)
    return ptr, work, np.argsort(-work, kind="stable").astype(np.int32)


def cosine_layout(rows, cols, vals, num_users: int, num_items: int,
                  threshold: int | None = None) -> CosineLayout:
    """K6's host layout of deduped triples (:func:`_dedupe` output: sorted
    by user, then item). ``threshold``: None lets the cost model choose T
    and whether the split pays (:func:`k6_threshold`, ``_split_pays``); a
    number forces that T (0: every user with an entry is heavy), where a
    split is allowed at all."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    deg_u = np.bincount(rows, minlength=num_users).astype(np.int64)
    user_ptr = np.zeros(num_users + 1, np.int64)
    np.cumsum(deg_u, out=user_ptr[1:])
    # users stay ascending per item; 16-bit keys take numpy's radix sort
    keys = cols.astype(np.uint16) if num_items <= 1 << 16 else cols
    order = np.argsort(keys, kind="stable")
    item_of, item_users, item_vals = cols[order], rows[order].astype(np.int32), vals[order]
    item_ptr, work, row_order = _csc(item_of, item_users, deg_u, num_items)
    route = k6_route(cols, vals, num_items)
    T = None
    heavy = np.zeros(0, np.int64)
    if route == "atomic" and _s8_values(vals):
        T = k6_threshold(num_items) if threshold is None else int(threshold)
        heavy = np.nonzero((deg_u >= T) & (deg_u > 0))[0]
        if threshold is None and not _split_pays(deg_u[heavy], num_items):
            heavy = heavy[:0]
    col_of = np.full(num_users, -1, np.int64)
    col_of[heavy] = np.arange(len(heavy))
    entry_col = col_of[rows]
    is_heavy = entry_col >= 0
    light_users, light_vals = item_users, item_vals
    light_ptr, light_work, light_order = item_ptr, work, row_order
    if len(heavy):  # the full CSC without the heavy users' entries: still sorted
        keep = col_of[item_users] < 0
        light_users, light_vals = item_users[keep], item_vals[keep]
        light_ptr, light_work, light_order = _csc(item_of[keep], light_users, deg_u,
                                                  num_items)
    packed = None
    if route == "atomic" and num_items <= _PACK_MAX_I:  # |value| < 4,096 on this route
        packed = ((cols << 16) | (vals.astype(np.int64) & 0xFFFF)).astype(np.uint32).view(
            np.int32)
    return CosineLayout(
        user_ptr=user_ptr,
        user_items=cols.astype(np.int32),
        user_vals=vals,
        user_packed=packed,
        item_ptr=item_ptr,
        item_users=item_users,
        item_vals=item_vals,
        row_order=row_order,
        work=work,
        route=route,
        threshold=T,
        heavy=heavy.astype(np.int32),
        heavy_items=cols[is_heavy].astype(np.int32),
        heavy_cols=entry_col[is_heavy].astype(np.int32),
        heavy_vals=vals[is_heavy].astype(np.int8),
        light_ptr=light_ptr,
        light_users=light_users,
        light_vals=light_vals,
        light_work=light_work,
        light_order=light_order,
    )


def heavy_operand(layout: CosineLayout, num_items: int, device) -> torch.Tensor:
    """The dense stage's operand: ``[I_pad, H_pad]`` int8, item-major,
    ``A[j, h]`` the value of heavy user ``heavy[h]`` for item j, zeros
    elsewhere (I_pad a multiple of :data:`K6_DENSE_TILE`, H_pad of
    :data:`K6_DENSE_K`): the heavy entries scattered into a zeroed tensor
    on ``device``."""
    i_pad = _pad(num_items, K6_DENSE_TILE)
    h_pad = _pad(len(layout.heavy), K6_DENSE_K)
    a = torch.zeros(i_pad * h_pad, dtype=torch.int8, device=device)
    flat = (torch.from_numpy(layout.heavy_items).to(device).long() * h_pad
            + torch.from_numpy(layout.heavy_cols).to(device).long())
    a[flat] = torch.from_numpy(layout.heavy_vals).to(device)
    return a.view(i_pad, h_pad)


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
    launches K6 (the dense stage when the layout has heavy users, the
    sparse stage, and K2's selection above :data:`K6_SELECT_MAX_N`), the
    CPU runs :func:`item_similarity_topn_reference`."""
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
item_similarity_topn.stages = {name: _build.LaunchCount()
                               for name in ("dense", "sparse", "select")}


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


def gram_s8_reference(a: torch.Tensor, rows: torch.Tensor, num_items: int) -> torch.Tensor:
    """The dense stage in plain PyTorch: ``[n, I]`` f32 ``A[rows] · A[:I]ᵀ``
    of the int8 operand, in f32 (exact: every partial sum is an integer
    below 2^24 on the atomic route)."""
    return a[rows.long()].float() @ a[:num_items].float().T


# -- the CUDA kernels ------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)


def _lib() -> ctypes.CDLL:
    lib = _build.load("cosine_sim")
    if not getattr(lib, "_pio_typed", False):
        lib.pio_k6_cosine_topn.argtypes = [
            _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P, _IP, _P,
        ]
        lib.pio_k6_cosine_topn.restype = _I
        lib.pio_k6_gram_s8.argtypes = [_P, _I, _I, _P, _I, _I, _P, _IP, _P]
        lib.pio_k6_gram_s8.restype = _I
        lib.pio_k6_pass_cols.restype = _I
        lib.pio_k6_select_max_n.restype = _I
        lib._pio_typed = True
    return lib


def upload_layout(layout: CosineLayout, norms: np.ndarray, device) -> dict:
    """The layout's arrays and the norms as tensors on ``device``, the
    row orders, the dense operand (:func:`heavy_operand`) when the layout
    has heavy users, and ``heavy`` = H. With H = 0 the light entries are
    the full CSC's tensors."""
    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    dev = {name: up(getattr(layout, name))
           for name in ("item_ptr", "item_users", "item_vals", "user_ptr", "user_items",
                        "user_vals", "row_order")}
    dev["norms"] = up(norms)
    dev["user_packed"] = None if layout.user_packed is None else up(layout.user_packed)
    dev["heavy"] = len(layout.heavy)
    if dev["heavy"]:
        for name in ("light_ptr", "light_users", "light_vals", "light_order"):
            dev[name] = up(getattr(layout, name))
        dev["heavy_a"] = heavy_operand(layout, len(norms), device)
    else:
        dev.update(light_ptr=dev["item_ptr"], light_users=dev["item_users"],
                   light_vals=dev["item_vals"], light_order=dev["row_order"])
    return dev


def gram_s8(a: torch.Tensor, rows: torch.Tensor, num_items: int, out: torch.Tensor) -> int:
    """The dense stage, one launch: ``out[b, j] = sum_h a[rows[b], h] *
    a[j, h]`` as f32 for ``b < len(rows)``, ``j < I`` (``a`` the CUDA
    ``[I_pad, H_pad]`` int8 operand of :func:`heavy_operand`, ``rows``
    int32 item ids, ``out`` a contiguous f32 ``[>= len(rows), I]``).
    Returns the kernels launched, for the caller to count
    (:func:`gram_s8_reference` is its plain version)."""
    launched = ctypes.c_int(0)
    with torch.cuda.device(a.device):
        err = _lib().pio_k6_gram_s8(a.data_ptr(), a.shape[0], a.shape[1], rows.data_ptr(),
                                    rows.shape[0], num_items, out.data_ptr(),
                                    ctypes.byref(launched),
                                    torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "K6 dense stage launch")
    return launched.value


def _count(stage: str, n: int) -> None:
    item_similarity_topn.stages[stage].add(n)
    item_similarity_topn.launches.add(n)


def cosine_topn_kernel(dev: dict, num_items: int, top_n: int, route: str,
                       pass_cols: int = K6_PASS_COLS, rows: int | None = None,
                       dense: bool = True):
    """K6 over the rows of the uploaded layout ``dev`` (:func:`upload_layout`):
    ``([I, top_n] f32 scores, [I, top_n] int32 ids)`` on the device, any
    ``1 <= top_n <= I``.

    Stages: with heavy users on the atomic route (and ``dense``), each
    scratch chunk of :func:`k6_chunk_rows` rows (the heaviest-first order
    by light work, cut in chunks) takes the dense stage, then the sparse
    stage over the light users; otherwise the sparse stage over every
    user, in one launch when ``top_n <= K6_SELECT_MAX_N``. Above that the
    sparse stage writes scores into the chunk and K2's select_kernel
    picks them. ``dense=False`` skips the dense stage (``H = 0``, the
    same-run baseline). ``pass_cols`` below :data:`K6_PASS_COLS` forces
    column passes (for tests of that path at a small catalog); ``rows``
    launches only the first rows of the order (the others are left
    unwritten: for timing the slowest blocks alone). Counts each launch
    on :func:`item_similarity_topn` (``launches`` and ``stages``)."""
    device = dev["norms"].device
    if not 1 <= top_n <= num_items:
        raise ValueError(f"K6 selects 1 <= top_n <= I = {num_items}; got top_n={top_n}")
    if route not in ("atomic", "ordered"):
        raise ValueError(f"unknown K6 route {route!r}")
    pass_cols = int(min(pass_cols, num_items))
    n_rows = num_items if rows is None else int(rows)
    if not 1 <= n_rows <= num_items:
        raise ValueError(f"K6 launches 1 <= rows <= {num_items}, got {n_rows}")
    use_dense = dense and route == "atomic" and dev["heavy"] > 0
    pre = "light_" if use_dense else "item_"
    order = dev["light_order"] if use_dense else dev["row_order"]
    scores_route = top_n > K6_SELECT_MAX_N
    chunk = k6_chunk_rows(num_items) if (use_dense or scores_route) else n_rows
    out_s = torch.empty((num_items, top_n), dtype=torch.float32, device=device)
    out_i = torch.empty((num_items, top_n), dtype=torch.int32, device=device)
    scratch = None
    if use_dense or scores_route:
        scratch = torch.empty((min(chunk, n_rows), num_items), dtype=torch.float32,
                              device=device)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for r0 in range(0, n_rows, chunk):
            n = min(chunk, n_rows - r0)
            part = order[r0:r0 + n]
            if use_dense:
                _count("dense", gram_s8(dev["heavy_a"], part, num_items, scratch))
            launched = ctypes.c_int(0)
            err = lib.pio_k6_cosine_topn(
                part.data_ptr(), n, dev[pre + "ptr"].data_ptr(), dev[pre + "users"].data_ptr(),
                dev[pre + "vals"].data_ptr(), dev["user_ptr"].data_ptr(),
                dev["user_items"].data_ptr(), dev["user_vals"].data_ptr(),
                None if dev["user_packed"] is None else dev["user_packed"].data_ptr(),
                dev["norms"].data_ptr(), num_items, top_n, pass_cols,
                1 if route == "atomic" else 0,
                None if scratch is None else scratch.data_ptr(), 1 if use_dense else 0,
                None if scores_route else out_s.data_ptr(),
                None if scores_route else out_i.data_ptr(), ctypes.byref(launched), stream,
            )
            _build.check(err, f"K6 {route} sparse stage launch")
            _count("sparse", launched.value)
            if scores_route:
                s, i, launched = select_rows(scratch[:n], top_n)
                _count("select", launched)
                out_s[part.long()] = s
                out_i[part.long()] = i
    return out_s, out_i
