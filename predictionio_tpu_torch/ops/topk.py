"""Scoring + top-k for serving: K2, the fused gather -> score -> top-k.

Port of ``predictionio_tpu/ops/topk.py:90 gather_top_k_batch``: gather B
user rows by index from the device-resident user table, dequantize,
score them against the whole item catalog, mask excluded items, and
take the top k; and of ``:135 sum_rows_top_k_batch``, K2's summed-rows
mode, whose query row is the weighted sum of several catalog rows (the
cosine templates: similar products); and of ``:69 top_k_items_batch``,
dense query rows scored through the same wrapper; and of ``:34
top_k_items`` (one dense query: that wrapper at B = 1, row 0) and ``:247
top_k_similar``, K2's cosine mode: one query's scores divided by
``max(norms * ||v||, 1e-12)`` before ordering, an int8 catalog read
without its scales. On
a CUDA tensor each wrapper launches the hand-written kernel
``csrc/topk.cu``; on a CPU tensor it runs the plain PyTorch version
beside it (``*_reference``). There is no fallback from one to the other.
``catalog_norms`` (``:231``) and the cosine query's norm are plain.

K3, :func:`ranking_metrics_batch` (``:179``), scores a whole eval split's
top-k id matrix: per query P@K, AP@K and NDCG@K, by sorted membership in
the query's actual ids (kernel ``csrc/ranking.cu``, plain version
:func:`ranking_metrics_batch_reference`).

A call of more rows than one launch takes -- 65,535 x 8 query rows
(``K2_TILE_B`` rows a block, gridDim.y blocks) -- or than
:data:`K2_SCRATCH_BYTES` of per-call scratch, is served in row chunks
(:func:`k2_chunks`); each row is scored alone, so the answer does not
change. Serving batches are one chunk.

On the card each call takes one of two hand-written routes, picked by
:func:`k2_route` from k and the catalog size: the tile route (k <=
:data:`K2_TILE_MAX_K`, every serving call) keeps each tile's top k on
chip and merges the tiles' lists in a second launch, so the ``[B, I]``
scores never reach device memory; the select route (larger k, and
:func:`top_k_rows`) writes the scores to a ``[B, I]`` scratch and radix
selects each row. Both compute every score the same way.
``launches`` on each wrapper counts calls, ``routes[name]`` the calls
each route served, and ``kernel_launches`` the kernels those calls
launched, as the C entry counts them at each launch; :func:`k2_launches`
is what one call should add there. ``/metrics`` reads the same counts at
scrape time (``pio_k2_calls{kernel,route}``, ``pio_k2_kernel_launches
{kernel}``), so a server process's K2 work is visible from outside it.

Order contract (``jax.lax.top_k``'s): descending by the order-preserving
int key of the f32 score -- ``bits < 0 ? bits ^ 0x7FFFFFFF : bits``, so
NaN ranks above +inf and +0.0 above -0.0 -- and the lower index first on
equal keys. ``torch.topk`` does not keep that order on ties, and a float
sort does not separate signed zeros; both versions here rank by the key.

Batch invariance: a row's scores and ids do not depend on the batch size
-- both versions sum each (b, i) on its own, in the fixed order
d = 0..D-1 -- so a query answered alone is byte-identical to the same
query inside a batch. The two versions also agree with each other bit
for bit: the kernel rounds each product and partial sum as the plain
version's elementwise ops do (no FMA). A summed-rows query adds its rows
in the fixed order l = 0..L-1 the same way, multiplying weight-0 padding
in (exact +0.0), so it is also invariant to the padded width L.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from predictionio_tpu_torch.kernels import _build
from predictionio_tpu_torch.obs import metrics as obs_metrics

NEG_INF = -1e30

# csrc/topk.cu's constants, repeated (tests hold them equal):
K2_TILE_MAX_K = 128  # TILE_MAX_K: k up to this takes the tile route
K2_CHUNK = 128  # TILE_I: items a tile block scores at a time, one a thread
K2_MERGE_CAP = 16384  # MERGE_CAP: composites one row's merge takes, at most
K2_TILE_B = 8  # TILE_B: query rows a score or tile block serves
K2_MAX_GRID_Y = 65535  # CUDA's gridDim.y cap: row blocks one launch takes
#: device scratch one K2 chunk may take: the tile route's [B, T, g] int64
#: composites, or the select route's [B, I] f32 scores and [B, k] int64
#: candidates
K2_SCRATCH_BYTES = 1 << 30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SIGN_FLIP = 0x7FFFFFFF


def catalog_rows(item_factors) -> int:
    """Row count of a factor table in either representation: a dense
    [I, D] tensor, or the int8 (values [I, D], per-row f32 scales [I])
    pair (ops/als.py quantize_rows)."""
    table = item_factors[0] if isinstance(item_factors, tuple) else item_factors
    return table.shape[0]


def order_key(scores: torch.Tensor) -> torch.Tensor:
    """int32 key whose integer order is the f32 total order of
    ``scores`` (NaN above +inf, +0.0 above -0.0)."""
    bits = scores.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ _SIGN_FLIP, bits)


class K2Route(NamedTuple):
    """How K2 serves a call on the card (:func:`k2_route`)."""

    name: str  # "tile" or "select"
    width: int  # tile route: items a tile block keeps the top k of; else 0
    group: int  # tile route: entries kept a tile, the power of two >= k; else 0
    tiles: int  # tile route: ceil(I / width) blocks a query row; else 0


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def k2_route(k: int, I: int, B: int) -> K2Route:
    """K2's route on the card for a call of ``B`` query rows, ``k``
    winners, an ``I``-item catalog. ``"tile"`` for ``k <=
    K2_TILE_MAX_K``: each block keeps the top ``group`` of ``width``
    items, and one block a row merges the ``tiles`` lists; ``width`` is
    the narrowest multiple of :data:`K2_CHUNK` whose ``tiles`` lists
    hold at most :data:`K2_MERGE_CAP` entries (narrow tiles fill the
    card at B = 1; wider ones keep the merge small at large k).
    ``"select"`` above: a ``[B, I]`` score scratch and a radix select.
    B does not change the pick: a block serves up to 8 query rows of one
    tile, so larger B only adds blocks."""
    if B < 1 or I < 1 or not 1 <= k <= I:
        raise ValueError(f"K2 takes 1 <= k <= I and B >= 1, got k={k} I={I} B={B}")
    if k > K2_TILE_MAX_K:
        return K2Route("select", 0, 0, 0)
    group = _pow2_at_least(k)
    width = K2_CHUNK
    while -(-I // width) * group > K2_MERGE_CAP:
        width *= 2
    return K2Route("tile", width, group, -(-I // width))


def k2_launches(k: int, I: int, B: int, summed: bool = False) -> int:
    """Kernel launches one K2 call on the card should add to its
    wrapper's ``kernel_launches`` (:func:`k2_route`), per row chunk
    (:func:`k2_chunks`): 2 on the tile route (tile, merge); on the
    select route 2 (score, select), 3 in summed-rows mode (its query rows
    summed first)."""
    chunks = len(k2_chunks(k, I, B))
    if k2_route(k, I, B).name == "tile":
        return 2 * chunks
    return (3 if summed else 2) * chunks


def k2_chunks(k: int, I: int, B: int) -> list[tuple[int, int]]:
    """The ``[lo, hi)`` row chunks one K2 call of ``B`` rows is launched
    in: at most ``K2_MAX_GRID_Y * K2_TILE_B`` rows a chunk (the grid's
    row blocks), and as many as keep the route's scratch within
    :data:`K2_SCRATCH_BYTES` (at least one row). The route does not
    depend on B, so every chunk takes the same route."""
    return _row_chunks(k2_route(k, I, B), k, I, B)


def _row_chunks(plan: K2Route, k: int, I: int, B: int) -> list[tuple[int, int]]:
    if plan.name == "tile":
        per_row = plan.tiles * plan.group * 8
    else:
        per_row = I * 4 + k * 8
    rows = min(K2_MAX_GRID_Y * K2_TILE_B, max(1, K2_SCRATCH_BYTES // per_row))
    return [(lo, min(B, lo + rows)) for lo in range(0, B, rows)]


def top_k_rows_reference(scores: torch.Tensor, k: int):
    """Plain top-k of each row of a [B, I] f32 score matrix in
    ``lax.top_k`` order: a stable descending sort on :func:`order_key`."""
    k = min(int(k), scores.shape[-1])
    order = torch.sort(order_key(scores), dim=-1, descending=True, stable=True)
    ids = order.indices[..., :k]
    return torch.gather(scores, -1, ids), ids.to(torch.int32)


def _dense_rows(table, ixs: torch.Tensor) -> torch.Tensor:
    """``table[ixs]`` as f32, dequantizing an int8 pair after the gather."""
    if isinstance(table, tuple):
        q, s = table
        return q[ixs].to(torch.float32) * s[ixs][..., None]
    return table[ixs].to(torch.float32)


def _score_top_k_reference(queries: torch.Tensor, item_factors, k: int,
                           exclude_mask=None, norms=None, qnorms=None):
    """Score f32 query rows ``[B, D]`` against the catalog and take the
    top k: the kernel's arithmetic (``sum_d q_d * v_d`` over d = 0..D-1
    in order, each product and partial sum rounded to f32, from +0.0),
    times the int8 item scale after the product, masked to ``NEG_INF``.
    With ``norms`` ([I]) and ``qnorms`` ([B]), the cosine mode: int8
    values without their scales, each score divided by ``max(norms[i] *
    qnorms[b], 1e-12)`` before the mask."""
    values = item_factors[0] if isinstance(item_factors, tuple) else item_factors
    items = values.to(torch.float32)  # [I, D]
    scores = queries.new_zeros((queries.shape[0], items.shape[0]))
    for d in range(items.shape[1]):
        scores = scores + queries[:, d, None] * items[None, :, d]
    if norms is not None:
        scores = scores / torch.clamp(norms[None, :] * qnorms[:, None], min=1e-12)
    elif isinstance(item_factors, tuple):
        scores = scores * item_factors[1][None, :]
    if exclude_mask is not None:
        mask = torch.as_tensor(exclude_mask, device=values.device).to(torch.bool)
        scores = torch.where(mask[None, :], NEG_INF, scores)
    return top_k_rows_reference(scores, k)


def gather_top_k_batch_reference(user_ixs, user_factors, item_factors, k: int,
                                 exclude_mask=None):
    """The plain PyTorch version of K2, same contract as
    :func:`gather_top_k_batch`: gather, dequantize, score in f32,
    multiply by the int8 item scale after the product, mask to
    ``NEG_INF``, stable descending sort on the order key.

    The score is the kernel's arithmetic: ``sum_d u_d * v_d`` over d =
    0..D-1 in order, each product and each partial sum rounded to f32 (no
    FMA), starting from +0.0. Elementwise, so a row's bits do not depend
    on the batch size, and equal to the kernel's bit for bit."""
    values = item_factors[0] if isinstance(item_factors, tuple) else item_factors
    ixs = torch.as_tensor(user_ixs, device=values.device).to(torch.int64)
    users = _dense_rows(user_factors, ixs)  # [B, D]
    return _score_top_k_reference(users, item_factors, k, exclude_mask)


def sum_rows_top_k_batch_reference(row_ixs, row_weights, item_factors, k: int,
                                   exclude_mask=None):
    """The plain PyTorch version of K2's summed-rows mode, same contract
    as :func:`sum_rows_top_k_batch`: query row ``q_b = sum_l
    deq(V[ix_bl]) * w_bl`` added in l order from +0.0 (each product and
    partial sum rounded to f32, weight-0 rows multiplied in), then
    scored as :func:`gather_top_k_batch_reference` scores."""
    values = item_factors[0] if isinstance(item_factors, tuple) else item_factors
    ixs = torch.as_tensor(row_ixs, device=values.device).to(torch.int64)
    w = torch.as_tensor(row_weights, device=values.device).to(torch.float32)
    rows = _dense_rows(item_factors, ixs)  # [B, L, D]
    queries = rows.new_zeros((rows.shape[0], rows.shape[2]))
    for l in range(rows.shape[1]):
        queries = queries + rows[:, l] * w[:, l, None]
    return _score_top_k_reference(queries, item_factors, k, exclude_mask)


# -- the CUDA kernel ---------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)  # the entries' launch counter


def _lib() -> ctypes.CDLL:
    lib = _build.load("topk")
    if not getattr(lib, "_pio_typed", False):
        lib.pio_k2_gather_top_k.argtypes = [
            _P, _I, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _IP, _P,
        ]
        lib.pio_k2_gather_top_k.restype = _I
        lib.pio_k2_select.argtypes = [_P, _I, _I, _I, _P, _P, _P, _IP, _P]
        lib.pio_k2_select.restype = _I
        lib.pio_k2_sum_rows_top_k.argtypes = [
            _P, _P, _I, _I, _P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _IP, _P,
        ]
        lib.pio_k2_sum_rows_top_k.restype = _I
        lib.pio_k2_tile_top_k.argtypes = [
            _P, _I, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _IP, _P,
        ]
        lib.pio_k2_tile_top_k.restype = _I
        lib.pio_k2_tile_sum_rows_top_k.argtypes = [
            _P, _P, _I, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _IP, _P,
        ]
        lib.pio_k2_tile_sum_rows_top_k.restype = _I
        lib.pio_k2_cosine_top_k.argtypes = [
            _P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _IP, _P,
        ]
        lib.pio_k2_cosine_top_k.restype = _I
        lib._pio_typed = True
    return lib


def _split(table, name: str):
    """(values, scales or None, dtype code), checked for the kernel."""
    values, scales = table if isinstance(table, tuple) else (table, None)
    code = _DTYPE_CODE.get(values.dtype)
    if code is None or values.dim() != 2 or not values.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous [N, D] float32/bfloat16/int8 "
            f"tensor, got {values.dtype} {tuple(values.shape)}"
        )
    if (code == 2) != (scales is not None):
        raise ValueError(f"{name}: int8 values come with f32 scales, others without")
    if scales is not None and (
        scales.dtype != torch.float32 or scales.shape != values.shape[:1]
        or not scales.is_contiguous()
    ):
        raise ValueError(f"{name}: scales must be contiguous float32 [N]")
    return values, scales, code


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _on(device: torch.device, *tensors) -> None:
    for t in tensors:
        if t is not None and t.device != device:
            raise ValueError(f"tensor on {t.device}, expected {device}")


def _indices(ixs, num_rows: int, device: torch.device) -> torch.Tensor:
    """int32 index tensor on ``device``, in the shape given. Host indices
    are range-checked here; device indices are the caller's to keep in
    range."""
    if isinstance(ixs, torch.Tensor) and ixs.device.type == "cuda":
        return ixs.to(torch.int32).contiguous()
    a = np.asarray(ixs.cpu() if isinstance(ixs, torch.Tensor) else ixs, dtype=np.int64)
    if a.size and (a.min() < 0 or a.max() >= num_rows):
        raise IndexError(f"index out of range [0, {num_rows})")
    return torch.from_numpy(a.astype(np.int32)).to(device)


def _user_ixs(user_ixs, num_users: int, device: torch.device) -> torch.Tensor:
    """int32 [B] user index tensor on ``device`` (:func:`_indices`)."""
    return _indices(user_ixs, num_users, device).reshape(-1)


def _mask(exclude_mask, num_items: int, device: torch.device):
    if exclude_mask is None:
        return None
    mask = torch.as_tensor(exclude_mask, device=device).to(torch.bool).contiguous()
    if mask.shape != (num_items,):
        raise ValueError(f"exclude_mask must be [{num_items}] bool")
    return mask


def _route_counts() -> dict:
    return {"tile": _build.LaunchCount(), "select": _build.LaunchCount()}


def gather_top_k_batch(user_ixs, user_factors, item_factors, k: int,
                       exclude_mask=None):
    """Fused gather + score + top-k: the serving path's one device call.

    ``user_ixs``: [B] indices into ``user_factors``; ``user_factors`` and
    ``item_factors``: dense float32/bfloat16 [N, D] tensors or int8
    ``(values [N, D], scales float32 [N])`` pairs, all on one device;
    ``exclude_mask``: optional [I] bool, masked items score ``NEG_INF``.
    ``k`` is capped at the catalog size. Returns ``([B, k] f32 scores,
    [B, k] int32 ids)``.

    CPU tensors take :func:`gather_top_k_batch_reference`; CUDA tensors
    launch the route :func:`k2_route` picks (``csrc/topk.cu``) or raise."""
    item_values = item_factors[0] if isinstance(item_factors, tuple) else item_factors
    if item_values.device.type == "cpu":
        k = min(int(k), catalog_rows(item_factors))
        return gather_top_k_batch_reference(
            user_ixs, user_factors, item_factors, k, exclude_mask
        )
    return _gather_on_card(None, gather_top_k_batch, user_ixs, user_factors,
                           item_factors, k, exclude_mask)


gather_top_k_batch.launches = _build.LaunchCount()
gather_top_k_batch.routes = _route_counts()
gather_top_k_batch.kernel_launches = _build.LaunchCount()


def top_k_items_batch(user_vectors, item_factors, k: int, exclude_mask=None):
    """Dense ``[B, D]`` query rows scored against the catalog, top k:
    ``([B, k] f32 scores, [B, k] int32 ids)``, the JAX package's ``:69``
    (an int8 catalog scores ``(u . q) * s``). It is
    :func:`gather_top_k_batch` of the rows as a float32 table read
    through ``arange(B)``, on that wrapper's launches and counts."""
    values = item_factors[0] if isinstance(item_factors, tuple) else item_factors
    queries = torch.as_tensor(user_vectors, device=values.device).to(torch.float32)
    ixs = torch.arange(queries.shape[0], dtype=torch.int32, device=values.device)
    return gather_top_k_batch(ixs, queries.contiguous(), item_factors, k, exclude_mask)


def top_k_items(user_vector, item_factors, k: int, exclude_mask=None):
    """One dense query ``[D]`` scored against the catalog, top k:
    ``([k] f32 scores, [k] int32 ids)``, the JAX package's ``:34`` (an
    int8 catalog scores ``(u . q) * s``). Row 0 of
    :func:`top_k_items_batch` at B = 1: K2 on the card, its plain version
    on the CPU."""
    values = item_factors[0] if isinstance(item_factors, tuple) else item_factors
    query = torch.as_tensor(user_vector, device=values.device).to(torch.float32)
    scores, ids = top_k_items_batch(query.reshape(1, -1), item_factors, k, exclude_mask)
    return scores[0], ids[0]


def _cosine_inputs(item_vector, item_factors, norms):
    """(the f32 ``[1, D]`` query, the ``[I]`` catalog norms, the ``[1]``
    query norm as ``jnp.linalg.norm`` states it: an f32 sum of squares,
    then the square root)."""
    values = item_factors[0] if isinstance(item_factors, tuple) else item_factors
    device = values.device
    query = torch.as_tensor(item_vector, device=device).to(torch.float32).reshape(1, -1)
    if norms is None:
        norms = catalog_norms(item_factors)
    norms = torch.as_tensor(norms, device=device).to(torch.float32).contiguous()
    if norms.shape != values.shape[:1]:
        raise ValueError(f"norms must be [{values.shape[0]}] like the catalog's rows")
    return query.contiguous(), norms, torch.sqrt((query * query).sum()).reshape(1)


def top_k_similar_reference(item_vector, item_factors, k: int, exclude_mask=None,
                            norms=None):
    """The plain PyTorch version of K2's cosine mode, same contract as
    :func:`top_k_similar`: the kernel's dot products (d in order, each
    product and partial sum rounded), divided by ``max(norms *
    ||v||, 1e-12)``, masked to ``NEG_INF``, stable descending sort on the
    order key."""
    k = min(int(k), catalog_rows(item_factors))
    query, norms, qnorm = _cosine_inputs(item_vector, item_factors, norms)
    scores, ids = _score_top_k_reference(query, item_factors, k, exclude_mask,
                                         norms=norms, qnorms=qnorm)
    return scores[0], ids[0]


def top_k_similar(item_vector, item_factors, k: int, exclude_mask=None, norms=None):
    """Cosine top-k of one item vector ``[D]`` against the catalog, the
    JAX package's ``:247``: ``(f32(V) @ v) / max(norms * ||v||, 1e-12)``
    (an int8 pair's values alone: the positive per-row scale drops out of
    a cosine), masked to ``NEG_INF``, top k in ``lax.top_k`` order.
    ``norms``: optional precomputed :func:`catalog_norms` ``[I]``; without
    it every call reduces the catalog first. Returns ``([k] f32 scores,
    [k] int32 ids)``, k capped at the catalog size.

    CPU tensors take :func:`top_k_similar_reference`; CUDA tensors launch
    K2's cosine mode (``csrc/topk.cu``, the route :func:`k2_route` picks)
    or raise."""
    values = item_factors[0] if isinstance(item_factors, tuple) else item_factors
    if values.device.type == "cpu":
        return top_k_similar_reference(item_vector, item_factors, k, exclude_mask, norms)
    device = values.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    k = min(int(k), catalog_rows(item_factors))
    query, norms, qnorm = _cosine_inputs(item_vector, item_factors, norms)
    v_vals, _, v_code = _split(item_factors, "item_factors")
    num_items, rank = v_vals.shape
    if query.shape[1] != rank:
        raise ValueError("the query vector and the catalog differ in rank")
    mask = _mask(exclude_mask, num_items, device)
    scores = torch.empty((1, k), dtype=torch.float32, device=device)
    ids = torch.empty((1, k), dtype=torch.int32, device=device)
    if k == 0:
        return scores[0], ids[0]
    plan = k2_route(k, num_items, 1)
    ixs = torch.zeros(1, dtype=torch.int32, device=device)
    ws = scratch = cand = None
    if plan.name == "tile":
        ws = torch.empty((1, plan.tiles, plan.group), dtype=torch.int64, device=device)
    else:
        scratch = torch.empty((1, num_items), dtype=torch.float32, device=device)
        cand = torch.empty((1, k), dtype=torch.int64, device=device)
    launched = ctypes.c_int(0)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pio_k2_cosine_top_k(
            ixs.data_ptr(), 1, query.data_ptr(), v_vals.data_ptr(), v_code,
            norms.data_ptr(), qnorm.data_ptr(), _ptr(mask), num_items, rank, k,
            plan.width, _ptr(ws), _ptr(scratch), _ptr(cand),
            scores.data_ptr(), ids.data_ptr(), ctypes.byref(launched), stream,
        )
    _build.check(err, f"top_k_similar {plan.name} route launch")
    top_k_similar.launches.add()
    top_k_similar.routes[plan.name].add()
    top_k_similar.kernel_launches.add(launched.value)
    return scores[0], ids[0]


top_k_similar.launches = _build.LaunchCount()
top_k_similar.routes = _route_counts()
top_k_similar.kernel_launches = _build.LaunchCount()


def _gather_top_k_select(user_ixs, user_factors, item_factors, k: int,
                         exclude_mask=None):
    """K2's select route at any k, whatever :func:`k2_route` picks: the
    old route's same-run baseline for chip_smoke.py. CUDA tensors only;
    counts its calls in its own ``launches``."""
    return _gather_on_card("select", _gather_top_k_select, user_ixs, user_factors,
                           item_factors, k, exclude_mask)


_gather_top_k_select.launches = _build.LaunchCount()
_gather_top_k_select.routes = _route_counts()
_gather_top_k_select.kernel_launches = _build.LaunchCount()


def _gather_on_card(route, counter, user_ixs, user_factors, item_factors, k: int,
                    exclude_mask):
    """K2 on CUDA tensors by ``route`` ("select", or None: what
    :func:`k2_route` picks); one call counted on ``counter``."""
    item_values = item_factors[0] if isinstance(item_factors, tuple) else item_factors
    device = item_values.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    k = min(int(k), catalog_rows(item_factors))
    u_vals, u_scales, u_code = _split(user_factors, "user_factors")
    v_vals, v_scales, v_code = _split(item_factors, "item_factors")
    _on(device, u_vals, u_scales, v_scales)
    if u_vals.shape[1] != v_vals.shape[1]:
        raise ValueError("user and item factors differ in rank")
    num_items, rank = v_vals.shape
    ixs = _user_ixs(user_ixs, u_vals.shape[0], device)
    batch = ixs.shape[0]
    mask = _mask(exclude_mask, num_items, device)
    scores = torch.empty((batch, k), dtype=torch.float32, device=device)
    ids = torch.empty((batch, k), dtype=torch.int32, device=device)
    if batch == 0 or k == 0:
        return scores, ids
    plan = k2_route(k, num_items, batch)
    if route is not None:
        plan = K2Route(route, 0, 0, 0)
    launched = ctypes.c_int(0)  # the C entry adds each kernel it launches
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for lo, hi in _row_chunks(plan, k, num_items, batch):
            n = hi - lo
            if plan.name == "tile":
                ws = torch.empty((n, plan.tiles, plan.group), dtype=torch.int64,
                                 device=device)
                err = lib.pio_k2_tile_top_k(
                    ixs[lo:].data_ptr(), n,
                    u_vals.data_ptr(), u_code, _ptr(u_scales),
                    v_vals.data_ptr(), v_code, _ptr(v_scales),
                    _ptr(mask), num_items, rank, k, plan.width,
                    ws.data_ptr(), scores[lo:].data_ptr(), ids[lo:].data_ptr(),
                    ctypes.byref(launched), stream,
                )
            else:
                scratch = torch.empty((n, num_items), dtype=torch.float32, device=device)
                cand = torch.empty((n, k), dtype=torch.int64, device=device)
                err = lib.pio_k2_gather_top_k(
                    ixs[lo:].data_ptr(), n,
                    u_vals.data_ptr(), u_code, _ptr(u_scales),
                    v_vals.data_ptr(), v_code, _ptr(v_scales),
                    _ptr(mask), num_items, rank, k,
                    scratch.data_ptr(), cand.data_ptr(),
                    scores[lo:].data_ptr(), ids[lo:].data_ptr(),
                    ctypes.byref(launched), stream,
                )
            _build.check(err, f"{counter.__name__} {plan.name} route launch")
    counter.launches.add()
    counter.routes[plan.name].add()
    counter.kernel_launches.add(launched.value)
    return scores, ids


def sum_rows_top_k_batch(row_ixs, row_weights, item_factors, k: int,
                         exclude_mask=None):
    """K2's summed-rows mode: the query row of batch row b is the sum of
    catalog rows ``row_ixs[b]`` weighted by ``row_weights[b]``; it is
    scored against the same catalog and the top k taken.

    ``row_ixs``: [B, L] int rows of ``item_factors``, right-padded to a
    shared L; ``row_weights``: [B, L] f32, 1.0 for real rows and 0.0 for
    padding; ``item_factors``: a dense float32/bfloat16 [I, D] tensor or
    the int8 ``(values, scales)`` pair (the row-normalized catalog of
    ``models/filters.py normalized_device_factors``); ``exclude_mask``:
    optional [I] bool shared by the batch. ``k`` is capped at the catalog
    size. Returns ``([B, k] f32 scores, [B, k] int32 ids)``.

    CPU tensors take :func:`sum_rows_top_k_batch_reference`; CUDA tensors
    launch the route :func:`k2_route` picks (``csrc/topk.cu``) or raise."""
    item_values = item_factors[0] if isinstance(item_factors, tuple) else item_factors
    if item_values.device.type == "cpu":
        k = min(int(k), catalog_rows(item_factors))
        return sum_rows_top_k_batch_reference(
            row_ixs, row_weights, item_factors, k, exclude_mask
        )
    return _sum_rows_on_card(None, sum_rows_top_k_batch, row_ixs, row_weights,
                             item_factors, k, exclude_mask)


sum_rows_top_k_batch.launches = _build.LaunchCount()
sum_rows_top_k_batch.routes = _route_counts()
sum_rows_top_k_batch.kernel_launches = _build.LaunchCount()

for _wrapper in (gather_top_k_batch, sum_rows_top_k_batch, top_k_similar):
    for _route, _count in _wrapper.routes.items():
        obs_metrics.gauge(
            "pio_k2_calls", "K2 calls on the card by route, since the "
            "process started", kernel=_wrapper.__name__, route=_route,
        ).set_function(lambda c=_count: float(c.value))
    obs_metrics.gauge(
        "pio_k2_kernel_launches", "Kernels K2's calls launched on the card, "
        "as the C entry counts them", kernel=_wrapper.__name__,
    ).set_function(lambda c=_wrapper.kernel_launches: float(c.value))
del _wrapper, _route, _count


def _sum_rows_top_k_select(row_ixs, row_weights, item_factors, k: int,
                           exclude_mask=None):
    """K2 summed rows by the select route at any k (three launches), for
    chip_smoke.py's same-run baseline. CUDA tensors only; counts its
    calls in its own ``launches``."""
    return _sum_rows_on_card("select", _sum_rows_top_k_select, row_ixs, row_weights,
                             item_factors, k, exclude_mask)


_sum_rows_top_k_select.launches = _build.LaunchCount()
_sum_rows_top_k_select.routes = _route_counts()
_sum_rows_top_k_select.kernel_launches = _build.LaunchCount()


def _sum_rows_on_card(route, counter, row_ixs, row_weights, item_factors, k: int,
                      exclude_mask):
    """K2 summed rows on CUDA tensors by ``route`` ("select", or None:
    what :func:`k2_route` picks); one call counted on ``counter``."""
    item_values = item_factors[0] if isinstance(item_factors, tuple) else item_factors
    device = item_values.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    k = min(int(k), catalog_rows(item_factors))
    v_vals, v_scales, v_code = _split(item_factors, "item_factors")
    _on(device, v_scales)
    num_items, rank = v_vals.shape
    ixs = _indices(row_ixs, num_items, device)
    if ixs.dim() != 2:
        raise ValueError(f"row_ixs must be [B, L], got shape {tuple(ixs.shape)}")
    batch, width = ixs.shape
    w = torch.as_tensor(row_weights, device=device).to(torch.float32).contiguous()
    if tuple(w.shape) != (batch, width):
        raise ValueError(f"row_weights must be [{batch}, {width}] like row_ixs")
    mask = _mask(exclude_mask, num_items, device)
    scores = torch.empty((batch, k), dtype=torch.float32, device=device)
    ids = torch.empty((batch, k), dtype=torch.int32, device=device)
    if batch == 0 or k == 0:
        return scores, ids
    plan = k2_route(k, num_items, batch)
    if route is not None:
        plan = K2Route(route, 0, 0, 0)
    launched = ctypes.c_int(0)  # the C entry adds each kernel it launches
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for lo, hi in _row_chunks(plan, k, num_items, batch):
            n = hi - lo
            if plan.name == "tile":
                ws = torch.empty((n, plan.tiles, plan.group), dtype=torch.int64,
                                 device=device)
                err = lib.pio_k2_tile_sum_rows_top_k(
                    ixs[lo:].data_ptr(), w[lo:].data_ptr(), n, width,
                    v_vals.data_ptr(), v_code, _ptr(v_scales),
                    _ptr(mask), num_items, rank, k, plan.width,
                    ws.data_ptr(), scores[lo:].data_ptr(), ids[lo:].data_ptr(),
                    ctypes.byref(launched), stream,
                )
            else:
                qvec = torch.empty((n, rank), dtype=torch.float32, device=device)
                scratch = torch.empty((n, num_items), dtype=torch.float32, device=device)
                cand = torch.empty((n, k), dtype=torch.int64, device=device)
                err = lib.pio_k2_sum_rows_top_k(
                    ixs[lo:].data_ptr(), w[lo:].data_ptr(), n, width,
                    v_vals.data_ptr(), v_code, _ptr(v_scales),
                    _ptr(mask), num_items, rank, k,
                    qvec.data_ptr(), scratch.data_ptr(), cand.data_ptr(),
                    scores[lo:].data_ptr(), ids[lo:].data_ptr(),
                    ctypes.byref(launched), stream,
                )
            _build.check(err, f"sum_rows_top_k_batch {plan.name} route launch")
    counter.launches.add()
    counter.routes[plan.name].add()
    counter.kernel_launches.add(launched.value)
    return scores, ids


def catalog_norms(item_factors) -> torch.Tensor:
    """Per-row L2 norms ``[I]`` f32 of a catalog's stored values (the int8
    pair's values, without their scales): computed once at model load and
    kept on the device beside the table."""
    values = item_factors[0] if isinstance(item_factors, tuple) else item_factors
    return torch.linalg.vector_norm(values.to(torch.float32), dim=1)


def select_rows(scores: torch.Tensor, k: int):
    """K2's selection stage alone (``select_kernel``, one launch) on a
    ``[B, I]`` f32 CUDA tensor, any ``k <= I``: ``([B, k] scores, [B, k]
    int32 ids, kernels launched)`` in ``lax.top_k`` order. For callers that
    count the launch as their own (K6's scores route); others call
    :func:`top_k_rows`."""
    if scores.dtype != torch.float32 or scores.dim() != 2:
        raise ValueError("select_rows takes a [B, I] float32 tensor")
    if not 0 <= k <= scores.shape[-1]:
        raise ValueError(f"select_rows takes 0 <= k <= I = {scores.shape[-1]}, got {k}")
    scores = scores.contiguous()
    batch, num_items = scores.shape
    out = torch.empty((batch, k), dtype=torch.float32, device=scores.device)
    ids = torch.empty((batch, k), dtype=torch.int32, device=scores.device)
    if batch == 0 or k == 0:
        return out, ids, 0
    cand = torch.empty((batch, k), dtype=torch.int64, device=scores.device)
    launched = ctypes.c_int(0)
    lib = _lib()
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = lib.pio_k2_select(
            scores.data_ptr(), batch, num_items, k, cand.data_ptr(),
            out.data_ptr(), ids.data_ptr(), ctypes.byref(launched), stream,
        )
    _build.check(err, "select_rows kernel launch")
    return out, ids, launched.value


def top_k_rows(scores: torch.Tensor, k: int):
    """Top-k of each row of a [B, I] f32 score matrix in ``lax.top_k``
    order: ``([B, k] scores, [B, k] int32 ids)``. K2's selection stage
    alone (the kernel's second launch), for scores computed elsewhere.
    CPU tensors take :func:`top_k_rows_reference`."""
    k = min(int(k), scores.shape[-1])
    if scores.device.type == "cpu":
        return top_k_rows_reference(scores, k)
    out, ids, launched = select_rows(scores, k)
    top_k_rows.launches.add(launched)
    return out, ids


top_k_rows.launches = _build.LaunchCount()


# -- K3: the ranking-metrics kernel --------------------------------------------


def _ranking_tables(P: int, k: int, device: torch.device):
    """(discounts ``[P]``, IDCG prefix ``[k]``) float32: ``1 / log2(r +
    1)`` for rank r = 1..P, and the running sum of ``1 / log2(r + 1)``
    over r = 1..k, computed in torch float32 as the JAX package computes
    them. K3 takes them as inputs, so both versions divide by the same
    bits."""
    discounts = 1.0 / torch.log2(torch.arange(2, P + 2, dtype=torch.float32))
    idcg = torch.cumsum(1.0 / torch.log2(torch.arange(2, k + 2, dtype=torch.float32)), 0)
    return discounts.to(device), idcg.to(device)


def _ranking_inputs(pred_ids, actual_sorted, actual_counts, device):
    pred = torch.as_tensor(pred_ids, device=device).to(torch.int32).contiguous()
    actual = torch.as_tensor(actual_sorted, device=device).to(torch.int32).contiguous()
    counts = torch.as_tensor(actual_counts, device=device).to(torch.int32).contiguous()
    Q = pred.shape[0]
    if pred.dim() != 2 or actual.dim() != 2 or actual.shape[0] != Q or counts.shape != (Q,):
        raise ValueError(
            "ranking_metrics_batch takes pred_ids [Q, P], actual_sorted [Q, A] "
            f"and actual_counts [Q]; got {tuple(pred.shape)}, "
            f"{tuple(actual.shape)}, {tuple(counts.shape)}"
        )
    return pred, actual, counts


def ranking_metrics_batch_reference(pred_ids, actual_sorted, actual_counts, k: int):
    """The plain PyTorch version of K3, same contract as
    :func:`ranking_metrics_batch`, operation for operation the JAX
    package's: a sorted lookup (``searchsorted``) per rank position, hit
    prefix sums for the precision-at-hit terms, true divisions."""
    pred = torch.as_tensor(pred_ids).to(torch.int32)
    device = pred.device
    pred, actual, counts = _ranking_inputs(pred, actual_sorted, actual_counts, device)
    Q, pn = pred.shape
    if actual.shape[1] == 0:
        raise ValueError("actual_sorted needs at least one column")
    pos = torch.searchsorted(actual, pred)
    clipped = pos.clamp(0, actual.shape[1] - 1)
    hits = ((pos < counts[:, None]) & (torch.gather(actual, 1, clipped) == pred)
            & (pred >= 0)).to(torch.float32)
    kf = torch.full((Q,), float(k), dtype=torch.float32, device=device)
    precision = hits.sum(dim=1) / kf
    ranks = torch.arange(1, pn + 1, dtype=torch.float32, device=device)
    ap_terms = torch.where(hits > 0, torch.cumsum(hits, dim=1) / ranks,
                           torch.zeros_like(hits))
    ap_norm = torch.clamp(torch.minimum(kf, counts.to(torch.float32)), min=1.0)
    ap = ap_terms.sum(dim=1) / ap_norm
    discounts, idcg = _ranking_tables(pn, k, device)
    dcg = (hits * discounts).sum(dim=1)
    ideal_n = torch.clamp(torch.minimum(counts, torch.full_like(counts, k)), 1, k)
    ndcg = dcg / idcg[(ideal_n - 1).to(torch.int64)]
    return precision, ap, ndcg, counts > 0


#: lanes K3 gives a query row at most (csrc/ranking.cu K3_MAX_GROUP): a warp
K3_MAX_GROUP = 32
#: rank positions a K3 lane takes at most below K3_MAX_GROUP lanes a row
#: (csrc/ranking.cu K3_POSITIONS)
K3_POSITIONS = 16


def k3_group(P: int) -> int:
    """Lanes K3 gives a query row of ``P`` rank positions (csrc/ranking.cu
    ``k3_group``): the fewest, a power of two, that leave a lane at most
    :data:`K3_POSITIONS` positions, at most :data:`K3_MAX_GROUP`; one
    thread a row at the evaluation's P <= 16. A warp serves ``32 //
    k3_group(P)`` rows."""
    g = 1
    while g < K3_MAX_GROUP and P > K3_POSITIONS * g:
        g *= 2
    return g


def _k3_lib() -> ctypes.CDLL:
    lib = _build.load("ranking")
    if not getattr(lib, "_pio_typed", False):
        lib.pio_k3_ranking_metrics.argtypes = [
            _P, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P,
        ]
        lib.pio_k3_ranking_metrics.restype = _I
        lib._pio_typed = True
    return lib


def ranking_metrics_batch(pred_ids, actual_sorted, actual_counts, k: int):
    """K3: P@K, AP@K and NDCG@K of every query of an eval split at once.

    ``pred_ids``: ``[Q, P]`` int32 ranked predicted ids, P <= k; -1 marks
    an empty slot. ``actual_sorted``: ``[Q, A]`` int32 relevant ids per
    query, sorted ascending and padded with ``ACTUAL_PAD`` (int32 max);
    relevant ids outside the prediction id space are distinct codes <= -2
    (core/ranking.py ``encode_actuals``). ``actual_counts``: ``[Q]`` int32
    true |actual|. ``k``: the metric cutoff; denominators use it even
    when P < k. Returns ``(precision, ap, ndcg, valid)``, each ``[Q]``
    (float32, float32, float32, bool); ``valid`` is False where the actual
    set is empty (the rows the per-query metrics skip).

    Inputs go to the device of ``pred_ids`` when it is a tensor, else
    the CPU; a CPU tensor takes :func:`ranking_metrics_batch_reference`,
    a CUDA tensor launches ``csrc/ranking.cu`` (:func:`k3_group` lanes a
    query) or raises."""
    device = pred_ids.device if isinstance(pred_ids, torch.Tensor) else torch.device("cpu")
    if device.type == "cpu":
        return ranking_metrics_batch_reference(pred_ids, actual_sorted, actual_counts, k)
    return _ranking_on_card(pred_ids, actual_sorted, actual_counts, k, device, 0,
                            ranking_metrics_batch.launches)


def _ranking_metrics_warp(pred_ids, actual_sorted, actual_counts, k: int):
    """K3's earlier design, one warp a query row whatever P (the kernel
    at 32 lanes a row): chip_smoke.py's same-run baseline. The port never
    calls it. CUDA tensors only; counts its launches in
    ``_ranking_metrics_warp.launches``."""
    return _ranking_on_card(pred_ids, actual_sorted, actual_counts, k, pred_ids.device,
                            K3_MAX_GROUP, _ranking_metrics_warp.launches)


def _ranking_on_card(pred_ids, actual_sorted, actual_counts, k: int, device, group: int,
                     counter):
    """One K3 launch at ``group`` lanes a row (0: :func:`k3_group`),
    added to ``counter``."""
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    k = int(k)
    pred, actual, counts = _ranking_inputs(pred_ids, actual_sorted, actual_counts, device)
    Q, pn = pred.shape
    if k < 1 or actual.shape[1] == 0:
        raise ValueError(f"K3 takes k >= 1 and A >= 1, got k={k} A={actual.shape[1]}")
    out = [torch.empty(Q, dtype=torch.float32, device=device) for _ in range(3)]
    valid = torch.empty(Q, dtype=torch.bool, device=device)
    if Q == 0:
        return (*out, valid)
    discounts, idcg = _ranking_tables(pn, k, device)
    lib = _k3_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pio_k3_ranking_metrics(
            pred.data_ptr(), Q, pn, actual.data_ptr(), actual.shape[1],
            counts.data_ptr(), k, discounts.data_ptr() if pn else None,
            idcg.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            valid.data_ptr(), group, stream,
        )
    _build.check(err, "ranking_metrics_batch kernel launch")
    counter.add()
    return (*out, valid)


ranking_metrics_batch.launches = _build.LaunchCount()
_ranking_metrics_warp.launches = _build.LaunchCount()
