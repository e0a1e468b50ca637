"""Two-stage catalog retrieval: coarse shortlist (K4) + exact rescore (K5).

Port of ``predictionio_tpu/ops/retrieval.py``. The exact serving ops
(``ops/topk.py``, K2) score the whole catalog for every query: O(I) a
query. At catalogs of ``PIO_RETRIEVAL_THRESHOLD`` rows and more (default
100,000) the templates route ``batch_predict`` through two stages:

1. **Coarse shortlist** (K4, :func:`coarse_topk`, kernel
   ``csrc/retrieval.cu``): the catalog is held in a coarse form,
   :class:`CoarseCatalog` -- an int8 catalog as it is stored, a dense one
   as a bf16 copy (or an int8 copy, when forced) -- and each query's best
   ``k'`` rows are found without a ``[B, I]`` score matrix in device
   memory. ``int8`` scores ``(q . values) * scale``; ``int8_dot`` also
   quantizes the queries and sums int8 x int8 in int32 (exact); ``bf16``
   scores the bf16 copy in f32.
2. **Exact rescore** (K5, :func:`rescore_top_k`, the same source): the
   ``[B, k']`` shortlisted rows are scored against query vectors built as
   K2 builds them (a user row, given vectors, or summed catalog rows),
   with K2's arithmetic, so each score equals K2's for the same (query,
   item) pair bit for bit and the two-stage ranking is the exact ranking
   restricted to the shortlist. Recall is then only a question of
   shortlist coverage, which the oversampling ``k' = pow2(oversample *
   pow2(k))`` buys.

Below the threshold the templates never reach this module: nothing
changes, bit for bit. Knobs, read per call as in the JAX package
(``docs/serving.md``): ``PIO_RETRIEVAL_THRESHOLD`` (rows below which
serving stays exact, default 100000; <= 0 disables two-stage),
``PIO_RETRIEVAL_OVERSAMPLE`` (default 8), ``PIO_RETRIEVAL_TILE`` (coarse
tile rows, default 2^18), ``PIO_RETRIEVAL_COARSE`` (``auto``: int8
catalogs stay ``int8``, dense ones get ``bf16``, as the JAX package
picks off a TPU; or force ``int8`` / ``int8_dot`` / ``bf16``) and
``PIO_RETRIEVAL_PROBE_EVERY`` (every Nth two-stage dispatch re-scores one
query exactly and publishes recall; default 256, 0 disables).

On a CUDA tensor each kernel wrapper launches its kernel or raises; on a
CPU tensor it runs the plain PyTorch version beside it
(:func:`coarse_topk_reference`, :func:`rescore_top_k_reference`). K4
takes ``k'`` up to :data:`K4_MAX_K` on the card and raises above it, by
one of two routes (:func:`k4_route`), each one launch: the warp route
for ``k'`` up to :data:`K4_WARP_MAX_K` (lists in registers), the stream
route above (lists in shared memory). The serving path calls
:func:`two_stage_top_k`: the shortlist and its rescore in ONE launch on
the card (K5 is the epilogue of K4's merge), with no host step between
the stages; the standalone K5 (:func:`rescore_top_k`) and the three
``rescore_*_top_k_batch`` forms mirror the JAX package's functions.
``coarse_topk.launches`` / ``rescore_top_k.launches`` count calls on the
card (``modes`` / ``queries`` by form, ``coarse_topk.routes`` by route,
``kernel_launches`` the kernels, as the C entries count them); a fused
call counts one K4 call and one K5 call, and its one launch on K4's
``kernel_launches``. ``/metrics`` reads them as ``pio_k4_calls{mode}``,
``pio_k4_route_calls{route}``, ``pio_k5_calls{query}``,
``pio_k4_kernel_launches`` and ``pio_k5_kernel_launches`` (standalone K5
launches only).

Observability, as the JAX package's: the ``pio_retrieval_*`` metrics, and
a thread-local per-dispatch stage split that the engine server turns
into ``dispatch.shortlist`` / ``dispatch.rescore`` trace spans.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from predictionio_tpu_torch.kernels import _build
from predictionio_tpu_torch.models.modelfile import BFLOAT16, host_array
from predictionio_tpu_torch.obs import metrics as obs_metrics
from predictionio_tpu_torch.ops import topk as topk_ops

NEG_INF = -1e30

# -- knobs (env-read per call: operators flip them on a live server) --------

_DEFAULT_THRESHOLD = 100_000
_DEFAULT_OVERSAMPLE = 8.0
_DEFAULT_TILE = 1 << 18
_DEFAULT_PROBE_EVERY = 256


def retrieval_threshold() -> int:
    return int(os.environ.get("PIO_RETRIEVAL_THRESHOLD", _DEFAULT_THRESHOLD))


def oversample() -> float:
    return float(os.environ.get("PIO_RETRIEVAL_OVERSAMPLE", _DEFAULT_OVERSAMPLE))


def tile_size() -> int:
    return int(os.environ.get("PIO_RETRIEVAL_TILE", _DEFAULT_TILE))


def probe_every() -> int:
    return int(os.environ.get("PIO_RETRIEVAL_PROBE_EVERY", _DEFAULT_PROBE_EVERY))


def engaged(num_rows: int) -> bool:
    """Should serving route this catalog through two-stage retrieval?"""
    t = retrieval_threshold()
    return t > 0 and num_rows >= t


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def shortlist_k(k: int, num_rows: int) -> int:
    """Shortlist size k' for a headroom-k request against ``num_rows``
    catalog rows: oversample * k, power-of-two bucketed, capped at the
    tile width and the catalog's power-of-two envelope."""
    kp = _pow2(int(np.ceil(oversample() * _pow2(max(1, k)))))
    return max(1, min(kp, tile_size(), _pow2(num_rows)))


# -- metrics -----------------------------------------------------------------

_SIZE_BOUNDS = tuple(float(1 << p) for p in range(4, 20, 2))  # 16 .. 262144

_m_two_stage = obs_metrics.counter(
    "pio_retrieval_queries_total",
    "serving queries at retrieval scale, by path", path="two_stage",
)
_m_exact = obs_metrics.counter(
    "pio_retrieval_queries_total",
    "serving queries at retrieval scale, by path", path="exact",
)
_m_shortlist_size = obs_metrics.histogram(
    "pio_retrieval_shortlist_size",
    "shortlist candidates per query (k')", bounds=_SIZE_BOUNDS,
)
_m_shortlist_secs = obs_metrics.histogram(
    "pio_retrieval_shortlist_seconds", "coarse shortlist pass wall time",
)
_m_rescore_secs = obs_metrics.histogram(
    "pio_retrieval_rescore_seconds", "exact rescore pass wall time",
)
_m_probe_recall = obs_metrics.gauge(
    "pio_retrieval_probe_recall",
    "recall@num of the most recent exact-rescored probe query",
)
_m_probes = obs_metrics.counter(
    "pio_retrieval_probes_total", "live recall probes run",
)

_tls = threading.local()
_probe_clock = itertools.count(1)


def note_exact(n: int = 1) -> None:
    """Count queries that stayed on the exact path at retrieval scale
    (complex-filtered queries)."""
    _m_exact.inc(n)


def _note_stage(stage: str, seconds: float) -> None:
    split = getattr(_tls, "split", None)
    if split is None:
        split = _tls.split = {}
    split[stage] = split.get(stage, 0.0) + seconds


def take_stage_split() -> dict | None:
    """Pop this thread's accumulated {shortlist, rescore} seconds since
    the last call: the engine server drains it after every dispatch and
    turns it into ``dispatch.shortlist``/``dispatch.rescore`` spans on
    the request traces it just dispatched."""
    split = getattr(_tls, "split", None)
    _tls.split = None
    return split or None


def probe_due() -> bool:
    """True every ``PIO_RETRIEVAL_PROBE_EVERY``-th two-stage dispatch:
    the caller should exact-score one query and ``record_probe`` the
    measured recall."""
    n = probe_every()
    return n > 0 and next(_probe_clock) % n == 0


def record_probe(recall: float) -> None:
    _m_probes.inc()
    _m_probe_recall.set(recall)


def probe_recall(two_stage_ids, exact_ids) -> float:
    """Measure + publish id-set recall of a two-stage result row against
    its exact-path counterpart (the live recall probe)."""
    want = {int(i) for i in np.asarray(exact_ids).ravel() if int(i) >= 0}
    got = {int(i) for i in np.asarray(two_stage_ids).ravel() if int(i) >= 0}
    recall = len(got & want) / len(want) if want else 1.0
    record_probe(recall)
    return recall


def stats_block() -> dict:
    """Compact ``retrieval`` object for the server's ``/stats.json``."""
    return {
        "threshold": retrieval_threshold(),
        "oversample": oversample(),
        "two_stage_queries": _m_two_stage.value(),
        "exact_queries": _m_exact.value(),
        "shortlist_size": _m_shortlist_size.summary(),
        "shortlist_seconds": _m_shortlist_secs.summary(),
        "rescore_seconds": _m_rescore_secs.summary(),
        "probes": _m_probes.value(),
        "probe_recall": _m_probe_recall.value(),
    }


def _sync(device: torch.device) -> None:
    """Wait for the device's work on the current stream (the stage
    seconds are the device's, as the JAX package's host copies make
    them)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


# -- K4: the coarse shortlist ------------------------------------------------

MODES = ("int8", "int8_dot", "bf16")
_MODE_CODE = {"int8": 0, "int8_dot": 1, "bf16": 2}
ROUTES = ("warp", "stream")
_ROUTE_CODE = {"warp": 0, "stream": 1}
#: csrc/retrieval.cu MAX_K: the largest k' K4 (and shortlist S K5) takes
K4_MAX_K = 8192
#: csrc/retrieval.cu WARP_MAX_K: k' up to this takes the warp route
K4_WARP_MAX_K = 128
K4_TILE_THREADS = 256  # TILE_THREADS: rows a block of the pair's tile launch scores a round
K4_MERGE_THREADS = 1024  # MERGE_THREADS: the pair's merge block
K4_WARP_THREADS = 256  # WARP_THREADS: a warp- or stream-route block, at most 8 warps
K4_ROUND_ROWS = 64  # ROUND_ROWS: rows a warp stages and scores a round
K4_QUEUE = 128  # QUEUE: a warp's queue of admitted composites, per query
K4_MERGE_MAX_COLS = 8  # MERGE_MAX_COLS: list columns a merge batch stages
K4_MAX_STAGES = 4  # MAX_STAGES: a warp's ring, at most (rounds staged ahead + 1)
K4_RADIX = 256  # RADIX: bins of the stream route's exact cut (8 bits a pass)
K4_SMEM_CAP = 232_448  # shared memory a block may take on an H100 (227 KB)
K4_MIN_ROWS = 4096  # catalog rows a block of the pair's tile launch streams, at least
K4_WARP_ROWS_PER_K = 4  # catalog rows a warp streams, at least, per unit of K
K4_WS_BYTES = 1 << 28  # [B, nblk, K] workspace, at most (unless nblk = 1)
_SM_COUNT: dict[int, int] = {}


def quantize_queries(q: torch.Tensor) -> torch.Tensor:
    """``int8_dot``'s query quantization, operation for operation the
    JAX package's: ``qs = max|q| / 127`` per row, ``round(q / max(qs,
    1e-12))`` half to even, clipped to +-127. Both divisions are by a
    tensor (a true division; CUDA turns division by a Python scalar into
    a multiplication by its reciprocal). A NaN quantizes to 0."""
    qs = q.abs().amax(dim=1, keepdim=True) / torch.full_like(q[:, :1], 127.0)
    y = torch.round(q / torch.clamp_min(qs, 1e-12))
    return torch.nan_to_num(y, nan=0.0).clamp(-127, 127).to(torch.int8)


def coarse_topk_reference(queries: torch.Tensor, tiles: torch.Tensor, scales,
                          num_rows: int, k: int, mode: str):
    """The plain PyTorch version of K4, step for step the JAX package's
    scan: per tile, the coarse scores (d in order from +0.0, each product
    and partial sum rounded to f32, times the row scale after the sum;
    ``int8_dot``: exact int32 sums), pad rows at ``NEG_INF``, the tile's
    top k, then the top k of the running list followed by the tile's, in
    ``lax.top_k`` order (:func:`ops.topk.top_k_rows_reference`). Returns
    ``([B, k] f32 scores, [B, k] int32 ids)``, ``(NEG_INF, -1)`` past the
    catalog's rows."""
    q = queries.to(torch.float32)
    device = q.device
    batch = q.shape[0]
    nt, T, D = tiles.shape
    if mode == "int8_dot":
        qi = quantize_queries(q).to(torch.int32)
    best_s = torch.full((batch, k), NEG_INF, dtype=torch.float32, device=device)
    best_i = torch.full((batch, k), -1, dtype=torch.int32, device=device)
    for t in range(nt):
        pos = torch.arange(t * T, (t + 1) * T, device=device)
        tid = torch.where(pos < num_rows, pos, -1).to(torch.int32)
        if mode == "int8_dot":
            v = tiles[t].to(torch.int32)
            acc = torch.zeros((batch, T), dtype=torch.int32, device=device)
            for d in range(D):
                acc = acc + qi[:, d, None] * v[None, :, d]
            sc = acc.to(torch.float32) * scales[t][None, :]
        else:
            v = tiles[t].to(torch.float32)
            sc = torch.zeros((batch, T), dtype=torch.float32, device=device)
            for d in range(D):
                sc = sc + q[:, d, None] * v[None, :, d]
            if scales is not None:
                sc = sc * scales[t][None, :]
        sc = torch.where(tid[None, :] >= 0, sc, NEG_INF)
        ts, tix = topk_ops.top_k_rows_reference(sc, min(k, T))
        ti = tid[tix.to(torch.int64)]
        cs = torch.cat([best_s, ts], dim=1)
        ci = torch.cat([best_i, ti], dim=1)
        best_s, ix = topk_ops.top_k_rows_reference(cs, k)
        best_i = torch.gather(ci, 1, ix.to(torch.int64))
    return best_s, best_i


class K4Plan(NamedTuple):
    """How K4 runs a call on the card (:func:`k4_plan`)."""

    route: str  # "warp", "stream" or "pair" (:func:`k4_route`; "pair": the old stream route)
    rb: int  # query rows a block serves: 8, 4, 2 or 1
    W: int  # catalog rows a block owns
    nblk: int  # blocks a query group: ceil(num_rows / W)
    K: int  # the power of two >= k'
    S: int  # stream: a query's buffer entries; pair: a tile block's; warp: 0
    S2: int  # pair: the buffer entries of a merge block; else 0
    nw: int  # warps a block (warp, stream); pair: 0
    stages: int  # a warp's ring of stages (stages - 1 rounds in flight); pair: 0
    mcols: int  # list columns the merge stages a batch; pair: 0
    smem: int  # dynamic shared memory of the route's main block, bytes


def k4_route(k: int) -> str:
    """K4's route on the card for ``k`` winners: ``"warp"`` for ``k <=``
    :data:`K4_WARP_MAX_K` (every serving call at ``num`` <= 16: each warp
    keeps its running best in registers), ``"stream"`` above (the block's
    lists in shared memory); one launch either way. Raises above
    :data:`K4_MAX_K`."""
    if not 1 <= k <= K4_MAX_K:
        raise ValueError(
            f"K4 takes 1 <= k' <= {K4_MAX_K} (ops/retrieval.py K4_MAX_K, the "
            f"largest shortlist one query's buffer holds in shared memory), got {k}"
        )
    return "warp" if k <= K4_WARP_MAX_K else "stream"


def k4_tile_smem(rb: int, S: int, D: int) -> int:
    """Shared-memory bytes of a block of the pair's tile launch
    (``csrc/retrieval.cu`` ``pio_k4_tile_smem``): the buffers, thresholds,
    counts and per-warp counts of ``rb`` query rows, then the queries in
    f32 and in int8, ``D`` padded to 16."""
    stream = (rb * S + rb) * 8 + rb * 4 + rb * (K4_TILE_THREADS // 32 + 1) * 4
    dp = -(-D // 16) * 16
    return -(-stream // 16) * 16 + rb * dp * 5


def _align16(n: int) -> int:
    return -(-n // 16) * 16


_DTYPE_BYTES = {0: 4, 1: 2, 2: 1}  # csrc/retrieval.cu DType codes (f32, bf16, int8)


def _warp_stage_bytes(D: int, mode: str) -> int:
    """A warp's ring stage: ``K4_ROUND_ROWS`` rows, padded to ``rowbytes +
    16`` when rows are whole 16-byte words (else one span and its offset),
    then their scales in the int8 modes."""
    rowbytes = D * (2 if mode == "bf16" else 1)
    if rowbytes % 16 == 0:
        rows = K4_ROUND_ROWS * (rowbytes + 16)
    else:
        rows = _align16(K4_ROUND_ROWS * rowbytes + 32)
    return rows + (K4_ROUND_ROWS * 4 if mode != "bf16" else 0)


def k5_epilogue_bytes(D: int, v_dtype: int) -> int:
    """Shared memory the fused K5 epilogue takes a warp, at least
    (``csrc/retrieval.cu`` ``epi_bytes``): a query of ``D`` f32, the warp
    route's :data:`K4_WARP_MAX_K` rescore composites and shortlist ids,
    then 32 staged item-table rows, each in a slot of an odd number of
    16-byte words with room for its offset (more groups of 32 go in
    flight at once where the warp's share of the rings holds them)."""
    rowbytes = D * _DTYPE_BYTES[v_dtype]
    return (_align16(D * 4) + K4_WARP_MAX_K * 12
            + 32 * (((rowbytes + 30) // 16) | 1) * 16)


def _k4_ring(D: int, mode: str, stages: int, v_dtype: int) -> int:
    """A warp's share of the rings: its stages, or the fused epilogue's
    need (``v_dtype`` -1: K4 alone)."""
    ring = stages * _warp_stage_bytes(D, mode)
    return max(ring, k5_epilogue_bytes(D, v_dtype)) if v_dtype >= 0 else ring


def k4_stream_cap(K: int) -> int:
    """A stream-route query's buffer entries (``stream_cap``): K kept and
    room for max(K, :data:`K4_QUEUE`) more."""
    return K + max(K, K4_QUEUE)


def k4_smem(route: str, rb: int, nw: int, D: int, mode: str, stages: int, k: int,
            v_dtype: int = -1) -> int:
    """Shared-memory bytes of a warp- or stream-route block
    (``csrc/retrieval.cu`` ``pio_k4_smem``) for ``k`` winners; ``v_dtype``
    the item table's dtype code of a fused call, -1 for K4 alone.

    Warp route: the queries of ``rb`` rows in f32 and in int8, the block's
    thresholds, the 8 warps' published entries, the int8_dot divisors and
    the last-block flag, then for each of ``nw`` warps its queues
    (:data:`K4_QUEUE` composites a query) and its share of the rings.
    Stream route: the queries; each query's threshold, count, lock and
    divisor and the last-block flag; each query's buffer
    (:func:`k4_stream_cap`); each warp's queues, radix histogram and share
    of the rings."""
    ring = _k4_ring(D, mode, stages, v_dtype)
    queries = _align16(rb * _align16(D) * 5)
    if route == "warp":
        return (queries + _align16(rb * (9 * 8 + 4) + 4) + nw * rb * K4_QUEUE * 8
                + nw * ring)
    return (queries + _align16(rb * 20 + 4) + _align16(rb * k4_stream_cap(_pow2(k)) * 8)
            + nw * rb * K4_QUEUE * 8 + nw * K4_RADIX * 4 + nw * ring)


@functools.lru_cache(maxsize=1024)
def k4_plan(batch: int, num_rows: int, dim: int, k: int, sm_count: int = 132,
            mode: str = "bf16", route: str | None = None, v_dtype: int = -1) -> K4Plan:
    """K4's launch plan for ``batch`` queries, ``k`` winners, a catalog of
    ``num_rows`` rows of ``dim`` in coarse ``mode``, on ``route`` (None:
    :func:`k4_route`'s pick; ``"pair"``: the two-launch baseline), for K4
    alone (``v_dtype`` -1) or fused with K5 on an item table of dtype code
    ``v_dtype``. The answer does not depend on the plan. Raises above
    :data:`K4_MAX_K`, and for the warp route above
    :data:`K4_WARP_MAX_K`. Plans are cached: a serving call asks for the
    same few again and again."""
    pick = k4_route(k)
    route = route or pick
    if route == "warp":
        if pick != "warp":
            raise ValueError(f"K4's warp route takes k' <= {K4_WARP_MAX_K}, got {k}")
        return _k4_warp_plan(batch, num_rows, dim, k, sm_count, mode, v_dtype)
    if route == "stream":
        return _k4_stream_plan(batch, num_rows, dim, k, sm_count, mode, v_dtype)
    if route != "pair":
        raise ValueError(f"unknown K4 route {route!r}")
    return _k4_pair_plan(batch, num_rows, dim, k, sm_count)


def _k4_warp_plan(batch: int, num_rows: int, dim: int, k: int, sm_count: int,
                  mode: str, v_dtype: int) -> K4Plan:
    """The warp route: rb as wide as the batch (at most 8); nw warps a
    block, 8 unless the rings of wide rows overflow shared memory, and
    rings as deep as the rest of shared memory allows (up to
    :data:`K4_MAX_STAGES`: the rows in flight hide the memory's
    latency); one block an SM (the card filled once, in one wave:
    ``sm_count // groups`` blocks a query group), but each warp at least
    ``K4_WARP_ROWS_PER_K * K`` rows, since a warp admits about ``K * (1 +
    ln(rows / K))`` of its rows on its own (fewer as the block's shared
    bounds rise); W a multiple of ``K4_ROUND_ROWS * nw``, so each warp
    owns whole rounds. The merge stages ``mcols`` columns of every list
    of ``min(nw, rb)`` queries at once in the rings. Workspace: ``batch *
    nblk * K * 8`` bytes, at most ``(8 * sm_count + batch) * K * 8`` (1.1
    MB at B = 64, K = 128)."""
    K = _pow2(k)
    rb = min(8, _pow2(batch))
    groups = -(-batch // rb)
    if groups > 65535:
        raise ValueError(f"K4 takes at most {65535 * rb} query rows a call, got {batch}")
    fits = [(nw, st) for nw in range(K4_WARP_THREADS // 32, 0, -1)
            for st in range(K4_MAX_STAGES, 1, -1)
            if k4_smem("warp", rb, nw, dim, mode, st, k, v_dtype) <= K4_SMEM_CAP]
    if not fits:
        raise ValueError(f"K4: rank {dim} needs {k4_smem('warp', rb, 1, dim, mode, 2, k, v_dtype)} "
                         "bytes of shared memory a warp-route block")
    nw, stages = fits[0]
    smem = k4_smem("warp", rb, nw, dim, mode, stages, k, v_dtype)
    unit = K4_ROUND_ROWS * nw
    rings = nw * _k4_ring(dim, mode, stages, v_dtype)
    nq = min(nw, rb)
    nblk = max(1, min(sm_count // groups,
                      -(-num_rows // max(unit, nw * K4_WARP_ROWS_PER_K * K)),
                      rings // (nq * 8)))
    W = -(-(-(-num_rows // nblk)) // unit) * unit  # ceil(ceil(I / nblk) / unit) * unit
    nblk = -(-num_rows // W)
    mcols = min(K, K4_MERGE_MAX_COLS)
    while mcols > 1 and nq * mcols * nblk * 8 > rings:
        mcols //= 2
    return K4Plan("warp", rb, W, nblk, K, 0, 0, nw, stages, mcols, smem)


def _k4_stream_plan(batch: int, num_rows: int, dim: int, k: int, sm_count: int,
                    mode: str, v_dtype: int) -> K4Plan:
    """The stream route: 8 warps a block unless nothing fits (wide rows);
    then rb as wide as the batch (at most 8) and rings as deep as 227 KB
    allow beside rb buffers of :func:`k4_stream_cap` entries (rb 8 up to
    k' = 512 at D = 32, 1 at 8,192). One block an SM over the query
    groups: a block appends about ``K * (1 + ln(rows / K))`` of its rows
    and cuts its buffers about ``1 + ln(rows / K)`` times, so long blocks
    cost little more than short ones, while the last block's merge reads
    ``nblk`` lists. Each warp stages the merge's ``mcols`` columns of
    ``nblk`` lists in its share of the rings. Workspace ``batch * nblk *
    K * 8`` bytes: 8 MB at B = 8 or 64, k' = 8,192."""
    K = _pow2(k)
    rb0 = min(8, _pow2(batch))
    fits = [(nw, rb, st) for nw in range(K4_WARP_THREADS // 32, 0, -1)
            for rb in (8, 4, 2, 1) if rb <= rb0
            for st in range(K4_MAX_STAGES, 1, -1)
            if k4_smem("stream", rb, nw, dim, mode, st, K, v_dtype) <= K4_SMEM_CAP]
    if not fits:
        raise ValueError(f"K4: rank {dim} at k' = {k} needs "
                         f"{k4_smem('stream', 1, 1, dim, mode, 2, K, v_dtype)} bytes of "
                         "shared memory a stream-route block")
    nw, rb, stages = fits[0]
    groups = -(-batch // rb)
    if groups > 65535:
        raise ValueError(f"K4 takes at most {65535 * rb} query rows a call, got {batch}")
    unit = K4_ROUND_ROWS * nw
    ring = _k4_ring(dim, mode, stages, v_dtype)
    nblk = max(1, min(sm_count // groups, -(-num_rows // unit), ring // 8,
                      K4_WS_BYTES // (batch * K * 8)))
    W = -(-(-(-num_rows // nblk)) // unit) * unit
    nblk = -(-num_rows // W)
    mcols = min(K, K4_MERGE_MAX_COLS)
    while mcols > 1 and mcols * nblk * 8 > ring:
        mcols //= 2
    smem = k4_smem("stream", rb, nw, dim, mode, stages, K, v_dtype)
    return K4Plan("stream", rb, W, nblk, K, k4_stream_cap(K), 0, nw, stages, mcols, smem)


def _k4_pair_plan(batch: int, num_rows: int, dim: int, k: int, sm_count: int) -> K4Plan:
    """The pair (the stream route before the one-launch design, the
    same-run baseline): rb as wide as the batch (at most 8) and the
    shared memory allow; enough coarse blocks to fill the card once (at
    least :data:`K4_MIN_ROWS` rows each), within :data:`K4_WS_BYTES` of
    workspace. A block's cost is mostly its selection (its rounds'
    barriers and its buffer's sorts), so fewer, longer blocks win once
    the card is full."""
    K = _pow2(k)
    S, S2 = _pow2(K + K4_TILE_THREADS), _pow2(K + K4_MERGE_THREADS)
    rb = min(8, _pow2(batch))
    while rb > 1 and k4_tile_smem(rb, S, dim) > K4_SMEM_CAP:
        rb //= 2
    smem = k4_tile_smem(rb, S, dim)
    if smem > K4_SMEM_CAP:
        raise ValueError(f"K4: rank {dim} at k' = {k} needs {smem} bytes of shared memory")
    groups = -(-batch // rb)
    if groups > 65535:
        raise ValueError(f"K4 takes at most {65535 * rb} query rows a call, got {batch}")
    per_sm = max(1, min(2048 // K4_TILE_THREADS, (228 * 1024) // (smem + 1024)))
    want = -(-sm_count * per_sm // groups)
    nblk = max(1, min(want, -(-num_rows // K4_MIN_ROWS), K4_WS_BYTES // (batch * K * 8)))
    W = -(-num_rows // nblk)
    W = -(-W // K4_TILE_THREADS) * K4_TILE_THREADS
    return K4Plan("pair", rb, W, -(-num_rows // W), K, S, S2, 0, 0, 0, smem)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)


_K4_ARGS = [_I, _P, _I, _I, _P, _P, _L, _L, _I, _I, _I, _I, _L, _I, _I, _I, _P, _P]


def _lib() -> ctypes.CDLL:
    lib = _build.load("retrieval")
    if not getattr(lib, "_pio_typed", False):
        lib.pio_k4_coarse_top_k.argtypes = [
            _P, _I, _I, _P, _P, _L, _I, _I, _I, _L, _I, _I, _I, _I, _P, _P, _P, _IP, _P,
        ]
        lib.pio_k4_coarse_top_k.restype = _I
        lib.pio_k4_tile_smem.argtypes = [_I, _I, _I]
        lib.pio_k4_tile_smem.restype = _L
        lib.pio_k4_smem.argtypes = [_I, _I, _I, _I, _I, _I, _I, _I]
        lib.pio_k4_smem.restype = _L
        lib.pio_k4_top_k.argtypes = [*_K4_ARGS, _P, _P, _IP, _P]
        lib.pio_k4_top_k.restype = _I
        lib.pio_k4_two_stage.argtypes = [
            *_K4_ARGS, _I, _P, _P, _I, _P, _I, _P, _P, _P, _I, _P, _L, _I, _P, _P, _P, _IP, _P,
        ]
        lib.pio_k4_two_stage.restype = _I
        lib.pio_k5_rescore_top_k.argtypes = [
            _I, _P, _P, _I, _P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P,
            _IP, _P,
        ]
        lib.pio_k5_rescore_top_k.restype = _I
        lib.pio_globaltimer_tick.argtypes = [_I, _P, _IP, _P]
        lib.pio_globaltimer_tick.restype = _I
        lib._pio_typed = True
    return lib


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNT[index]


def coarse_topk(queries: torch.Tensor, tiles: torch.Tensor, scales, num_rows: int,
                k: int, mode: str):
    """K4: the best ``k`` coarse scores of each query row over a tiled
    coarse catalog, and their row ids.

    ``queries``: ``[B, D]`` f32; ``tiles``: ``[NT, T, D]`` int8 (modes
    ``int8``, ``int8_dot``, with ``scales`` ``[NT, T]`` f32) or bf16 (mode
    ``bf16``, ``scales`` None), rows from ``num_rows`` on padding.
    Returns ``([B, k] f32 scores, [B, k] int32 ids)`` in ``lax.top_k``
    order (score by IEEE total order descending, the lower id first on a
    tie), ``(NEG_INF, -1)`` where fewer than k rows score above
    ``NEG_INF``. CPU tensors take :func:`coarse_topk_reference`; CUDA
    tensors launch the route :func:`k4_route` picks (``csrc/retrieval.cu``,
    :func:`k4_plan`) or raise."""
    if mode not in MODES:
        raise ValueError(f"unknown coarse mode {mode!r}")
    if tiles.device.type == "cpu":
        return coarse_topk_reference(queries, tiles, scales, num_rows, k, mode)
    return _coarse_on_card(None, coarse_topk, queries, tiles, scales, num_rows, k, mode)


def _coarse_topk_stream(queries: torch.Tensor, tiles: torch.Tensor, scales,
                        num_rows: int, k: int, mode: str):
    """K4's stream route at any k' <= :data:`K4_MAX_K`, whatever
    :func:`k4_route` picks: the warp route's same-run comparison in
    chip_smoke.py. CUDA tensors only; counts its calls on itself."""
    if mode not in MODES:
        raise ValueError(f"unknown coarse mode {mode!r}")
    return _coarse_on_card("stream", _coarse_topk_stream, queries, tiles, scales, num_rows,
                           k, mode)


def _coarse_topk_pair(queries: torch.Tensor, tiles: torch.Tensor, scales,
                      num_rows: int, k: int, mode: str):
    """K4's pair, the two-launch stream route this design replaced
    (``coarse_tile_kernel`` + ``coarse_merge_kernel``), at any k' <=
    :data:`K4_MAX_K`: the same-run baseline of chip_smoke.py; nothing on
    the serving path calls it. CUDA tensors only; counts its calls on
    itself."""
    if mode not in MODES:
        raise ValueError(f"unknown coarse mode {mode!r}")
    return _coarse_on_card("pair", _coarse_topk_pair, queries, tiles, scales, num_rows, k, mode)


def _count_calls(fn, routes=ROUTES) -> None:
    fn.launches = _build.LaunchCount()
    fn.modes = {m: _build.LaunchCount() for m in MODES}
    fn.routes = {r: _build.LaunchCount() for r in routes}
    fn.kernel_launches = _build.LaunchCount()


_count_calls(coarse_topk)
_count_calls(_coarse_topk_stream)
_count_calls(_coarse_topk_pair, routes=("pair",))

_TICKETS: dict[tuple[int, int], torch.Tensor] = {}
_tickets_lock = threading.Lock()


def _tickets(device: torch.device, stream: int, groups: int, counter) -> torch.Tensor:
    """The one-launch routes' arrival tickets, one a query group, for
    calls on ``stream``: zeroed once when made (a launch, counted on
    ``counter``), then left zero by each call's merging blocks. Calls on
    one stream run in order, so they share them."""
    key = (device.index, stream)
    with _tickets_lock:
        t = _TICKETS.get(key)
        if t is None or t.numel() < groups:
            t = torch.zeros(max(groups, 64), dtype=torch.int32, device=device)
            counter.kernel_launches.add()
            _TICKETS[key] = t
        return t


def _k4_checked(queries, tiles, scales, num_rows: int, mode: str):
    """K4's inputs on the card, checked: (device, [B, D] f32 queries)."""
    device = tiles.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    want = torch.bfloat16 if mode == "bf16" else torch.int8
    if tiles.dtype != want or tiles.dim() != 3 or not tiles.is_contiguous():
        raise ValueError(f"K4 mode {mode} takes contiguous [NT, T, D] {want} tiles")
    if (scales is None) != (mode == "bf16") or (
        scales is not None and (scales.dtype != torch.float32 or scales.shape != tiles.shape[:2]
                                or not scales.is_contiguous() or scales.device != device)
    ):
        raise ValueError("K4: the int8 modes take contiguous [NT, T] f32 scales, bf16 none")
    nt, T, D = tiles.shape
    if not 1 <= num_rows <= nt * T:
        raise ValueError(f"num_rows {num_rows} outside the {nt * T} tile rows")
    q = queries.to(device=device, dtype=torch.float32).contiguous()
    if q.dim() != 2 or q.shape[1] != D:
        raise ValueError(f"queries must be [B, {D}]")
    return device, q


def _k4_plan_args(plan: K4Plan, q, tiles, scales, num_rows: int, mode: str, k: int,
                  ws, tickets) -> list:
    """The arguments pio_k4_top_k and pio_k4_two_stage share."""
    for name, t in (("tiles", tiles), ("scales", scales)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"K4's one-launch routes take 16-byte aligned {name}")
    nt, T, D = tiles.shape
    return [_ROUTE_CODE[plan.route], q.data_ptr(), q.shape[0], D, tiles.data_ptr(),
            topk_ops._ptr(scales), num_rows, nt * T, _MODE_CODE[mode], k, plan.rb, plan.nw,
            plan.W, plan.nblk, plan.stages, plan.mcols, ws.data_ptr(), tickets.data_ptr()]


def _coarse_on_card(route, counter, queries, tiles, scales, num_rows: int, k: int, mode: str):
    """K4 on CUDA tensors by ``route`` ("stream", "pair", or None: what
    :func:`k4_route` picks); one call counted on ``counter``."""
    device, q = _k4_checked(queries, tiles, scales, num_rows, mode)
    batch, D = q.shape
    k = int(k)
    plan = k4_plan(max(1, batch), num_rows, D, k, _sm_count(device), mode, route)
    scores = torch.empty((batch, k), dtype=torch.float32, device=device)
    ids = torch.empty((batch, k), dtype=torch.int32, device=device)
    if batch == 0:
        return scores, ids
    ws = torch.empty((batch, plan.nblk, plan.K), dtype=torch.int64, device=device)
    launched = ctypes.c_int(0)  # the C entry adds each kernel it launches
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if plan.route == "pair":
            err = lib.pio_k4_coarse_top_k(
                q.data_ptr(), batch, D, tiles.data_ptr(), topk_ops._ptr(scales), num_rows,
                _MODE_CODE[mode], k, plan.rb, plan.W, plan.nblk, plan.K, plan.S, plan.S2,
                ws.data_ptr(), scores.data_ptr(), ids.data_ptr(), ctypes.byref(launched), stream,
            )
        else:
            tickets = _tickets(device, stream, -(-batch // plan.rb), counter)
            err = lib.pio_k4_top_k(
                *_k4_plan_args(plan, q, tiles, scales, num_rows, mode, k, ws, tickets),
                scores.data_ptr(), ids.data_ptr(), ctypes.byref(launched), stream,
            )
    _build.check(err, f"coarse_topk ({mode}, {plan.route} route) launch")
    counter.launches.add()
    counter.modes[mode].add()
    counter.routes[plan.route].add()
    counter.kernel_launches.add(launched.value)
    return scores, ids


def k4_launches(k: int) -> int:
    """Kernel launches one K4 call on the card (alone, or fused with K5
    in :func:`two_stage_top_k`) adds to its wrapper's ``kernel_launches``
    once its stream's tickets exist: 1 on either route (scoring,
    selection and the merge -- and the rescore, fused -- in one
    launch). Raises above :data:`K4_MAX_K`."""
    k4_route(k)
    return 1


def _host_values(table) -> np.ndarray:
    """A factor table (numpy, :data:`BFLOAT16` bits, or a tensor on any
    device) as host numpy: bfloat16 as its exact float32 values."""
    if isinstance(table, torch.Tensor):
        t = table.detach().cpu()
        return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()
    a = host_array(np.asarray(table))
    if a.dtype == BFLOAT16:
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a


def _owned(a: np.ndarray) -> np.ndarray:
    """``a`` contiguous and writable (copied only if it is not), for
    ``torch.from_numpy``."""
    return np.require(a, requirements=["C", "W"])


class CoarseCatalog:
    """A catalog staged in tiled coarse form for the shortlist pass.

    Built once per (model, weights, device) from the serving factor
    table -- a dense ``[I, D]`` table or the int8 ``(values, scales)``
    pair, as numpy or tensors -- and cached by the templates beside their
    device tables. As in the JAX package, the tiles are made on the host
    in numpy and go to ``device`` in one upload: an int8 catalog keeps
    its quantized values; a dense one gets a bf16 copy (round to nearest
    even) or, in mode ``int8``, ``s = max|f| / 127`` per row (1 where
    that is 0) and ``rint(f / s)``. Pad rows past the catalog are zeros
    with scale 1. The quantization only costs shortlist coverage, never
    final score accuracy: the rescore reads the original table.

    ``mode`` None reads ``PIO_RETRIEVAL_COARSE``; ``auto`` picks ``int8``
    for an int8 catalog and ``bf16`` for a dense one (the JAX package's
    pick on any backend but a TPU). Tiles are ``[NT, T, D]``, ``T =
    min(tile, pow2(I))``; a row's id is its position, ``-1`` past the
    catalog (:meth:`ids`)."""

    def __init__(self, item_table, tile: int | None = None, mode: str | None = None,
                 device: torch.device | str = "cpu"):
        quantized = isinstance(item_table, tuple)
        vals = _host_values(item_table[0] if quantized else item_table)
        self.num_rows = int(vals.shape[0])
        self.dim = int(vals.shape[1])
        self.device = torch.device(device)
        if mode is None:
            mode = os.environ.get("PIO_RETRIEVAL_COARSE", "auto")
        if mode == "auto":
            mode = "int8" if quantized else "bf16"
        if mode not in MODES:
            raise ValueError(f"unknown coarse mode {mode!r}")
        self.mode = mode
        T = min(int(tile or tile_size()), _pow2(max(1, self.num_rows)))
        nt = -(-self.num_rows // T)
        pad = nt * T - self.num_rows
        self.tile = T
        if mode == "bf16":
            if quantized:
                f = np.asarray(vals, dtype=np.float32) * np.asarray(
                    _host_values(item_table[1]), np.float32)[:, None]
            else:
                f = np.asarray(vals, dtype=np.float32)
            if pad:
                f = np.concatenate([f, np.zeros((pad, self.dim), np.float32)])
            tiles = torch.from_numpy(_owned(f)).to(torch.bfloat16)
            self._tiles = tiles.reshape(nt, T, self.dim).to(self.device)
            self._scales = None
        else:
            if quantized:
                vq = np.asarray(vals, dtype=np.int8)
                vs = np.asarray(_host_values(item_table[1]), dtype=np.float32)
            else:
                f = np.asarray(vals, dtype=np.float32)
                s = np.max(np.abs(f), axis=1) / 127.0
                s = np.where(s > 0, s, 1.0).astype(np.float32)
                vq = np.rint(f / s[:, None]).astype(np.int8)
                vs = s
            if pad:
                vq = np.concatenate([vq, np.zeros((pad, self.dim), np.int8)])
                vs = np.concatenate([vs, np.ones(pad, np.float32)])
            self._tiles = torch.from_numpy(_owned(vq.reshape(nt, T, self.dim))).to(self.device)
            self._scales = torch.from_numpy(_owned(vs.reshape(nt, T))).to(self.device)

    def ids(self) -> np.ndarray:
        """``[NT, T]`` int32 row ids: the position, ``-1`` past the catalog
        (the JAX package's ``_ids``; the kernel derives them)."""
        nt, T = self._tiles.shape[:2]
        ids = np.arange(nt * T, dtype=np.int32)
        ids[self.num_rows:] = -1
        return ids.reshape(nt, T)

    def nbytes(self) -> int:
        """Device-resident coarse bytes (tiles + scales)."""
        n = self._tiles.numel() * self._tiles.element_size()
        if self._scales is not None:
            n += self._scales.numel() * 4
        return n

    def shortlist(self, queries, k: int):
        """Coarse top-k' candidate ids for a ``[B, D]`` f32 query batch ->
        (``[B, k']`` coarse scores, ``[B, k']`` int32 ids, ``-1`` past the
        catalog), tensors on the catalog's device. k' clamps to the tile
        width. B is not padded (the JAX package padded it for its compile
        cache; K4 takes any B, and rows are independent)."""
        t0 = time.perf_counter()
        q = torch.as_tensor(np.asarray(queries, dtype=np.float32)
                            if not isinstance(queries, torch.Tensor) else queries)
        q = q.to(device=self.device, dtype=torch.float32).contiguous()
        k = max(1, min(int(k), self.tile))
        s, ids = coarse_topk(q, self._tiles, self._scales, self.num_rows, k, self.mode)
        _sync(self.device)
        dt = time.perf_counter() - t0
        _m_shortlist_secs.observe(dt)
        _m_shortlist_size.observe(float(k))
        _note_stage("shortlist", dt)
        return s, ids


# -- K5: the exact rescore -----------------------------------------------------

QUERY_FORMS = ("gather", "vectors", "sum_rows")
_QUERY_CODE = {"gather": 0, "vectors": 1, "sum_rows": 2}


def _query_vectors_reference(form: str, item_factors, user_ixs, user_factors, vectors,
                             row_ixs, row_weights) -> torch.Tensor:
    """``[B, D]`` f32 query vectors as K2's plain version builds them."""
    values = item_factors[0] if isinstance(item_factors, tuple) else item_factors
    device = values.device
    if form == "gather":
        ixs = torch.as_tensor(user_ixs, device=device).to(torch.int64).reshape(-1)
        return topk_ops._dense_rows(user_factors, ixs)
    if form == "vectors":
        return torch.as_tensor(vectors, device=device).to(torch.float32)
    ixs = torch.as_tensor(row_ixs, device=device).to(torch.int64)
    w = torch.as_tensor(row_weights, device=device).to(torch.float32)
    rows = topk_ops._dense_rows(item_factors, ixs)  # [B, L, D]
    q = rows.new_zeros((rows.shape[0], rows.shape[2]))
    for l in range(rows.shape[1]):
        q = q + rows[:, l] * w[:, l, None]
    return q


def rescore_top_k_reference(form: str, item_factors, cand_ids, k: int, *, user_ixs=None,
                            user_factors=None, vectors=None, row_ixs=None,
                            row_weights=None):
    """The plain PyTorch version of K5, same contract as
    :func:`rescore_top_k`: K2's query vectors, the ``[B, S]`` candidate
    rows gathered (a -1 gathers row 0), scored with K2's arithmetic (d in
    order from +0.0, each product and partial sum rounded, times the int8
    scale after the sum), -1 slots at ``NEG_INF``, the top k in
    ``lax.top_k`` order on the row (ties keep shortlist order), ids -1
    where the score is not above ``NEG_INF / 2``."""
    values = item_factors[0] if isinstance(item_factors, tuple) else item_factors
    device = values.device
    qv = _query_vectors_reference(form, item_factors, user_ixs, user_factors, vectors,
                                  row_ixs, row_weights)
    cand = torch.as_tensor(cand_ids, device=device).to(torch.int32)
    rows_ix = cand.clamp_min(0).to(torch.int64)
    rows = values[rows_ix].to(torch.float32)  # [B, S, D]
    sc = rows.new_zeros(cand.shape)
    for d in range(rows.shape[2]):
        sc = sc + qv[:, d, None] * rows[:, :, d]
    if isinstance(item_factors, tuple):
        sc = sc * item_factors[1][rows_ix]
    sc = torch.where(cand >= 0, sc, NEG_INF)
    s, ix = topk_ops.top_k_rows_reference(sc, min(int(k), cand.shape[1]))
    ids = torch.gather(cand, 1, ix.to(torch.int64))
    return s, torch.where(s > NEG_INF / 2, ids, -1)


def _candidates(cand_ids, num_items: int, device: torch.device) -> torch.Tensor:
    """``[B, S]`` int32 candidate ids on ``device``; host ids are checked
    to lie in [-1, I)."""
    if isinstance(cand_ids, torch.Tensor) and cand_ids.device.type == "cuda":
        return cand_ids.to(device=device, dtype=torch.int32).contiguous()
    a = np.asarray(cand_ids.cpu() if isinstance(cand_ids, torch.Tensor) else cand_ids,
                   dtype=np.int64)
    if a.ndim != 2:
        raise ValueError(f"cand_ids must be [B, S], got shape {a.shape}")
    if a.size and (a.min() < -1 or a.max() >= num_items):
        raise IndexError(f"candidate id out of range [-1, {num_items})")
    return torch.from_numpy(a.astype(np.int32)).to(device)


class _Form(NamedTuple):
    """A K5 query form on the card, checked (the C entries' arguments)."""

    code: int
    ixs: torch.Tensor | None
    w: torch.Tensor | None
    L: int
    u_vals: torch.Tensor | None
    u_code: int
    u_scales: torch.Tensor | None
    vecs: torch.Tensor | None
    v_vals: torch.Tensor
    v_code: int
    v_scales: torch.Tensor | None
    rows: int  # query rows

    def args(self) -> list:
        return [self.code, topk_ops._ptr(self.ixs), topk_ops._ptr(self.w), self.L,
                topk_ops._ptr(self.u_vals), self.u_code, topk_ops._ptr(self.u_scales),
                topk_ops._ptr(self.vecs), self.v_vals.data_ptr(), self.v_code,
                topk_ops._ptr(self.v_scales)]


def _k5_form(form: str, item_factors, device: torch.device, user_ixs, user_factors, vectors,
             row_ixs, row_weights) -> _Form:
    """K5's query form and item table on ``device``, checked as
    :func:`rescore_top_k` takes them."""
    if form not in QUERY_FORMS:
        raise ValueError(f"unknown query form {form!r}")
    v_vals, v_scales, v_code = topk_ops._split(item_factors, "item_factors")
    topk_ops._on(device, v_vals, v_scales)
    num_items, rank = v_vals.shape
    ixs = w = u_vals = u_scales = vecs = None
    u_code, L = 0, 0
    if form == "gather":
        u_vals, u_scales, u_code = topk_ops._split(user_factors, "user_factors")
        topk_ops._on(device, u_vals, u_scales)
        if u_vals.shape[1] != rank:
            raise ValueError("user and item factors differ in rank")
        ixs = topk_ops._user_ixs(user_ixs, u_vals.shape[0], device)
        rows = ixs.shape[0]
    elif form == "vectors":
        vecs = torch.as_tensor(vectors, device=device).to(torch.float32).contiguous()
        if vecs.dim() != 2 or vecs.shape[1] != rank:
            raise ValueError(f"vectors must be [B, {rank}]")
        rows = vecs.shape[0]
    else:
        ixs = topk_ops._indices(row_ixs, num_items, device)
        if ixs.dim() != 2:
            raise ValueError(f"row_ixs must be [B, L], got shape {tuple(ixs.shape)}")
        rows, L = ixs.shape
        w = torch.as_tensor(row_weights, device=device).to(torch.float32).contiguous()
        if tuple(w.shape) != (rows, L):
            raise ValueError(f"row_weights must be [{rows}, {L}] like row_ixs")
    return _Form(_QUERY_CODE[form], ixs, w, L, u_vals, u_code, u_scales, vecs, v_vals, v_code,
                 v_scales, rows)


def rescore_top_k(form: str, item_factors, cand_ids, k: int, *, user_ixs=None,
                  user_factors=None, vectors=None, row_ixs=None, row_weights=None):
    """K5: the best ``k`` of each query row's shortlist by exact score.

    ``form`` names the query: ``"gather"`` (``user_ixs`` [B] rows of
    ``user_factors``), ``"vectors"`` (``vectors`` [B, D] f32) or
    ``"sum_rows"`` (``row_ixs`` [B, L] catalog rows weighted by
    ``row_weights`` [B, L]); tables as :func:`ops.topk.gather_top_k_batch`
    takes them. ``cand_ids``: [B, S] int ids, -1 for an empty slot. ``k``
    is capped at S. Returns ``([B, k] f32 scores, [B, k] int32 ids)``.
    CPU tensors take :func:`rescore_top_k_reference`; CUDA tensors
    launch ``csrc/retrieval.cu`` (one launch, ``rescore_kernel``) or
    raise. The serving path runs the same arithmetic fused into K4
    (:func:`two_stage_top_k`)."""
    if form not in QUERY_FORMS:
        raise ValueError(f"unknown query form {form!r}")
    values = item_factors[0] if isinstance(item_factors, tuple) else item_factors
    device = values.device
    if device.type == "cpu":
        return rescore_top_k_reference(
            form, item_factors, cand_ids, k, user_ixs=user_ixs, user_factors=user_factors,
            vectors=vectors, row_ixs=row_ixs, row_weights=row_weights)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    f = _k5_form(form, item_factors, device, user_ixs, user_factors, vectors, row_ixs,
                 row_weights)
    num_items, rank = f.v_vals.shape
    cand = _candidates(cand_ids, num_items, device)
    batch, width = cand.shape
    if width > K4_MAX_K:
        raise ValueError(f"K5 takes shortlists of up to {K4_MAX_K} ids, got {width}")
    if f.rows != batch:
        raise ValueError(f"{f.rows} queries for {batch} shortlist rows")
    k = min(int(k), width)
    scores = torch.empty((batch, k), dtype=torch.float32, device=device)
    ids = torch.empty((batch, k), dtype=torch.int32, device=device)
    if batch == 0 or k <= 0:
        return scores, ids
    launched = ctypes.c_int(0)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pio_k5_rescore_top_k(
            *f.args(), cand.data_ptr(), batch, width, _pow2(width), rank, k, scores.data_ptr(),
            ids.data_ptr(), ctypes.byref(launched), stream,
        )
    _build.check(err, f"rescore_top_k ({form}) launch")
    rescore_top_k.launches.add()
    rescore_top_k.queries[form].add()
    rescore_top_k.kernel_launches.add(launched.value)
    return scores, ids


rescore_top_k.launches = _build.LaunchCount()
rescore_top_k.queries = {f: _build.LaunchCount() for f in QUERY_FORMS}
rescore_top_k.kernel_launches = _build.LaunchCount()

for _mode, _count in coarse_topk.modes.items():
    obs_metrics.gauge(
        "pio_k4_calls", "K4 (coarse shortlist) calls on the card by mode, since "
        "the process started", mode=_mode,
    ).set_function(lambda c=_count: float(c.value))
for _route, _count in coarse_topk.routes.items():
    obs_metrics.gauge(
        "pio_k4_route_calls", "K4 (coarse shortlist) calls on the card by route, "
        "since the process started", route=_route,
    ).set_function(lambda c=_count: float(c.value))
for _form, _count in rescore_top_k.queries.items():
    obs_metrics.gauge(
        "pio_k5_calls", "K5 (shortlist rescore) calls on the card by query form, "
        "since the process started", query=_form,
    ).set_function(lambda c=_count: float(c.value))
for _name, _wrapper in (("pio_k4_kernel_launches", coarse_topk),
                        ("pio_k5_kernel_launches", rescore_top_k)):
    obs_metrics.gauge(
        _name, "Kernels the wrapper's calls launched on the card, as the C entry "
        "counts them",
    ).set_function(lambda c=_wrapper.kernel_launches: float(c.value))
del _mode, _route, _form, _count, _name, _wrapper


# -- the two stages in one call: the serving path ---------------------------------


def two_stage_top_k(catalog: CoarseCatalog, queries, kp: int, k: int, form: str,
                    item_factors, *, user_ixs=None, user_factors=None, vectors=None,
                    row_ixs=None, row_weights=None):
    """Two-stage retrieval of a query batch: K4's shortlist of ``kp``
    (k') candidates of ``catalog`` for the ``[B, D]`` coarse ``queries``,
    then K5's best ``k`` of them by exact score, the query in ``form``
    and the item table as :func:`rescore_top_k` takes them. Returns host
    ``([B, k] f32 scores, [B, k] int32 ids)``, as the shortlist followed
    by ``rescore_*_top_k_batch`` does. k' clamps to the catalog's tile
    width and k to k'.

    On the card it is ONE launch (``pio_k4_two_stage``: K5 runs as the
    epilogue of K4's merge, no host step between the stages), counted as
    one K4 call (``coarse_topk``'s mode and route) and one K5 call
    (``rescore_top_k.queries``), its launch on ``coarse_topk``'s
    ``kernel_launches``; the merging blocks time their epilogue on the
    card, so the stage split reads rescore = the largest query group's
    epilogue and shortlist = the call's host wall minus it. On the CPU it
    is :func:`coarse_topk_reference` then :func:`rescore_top_k_reference`,
    each timed. Either way the call counts
    ``pio_retrieval_queries_total{path="two_stage"}``, observes both
    stages' seconds and the shortlist size, and notes the split for the
    engine server's ``dispatch.shortlist`` / ``dispatch.rescore`` spans."""
    if form not in QUERY_FORMS:
        raise ValueError(f"unknown query form {form!r}")
    t0 = time.perf_counter()
    q = torch.as_tensor(np.asarray(queries, dtype=np.float32)
                        if not isinstance(queries, torch.Tensor) else queries)
    q = q.to(device=catalog.device, dtype=torch.float32).contiguous()
    kp = max(1, min(int(kp), catalog.tile))
    k = max(1, min(int(k), kp))
    query = dict(user_ixs=user_ixs, user_factors=user_factors, vectors=vectors,
                 row_ixs=row_ixs, row_weights=row_weights)
    if catalog.device.type == "cpu":
        _, cand = coarse_topk_reference(q, catalog._tiles, catalog._scales, catalog.num_rows,
                                        kp, catalog.mode)
        t1 = time.perf_counter()
        s, ids = rescore_top_k_reference(form, item_factors, cand, k, **query)
        s, ids = s.numpy(), ids.numpy()
        rescore = time.perf_counter() - t1
        shortlist = t1 - t0
    else:
        s, ids, epi_ns = _two_stage_on_card(catalog, q, kp, k, form, item_factors, query)
        rescore = epi_ns * 1e-9
        shortlist = max(0.0, time.perf_counter() - t0 - rescore)
    _m_shortlist_secs.observe(shortlist)
    _m_shortlist_size.observe(float(kp))
    _note_stage("shortlist", shortlist)
    _m_rescore_secs.observe(rescore)
    _note_stage("rescore", rescore)
    _m_two_stage.inc(len(s))
    return s, ids


two_stage_top_k.launches = _build.LaunchCount()  # fused calls on the card
two_stage_top_k.routes = {r: _build.LaunchCount() for r in ROUTES}
for _route, _count in two_stage_top_k.routes.items():
    obs_metrics.gauge(
        "pio_two_stage_calls", "two-stage calls on the card (K4 with K5 as its epilogue, one "
        "launch) by K4's route, since the process started", route=_route,
    ).set_function(lambda c=_count: float(c.value))
del _route, _count


def _two_stage_on_card(catalog: CoarseCatalog, q: torch.Tensor, kp: int, k: int, form: str,
                       item_factors, query: dict):
    """:func:`two_stage_top_k` on the card: host (scores, ids) and the
    largest query group's epilogue in nanoseconds. The outputs and the
    groups' timers share one buffer, so one copy brings them back."""
    device, q = _k4_checked(q, catalog._tiles, catalog._scales, catalog.num_rows, catalog.mode)
    f = _k5_form(form, item_factors, device, **query)
    batch, D = q.shape
    num_items = f.v_vals.shape[0]
    if f.v_vals.shape[1] != D:
        raise ValueError(f"the item table's rank {f.v_vals.shape[1]} is not the catalog's {D}")
    if catalog.num_rows > num_items:
        raise ValueError(f"a catalog of {catalog.num_rows} rows over {num_items} items")
    if f.rows != batch:
        raise ValueError(f"{f.rows} queries for {batch} coarse query rows")
    mode = catalog.mode
    plan = k4_plan(max(1, batch), catalog.num_rows, D, kp, _sm_count(device), mode,
                   v_dtype=f.v_code)
    groups = -(-batch // plan.rb)
    out = torch.empty(2 * batch * k + 2 * groups, dtype=torch.int32, device=device)
    if batch == 0:
        empty = np.zeros((0, k), np.float32)
        return empty, empty.astype(np.int32), 0
    ws = torch.empty((batch, plan.nblk, plan.K), dtype=torch.int64, device=device)
    launched = ctypes.c_int(0)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        tickets = _tickets(device, stream, groups, coarse_topk)
        base = out.data_ptr()
        err = lib.pio_k4_two_stage(
            *_k4_plan_args(plan, q, catalog._tiles, catalog._scales, catalog.num_rows, mode, kp,
                           ws, tickets),
            *f.args(), num_items, k, base, base + 4 * batch * k, base + 8 * batch * k,
            ctypes.byref(launched), stream,
        )
    _build.check(err, f"two_stage_top_k ({mode}, {form}, {plan.route} route) launch")
    coarse_topk.launches.add()
    coarse_topk.modes[mode].add()
    coarse_topk.routes[plan.route].add()
    coarse_topk.kernel_launches.add(launched.value)
    rescore_top_k.launches.add()
    rescore_top_k.queries[form].add()
    two_stage_top_k.launches.add()
    two_stage_top_k.routes[plan.route].add()
    host = out.cpu().numpy()
    n = batch * k
    scores = host[:n].view(np.float32).reshape(batch, k)
    ids = host[n:2 * n].reshape(batch, k)
    return scores, ids, int(host[2 * n:].copy().view(np.int64).max())


def globaltimer_tick(device: torch.device, samples: int = 4096) -> int:
    """The smallest step of the card's ``%globaltimer`` one thread sees
    in ``samples`` reads, in nanoseconds: the resolution of the fused
    call's stage split."""
    out = torch.zeros(1, dtype=torch.int64, device=device)
    launched = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _lib().pio_globaltimer_tick(samples, out.data_ptr(), ctypes.byref(launched),
                                          torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "globaltimer_tick launch")
    return int(out.item())


def _finish_rescore(t0: float, out, n_queries: int):
    s, ids = out[0].cpu().numpy(), out[1].cpu().numpy()
    dt = time.perf_counter() - t0
    _m_rescore_secs.observe(dt)
    _note_stage("rescore", dt)
    _m_two_stage.inc(n_queries)
    return s, ids


def rescore_gather_top_k_batch(user_ixs, user_factors, item_factors, cand_ids, k: int):
    """Shortlist variant of ``gather_top_k_batch``: [B] user row indices
    + the device tables + a [B, S] candidate-id matrix instead of the
    whole catalog. The query vectors are gathered and dequantized as the
    exact path does, so the ranking equals the exact ranking restricted
    to the candidates. Returns host ``([B, k] scores, [B, k] ids)``."""
    t0 = time.perf_counter()
    out = rescore_top_k("gather", item_factors, cand_ids, k, user_ixs=user_ixs,
                        user_factors=user_factors)
    return _finish_rescore(t0, out, len(cand_ids))


def rescore_top_k_batch(user_vectors, item_factors, cand_ids, k: int):
    """Shortlist variant of ``top_k_items_batch``: [B, D] query vectors
    against a [B, S] candidate-id matrix."""
    t0 = time.perf_counter()
    out = rescore_top_k("vectors", item_factors, cand_ids, k, vectors=user_vectors)
    return _finish_rescore(t0, out, len(cand_ids))


def rescore_sum_rows_top_k_batch(row_ixs, row_weights, item_factors, cand_ids, k: int):
    """Shortlist variant of ``sum_rows_top_k_batch`` for the cosine
    templates: the query vector is the weighted sum of catalog rows
    (built on the device as the exact op builds it), scored against the
    [B, S] candidates only."""
    t0 = time.perf_counter()
    out = rescore_top_k("sum_rows", item_factors, cand_ids, k, row_ixs=row_ixs,
                        row_weights=row_weights)
    return _finish_rescore(t0, out, len(cand_ids))


def rescore_host(query_vectors, values, scales, cand_ids, k: int):
    """Host-side exact rescore for the mesh path: the ring coarse pass
    returns [B, S] global candidate ids; the exact factors live host-side
    in the model, and S is small, so the f32 gather + dot runs in numpy."""
    t0 = time.perf_counter()
    cand_ids = np.asarray(cand_ids, dtype=np.int32)
    cand = np.maximum(cand_ids, 0)
    rows = np.asarray(values)[cand].astype(np.float32)
    if scales is not None:
        rows *= np.asarray(scales, np.float32)[cand][..., None]
    sc = np.einsum(
        "bd,bsd->bs", np.asarray(query_vectors, np.float32), rows
    )
    sc[cand_ids < 0] = NEG_INF
    k = min(k, cand_ids.shape[1])
    order = np.argsort(-sc, axis=1, kind="stable")[:, :k]
    s = np.take_along_axis(sc, order, axis=1)
    ids = np.take_along_axis(cand_ids, order, axis=1)
    ids[s <= NEG_INF / 2] = -1
    return _finish_rescore(t0, (torch.from_numpy(s), torch.from_numpy(ids)), len(cand_ids))
