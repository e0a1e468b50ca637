// K2: fused gather -> score -> top-k for ALS serving, for Hopper (sm_90a).
//
// Replaces predictionio_tpu/ops/topk.py:90 gather_top_k_batch (a jax.jit
// XLA program: row gather, dequantize, [B, I] matmul, mask, lax.top_k),
// and, in its summed-rows mode (pio_k2_sum_rows_top_k), :135
// sum_rows_top_k_batch, the cosine templates' query: the weighted sum of
// several catalog rows, scored against the same catalog.
//
// What it computes, per query row b and catalog row i:
//   u_b      = float(U[ix_b]) (* u_scale[ix_b] for int8 storage)
//   s_bi     = sum_{d=0..D-1} u_bd * float(V[i, d])   (f32, d in order,
//              each product and each partial sum rounded: no FMA)
//   s_bi    *= v_scale[i]                              (int8 catalogs)
//   s_bi     = -1e30 where exclude_mask[i]
//   result_b = the k largest s_bi by the order-preserving int key
//              key = bits < 0 ? bits ^ 0x7FFFFFFF : bits (IEEE total
//              order: NaN above +inf, +0 above -0), descending, lower
//              index first on equal keys -- jax.lax.top_k's order.
// Summed-rows mode: the query row is not a row of U but
//   u_bd     = sum_{l=0..L-1} deq(V[ix_bl, d]) * w_bl
//              (deq: float(q) * v_scale[ix] for int8, a cast otherwise;
//              each product and partial sum rounded, l in order from
//              +0.0, zero weights multiplied in, never skipped)
// and the scores follow as above. One thread sums each (b, d), so a
// query's bits do not depend on the batch (batch invariance) nor on
// weight-0 padding of its row list (padding invariance: +0.0 products).
//
// What bounds it on an H100: reading the catalog once, I*D*bytes (ML-20M
// shape, rank 20: 2.14 MB f32, 1.07 MB bf16, 0.53 MB + 0.11 MB scales
// int8) against 3.35 TB/s, plus 2*B*I*D FP32 operations (the summed-rows
// mode adds 2*B*L*D). The whole catalog fits in the 50 MB L2, and a
// served query (B = 1) needs 0.6 us of bytes: in practice it is bound by
// launch latency and by how many SMs the call keeps busy.
//
// Two routes, picked per call by ops/topk.py k2_route (k, I, B):
//
// The tile route, k <= TILE_MAX_K (every serving call of the templates):
//   launch 1, tile_topk_kernel: one 128-thread block per (tile of W
//     items, 8 query rows). It scores its tile 128 items at a time with
//     the arithmetic above (one thread an item, 8 accumulators, d in
//     order) and turns each score into the unique 64-bit composite
//     order_key(s) << 32 | ~i. Each warp then takes a query row's 128
//     composites into registers (4 a lane) and selects with bitonic
//     networks of shuffles and in-register swaps -- no shared memory, no
//     block barrier. For g <= 32 (g = the power of two >= k) it sorts
//     groups of g lanes, merges adjacent groups (the flip form: compare
//     x with x ^ (2g - 1), then x ^ g/2, ..., x ^ 1), which leaves each
//     pair's top g in its first group, and packs the surviving groups of
//     four registers into two, then one, until one group is left: a few
//     dozen stages instead of a full sort's 28 on four registers. Larger
//     g sort all 128 (the tile's list then waits in shared memory). A tile of several chunks folds each chunk's top
//     into the tile's: the elementwise max of one sorted list and the
//     other reversed holds the top of both as a bitonic sequence (the
//     half-cleaner), which a bitonic merge sorts. The block writes each
//     row's top g to a [B, T, g] u64 workspace. In summed-rows mode the block sums its own query rows
//     while it stages them, each (b, d) by one thread as above: no [B, D]
//     scratch and no launch of its own.
//   launch 2, merge_topk_kernel: one 32-warp block per query row. Every
//     load goes out first: for g <= 32 the block reads the row's T * g
//     composites in order, 1,024 a round, so a warp's register holds
//     32 / g whole lists, which the same group networks reduce to their
//     top g; larger g give warp w lists w, w + 32, .... Each warp folds
//     what it holds into one list, and the warps' lists fold pairwise
//     through shared memory, 16, 8, ..., 1. Composite 0 pads (~i != 0
//     for i < 2^31, so no item has it). Composites are unique, so the top
//     k of the tiles' top k's is the row's top k, in lax.top_k order, and
//     the fixed fold order makes the merge deterministic. The score comes
//     back from the composite (order_key is a bijection of the f32 bits):
//     nothing reads scores.
//   So the [B, I] scores never reach device memory, B = 1 keeps every SM
//   busy (I = 26,744 at W = 128: 209 blocks on 132 SMs), and the merge
//   does O(T * g) work over 32 warps instead of five passes over I. W is
//   the narrowest multiple of 128 whose T lists of g hold at most
//   MERGE_CAP composites: 128 for k <= 64 at I = 26,744, 256 at k = 128.
//
// The select route, k > TILE_MAX_K (and top_k_rows, scores made elsewhere):
//   launch 1, score_kernel: as launch 1 above without the selection,
//     writing the scores to a [B, I] f32 scratch the wrapper allocates.
//   launch 2, select_kernel: one 1024-thread block per query row. A
//     4-pass 8-bit radix select over the ordered key finds the k-th key;
//     an ordered compaction (ballot scans, in index order) keeps every
//     key above it and the lowest-index keys equal to it, so exactly k
//     winners survive; winners are sorted on the composite -- bitonic in
//     shared memory up to 2048, past that each winner's rank is counted
//     against all the others.
//   Summed-rows mode adds launch 0, sum_rows_kernel: one block per query
//   row, one thread per factor dim, writing the [B, D] f32 query rows to
//   a scratch that launch 1 reads as its U (identity row indices).
// Both routes compute every score with the same operations in the same
// order, so they agree with each other and with the plain version bit
// for bit.
//
// Cosine mode (pio_k2_cosine_top_k; ops/topk.py top_k_similar, replacing
// predictionio_tpu/ops/topk.py:247): dense f32 query rows, and each score
// divided by a per-item divisor before ordering,
//   s_bi     = s_bi / max(norms[i] * qnorms[b], 1e-12)
// (one rounded product, fmaxf, one IEEE division: __fdiv_rn, never a
// reciprocal multiply), the int8 values read without their scales
// (cosine drops a positive per-row scale), masked to -1e30 after the
// division. Both routes take it: the tile route at k <= 128, score_kernel
// + select_kernel above. The existing modes pass null norms and compute
// exactly what they did.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_I = 128;       // items per score block, one per thread
constexpr int TILE_B = 8;         // query rows per score block
constexpr int CHUNK_D = 32;       // factor dims staged per step
constexpr int SEL_THREADS = 1024; // threads of a select block
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int SORT_CAP = 2048;    // k up to this sorts in shared memory
constexpr int TILE_MAX_K = 128;   // k up to this takes the tile route
constexpr int MERGE_CAP = 16384;  // composites one row's merge takes, at most
constexpr int MERGE_THREADS = 1024;
constexpr int MERGE_WARPS = MERGE_THREADS / 32;
constexpr int CHUNK_E = TILE_I / 32;           // a chunk's composites per lane
constexpr int SEL_WARPS_TILE = TILE_I / 32;    // warps of a tile block
constexpr int ROWS_PER_WARP = TILE_B / SEL_WARPS_TILE;
constexpr int GROUP_MAX_G = 32;   // g up to this selects by groups, else by a full sort
constexpr float NEG_INF = -1e30f; // ops/topk.py NEG_INF

enum DType { F32 = 0, BF16 = 1, I8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// The cosine mode's score: the dot over max(||v_i|| * ||q_b||, 1e-12),
// each operation rounded once (jnp's `(f32 @ v) / jnp.maximum(denom,
// 1e-12)`).
__device__ __forceinline__ float cosine_div(float dot, float norm, float qnorm) {
  return __fdiv_rn(dot, fmaxf(__fmul_rn(norm, qnorm), 1e-12f));
}

template <typename TU, typename TV>
__global__ void __launch_bounds__(TILE_I)
score_kernel(const int* __restrict__ user_ixs, int B,
             const TU* __restrict__ U, const float* __restrict__ u_scales,
             const TV* __restrict__ V, const float* __restrict__ v_scales,
             const uint8_t* __restrict__ mask, int I, int D,
             const float* __restrict__ norms, const float* __restrict__ qnorms,
             float* __restrict__ scores) {
  __shared__ float su[TILE_B][CHUNK_D];
  __shared__ float sv[CHUNK_D][TILE_I + 1];  // +1: conflict-free staging
  __shared__ int rows[TILE_B];
  const int t = threadIdx.x;
  const int i0 = blockIdx.x * TILE_I;
  const int b0 = blockIdx.y * TILE_B;
  const int nb = min(TILE_B, B - b0);
  // user_ixs NULL: U holds the query rows themselves, in batch order
  if (t < TILE_B)
    rows[t] = t < nb ? (user_ixs != nullptr ? user_ixs[b0 + t] : b0 + t) : 0;
  float acc[TILE_B];
#pragma unroll
  for (int bb = 0; bb < TILE_B; ++bb) acc[bb] = 0.0f;
  __syncthreads();
  for (int d0 = 0; d0 < D; d0 += CHUNK_D) {
    const int dc = min(CHUNK_D, D - d0);
    for (int e = t; e < TILE_I * dc; e += TILE_I) {
      const int it = e / dc, dd = e - it * dc;
      const int ii = i0 + it;
      sv[dd][it] = ii < I ? to_f32(V[(size_t)ii * D + d0 + dd]) : 0.0f;
    }
    for (int e = t; e < TILE_B * dc; e += TILE_I) {
      const int bb = e / dc, dd = e - bb * dc;
      float u = 0.0f;
      if (bb < nb) {
        const int r = rows[bb];
        u = to_f32(U[(size_t)r * D + d0 + dd]);
        if (u_scales != nullptr) u = u * u_scales[r];
      }
      su[bb][dd] = u;
    }
    __syncthreads();
    for (int dd = 0; dd < dc; ++dd) {
      const float v = sv[dd][t];
      // round the product, then the sum (never contracted to an FMA):
      // the plain version's arithmetic, so the two agree bit for bit
#pragma unroll
      for (int bb = 0; bb < TILE_B; ++bb)
        acc[bb] = __fadd_rn(acc[bb], __fmul_rn(su[bb][dd], v));
    }
    __syncthreads();
  }
  const int i = i0 + t;
  if (i >= I) return;
  const bool masked = mask != nullptr && mask[i] != 0;
  const float vs = v_scales != nullptr ? v_scales[i] : 1.0f;
  const float nrm = norms != nullptr ? norms[i] : 0.0f;
#pragma unroll
  for (int bb = 0; bb < TILE_B; ++bb) {
    if (bb < nb) {
      float s = v_scales != nullptr ? acc[bb] * vs : acc[bb];
      if (norms != nullptr) s = cosine_div(s, nrm, qnorms[b0 + bb]);
      scores[(size_t)(b0 + bb) * I + i] = masked ? NEG_INF : s;
    }
  }
}

// Launch 0 of the summed-rows mode: q[b, d] = sum_l deq(V[ix[b, l], d]) * w[b, l].
template <typename TV>
__global__ void sum_rows_kernel(const int* __restrict__ row_ixs,
                                const float* __restrict__ row_w, int L,
                                const TV* __restrict__ V,
                                const float* __restrict__ v_scales, int D,
                                float* __restrict__ qvec) {
  const int b = blockIdx.x;
  const int* ix = row_ixs + (size_t)b * L;
  const float* w = row_w + (size_t)b * L;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float q = 0.0f;
    for (int l = 0; l < L; ++l) {
      const int r = ix[l];
      float v = to_f32(V[(size_t)r * D + d]);
      if (v_scales != nullptr) v = __fmul_rn(v, v_scales[r]);
      q = __fadd_rn(q, __fmul_rn(v, w[l]));
    }
    qvec[(size_t)b * D + d] = q;
  }
}

// Unsigned image of the signed order key: unsigned compare == key compare.
__device__ __forceinline__ uint32_t order_key(float x) {
  const int b = __float_as_int(x);
  const int key = b < 0 ? (b ^ 0x7FFFFFFF) : b;
  return (uint32_t)key ^ 0x80000000u;
}

// Block-wide exclusive rank of `flag` among the block's threads (thread
// order) and the block's total. Every thread of the block must call it.
__device__ __forceinline__ void block_rank(bool flag, unsigned int* warp_tot,
                                           unsigned int* total,
                                           unsigned int* rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned int bal = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_tot[warp] = __popc(bal);
  __syncthreads();
  if (warp == 0) {
    const unsigned int v = warp_tot[lane];  // SEL_WARPS == 32
    unsigned int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned int n = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += n;
    }
    warp_tot[lane] = incl - v;
    if (lane == 31) warp_tot[SEL_WARPS] = incl;
  }
  __syncthreads();
  *rank = warp_tot[warp] + __popc(bal & ((1u << lane) - 1u));
  *total = warp_tot[SEL_WARPS];
  __syncthreads();  // warp_tot is reused by the next call
}

__global__ void __launch_bounds__(SEL_THREADS)
select_kernel(const float* __restrict__ scores, int I, int k,
              unsigned long long* __restrict__ cand,
              float* __restrict__ out_scores, int* __restrict__ out_ids) {
  __shared__ unsigned int hist[256];
  __shared__ unsigned int suffix[257];
  __shared__ unsigned int sel[2];
  __shared__ unsigned int warp_tot[SEL_WARPS + 1];
  __shared__ unsigned long long sorted[SORT_CAP];
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const float* row = scores + (size_t)b * I;
  unsigned long long* crow = cand + (size_t)b * k;

  // 1. radix select, most significant digit first: `prefix` converges to
  // the k-th largest key; `remaining` counts the winners still to be
  // found among the keys that share the prefix.
  uint32_t prefix = 0, pmask = 0;
  unsigned int remaining = (unsigned int)k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (t < 256) hist[t] = 0;
    __syncthreads();
    for (int j = t; j < I; j += SEL_THREADS) {
      const uint32_t u = order_key(row[j]);
      if ((u & pmask) == prefix) atomicAdd(&hist[(u >> shift) & 0xFFu], 1u);
    }
    __syncthreads();
    if (t < 256) suffix[t] = hist[t];
    if (t == 0) suffix[256] = 0;
    __syncthreads();
    for (int off = 1; off < 256; off <<= 1) {  // suffix[d] = #digits >= d
      unsigned int v = 0;
      if (t + off < 256) v = suffix[t + off];
      __syncthreads();
      if (t < 256) suffix[t] += v;
      __syncthreads();
    }
    if (t < 256 && suffix[t] >= remaining && suffix[t + 1] < remaining) {
      sel[0] = (unsigned int)t;
      sel[1] = suffix[t + 1];
    }
    __syncthreads();
    prefix |= sel[0] << shift;
    pmask |= 0xFFu << shift;
    remaining -= sel[1];
    __syncthreads();
  }
  const uint32_t kth = prefix;
  const unsigned int need_eq = remaining;  // keys == kth to keep, >= 1

  // 2. ordered compaction: every key above kth, and the need_eq lowest
  // indices whose key equals kth -- exactly k winners.
  unsigned int eq_base = 0, out_base = 0;
  for (int j0 = 0; j0 < I && out_base < (unsigned int)k; j0 += SEL_THREADS) {
    const int j = j0 + t;
    const bool valid = j < I;
    const uint32_t u = valid ? order_key(row[j]) : 0u;
    const bool eq = valid && u == kth;
    unsigned int eq_rank, eq_total, win_rank, win_total;
    block_rank(eq, warp_tot, &eq_total, &eq_rank);
    const bool win = valid && (u > kth || (eq && eq_base + eq_rank < need_eq));
    block_rank(win, warp_tot, &win_total, &win_rank);
    if (win) {
      crow[out_base + win_rank] =
          ((unsigned long long)u << 32) | (unsigned long long)(~(uint32_t)j);
    }
    eq_base += eq_total;
    out_base += win_total;
  }
  __syncthreads();

  // 3. order the winners: composite descending == key descending, then
  // index ascending. Composites are unique, and 0 is never a winner's.
  if (k <= SORT_CAP) {
    int n2 = 1;
    while (n2 < k) n2 <<= 1;
    for (int j = t; j < n2; j += SEL_THREADS) sorted[j] = j < k ? crow[j] : 0ull;
    __syncthreads();
    for (int size = 2; size <= n2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int p = t; p < n2 / 2; p += SEL_THREADS) {
          const int lo = 2 * stride * (p / stride) + (p % stride);
          const int hi = lo + stride;
          const bool desc = (lo & size) == 0;
          const unsigned long long a = sorted[lo], c = sorted[hi];
          if (desc ? (a < c) : (a > c)) {
            sorted[lo] = c;
            sorted[hi] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int j = t; j < k; j += SEL_THREADS) {
      const int idx = (int)(~(uint32_t)sorted[j]);
      out_ids[(size_t)b * k + j] = idx;
      out_scores[(size_t)b * k + j] = row[idx];
    }
  } else {
    for (int w0 = 0; w0 < k; w0 += SEL_THREADS) {
      const int w = w0 + t;
      const unsigned long long mine = w < k ? crow[w] : 0ull;
      unsigned int rank = 0;
      for (int c0 = 0; c0 < k; c0 += SORT_CAP) {
        const int cn = min(SORT_CAP, k - c0);
        __syncthreads();
        for (int j = t; j < cn; j += SEL_THREADS) sorted[j] = crow[c0 + j];
        __syncthreads();
        if (w < k) {
          for (int j = 0; j < cn; ++j) rank += sorted[j] > mine ? 1u : 0u;
        }
      }
      if (w < k) {
        const int idx = (int)(~(uint32_t)mine);
        out_ids[(size_t)b * k + rank] = idx;
        out_scores[(size_t)b * k + rank] = row[idx];
      }
    }
  }
}

// -- the tile route ----------------------------------------------------------

typedef unsigned long long u64;

static_assert(TILE_MAX_K <= TILE_I, "a tile keeps its top TILE_I entries");
static_assert(TILE_I == 128 && TILE_B % (TILE_I / 32) == 0, "4 registers a lane, rows split over warps");
static_assert(MERGE_CAP % (4 * MERGE_THREADS) == 0, "a merge lane loads whole lists");

// The unique composite of item i's score: key descending, then index
// ascending (~i), as one unsigned compare. 0 is no item's (~i != 0).
__device__ __forceinline__ u64 composite(float s, int i) {
  return ((u64)order_key(s) << 32) | (u64)(~(uint32_t)i);
}

// The score whose composite this is: order_key inverted. The signed key
// maps negative floats by bits ^ 0x7FFFFFFF, an involution on them.
__device__ __forceinline__ float composite_score(u64 c) {
  const int key = (int)((uint32_t)(c >> 32) ^ 0x80000000u);
  return __int_as_float(key < 0 ? (key ^ 0x7FFFFFFF) : key);
}

__device__ __forceinline__ int composite_index(u64 c) { return (int)(~(uint32_t)c); }

#include "warp_select.cuh"

struct TileArgs {
  const int* ixs;      // [B] user rows, or [B, L] catalog rows (summed)
  const float* row_w;  // [B, L] weights (summed), else null
  int L, B;
  const void* U;       // user table (unused when summed)
  const float* u_scales;
  const void* V;
  const float* v_scales;
  const uint8_t* mask;
  int I, D;
  int W;               // items a block keeps the top g of
  int g;               // power of two >= k, <= TILE_MAX_K
  u64* ws;             // [B, T, g] composites, T = gridDim.x
  const float* norms;  // cosine mode: [I] item norms, else null
  const float* qnorms; // cosine mode: [B] query norms
};

// e / d for 0 <= e < 2^16 and 1 <= d <= CHUNK_D by a multiply, with
// m = ceil(2^31 / d): e * m / 2^31 = e / d + e * (m * d - 2^31) / (d * 2^31),
// and e * (m * d - 2^31) < 2^16 * d < 2^31 keeps the floor exact.
__device__ __forceinline__ int div_small(int e, unsigned int m) {
  return (int)(((unsigned long long)e * m) >> 31);
}

// Launch 1 of the tile route (see the note at the top). 8 blocks an SM
// caps registers at 64 (a few bytes spill); at B = 64 that measured
// faster than 76 registers and 6 blocks an SM.
template <typename TU, typename TV, bool SUMMED>
__global__ void __launch_bounds__(TILE_I, 8) tile_topk_kernel(const TileArgs a) {
  __shared__ __align__(16) float su[TILE_B][CHUNK_D];
  // the chunk's items, staged for scoring; then its composites (cand)
  __shared__ __align__(16) unsigned char stage[CHUNK_D * (TILE_I + 1) * sizeof(float)];
  // the full-sort path's top 128 of each row so far, sorted
  __shared__ u64 best_s[TILE_B][TILE_I];
  __shared__ int rows[TILE_B];
  float (*sv)[TILE_I + 1] = reinterpret_cast<float (*)[TILE_I + 1]>(stage);  // +1: no conflicts
  u64 (*cand)[TILE_I] = reinterpret_cast<u64 (*)[TILE_I]>(stage);
  static_assert(sizeof(u64) * TILE_B * TILE_I <= sizeof(stage), "cand fits the staging buffer");
  // the grouped path's top g of each of the warp's rows so far, in lanes [0, g)
  u64 gbest[ROWS_PER_WARP];
  const TU* __restrict__ U = static_cast<const TU*>(a.U);
  const TV* __restrict__ V = static_cast<const TV*>(a.V);
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int tile = blockIdx.x;
  const int b0 = blockIdx.y * TILE_B;
  const int nb = min(TILE_B, a.B - b0);
  const int D = a.D, I = a.I, g = a.g;
  if (!SUMMED && t < TILE_B) rows[t] = t < nb ? a.ixs[b0 + t] : 0;
  __syncthreads();
  const int end = min(I, (tile + 1) * a.W);
  for (int c0 = tile * a.W; c0 < end; c0 += TILE_I) {
    float acc[TILE_B];
#pragma unroll
    for (int bb = 0; bb < TILE_B; ++bb) acc[bb] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += CHUNK_D) {
      const int dc = min(CHUNK_D, D - d0);
      const unsigned int m = (0x80000000u + dc - 1) / dc;
      for (int e = t; e < TILE_I * dc; e += TILE_I) {
        const int it = div_small(e, m), dd = e - it * dc;
        const int ii = c0 + it;
        sv[dd][it] = ii < I ? to_f32(V[(size_t)ii * D + d0 + dd]) : 0.0f;
      }
      // the query rows: staged once when D fits one step of CHUNK_D
      for (int e = t; e < TILE_B * dc && (D > CHUNK_D || c0 == tile * a.W); e += TILE_I) {
        const int bb = div_small(e, m), dd = e - bb * dc;
        float u = 0.0f;
        if (bb < nb) {
          if (SUMMED) {
            // sum_rows_kernel's sum: l in order from +0.0, each product
            // and partial sum rounded, zero weights multiplied in
            const int* ix = a.ixs + (size_t)(b0 + bb) * a.L;
            const float* w = a.row_w + (size_t)(b0 + bb) * a.L;
#pragma unroll 4
            for (int l = 0; l < a.L; ++l) {
              const int r = ix[l];
              float v = to_f32(V[(size_t)r * D + d0 + dd]);
              if (a.v_scales != nullptr) v = __fmul_rn(v, a.v_scales[r]);
              u = __fadd_rn(u, __fmul_rn(v, w[l]));
            }
          } else {
            const int r = rows[bb];
            u = to_f32(U[(size_t)r * D + d0 + dd]);
            if (a.u_scales != nullptr) u = u * a.u_scales[r];
          }
        }
        su[bb][dd] = u;
      }
      __syncthreads();
      // score_kernel's arithmetic: the product rounded, then the sum, d
      // in order; the query values four dims at a time (one broadcast)
      int dd = 0;
      for (; dd + 4 <= dc; dd += 4) {
        const float v0 = sv[dd][t], v1 = sv[dd + 1][t], v2 = sv[dd + 2][t], v3 = sv[dd + 3][t];
#pragma unroll
        for (int bb = 0; bb < TILE_B; ++bb) {
          const float4 q = *reinterpret_cast<const float4*>(&su[bb][dd]);
          float x = acc[bb];
          x = __fadd_rn(x, __fmul_rn(q.x, v0));
          x = __fadd_rn(x, __fmul_rn(q.y, v1));
          x = __fadd_rn(x, __fmul_rn(q.z, v2));
          acc[bb] = __fadd_rn(x, __fmul_rn(q.w, v3));
        }
      }
      for (; dd < dc; ++dd) {
        const float v = sv[dd][t];
#pragma unroll
        for (int bb = 0; bb < TILE_B; ++bb)
          acc[bb] = __fadd_rn(acc[bb], __fmul_rn(su[bb][dd], v));
      }
      __syncthreads();
    }
    const int i = c0 + t;
    const bool masked = i < I && a.mask != nullptr && a.mask[i] != 0;
    const float vs = i < I && a.v_scales != nullptr ? a.v_scales[i] : 1.0f;
    const float nrm = i < I && a.norms != nullptr ? a.norms[i] : 0.0f;
#pragma unroll
    for (int bb = 0; bb < TILE_B; ++bb) {
      if (bb < nb) {
        float s = a.v_scales != nullptr ? acc[bb] * vs : acc[bb];
        if (a.norms != nullptr) s = cosine_div(s, nrm, a.qnorms[b0 + bb]);
        cand[bb][t] = i < I ? composite(masked ? NEG_INF : s, i) : 0ull;
      }
    }
    __syncthreads();
    const bool first = c0 == tile * a.W;
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp + rr * SEL_WARPS_TILE;
      if (r < nb) {  // warp-uniform
        u64 c[CHUNK_E];
#pragma unroll
        for (int e = 0; e < CHUNK_E; ++e) c[e] = cand[r][lane + 32 * e];
        if (g <= GROUP_MAX_G) {
          // the chunk's top g: sort groups of g, merge adjacent groups,
          // packing four registers into two, then one (g = 32: one group
          // a register, so the registers fold pairwise)
          sort_groups<CHUNK_E>(c, lane, g);
          u64 top;
          if (g < 32) {
            merge_pairs<CHUNK_E>(c, lane, g);
            u64 two[2] = {pack_pairs(c[0], c[1], lane, g), pack_pairs(c[2], c[3], lane, g)};
            merge_pairs<2>(two, lane, g);
            top = top_of_groups(pack_pairs(two[0], two[1], lane, g), lane, g);
          } else {
            top = fold_group(fold_group(c[0], c[1], lane, g), fold_group(c[2], c[3], lane, g),
                             lane, g);
          }
          gbest[rr] = first ? top : fold_group(gbest[rr], top, lane, g);
        } else {
          warp_sort<CHUNK_E>(c, lane);
          if (!first) {  // this warp wrote the row's best_s, lane by lane
            u64 b[CHUNK_E];
#pragma unroll
            for (int e = 0; e < CHUNK_E; ++e) b[e] = best_s[r][lane + 32 * e];
            warp_fold<CHUNK_E>(b, c, lane);
#pragma unroll
            for (int e = 0; e < CHUNK_E; ++e) c[e] = b[e];
          }
          __syncwarp();
#pragma unroll
          for (int e = 0; e < CHUNK_E; ++e) best_s[r][lane + 32 * e] = c[e];
          __syncwarp();
        }
      }
    }
    __syncthreads();  // the staging buffer is rewritten by the next chunk
  }
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp + rr * SEL_WARPS_TILE;
    if (r < nb) {
      u64* out = a.ws + ((size_t)(b0 + r) * gridDim.x + tile) * g;
      if (g <= GROUP_MAX_G) {
        if (lane < g) out[lane] = gbest[rr];
      } else {
        for (int x = lane; x < g; x += 32) out[x] = best_s[r][x];
      }
    }
  }
}

// Launch 2 of the tile route: one 32-warp block per query row merges the
// row's T sorted lists of g and writes its top k, scores recovered from
// the keys. All of a row's loads go out first. For g <= 32 (E = 1) the
// block reads the row's T * g composites in order, 1,024 a round, so a
// warp's register holds 32 / g whole lists, which it reduces to their
// top g; the rounds fold into one list a warp. For g = 64, 128 (E = 2,
// 4) warp w takes lists w, w + 32, ... and folds them in order. Then
// the warps' lists fold pairwise through shared memory, 16, 8, ..., 1.
// Entries past the row's composites load as 0, which no item has. The
// fold order is fixed, so the merge is deterministic.
template <int E>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_topk_kernel(const u64* __restrict__ ws, int T, int g, int k,
                  float* __restrict__ out_scores, int* __restrict__ out_ids) {
  constexpr int LOADS = MERGE_CAP / MERGE_THREADS;  // registers a lane loads
  __shared__ u64 lists[MERGE_WARPS][32 * E];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const u64* src = ws + (size_t)blockIdx.x * T * g;
  const int total = T * g;
  u64 in[LOADS];
  u64 best[E];
  if constexpr (E == 1) {
#pragma unroll
    for (int r = 0; r < LOADS; ++r) {
      const int idx = r * MERGE_THREADS + threadIdx.x;
      in[r] = idx < total ? src[idx] : 0ull;
    }
    best[0] = top_of_groups(in[0], lane, g);
#pragma unroll
    for (int r = 1; r < LOADS; ++r) {
      if (r * MERGE_THREADS < total)  // block-uniform
        best[0] = fold_group(best[0], top_of_groups(in[r], lane, g), lane, g);
    }
  } else {
#pragma unroll
    for (int j = 0; j < LOADS / E; ++j) {
      const int t = warp + j * MERGE_WARPS;
#pragma unroll
      for (int e = 0; e < E; ++e)
        in[j * E + e] = t < T && lane + 32 * e < g ? src[(size_t)t * g + lane + 32 * e] : 0ull;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) best[e] = in[e];
#pragma unroll
    for (int j = 1; j < LOADS / E; ++j) {
      if (warp + j * MERGE_WARPS < T) {  // warp-uniform
        u64 cur[E];
#pragma unroll
        for (int e = 0; e < E; ++e) cur[e] = in[j * E + e];
        warp_fold<E>(best, cur, lane);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) lists[warp][lane + 32 * e] = best[e];
  __syncthreads();
  for (int half = MERGE_WARPS / 2; half > 0; half >>= 1) {
    if (warp < half) {
      u64 other[E];
#pragma unroll
      for (int e = 0; e < E; ++e) other[e] = lists[warp + half][lane + 32 * e];
      if constexpr (E == 1)
        best[0] = fold_group(best[0], other[0], lane, g);
      else
        warp_fold<E>(best, other, lane);
#pragma unroll
      for (int e = 0; e < E; ++e) lists[warp][lane + 32 * e] = best[e];
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < k; j += MERGE_THREADS) {
    const u64 c = lists[0][j];
    out_ids[(size_t)blockIdx.x * k + j] = composite_index(c);
    out_scores[(size_t)blockIdx.x * k + j] = composite_score(c);
  }
}

// The error of the launch just made; one more on *launched if it went out.
// Every launch of the C entries below goes through here, so *launched is
// the count of kernels a call really launched (ops/topk.py reads it).
cudaError_t counted(int* launched) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

template <typename TU, typename TV, bool SUMMED>
cudaError_t launch_tile(const TileArgs& a, int T, cudaStream_t s, int* launched) {
  const dim3 grid(T, (a.B + TILE_B - 1) / TILE_B);
  tile_topk_kernel<TU, TV, SUMMED><<<grid, TILE_I, 0, s>>>(a);
  return counted(launched);
}

template <typename TU>
cudaError_t launch_tile_u(int v_dtype, const TileArgs& a, int T, cudaStream_t s,
                          int* launched) {
  switch (v_dtype) {
    case F32: return launch_tile<TU, float, false>(a, T, s, launched);
    case BF16: return launch_tile<TU, __nv_bfloat16, false>(a, T, s, launched);
    case I8: return launch_tile<TU, int8_t, false>(a, T, s, launched);
    default: return cudaErrorInvalidValue;
  }
}

// T for a valid tile-route call, else 0: k <= TILE_MAX_K, g the power of
// two >= k, W a positive multiple of TILE_I, and T lists of g holding at
// most MERGE_CAP composites (ops/topk.py k2_route picks such W).
int tile_count(int B, int I, int D, int k, int W, int* g_out) {
  if (B <= 0 || I <= 0 || D <= 0 || k <= 0 || k > I || k > TILE_MAX_K) return 0;
  if (W <= 0 || W % TILE_I != 0) return 0;
  int g = 1;
  while (g < k) g <<= 1;
  const int T = (int)(((long long)I + W - 1) / W);
  if ((long long)T * g > MERGE_CAP) return 0;
  *g_out = g;
  return T;
}

cudaError_t launch_merge(const TileArgs& a, int T, int k, float* out_scores,
                         int* out_ids, cudaStream_t s, int* launched) {
  if (a.g <= 32)
    merge_topk_kernel<1><<<a.B, MERGE_THREADS, 0, s>>>(a.ws, T, a.g, k, out_scores, out_ids);
  else if (a.g <= 64)
    merge_topk_kernel<2><<<a.B, MERGE_THREADS, 0, s>>>(a.ws, T, a.g, k, out_scores, out_ids);
  else
    merge_topk_kernel<4><<<a.B, MERGE_THREADS, 0, s>>>(a.ws, T, a.g, k, out_scores, out_ids);
  return counted(launched);
}

template <typename TU>
cudaError_t launch_score_u(int v_dtype, dim3 grid, cudaStream_t stream,
                           const int* ixs, int B, const void* U,
                           const float* us, const void* V, const float* vs,
                           const uint8_t* mask, int I, int D, float* scores,
                           int* launched, const float* norms = nullptr,
                           const float* qnorms = nullptr) {
  const TU* u = static_cast<const TU*>(U);
  switch (v_dtype) {
    case F32:
      score_kernel<TU, float><<<grid, TILE_I, 0, stream>>>(
          ixs, B, u, us, static_cast<const float*>(V), vs, mask, I, D, norms, qnorms,
          scores);
      return counted(launched);
    case BF16:
      score_kernel<TU, __nv_bfloat16><<<grid, TILE_I, 0, stream>>>(
          ixs, B, u, us, static_cast<const __nv_bfloat16*>(V), vs, mask, I, D, norms,
          qnorms, scores);
      return counted(launched);
    case I8:
      score_kernel<TU, int8_t><<<grid, TILE_I, 0, stream>>>(
          ixs, B, u, us, static_cast<const int8_t*>(V), vs, mask, I, D, norms, qnorms,
          scores);
      return counted(launched);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Every entry adds the kernels it launches to *launched (host memory,
// not null) and returns the first launch error, or cudaSuccess.

// Top-k of each row of a [B, I] f32 score matrix (launch 2 alone).
// cand: [B, k] u64 scratch.
int pio_k2_select(const float* scores, int B, int I, int k, void* cand,
                  float* out_scores, int* out_ids, int* launched, void* stream) {
  if (B <= 0 || I <= 0 || k <= 0 || k > I || launched == nullptr)
    return (int)cudaErrorInvalidValue;
  select_kernel<<<B, SEL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      scores, I, k, static_cast<unsigned long long*>(cand), out_scores,
      out_ids);
  return (int)counted(launched);
}

// The summed-rows K2 call: sum_rows_kernel into `qvec` ([B, D] f32
// scratch), score_kernel against V into `scores` ([B, I] f32 scratch),
// then select_kernel. row_ixs, row_w: [B, L]. v_scales / mask may be
// null.
int pio_k2_sum_rows_top_k(const int* row_ixs, const float* row_w, int B, int L,
                          const void* V, int v_dtype, const float* v_scales,
                          const uint8_t* mask, int I, int D, int k, float* qvec,
                          float* scores, void* cand, float* out_scores,
                          int* out_ids, int* launched, void* stream) {
  if (B <= 0 || L < 0 || I <= 0 || D <= 0 || k <= 0 || k > I || launched == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((v_dtype == I8) != (v_scales != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = D < 128 ? ((D + 31) / 32) * 32 : 128;
  switch (v_dtype) {
    case F32:
      sum_rows_kernel<float><<<B, threads, 0, s>>>(
          row_ixs, row_w, L, static_cast<const float*>(V), v_scales, D, qvec);
      break;
    case BF16:
      sum_rows_kernel<__nv_bfloat16><<<B, threads, 0, s>>>(
          row_ixs, row_w, L, static_cast<const __nv_bfloat16*>(V), v_scales, D, qvec);
      break;
    case I8:
      sum_rows_kernel<int8_t><<<B, threads, 0, s>>>(
          row_ixs, row_w, L, static_cast<const int8_t*>(V), v_scales, D, qvec);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = counted(launched);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((I + TILE_I - 1) / TILE_I, (B + TILE_B - 1) / TILE_B);
  err = launch_score_u<float>(v_dtype, grid, s, nullptr, B, qvec, nullptr, V,
                              v_scales, mask, I, D, scores, launched);
  if (err != cudaSuccess) return (int)err;
  return pio_k2_select(scores, B, I, k, cand, out_scores, out_ids, launched, stream);
}

// The fused K2 call: score_kernel into `scores` ([B, I] f32 scratch), then
// select_kernel. u_scales / v_scales / mask may be null. dtype codes:
// 0 f32, 1 bf16, 2 int8.
int pio_k2_gather_top_k(const int* user_ixs, int B, const void* U, int u_dtype,
                        const float* u_scales, const void* V, int v_dtype,
                        const float* v_scales, const uint8_t* mask, int I,
                        int D, int k, float* scores, void* cand,
                        float* out_scores, int* out_ids, int* launched,
                        void* stream) {
  if (B <= 0 || I <= 0 || D <= 0 || k <= 0 || k > I || launched == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((I + TILE_I - 1) / TILE_I, (B + TILE_B - 1) / TILE_B);
  cudaError_t err;
  switch (u_dtype) {
    case F32:
      err = launch_score_u<float>(v_dtype, grid, s, user_ixs, B, U, u_scales,
                                  V, v_scales, mask, I, D, scores, launched);
      break;
    case BF16:
      err = launch_score_u<__nv_bfloat16>(v_dtype, grid, s, user_ixs, B, U,
                                          u_scales, V, v_scales, mask, I, D,
                                          scores, launched);
      break;
    case I8:
      err = launch_score_u<int8_t>(v_dtype, grid, s, user_ixs, B, U, u_scales,
                                   V, v_scales, mask, I, D, scores, launched);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return pio_k2_select(scores, B, I, k, cand, out_scores, out_ids, launched, stream);
}

// The tile route of the fused K2 call: tile_topk_kernel into `ws` ([B, T,
// g] u64 workspace, T = ceil(I / W), g the power of two >= k), then
// merge_topk_kernel. Arguments as pio_k2_gather_top_k; W as
// ops/topk.py k2_route picks it.
int pio_k2_tile_top_k(const int* user_ixs, int B, const void* U, int u_dtype,
                      const float* u_scales, const void* V, int v_dtype,
                      const float* v_scales, const uint8_t* mask, int I, int D,
                      int k, int W, void* ws, float* out_scores, int* out_ids,
                      int* launched, void* stream) {
  int g = 0;
  const int T = tile_count(B, I, D, k, W, &g);
  if (T == 0 || launched == nullptr) return (int)cudaErrorInvalidValue;
  if ((u_dtype == I8) != (u_scales != nullptr) || (v_dtype == I8) != (v_scales != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TileArgs a{user_ixs, nullptr, 0, B, U, u_scales, V, v_scales, mask, I, D, W, g,
                   static_cast<u64*>(ws)};
  cudaError_t err;
  switch (u_dtype) {
    case F32: err = launch_tile_u<float>(v_dtype, a, T, s, launched); break;
    case BF16: err = launch_tile_u<__nv_bfloat16>(v_dtype, a, T, s, launched); break;
    case I8: err = launch_tile_u<int8_t>(v_dtype, a, T, s, launched); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(a, T, k, out_scores, out_ids, s, launched);
}

// The tile route of the summed-rows K2 call: tile_topk_kernel, summing
// each block's query rows as it stages them, then merge_topk_kernel.
// Arguments as pio_k2_sum_rows_top_k, with W and ws as pio_k2_tile_top_k.
int pio_k2_tile_sum_rows_top_k(const int* row_ixs, const float* row_w, int B, int L,
                               const void* V, int v_dtype, const float* v_scales,
                               const uint8_t* mask, int I, int D, int k, int W,
                               void* ws, float* out_scores, int* out_ids,
                               int* launched, void* stream) {
  int g = 0;
  const int T = tile_count(B, I, D, k, W, &g);
  if (T == 0 || L < 0 || launched == nullptr) return (int)cudaErrorInvalidValue;
  if ((v_dtype == I8) != (v_scales != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TileArgs a{row_ixs, row_w, L, B, nullptr, nullptr, V, v_scales, mask, I, D, W, g,
                   static_cast<u64*>(ws)};
  cudaError_t err;
  switch (v_dtype) {
    case F32: err = launch_tile<float, float, true>(a, T, s, launched); break;
    case BF16: err = launch_tile<float, __nv_bfloat16, true>(a, T, s, launched); break;
    case I8: err = launch_tile<float, int8_t, true>(a, T, s, launched); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(a, T, k, out_scores, out_ids, s, launched);
}

// The cosine-mode K2 call (ops/topk.py top_k_similar): dense f32 query
// rows Q ([B, D], read through `ixs`), V values without scales (an int8
// catalog's values alone), each score divided by max(norms[i] * qnorms[b],
// 1e-12). W > 0: the tile route (ws as pio_k2_tile_top_k); W == 0: the
// select route (scores [B, I] f32 and cand [B, k] u64 scratch). mask may
// be null.
int pio_k2_cosine_top_k(const int* ixs, int B, const float* Q, const void* V,
                        int v_dtype, const float* norms, const float* qnorms,
                        const uint8_t* mask, int I, int D, int k, int W, void* ws,
                        float* scores, void* cand, float* out_scores, int* out_ids,
                        int* launched, void* stream) {
  if (norms == nullptr || qnorms == nullptr || launched == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W > 0) {
    int g = 0;
    const int T = tile_count(B, I, D, k, W, &g);
    if (T == 0) return (int)cudaErrorInvalidValue;
    const TileArgs a{ixs, nullptr, 0, B, Q, nullptr, V, nullptr, mask, I, D, W, g,
                     static_cast<u64*>(ws), norms, qnorms};
    const cudaError_t err = launch_tile_u<float>(v_dtype, a, T, s, launched);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_merge(a, T, k, out_scores, out_ids, s, launched);
  }
  if (B <= 0 || I <= 0 || D <= 0 || k <= 0 || k > I) return (int)cudaErrorInvalidValue;
  const dim3 grid((I + TILE_I - 1) / TILE_I, (B + TILE_B - 1) / TILE_B);
  const cudaError_t err = launch_score_u<float>(v_dtype, grid, s, ixs, B, Q, nullptr, V,
                                                nullptr, mask, I, D, scores, launched,
                                                norms, qnorms);
  if (err != cudaSuccess) return (int)err;
  return pio_k2_select(scores, B, I, k, cand, out_scores, out_ids, launched, stream);
}

}  // extern "C"
