// K4 and K5: two-stage retrieval for Hopper (sm_90a).
//
// K4, the coarse shortlist, replaces predictionio_tpu/ops/retrieval.py:212
// _coarse_topk (a jax.jit lax.scan over [NT, T, D] catalog tiles: score
// each tile in the catalog's storage precision, take the tile's top k',
// merge into a running top k'). K5, the shortlist rescore, replaces :375
// _score_candidates with its three query forms (:396 _rescore_gather, :408
// _rescore_vectors, :414 _rescore_sum_rows).
//
// K4, per query row b and catalog row i (i < num_rows; pad rows past the
// catalog are never read):
//   int8      s_bi = (sum_{d=0..D-1} q_bd * float(V[i, d])) * scale[i]
//   int8_dot  s_bi = float(sum_d qi_bd * V[i, d]) * scale[i], int32 sums
//             (exact), qi_b = clip(rint(q_b / max(max|q_b| / 127, 1e-12)),
//             -127, 127), each division a true f32 division
//   bf16      s_bi = sum_d q_bd * float(V[i, d]), V the bf16 copy
// (the f32 sums in d order, each product and partial sum rounded: no FMA),
// then the k' largest s_bi by the composite order_key(s) << 32 | ~i: IEEE
// total order descending (NaN above +inf, +0 above -0), the lower id first
// on a tie -- the order of jax.lax.top_k over the JAX running merge. Rows
// scoring at or below -1e30 never enter (in JAX they lose every tie to the
// merge's initial (-1e30, -1) entries), and a row with fewer than k' such
// rows ends in (-1e30, -1).
//
// K4 takes one of two routes, picked per call by ops/retrieval.py
// k4_route from k'; both are one launch:
//
// The warp route, k' <= WARP_MAX_K = 128 (every serving call at num <=
// 16: k' = 32 at the templates' default num = 4, 128 at num = 10),
// coarse_warp_kernel. A block of nw warps (8, fewer only when
// wide rows overflow shared memory) serves RB query rows over W catalog
// rows, one block an SM. Each warp owns W / nw contiguous rows and keeps,
// for each of its RB queries, its running best L = max(K, 32) composites
// in registers (K / 32 u64 a lane, at most 4), sorted descending; their
// K-th is its admission threshold.
//   - Rows in flight: a round stages the warp's next 64 rows into its
//     ring of two stages (cp.async, 16-byte words; rows padded by 16
//     bytes, so lanes reading their own rows do not conflict) before it
//     scores this round's.
//   - Scoring: each lane scores 2 rows against the RB queries, read as
//     16-byte broadcasts from shared memory and used for both rows, so a
//     product is one FP32 mul and one add.
//   - Admission: composites above the threshold go to a per-warp queue
//     in shared memory (ballot + prefix). Once a queue holds more than
//     64, the warp sorts it with K2's bitonic networks
//     (csrc/warp_select.cuh) and folds it into the list. A warp
//     publishes its K-th to the block (atomicMax in shared memory) and
//     admits against the largest published: the global K-th is at least
//     any warp's. No block barrier in the loop: ballots, shuffles and
//     __syncwarp only.
//   - Block end: the warps' lists fold once through shared memory into
//     the block's best K, written to the [B, nblk, K] u64 workspace.
//   - The merge, in the same launch: each block takes a ticket
//     (__threadfence, then atomicAdd on its query group's counter, which
//     the merging block sets back to 0). The last block of a group merges
//     the group's nblk lists: only entries at or above the largest of the
//     lists' K-th entries (a bound on the global K-th) enter, column by
//     column from the lists' heads (mcols columns of every list staged in
//     shared memory at once), until a column admits nothing.
// What bounds it on an H100: the bytes, read once, I * (D + 4) for int8
// and I * 2D for bf16 (0.019 ms for bf16 at I = 1M, D = 32, against
// 3.35 TB/s); and the arithmetic that bit-equality fixes, products and
// sums as separate FP32 instructions, 2 * B * I * D of them at half the
// 67 TFLOP/s FMA peak (0.015 ms at B = 8, I = 1M; 0.12 ms at B = 64).
// The admissions' sorts come on top.
//
// The stream route, 128 < k' <= MAX_K = 8192 (num > 16; any k' when asked
// for), coarse_stream_kernel: the warp route with the lists moved from
// registers to shared memory. It keeps the [B, I] scores out of device
// memory (320 MB at B = 8, I = 10M) at any k' up to MAX_K.
//   - Rows, scoring and admission as on the warp route: each warp stages
//     its rows in its cp.async ring, scores them, and queues the
//     composites above its query's threshold (read from shared memory
//     each round). No block barrier in the loop.
//   - A query's list is the block's, in shared memory: a buffer of cap =
//     K + max(K, 128) entries in no order. A warp flushes a queue of more
//     than 64 under the query's lock (a shared-memory spin lock, lane 0
//     spinning): its entries above the threshold are appended; when they
//     could overflow the buffer, the buffer is first thinned to between
//     K and cap - 128 entries above a pivot (32 samples sorted in the
//     warp; one ballot-counting pass checks it), which becomes the
//     threshold; when no pivot lands there, it is cut to its best K (a
//     radix select, 8 bits a pass from the top, on the warp's histogram)
//     and their least becomes the threshold. A block appends about K (1 + ln(rows / K)) of its rows
//     and cuts about 1 + ln(rows / K) times; the sorted insertion a
//     queue could make into a sorted list costs O(K) a flush instead.
//   - Block end: each query's buffer is cut to K, sorted (a bitonic
//     network over the block, one barrier a stage) and written to the
//     [B, nblk, K] workspace.
//   - The merge, in the same launch, by the last block of the group (the
//     warp route's ticket): a warp a query streams the group's lists
//     column by column (mcols columns of every list staged in its ring)
//     from the bound on the global K-th (the largest list K-th) through
//     its queue into the query's buffer, until a column admits nothing;
//     the buffer is cut to k' and sorted.
//   RB, the warps and the ring stages are sized to fit 227 KB (RB 8 to
//   k' = 512 at D = 32; 1 at k' = 8192).
// The pair, coarse_tile_kernel + coarse_merge_kernel, is the stream route
// before this design, two launches, kept as a same-run baseline (nothing
// on the serving path calls it):
//   launch 1, coarse_tile_kernel: a 256-thread block per (range of W
//     catalog rows, RB query rows). Each thread scores one row at a time
//     against the block's RB queries (kept in shared memory), and the
//     block streams the composites into a per-query buffer of S entries
//     in shared memory (S the power of two >= K + 256, K the power of two
//     >= k'): only composites above the query's threshold are appended
//     (ballot + prefix, in thread order); when a round could overflow the
//     buffer, every query's buffer is sorted (a bitonic network) and cut
//     to its best K, whose last entry becomes the threshold. The block
//     writes each query's best K to a [B, nblk, K] u64 workspace.
//   launch 2, coarse_merge_kernel: a 1024-thread block per query streams
//     its nblk sorted lists through the same buffer, column by column,
//     and stops at the first column of which nothing was appended; it
//     writes the best k', the score recovered from the composite
//     (order_key is a bijection).
//   Its selection costs about ten times its scoring: four block barriers
//   and a prefix over 8 warps every round of 256 rows, bitonic sorts of
//   every query's buffer with a barrier a stage, and a merge launch of
//   only B blocks.
//
// K5, per query row b and shortlist position j (cand[b, j] = -1 marks an
// empty slot, which gathers row 0 and scores -1e30):
//   q_b  = the query vector, built as ops/topk.py's K2 builds it: a user
//          row float(U[ix_b]) * u_scale, given f32 vectors, or the weighted
//          sum of catalog rows sum_l (float(V[ix_bl]) * v_scale) * w_bl (l
//          in order from +0.0, each product and partial sum rounded)
//   s_bj = (sum_d q_bd * float(V[cand_bj, d])) * v_scale[cand_bj], K2's
//          arithmetic (csrc/topk.cu score_kernel), so every score equals
//          K2's for the same (query, item) pair bit for bit
//   the k best by order_key(s) << 32 | ~j: ties keep shortlist order, as
//   lax.top_k on the [B, S] row; a winner not above -5e29 reports id -1.
// The arithmetic is two device functions, query_value and exact_score,
// which both of K5's forms call:
//   - fused, the epilogue of K4's merge (pio_k4_two_stage, the serving
//     path): the block that completes a query group's shortlist rescores
//     it in the same launch. A warp gathers 32 candidate rows at a time
//     into its ring (cp.async, the 16-byte words that hold each row) and
//     each lane scores one; on the warp route the warp that merged a
//     query selects its k in registers (K2's bitonic networks), on the
//     stream route the block sorts each query's k' rescored composites.
//     The merging block writes the epilogue's %globaltimer nanoseconds
//     for its group, so the host can split a call into its stages.
//   - standalone, rescore_kernel (pio_k5_rescore_top_k, the port of the
//     JAX package's rescore functions): one block a query row, the
//     shortlist (S <= MAX_K) scored and sorted in shared memory. It reads
//     B * S * D values and is bound by its launch, not by bytes or
//     operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

#include "warp_select.cuh"

constexpr float NEG_INF = -1e30f;       // ops/retrieval.py NEG_INF
constexpr float REPORT_FLOOR = -5e29f;  // NEG_INF / 2: winners at or below report -1
constexpr int TILE_THREADS = 256;       // rows a coarse block scores a round, one a thread
constexpr int MERGE_THREADS = 1024;
constexpr int RESCORE_THREADS = 256;
constexpr int MAX_K = 8192;             // ops/retrieval.py K4_MAX_K
constexpr int RADIX = 256;              // bins of the stream route's exact cut, 8 bits a pass

enum Mode { INT8 = 0, INT8_DOT = 1, BF16 = 2 };
enum DType { F32 = 0, DT_BF16 = 1, I8 = 2 };
enum Query { GATHER = 0, VECTORS = 1, SUM_ROWS = 2 };

// Unsigned image of the signed order key: unsigned compare == key compare.
__device__ __forceinline__ uint32_t order_key(float x) {
  const int b = __float_as_int(x);
  const int key = b < 0 ? (b ^ 0x7FFFFFFF) : b;
  return (uint32_t)key ^ 0x80000000u;
}

// Key descending, then position ascending (~pos), as one unsigned compare.
__device__ __forceinline__ u64 composite(float s, uint32_t pos) {
  return ((u64)order_key(s) << 32) | (u64)(~pos);
}

__device__ __forceinline__ float composite_score(u64 c) {
  const int key = (int)((uint32_t)(c >> 32) ^ 0x80000000u);
  return __int_as_float(key < 0 ? (key ^ 0x7FFFFFFF) : key);
}

__device__ __forceinline__ uint32_t composite_pos(u64 c) { return ~(uint32_t)c; }

// Every admitted composite is above this: a key above order_key(-1e30).
__device__ __forceinline__ u64 admit_floor() {
  return ((u64)order_key(NEG_INF) << 32) | 0xFFFFFFFFull;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

__device__ __forceinline__ float load_f32(const void* p, int dtype, size_t i) {
  switch (dtype) {
    case DT_BF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case I8: return (float)static_cast<const int8_t*>(p)[i];
    default: return static_cast<const float*>(p)[i];
  }
}

// -- K5's arithmetic: the standalone kernel and the fused epilogue ---------------

__host__ __device__ constexpr int dtype_bytes(int dtype) {
  return dtype == F32 ? 4 : dtype == DT_BF16 ? 2 : dtype == I8 ? 1 : 0;
}

// A K5 call's query form and item table (see the note at the top).
struct QueryForm {
  int query;              // GATHER, VECTORS or SUM_ROWS
  const int* ixs;         // [B] user rows (GATHER) or [B, L] catalog rows (SUM_ROWS)
  const float* row_w;     // [B, L] (SUM_ROWS)
  int L;
  const void* U;          // GATHER: the user table
  int u_dtype;
  const float* u_scales;
  const float* vecs;      // VECTORS: [B, D] f32
  const void* V;          // the item table, f32/bf16/int8
  int v_dtype;
  const float* v_scales;  // int8 item table
  int D;
};

// Element d of query row b, built as K2 builds it.
__device__ __forceinline__ float query_value(const QueryForm& f, int b, int d) {
  const int D = f.D;
  float u = 0.0f;
  if (f.query == GATHER) {
    const int r = f.ixs[b];
    u = load_f32(f.U, f.u_dtype, (size_t)r * D + d);
    if (f.u_scales != nullptr) u = __fmul_rn(u, f.u_scales[r]);
  } else if (f.query == VECTORS) {
    u = f.vecs[(size_t)b * D + d];
  } else {  // K2's sum: l in order from +0.0, zero weights multiplied in
    const int* ix = f.ixs + (size_t)b * f.L;
    const float* w = f.row_w + (size_t)b * f.L;
    for (int l = 0; l < f.L; ++l) {
      const int r = ix[l];
      float v = load_f32(f.V, f.v_dtype, (size_t)r * D + d);
      if (f.v_scales != nullptr) v = __fmul_rn(v, f.v_scales[r]);
      u = __fadd_rn(u, __fmul_rn(v, w[l]));
    }
  }
  return u;
}

// sum_d q[d] * float(v[d]), d in order from +0.0, each product and
// partial sum rounded (no FMA): K2's score.
template <typename T>
__device__ __forceinline__ float exact_dot(const float* q, const T* v, int D) {
  float acc = 0.0f;
  int d = 0;
  for (; d + 4 <= D; d += 4) {  // four loads in flight; the sum stays in d order
    const float p0 = __fmul_rn(q[d], to_f32(v[d])), p1 = __fmul_rn(q[d + 1], to_f32(v[d + 1]));
    const float p2 = __fmul_rn(q[d + 2], to_f32(v[d + 2])), p3 = __fmul_rn(q[d + 3], to_f32(v[d + 3]));
    acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, p0), p1), p2), p3);
  }
  for (; d < D; ++d) acc = __fadd_rn(acc, __fmul_rn(q[d], to_f32(v[d])));
  return acc;
}

// The exact score of catalog row `row`, whose D values lie at v (device
// or shared memory): exact_dot, times the int8 scale after the sum.
__device__ __forceinline__ float exact_score(const QueryForm& f, const float* q, const void* v,
                                             int row) {
  float acc;
  switch (f.v_dtype) {
    case DT_BF16: acc = exact_dot(q, static_cast<const __nv_bfloat16*>(v), f.D); break;
    case I8: acc = exact_dot(q, static_cast<const int8_t*>(v), f.D); break;
    default: acc = exact_dot(q, static_cast<const float*>(v), f.D);
  }
  return f.v_scales != nullptr ? __fmul_rn(acc, f.v_scales[row]) : acc;
}

// Sort `rows` rows of S entries each (S a power of two, lg_s = log2 S;
// row r at buf + r * stride) descending, all rows at once, by the block's
// nt threads: a bitonic network, one barrier a stage.
__device__ void sort_rows_n(u64* buf, int rows, int S, int lg_s, int stride, int nt) {
  const int half = S >> 1;
  const int total = rows * half;
  for (int size = 2; size <= S; size <<= 1) {
    for (int step = size >> 1; step > 0; step >>= 1) {
#pragma unroll 4
      for (int p = threadIdx.x; p < total; p += nt) {
        const int r = p >> (lg_s - 1), q = p & (half - 1);
        const int lo = ((q & ~(step - 1)) << 1) | (q & (step - 1));
        const int hi = lo + step;
        u64* row = buf + (size_t)r * stride;
        const u64 a = row[lo], b = row[hi];
        const bool desc = (lo & size) == 0;
        if (desc ? a < b : a > b) {
          row[lo] = b;
          row[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

template <int NT>
__device__ void sort_rows(u64* buf, int rows, int S, int lg_s) {
  sort_rows_n(buf, rows, S, lg_s, S, NT);
}

// The best K composites of a stream, for RB rows at once, in shared
// memory: each row's buffer of S entries holds n[r] of them (unsorted past
// the last cut) and admits only composites above thr[r].
template <int RB, int NT>
struct Stream {
  static constexpr int NW = NT / 32;
  u64* buf;       // [RB][S]
  u64* thr;       // [RB]
  int* n;         // [RB]
  unsigned* wt;   // [RB][NW + 1]: per-warp admissions, then offsets
  int S, lg_s, K;

  __device__ void init() {
    if (threadIdx.x < RB) {
      n[threadIdx.x] = 0;
      thr[threadIdx.x] = admit_floor();
    }
    __syncthreads();
  }

  // Sort every row and keep its best K: the K-th becomes the threshold.
  __device__ void cut() {
    for (int e = threadIdx.x; e < (RB << lg_s); e += NT) {
      if ((e & (S - 1)) >= n[e >> lg_s]) buf[e] = 0ull;
    }
    __syncthreads();
    sort_rows<NT>(buf, RB, S, lg_s);
    if (threadIdx.x < RB) {
      const int r = threadIdx.x;
      if (n[r] >= K) {
        n[r] = K;
        thr[r] = buf[((size_t)r << lg_s) + K - 1];
      }
    }
    __syncthreads();
  }

  // Every thread offers one composite a row (0: none); those above the
  // row's threshold are appended in thread order. Returns how many were
  // appended over all rows, the same in every thread.
  __device__ int offer(const u64 (&c)[RB]) {
    bool full = false;
#pragma unroll
    for (int r = 0; r < RB; ++r) full |= n[r] + NT > S;
    if (full) cut();  // block-uniform: every thread read the same n
    int base = 0;
#pragma unroll
    for (int r = 0; r < RB; ++r) base += n[r];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned bal[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      bal[r] = __ballot_sync(0xffffffffu, c[r] > thr[r]);
      if (lane == 0) wt[r * (NW + 1) + warp] = __popc(bal[r]);
    }
    __syncthreads();
    if (threadIdx.x < RB) {
      unsigned* w = wt + threadIdx.x * (NW + 1);
      unsigned run = (unsigned)n[threadIdx.x];
      for (int j = 0; j < NW; ++j) {
        const unsigned x = w[j];
        w[j] = run;
        run += x;
      }
      w[NW] = run;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if ((bal[r] >> lane) & 1u) {
        const unsigned pos = wt[r * (NW + 1) + warp] + __popc(bal[r] & ((1u << lane) - 1u));
        buf[((size_t)r << lg_s) + pos] = c[r];
      }
    }
    __syncthreads();
    if (threadIdx.x < RB) n[threadIdx.x] = (int)wt[threadIdx.x * (NW + 1) + NW];
    __syncthreads();
    int now = 0;
#pragma unroll
    for (int r = 0; r < RB; ++r) now += n[r];
    return now - base;
  }
};

// Shared-memory layout of a stream of RB rows of S entries, followed by
// `extra` bytes (16-byte aligned).
template <int RB, int NT>
__host__ __device__ constexpr size_t stream_bytes(int S) {
  return ((size_t)RB * S + RB) * sizeof(u64) + RB * sizeof(int) +
         RB * (NT / 32 + 1) * sizeof(unsigned);
}

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

template <int RB, int NT>
__device__ Stream<RB, NT> carve(unsigned char* smem, int S, int lg_s, int K) {
  Stream<RB, NT> s;
  s.buf = reinterpret_cast<u64*>(smem);
  s.thr = s.buf + (size_t)RB * S;
  s.n = reinterpret_cast<int*>(s.thr + RB);
  s.wt = reinterpret_cast<unsigned*>(s.n + RB);
  s.S = S;
  s.lg_s = lg_s;
  s.K = K;
  return s;
}

struct CoarseArgs {
  const float* q;       // [B, D] f32 queries
  int B, D, Dp;         // Dp: D rounded up to 16 (the staged query rows' width)
  const void* V;        // [N, D] int8 or bf16 coarse values (N >= num_rows)
  const float* scales;  // [N] (int8 modes), else null
  long long num_rows;   // rows past it are padding, never read
  long long W;          // catalog rows a block streams
  int nblk;             // gridDim.x
  int K, S, lg_s;       // K: power of two >= k'; S: buffer entries a row
  bool vec;             // rows are whole 16-byte words (D * elem % 16 == 0)
  u64* ws;              // [B, nblk, K]
};

// Round to nearest, ties to even, clipped to [-127, 127]; NaN -> 0.
__device__ __forceinline__ int quantize(float x, float den) {
  const float y = rintf(__fdiv_rn(x, den));
  if (y != y) return 0;
  return (int)fminf(fmaxf(y, -127.0f), 127.0f);
}

template <int RB>
__device__ __forceinline__ void dot_f32(float (&acc)[RB], const float* qf, int Dp, int d,
                                        float v) {
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = __fadd_rn(acc[r], __fmul_rn(qf[r * Dp + d], v));
}

// The RB scores of catalog row i (see the note at the top).
template <int RB, int MODE>
__device__ __forceinline__ void coarse_scores(const CoarseArgs& a, const float* qf,
                                              const int* qw, size_t i, float (&s)[RB]) {
  const int D = a.D, Dp = a.Dp;
  if constexpr (MODE == INT8_DOT) {
    const int8_t* row = static_cast<const int8_t*>(a.V) + i * D;
    const int8_t* qb = reinterpret_cast<const int8_t*>(qw);
    int acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0;
    if (a.vec) {
      for (int d0 = 0; d0 < D; d0 += 16) {
        const int4 w = *reinterpret_cast<const int4*>(row + d0);
        const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int r = 0; r < RB; ++r) acc[r] = __dp4a(words[j], qw[(r * Dp + d0) / 4 + j], acc[r]);
        }
      }
    } else {
      for (int d = 0; d < D; ++d) {
        const int v = row[d];
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[r] += v * (int)qb[r * Dp + d];
      }
    }
    const float sc = a.scales[i];
#pragma unroll
    for (int r = 0; r < RB; ++r) s[r] = __fmul_rn(__int2float_rn(acc[r]), sc);
  } else {
#pragma unroll
    for (int r = 0; r < RB; ++r) s[r] = 0.0f;
    if constexpr (MODE == INT8) {
      const int8_t* row = static_cast<const int8_t*>(a.V) + i * D;
      if (a.vec) {
        for (int d0 = 0; d0 < D; d0 += 16) {
          const int4 w = *reinterpret_cast<const int4*>(row + d0);
          const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dot_f32<RB>(s, qf, Dp, d0 + 4 * j + e, (float)(int8_t)(words[j] >> (8 * e)));
          }
        }
      } else {
        for (int d = 0; d < D; ++d) dot_f32<RB>(s, qf, Dp, d, (float)row[d]);
      }
      const float sc = a.scales[i];
#pragma unroll
      for (int r = 0; r < RB; ++r) s[r] = __fmul_rn(s[r], sc);
    } else {
      const __nv_bfloat16* row = static_cast<const __nv_bfloat16*>(a.V) + i * D;
      if (a.vec) {
        for (int d0 = 0; d0 < D; d0 += 8) {
          const int4 w = *reinterpret_cast<const int4*>(row + d0);
          const unsigned words[4] = {(unsigned)w.x, (unsigned)w.y, (unsigned)w.z, (unsigned)w.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dot_f32<RB>(s, qf, Dp, d0 + 2 * j, __uint_as_float(words[j] << 16));
            dot_f32<RB>(s, qf, Dp, d0 + 2 * j + 1, __uint_as_float(words[j] & 0xFFFF0000u));
          }
        }
      } else {
        for (int d = 0; d < D; ++d) dot_f32<RB>(s, qf, Dp, d, __bfloat162float(row[d]));
      }
    }
  }
}

// Launch 1 of K4 (see the note at the top).
template <int RB, int MODE>
__global__ void __launch_bounds__(TILE_THREADS) coarse_tile_kernel(const CoarseArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stream<RB, TILE_THREADS> st = carve<RB, TILE_THREADS>(smem, a.S, a.lg_s, a.K);
  float* qf = reinterpret_cast<float*>(smem + align16(stream_bytes<RB, TILE_THREADS>(a.S)));
  int* qw = reinterpret_cast<int*>(qf + RB * a.Dp);  // int8_dot: RB rows of Dp bytes
  __shared__ float den[RB];
  const int t = threadIdx.x;
  const int b0 = blockIdx.y * RB;
  const int nb = min(RB, a.B - b0);
  for (int e = t; e < RB * a.Dp; e += TILE_THREADS) {
    const int r = e / a.Dp, d = e - r * a.Dp;
    qf[e] = r < nb && d < a.D ? a.q[(size_t)(b0 + r) * a.D + d] : 0.0f;
  }
  st.init();  // its barrier also publishes qf
  if constexpr (MODE == INT8_DOT) {
    if (t < RB) {
      float m = 0.0f;  // max |q|, NaN sticky as jnp.max
      for (int d = 0; d < a.D; ++d) {
        const float x = fabsf(qf[t * a.Dp + d]);
        m = (x > m || x != x) ? x : m;
      }
      const float qs = __fdiv_rn(m, 127.0f);
      den[t] = qs != qs ? qs : fmaxf(qs, 1e-12f);
    }
    __syncthreads();
    int8_t* qb = reinterpret_cast<int8_t*>(qw);
    for (int e = t; e < RB * a.Dp; e += TILE_THREADS) {
      const int r = e / a.Dp, d = e - r * a.Dp;
      qb[e] = (int8_t)(d < a.D ? quantize(qf[e], den[r]) : 0);
    }
    __syncthreads();
  }
  const long long begin = (long long)blockIdx.x * a.W;
  const long long end = min(begin + a.W, a.num_rows);
  for (long long c0 = begin; c0 < end; c0 += TILE_THREADS) {  // block-uniform trip count
    const long long i = c0 + t;
    u64 c[RB];
    if (i < end) {
      float s[RB];
      coarse_scores<RB, MODE>(a, qf, qw, (size_t)i, s);
#pragma unroll
      for (int r = 0; r < RB; ++r) c[r] = r < nb ? composite(s[r], (uint32_t)i) : 0ull;
    } else {
#pragma unroll
      for (int r = 0; r < RB; ++r) c[r] = 0ull;
    }
    st.offer(c);
  }
  st.cut();
  for (int e = t; e < nb * a.K; e += TILE_THREADS) {
    const int r = e / a.K, j = e - r * a.K;
    a.ws[((size_t)(b0 + r) * a.nblk + blockIdx.x) * a.K + j] =
        j < st.n[r] ? st.buf[((size_t)r << a.lg_s) + j] : 0ull;
  }
}

// Launch 2 of K4: one block a query row streams the row's nblk sorted
// lists of K, column by column (every list's entry p, then p + 1), and
// writes its best k. Once no entry of a whole column was appended, every
// later entry is below the threshold too (each list descends, and the
// threshold only rises), so the stream stops there: a few columns, not K.
__global__ void __launch_bounds__(MERGE_THREADS)
coarse_merge_kernel(const u64* __restrict__ ws, int nblk, int K, int S, int lg_s, int k,
                    float* __restrict__ out_scores, int* __restrict__ out_ids) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stream<1, MERGE_THREADS> st = carve<1, MERGE_THREADS>(smem, S, lg_s, K);
  st.init();
  const u64* src = ws + (size_t)blockIdx.x * nblk * K;
  for (int p = 0; p < K; ++p) {
    int appended = 0;  // block-uniform
    for (int l0 = 0; l0 < nblk; l0 += MERGE_THREADS) {
      const int l = l0 + threadIdx.x;
      const u64 c[1] = {l < nblk ? src[(size_t)l * K + p] : 0ull};
      appended += st.offer(c);
    }
    if (appended == 0) break;
  }
  st.cut();
  for (int j = threadIdx.x; j < k; j += MERGE_THREADS) {
    const u64 c = j < st.n[0] ? st.buf[j] : 0ull;
    const size_t o = (size_t)blockIdx.x * k + j;
    out_scores[o] = c != 0ull ? composite_score(c) : NEG_INF;
    out_ids[o] = c != 0ull ? (int)composite_pos(c) : -1;
  }
}

// -- K4's warp route: k' <= WARP_MAX_K (see the note at the top) ------------

constexpr int WARP_THREADS = 256;            // a warp-route block: at most 8 warps
constexpr int LANE_ROWS = 2;                 // rows a lane scores a round
constexpr int ROUND_ROWS = 32 * LANE_ROWS;   // rows a warp stages a round
constexpr int QUEUE = 128;                   // a warp's queue of admissions, per query
constexpr int WARP_MAX_K = 128;              // ops/retrieval.py K4_WARP_MAX_K
constexpr int MERGE_MAX_COLS = 8;            // list columns the merge stages a batch
constexpr int MAX_STAGES = 4;                // a warp's ring: rounds staged ahead + 1
constexpr int MAX_WARPS = WARP_THREADS / 32;

// The fused epilogue's arguments (pio_k4_two_stage): K5's query form
// and item table, its k and outputs. f.V null: K4 alone.
struct EpiArgs {
  QueryForm f;
  int v_elem;            // bytes of an item-table value
  long long v_rows;      // rows of the item table (>= the catalog's rows)
  int k;                 // winners of the rescore (<= k')
  int slot;              // gather_slot(D * v_elem): a staged row's bytes
  float* out_scores;     // [B, k]
  int* out_ids;
  unsigned long long* timer;  // [query groups]: the epilogue's nanoseconds
};

struct WarpArgs {
  const float* q;        // [B, D] f32 queries
  int B, D, Dp;          // Dp: D rounded up to 16
  const void* V;         // [v_rows, D] int8 or bf16, 16-byte aligned
  const float* scales;   // [v_rows] (int8 modes), 16-byte aligned, else null
  long long num_rows;    // rows past it are padding, never read
  long long v_rows;      // rows of V: staging never reads past them
  long long W;           // rows a block owns, a multiple of ROUND_ROWS * nw
  int nblk, nw;          // blocks of a query group (gridDim.x), warps of a block
  int k, K, lg_k;        // winners; the power of two >= k, its log2
  int rowbytes;          // D * element size
  bool vec;              // rows are whole 16-byte words: staged padded, read 16 at a time
  int rows_bytes, stage_bytes;  // a stage's rows, then its scales
  int stages;            // a warp's ring: stages - 1 rounds in flight while one is scored
  int ring;              // a warp's share of the rings: the stages, or the epilogue's need
  int cap;               // stream route: a query's buffer entries
  int mcols;             // list columns the merge stages a batch
  u64* ws;               // [B, nblk, K]
  unsigned* tickets;     // [gridDim.y] arrivals, 0 between calls
  float* out_scores;     // [B, k] (K4 alone)
  int* out_ids;
  bool fused;            // run the K5 epilogue instead of writing the shortlist
  EpiArgs e;
};

// Shared memory of a warp-route block: the queries (f32, then int8); the
// block's thresholds (u64 [RB]), each warp's published entries (u64
// [MAX_WARPS][RB]), the int8_dot quantization's divisors and the
// last-block flag; each warp's queues (QUEUE composites a query); each
// warp's ring of `stages` stages.
__host__ __device__ constexpr size_t warp_head_bytes(int rb, int Dp) {
  return align16((size_t)rb * Dp * 5) +
         align16((size_t)rb * ((1 + MAX_WARPS) * sizeof(u64) + sizeof(float)) + sizeof(int));
}

// A stage's rows: padded to rowbytes + 16 a row when vec, else one span
// with room for its offset from the 16-byte word below it.
__host__ __device__ constexpr size_t warp_rows_bytes(int D, int elem, bool vec) {
  return vec ? ROUND_ROWS * ((size_t)D * elem + 16) : align16(ROUND_ROWS * (size_t)D * elem + 32);
}

// A stage: its rows, then their scales (int8 modes).
__host__ __device__ constexpr size_t warp_stage_bytes(int D, int elem, bool vec, bool scaled) {
  return warp_rows_bytes(D, elem, vec) + (scaled ? ROUND_ROWS * sizeof(float) : 0);
}

// The bytes a staged item-table row of `rowbytes` takes in the epilogue:
// room for its offset within a 16-byte word, rounded up to an odd number
// of words (lanes reading their own rows then spread over the banks).
__host__ __device__ constexpr int gather_slot(int rowbytes) {
  return ((rowbytes + 30) / 16 | 1) * 16;
}

// The warp route's epilogue keeps its WARP_MAX_K rescore composites and
// shortlist ids in shared memory.
constexpr int EPI_SEL_BYTES = WARP_MAX_K * (sizeof(u64) + sizeof(int));

// The epilogue's shared memory a warp, at least: a query (D f32), the
// composites and ids, then one group of 32 staged rows (more groups in
// flight where the warp's share of the rings holds them).
__host__ __device__ constexpr size_t epi_bytes(int D, int v_elem) {
  return align16((size_t)D * 4) + EPI_SEL_BYTES + 32 * (size_t)gather_slot(D * v_elem);
}

// A warp's share of the rings: its stages, or the epilogue's need
// (v_elem 0: K4 alone).
__host__ __device__ constexpr size_t ring_bytes(int D, int elem, bool vec, bool scaled, int stages,
                                                int v_elem) {
  return stages * warp_stage_bytes(D, elem, vec, scaled) > (v_elem > 0 ? epi_bytes(D, v_elem) : 0)
             ? stages * warp_stage_bytes(D, elem, vec, scaled)
             : epi_bytes(D, v_elem);
}

__host__ __device__ constexpr size_t warp_smem_bytes(int rb, int nw, int D, size_t ring) {
  return warp_head_bytes(rb, (D + 15) / 16 * 16) + (size_t)nw * rb * QUEUE * sizeof(u64) +
         (size_t)nw * ring;
}

// Shared memory of a stream-route block: the queries (f32, then int8);
// each query's threshold, count and lock, the int8_dot divisors and the
// last-block flag; each query's buffer of stream_cap(K); each warp's
// queues, its radix histogram and its share of the rings.
__host__ __device__ constexpr int stream_cap(int K) { return K + (K > QUEUE ? K : QUEUE); }

__host__ __device__ constexpr size_t stream_ctl_bytes(int rb) {
  return align16((size_t)rb * (sizeof(u64) + 2 * sizeof(int) + sizeof(float)) + sizeof(int));
}

__host__ __device__ constexpr size_t stream_smem_bytes(int rb, int nw, int D, int K, size_t ring) {
  return align16((size_t)rb * ((D + 15) / 16 * 16) * 5) + stream_ctl_bytes(rb) +
         align16((size_t)rb * stream_cap(K) * sizeof(u64)) + (size_t)nw * rb * QUEUE * sizeof(u64) +
         (size_t)nw * RADIX * sizeof(unsigned) + (size_t)nw * ring;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most n (< MAX_STAGES) of the thread's groups are pending.
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  switch (n) {
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>();
  }
}

// Stage the bytes [src, src + n) at dst + (src & 15), 16 at a time from the
// 16-byte word below src; a word that would reach past `limit` (the end of
// the array) is copied byte by byte. One warp.
__device__ __forceinline__ void stage_span(unsigned char* dst, const unsigned char* src, size_t n,
                                           const unsigned char* limit, int lane) {
  const uintptr_t a0 = (uintptr_t)src & ~(uintptr_t)15;
  const int words = (int)(((uintptr_t)src + n - a0 + 15) >> 4);
  for (int w = lane; w < words; w += 32) {
    const unsigned char* from = reinterpret_cast<const unsigned char*>(a0) + 16 * w;
    if (from + 16 <= limit) {
      cp_async16(dst + 16 * w, from);
    } else {
      for (int j = 0; j < 16; ++j) dst[16 * w + j] = from + j < limit ? from[j] : 0;
    }
  }
}

// Stage rows [i0, i0 + nr) (nr <= ROUND_ROWS), and their scales, into a
// stage: padded to rowbytes + 16 a row when a.vec (16-byte words, no bank
// conflicts when each lane reads its own row), else as one span.
__device__ __forceinline__ void stage_rows(const WarpArgs& a, unsigned char* stage, long long i0,
                                           int nr, int lane) {
  const unsigned char* V = static_cast<const unsigned char*>(a.V);
  if (a.vec) {
    const int cpr = a.rowbytes >> 4, stride = a.rowbytes + 16;
    const int lg = (cpr & (cpr - 1)) == 0 ? __ffs(cpr) - 1 : -1;  // a shift, not a division
    const unsigned char* base = V + (size_t)i0 * a.rowbytes;
    for (int c = lane; c < nr * cpr; c += 32) {
      const int r = lg >= 0 ? c >> lg : c / cpr, part = c - r * cpr;
      cp_async16(stage + r * stride + 16 * part, base + (size_t)r * a.rowbytes + 16 * part);
    }
  } else {
    stage_span(stage, V + (size_t)i0 * a.rowbytes, (size_t)nr * a.rowbytes,
               V + (size_t)a.v_rows * a.rowbytes, lane);
  }
  if (a.scales != nullptr) {
    const unsigned char* sc = reinterpret_cast<const unsigned char*>(a.scales);
    stage_span(stage + a.rows_bytes, sc + (size_t)i0 * 4, (size_t)nr * 4,
               sc + (size_t)a.v_rows * 4, lane);  // i0 % ROUND_ROWS == 0: no offset
  }
}

// Start staging the item-table rows `row` (one a lane; rowbytes each,
// v_rows in the table V) into slots of `slot` bytes: lane l's row at dst +
// l * slot + (its address & 15), copied as the 16-byte words that hold it
// (cp.async; a word reaching past the table byte by byte). The caller
// commits and waits. One warp.
__device__ __forceinline__ void gather_start(unsigned char* dst, int slot, const unsigned char* V,
                                             int rowbytes, long long v_rows, long long row,
                                             int lane) {
  const unsigned char* limit = V + (size_t)v_rows * rowbytes;
  const int wpr = (rowbytes + 30) >> 4;  // the most words a row spans
  // lanes cover rpp rows of wpr words a pass (one row at a time when a
  // row spans more than 32 words)
  const int rpp = wpr <= 32 ? 32 / wpr : 1;
  const int lr = wpr <= 32 ? lane / wpr : 0, lw = wpr <= 32 ? lane - lr * wpr : lane;
  for (int r0 = 0; r0 < 32; r0 += rpp) {
    const long long rr = __shfl_sync(0xffffffffu, row, min(r0 + lr, 31));
    const int r = r0 + lr;
    if (lr < rpp && r < 32) {
      const unsigned char* src = V + (size_t)rr * rowbytes;
      const uintptr_t a0 = (uintptr_t)src & ~(uintptr_t)15;
      const int words = (int)(((uintptr_t)src + rowbytes - a0 + 15) >> 4);
      for (int w = lw; w < words; w += 32) {
        const unsigned char* from = reinterpret_cast<const unsigned char*>(a0) + 16 * w;
        unsigned char* to = dst + r * slot + 16 * w;
        if (from + 16 <= limit) {
          cp_async16(to, from);
        } else {
          for (int j = 0; j < 16; ++j) to[j] = from + j < limit ? from[j] : 0;
        }
      }
    }
  }
}

__device__ __forceinline__ void gather_wait() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
}

// The rescore composite of shortlist position j (id cid, -1 for an empty
// slot, whose row 0 the lane staged anyway), the lane's row staged by
// gather_start at `rows`: K5's, composite(score, j).
__device__ __forceinline__ u64 rescore_composite(const EpiArgs& e, const float* q,
                                                 const unsigned char* rows, int cid, int j,
                                                 int lane) {
  const int row = cid > 0 ? cid : 0;
  const unsigned char* V = static_cast<const unsigned char*>(e.f.V);
  const size_t at = (size_t)row * e.f.D * e.v_elem;
  const float s = exact_score(e.f, q, rows + lane * e.slot + ((uintptr_t)(V + at) & 15), row);
  return composite(cid < 0 ? NEG_INF : s, (uint32_t)j);
}

// acc = (((acc + q.x v0) + q.y v1) + q.z v2) + q.w v3, each product and sum rounded.
__device__ __forceinline__ float dot4(float acc, const float4 q, const float (&v)[4]) {
  acc = __fadd_rn(acc, __fmul_rn(q.x, v[0]));
  acc = __fadd_rn(acc, __fmul_rn(q.y, v[1]));
  acc = __fadd_rn(acc, __fmul_rn(q.z, v[2]));
  return __fadd_rn(acc, __fmul_rn(q.w, v[3]));
}

// Element e of a staged row (generic layout).
template <int MODE>
__device__ __forceinline__ float staged_value(const unsigned char* row, int d) {
  if constexpr (MODE == BF16)
    return __uint_as_float((uint32_t)*reinterpret_cast<const unsigned short*>(row + 2 * d) << 16);
  else
    return (float)(int8_t)row[d];
}

// The scores of the lane's LANE_ROWS rows of the stage holding rows from
// i0 on (staged rows lane + 32 r) against the block's RB queries: the
// note's arithmetic, d in order. The queries are read as 16-byte
// broadcasts, each serving LANE_ROWS rows.
template <int RB, int MODE>
__device__ __forceinline__ void warp_scores(const WarpArgs& a, const unsigned char* stage,
                                            long long i0, const float* qf, const int8_t* qb,
                                            int lane, float (&s)[LANE_ROWS][RB]) {
  const int D = a.D, Dp = a.Dp;
  const int shift = (int)(((uintptr_t)a.V + (size_t)i0 * a.rowbytes) & 15);  // stage_span's
  const unsigned char* row[LANE_ROWS];
#pragma unroll
  for (int r = 0; r < LANE_ROWS; ++r)
    row[r] = a.vec ? stage + (lane + 32 * r) * (a.rowbytes + 16)
                   : stage + shift + (lane + 32 * r) * a.rowbytes;
  const float* scl = reinterpret_cast<const float*>(stage + a.rows_bytes);
  if constexpr (MODE == INT8_DOT) {
    int acc[LANE_ROWS][RB];
#pragma unroll
    for (int r = 0; r < LANE_ROWS; ++r)
#pragma unroll
      for (int b = 0; b < RB; ++b) acc[r][b] = 0;
    if (a.vec) {
      for (int d0 = 0; d0 < D; d0 += 16) {
        int4 w[LANE_ROWS];
#pragma unroll
        for (int r = 0; r < LANE_ROWS; ++r) w[r] = *reinterpret_cast<const int4*>(row[r] + d0);
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          const int4 qv = *reinterpret_cast<const int4*>(qb + b * Dp + d0);
#pragma unroll
          for (int r = 0; r < LANE_ROWS; ++r) {
            int x = __dp4a(w[r].x, qv.x, acc[r][b]);
            x = __dp4a(w[r].y, qv.y, x);
            x = __dp4a(w[r].z, qv.z, x);
            acc[r][b] = __dp4a(w[r].w, qv.w, x);
          }
        }
      }
    } else {
      for (int d = 0; d < D; ++d) {
        int v[LANE_ROWS];
#pragma unroll
        for (int r = 0; r < LANE_ROWS; ++r) v[r] = (int)(int8_t)row[r][d];
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          const int qd = qb[b * Dp + d];
#pragma unroll
          for (int r = 0; r < LANE_ROWS; ++r) acc[r][b] += v[r] * qd;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < LANE_ROWS; ++r) {
      const float sc = scl[lane + 32 * r];
#pragma unroll
      for (int b = 0; b < RB; ++b) s[r][b] = __fmul_rn(__int2float_rn(acc[r][b]), sc);
    }
  } else {
#pragma unroll
    for (int r = 0; r < LANE_ROWS; ++r)
#pragma unroll
      for (int b = 0; b < RB; ++b) s[r][b] = 0.0f;
    if (a.vec) {
      constexpr int STEP = MODE == BF16 ? 8 : 16;  // the elements of a 16-byte word
      for (int d0 = 0; d0 < D; d0 += STEP) {
        uint4 w[LANE_ROWS];
#pragma unroll
        for (int r = 0; r < LANE_ROWS; ++r)
          w[r] = *reinterpret_cast<const uint4*>(row[r] + (MODE == BF16 ? 2 : 1) * d0);
#pragma unroll
        for (int g = 0; g < STEP / 4; ++g) {  // four dims at a time
          float v[LANE_ROWS][4];
#pragma unroll
          for (int r = 0; r < LANE_ROWS; ++r) {
            const uint32_t word[4] = {w[r].x, w[r].y, w[r].z, w[r].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if constexpr (MODE == BF16) {
                const uint32_t x = word[(4 * g + e) >> 1];
                v[r][e] = __uint_as_float(((4 * g + e) & 1) ? (x & 0xFFFF0000u) : (x << 16));
              } else {
                v[r][e] = (float)(int8_t)(word[g] >> (8 * e));
              }
            }
          }
#pragma unroll
          for (int b = 0; b < RB; ++b) {
            const float4 qv = *reinterpret_cast<const float4*>(qf + b * Dp + d0 + 4 * g);
#pragma unroll
            for (int r = 0; r < LANE_ROWS; ++r) s[r][b] = dot4(s[r][b], qv, v[r]);
          }
        }
      }
    } else {
      int d = 0;
      for (; d + 4 <= D; d += 4) {
        float v[LANE_ROWS][4];
#pragma unroll
        for (int r = 0; r < LANE_ROWS; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[r][e] = staged_value<MODE>(row[r], d + e);
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          const float4 qv = *reinterpret_cast<const float4*>(qf + b * Dp + d);
#pragma unroll
          for (int r = 0; r < LANE_ROWS; ++r) s[r][b] = dot4(s[r][b], qv, v[r]);
        }
      }
      for (; d < D; ++d) {
        float v[LANE_ROWS];
#pragma unroll
        for (int r = 0; r < LANE_ROWS; ++r) v[r] = staged_value<MODE>(row[r], d);
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          const float qd = qf[b * Dp + d];
#pragma unroll
          for (int r = 0; r < LANE_ROWS; ++r) s[r][b] = __fadd_rn(s[r][b], __fmul_rn(qd, v[r]));
        }
      }
    }
    if constexpr (MODE == INT8) {
#pragma unroll
      for (int r = 0; r < LANE_ROWS; ++r) {
        const float sc = scl[lane + 32 * r];
#pragma unroll
        for (int b = 0; b < RB; ++b) s[r][b] = __fmul_rn(s[r][b], sc);
      }
    }
  }
}

// Append the composites above th to a warp's queue q of n entries, in
// row then lane order (ballot + prefix); n stays the same in every lane.
__device__ __forceinline__ void queue_offer(const u64 (&c)[LANE_ROWS], u64 th, u64* q, int& n,
                                            int lane) {
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < LANE_ROWS; ++r) {
    const bool in = c[r] > th;
    const unsigned m = __ballot_sync(0xffffffffu, in);
    if (in) q[n + __popc(m & below)] = c[r];
    n += __popc(m);
  }
}

// Fold a queue of n <= QUEUE composites into the sorted list `lst` of
// 32 * EL: the queue is sorted (a bitonic network on as few registers as
// hold it) and its best 32 * EL folded in (warp_fold: the half-cleaner,
// then a bitonic merge). The queue may be refilled once it returns.
template <int EL>
__device__ __forceinline__ void fold_queue(u64 (&lst)[EL], const u64* q, int n, int lane) {
  u64 v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = lane + 32 * e < n ? q[lane + 32 * e] : 0ull;
  __syncwarp();
  if (n <= 32) {
    u64 w[1] = {v[0]};
    warp_sort<1>(w, lane);
    v[0] = w[0];
  } else if (n <= 64) {
    u64 w[2] = {v[0], v[1]};
    warp_sort<2>(w, lane);
    v[0] = w[0];
    v[1] = w[1];
  } else {
    warp_sort<4>(v, lane);
  }
  u64 w[EL];  // the queue's best 32 * EL
#pragma unroll
  for (int e = 0; e < EL; ++e) w[e] = v[e];
  warp_fold<EL>(lst, w, lane);
}

// Entry p (< 32 * EL) of a warp's sorted list, in every lane.
template <int EL>
__device__ __forceinline__ u64 list_entry(const u64 (&lst)[EL], int p, int lane) {
  u64 v = lst[0];
#pragma unroll
  for (int e = 1; e < EL; ++e)
    if (p >> 5 == e) v = lst[e];
  return __shfl_sync(0xffffffffu, v, p & 31);
}

// Raise each query's admission threshold to what the block knows. Two
// bounds on the global K-th: the largest K-th a warp published (sthr),
// and the smallest of the warps' ceil(K / nw)-th entries (pub): all nw
// warps hold at least that many entries at or above it, K in all. A
// warp's list only improves, so a stale read is a lower, still valid,
// bound. The pub minimum takes lane (w, b) = (lane & 7, lane >> 3) and
// b + 4, then a min over the 8 lanes of each b.
template <int RB>
__device__ __forceinline__ void block_thresholds(const u64* sthr, const u64* pub, int lane,
                                                 u64 (&thr)[RB]) {
  static_assert(MAX_WARPS == 8 && RB <= 8, "lanes cover [8 warps][8 queries] twice");
  const volatile u64* vp = pub;
  const int w = lane & 7, b = lane >> 3;
  u64 lo = b < RB ? vp[w * RB + b] : ~0ull;
  u64 hi = b + 4 < RB ? vp[w * RB + b + 4] : ~0ull;
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    lo = min64(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    if (RB > 4) hi = min64(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
#pragma unroll
  for (int q = 0; q < RB; ++q) {
    const u64 m = __shfl_sync(0xffffffffu, q < 4 ? lo : hi, (q & 3) * 8);
    thr[q] = max64(thr[q], max64(m, reinterpret_cast<const volatile u64*>(sthr)[q]));
  }
}

// The fused epilogue of a warp that merged query row bq's shortlist (the
// first a.k entries of lst, sorted descending): K5 on it in the same
// launch, its best e.k written out. `scratch` is the warp's share of the
// rings (at least epi_bytes): the query, the rescore composites and
// shortlist ids of positions j = lane + 32 x, then as many groups of 32
// staged rows as fit, all in flight before one wait. The best e.k are
// placed by rank (at most 128 x 128 comparisons, no sort).
template <int EL>
__device__ __forceinline__ void rescore_warp(const WarpArgs& a, int bq, const u64 (&lst)[EL],
                                             unsigned char* scratch, int lane) {
  const EpiArgs& e = a.e;
  const int D = e.f.D;
  float* qv = reinterpret_cast<float*>(scratch);
  u64* sc = reinterpret_cast<u64*>(scratch + align16((size_t)D * 4));  // [WARP_MAX_K]
  int* ids = reinterpret_cast<int*>(sc + WARP_MAX_K);
  unsigned char* rows = scratch + align16((size_t)D * 4) + EPI_SEL_BYTES;
  const int G = max(1, (int)((a.ring - (rows - scratch)) / (32 * e.slot)));
  const unsigned char* V = static_cast<const unsigned char*>(e.f.V);
  const int rowbytes = D * e.v_elem;
#pragma unroll
  for (int x = 0; x < EL; ++x) {
    const int j = lane + 32 * x;
    ids[j] = j < a.k && lst[x] != 0ull ? (int)composite_pos(lst[x]) : -1;
  }
  for (int d = lane; d < D; d += 32) qv[d] = query_value(e.f, bq, d);
  __syncwarp();
  const int groups = (a.k + 31) / 32;
  for (int g0 = 0; g0 < groups; g0 += G) {
    const int gn = min(G, groups - g0);
    for (int g = 0; g < gn; ++g) {
      const int cid = ids[(g0 + g) * 32 + lane];
      gather_start(rows + (size_t)g * 32 * e.slot, e.slot, V, rowbytes, e.v_rows,
                   cid > 0 ? cid : 0, lane);
    }
    gather_wait();
    for (int g = 0; g < gn; ++g) {
      const int j = (g0 + g) * 32 + lane;
      const u64 c = rescore_composite(e, qv, rows + (size_t)g * 32 * e.slot, ids[j], j, lane);
      sc[j] = j < a.k ? c : 0ull;
    }
    __syncwarp();  // the rows are read before the next batch is staged
  }
  // the k best by rank: a composite's rank among the k' (distinct) is the
  // number above it; each lane ranks its own EL against all k'
  u64 mine[EL];
  int rank[EL];
#pragma unroll
  for (int x = 0; x < EL; ++x) {
    mine[x] = lane + 32 * x < a.k ? sc[lane + 32 * x] : 0ull;
    rank[x] = 0;
  }
#pragma unroll 4
  for (int y = 0; y < a.k; ++y) {
    const u64 o = sc[y];
#pragma unroll
    for (int x = 0; x < EL; ++x) rank[x] += o > mine[x] ? 1 : 0;
  }
#pragma unroll
  for (int x = 0; x < EL; ++x) {
    const int j = lane + 32 * x;
    if (j < a.k && rank[x] < e.k) {
      const float s = composite_score(mine[x]);
      const size_t at = (size_t)bq * e.k + rank[x];
      e.out_scores[at] = s;
      e.out_ids[at] = s > REPORT_FLOOR ? ids[j] : -1;
    }
  }
}

// K4's warp route, one launch (see the note at the top). Block (x, y)
// owns catalog rows [x W, (x + 1) W) for query rows [y RB, y RB + RB); its
// warp w owns a contiguous W / nw of them.
template <int RB, int EL, int MODE>
__global__ void __launch_bounds__(WARP_THREADS, 1) coarse_warp_kernel(const WarpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b0 = blockIdx.y * RB;
  const int nb = min(RB, a.B - b0);
  const int Dp = a.Dp;
  float* qf = reinterpret_cast<float*>(smem);
  int8_t* qb = reinterpret_cast<int8_t*>(qf + RB * Dp);
  u64* sthr = reinterpret_cast<u64*>(smem + align16((size_t)RB * Dp * 5));
  u64* pub = sthr + RB;  // [MAX_WARPS][RB]
  float* den = reinterpret_cast<float*>(pub + MAX_WARPS * RB);
  int* last = reinterpret_cast<int*>(den + RB);
  u64* queues = reinterpret_cast<u64*>(smem + warp_head_bytes(RB, Dp));
  unsigned char* rings = reinterpret_cast<unsigned char*>(queues + (size_t)a.nw * RB * QUEUE);
  u64* queue = queues + (size_t)warp * RB * QUEUE;
  unsigned char* ring = rings + (size_t)warp * a.ring;
  const u64 bottom = admit_floor();

  for (int e = t; e < RB * Dp; e += blockDim.x) {
    const int r = e / Dp, d = e - r * Dp;
    qf[e] = r < nb && d < a.D ? a.q[(size_t)(b0 + r) * a.D + d] : 0.0f;
  }
  if (t < RB) sthr[t] = bottom;
  if (t < MAX_WARPS * RB) pub[t] = t / RB < a.nw ? bottom : ~0ull;  // absent warps: no bound
  __syncthreads();
  if constexpr (MODE == INT8_DOT) {  // the stream route's quantization
    if (t < RB) {
      float m = 0.0f;  // max |q|, NaN sticky as jnp.max
      for (int d = 0; d < a.D; ++d) {
        const float x = fabsf(qf[t * Dp + d]);
        m = (x > m || x != x) ? x : m;
      }
      const float qs = __fdiv_rn(m, 127.0f);
      den[t] = qs != qs ? qs : fmaxf(qs, 1e-12f);
    }
    __syncthreads();
    for (int e = t; e < RB * Dp; e += blockDim.x) {
      const int r = e / Dp, d = e - r * Dp;
      qb[e] = (int8_t)(d < a.D ? quantize(qf[e], den[r]) : 0);
    }
    __syncthreads();
  }

  // Stream the warp's rows: the next stages - 1 rounds are staged
  // (cp.async) while this round is scored; no block barrier until the end.
  u64 list[RB][EL], thr[RB];
  int cnt[RB];
#pragma unroll
  for (int b = 0; b < RB; ++b) {
#pragma unroll
    for (int e = 0; e < EL; ++e) list[b][e] = 0ull;
    thr[b] = bottom;
    cnt[b] = 0;
  }
  const long long wb = (long long)blockIdx.x * a.W + (long long)warp * (a.W / a.nw);
  const long long we = min(wb + a.W / a.nw, a.num_rows);
  const int rounds = wb < we ? (int)((we - wb + ROUND_ROWS - 1) / ROUND_ROWS) : 0;
  const int S = a.stages;
  const int share_at = (a.K + a.nw - 1) / a.nw;  // the entries each warp vouches for
  for (int j = 0; j < S - 1; ++j) {  // one group a round, empty past the last
    const long long i = wb + (long long)j * ROUND_ROWS;
    if (j < rounds)
      stage_rows(a, ring + j * a.stage_bytes, i, (int)min((long long)ROUND_ROWS, we - i), lane);
    cp_async_commit();
  }
  for (int j = 0, slot = 0; j < rounds; ++j, slot = slot + 1 == S ? 0 : slot + 1) {
    const long long i0 = wb + (long long)j * ROUND_ROWS;
    const int nr = (int)min((long long)ROUND_ROWS, we - i0);
    const int ahead = j + S - 1;  // into the slot round j - 1 left
    if (ahead < rounds) {
      const long long i1 = wb + (long long)ahead * ROUND_ROWS;
      stage_rows(a, ring + (slot == 0 ? S - 1 : slot - 1) * a.stage_bytes, i1,
                 (int)min((long long)ROUND_ROWS, we - i1), lane);
    }
    cp_async_commit();
    cp_async_wait_at_most(S - 1);  // round j's group is in
    __syncwarp();
    block_thresholds<RB>(sthr, pub, lane, thr);
    float s[LANE_ROWS][RB];
    warp_scores<RB, MODE>(a, ring + slot * a.stage_bytes, i0, qf, qb, lane, s);
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      if (b < nb) {
        u64 c[LANE_ROWS];
#pragma unroll
        for (int r = 0; r < LANE_ROWS; ++r) {
          const int x = lane + 32 * r;
          c[r] = x < nr ? composite(s[r][b], (uint32_t)(i0 + x)) : 0ull;
        }
        queue_offer(c, thr[b], queue + b * QUEUE, cnt[b], lane);
      }
    }
    __syncwarp();  // the stage is scored and the queues written
    // flush the queues that could not take another round (all, at the end)
    unsigned need = 0;
    const bool final_round = j + 1 == rounds;
#pragma unroll
    for (int b = 0; b < RB; ++b)
      need |= (cnt[b] > (final_round ? 0 : QUEUE - ROUND_ROWS) ? 1u : 0u) << b;
    while (need != 0) {  // warp-uniform; one copy of the flush, b at run time
      const int fb = __ffs(need) - 1;
      need &= need - 1;
      u64 lst[EL];
      int n = 0;
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        if (b == fb) {
#pragma unroll
          for (int e = 0; e < EL; ++e) lst[e] = list[b][e];
          n = cnt[b];
        }
      }
      fold_queue<EL>(lst, queue + fb * QUEUE, n, lane);
      const u64 kth = list_entry<EL>(lst, a.K - 1, lane);  // 0 while it holds fewer
      const u64 share = list_entry<EL>(lst, share_at - 1, lane);
      if (lane == 0) {  // the bounds the list gives the block; both only rise
        if (kth > bottom) atomicMax(sthr + fb, kth);
        if (share > pub[warp * RB + fb]) pub[warp * RB + fb] = share;
      }
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        if (b == fb) {
#pragma unroll
          for (int e = 0; e < EL; ++e) list[b][e] = lst[e];
          cnt[b] = 0;
          thr[b] = max64(thr[b], kth);
        }
      }
    }
  }

  // The block's best K a query: the warps' lists fold through shared
  // memory, then go to the workspace.
#pragma unroll
  for (int b = 0; b < RB; ++b)
#pragma unroll
    for (int e = 0; e < EL; ++e) queue[b * QUEUE + lane + 32 * e] = list[b][e];
  __syncthreads();
  for (int b = warp; b < nb; b += a.nw) {
    u64 lst[EL];
#pragma unroll
    for (int e = 0; e < EL; ++e) lst[e] = queues[b * QUEUE + lane + 32 * e];
    for (int w = 1; w < a.nw; ++w) {
      u64 o[EL];
#pragma unroll
      for (int e = 0; e < EL; ++e) o[e] = queues[((size_t)w * RB + b) * QUEUE + lane + 32 * e];
      warp_fold<EL>(lst, o, lane);
    }
    u64* out = a.ws + ((size_t)(b0 + b) * a.nblk + blockIdx.x) * a.K;
#pragma unroll
    for (int e = 0; e < EL; ++e)
      if (lane + 32 * e < a.K) out[lane + 32 * e] = lst[e];
  }

  // The last block of the query group to arrive merges the group's lists.
  __threadfence();
  __syncthreads();
  if (t == 0) *last = atomicAdd(a.tickets + blockIdx.y, 1u) == (unsigned)(a.nblk - 1);
  __syncthreads();
  if (*last == 0) return;
  __threadfence();
  if (t == 0) a.tickets[blockIdx.y] = 0u;  // ready for the next call on this stream
  u64* stg = reinterpret_cast<u64*>(rings);  // [queries][mcols][nblk]: a batch of columns
  unsigned long long epi_ns = 0ull;  // the fused epilogue's time (thread 0)
  for (int bq0 = 0; bq0 < nb; bq0 += a.nw) {
    const int nq = min(a.nw, nb - bq0), b = bq0 + warp;
    const bool mine = warp < nq;  // warp-uniform
    u64 lst[EL];
#pragma unroll
    for (int e = 0; e < EL; ++e) lst[e] = 0ull;
    int n = 0;
    u64 th = bottom;
    bool done = !mine;
    if (mine) {
      // the global K-th is at least every list's K-th: only entries at
      // or above the largest of those enter
      const u64* src = a.ws + (size_t)(b0 + b) * a.nblk * a.K;
      u64 bound = 0ull;
      for (int l = lane; l < a.nblk; l += 32)
        bound = max64(bound, __ldcg(src + (size_t)l * a.K + a.K - 1));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) bound = max64(bound, __shfl_xor_sync(0xffffffffu, bound, o));
      if (bound > bottom) th = bound - 1;
    }
    for (int p0 = 0; p0 < a.K; p0 += a.mcols) {
      const int total = nq * a.mcols * a.nblk;
#pragma unroll 8
      for (int e = t; e < total; e += blockDim.x) {
        const int l = e % a.nblk, qc = e / a.nblk;
        const int c = qc % a.mcols, qq = qc / a.mcols;
        stg[e] = __ldcg(a.ws + ((size_t)(b0 + bq0 + qq) * a.nblk + l) * a.K + p0 + c);
      }
      __syncthreads();
      // columns in order, every list's entry p before any list's p + 1;
      // once a column admits nothing, no later one can (each list
      // descends and th only rises)
      for (int c = 0; c < a.mcols && !done; ++c) {
        const u64* col = stg + ((size_t)warp * a.mcols + c) * a.nblk;
        bool any = false;
        for (int l0 = 0; l0 < a.nblk; l0 += ROUND_ROWS) {
          u64 v[LANE_ROWS];
#pragma unroll
          for (int r = 0; r < LANE_ROWS; ++r) {
            const int l = l0 + lane + 32 * r;
            v[r] = l < a.nblk ? col[l] : 0ull;
          }
          const int before = n;
          queue_offer(v, th, queue, n, lane);
          any |= n != before;
          __syncwarp();
          if (n > QUEUE - ROUND_ROWS) {
            fold_queue<EL>(lst, queue, n, lane);
            th = max64(th, list_entry<EL>(lst, a.K - 1, lane));
            n = 0;
          }
        }
        done = !any;
      }
      if (__syncthreads_and(done)) break;  // also frees the staged batch
    }
    const unsigned long long e0 = a.fused && t == 0 ? globaltimer() : 0ull;
    if (mine) {
      __syncwarp();
      if (n > 0) fold_queue<EL>(lst, queue, n, lane);
      if (a.fused) {  // the batch's staged columns are read: the rings are free
        rescore_warp<EL>(a, b0 + b, lst, rings + (size_t)warp * a.ring, lane);
      } else {
#pragma unroll
        for (int e = 0; e < EL; ++e) {
          const int x = lane + 32 * e;
          if (x < a.k) {
            const u64 c = lst[e];
            const size_t o = (size_t)(b0 + b) * a.k + x;
            a.out_scores[o] = c != 0ull ? composite_score(c) : NEG_INF;
            a.out_ids[o] = c != 0ull ? (int)composite_pos(c) : -1;
          }
        }
      }
    }
    __syncthreads();
    if (a.fused && t == 0) epi_ns += globaltimer() - e0;
  }
  if (a.fused && t == 0) a.e.timer[blockIdx.y] = epi_ns;
}

// -- K4's stream route: lists in shared memory (see the note at the top) ----------

// Compact the entries of row above t to its front, in entry order. One warp.
__device__ __forceinline__ void keep_above(u64* row, int n, u64 t, int lane) {
  const unsigned below = (1u << lane) - 1u;
  int out = 0;
  for (int e0 = 0; e0 < n; e0 += 32) {
    const int e = e0 + lane;
    const u64 v = e < n ? row[e] : 0ull;
    const bool ok = e < n && v > t;
    const unsigned bal = __ballot_sync(0xffffffffu, ok);
    __syncwarp();  // the chunk is read before any of it is overwritten
    if (ok) row[out + __popc(bal & below)] = v;
    out += __popc(bal);
  }
  __syncwarp();
}

// Keep the `keep` largest of the n (> keep) distinct entries of row, in
// place and in no order; returns the least kept. A radix select on the
// warp's histogram (RADIX bins, 8 bits a pass from the top, until one
// entry is left in the target's bin), then a compaction in entry order.
__device__ u64 cut_row(u64* row, int n, int keep, unsigned* hist, int lane) {
  u64 prefix = 0ull, mask = 0ull;
  unsigned want = (unsigned)keep;  // the target's rank among the entries matching prefix
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = lane; i < RADIX; i += 32) hist[i] = 0u;
    __syncwarp();
    for (int e = lane; e < n; e += 32) {
      const u64 v = row[e];
      if ((v & mask) == prefix) atomicAdd(hist + (int)((v >> shift) & 255u), 1u);
    }
    __syncwarp();
    // lane l holds bins 255 - 8l down to 248 - 8l: a prefix over the
    // lanes counts the entries above each bin
    unsigned c[8], tot = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = hist[255 - 8 * lane - j];
      tot += c[j];
    }
    unsigned incl = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const unsigned excl = incl - tot;
    const bool here = excl < want && want <= incl;  // one lane
    const int src = __ffs(__ballot_sync(0xffffffffu, here)) - 1;
    int digit = 0;
    unsigned above = 0u, count = 0u, run = excl;
    bool found = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (here && !found && run + c[j] >= want) {
        digit = 255 - 8 * lane - j;
        above = run;
        count = c[j];
        found = true;
      }
      run += c[j];
    }
    digit = __shfl_sync(0xffffffffu, digit, src);
    above = __shfl_sync(0xffffffffu, above, src);
    count = __shfl_sync(0xffffffffu, count, src);
    want -= above;
    prefix |= (u64)digit << shift;
    mask |= 0xFFull << shift;
    __syncwarp();  // the histogram is read before it is cleared again
    if (count == 1u) break;
  }
  u64 kth = 0ull;  // the one entry matching prefix
  for (int e0 = 0; e0 < n; e0 += 32) {
    const int e = e0 + lane;
    const u64 v = e < n ? row[e] : 0ull;
    const unsigned hit = __ballot_sync(0xffffffffu, e < n && (v & mask) == prefix);
    if (hit != 0u) {
      kth = __shfl_sync(0xffffffffu, v, __ffs(hit) - 1);
      break;
    }
  }
  keep_above(row, n, kth - 1, lane);
  return kth;
}

// Thin the n distinct entries of row to those above a pivot that leaves
// between lo_keep and hi_keep of them (in entry order): 32 samples, one a
// lane spread over the row, sorted in the warp (K2's network), give
// pivots; one ballot-counting pass checks each (a few tries). Returns the
// entries kept and sets *th to the pivot, or -1 (row unchanged) when no
// try lands in the window. One warp.
__device__ int thin_row(u64* row, int n, int lo_keep, int hi_keep, u64* th, int lane) {
  if (n < 64 || hi_keep - lo_keep < n / 16) return -1;
  u64 smp[1] = {row[(int)((long long)lane * n / 32)]};
  warp_sort<1>(smp, lane);  // descending: sample r has about (r + 1) n / 32 entries at or above it
  int r = (int)(((long long)(lo_keep + hi_keep) / 2 * 32) / n) - 1;
  for (int tries = 0; tries < 3; ++tries) {
    r = max(0, min(31, r));
    const u64 t = __shfl_sync(0xffffffffu, smp[0], r);
    int above = 0;
    for (int e0 = 0; e0 < n; e0 += 32) {
      const int e = e0 + lane;
      above += __popc(__ballot_sync(0xffffffffu, e < n && row[e] > t));
    }
    if (above < lo_keep) {
      ++r;  // a lower pivot
    } else if (above > hi_keep) {
      --r;
    } else {
      keep_above(row, n, t, lane);
      *th = t;
      return above;
    }
  }
  return -1;
}

__device__ __forceinline__ void lock_query(int* lock, int lane) {
  if (lane == 0) {
    while (atomicCAS(lock, 0, 1) != 0) {
    }
  }
  __syncwarp();
  __threadfence_block();
}

__device__ __forceinline__ void unlock_query(int* lock, int lane) {
  __threadfence_block();
  __syncwarp();
  if (lane == 0) atomicExch(lock, 0);
}

// Append the entries of a warp's queue q (n <= QUEUE, any order) above the
// query's threshold to its buffer (cap entries, cnt held), under its
// lock; when they could overflow the buffer it is first thinned to
// between K and cap - QUEUE entries above a sampled pivot (or, when no
// pivot lands there, cut to its best K), and the pivot (or the least kept)
// becomes the threshold: at least K entries are at or above it. Returns the
// threshold.
__device__ u64 stream_flush(u64* buf, int* cnt, u64* thr, int* lock, int K, int cap, const u64* q,
                           int n, unsigned* hist, int lane) {
  lock_query(lock, lane);
  u64 th = *reinterpret_cast<volatile u64*>(thr);
  int m = *reinterpret_cast<volatile int*>(cnt);
  int in = 0;
  for (int e0 = 0; e0 < n; e0 += 32)
    in += __popc(__ballot_sync(0xffffffffu, e0 + lane < n && q[e0 + lane] > th));
  if (m + in > cap) {  // then m > K: cap >= K + QUEUE
    const int kept = thin_row(buf, m, K, cap - QUEUE, &th, lane);
    if (kept >= 0) {
      m = kept;
    } else {
      th = cut_row(buf, m, K, hist, lane);
      m = K;
    }
    if (lane == 0) *reinterpret_cast<volatile u64*>(thr) = th;
  }
  const unsigned below = (1u << lane) - 1u;
  for (int e0 = 0; e0 < n; e0 += 32) {
    const int e = e0 + lane;
    const u64 v = e < n ? q[e] : 0ull;
    const bool ok = e < n && v > th;
    const unsigned bal = __ballot_sync(0xffffffffu, ok);
    if (ok) buf[m + __popc(bal & below)] = v;
    m += __popc(bal);
  }
  if (lane == 0) *reinterpret_cast<volatile int*>(cnt) = m;
  unlock_query(lock, lane);
  return th;
}

// K4's stream route, one launch (see the note at the top). Block (x, y)
// owns catalog rows [x W, (x + 1) W) for query rows [y RB, y RB + RB); its
// warp w owns a contiguous W / nw of them.
template <int RB, int MODE>
__global__ void __launch_bounds__(WARP_THREADS, 1) coarse_stream_kernel(const WarpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b0 = blockIdx.y * RB;
  const int nb = min(RB, a.B - b0);
  const int Dp = a.Dp, K = a.K, cap = a.cap, nt = blockDim.x;
  float* qf = reinterpret_cast<float*>(smem);
  int8_t* qb = reinterpret_cast<int8_t*>(qf + RB * Dp);
  unsigned char* ctl = smem + align16((size_t)RB * Dp * 5);
  u64* thr = reinterpret_cast<u64*>(ctl);  // [RB]
  int* cnt = reinterpret_cast<int*>(thr + RB);
  int* lock = cnt + RB;
  float* den = reinterpret_cast<float*>(lock + RB);
  int* last = reinterpret_cast<int*>(den + RB);
  u64* bufs = reinterpret_cast<u64*>(ctl + stream_ctl_bytes(RB));  // [RB][cap]
  u64* queues = reinterpret_cast<u64*>(reinterpret_cast<unsigned char*>(bufs) +
                                       align16((size_t)RB * cap * sizeof(u64)));
  unsigned* hists = reinterpret_cast<unsigned*>(queues + (size_t)a.nw * RB * QUEUE);
  unsigned char* rings = reinterpret_cast<unsigned char*>(hists + a.nw * RADIX);
  u64* queue = queues + (size_t)warp * RB * QUEUE;
  unsigned* hist = hists + warp * RADIX;
  unsigned char* ring = rings + (size_t)warp * a.ring;
  const u64 bottom = admit_floor();

  for (int e = t; e < RB * Dp; e += nt) {
    const int r = e / Dp, d = e - r * Dp;
    qf[e] = r < nb && d < a.D ? a.q[(size_t)(b0 + r) * a.D + d] : 0.0f;
  }
  if (t < RB) {
    thr[t] = bottom;
    cnt[t] = 0;
    lock[t] = 0;
  }
  __syncthreads();
  if constexpr (MODE == INT8_DOT) {  // the warp route's quantization
    if (t < RB) {
      float m = 0.0f;  // max |q|, NaN sticky as jnp.max
      for (int d = 0; d < a.D; ++d) {
        const float x = fabsf(qf[t * Dp + d]);
        m = (x > m || x != x) ? x : m;
      }
      const float qs = __fdiv_rn(m, 127.0f);
      den[t] = qs != qs ? qs : fmaxf(qs, 1e-12f);
    }
    __syncthreads();
    for (int e = t; e < RB * Dp; e += nt) {
      const int r = e / Dp, d = e - r * Dp;
      qb[e] = (int8_t)(d < a.D ? quantize(qf[e], den[r]) : 0);
    }
    __syncthreads();
  }

  // Stream the warp's rows as the warp route does; the queues flush into
  // the block's buffers. No block barrier until the end.
  u64 th[RB];
  int qn[RB];
#pragma unroll
  for (int b = 0; b < RB; ++b) {
    th[b] = bottom;
    qn[b] = 0;
  }
  const long long wb = (long long)blockIdx.x * a.W + (long long)warp * (a.W / a.nw);
  const long long we = min(wb + a.W / a.nw, a.num_rows);
  const int rounds = wb < we ? (int)((we - wb + ROUND_ROWS - 1) / ROUND_ROWS) : 0;
  const int S = a.stages;
  for (int j = 0; j < S - 1; ++j) {
    const long long i = wb + (long long)j * ROUND_ROWS;
    if (j < rounds)
      stage_rows(a, ring + j * a.stage_bytes, i, (int)min((long long)ROUND_ROWS, we - i), lane);
    cp_async_commit();
  }
  for (int j = 0, slot = 0; j < rounds; ++j, slot = slot + 1 == S ? 0 : slot + 1) {
    const long long i0 = wb + (long long)j * ROUND_ROWS;
    const int nr = (int)min((long long)ROUND_ROWS, we - i0);
    const int ahead = j + S - 1;
    if (ahead < rounds) {
      const long long i1 = wb + (long long)ahead * ROUND_ROWS;
      stage_rows(a, ring + (slot == 0 ? S - 1 : slot - 1) * a.stage_bytes, i1,
                 (int)min((long long)ROUND_ROWS, we - i1), lane);
    }
    cp_async_commit();
    cp_async_wait_at_most(S - 1);
    __syncwarp();
#pragma unroll
    for (int b = 0; b < RB; ++b) th[b] = max64(th[b], reinterpret_cast<volatile u64*>(thr)[b]);
    float s[LANE_ROWS][RB];
    warp_scores<RB, MODE>(a, ring + slot * a.stage_bytes, i0, qf, qb, lane, s);
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      if (b < nb) {
        u64 c[LANE_ROWS];
#pragma unroll
        for (int r = 0; r < LANE_ROWS; ++r) {
          const int x = lane + 32 * r;
          c[r] = x < nr ? composite(s[r][b], (uint32_t)(i0 + x)) : 0ull;
        }
        queue_offer(c, th[b], queue + b * QUEUE, qn[b], lane);
      }
    }
    __syncwarp();
    unsigned need = 0;
    const bool final_round = j + 1 == rounds;
#pragma unroll
    for (int b = 0; b < RB; ++b)
      need |= (qn[b] > (final_round ? 0 : QUEUE - ROUND_ROWS) ? 1u : 0u) << b;
    while (need != 0) {  // warp-uniform; one copy of the flush, b at run time
      const int fb = __ffs(need) - 1;
      need &= need - 1;
      int n = 0;
#pragma unroll
      for (int b = 0; b < RB; ++b)
        if (b == fb) n = qn[b];
      const u64 nt_ = stream_flush(bufs + (size_t)fb * cap, cnt + fb, thr + fb, lock + fb, K, cap,
                                   queue + fb * QUEUE, n, hist, lane);
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        if (b == fb) {
          qn[b] = 0;
          th[b] = max64(th[b], nt_);
        }
      }
    }
  }
  __syncthreads();

  // The block's best K a query, sorted, to the workspace.
  for (int b = warp; b < nb; b += a.nw) {
    if (cnt[b] > K) {
      cut_row(bufs + (size_t)b * cap, cnt[b], K, hist, lane);
      if (lane == 0) cnt[b] = K;
    }
  }
  __syncthreads();
  for (int e = t; e < RB * K; e += nt) {
    const int b = e >> a.lg_k, x = e & (K - 1);
    if (x >= cnt[b]) bufs[(size_t)b * cap + x] = 0ull;
  }
  __syncthreads();
  sort_rows_n(bufs, nb, K, a.lg_k, cap, nt);
  for (int e = t; e < nb * K; e += nt) {
    const int b = e >> a.lg_k, x = e & (K - 1);
    a.ws[((size_t)(b0 + b) * a.nblk + blockIdx.x) * K + x] = bufs[(size_t)b * cap + x];
  }

  // The last block of the query group to arrive merges the group's lists.
  __threadfence();
  __syncthreads();
  if (t == 0) *last = atomicAdd(a.tickets + blockIdx.y, 1u) == (unsigned)(a.nblk - 1);
  __syncthreads();
  if (*last == 0) return;
  __threadfence();
  if (t == 0) a.tickets[blockIdx.y] = 0u;  // ready for the next call on this stream
  for (int b = warp; b < nb; b += a.nw) {  // a warp a query
    u64* buf = bufs + (size_t)b * cap;
    const u64* src = a.ws + (size_t)(b0 + b) * a.nblk * K;
    // the global K-th is at least every list's K-th: only entries at or
    // above the largest of those enter
    u64 bound = 0ull;
    for (int l = lane; l < a.nblk; l += 32) bound = max64(bound, __ldcg(src + (size_t)l * K + K - 1));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) bound = max64(bound, __shfl_xor_sync(0xffffffffu, bound, o));
    u64 th_ = bound > bottom ? bound - 1 : bottom;
    if (lane == 0) {
      thr[b] = th_;
      cnt[b] = 0;
    }
    __syncwarp();
    u64* stg = reinterpret_cast<u64*>(ring);  // [mcols][nblk]: a batch of columns
    int n = 0;
    bool done = false;
    for (int p0 = 0; p0 < K && !done; p0 += a.mcols) {
      for (int e = lane; e < a.mcols * a.nblk; e += 32) {
        const int c = e / a.nblk, l = e - c * a.nblk;
        stg[e] = __ldcg(src + (size_t)l * K + p0 + c);
      }
      __syncwarp();
      // columns in order; once a column admits nothing, no later one can
      // (each list descends and the threshold only rises)
      for (int c = 0; c < a.mcols && !done; ++c) {
        const u64* col = stg + (size_t)c * a.nblk;
        bool any = false;
        for (int l0 = 0; l0 < a.nblk; l0 += ROUND_ROWS) {
          u64 v[LANE_ROWS];
#pragma unroll
          for (int r = 0; r < LANE_ROWS; ++r) {
            const int l = l0 + lane + 32 * r;
            v[r] = l < a.nblk ? col[l] : 0ull;
          }
          const int before = n;
          queue_offer(v, th_, queue, n, lane);
          any |= n != before;
          __syncwarp();
          if (n > QUEUE - ROUND_ROWS) {
            th_ = max64(th_, stream_flush(buf, cnt + b, thr + b, lock + b, K, cap, queue, n, hist,
                                          lane));
            n = 0;
          }
        }
        done = !any;
      }
      __syncwarp();  // the batch is read before the next is staged
    }
    if (n > 0) stream_flush(buf, cnt + b, thr + b, lock + b, K, cap, queue, n, hist, lane);
    const int m = *reinterpret_cast<volatile int*>(cnt + b);
    if (m > a.k) {
      cut_row(buf, m, a.k, hist, lane);
      if (lane == 0) cnt[b] = a.k;
    }
    __syncwarp();
  }
  __syncthreads();
  for (int e = t; e < nb * K; e += nt) {
    const int b = e >> a.lg_k, x = e & (K - 1);
    if (x >= cnt[b]) bufs[(size_t)b * cap + x] = 0ull;
  }
  __syncthreads();
  sort_rows_n(bufs, nb, K, a.lg_k, cap, nt);  // each query's shortlist: its first k entries
  if (!a.fused) {
    for (int e = t; e < nb * a.k; e += nt) {
      const int b = e / a.k, x = e - b * a.k;
      const u64 c = bufs[(size_t)b * cap + x];
      const size_t o = (size_t)(b0 + b) * a.k + x;
      a.out_scores[o] = c != 0ull ? composite_score(c) : NEG_INF;
      a.out_ids[o] = c != 0ull ? (int)composite_pos(c) : -1;
    }
    return;
  }

  // The fused epilogue: K5 on the group's shortlists. The queues hold the
  // query vectors; each warp rescores groups of 32 shortlist positions j
  // of a query, staging their rows in its share of the free shared
  // memory, into buf[K + j]; each
  // query's k' rescored entries are cut to their best e.k, which are
  // sorted and written out.
  const unsigned long long e0 = t == 0 ? globaltimer() : 0ull;
  const EpiArgs& e = a.e;
  const int D = e.f.D;
  float* qv = reinterpret_cast<float*>(queues);  // [nb][D]
  for (int i = t; i < nb * D; i += nt) qv[i] = query_value(e.f, b0 + i / D, i % D);
  __syncthreads();
  const unsigned char* V = static_cast<const unsigned char*>(e.f.V);
  const int groups = (K + 31) / 32;  // a query's groups of 32 positions
  // the queues past the query vectors, the histograms and the rings are
  // free now and contiguous: each warp stages in its share of them
  unsigned char* free0 = reinterpret_cast<unsigned char*>(queues) + align16((size_t)nb * D * 4);
  const size_t share = (size_t)((rings + (size_t)a.nw * a.ring) - free0) / a.nw & ~(size_t)15;
  unsigned char* stage = free0 + (size_t)warp * share;
  const int G = max(1, (int)(share / (32 * (size_t)e.slot)));  // groups a warp stages at once
  for (int g0 = warp; g0 < nb * groups; g0 += a.nw * G) {
    // the warp's groups g0, g0 + nw, ...: all gathered, then all scored
    int n = 0;
    for (int g = g0; g < nb * groups && n < G; g += a.nw, ++n) {
      const int b = g / groups, j0 = (g - b * groups) * 32, j = j0 + lane;
      const u64 x = j < a.k ? bufs[(size_t)b * cap + j] : 0ull;
      const int cid = x != 0ull ? (int)composite_pos(x) : -1;
      if (j0 < a.k)  // warp-uniform: groups past k' stage nothing
        gather_start(stage + (size_t)n * 32 * e.slot, e.slot, V, D * e.v_elem, e.v_rows,
                     cid > 0 ? cid : 0, lane);
    }
    gather_wait();
    n = 0;
    for (int g = g0; g < nb * groups && n < G; g += a.nw, ++n) {
      const int b = g / groups, j = (g - b * groups) * 32 + lane;
      u64* buf = bufs + (size_t)b * cap;
      const u64 x = j < a.k ? buf[j] : 0ull;
      const int cid = x != 0ull ? (int)composite_pos(x) : -1;
      if (j < K)
        buf[K + j] = j < a.k ? rescore_composite(e, qv + (size_t)b * D,
                                                 stage + (size_t)n * 32 * e.slot, cid, j, lane)
                             : 0ull;
    }
    __syncwarp();  // the rows are read before the next batch is staged
  }
  __syncthreads();
  // each query's best e.k of its k' rescored: cut (a warp a query), then
  // the block sorts them, pow2(e.k) entries a query
  int lg = 0;
  while ((1 << lg) < e.k) ++lg;
  for (int b = warp; b < nb; b += a.nw)
    if (a.k > e.k) cut_row(bufs + (size_t)b * cap + K, a.k, e.k, hist, lane);
  __syncthreads();
  for (int i = t; i < nb * (1 << lg); i += nt) {
    const int b = i >> lg, x = i & ((1 << lg) - 1);
    if (x >= e.k) bufs[(size_t)b * cap + K + x] = 0ull;
  }
  __syncthreads();
  sort_rows_n(bufs + K, nb, 1 << lg, lg, cap, nt);
  for (int i = t; i < nb * e.k; i += nt) {
    const int b = i / e.k, x = i - b * e.k;
    const u64* buf = bufs + (size_t)b * cap;
    const u64 c = buf[K + x];
    const float sc = composite_score(c);
    const u64 cand = buf[composite_pos(c)];
    const size_t o = (size_t)(b0 + b) * e.k + x;
    e.out_scores[o] = sc;
    e.out_ids[o] = sc > REPORT_FLOOR && cand != 0ull ? (int)composite_pos(cand) : -1;
  }
  __syncthreads();
  if (t == 0) e.timer[blockIdx.y] = globaltimer() - e0;
}

struct RescoreArgs {
  QueryForm f;
  const int* cand;        // [B, S]
  int S, S2, lg_s2, k;
  float* out_scores;      // [B, k]
  int* out_ids;
};

// K5 standalone (see the note at the top): one block a query row.
__global__ void __launch_bounds__(RESCORE_THREADS) rescore_kernel(const RescoreArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* buf = reinterpret_cast<u64*>(smem);          // [S2]
  float* q = reinterpret_cast<float*>(buf + a.S2);  // [D]
  const unsigned char* V = static_cast<const unsigned char*>(a.f.V);
  const int b = blockIdx.x, t = threadIdx.x, D = a.f.D;
  const size_t rowbytes = (size_t)D * dtype_bytes(a.f.v_dtype);
  for (int d = t; d < D; d += RESCORE_THREADS) q[d] = query_value(a.f, b, d);
  __syncthreads();
  const int* cr = a.cand + (size_t)b * a.S;
  for (int j = t; j < a.S2; j += RESCORE_THREADS) {
    u64 c = 0ull;  // below every real entry's composite
    if (j < a.S) {
      const int cid = cr[j];
      const int row = cid > 0 ? cid : 0;
      const float s = exact_score(a.f, q, V + row * rowbytes, row);
      c = composite(cid < 0 ? NEG_INF : s, (uint32_t)j);
    }
    buf[j] = c;
  }
  __syncthreads();
  sort_rows<RESCORE_THREADS>(buf, 1, a.S2, a.lg_s2);
  for (int j = t; j < a.k; j += RESCORE_THREADS) {
    const u64 c = buf[j];
    const float s = composite_score(c);
    const size_t o = (size_t)b * a.k + j;
    a.out_scores[o] = s;
    a.out_ids[o] = s > REPORT_FLOOR ? cr[composite_pos(c)] : -1;
  }
}

// The error of the launch just made; one more on *launched if it went out.
cudaError_t counted(int* launched) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

int log2_exact(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return (1 << l) == x ? l : -1;
}

// Raise the kernel's dynamic shared memory cap to `bytes` when above the
// default 48 KB.
template <typename F>
cudaError_t allow_smem(F kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int RB, int MODE>
cudaError_t launch_tile(const CoarseArgs& a, cudaStream_t s, int* launched) {
  const size_t bytes = align16(stream_bytes<RB, TILE_THREADS>(a.S)) +
                       (size_t)RB * a.Dp * sizeof(float) + (size_t)RB * a.Dp;
  cudaError_t err = allow_smem(coarse_tile_kernel<RB, MODE>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.nblk, (a.B + RB - 1) / RB);
  coarse_tile_kernel<RB, MODE><<<grid, TILE_THREADS, bytes, s>>>(a);
  return counted(launched);
}

template <int MODE>
cudaError_t launch_tile_rb(int rb, const CoarseArgs& a, cudaStream_t s, int* launched) {
  switch (rb) {
    case 8: return launch_tile<8, MODE>(a, s, launched);
    case 4: return launch_tile<4, MODE>(a, s, launched);
    case 2: return launch_tile<2, MODE>(a, s, launched);
    case 1: return launch_tile<1, MODE>(a, s, launched);
    default: return cudaErrorInvalidValue;
  }
}

template <int RB, int EL, int MODE>
cudaError_t launch_warp(const WarpArgs& a, size_t bytes, cudaStream_t s, int* launched) {
  cudaError_t err = allow_smem(coarse_warp_kernel<RB, EL, MODE>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.nblk, (a.B + RB - 1) / RB);
  coarse_warp_kernel<RB, EL, MODE><<<grid, a.nw * 32, bytes, s>>>(a);
  return counted(launched);
}

template <int RB, int MODE>
cudaError_t launch_warp_el(int el, const WarpArgs& a, size_t bytes, cudaStream_t s,
                           int* launched) {
  switch (el) {
    case 1: return launch_warp<RB, 1, MODE>(a, bytes, s, launched);
    case 2: return launch_warp<RB, 2, MODE>(a, bytes, s, launched);
    case 4: return launch_warp<RB, 4, MODE>(a, bytes, s, launched);
    default: return cudaErrorInvalidValue;
  }
}

template <int RB, int MODE>
cudaError_t launch_stream(const WarpArgs& a, size_t bytes, cudaStream_t s, int* launched) {
  cudaError_t err = allow_smem(coarse_stream_kernel<RB, MODE>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.nblk, (a.B + RB - 1) / RB);
  coarse_stream_kernel<RB, MODE><<<grid, a.nw * 32, bytes, s>>>(a);
  return counted(launched);
}

// route 0: the warp route, el registers of list a lane; route 1: the
// stream route.
template <int RB, int MODE>
cudaError_t launch_route(int route, int el, const WarpArgs& a, size_t bytes, cudaStream_t s,
                         int* launched) {
  return route == 0 ? launch_warp_el<RB, MODE>(el, a, bytes, s, launched)
                    : launch_stream<RB, MODE>(a, bytes, s, launched);
}

template <int MODE>
cudaError_t launch_rb(int route, int rb, int el, const WarpArgs& a, size_t bytes, cudaStream_t s,
                      int* launched) {
  switch (rb) {
    case 8: return launch_route<8, MODE>(route, el, a, bytes, s, launched);
    case 4: return launch_route<4, MODE>(route, el, a, bytes, s, launched);
    case 2: return launch_route<2, MODE>(route, el, a, bytes, s, launched);
    case 1: return launch_route<1, MODE>(route, el, a, bytes, s, launched);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_rescore(const RescoreArgs& a, int B, cudaStream_t s, int* launched) {
  const size_t bytes = (size_t)a.S2 * sizeof(u64) + (size_t)a.f.D * sizeof(float);
  cudaError_t err = allow_smem(rescore_kernel, bytes);
  if (err != cudaSuccess) return err;
  rescore_kernel<<<B, RESCORE_THREADS, bytes, s>>>(a);
  return counted(launched);
}

// A K5 query form, checked: -1 when no kernel takes it.
bool form_ok(const QueryForm& f) {
  if (f.query < GATHER || f.query > SUM_ROWS || f.D <= 0 || f.V == nullptr || f.L < 0) return false;
  if (dtype_bytes(f.v_dtype) == 0 || (f.v_dtype == I8) != (f.v_scales != nullptr)) return false;
  if (f.query == GATHER && (dtype_bytes(f.u_dtype) == 0 || f.U == nullptr || f.ixs == nullptr ||
                            (f.u_dtype == I8) != (f.u_scales != nullptr)))
    return false;
  if (f.query == VECTORS && f.vecs == nullptr) return false;
  if (f.query == SUM_ROWS && (f.ixs == nullptr || f.row_w == nullptr)) return false;
  return true;
}

// Shared memory of a K4 block (route 0 warp, 1 stream) for k winners;
// v_dtype: the item table's dtype of a fused call, -1 for K4 alone. -1
// for arguments no block takes.
long long k4_smem(int route, int rb, int nw, int D, int mode, int stages, int k, int v_dtype) {
  if ((rb != 1 && rb != 2 && rb != 4 && rb != 8) || nw < 1 || nw > MAX_WARPS || D <= 0 ||
      mode < INT8 || mode > BF16 || stages < 2 || stages > MAX_STAGES || k < 1 ||
      k > (route == 0 ? WARP_MAX_K : MAX_K) || route < 0 || route > 1 ||
      (v_dtype >= 0 && dtype_bytes(v_dtype) == 0))
    return -1;
  int K = 1;
  while (K < k) K <<= 1;
  const int elem = mode == BF16 ? 2 : 1;
  const size_t ring = ring_bytes(D, elem, (D * elem) % 16 == 0, mode != BF16, stages,
                                 v_dtype >= 0 ? dtype_bytes(v_dtype) : 0);
  return (long long)(route == 0 ? warp_smem_bytes(rb, nw, D, ring)
                                : stream_smem_bytes(rb, nw, D, K, ring));
}

// K4 on one of its one-launch routes, alone (epi null) or with the fused
// K5 epilogue; see pio_k4_top_k and pio_k4_two_stage.
int k4_launch(int route, const float* q, int B, int D, const void* V, const float* scales,
              long long num_rows, long long v_rows, int mode, int k, int rb, int nw, long long W,
              int nblk, int stages, int mcols, void* ws, unsigned* tickets, float* out_scores,
              int* out_ids, const EpiArgs* epi, int* launched, void* stream) {
  const int v_dtype = epi != nullptr ? epi->f.v_dtype : -1;
  const long long smem = k4_smem(route, rb, nw, D, mode, stages, k, v_dtype);
  int K = 1, lg_k = 0;
  while (K < k) K <<= 1, ++lg_k;
  if (B <= 0 || num_rows <= 0 || v_rows < num_rows || smem < 0 || W <= 0 ||
      W % ((long long)ROUND_ROWS * nw) != 0 || nblk != (int)((num_rows + W - 1) / W) ||
      mcols <= 0 || (mcols & (mcols - 1)) != 0 || mcols > K || mcols > MERGE_MAX_COLS ||
      (B + rb - 1) / rb > 65535 || ws == nullptr || tickets == nullptr || launched == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((mode == BF16) != (scales == nullptr) || ((uintptr_t)V & 15u) != 0 ||
      ((uintptr_t)scales & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  const int elem = mode == BF16 ? 2 : 1;
  const bool vec = (D * elem) % 16 == 0;
  const size_t stage = warp_stage_bytes(D, elem, vec, mode != BF16);
  const size_t ring = ring_bytes(D, elem, vec, mode != BF16, stages,
                                 epi != nullptr ? dtype_bytes(v_dtype) : 0);
  // the merge stages mcols columns of every list: of min(nw, rb) queries
  // in all the rings (warp route), of one query in a warp's share (stream)
  const size_t staged = (size_t)mcols * nblk * sizeof(u64);
  if (route == 0 ? (size_t)(nw < rb ? nw : rb) * staged > (size_t)nw * ring : staged > ring)
    return (int)cudaErrorInvalidValue;
  WarpArgs a{q, B, D, (D + 15) / 16 * 16, V, scales, num_rows, v_rows, W, nblk, nw, k, K, lg_k,
             D * elem, vec, (int)warp_rows_bytes(D, elem, vec), (int)stage, stages, (int)ring,
             stream_cap(K), mcols, static_cast<u64*>(ws), tickets, out_scores, out_ids,
             epi != nullptr, EpiArgs{}};
  if (epi != nullptr) {
    a.e = *epi;
    if (!form_ok(epi->f) || epi->f.D != D || epi->k < 1 || epi->k > k || epi->v_rows < num_rows ||
        epi->out_scores == nullptr || epi->out_ids == nullptr || epi->timer == nullptr ||
        (route == 1 && (size_t)rb * D * sizeof(float) > (size_t)nw * rb * QUEUE * sizeof(u64)))
      return (int)cudaErrorInvalidValue;
  } else if (out_scores == nullptr || out_ids == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int el = K <= 32 ? 1 : K / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case INT8: return (int)launch_rb<INT8>(route, rb, el, a, (size_t)smem, s, launched);
    case INT8_DOT: return (int)launch_rb<INT8_DOT>(route, rb, el, a, (size_t)smem, s, launched);
    case BF16: return (int)launch_rb<BF16>(route, rb, el, a, (size_t)smem, s, launched);
    default: return (int)cudaErrorInvalidValue;
  }
}

__global__ void timer_tick_kernel(unsigned long long* out, int samples) {
  unsigned long long prev = globaltimer(), tick = ~0ull;
  for (int i = 0; i < samples; ++i) {
    const unsigned long long now = globaltimer();
    if (now != prev) {
      tick = now - prev < tick ? now - prev : tick;
      prev = now;
    }
  }
  *out = tick;
}

}  // namespace

extern "C" {

// Every entry adds the kernels it launches to *launched (host memory, not
// null) and returns the first error, or cudaSuccess.

// Shared-memory bytes one coarse block of the pair's tile launch takes at
// `rb` query rows, buffer width S and query width D: ops/retrieval.py
// k4_plan sizes rb by it.
long long pio_k4_tile_smem(int rb, int S, int D) {
  const int Dp = (D + 15) / 16 * 16;
  size_t stream;
  switch (rb) {
    case 8: stream = stream_bytes<8, TILE_THREADS>(S); break;
    case 4: stream = stream_bytes<4, TILE_THREADS>(S); break;
    case 2: stream = stream_bytes<2, TILE_THREADS>(S); break;
    case 1: stream = stream_bytes<1, TILE_THREADS>(S); break;
    default: return -1;
  }
  return (long long)(align16(stream) + (size_t)rb * Dp * (sizeof(float) + 1));
}

// K4's pair (the stream route before the one-launch design, kept as a
// baseline): the best k of each of B query rows over the coarse catalog,
// in two launches. q: [B, D] f32; V: [N, D] int8 (mode 0, 1) or bf16 (mode
// 2) with scales [N] f32 for the int8 modes; rows from num_rows on are
// padding. Plan (ops/retrieval.py k4_plan, route "pair"): rb query rows a
// block, W catalog rows a block (nblk = ceil(num_rows / W) blocks), K =
// the power of two >= k, S (tile) and S2 (merge) the buffers' entries a
// row. ws: [B, nblk, K] u64 workspace. Outputs [B, k] f32 scores and
// int32 ids.
int pio_k4_coarse_top_k(const float* q, int B, int D, const void* V, const float* scales,
                        long long num_rows, int mode, int k, int rb, long long W, int nblk,
                        int K, int S, int S2, void* ws, float* out_scores, int* out_ids,
                        int* launched, void* stream) {
  const int lg_s = log2_exact(S), lg_s2 = log2_exact(S2), lg_k = log2_exact(K);
  if (B <= 0 || D <= 0 || num_rows <= 0 || k <= 0 || k > K || K > MAX_K || lg_k < 0 ||
      lg_s < 0 || lg_s2 < 0 || S < K + TILE_THREADS || S2 < K + MERGE_THREADS || W <= 0 ||
      W % TILE_THREADS != 0 || nblk != (int)((num_rows + W - 1) / W) ||
      (B + rb - 1) / rb > 65535 || launched == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((mode == BF16) != (scales == nullptr)) return (int)cudaErrorInvalidValue;
  const int elem = mode == BF16 ? 2 : 1;
  const bool aligned = ((uintptr_t)V & 15u) == 0;
  const CoarseArgs a{q, B, D, (D + 15) / 16 * 16, V, scales, num_rows, W, nblk, K, S, lg_s,
                     aligned && (D * elem) % 16 == 0, static_cast<u64*>(ws)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case INT8: err = launch_tile_rb<INT8>(rb, a, s, launched); break;
    case INT8_DOT: err = launch_tile_rb<INT8_DOT>(rb, a, s, launched); break;
    case BF16: err = launch_tile_rb<BF16>(rb, a, s, launched); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = stream_bytes<1, MERGE_THREADS>(S2);
  err = allow_smem(coarse_merge_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  coarse_merge_kernel<<<B, MERGE_THREADS, bytes, s>>>(static_cast<const u64*>(ws), nblk, K,
                                                     S2, lg_s2, k, out_scores, out_ids);
  return (int)counted(launched);
}

// Shared-memory bytes of a block of K4's warp route (route 0) or stream
// route (route 1) of `rb` query rows, `nw` warps and rings of `stages` at
// query width D in `mode` for k winners; v_dtype: the item table's dtype
// (0 f32, 1 bf16, 2 int8) of a fused call, -1 for K4 alone.
// ops/retrieval.py k4_plan sizes its plans by the same sum. -1 for
// arguments no block takes.
long long pio_k4_smem(int route, int rb, int nw, int D, int mode, int stages, int k, int v_dtype) {
  return k4_smem(route, rb, nw, D, mode, stages, k, v_dtype);
}

// K4 on its one-launch routes (route 0, the warp route, k <= WARP_MAX_K;
// route 1, the stream route, k <= MAX_K): the best k of each of B query
// rows over the coarse catalog. q, V, scales, num_rows, mode as
// pio_k4_coarse_top_k; V and scales 16-byte aligned, v_rows the rows V
// holds. Plan (ops/retrieval.py k4_plan): rb query rows and nw warps a
// block, W catalog rows a block (a multiple of 64 * nw; nblk =
// ceil(num_rows / W) blocks a query group), a ring of `stages` a warp,
// mcols list columns a merge batch. ws: [B, nblk, K] u64 workspace;
// tickets: [ceil(B / rb)] u32, zero before the first call on a stream
// (the merging blocks leave them zero). Outputs [B, k] f32 scores and
// int32 ids.
int pio_k4_top_k(int route, const float* q, int B, int D, const void* V, const float* scales,
                 long long num_rows, long long v_rows, int mode, int k, int rb, int nw,
                 long long W, int nblk, int stages, int mcols, void* ws, unsigned* tickets,
                 float* out_scores, int* out_ids, int* launched, void* stream) {
  return k4_launch(route, q, B, D, V, scales, num_rows, v_rows, mode, k, rb, nw, W, nblk, stages,
                   mcols, ws, tickets, out_scores, out_ids, nullptr, launched, stream);
}

// Two-stage retrieval in one launch: K4 (as pio_k4_top_k, k = k', the
// plan sized with v_dtype) and, in the block that completes each query
// group's shortlist, K5 on it: the query form (as pio_k5_rescore_top_k)
// against the item table IV ([i_rows, D] in v_dtype, i_rows >= num_rows),
// the best kf <= k out. Outputs [B, kf] f32 scores and int32 ids; timer:
// [ceil(B / rb)] u64, each group's epilogue in %globaltimer nanoseconds.
int pio_k4_two_stage(int route, const float* q, int B, int D, const void* V, const float* scales,
                     long long num_rows, long long v_rows, int mode, int k, int rb, int nw,
                     long long W, int nblk, int stages, int mcols, void* ws, unsigned* tickets,
                     int query, const int* ixs, const float* row_w, int L, const void* U,
                     int u_dtype, const float* u_scales, const float* vecs, const void* IV,
                     int v_dtype, const float* v_scales, long long i_rows, int kf,
                     float* out_scores, int* out_ids, unsigned long long* timer, int* launched,
                     void* stream) {
  EpiArgs e{QueryForm{query, ixs, row_w, L, U, u_dtype, u_scales, vecs, IV, v_dtype, v_scales, D},
            dtype_bytes(v_dtype), i_rows, kf, gather_slot(D * dtype_bytes(v_dtype)), out_scores,
            out_ids, timer};
  return k4_launch(route, q, B, D, V, scales, num_rows, v_rows, mode, k, rb, nw, W, nblk, stages,
                   mcols, ws, tickets, nullptr, nullptr, &e, launched, stream);
}

// K5 standalone: the best k of each query row's shortlist cand [B, S] by
// exact score, in one launch. query 0: user rows ixs [B] of U (u_dtype,
// u_scales for int8); 1: vecs [B, D] f32; 2: catalog rows ixs [B, L] of V
// weighted by row_w [B, L]. V: [I, D] in v_dtype (0 f32, 1 bf16, 2 int8
// with v_scales). S2: the power of two >= S. Outputs [B, k] f32 scores
// and int32 ids (-1 past the shortlist's real entries).
int pio_k5_rescore_top_k(int query, const int* ixs, const float* row_w, int L, const void* U,
                         int u_dtype, const float* u_scales, const float* vecs, const void* V,
                         int v_dtype, const float* v_scales, const int* cand, int B, int S,
                         int S2, int D, int k, float* out_scores, int* out_ids, int* launched,
                         void* stream) {
  const int lg_s2 = log2_exact(S2);
  const QueryForm f{query, ixs, row_w, L, U, u_dtype, u_scales, vecs, V, v_dtype, v_scales, D};
  if (B <= 0 || S <= 0 || S > MAX_K || lg_s2 < 0 || S2 < S || k <= 0 || k > S || !form_ok(f) ||
      launched == nullptr)
    return (int)cudaErrorInvalidValue;
  const RescoreArgs a{f, cand, S, S2, lg_s2, k, out_scores, out_ids};
  return (int)launch_rescore(a, B, static_cast<cudaStream_t>(stream), launched);
}

// The smallest step of %globaltimer seen in `samples` reads by one thread
// (the stage split's tick), written to out_ns (one u64, device memory).
// One launch.
int pio_globaltimer_tick(int samples, unsigned long long* out_ns, int* launched, void* stream) {
  if (samples <= 0 || out_ns == nullptr || launched == nullptr) return (int)cudaErrorInvalidValue;
  timer_tick_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(out_ns, samples);
  return (int)counted(launched);
}

}  // extern "C"
