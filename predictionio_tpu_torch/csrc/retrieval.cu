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
// What bounds K4 on an H100: reading the coarse catalog once, I * (D + 4)
// bytes for int8 (0.107 ms at I = 10M, D = 32, against 3.35 TB/s) and I *
// 2D for bf16; the f32 operations, 2 * B * I * D, are below that at the
// serving batch sizes. Its design keeps the [B, I] scores out of device
// memory (320 MB at B = 8, I = 10M) and takes any k' up to MAX_K:
//   launch 1, coarse_tile_kernel: a 256-thread block per (range of W
//     catalog rows, RB query rows). Each thread scores one row at a time
//     against the block's RB queries (kept in shared memory), and the
//     block streams the composites into a per-query buffer of S entries
//     in shared memory (S the power of two >= K + 256, K the power of two
//     >= k'): only composites above the query's threshold are appended
//     (ballot + prefix, in thread order); when a round could overflow the
//     buffer, every query's buffer is sorted (a bitonic network) and cut
//     to its best K, whose last entry becomes the threshold. Thresholds
//     rise fast, so after the first few thousand rows almost nothing is
//     appended. The block writes each query's best K to a [B, nblk, K]
//     u64 workspace: O(B * nblk * K) scratch, whatever I is.
//   launch 2, coarse_merge_kernel: a 1024-thread block per query streams
//     its nblk sorted lists through the same buffer, column by column,
//     and stops at the first column of which nothing was appended; it
//     writes the best k', the score recovered from the composite
//     (order_key is a bijection).
//   RB is 8, 4, 2 or 1 (the batch, and the buffer's shared memory at large
//   K); MAX_K = 8192 fits one query's buffer of 16,384 entries (128 KB).
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
// One block a query row, one launch a call: the shortlist (S <= MAX_K) is
// scored and sorted in shared memory. K5 reads B * S * D values and is
// bound by its launch, not by bytes or operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr float NEG_INF = -1e30f;       // ops/retrieval.py NEG_INF
constexpr float REPORT_FLOOR = -5e29f;  // NEG_INF / 2: winners at or below report -1
constexpr int TILE_THREADS = 256;       // rows a coarse block scores a round, one a thread
constexpr int MERGE_THREADS = 1024;
constexpr int RESCORE_THREADS = 256;
constexpr int MAX_K = 8192;             // ops/retrieval.py K4_MAX_K

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

// Sort `rows` rows of S entries each (S a power of two, lg_s = log2 S)
// descending, all rows at once: a bitonic network, one barrier a stage.
template <int NT>
__device__ void sort_rows(u64* buf, int rows, int S, int lg_s) {
  const int half = S >> 1;
  const int total = rows * half;
  for (int size = 2; size <= S; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < total; p += NT) {
        const int r = p >> (lg_s - 1), q = p & (half - 1);
        const int lo = ((q & ~(stride - 1)) << 1) | (q & (stride - 1));
        const int hi = lo + stride;
        u64* row = buf + ((size_t)r << lg_s);
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

struct RescoreArgs {
  int query;              // GATHER, VECTORS or SUM_ROWS
  const int* ixs;         // [B] user rows (GATHER) or [B, L] catalog rows (SUM_ROWS)
  const float* row_w;     // [B, L] (SUM_ROWS)
  int L;
  const void* U;          // GATHER: the user table
  int u_dtype;
  const float* u_scales;
  const float* vecs;      // VECTORS: [B, D] f32
  const void* V;          // the item table, f32/bf16/int8
  const float* v_scales;
  const int* cand;        // [B, S]
  int S, S2, lg_s2, D, k;
  float* out_scores;      // [B, k]
  int* out_ids;
};

// K5 (see the note at the top): one block a query row.
template <typename TV>
__global__ void __launch_bounds__(RESCORE_THREADS) rescore_kernel(const RescoreArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* buf = reinterpret_cast<u64*>(smem);          // [S2]
  float* q = reinterpret_cast<float*>(buf + a.S2);  // [D]
  const TV* __restrict__ V = static_cast<const TV*>(a.V);
  const int b = blockIdx.x, t = threadIdx.x, D = a.D;
  for (int d = t; d < D; d += RESCORE_THREADS) {
    float u = 0.0f;
    if (a.query == GATHER) {
      const int r = a.ixs[b];
      u = load_f32(a.U, a.u_dtype, (size_t)r * D + d);
      if (a.u_scales != nullptr) u = __fmul_rn(u, a.u_scales[r]);
    } else if (a.query == VECTORS) {
      u = a.vecs[(size_t)b * D + d];
    } else {  // K2's sum: l in order from +0.0, zero weights multiplied in
      const int* ix = a.ixs + (size_t)b * a.L;
      const float* w = a.row_w + (size_t)b * a.L;
      for (int l = 0; l < a.L; ++l) {
        const int r = ix[l];
        float v = to_f32(V[(size_t)r * D + d]);
        if (a.v_scales != nullptr) v = __fmul_rn(v, a.v_scales[r]);
        u = __fadd_rn(u, __fmul_rn(v, w[l]));
      }
    }
    q[d] = u;
  }
  __syncthreads();
  const int* cr = a.cand + (size_t)b * a.S;
  for (int j = t; j < a.S2; j += RESCORE_THREADS) {
    u64 c = 0ull;  // below every real entry's composite
    if (j < a.S) {
      const int cid = cr[j];
      const int row = cid > 0 ? cid : 0;
      const TV* v = V + (size_t)row * D;
      float acc = 0.0f;
      for (int d = 0; d < D; ++d) acc = __fadd_rn(acc, __fmul_rn(q[d], to_f32(v[d])));
      if (a.v_scales != nullptr) acc = __fmul_rn(acc, a.v_scales[row]);
      c = composite(cid < 0 ? NEG_INF : acc, (uint32_t)j);
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

template <typename TV>
cudaError_t launch_rescore(const RescoreArgs& a, int B, cudaStream_t s, int* launched) {
  const size_t bytes = (size_t)a.S2 * sizeof(u64) + (size_t)a.D * sizeof(float);
  cudaError_t err = allow_smem(rescore_kernel<TV>, bytes);
  if (err != cudaSuccess) return err;
  rescore_kernel<TV><<<B, RESCORE_THREADS, bytes, s>>>(a);
  return counted(launched);
}

}  // namespace

extern "C" {

// Every entry adds the kernels it launches to *launched (host memory, not
// null) and returns the first error, or cudaSuccess.

// Shared-memory bytes one coarse block of `rb` query rows takes at buffer
// width S and query width D: ops/retrieval.py k4_plan sizes rb by it.
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

// K4: the best k of each of B query rows over the coarse catalog, in two
// launches. q: [B, D] f32; V: [N, D] int8 (mode 0, 1) or bf16 (mode 2)
// with scales [N] f32 for the int8 modes; rows from num_rows on are
// padding. Plan (ops/retrieval.py k4_plan): rb query rows a block, W
// catalog rows a block (nblk = ceil(num_rows / W) blocks), K = the power
// of two >= k, S (tile) and S2 (merge) the buffers' entries a row. ws:
// [B, nblk, K] u64 workspace. Outputs [B, k] f32 scores and int32 ids.
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

// K5: the best k of each query row's shortlist cand [B, S] by exact score,
// in one launch. query 0: user rows ixs [B] of U (u_dtype, u_scales for
// int8); 1: vecs [B, D] f32; 2: catalog rows ixs [B, L] of V weighted by
// row_w [B, L]. V: [I, D] in v_dtype (0 f32, 1 bf16, 2 int8 with
// v_scales). S2: the power of two >= S. Outputs [B, k] f32 scores and
// int32 ids (-1 past the shortlist's real entries).
int pio_k5_rescore_top_k(int query, const int* ixs, const float* row_w, int L, const void* U,
                         int u_dtype, const float* u_scales, const float* vecs, const void* V,
                         int v_dtype, const float* v_scales, const int* cand, int B, int S,
                         int S2, int D, int k, float* out_scores, int* out_ids, int* launched,
                         void* stream) {
  const int lg_s2 = log2_exact(S2);
  if (B <= 0 || S <= 0 || S > MAX_K || lg_s2 < 0 || S2 < S || D <= 0 || k <= 0 || k > S ||
      L < 0 || query < GATHER || query > SUM_ROWS || launched == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((v_dtype == I8) != (v_scales != nullptr)) return (int)cudaErrorInvalidValue;
  if (query == GATHER && (u_dtype == I8) != (u_scales != nullptr)) return (int)cudaErrorInvalidValue;
  const RescoreArgs a{query, ixs, row_w, L, U, u_dtype, u_scales, vecs, V, v_scales, cand,
                      S, S2, lg_s2, D, k, out_scores, out_ids};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (v_dtype) {
    case F32: err = launch_rescore<float>(a, B, s, launched); break;
    case DT_BF16: err = launch_rescore<__nv_bfloat16>(a, B, s, launched); break;
    case I8: err = launch_rescore<int8_t>(a, B, s, launched); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
