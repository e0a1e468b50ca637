// K1: the fused ALS bucket solve with its write-back, for Hopper (sm_90a).
//
// Replaces predictionio_tpu/ops/als.py:772 _solve_bucket_inline (the XLA
// program gather -> _gramian_rhs -> segment add -> regularize ->
// _psd_solve, with :486 _gramian_rhs_gathered, :530 _gramian_rhs, :570
// _psd_solve, :808 _bucket_weights, :823 _finish_bucket_solve) and its
// epilogue :657 _scatter_rows + :591 quantize_rows; and the op the
// deleted Pallas kernel ops/als_pallas.py::_gramian_rhs_kernel covered.
//
// What it computes, for solved row r of one bucket:
//   for every entry t of r's table rows seg_start[r] .. seg_start[r+1]-1:
//     g_t  = other[col_ids[t]] in the compute dtype: a cast for dense
//            tables; for int8, q * s taken in the compute dtype (bf16
//            compute: bf16(q) * bf16(s), rounded to bf16)
//     explicit: w_t = cdt(mask_t), r_t = cdt(rating_t * mask_t)
//     implicit (Hu-Koren-Volinsky, :808 _bucket_weights):
//               w_t = cdt((alpha * rating_t) * mask_t),
//               r_t = cdt((1 + alpha * rating_t) * mask_t)
//            (cdt: round to the compute dtype; each product and sum
//            rounded, no FMA)
//     A   += cdt(w_t * g_t) g_t^T,  b += r_t g_t,  n += mask_t   (float32)
//   A += (n > 0 ? reg * (weighted ? n : 1) : 1) * I
//   implicit: A += gram (Y^T Y of the whole opposite table, :667
//            compute_gram, passed in), after the regularizer, as
//            :823 _finish_bucket_solve adds them
//   x  = A^-1 b by Cholesky (forward, then backward substitution); a
//   pivot that is not > 0 (an indefinite A: implicit dislikes weigh
//   alpha * r < 0; or a NaN) makes the whole x NaN, as the JAX package's
//   failed Cholesky does -- no clamp, no trap
//   x -> x_out[r] (optional), and -> target[row_ids[r]] (optional): a
//   copy for f32, __float2bfloat16_rn for bf16, and for int8
//   scale = max|x| / 127 (1 where that is not > 0, NaN included),
//   q = rintf(x / scale) -- half to even with a true division, as
//   jnp.round(x / scale) does -- and q = 0 for a NaN, as XLA converts
//   it. The build uses no --use_fast_math.
//
// Padding entries (mask 0) gather their column with weight 0 in the JAX
// program, which adds exact zeros unless that factor row is not finite
// (0 * inf and 0 * NaN are NaN, and a NaN diagonal fails the Cholesky).
// The kernel skips a tile of padding only: where it skipped one, it reads
// the padding's factor row once and fails the solve if that row is not
// finite, which is what the skipped products would have done.
//
// The target table is never the table being read in the same launch:
// a half-step solves U from V (or V from U), so the in-place write-back
// races with no read. Buckets of one side hold disjoint rows.
//
// What bounds it on an H100, at ML-20M (138,493 x 26,744, 20 M ratings)
// rank 20 f32, per iteration (7 buckets): 40 M real entries of
// D(D+1) + 2D = 460 FP32 operations (the symmetric Gramian and the rhs)
// = 18.4 GFLOP, 0.27 ms at 67 TFLOP/s; the bucket arrays, 854 MB, are
// 0.25 ms at 3.35 TB/s; both factor tables (11.1 MB and 2.1 MB) fit in
// the 50 MB L2. So about 0.3 ms, bound by operations and bytes alike.
// The implicit form adds one [D, D] Gramian read per solved row. At the
// similar-product defaults (rank 10; 20 M view events counted to 16.8 M
// pairs, 33.6 M live entries per iteration) D(D+1) + 2D = 130 operations
// an entry make it bound by bytes: 0.236 ms per iteration, computed by
// chip_smoke.py from the buckets of a run on an NVIDIA H100 80GB HBM3
// at 700.00 W. In practice neither bound is reached: each 32-entry tile
// is a chain of dependent loads (the entries, then their factor rows)
// and the products read two shared-memory words per FMA, so what bounds
// the kernel is latency (rows in flight) and the shared-memory pipe.
//
// Two routes, chosen by ops/als.py k1_route from D and the bucket shape
// (never from a failure):
//
// The warp route, D <= WARP_MAX_D (32; the templates' ranks 10 and 20).
//   One warp per row, 8 independent warps a 256-thread block, no block
//   barrier (only __syncwarp). Lane l loads entry t0 + l of the row,
//   computes its weights, and the warp gathers the tile's 32 factor rows
//   into its own slice of shared memory ([32][2D + 2] floats), lanes on
//   neighbouring addresses, 16 bytes a lane where a row starts 16-byte
//   aligned (D a multiple of 16 / sizeof(T)). Lane l owns the entries
//   p = l, l + 32, ... of the same list of D(D+1)/2 + D entries the block
//   kernel splits over 256 threads, and sums each in the same order. The
//   finish (regularize, Gramian, Cholesky on the lanes' registers with
//   the pivot passed by shuffle, both substitutions, write-back) runs on
//   the same warp, its L in the tile's space. At D = 20 shared memory
//   would let 5 blocks of 8 rows share an SM, but 88 registers a thread
//   (ptxas) hold it to 2: 16 rows in flight, against 6 rows of the block
//   kernel. On an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py) an
//   ML-20M iteration took 7.14 ms at rank 20 (block kernel: 11.95) and
//   2.94 ms at rank 10 implicit (6.90): the hot rows' chains are gone,
//   and the products' two shared-memory reads an FMA now bound it.
//   - A bucket whose solved rows each have one table row (R >= B) takes
//     one launch, warp_solve_kernel: accumulate and finish in one warp.
//   - A segmented bucket (R < B: hot rows over several table rows) takes
//     two: warp_partials_kernel gives each table row a warp that writes
//     its A and b entries, n and a flag (a non-finite skipped padding
//     row) to a [B, D(D+3)/2 + 2] f32 workspace; warp_finish_kernel
//     gives each solved row a warp that sums its segments' partials in
//     segment order, starting from the first partial (not from +0.0,
//     which would turn a -0.0 into +0.0), and runs the finish. A hot
//     row's longest chain is one segment's tiles, not all of them. The
//     sum is deterministic and uses no atomics.
//   Every operation of a row with one table row is the block kernel's,
//   in its order, so its x and written-back storage are bit-equal to the
//   block kernel's; rows of several segments are summed in another
//   order (the plain version's: per table row, then over segments).
//
// The block kernel, D in 33..128 (and at any D for chip_smoke.py's
//   comparison, through ops/als.py _solve_bucket_block):
//   one 256-thread block per solved row; segment offsets come from the
//   host, so a hot row's segments (consecutive table rows) are summed in
//   one block, in a fixed order, with no atomics. Entries are staged 32
//   at a time: the entries' rows are gathered straight from the factor
//   table into shared memory, dequantized and rounded there ([B, K, D]
//   never exists anywhere); a tile whose entries are all padding is
//   skipped (rows are packed to the front, so a row's trailing padding
//   costs one check per tile). Each thread owns a fixed set of the
//   D(D+1)/2 lower-triangle entries of A and of the D entries of b, held
//   in registers and summed over the entries in order, a tile's 32
//   products into a partial first. The Cholesky factorization runs
//   column by column on those registers (2 block barriers a column), L
//   goes to shared memory, and one warp does both substitutions and the
//   write-back. Dynamic shared memory: about 100 KB at D = 128
//   (cudaFuncSetAttribute past 48 KB). About 6 rows fit on an SM, a hot
//   row's segments run in one chain, and 7 warps wait during the
//   substitutions: what the warp route removes at D <= 32.
//
// K1s, the candidate axis (replaces predictionio_tpu/ops/als.py:1088
//   _train_fused_sweep, the vmapped program of :1132 als_train_sweep):
//   every launch above takes C candidates as gridDim.y. Candidate c reads
//   its own opposite table (and int8 scales), reg, alpha and Gramian and
//   writes its own target, x and workspace, at a per-candidate stride
//   (struct Cand); the bucket arrays are shared, so one launch per bucket
//   per half-step serves all C trainings and reads the bucket once into
//   L2 for all of them. Each candidate's arithmetic is a one-candidate
//   launch's, so candidate c of a sweep is bit-identical to its training
//   alone from the same init. A rank-r candidate padded to the sweep's
//   rank D with zero columns keeps them exactly zero: its A is
//   [[A_r, 0], [0, lam I]], every product of a zero column adds +-0, and
//   the eliminations and substitutions subtract exact zeros from the
//   real block. Bound: C times K1's, per iteration (about 0.3 ms a
//   candidate at the ML-20M shape, rank 20), the factor tables of all C
//   candidates now sharing the 50 MB L2.
//
// Later work: fewer shared-memory reads per product (register blocking);
//   cp.async / TMA prefetch of the next tile, and the gather's loads
//   issued before their use; registers, the tile width and warps per
//   block; the warp route's design for D > 32 (several warps a row,
//   split hot rows); mma.sync or wgmma for the Gramian at high rank.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_K = 32;  // entries staged per step: one per lane of warp 0
constexpr int MAX_D = 128;
constexpr int WARP_MAX_D = 32;  // the warp route's largest rank (ops/als.py WARP_MAX_RANK)
constexpr int WARPS = 8;        // rows (warps) a block of the warp route
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_C = 65535;  // candidates a launch: gridDim.y

enum DType { F32 = 0, BF16 = 1, I8 = 2 };

// The candidate axis (K1s): blockIdx.y is the candidate c of a sweep.
// Candidate c reads its own opposite table, scales, reg, alpha and
// Gramian and writes its own target, x and workspace, each c strides on
// from the first; the bucket arrays (col_ids, ratings, mask, seg_start,
// row_ids) are shared by every candidate. regs/alphas NULL: the launch's
// scalar reg/alpha (a one-candidate launch, K1 itself).
struct Cand {
  const float* regs;    // [C] or NULL
  const float* alphas;  // [C] or NULL
  size_t other_cs;      // bytes between candidates' opposite tables
  size_t scales_cs;     // floats between their int8 scales
  size_t target_cs;     // bytes between their target tables
  size_t tscales_cs;    // floats between their target scales
  size_t x_cs;          // floats between their x_out blocks (R * D)
  size_t gram_cs;       // floats between their Gramians (D * D)
  size_t ws_cs;         // floats between their workspaces (B * (NE + 2))
  int C;                // candidates: gridDim.y
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// one gathered factor value in the compute dtype (as a float)
__device__ __forceinline__ float gathered(const float* t, const float*, size_t i,
                                          size_t, bool bf16c) {
  const float v = t[i];
  return bf16c ? bf16_round(v) : v;
}
__device__ __forceinline__ float gathered(const __nv_bfloat16* t, const float*,
                                          size_t i, size_t, bool) {
  return __bfloat162float(t[i]);
}
__device__ __forceinline__ float gathered(const int8_t* t, const float* s,
                                          size_t i, size_t row, bool bf16c) {
  const float q = (float)t[i];
  if (bf16c) return bf16_round(__fmul_rn(q, bf16_round(s[row])));
  return __fmul_rn(q, s[row]);
}

// max that propagates NaN, as jnp.max does
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// The entries owner `o` of `stride` owners holds: A[i][k] (k <= i) as
// tile columns (i, D + k); b[i] as (D + i, 2D); past the end, the zero
// column 2D + 1. Entry p = o + q * stride of the list A (row by row),
// then b.
template <int P>
__device__ __forceinline__ void owned_entries(int o, int stride, int D, int* xo, int* yo) {
  const int NT = D * (D + 1) / 2;
  const int ZERO = 2 * D + 1;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int p = o + q * stride;
    if (p < NT) {
      int i = (int)((sqrtf(8.0f * (float)p + 1.0f) - 1.0f) * 0.5f);
      while (i * (i + 1) / 2 > p) --i;
      while ((i + 1) * (i + 2) / 2 <= p) ++i;
      xo[q] = i;
      yo[q] = D + (p - i * (i + 1) / 2);
    } else if (p < NT + D) {
      xo[q] = D + (p - NT);
      yo[q] = 2 * D;
    } else {
      xo[q] = ZERO;
      yo[q] = ZERO;
    }
  }
}

// x (sb[0 .. D-1], shared) -> x_out[r] and target[row_ids[r]], by the 32
// lanes of one warp
__device__ __forceinline__ void write_back(const float* sb, int lane, int D, int r,
                                           float* x_out, void* target, int target_code,
                                           float* target_scales, const int* row_ids) {
  if (x_out != nullptr)
    for (int d = lane; d < D; d += 32) x_out[(size_t)r * D + d] = sb[d];
  if (target == nullptr) return;
  const size_t row = (size_t)row_ids[r];
  if (target_code == F32) {
    float* tt = (float*)target + row * D;
    for (int d = lane; d < D; d += 32) tt[d] = sb[d];
  } else if (target_code == BF16) {
    __nv_bfloat16* tt = (__nv_bfloat16*)target + row * D;
    for (int d = lane; d < D; d += 32) tt[d] = __float2bfloat16_rn(sb[d]);
  } else {
    float m = 0.0f;
    for (int d = lane; d < D; d += 32) m = nanmax(m, fabsf(sb[d]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nanmax(m, __shfl_xor_sync(FULL, m, off));
    float scale = __fdiv_rn(m, 127.0f);
    if (!(scale > 0.0f)) scale = 1.0f;
    int8_t* tt = (int8_t*)target + row * D;
    for (int d = lane; d < D; d += 32) {
      const float v = __fdiv_rn(sb[d], scale);
      tt[d] = v != v ? (int8_t)0 : (int8_t)(int)rintf(v);  // NaN -> 0, as XLA
    }
    if (lane == 0) target_scales[row] = scale;
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
solve_kernel(const T* __restrict__ other, const float* __restrict__ other_scales,
             const int* __restrict__ col_ids, const float* __restrict__ ratings,
             const float* __restrict__ mask, const int* __restrict__ seg_start,
             int K, int D, float reg, int weighted, int bf16c, int implicit,
             float alpha, const float* __restrict__ gram,
             float* __restrict__ x_out, void* __restrict__ target, int target_code,
             float* __restrict__ target_scales, const int* __restrict__ row_ids,
             const Cand cand) {
  extern __shared__ float smem[];
  __shared__ int s_col[TILE_K];
  {  // candidate blockIdx.y: its tables, reg and alpha (Cand)
    const size_t c = blockIdx.y;
    other = (const T*)((const char*)other + c * cand.other_cs);
    if (other_scales != nullptr) other_scales += c * cand.scales_cs;
    if (cand.regs != nullptr) reg = cand.regs[c];
    if (cand.alphas != nullptr) alpha = cand.alphas[c];
    if (gram != nullptr) gram += c * cand.gram_cs;
    if (x_out != nullptr) x_out += c * cand.x_cs;
    if (target != nullptr) target = (char*)target + c * cand.target_cs;
    if (target_scales != nullptr) target_scales += c * cand.tscales_cs;
  }
  __shared__ float s_w[TILE_K];
  __shared__ float s_diag;
  __shared__ float s_n;

  const int S = 2 * D + 2;      // tile row: w*g [D] | g [D] | r | 0
  const int ZERO = 2 * D + 1;   // a column held at 0 for idle owners
  const int LD = D + 1;         // stride of L in shared memory
  float* tile = smem;                 // [TILE_K][S]
  float* Ls = tile + TILE_K * S;      // [D][D + 1], lower triangle of L
  float* sb = Ls + D * LD;            // [D]: b, then y, then x
  const int tid = threadIdx.x;
  const int r = blockIdx.x;

  // the entries this thread owns (owned_entries)
  int xo[P], yo[P];
  float acc[P];
  owned_entries<P>(tid, THREADS, D, xo, yo);
#pragma unroll
  for (int q = 0; q < P; ++q) acc[q] = 0.0f;
  for (int k = tid; k < TILE_K; k += THREADS) tile[k * S + ZERO] = 0.0f;

  const long long base = (long long)seg_start[r] * K;
  const long long total = (long long)(seg_start[r + 1] - seg_start[r]) * K;
  float n_acc = 0.0f;  // mask sum, kept by thread 0
  bool skipped = false;  // a tile of padding was skipped (block-uniform)
  int pad_col = 0;       // the first skipped padding entry's column (thread 0)
  for (long long t0 = 0; t0 < total; t0 += TILE_K) {
    int live = 0;
    int ec = -1;  // this thread's entry's column (-1 past the row's end)
    if (tid < TILE_K) {
      const long long t = t0 + tid;
      float m = 0.0f, rt = 0.0f;
      if (t < total) {
        ec = col_ids[base + t];
        m = mask[base + t];
        rt = ratings[base + t];
      }
      float w, rr;
      if (implicit) {
        const float ar = __fmul_rn(alpha, rt);
        w = __fmul_rn(ar, m);
        rr = __fmul_rn(__fadd_rn(1.0f, ar), m);
      } else {
        w = m;
        rr = __fmul_rn(rt, m);
      }
      if (bf16c) {
        w = bf16_round(w);
        rr = bf16_round(rr);
      }
      s_col[tid] = ec;
      s_w[tid] = w;
      tile[tid * S + 2 * D] = rr;
      live = (m != 0.0f) || (rr != 0.0f);
      float msum = m;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        msum += __shfl_xor_sync(0xffffffffu, msum, off);
      if (tid == 0) n_acc += msum;
    }
    if (!__syncthreads_or(live)) {  // all padding: adds exact zeros
      if (tid == 0 && !skipped) pad_col = ec;
      skipped = true;
      continue;
    }
    for (int e = tid; e < TILE_K * D; e += THREADS) {
      const int k = e / D;
      const int d = e - k * D;
      const int c = s_col[k];
      float g = 0.0f;
      if (c >= 0) g = gathered(other, other_scales, (size_t)c * D + d, (size_t)c, bf16c);
      float wg = __fmul_rn(s_w[k], g);
      if (bf16c) wg = bf16_round(wg);
      tile[k * S + d] = wg;
      tile[k * S + D + d] = g;
    }
    __syncthreads();
    // each owned entry sums the tile's 32 products into a partial, then
    // adds it to its running sum: a hot row's ~67,000 entries take ~2,100
    // long additions instead of 67,000, which keeps the f32 rounding of
    // the sum near that of a blocked (cuBLAS) sum
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float* xs = tile + xo[q];
      const float* ys = tile + yo[q];
      float t = 0.0f;
#pragma unroll 8
      for (int k = 0; k < TILE_K; ++k) t = fmaf(xs[k * S], ys[k * S], t);
      acc[q] += t;
    }
    __syncthreads();
  }

  // regularize: reg * (n or 1) on the diagonal, the identity when n == 0
  if (tid == 0) {
    s_n = n_acc;
    s_col[0] = pad_col;
  }
  __syncthreads();
  const float n = s_n;
  // the skipped padding's factor row: a value that is not finite fails
  // the solve, as its zero-weight products would have (see the header)
  bool bad = false;
  if (skipped) {
    int nonfinite = 0;
    for (int d = tid; d < D; d += THREADS) {
      const float g =
          gathered(other, other_scales, (size_t)s_col[0] * D + d, (size_t)s_col[0], bf16c);
      nonfinite |= !isfinite(g);
    }
    bad = __syncthreads_or(nonfinite);
  }
  float lam = weighted ? __fmul_rn(reg, n) : reg;
  if (!(n > 0.0f)) lam = 1.0f;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (xo[q] < D && xo[q] == yo[q] - D) acc[q] = __fadd_rn(acc[q], lam);
    if (implicit && xo[q] < D) acc[q] = __fadd_rn(acc[q], gram[xo[q] * D + yo[q] - D]);
    if (yo[q] == 2 * D) sb[xo[q] - D] = acc[q];
  }

  // Cholesky, column j at a time, on the owners' registers; a pivot that
  // is not > 0 stops it (block-uniform: every thread reads s_diag)
  for (int j = 0; j < D && !bad; ++j) {
#pragma unroll
    for (int q = 0; q < P; ++q)
      if (xo[q] == j && yo[q] == D + j) s_diag = acc[q];
    __syncthreads();
    if (!(s_diag > 0.0f)) {
      bad = true;
      break;
    }
    const float dj = sqrtf(s_diag);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (xo[q] < D && yo[q] == D + j) {
        const int i = xo[q];
        if (i == j) {
          Ls[j * LD + j] = dj;
        } else {
          acc[q] = acc[q] / dj;
          Ls[i * LD + j] = acc[q];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int k = yo[q] - D;
      if (xo[q] < D && k > j)
        acc[q] = fmaf(-Ls[xo[q] * LD + j], Ls[k * LD + j], acc[q]);
    }
  }
  __syncthreads();

  if (tid >= 32) return;
  const int lane = tid;
  if (bad) {  // a failed factorization: x is NaN, as the JAX package's is
    for (int d = lane; d < D; d += 32) sb[d] = __int_as_float(0x7fc00000);
    __syncwarp();
  }
  // L y = b
  for (int j = 0; j < D && !bad; ++j) {
    const float yj = sb[j] / Ls[j * LD + j];
    __syncwarp();
    if (lane == 0) sb[j] = yj;
    for (int i = j + 1 + lane; i < D; i += 32) sb[i] = fmaf(-Ls[i * LD + j], yj, sb[i]);
    __syncwarp();
  }
  // L^T x = y
  for (int j = D - 1; j >= 0 && !bad; --j) {
    const float xj = sb[j] / Ls[j * LD + j];
    __syncwarp();
    if (lane == 0) sb[j] = xj;
    for (int i = lane; i < j; i += 32) sb[i] = fmaf(-Ls[j * LD + i], xj, sb[i]);
    __syncwarp();
  }

  write_back(sb, lane, D, r, x_out, target, target_code, target_scales, row_ids);
}

template <typename T, int P>
cudaError_t launch(const void* other, const float* other_scales, const int* col_ids,
                   const float* ratings, const float* mask, const int* seg_start,
                   int R, int K, int D, float reg, int weighted, int bf16c,
                   int implicit, float alpha, const float* gram,
                   float* x_out, void* target, int target_code, float* target_scales,
                   const int* row_ids, const Cand& cand, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)TILE_K * (2 * D + 2) + (size_t)D * (D + 1) + D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        solve_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  solve_kernel<T, P><<<dim3(R, cand.C), THREADS, smem, stream>>>(
      (const T*)other, other_scales, col_ids, ratings, mask, seg_start, K, D, reg,
      weighted, bf16c, implicit, alpha, gram, x_out, target, target_code, target_scales,
      row_ids, cand);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* other, const float* other_scales, const int* col_ids,
                     const float* ratings, const float* mask, const int* seg_start,
                     int R, int K, int D, float reg, int weighted, int bf16c,
                     int implicit, float alpha, const float* gram,
                     float* x_out, void* target, int target_code, float* target_scales,
                     const int* row_ids, const Cand& cand, cudaStream_t stream) {
  // owned entries per thread: ceil((D(D+1)/2 + D) / THREADS)
  const int need = (D * (D + 3) / 2 + THREADS - 1) / THREADS;
#define PIO_K1_LAUNCH(PV)                                                          \
  return launch<T, PV>(other, other_scales, col_ids, ratings, mask, seg_start, R, \
                       K, D, reg, weighted, bf16c, implicit, alpha, gram, x_out,  \
                       target, target_code, target_scales, row_ids, cand, stream)
  if (need <= 1) PIO_K1_LAUNCH(1);
  if (need <= 2) PIO_K1_LAUNCH(2);
  if (need <= 4) PIO_K1_LAUNCH(4);
  if (need <= 9) PIO_K1_LAUNCH(9);
  if (need <= 17) PIO_K1_LAUNCH(17);
  PIO_K1_LAUNCH(33);
#undef PIO_K1_LAUNCH
}

// -- the warp route (D <= WARP_MAX_D) ------------------------------------------

// One bucket solve's arguments, as the entry point receives them.
struct Solve {
  const void* other;
  const float* other_scales;
  const int* col_ids;
  const float* ratings;
  const float* mask;
  const int* seg_start;
  int R, B, K, D;
  float reg;
  int weighted, bf16c, implicit;
  float alpha;
  const float* gram;
  float* workspace;  // [B, D(D+3)/2 + 2]: the partials of a segmented bucket
  float* x_out;
  void* target;
  int target_code;
  float* target_scales;
  const int* row_ids;
  int vec;  // factor rows start 16-byte aligned: gather 16 bytes a lane
  Cand cand;
};

// The arguments of candidate c (blockIdx.y) of a sweep (Cand)
__device__ __forceinline__ Solve for_candidate(Solve a, size_t c) {
  const Cand& k = a.cand;
  a.other = (const char*)a.other + c * k.other_cs;
  if (a.other_scales != nullptr) a.other_scales += c * k.scales_cs;
  if (k.regs != nullptr) a.reg = k.regs[c];
  if (k.alphas != nullptr) a.alpha = k.alphas[c];
  if (a.gram != nullptr) a.gram += c * k.gram_cs;
  if (a.workspace != nullptr) a.workspace += c * k.ws_cs;
  if (a.x_out != nullptr) a.x_out += c * k.x_cs;
  if (a.target != nullptr) a.target = (char*)a.target + c * k.target_cs;
  if (a.target_scales != nullptr) a.target_scales += c * k.tscales_cs;
  return a;
}

// 16 bytes of factor row c (vector v) as gathered() reads each value
__device__ __forceinline__ void gathered16(const float* t, const float*, size_t c, int D,
                                           int v, bool bf16c, float* g) {
  const float4 q = *reinterpret_cast<const float4*>(t + c * D + v * 4);
  g[0] = q.x;
  g[1] = q.y;
  g[2] = q.z;
  g[3] = q.w;
  if (bf16c)
#pragma unroll
    for (int j = 0; j < 4; ++j) g[j] = bf16_round(g[j]);
}
__device__ __forceinline__ void gathered16(const __nv_bfloat16* t, const float*, size_t c,
                                           int D, int v, bool, float* g) {
  const uint4 q = *reinterpret_cast<const uint4*>(t + c * D + v * 8);
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // a bf16 is the high half of its float
    g[2 * j] = __uint_as_float(w[j] << 16);
    g[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void gathered16(const int8_t* t, const float* s, size_t c, int D,
                                           int v, bool bf16c, float* g) {
  const uint4 q = *reinterpret_cast<const uint4*>(t + c * D + v * 16);
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
  const float sc = s[c];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float qv = (float)((int)(w[j >> 2] << (24 - 8 * (j & 3))) >> 24);
    g[j] = bf16c ? bf16_round(__fmul_rn(qv, bf16_round(sc))) : __fmul_rn(qv, sc);
  }
}

// Sum the products of entries [base, base + total) into the lane's owned
// entries, tile by tile, as the block kernel does: the same weights, the
// same gathered values, each tile's 32 products into a partial with
// fmaf in k order, then added to the running sum. Lane 0's n_acc is the
// block kernel's n. tile: this warp's [TILE_K][2D + 2] floats.
template <typename T, int P>
__device__ __forceinline__ void warp_accumulate(const Solve& a, long long base,
                                                long long total, float* tile, int lane,
                                                const int* xo, const int* yo, float* acc,
                                                float& n_acc, bool& skipped, int& pad_col) {
  const int D = a.D;
  const int S = 2 * D + 2;
  const T* other = (const T*)a.other;
  const bool bf16c = a.bf16c;
  tile[lane * S + 2 * D + 1] = 0.0f;  // the zero column of idle owners
  for (long long t0 = 0; t0 < total; t0 += TILE_K) {
    const long long t = t0 + lane;
    int ec = -1;  // this lane's entry's column (-1 past the row's end)
    float m = 0.0f, rt = 0.0f;
    if (t < total) {
      ec = a.col_ids[base + t];
      m = a.mask[base + t];
      rt = a.ratings[base + t];
    }
    float w, rr;
    if (a.implicit) {
      const float ar = __fmul_rn(a.alpha, rt);
      w = __fmul_rn(ar, m);
      rr = __fmul_rn(__fadd_rn(1.0f, ar), m);
    } else {
      w = m;
      rr = __fmul_rn(rt, m);
    }
    if (bf16c) {
      w = bf16_round(w);
      rr = bf16_round(rr);
    }
    float msum = m;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) msum += __shfl_xor_sync(FULL, msum, off);
    n_acc += msum;
    if (!__any_sync(FULL, (m != 0.0f) || (rr != 0.0f))) {  // all padding: exact zeros
      const int c0 = __shfl_sync(FULL, ec, 0);
      if (!skipped) pad_col = c0;
      skipped = true;
      continue;
    }
    tile[lane * S + 2 * D] = rr;
    constexpr int EPV = 16 / sizeof(T);
    if (a.vec) {  // 16 bytes a lane: EPV values of one row
      const int NV = D / EPV;
      for (int it = 0; it < NV; ++it) {
        const int e = it * TILE_K + lane;
        const int k = e / NV;
        const int v = e - k * NV;
        const int c = __shfl_sync(FULL, ec, k);
        const float wk = __shfl_sync(FULL, w, k);
        float g[EPV];
        if (c >= 0) {
          gathered16(other, a.other_scales, (size_t)c, D, v, bf16c, g);
        } else {
#pragma unroll
          for (int j = 0; j < EPV; ++j) g[j] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < EPV; ++j) {
          float wg = __fmul_rn(wk, g[j]);
          if (bf16c) wg = bf16_round(wg);
          tile[k * S + v * EPV + j] = wg;
          tile[k * S + D + v * EPV + j] = g[j];
        }
      }
    } else {  // one value a lane, lanes on neighbouring values
      for (int it = 0; it < D; ++it) {
        const int e = it * TILE_K + lane;
        const int k = e / D;
        const int d = e - k * D;
        const int c = __shfl_sync(FULL, ec, k);
        const float wk = __shfl_sync(FULL, w, k);
        float g = 0.0f;
        if (c >= 0) g = gathered(other, a.other_scales, (size_t)c * D + d, (size_t)c, bf16c);
        float wg = __fmul_rn(wk, g);
        if (bf16c) wg = bf16_round(wg);
        tile[k * S + d] = wg;
        tile[k * S + D + d] = g;
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float* xs = tile + xo[q];
      const float* ys = tile + yo[q];
      float s = 0.0f;
#pragma unroll 8
      for (int k = 0; k < TILE_K; ++k) s = fmaf(xs[k * S], ys[k * S], s);
      acc[q] += s;
    }
    __syncwarp();
  }
}

// a skipped padding tile's factor row: is a value not finite? (see the header)
template <typename T>
__device__ __forceinline__ bool nonfinite_row(const Solve& a, int c, int lane) {
  int bad = 0;
  if (lane < a.D)
    bad = !isfinite(gathered((const T*)a.other, a.other_scales, (size_t)c * a.D + lane,
                             (size_t)c, a.bf16c));
  return __any_sync(FULL, bad);
}

// The block kernel's finish on one warp: regularize, add the Gramian
// (implicit), Cholesky column by column on the lanes' registers (the
// pivot passed by shuffle), both substitutions with lane d holding x[d],
// write-back. Ls: this warp's [D][D + 1] + [D] floats of shared memory.
template <int P>
__device__ __forceinline__ void warp_finish(const Solve& a, int r, int lane, float* Ls,
                                            const int* xo, const int* yo, float* acc,
                                            float n, bool bad) {
  const int D = a.D;
  const int LD = D + 1;
  float* sb = Ls + D * LD;
  float lam = a.weighted ? __fmul_rn(a.reg, n) : a.reg;
  if (!(n > 0.0f)) lam = 1.0f;
  __syncwarp();  // Ls may reuse the tile: its last reads are done
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (xo[q] < D && xo[q] == yo[q] - D) acc[q] = __fadd_rn(acc[q], lam);
    if (a.implicit && xo[q] < D) acc[q] = __fadd_rn(acc[q], a.gram[xo[q] * D + yo[q] - D]);
    if (yo[q] == 2 * D) sb[xo[q] - D] = acc[q];
  }
  for (int j = 0; j < D && !bad; ++j) {
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < P; ++q)
      if (xo[q] == j && yo[q] == D + j) v = acc[q];
    const float diag = __shfl_sync(FULL, v, (j * (j + 3) / 2) & 31);  // A[j][j]'s owner
    if (!(diag > 0.0f)) {
      bad = true;
      break;
    }
    const float dj = sqrtf(diag);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (xo[q] < D && yo[q] == D + j) {
        const int i = xo[q];
        if (i == j) {
          Ls[j * LD + j] = dj;
        } else {
          acc[q] = acc[q] / dj;
          Ls[i * LD + j] = acc[q];
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int k = yo[q] - D;
      if (xo[q] < D && k > j) acc[q] = fmaf(-Ls[xo[q] * LD + j], Ls[k * LD + j], acc[q]);
    }
  }
  __syncwarp();
  float x = lane < D ? sb[lane] : 0.0f;
  if (bad) {  // a failed factorization: x is NaN, as the JAX package's is
    x = __int_as_float(0x7fc00000);
  } else {
    for (int j = 0; j < D; ++j) {  // L y = b
      const float yj = __shfl_sync(FULL, x, j) / Ls[j * LD + j];
      if (lane == j)
        x = yj;
      else if (lane > j && lane < D)
        x = fmaf(-Ls[lane * LD + j], yj, x);
    }
    for (int j = D - 1; j >= 0; --j) {  // L^T x = y
      const float xj = __shfl_sync(FULL, x, j) / Ls[j * LD + j];
      if (lane == j)
        x = xj;
      else if (lane < j)
        x = fmaf(-Ls[j * LD + lane], xj, x);
    }
  }
  if (lane < D) sb[lane] = x;
  __syncwarp();
  write_back(sb, lane, D, r, a.x_out, a.target, a.target_code, a.target_scales, a.row_ids);
}

// One warp per row: a solved row's whole range, solved (PARTIALS false),
// or one table row's partial written to the workspace (PARTIALS true).
template <typename T, int P, bool PARTIALS>
__device__ __forceinline__ void warp_rows(const Solve& a0) {
  extern __shared__ float smem[];
  const Solve a = for_candidate(a0, blockIdx.y);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * WARPS + warp;
  if (r >= (PARTIALS ? a.B : a.R)) return;
  const int D = a.D;
  float* tile = smem + (size_t)warp * TILE_K * (2 * D + 2);
  int xo[P], yo[P];
  float acc[P];
  owned_entries<P>(lane, 32, D, xo, yo);
#pragma unroll
  for (int q = 0; q < P; ++q) acc[q] = 0.0f;
  long long base, total;
  if (PARTIALS) {
    base = (long long)r * a.K;
    total = a.K;
  } else {
    base = (long long)a.seg_start[r] * a.K;
    total = (long long)(a.seg_start[r + 1] - a.seg_start[r]) * a.K;
  }
  float n_acc = 0.0f;
  bool skipped = false;  // a tile of padding was skipped (warp-uniform)
  int pad_col = 0;       // the first skipped padding entry's column
  warp_accumulate<T, P>(a, base, total, tile, lane, xo, yo, acc, n_acc, skipped, pad_col);
  const bool bad = skipped && nonfinite_row<T>(a, pad_col, lane);
  if (PARTIALS) {
    const int NE = D * (D + 3) / 2;
    float* w = a.workspace + (size_t)r * (NE + 2);
#pragma unroll
    for (int q = 0; q < P; ++q)
      if (lane + q * 32 < NE) w[lane + q * 32] = acc[q];
    if (lane == 0) {
      w[NE] = n_acc;
      w[NE + 1] = bad ? 1.0f : 0.0f;
    }
    return;
  }
  warp_finish<P>(a, r, lane, tile, xo, yo, acc, __shfl_sync(FULL, n_acc, 0), bad);
}

// Blocks of 8 rows each SM keeps in flight: four at D <= 10 (P <= 3, 64
// registers a thread), three at D <= 20 (P <= 8, 85). ptxas is held to
// that budget, since its own choice moves with small changes of the code
// (int8 at D = 20 went from 80 to 112 registers when the candidate axis
// was added) and a block's rows in flight go with it; a looser cap lets
// it spend registers that cost a block (D = 10 took 72 under the D = 20
// cap).
constexpr int warp_min_blocks(int P) { return P <= 3 ? 4 : P <= 8 ? 3 : 1; }

template <typename T, int P>
__global__ void __launch_bounds__(WARPS * 32, warp_min_blocks(P))
warp_solve_kernel(const Solve a) {
  warp_rows<T, P, false>(a);
}

template <typename T, int P>
__global__ void __launch_bounds__(WARPS * 32, warp_min_blocks(P))
warp_partials_kernel(const Solve a) {
  warp_rows<T, P, true>(a);
}

// One warp per solved row of a segmented bucket: its segments' partials
// summed in segment order from the first partial, then the finish.
template <int P>
__global__ void __launch_bounds__(WARPS * 32, warp_min_blocks(P))
warp_finish_kernel(const Solve a0) {
  extern __shared__ float smem[];
  const Solve a = for_candidate(a0, blockIdx.y);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * WARPS + warp;
  if (r >= a.R) return;
  const int D = a.D;
  const int NE = D * (D + 3) / 2;
  float* Ls = smem + (size_t)warp * (D * (D + 1) + D);
  int xo[P], yo[P];
  float acc[P];
  owned_entries<P>(lane, 32, D, xo, yo);
#pragma unroll
  for (int q = 0; q < P; ++q) acc[q] = 0.0f;
  float n = 0.0f;
  bool bad = false;
  const int s0 = a.seg_start[r];
  const int s1 = a.seg_start[r + 1];
  for (int s = s0; s < s1; ++s) {
    const float* w = a.workspace + (size_t)s * (NE + 2);
#pragma unroll
    for (int q = 0; q < P; ++q)
      if (lane + q * 32 < NE)
        acc[q] = s == s0 ? w[lane + q * 32] : __fadd_rn(acc[q], w[lane + q * 32]);
    n = s == s0 ? w[NE] : __fadd_rn(n, w[NE]);
    bad |= w[NE + 1] != 0.0f;
  }
  warp_finish<P>(a, r, lane, Ls, xo, yo, acc, n, bad);
}

enum Launch { BLOCK = 0, WARP_SOLVE = 1, WARP_PARTIALS = 2, WARP_FINISH = 3 };

template <typename T, int P>
cudaError_t launch_warp(int launch, const Solve& a, cudaStream_t stream) {
  const int D = a.D;
  const size_t per_warp = launch == WARP_FINISH ? (size_t)D * (D + 1) + D
                                                : (size_t)TILE_K * (2 * D + 2);
  const size_t smem = sizeof(float) * WARPS * per_warp;
  void (*kernel)(const Solve) = launch == WARP_SOLVE      ? warp_solve_kernel<T, P>
                                : launch == WARP_PARTIALS ? warp_partials_kernel<T, P>
                                                          : warp_finish_kernel<P>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int rows = launch == WARP_PARTIALS ? a.B : a.R;
  kernel<<<dim3((rows + WARPS - 1) / WARPS, a.cand.C), WARPS * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_warp(int launch, const Solve& a, cudaStream_t stream) {
  // owned entries per lane: ceil((D(D+1)/2 + D) / 32); D = 10, 20, 32 -> 3, 8, 18
  const int need = (a.D * (a.D + 3) / 2 + 31) / 32;
  if (need <= 1) return launch_warp<T, 1>(launch, a, stream);
  if (need <= 2) return launch_warp<T, 2>(launch, a, stream);
  if (need <= 3) return launch_warp<T, 3>(launch, a, stream);
  if (need <= 4) return launch_warp<T, 4>(launch, a, stream);
  if (need <= 6) return launch_warp<T, 6>(launch, a, stream);
  if (need <= 8) return launch_warp<T, 8>(launch, a, stream);
  if (need <= 12) return launch_warp<T, 12>(launch, a, stream);
  return launch_warp<T, 18>(launch, a, stream);
}

}  // namespace

// One launch of K1 on one bucket. launch: BLOCK (the block kernel, one
// block per solved row, any D), WARP_SOLVE (one warp per solved row, D <=
// WARP_MAX_D), or the two launches of a segmented bucket on the warp
// route: WARP_PARTIALS (one warp per table row, into workspace [B, D(D+3)/2
// + 2] f32) then WARP_FINISH (one warp per solved row, from workspace).
// ops/als.py k1_route picks them. C candidates (K1s) run as gridDim.y,
// candidate c at the strides of n_other / n_target table rows (struct
// Cand); regs and alphas are [C] device arrays, or NULL for the scalar
// reg and alpha (C = 1: K1 itself). Pointers are device pointers;
// other_scales and target_scales are NULL unless the table is int8; x_out
// and target may each be NULL; gram ([D, D] f32, row-major) is read only
// when implicit is set, and must then be given. Returns cudaGetLastError()
// after the launch (or the error of a refused argument:
// cudaErrorInvalidValue).
extern "C" int pio_k1_solve_bucket(int launch, const void* other, int other_code,
                                   const float* other_scales, const int* col_ids,
                                   const float* ratings, const float* mask,
                                   const int* seg_start, int R, int B, int K, int D,
                                   float reg, int weighted, int bf16_compute,
                                   int implicit, float alpha, const float* gram,
                                   float* workspace, float* x_out, void* target,
                                   int target_code, float* target_scales,
                                   const int* row_ids, int C, const float* regs,
                                   const float* alphas, int n_other, int n_target,
                                   void* stream) {
  if (launch < BLOCK || launch > WARP_FINISH) return (int)cudaErrorInvalidValue;
  if (C < 1 || C > MAX_C || n_other < 0 || n_target < 0) return (int)cudaErrorInvalidValue;
  if ((launch == WARP_PARTIALS ? B : R) <= 0) return 0;
  if (D < 1 || D > (launch == BLOCK ? MAX_D : WARP_MAX_D) || K < 1)
    return (int)cudaErrorInvalidValue;
  if (implicit && gram == nullptr) return (int)cudaErrorInvalidValue;
  if ((other_code == I8) != (other_scales != nullptr)) return (int)cudaErrorInvalidValue;
  if (target != nullptr &&
      ((target_code == I8) != (target_scales != nullptr) || row_ids == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((launch == WARP_PARTIALS || launch == WARP_FINISH) && workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int elem = other_code == F32 ? 4 : other_code == BF16 ? 2 : 1;
  const int telem = target_code == F32 ? 4 : target_code == BF16 ? 2 : 1;
  const Cand cand{regs, alphas,
                  (size_t)n_other * D * elem, (size_t)n_other,
                  (size_t)n_target * D * telem, (size_t)n_target,
                  (size_t)R * D, (size_t)D * D, (size_t)B * (D * (D + 3) / 2 + 2), C};
  const Solve a{other, other_scales, col_ids, ratings, mask, seg_start, R, B, K, D, reg,
                weighted, bf16_compute, implicit, alpha, gram, workspace, x_out, target,
                target_code, target_scales, row_ids,
                (int)((uintptr_t)other % 16 == 0 && (D * elem) % 16 == 0), cand};
  cudaError_t err;
  switch (other_code) {
    case F32:
      err = launch != BLOCK
                ? dispatch_warp<float>(launch, a, s)
                : dispatch<float>(other, other_scales, col_ids, ratings, mask, seg_start,
                                  R, K, D, reg, weighted, bf16_compute, implicit, alpha,
                                  gram, x_out, target, target_code, target_scales,
                                  row_ids, cand, s);
      break;
    case BF16:
      err = launch != BLOCK
                ? dispatch_warp<__nv_bfloat16>(launch, a, s)
                : dispatch<__nv_bfloat16>(other, other_scales, col_ids, ratings, mask,
                                          seg_start, R, K, D, reg, weighted,
                                          bf16_compute, implicit, alpha, gram, x_out,
                                          target, target_code, target_scales, row_ids,
                                          cand, s);
      break;
    case I8:
      err = launch != BLOCK
                ? dispatch_warp<int8_t>(launch, a, s)
                : dispatch<int8_t>(other, other_scales, col_ids, ratings, mask,
                                   seg_start, R, K, D, reg, weighted, bf16_compute,
                                   implicit, alpha, gram, x_out, target, target_code,
                                   target_scales, row_ids, cand, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
