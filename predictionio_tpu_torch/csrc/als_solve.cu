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
//   _train_fused_sweep, the vmapped program of :1132 als_train_sweep): C
//   candidate trainings with their own reg, alpha, init and rank (zero-
//   padded to the sweep's rank D) on the same buckets, the launches of a
//   bucket's half-step serving all of them (pio_k1s_sweep). Candidate c's
//   every operation is K1 alone's, in
//   its order, so its tables are bit-identical to its training alone. A
//   rank-r candidate padded to D keeps its padded columns exactly zero:
//   its A is [[A_r, 0], [0, lam I]], every product of a zero column adds
//   +-0, and the eliminations and substitutions subtract exact zeros from
//   the real block.
//
//   Layout: the sweep keeps its stacks entry-major, [N, C, D] (int8
//   scales [N, C]), so one entry's C candidate rows are C * D contiguous
//   values: a warp gathers a chunk of them 16 bytes a lane.
//
//   Design, D <= WARP_MAX_D (ops/als.py k1s_route): two launches a
//   bucket, the accumulation into a workspace (sweep_kernel), then the
//   finish -- a thread a system (sweep_system_kernel) where the systems
//   (solved rows x candidates) are K1S_THREAD_SYSTEMS or more, a warp a
//   row (sweep_row_kernel) where they are fewer. (The accumulation and a
//   warp-a-row finish fused in one launch for unsegmented buckets
//   measured slower on an H100 at every eval-sweep group, and the finish
//   fused into the accumulating warp slower at the ML-20M shape: the
//   finish's latency and registers held the accumulation's warps.)
//   - The accumulation: one warp a table row for a chunk of cw candidates
//     (k1s_plan; chunks on gridDim.y only where cw < C). The warp reads a
//     tile's 32 entries (col, mask, rating) once, a tile ahead, computes
//     each candidate's weights (alpha differs in implicit mode), and
//     stages, per entry and candidate, X = [w*g, r] and Y = g in shared
//     memory, a lane's loads of the entries' rows in flight together
//     (GATHER_BATCH). Each candidate's sums form a (D + 1) x D lower
//     trapezoid: A's lower triangle, then b as the row X = r. A lane owns
//     up to K1S_MAX_NB blocks of S x S of the chunk's trapezoids (S = 1,
//     2 or 4 by the plan's cost model): a tile entry reads S values of X
//     and S of Y and makes S * S products, so a product costs 2 / S
//     shared-memory words -- 0.5 at S = 4, the plan's choice from rank 10
//     up (ML-20M C = 4; the eval sweep's rank-10 and rank-20 groups),
//     against 2 in K1's one entry a lane; S = 1 only where 4 x 4 blocks
//     would leave most lanes idle (rank 5, C = 1: 20 sums a row). Every
//     sum is K1's: a tile's 32 products of an entry with fmaf in entry
//     order from 0.0f, then added to its running sum. Each candidate's
//     sums, n and flag go to the workspace [C, B, D(D+3)/2 + 2], as K1's
//     warp_partials_kernel writes them.
//   - The finish, a warp a row: each candidate D lanes, lane i holding
//     row i, the Cholesky left-looking (row i's entry k takes its fmaf
//     chain over j < k in order, then sqrtf or / L[k][k]: the chain K1's
//     right-looking updates make). Its latency is a warp's D column steps
//     and 2D substitution steps a pass of 32 / D candidates.
//   - The finish, a thread a system: one thread a (solved row, candidate), 32 of them
//     a warp in shared memory, entry-major (no bank conflicts): the
//     segments' partials summed in segment order from the first, then
//     K1's warp_finish entry by entry, in its order (regularizer,
//     Gramian, Cholesky column by column, both substitutions, the
//     write-back). A warp a system spent a warp instruction on each of a
//     system's O(D^3) steps, most lanes masked; a warp of 32 systems
//     spends one on 32, with no shuffle or barrier; but one thread's
//     O(D^3) chain is long, so it serves buckets with systems enough to
//     fill the card. The split route's
//     cost: the sums go through the workspace (D(D+3)/2 + 2 floats a
//     table row and candidate, written once, read once).
//   Ranks 33 .. MAX_D take the block kernel with the candidates on
//   gridDim.y, at the entry-major row strides (Cand.ld, .sld, .tld,
//   .tsld).
//
//   Bound: C times K1's, per iteration: at ML-20M rank 20, C = 4, 1.13 ms
//   by operations (chip_smoke.py). The earlier design -- K1's launches with
//   the candidates on gridDim.y, each reading the row's entries and its
//   own [N, D] table, two shared words a product -- stays reachable only
//   as chip_smoke.py's same-run baseline (ops/als.py
//   _solve_bucket_sweep_grid).
//
// Later work: K1's own products register-blocked and its finish a
//   thread a system, as K1s's are; cp.async / TMA prefetch of the next
//   tile, and the gather's loads issued before their use (K1s batches
//   them); registers, the tile width and warps per
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
  // rows of the tables (the block kernel): elements between two rows of
  // the opposite table and of the target, and floats between two rows'
  // int8 scales. D, 1, D, 1 for [N, D] tables; C * D, C, C * D, C for
  // the entry-major [N, C, D] stacks of a sweep
  size_t ld, sld, tld, tsld;
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

// x (sb[0 .. D-1], shared) -> target row `row` in its storage dtype, by
// the 32 lanes of one warp; the row starts at row * ld elements, its
// int8 scale at target_scales[row * sld]
__device__ __forceinline__ void write_row(const float* sb, int lane, int D, size_t row,
                                          void* target, int target_code,
                                          float* target_scales, size_t ld, size_t sld) {
  if (target_code == F32) {
    float* tt = (float*)target + row * ld;
    for (int d = lane; d < D; d += 32) tt[d] = sb[d];
  } else if (target_code == BF16) {
    __nv_bfloat16* tt = (__nv_bfloat16*)target + row * ld;
    for (int d = lane; d < D; d += 32) tt[d] = __float2bfloat16_rn(sb[d]);
  } else {
    float m = 0.0f;
    for (int d = lane; d < D; d += 32) m = nanmax(m, fabsf(sb[d]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nanmax(m, __shfl_xor_sync(FULL, m, off));
    float scale = __fdiv_rn(m, 127.0f);
    if (!(scale > 0.0f)) scale = 1.0f;
    int8_t* tt = (int8_t*)target + row * ld;
    for (int d = lane; d < D; d += 32) {
      const float v = __fdiv_rn(sb[d], scale);
      tt[d] = v != v ? (int8_t)0 : (int8_t)(int)rintf(v);  // NaN -> 0, as XLA
    }
    if (lane == 0) target_scales[row * sld] = scale;
  }
}

// x (sb[0 .. D-1], shared) -> x_out[r] and target[row_ids[r]], by the 32
// lanes of one warp (write_row)
__device__ __forceinline__ void write_back(const float* sb, int lane, int D, int r,
                                           float* x_out, void* target, int target_code,
                                           float* target_scales, const int* row_ids,
                                           size_t ld, size_t sld) {
  if (x_out != nullptr)
    for (int d = lane; d < D; d += 32) x_out[(size_t)r * D + d] = sb[d];
  if (target == nullptr) return;
  write_row(sb, lane, D, (size_t)row_ids[r], target, target_code, target_scales, ld, sld);
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
      if (c >= 0)
        g = gathered(other, other_scales, (size_t)c * cand.ld + d, (size_t)c * cand.sld, bf16c);
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
      const float g = gathered(other, other_scales, (size_t)s_col[0] * cand.ld + d,
                               (size_t)s_col[0] * cand.sld, bf16c);
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

  write_back(sb, lane, D, r, x_out, target, target_code, target_scales, row_ids, cand.tld,
             cand.tsld);
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
  write_back(sb, lane, D, r, a.x_out, a.target, a.target_code, a.target_scales, a.row_ids, D,
             1);
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

// -- K1s: the candidate axis, one warp a row for a chunk of candidates ------------

constexpr int K1S_MAX_NB = 4;         // register blocks a lane owns at most (ops/als.py)
constexpr int K1S_WARP_SMEM = 49152;  // bytes of one warp's tile at most
constexpr int K1S_BLOCK_SMEM = 49152; // bytes of a block's tiles at most
constexpr int K1S_MAX_WARPS = 8;      // warps (rows) a block at most
// systems (solved row, candidate) from which the finish takes a thread a
// system; below, a warp a row (ops/als.py K1S_THREAD_SYSTEMS)
constexpr int K1S_THREAD_SYSTEMS = 16384;

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ __forceinline__ int imin(int x, int y) { return x < y ? x : y; }
__host__ __device__ __forceinline__ int imax(int x, int y) { return x > y ? x : y; }

// S x S blocks over the (D + 1) x D lower trapezoid of one candidate's
// sums: row i < D holds A[i][k] for k <= i, row D holds b[k]. Row block I
// (rows I*S .. I*S + S - 1) takes column blocks 0 .. k1s_row_blocks - 1.
__host__ __device__ inline int k1s_row_blocks(int S, int D, int I) {
  const int NJ = (D + S - 1) / S;
  const int last = imin(I * S + S - 1, D) / S;
  return imin(NJ, last + 1);
}
__host__ __device__ inline int k1s_blocks(int S, int D) {
  int n = 0;
  for (int I = 0; I < (D + S) / S; ++I) n += k1s_row_blocks(S, D, I);
  return n;
}

// One entry's record for one candidate in the tile: X = wg[0 .. D-1], r
// (padded to a multiple of 4), then Y = g[0 .. D-1] (padded to a multiple
// of S). Where D is a multiple of 4 every record and both halves start
// 16-byte aligned, and the gather writes 4 values a store.
__host__ __device__ inline int k1s_lx(int, int D) { return round_up(D + 1, 4); }
__host__ __device__ inline int k1s_record(int S, int D) {
  return k1s_lx(S, D) + round_up(D, S);
}
// one warp's shared floats: the tile, then the weights w and the int8
// scales, [32][cw] each
__host__ __device__ inline int k1s_warp_floats(int S, int D, int cw) {
  return 32 * cw * k1s_record(S, D) + 64 * cw;
}
// the finish's shared floats: a warp of 32 systems of D(D+3)/2 sums,
// entry-major; or, a warp a row, cw candidates' D + 1 rows of lda floats
__host__ __device__ inline int k1s_system_floats(int D) { return 32 * (D * (D + 3) / 2); }
__host__ __device__ inline int k1s_lda(int D) { return round_up(D + 1, 4); }
__host__ __device__ inline int k1s_row_floats(int D, int cw) { return cw * (D + 1) * k1s_lda(D); }

// The plan of a sweep of C candidates at rank D (ops/als.py k1s_plan is
// the same formula): for each block side S in {1, 2, 4}, the most
// candidates a warp takes (cw, at most 32) with at most K1S_MAX_NB blocks
// a lane and a warp's tile of at most K1S_WARP_SMEM bytes; the candidates
// split into chunks of equal size (gridDim.y); an entry costs NB * max(S
// * S, 8 * S) a chunk -- a lane's NB blocks of S * S FMAs (an SM issues 4
// warp FMAs a clock) against their 2S shared words (one 32-word wavefront
// a clock), whichever is larger -- times the chunks. The cheapest S wins,
// the larger on a tie. warps: table rows a block, as many as
// K1S_BLOCK_SMEM holds (at most K1S_MAX_WARPS).
struct K1sPlan {
  int cw, chunks, S, nb, warps;
};
__host__ inline K1sPlan k1s_plan(int C, int D) {
  K1sPlan best{0, 0, 0, 0, 0};
  long long best_cost = -1;
  for (int S = 1; S <= 4; S *= 2) {
    const int nblk = k1s_blocks(S, D);
    int cw = imin(imin(C, 32), 32 * K1S_MAX_NB / nblk);
    while (cw > 0 && 4 * k1s_warp_floats(S, D, cw) > K1S_WARP_SMEM) --cw;
    if (cw == 0) continue;
    const int chunks = (C + cw - 1) / cw;
    cw = (C + chunks - 1) / chunks;
    const int nb = (cw * nblk + 31) / 32;
    const long long cost = (long long)nb * imax(S * S, 8 * S) * chunks;
    if (best_cost < 0 || cost <= best_cost) {
      best_cost = cost;
      best = K1sPlan{cw, chunks, S, nb, 0};
    }
  }
  best.warps = imax(1, imin(K1S_MAX_WARPS,
                          K1S_BLOCK_SMEM / (4 * k1s_warp_floats(best.S, D, best.cw))));
  return best;
}

// A sweep launch's arguments. The stacks are entry-major: candidate c's
// row n of the opposite table starts at other[(n * C + c) * D] (its int8
// scale at other_scales[n * C + c]), and the same for the target.
struct Sweep {
  const void* other;
  const float* other_scales;
  const int* col_ids;
  const float* ratings;
  const float* mask;
  const int* seg_start;
  int R, B, K, D, C;
  int weighted, bf16c, implicit;
  const float* regs;    // [C]
  const float* alphas;  // [C]
  const float* gram;    // [C, D, D] (implicit) or NULL
  float* workspace;     // [C, B, D(D+3)/2 + 2]: a segmented bucket's partials
  void* target;
  int target_code;
  float* target_scales;
  const int* row_ids;
  int vec;          // every chunk of an entry's rows 16-byte aligned: 16 bytes a lane
  int cw, S, nblk;  // the plan (k1s_plan)
  int warp_floats;  // a warp's shared floats
};

// x / d for 0 <= x < 2^16 and d <= 2^10, as (x * m) >> 32 with m = ceil(2^32 / d)
__host__ __device__ __forceinline__ unsigned long long div_magic(int d) {
  return ((1ull << 32) + d - 1) / d;
}
__device__ __forceinline__ int div_by(int x, unsigned long long m) {
  return (int)(((unsigned long long)x * m) >> 32);
}

// 16 bytes of a factor table (as loaded) as floats, before any scale or
// rounding; and one value's bits
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& q, float* v);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& q, float* v) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& q, float* v) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // a bf16 is the high half of its float
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void unpack16<int8_t>(const uint4& q, float* v) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = (float)((int)(w[j >> 2] << (24 - 8 * (j & 3))) >> 24);
}
__device__ __forceinline__ unsigned raw_bits(const float* p) { return __float_as_uint(*p); }
__device__ __forceinline__ unsigned raw_bits(const __nv_bfloat16* p) {
  return (unsigned)*reinterpret_cast<const unsigned short*>(p) << 16;
}
__device__ __forceinline__ unsigned raw_bits(const int8_t* p) { return (unsigned)(int)*p; }
template <typename T>
__device__ __forceinline__ float unpack1(unsigned b);
template <>
__device__ __forceinline__ float unpack1<float>(unsigned b) { return __uint_as_float(b); }
template <>
__device__ __forceinline__ float unpack1<__nv_bfloat16>(unsigned b) { return __uint_as_float(b); }
template <>
__device__ __forceinline__ float unpack1<int8_t>(unsigned b) { return (float)(int)b; }
// a raw value as gathered() gives it in the compute dtype (sc: its int8 scale)
__device__ __forceinline__ float cooked(const float*, float v, float, bool bf16c) {
  return bf16c ? bf16_round(v) : v;
}
__device__ __forceinline__ float cooked(const __nv_bfloat16*, float v, float, bool) {
  return v;
}
__device__ __forceinline__ float cooked(const int8_t*, float q, float sc, bool bf16c) {
  return bf16c ? bf16_round(__fmul_rn(q, bf16_round(sc))) : __fmul_rn(q, sc);
}

// Stage one tile: for entry k (0..31) and candidate c of the chunk, X =
// w * g (rounded as K1 rounds it) and Y = g into the record at tile[(k *
// cw + c) * SR], from the chunk's cn * D values of row col_k, which the
// entry-major table keeps contiguous: 16 bytes a lane where a.vec, else
// one value a lane, lanes on neighbouring values. A lane issues the loads
// of GATHER_BATCH of its pieces before it uses the first, so a tile waits
// for ceil(pieces / 32 / GATHER_BATCH) round trips to memory, not one a
// piece; int8 scales are staged first (ssc, one round). An entry past the
// row's end (col -1) has g = 0, as in K1.
constexpr int GATHER_BATCH = 8;

// A warp's gather constants, made once before its tiles: the magic
// numbers of the divisions by D and by the pieces an entry takes (a
// 64-bit division each, too slow for every tile).
struct GatherShape {
  int per, NV;  // values a piece, pieces an entry
  unsigned long long mD, mV;
};
template <typename T>
__device__ __forceinline__ GatherShape gather_shape(const Sweep& a, int cn) {
  const int per = a.vec ? 16 / (int)sizeof(T) : 1;
  const int NV = cn * a.D / per;
  return GatherShape{per, NV, div_magic(a.D), div_magic(NV)};
}

template <typename T>
__device__ __forceinline__ void sweep_gather(const Sweep& a, const GatherShape& gs, int c0,
                                             int cn, float* tile, int ec, int lane) {
  float* sw = tile + a.warp_floats - 64 * a.cw;  // w [32][cw]
  float* ssc = sw + 32 * a.cw;                   // int8 scales [32][cw]
  const int D = a.D, cw = a.cw;
  const int SR = k1s_record(a.S, D);
  const int LX = k1s_lx(a.S, D);
  const unsigned long long mD = gs.mD;
  const T* other = (const T*)a.other;
  const bool bf16c = a.bf16c;
  if (a.other_scales != nullptr) {  // lane k: its entry's scales, loads in flight together
#pragma unroll 4
    for (int c = 0; c < cn; ++c)
      ssc[lane * cw + c] = ec >= 0 ? a.other_scales[(size_t)ec * a.C + c0 + c] : 0.0f;
    __syncwarp();
  }
  constexpr int EPV = 16 / sizeof(T);
  const int per = gs.per;  // values a lane takes at once
  const bool quads = a.vec && D % 4 == 0;
  const int NV = gs.NV;  // pieces of an entry
  const unsigned long long mV = gs.mV;
  for (int it0 = 0; it0 < NV; it0 += GATHER_BATCH) {
    uint4 raw[GATHER_BATCH];
    int ks[GATHER_BATCH], cols[GATHER_BATCH], f0s[GATHER_BATCH];
#pragma unroll
    for (int j = 0; j < GATHER_BATCH; ++j) {  // the batch's loads, all in flight
      const int it = it0 + j;                 // warp-uniform: every lane shuffles
      if (it < NV) {
        const int e = it * 32 + lane;
        const int k = div_by(e, mV);  // the entry
        ks[j] = k;
        f0s[j] = (e - k * NV) * per;  // the first value's place in the chunk
        cols[j] = __shfl_sync(FULL, ec, k);
        const T* p = other + ((size_t)cols[j] * a.C + c0) * D + f0s[j];
        if (cols[j] < 0)
          raw[j] = make_uint4(0u, 0u, 0u, 0u);
        else if (a.vec)
          raw[j] = *reinterpret_cast<const uint4*>(p);
        else
          raw[j].x = raw_bits(p);
      }
    }
#pragma unroll
    for (int j = 0; j < GATHER_BATCH; ++j) {
      if (it0 + j < NV) {
        float v[EPV];
        if (a.vec)
          unpack16<T>(raw[j], v);
        else
          v[0] = unpack1<T>(raw[j].x);
        const int k = ks[j];
        int c = div_by(f0s[j], mD);
        int d = f0s[j] - c * D;
        if (quads) {  // each 4 values one candidate's, 16-byte aligned: one store each
#pragma unroll
          for (int q = 0; q < EPV; q += 4) {
            const float sc = a.other_scales != nullptr ? ssc[k * cw + c] : 0.0f;
            const float w = sw[k * cw + c];
            float4 g4, wg4;
            float* g = &g4.x;
            float* wg = &wg4.x;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              g[u] = cols[j] >= 0 ? cooked(other, v[q + u], sc, bf16c) : 0.0f;
              wg[u] = __fmul_rn(w, g[u]);
              if (bf16c) wg[u] = bf16_round(wg[u]);
            }
            float* rec = tile + (k * cw + c) * SR;
            *reinterpret_cast<float4*>(rec + d) = wg4;
            *reinterpret_cast<float4*>(rec + LX + d) = g4;
            d += 4;
            if (d == D) {
              d = 0;
              ++c;
            }
          }
          continue;
        }
#pragma unroll
        for (int q = 0; q < EPV; ++q) {
          if (q < per) {
            const float sc = a.other_scales != nullptr ? ssc[k * cw + c] : 0.0f;
            const float g = cols[j] >= 0 ? cooked(other, v[q], sc, bf16c) : 0.0f;
            float wg = __fmul_rn(sw[k * cw + c], g);
            if (bf16c) wg = bf16_round(wg);
            float* rec = tile + (k * cw + c) * SR;
            rec[d] = wg;
            rec[LX + d] = g;
            if (++d == D) {
              d = 0;
              ++c;
            }
          }
        }
      }
    }
  }
}

// Block q of a lane: u = lane + 32 q over the chunk's cn * nblk blocks,
// candidate after candidate, each candidate's row blocks I in order and
// their column blocks J in order. c = -1: the lane has no block q.
__device__ __forceinline__ void sweep_block(int u, int cn, int nblk, int S, int D, int& c,
                                            int& i0, int& j0) {
  c = -1;
  i0 = j0 = 0;
  if (u >= cn * nblk) return;
  c = u / nblk;
  int b = u - c * nblk;
  int I = 0;
  for (int n = k1s_row_blocks(S, D, 0); b >= n; n = k1s_row_blocks(S, D, ++I)) b -= n;
  i0 = I * S;
  j0 = b * S;
}

// S floats of shared memory at p (S-aligned) into v
template <int S>
__device__ __forceinline__ void lds(const float* p, float* v) {
  if (S == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if (S == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// One warp per table row for the chunk's candidates, each candidate's
// partial sums written to the workspace (as K1's warp_partials_kernel
// writes them). The accumulation is K1's warp_accumulate, per candidate,
// with the row's entries read once: the same weights, the same gathered
// values, each tile's 32 products of an entry of A or b into a partial
// with fmaf in entry order from 0.0f, then added to its running sum; a
// tile whose entries are all padding is skipped for the candidates it is
// padding for. A lane owns NB blocks of S x S entries (sweep_block); for
// each it reads S values of X and S of Y a tile entry and makes S * S
// products: 2 / S shared words a product.
template <typename T, int S, int NB>
__global__ void __launch_bounds__(K1S_MAX_WARPS * 32)
sweep_kernel(const Sweep a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= a.B) return;
  const int D = a.D, cw = a.cw;
  const int c0 = blockIdx.y * cw;
  const int cn = imin(cw, a.C - c0);
  const int off = warp * a.warp_floats;
  float* tile = smem + off;
  float* sw = tile + a.warp_floats - 64 * cw;
  const int SR = k1s_record(S, D);
  const int LX = k1s_lx(S, D);
  const int step = cw * SR;  // floats between two entries' records of a candidate
  const GatherShape gs = gather_shape<T>(a, cn);

  int bc[NB], bx[NB], by[NB];  // each block's candidate, X offset, Y offset
  float acc[NB][S][S];
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    int i0, j0;
    sweep_block(lane + 32 * q, cn, a.nblk, S, D, bc[q], i0, j0);
    bx[q] = bc[q] * SR + i0;
    by[q] = bc[q] * SR + LX + j0;
#pragma unroll
    for (int x = 0; x < S; ++x)
#pragma unroll
      for (int y = 0; y < S; ++y) acc[q][x][y] = 0.0f;
  }

  const long long base = (long long)r * a.K;  // table row r
  const long long total = a.K;
  const unsigned all = cn == 32 ? FULL : (1u << cn) - 1u;
  float n_acc = 0.0f;
  unsigned skipped = 0;  // candidates that skipped a tile of padding (warp-uniform)
  int pad_col = 0;       // lane c: candidate c's first skipped padding entry's column
  int nec = -1;  // the next tile's entry of this lane, loaded a tile ahead
  float nm = 0.0f, nrt = 0.0f;
  if (lane < total) {
    nec = a.col_ids[base + lane];
    nm = a.mask[base + lane];
    nrt = a.ratings[base + lane];
  }
  for (long long t0 = 0; t0 < total; t0 += TILE_K) {
    const int ec = nec;
    const float m = nm, rt = nrt;
    nec = -1;
    nm = nrt = 0.0f;
    if (t0 + TILE_K + lane < total) {
      const long long t = base + t0 + TILE_K + lane;
      nec = a.col_ids[t];
      nm = a.mask[t];
      nrt = a.ratings[t];
    }
    float msum = m;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) msum += __shfl_xor_sync(FULL, msum, o);
    n_acc += msum;
    unsigned live = 0;
    for (int c = 0; c < cn; ++c) {
      float w, rr;
      if (a.implicit) {
        const float ar = __fmul_rn(a.alphas[c0 + c], rt);
        w = __fmul_rn(ar, m);
        rr = __fmul_rn(__fadd_rn(1.0f, ar), m);
      } else {
        w = m;
        rr = __fmul_rn(rt, m);
      }
      if (a.bf16c) {
        w = bf16_round(w);
        rr = bf16_round(rr);
      }
      sw[lane * cw + c] = w;
      tile[(lane * cw + c) * SR + D] = rr;  // X[D]: the rhs weight
      if (__any_sync(FULL, (m != 0.0f) || (rr != 0.0f))) live |= 1u << c;
    }
    if (live != all) {  // padding for some candidates: exact zeros for them
      const int first = __shfl_sync(FULL, ec, 0);
      const unsigned now = all & ~live & ~skipped;
      if ((now >> lane) & 1u) pad_col = first;
      skipped |= now;
      if (live == 0) continue;
    }
    __syncwarp();
    sweep_gather<T>(a, gs, c0, cn, tile, ec, lane);
    __syncwarp();
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      if (bc[q] >= 0 && ((live >> bc[q]) & 1u)) {
        const float* xs = tile + bx[q];
        const float* ys = tile + by[q];
        float s[S][S];
#pragma unroll
        for (int x = 0; x < S; ++x)
#pragma unroll
          for (int y = 0; y < S; ++y) s[x][y] = 0.0f;
#pragma unroll 4
        for (int k = 0; k < TILE_K; ++k) {
          float xv[S], yv[S];
          lds<S>(xs + k * step, xv);
          lds<S>(ys + k * step, yv);
#pragma unroll
          for (int x = 0; x < S; ++x)
#pragma unroll
            for (int y = 0; y < S; ++y) s[x][y] = fmaf(xv[x], yv[y], s[x][y]);
        }
#pragma unroll
        for (int x = 0; x < S; ++x)
#pragma unroll
          for (int y = 0; y < S; ++y) acc[q][x][y] += s[x][y];
      }
    }
    __syncwarp();
  }

  // the skipped padding rows: a value that is not finite fails the solve
  unsigned bad = 0;
  for (int c = 0; c < cn; ++c) {
    if (!((skipped >> c) & 1u)) continue;
    const int pc = __shfl_sync(FULL, pad_col, c);
    const size_t prow = (size_t)pc * a.C + c0 + c;
    int nf = 0;
    if (lane < D) nf = !isfinite(gathered((const T*)a.other, a.other_scales, prow * D + lane,
                                          prow, a.bf16c));
    if (__any_sync(FULL, nf)) bad |= 1u << c;
  }
  const float n = __shfl_sync(FULL, n_acc, 0);

  const int NT = D * (D + 1) / 2;
  const int NE = NT + D;
  // each needed entry of a lane's blocks, to its candidate's partials
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    if (bc[q] < 0) continue;
    const int i0 = bx[q] - bc[q] * SR;
    const int j0 = by[q] - bc[q] * SR - LX;
    float* w = a.workspace + ((size_t)(c0 + bc[q]) * a.B + r) * (NE + 2);
#pragma unroll
    for (int x = 0; x < S; ++x) {
#pragma unroll
      for (int y = 0; y < S; ++y) {
        const int i = i0 + x, k = j0 + y;
        if (i <= D && k < D && k <= i) w[i < D ? i * (i + 1) / 2 + k : NT + k] = acc[q][x][y];
      }
    }
  }
  if (lane < cn) {
    float* w = a.workspace + ((size_t)(c0 + lane) * a.B + r) * (NE + 2);
    w[NE] = n;
    w[NE + 1] = ((bad >> lane) & 1u) ? 1.0f : 0.0f;
  }
}

// The finish, one thread a system (solved row r, candidate c): its
// segments' partials summed in segment order from the first (as K1's
// warp_finish_kernel sums them), then every operation of K1's
// warp_finish on each entry, in its order: A[i][i] + lam (reg * n, or
// reg; 1 where n is not > 0), then + the Gramian (implicit), A[i][k] +
// the Gramian; Cholesky column by column (pivot, sqrtf, L[i][j] = A[i][j]
// / L[j][j], A[i][k] = fmaf(-L[i][j], L[k][j], A[i][k])); both
// substitutions; a pivot that is not > 0 or a flagged segment makes x
// NaN; write_row's write-back. A warp holds 32 systems in shared memory,
// entry-major (entry e of thread t at e * 32 + t: no bank conflicts),
// so each thread runs its own O(D^3) elimination with no shuffle, no
// barrier and no lane idle: where a warp a system spent a warp
// instruction on each of a system's steps, a warp of systems spends one
// on 32.
__global__ void __launch_bounds__(32) sweep_system_kernel(const Sweep a) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const long long sys = (long long)blockIdx.x * 32 + t;
  if (sys >= (long long)a.R * a.C) return;  // no warp-wide step follows
  const int c = (int)(sys / a.R);
  const int r = (int)(sys - (long long)c * a.R);
  const int D = a.D;
  const int NT = D * (D + 1) / 2;
  const int NE = NT + D;
  float* M = smem + t;  // entry e at M[e * 32]; A[i][k] is entry i(i+1)/2 + k, b[i] NT + i
  const float* w = a.workspace + (size_t)c * a.B * (NE + 2);
  const int s0 = a.seg_start[r], s1 = a.seg_start[r + 1];
  float n = 0.0f;
  bool bad = false;
  for (int s = s0; s < s1; ++s) {
    const float* ws = w + (size_t)s * (NE + 2);
#pragma unroll 8
    for (int e = 0; e < NE; ++e) M[e * 32] = s == s0 ? ws[e] : __fadd_rn(M[e * 32], ws[e]);
    n = s == s0 ? ws[NE] : __fadd_rn(n, ws[NE]);
    bad |= ws[NE + 1] != 0.0f;
  }
  const float reg = a.regs[c];
  float lam = a.weighted ? __fmul_rn(reg, n) : reg;
  if (!(n > 0.0f)) lam = 1.0f;
  const float* gram = a.implicit ? a.gram + (size_t)c * D * D : nullptr;
  for (int i = 0, e = 0; i < D; ++i) {
    for (int k = 0; k <= i; ++k, ++e) {
      float v = M[e * 32];
      if (k == i) v = __fadd_rn(v, lam);
      if (gram != nullptr) v = __fadd_rn(v, gram[i * D + k]);
      M[e * 32] = v;
    }
  }
  // Cholesky, column j at a time, right-looking. The loops take 4 rows at
  // a time, their loads before their stores: the compiler cannot tell
  // that a store to column k does not feed the next row's load of column
  // j, and would otherwise wait out every load.
  for (int j = 0; j < D && !bad; ++j) {
    const int jj = j * (j + 1) / 2 + j;
    const float diag = M[jj * 32];
    if (!(diag > 0.0f)) {
      bad = true;
      break;
    }
    const float dj = sqrtf(diag);
    M[jj * 32] = dj;
    int i = j + 1;
    for (; i + 4 <= D; i += 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = M[((i + u) * (i + u + 1) / 2 + j) * 32];
#pragma unroll
      for (int u = 0; u < 4; ++u) M[((i + u) * (i + u + 1) / 2 + j) * 32] = v[u] / dj;
    }
    for (; i < D; ++i) {
      const int ij = i * (i + 1) / 2 + j;
      M[ij * 32] = M[ij * 32] / dj;
    }
    for (int k = j + 1; k < D; ++k) {
      const float lkj = M[(k * (k + 1) / 2 + j) * 32];
      int i = k;
      for (; i + 4 <= D; i += 4) {
        float l[4], v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int row = (i + u) * (i + u + 1) / 2;
          l[u] = M[(row + j) * 32];
          v[u] = M[(row + k) * 32];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          M[((i + u) * (i + u + 1) / 2 + k) * 32] = fmaf(-l[u], lkj, v[u]);
      }
      for (; i < D; ++i) {
        const int row = i * (i + 1) / 2;
        M[(row + k) * 32] = fmaf(-M[(row + j) * 32], lkj, M[(row + k) * 32]);
      }
    }
  }
  float* x = M + NT * 32;  // b, then y, then x: x[i] at x[i * 32]
  if (bad) {  // a failed factorization: x is NaN, as K1's is
    for (int i = 0; i < D; ++i) x[i * 32] = __int_as_float(0x7fc00000);
  } else {
    for (int j = 0; j < D; ++j) {  // L y = b
      const float yj = x[j * 32] / M[(j * (j + 1) / 2 + j) * 32];
      x[j * 32] = yj;
      int i = j + 1;
      for (; i + 4 <= D; i += 4) {
        float l[4], v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          l[u] = M[((i + u) * (i + u + 1) / 2 + j) * 32];
          v[u] = x[(i + u) * 32];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) x[(i + u) * 32] = fmaf(-l[u], yj, v[u]);
      }
      for (; i < D; ++i) x[i * 32] = fmaf(-M[(i * (i + 1) / 2 + j) * 32], yj, x[i * 32]);
    }
    for (int j = D - 1; j >= 0; --j) {  // L^T x = y
      const int row = j * (j + 1) / 2;
      const float xj = x[j * 32] / M[(row + j) * 32];
      x[j * 32] = xj;
      int i = 0;
      for (; i + 4 <= j; i += 4) {
        float l[4], v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          l[u] = M[(row + i + u) * 32];
          v[u] = x[(i + u) * 32];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) x[(i + u) * 32] = fmaf(-l[u], xj, v[u]);
      }
      for (; i < j; ++i) x[i * 32] = fmaf(-M[(row + i) * 32], xj, x[i * 32]);
    }
  }
  // write_row's write-back, by one thread
  const size_t at = (size_t)a.row_ids[r] * a.C + c;  // (row, candidate) of the target
  if (a.target_code == F32) {
    float* tt = (float*)a.target + at * D;
    for (int d = 0; d < D; ++d) tt[d] = x[d * 32];
  } else if (a.target_code == BF16) {
    __nv_bfloat16* tt = (__nv_bfloat16*)a.target + at * D;
    for (int d = 0; d < D; ++d) tt[d] = __float2bfloat16_rn(x[d * 32]);
  } else {
    float m = 0.0f;
    for (int d = 0; d < D; ++d) m = nanmax(m, fabsf(x[d * 32]));
    float scale = __fdiv_rn(m, 127.0f);
    if (!(scale > 0.0f)) scale = 1.0f;
    int8_t* tt = (int8_t*)a.target + at * D;
    for (int d = 0; d < D; ++d) {
      const float v = __fdiv_rn(x[d * 32], scale);
      tt[d] = v != v ? (int8_t)0 : (int8_t)(int)rintf(v);  // NaN -> 0, as XLA
    }
    a.target_scales[at] = scale;
  }
}

// The finish of a bucket with few systems, where a thread a system
// would leave the card idle and wait out one thread's O(D^3) chain: one
// warp a solved row r for the chunk's candidates [c0, c0 + cn), each
// candidate D lanes
// (32 / D candidates a pass), lane i holding row i of A. The arithmetic of
// each entry is sweep_system_kernel's, in its order: the segments'
// partials summed from the first, A[i][i] + lam, + the Gramian; Cholesky
// left-looking (row i's entry k takes fmaf(-L[i][j], L[k][j], .) for j =
// 0 .. k-1 in order, then sqrtf or / L[k][k], the chain the right-looking
// updates make), L's rows to shared memory as they are made; both
// substitutions with lane i holding x[i]; write_row. Lanes off the pass
// take no square root or division (their garbage would take the slow
// paths). The sums come from the workspace's partials of the row's
// segments, summed from the first; n and the flags too. Shared memory: a
// warp's candidates' D + 1 rows of lda floats (L's rows; x in row D).
__global__ void __launch_bounds__(K1S_MAX_WARPS * 32) sweep_row_kernel(const Sweep a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= a.R) return;
  const int c0 = blockIdx.y * a.cw;
  const int cn = imin(a.cw, a.C - c0);
  const int D = a.D;
  const int lda = k1s_lda(D);
  float* As = smem + warp * k1s_row_floats(D, a.cw);
  const int NT = D * (D + 1) / 2;
  const int NE = NT + D;
  const int CPP = 32 / D;  // candidates a pass
  const int s0 = a.seg_start[r], s1 = a.seg_start[r + 1];
  float n = 0.0f;
  {
    const float* w0 = a.workspace + (size_t)c0 * a.B * (NE + 2);
    for (int s = s0; s < s1; ++s) {
      const float v = w0[(size_t)s * (NE + 2) + NE];
      n = s == s0 ? v : __fadd_rn(n, v);
    }
  }
  const size_t row_out = (size_t)a.row_ids[r];
  const int telem = a.target_code == F32 ? 4 : a.target_code == BF16 ? 2 : 1;
  for (int p0 = 0; p0 < cn; p0 += CPP) {
    const int cs = lane / D;
    const int i = lane - cs * D;
    const int c = p0 + cs;
    const bool on = cs < CPP && c < cn;
    const int cc = on ? c : 0;  // lanes off the pass read candidate 0 and write nothing
    const int cg = c0 + cc;
    float* Ac = As + (size_t)cc * (D + 1) * lda;
    const int src = cs * D;  // the pass's lane of row 0 of this candidate
    const float reg = a.regs[cg];
    float lam = a.weighted ? __fmul_rn(reg, n) : reg;
    if (!(n > 0.0f)) lam = 1.0f;
    bool bad = false;
    float x = 0.0f;  // b[i], then y, then x
    float row[32];   // row i of A, then of L
#pragma unroll
    for (int k = 0; k < 32; ++k) row[k] = 0.0f;
    const float* wrow = a.workspace + (size_t)cg * a.B * (NE + 2);
    for (int s = s0; s < s1; ++s) {  // each segment's row in one go: its loads in flight
      const float* w = wrow + (size_t)s * (NE + 2);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        if (k < D && on && k <= i) {
          const float v = w[i * (i + 1) / 2 + k];
          row[k] = s == s0 ? v : __fadd_rn(row[k], v);
        }
      }
      if (on) {
        x = s == s0 ? w[NT + i] : __fadd_rn(x, w[NT + i]);
        bad |= w[NE + 1] != 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (k < D && on && k <= i) {
        if (k == i) row[k] = __fadd_rn(row[k], lam);
        if (a.implicit) row[k] = __fadd_rn(row[k], a.gram[(size_t)cg * D * D + i * D + k]);
      }
    }
    // Cholesky: column k of L, left-looking
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (k < D) {
        const float* Lk = Ac + k * lda;  // row k of L: its entries j < k are made
#pragma unroll
        for (int j = 0; j < k; ++j)
          if (i >= k) row[k] = fmaf(-row[j], Lk[j], row[k]);
        const float diag = __shfl_sync(FULL, row[k], src + k);
        if (on) {
          bad |= !(diag > 0.0f);
          if (i >= k) {
            const float dk = sqrtf(diag);
            row[k] = i == k ? dk : row[k] / dk;
            Ac[i * lda + k] = row[k];
          }
        }
        __syncwarp();
      }
    }
    // L y = b, then L^T x = y (lane i holds x[i])
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j < D) {
        const float xj = __shfl_sync(FULL, x, src + j);
        if (on && i >= j) {
          const float yj = xj / Ac[j * lda + j];
          x = i == j ? yj : fmaf(-row[j], yj, x);
        }
      }
    }
    for (int j = D - 1; j >= 0; --j) {
      const float yj = __shfl_sync(FULL, x, src + j);
      if (on && i <= j) {
        const float xj = yj / Ac[j * lda + j];
        x = i == j ? xj : fmaf(-Ac[j * lda + i], xj, x);
      }
    }
    if (bad) x = __int_as_float(0x7fc00000);  // a failed factorization: NaN, as K1
    if (on) Ac[D * lda + i] = x;
    __syncwarp();
    for (int q = 0; q < CPP && p0 + q < cn; ++q) {
      const int cq = c0 + p0 + q;
      write_row(As + (size_t)(p0 + q) * (D + 1) * lda + D * lda, lane, D, row_out,
                (char*)a.target + (size_t)cq * D * telem, a.target_code,
                a.target_scales == nullptr ? nullptr : a.target_scales + cq,
                (size_t)a.C * D, (size_t)a.C);
    }
    __syncwarp();
  }
}

enum SweepLaunch { SWEEP_PARTIALS = 0, SWEEP_FINISH = 1, SWEEP_BLOCK = 2 };

template <typename T, int S, int NB>
cudaError_t launch_sweep(const Sweep& a, const K1sPlan& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * p.warps * a.warp_floats;
  sweep_kernel<T, S, NB><<<dim3((a.B + p.warps - 1) / p.warps, p.chunks), p.warps * 32, smem,
                           stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int S>
cudaError_t dispatch_sweep_nb(const Sweep& a, const K1sPlan& p, cudaStream_t st) {
  switch (p.nb) {
    case 1: return launch_sweep<T, S, 1>(a, p, st);
    case 2: return launch_sweep<T, S, 2>(a, p, st);
    case 3: return launch_sweep<T, S, 3>(a, p, st);
    default: return launch_sweep<T, S, 4>(a, p, st);
  }
}

// The finish of a split bucket: a thread a system from K1S_THREAD_SYSTEMS
// systems up, else a warp a row
cudaError_t launch_finish(const Sweep& a, const K1sPlan& p, cudaStream_t st) {
  if ((long long)a.R * a.C < K1S_THREAD_SYSTEMS) {
    const int warps =
        imax(1, imin(K1S_MAX_WARPS, K1S_BLOCK_SMEM / (4 * k1s_row_floats(a.D, a.cw))));
    sweep_row_kernel<<<dim3((a.R + warps - 1) / warps, p.chunks), warps * 32,
                       sizeof(float) * warps * k1s_row_floats(a.D, a.cw), st>>>(a);
    return cudaGetLastError();
  }
  const size_t smem = sizeof(float) * k1s_system_floats(a.D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sweep_system_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long systems = (long long)a.R * a.C;
  sweep_system_kernel<<<(unsigned)((systems + 31) / 32), 32, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_sweep(int launch, const Sweep& a, const K1sPlan& p, cudaStream_t st) {
  if (launch == SWEEP_FINISH) return launch_finish(a, p, st);
  if (p.S == 1) return dispatch_sweep_nb<T, 1>(a, p, st);
  if (p.S == 2) return dispatch_sweep_nb<T, 2>(a, p, st);
  return dispatch_sweep_nb<T, 4>(a, p, st);
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
                  (size_t)R * D, (size_t)D * D, (size_t)B * (D * (D + 3) / 2 + 2), C,
                  (size_t)D, 1, (size_t)D, 1};
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

// One launch of K1s, the candidate axis of a sweep, on one bucket: C
// candidates' entry-major [N, C, D] opposite tables (int8 scales [N, C])
// and targets, regs and alphas [C], gram [C, D, D] (implicit). launch, at
// D <= WARP_MAX_D: SWEEP_PARTIALS (one warp a table row for a chunk of
// candidates, into workspace [C, B, D(D+3)/2 + 2] f32) then SWEEP_FINISH
// (a thread a system, or a warp a row, by the systems R * C);
// SWEEP_BLOCK: ranks 33 .. MAX_D, the block kernel with the candidates
// on gridDim.y. ops/als.py k1s_route picks them. The target is written in
// place (row_ids[r]).
// plan_out (5 ints, or NULL): the plan's cw, chunks, S, nb, warps.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a refused argument.
extern "C" int pio_k1s_sweep(int launch, const void* other, int other_code,
                             const float* other_scales, const int* col_ids,
                             const float* ratings, const float* mask, const int* seg_start,
                             int R, int B, int K, int D, int C, int weighted,
                             int bf16_compute, int implicit, const float* regs,
                             const float* alphas, const float* gram, float* workspace,
                             void* target, int target_code, float* target_scales,
                             const int* row_ids, int* plan_out, void* stream) {
  if (launch < SWEEP_PARTIALS || launch > SWEEP_BLOCK) return (int)cudaErrorInvalidValue;
  if (C < 1 || C > MAX_C || K < 1 || R < 0 || B < 0) return (int)cudaErrorInvalidValue;
  if (D < 1 || D > (launch == SWEEP_BLOCK ? MAX_D : WARP_MAX_D)) return (int)cudaErrorInvalidValue;
  if (regs == nullptr || alphas == nullptr || target == nullptr || row_ids == nullptr)
    return (int)cudaErrorInvalidValue;
  if (implicit && gram == nullptr) return (int)cudaErrorInvalidValue;
  if ((other_code == I8) != (other_scales != nullptr)) return (int)cudaErrorInvalidValue;
  if ((target_code == I8) != (target_scales != nullptr)) return (int)cudaErrorInvalidValue;
  if ((launch == SWEEP_PARTIALS || launch == SWEEP_FINISH) && workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  if (other_code < F32 || other_code > I8 || target_code < F32 || target_code > I8)
    return (int)cudaErrorInvalidValue;
  const K1sPlan p = launch == SWEEP_BLOCK ? K1sPlan{1, C, 0, 0, 0} : k1s_plan(C, D);
  if (plan_out != nullptr) {
    const int v[5] = {p.cw, p.chunks, p.S, p.nb, p.warps};
    for (int j = 0; j < 5; ++j) plan_out[j] = v[j];
  }
  if ((launch == SWEEP_PARTIALS ? B : R) <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int elem = other_code == F32 ? 4 : other_code == BF16 ? 2 : 1;
  const int telem = target_code == F32 ? 4 : target_code == BF16 ? 2 : 1;
  if (launch == SWEEP_BLOCK) {  // the entry-major stacks at the block kernel's row strides
    const Cand cand{regs, alphas, (size_t)D * elem, 1, (size_t)D * telem, 1, 0,
                    (size_t)D * D, 0, C, (size_t)C * D, (size_t)C, (size_t)C * D, (size_t)C};
    cudaError_t err;
    switch (other_code) {
      case F32:
        err = dispatch<float>(other, other_scales, col_ids, ratings, mask, seg_start, R, K, D,
                              0.0f, weighted, bf16_compute, implicit, 1.0f, gram, nullptr,
                              target, target_code, target_scales, row_ids, cand, s);
        break;
      case BF16:
        err = dispatch<__nv_bfloat16>(other, other_scales, col_ids, ratings, mask, seg_start,
                                      R, K, D, 0.0f, weighted, bf16_compute, implicit, 1.0f,
                                      gram, nullptr, target, target_code, target_scales,
                                      row_ids, cand, s);
        break;
      default:
        err = dispatch<int8_t>(other, other_scales, col_ids, ratings, mask, seg_start, R, K,
                               D, 0.0f, weighted, bf16_compute, implicit, 1.0f, gram,
                               nullptr, target, target_code, target_scales, row_ids, cand, s);
    }
    return (int)err;
  }
  const int last = C - (p.chunks - 1) * p.cw;  // candidates of the last chunk
  const int vec = (uintptr_t)other % 16 == 0 && (C * D * elem) % 16 == 0 &&
                  (p.cw * D * elem) % 16 == 0 && (last * D * elem) % 16 == 0;
  const Sweep a{other, other_scales, col_ids, ratings, mask, seg_start, R, B, K, D, C,
                weighted, bf16_compute, implicit, regs, alphas, gram, workspace, target,
                target_code, target_scales, row_ids, vec, p.cw, p.S, k1s_blocks(p.S, D),
                k1s_warp_floats(p.S, D, p.cw)};
  cudaError_t err;
  switch (other_code) {
    case F32: err = dispatch_sweep<float>(launch, a, p, s); break;
    case BF16: err = dispatch_sweep<__nv_bfloat16>(launch, a, p, s); break;
    default: err = dispatch_sweep<int8_t>(launch, a, p, s); break;
  }
  return (int)err;
}
