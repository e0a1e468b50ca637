// K6: item-item cosine top-n from sparse interactions, for Hopper (sm_90a).
//
// Replaces predictionio_tpu/ops/cosine_sim.py:73 _block_topn (driven by
// :111 item_similarity_topn), a jax.jit program that scatter-builds dense
// [chunk, I] tiles of the deduped (user, item, value) triples and
// accumulates G_b += tile_b^T @ tile over a lax.scan of user chunks, then
// normalizes, masks and takes lax.top_k of every item block. It computes
// what that program computes, not its blocks:
//
//   G[i, j]  = sum_u v_ui * v_uj                 (over the users of i)
//   sim[i, j] = G[i, j] / max(norm_i * norm_j, 1e-12)
//               (norms: the wrapper's [I] f32 column norms, host numpy as
//               in the JAX package; one rounded product, fmaxf and one
//               IEEE division, __fdiv_rn, never a reciprocal multiply)
//   sim[i, j] = -inf where j == i, norm_j == 0 or norm_i == 0
//   out_i     = the top_n largest sim[i, :] by the order-preserving int
//               key, lower index first on equal keys: lax.top_k's order,
//               so an all -inf row (an item with no interactions) gives
//               ids 0, 1, 2, ... with the self id among them.
//
// What bounds it on an H100: the dense program does 2 U I^2 FLOP (1.98e14
// at the ML-20M shape, ~3 s at the FP32 peak); the function needs only
// sum_u deg(u)^2 multiply-adds (1.32e10 there, 0.39 ms of FP32 operations)
// and reads the CSR/CSC arrays once: the bound is the larger of the two.
// What it really moves is the users' rows, re-read once for each of their
// items (sum_u deg(u)^2 x 8 B from L2 and HBM).
//
// Design: the host builds CSR (by user) and CSC (by item) of the deduped
// triples. One 1024-thread block per item row i, rows scheduled heaviest
// first (the wrapper's row_order, by sum of the row's users' degrees), so
// the long rows start at once and the light ones fill the tail. The row
// G[i, :] is an f32 accumulator in dynamic shared memory (26,744 x 4 B =
// 107 KB at ML-20M); a catalog wider than PASS_COLS columns is done in
// column passes, each re-reading the row's users and keeping only its
// columns. Two accumulation orders:
//   atomic (ATOMIC = true): warp w takes the row's users w, w + 32, ...,
//     its lanes the user's items, and adds v_ui * v_uj to G[j] with a
//     shared-memory atomicAdd. The wrapper takes it only when every value
//     is an integer and every norm^2 is below 2^24: then every product and
//     partial sum is an integer below 2^24, exact in f32 in any order, so
//     the result is bit-equal to any exact summation (the JAX program's,
//     the plain version's) and the same on every run.
//   ordered (ATOMIC = false): any other values. The block takes the row's
//     users in ascending order, all threads on one user's items (distinct
//     columns, so no two threads add to one G[j]), a barrier between
//     users: each G[j] is summed in user order, the same bits on every
//     run (another order than a dense matmul's: within 1e-5 of it).
// Then each warp scores its columns 32 E at a time (E = g / 32, g the
// power of two >= top_n, at least 32), turns each score into the unique
// 64-bit composite order_key(s) << 32 | ~j, and folds a chunk into its
// running top g in registers (csrc/warp_select.cuh: a bitonic sort of the
// chunk, then warp_fold) only when some lane's composite beats the list's
// last entry. The running lists live across column passes; at the end
// the 32 warps' lists fold pairwise through shared memory (reusing G's
// space), 16, 8, ..., 1, and the block writes the first top_n. Composite
// 0 pads (~j != 0 for j < 2^31): no column has it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int PASS_COLS = 57344;  // columns a pass keeps in shared memory (224 KB)
constexpr int MAX_TOP_N = 128;    // the largest top_n: 4 composites a lane
constexpr unsigned FULL = 0xffffffffu;

#include "warp_select.cuh"

__device__ __forceinline__ uint32_t order_key(float x) {
  const int b = __float_as_int(x);
  const int key = b < 0 ? (b ^ 0x7FFFFFFF) : b;
  return (uint32_t)key ^ 0x80000000u;
}

__device__ __forceinline__ u64 composite(float s, int j) {
  return ((u64)order_key(s) << 32) | (u64)(~(uint32_t)j);
}

__device__ __forceinline__ float composite_score(u64 c) {
  const int key = (int)((uint32_t)(c >> 32) ^ 0x80000000u);
  return __int_as_float(key < 0 ? (key ^ 0x7FFFFFFF) : key);
}

struct Args {
  const int* row_order;    // [R] item rows, heaviest first
  const long long* item_ptr;  // [I + 1] CSC offsets
  const int* item_users;   // [nnz] users of each item, ascending
  const float* item_vals;  // [nnz]
  const long long* user_ptr;  // [U + 1] CSR offsets
  const int* user_items;   // [nnz] items of each user, ascending
  const float* user_vals;  // [nnz]
  const float* norms;      // [I] column norms
  int I, top_n, pass_cols;
  float* out_scores;       // [I, top_n]
  int* out_ids;            // [I, top_n]
};

template <int E, bool ATOMIC>
__global__ void __launch_bounds__(THREADS, 1) cosine_topn_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* G = reinterpret_cast<float*>(smem);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int row = a.row_order[blockIdx.x];
  const float rn = a.norms[row];
  const long long p0 = a.item_ptr[row], p1 = a.item_ptr[row + 1];
  u64 best[E];
#pragma unroll
  for (int e = 0; e < E; ++e) best[e] = 0ull;
  for (int c0 = 0; c0 < a.I; c0 += a.pass_cols) {
    const int cw = min(a.pass_cols, a.I - c0);
    for (int x = t; x < cw; x += THREADS) G[x] = 0.0f;
    __syncthreads();
    if (ATOMIC) {
      for (long long p = p0 + warp; p < p1; p += WARPS) {
        const int u = a.item_users[p];
        const float w = a.item_vals[p];
        const long long q1 = a.user_ptr[u + 1];
        for (long long q = a.user_ptr[u] + lane; q < q1; q += 32) {
          const unsigned x = (unsigned)(a.user_items[q] - c0);
          if (x < (unsigned)cw) atomicAdd(&G[x], __fmul_rn(w, a.user_vals[q]));
        }
      }
    } else {
      for (long long p = p0; p < p1; ++p) {
        const int u = a.item_users[p];
        const float w = a.item_vals[p];
        const long long q1 = a.user_ptr[u + 1];
        for (long long q = a.user_ptr[u] + t; q < q1; q += THREADS) {
          const unsigned x = (unsigned)(a.user_items[q] - c0);
          if (x < (unsigned)cw) G[x] = __fadd_rn(G[x], __fmul_rn(w, a.user_vals[q]));
        }
        __syncthreads();  // the next user adds to these columns in order
      }
    }
    __syncthreads();
    // select: this warp's chunks of 32 E columns, folded when they beat
    // the running list's last entry
    for (int base = warp * 32 * E; base < cw; base += WARPS * 32 * E) {
      u64 c[E];
      u64 top = 0ull;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int x = base + lane + 32 * e;
        u64 v = 0ull;
        if (x < cw) {
          const int j = c0 + x;
          const float nj = a.norms[j];
          float s = __fdiv_rn(G[x], fmaxf(__fmul_rn(rn, nj), 1e-12f));
          if (j == row || !(nj > 0.0f) || !(rn > 0.0f)) s = -__int_as_float(0x7f800000);
          v = composite(s, j);
        }
        c[e] = v;
        top = max64(top, v);
      }
      const u64 last = __shfl_sync(FULL, best[E - 1], 31);
      if (__any_sync(FULL, top > last)) {
        warp_sort<E>(c, lane);
        warp_fold<E>(best, c, lane);
      }
    }
    __syncthreads();  // G is zeroed again by the next pass
  }
  // fold the warps' lists pairwise through shared memory (G's space)
  u64* lists = reinterpret_cast<u64*>(smem);
#pragma unroll
  for (int e = 0; e < E; ++e) lists[warp * 32 * E + lane + 32 * e] = best[e];
  __syncthreads();
  for (int half = WARPS / 2; half > 0; half >>= 1) {
    if (warp < half) {
      u64 other[E];
#pragma unroll
      for (int e = 0; e < E; ++e) other[e] = lists[(warp + half) * 32 * E + lane + 32 * e];
      warp_fold<E>(best, other, lane);
#pragma unroll
      for (int e = 0; e < E; ++e) lists[warp * 32 * E + lane + 32 * e] = best[e];
    }
    __syncthreads();
  }
  for (int x = t; x < a.top_n; x += THREADS) {
    const u64 c = lists[x];
    a.out_ids[(size_t)row * a.top_n + x] = (int)(~(uint32_t)c);
    a.out_scores[(size_t)row * a.top_n + x] = composite_score(c);
  }
}

size_t smem_bytes(int pass_cols, int E) {
  const size_t g = (size_t)pass_cols * sizeof(float);
  const size_t lists = (size_t)WARPS * 32 * E * sizeof(u64);
  return g > lists ? g : lists;
}

template <int E, bool ATOMIC>
cudaError_t launch(const Args& a, int rows, cudaStream_t s) {
  const size_t bytes = smem_bytes(a.pass_cols, E);
  cudaError_t err = cudaFuncSetAttribute(cosine_topn_kernel<E, ATOMIC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  cosine_topn_kernel<E, ATOMIC><<<rows, THREADS, bytes, s>>>(a);
  return cudaGetLastError();
}

template <bool ATOMIC>
cudaError_t launch_e(const Args& a, int rows, cudaStream_t s) {
  if (a.top_n <= 32) return launch<1, ATOMIC>(a, rows, s);
  if (a.top_n <= 64) return launch<2, ATOMIC>(a, rows, s);
  return launch<4, ATOMIC>(a, rows, s);
}

}  // namespace

extern "C" {

// Constants the wrapper repeats (ops/cosine_sim.py; tests hold them equal).
int pio_k6_pass_cols() { return PASS_COLS; }
int pio_k6_max_top_n() { return MAX_TOP_N; }

// One launch over `rows` item rows (row_order[0..rows)), writing their
// [top_n] scores and ids into out_scores / out_ids ([I, top_n]). atomic:
// 1 for the integer route (see the note at the top), 0 for the ordered
// one. pass_cols in [1, PASS_COLS]; top_n in [1, min(MAX_TOP_N, I)].
// Adds 1 to *launched when the launch went out; returns the launch error.
int pio_k6_cosine_topn(const int* row_order, int rows, const long long* item_ptr,
                       const int* item_users, const float* item_vals,
                       const long long* user_ptr, const int* user_items,
                       const float* user_vals, const float* norms, int I, int top_n,
                       int pass_cols, int atomic, float* out_scores, int* out_ids,
                       int* launched, void* stream) {
  if (rows <= 0 || I <= 0 || top_n < 1 || top_n > MAX_TOP_N || top_n > I ||
      pass_cols < 1 || pass_cols > PASS_COLS || launched == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{row_order, item_ptr, item_users, item_vals, user_ptr, user_items,
               user_vals, norms, I, top_n, pass_cols, out_scores, out_ids};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = atomic ? launch_e<true>(a, rows, s) : launch_e<false>(a, rows, s);
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}

}  // extern "C"
