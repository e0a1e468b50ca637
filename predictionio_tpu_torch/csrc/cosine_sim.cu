// K6: item-item cosine top-n from sparse interactions, for Hopper (sm_90a).
//
// Replaces predictionio_tpu/ops/cosine_sim.py:73 _block_topn (driven by
// :111 item_similarity_topn), a jax.jit program that scatter-builds dense
// [chunk, I] tiles of the deduped (user, item, value) triples and
// accumulates G_b += tile_b^T @ tile over a lax.scan of user chunks (:91,
// on the MXU), then normalizes, masks and takes lax.top_k of every item
// block. It computes what that program computes, not its blocks:
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
// What bounds it on an H100: the function needs sum_u deg(u)^2
// multiply-adds (1.32e10 at the ML-20M views, 0.39 ms of FP32 operations)
// and reads the CSR/CSC arrays once. A sparse kernel really moves the
// users' rows once for each of their items (sum_u deg(u)^2 x 8 B, 105 GB
// there), so it is bound by the latency of those loads; and 76% of that
// sum comes from the 1,625 users of degree >= 1,024.
//
// Design: two stages, chosen by the data (the wrapper's cosine_layout):
//
// 1. The dense stage, gram_s8_kernel (only on the atomic route, every
//    value an integer in [-128, 127], and only when the host's cost model
//    finds heavy users -- deg(u) >= T -- worth a dense product). The heavy
//    users' values are an item-major s8 array A [I_pad, H_pad] (zeros
//    padded: I_pad to the tile DN, H_pad to DK); the stage writes
//    C[b, j] = sum_h A[rows[b], h] * A[j, h] for the rows of one row chunk
//    into the f32 scratch [R, I] (R rows of at most 1 GiB). Exact: every
//    int32 partial sum is below norm_i * norm_j < 2^24 (the route's
//    check), so its f32 conversion is exact. Tiles of 128 x 128 outputs,
//    8 warps of 64 x 32, K steps of 64 bytes: both operands by cp.async
//    into a ring of DSTAGES shared-memory stages (rows padded to DROW
//    bytes, so ldmatrix's 8 rows hit 8 distinct bank groups), then
//    ldmatrix.x4 and mma.sync.m16n8k32.row.col.s32.s8.s8.s32 (A's rows of
//    the chunk gathered through `rows`; B the whole catalog, the same
//    array: the TN layout mma.sync takes for both). Bound: 2 R I H_pad s8
//    operations at the int8 tensor peak.
//
// 2. The sparse stage, cosine_topn_kernel: one block per item row, the
//    row's G[i, :] an accumulator in dynamic shared memory (26,744 x
//    4 B = 107 KB at ML-20M; a catalog wider than PASS_COLS columns is done
//    in column passes, each re-reading the row's users and keeping only
//    its columns). G starts from the dense stage's scratch row (init) or
//    from zeros, then adds the row's users from the CSC the wrapper hands
//    it (the light users after a dense stage, every user otherwise). Rows
//    are launched heaviest first (the wrapper's order, by the row's
//    sparse multiply-adds). Two accumulation orders:
//    atomic (ATOMIC = true; 512 threads, two blocks an SM where G fits):
//      each warp stages a run of S <= 32 of the row's users -- id, weight,
//      CSR start and degree, one user a lane, loaded coalesced -- so no
//      user waits on the one before it; then walks them (shuffled out of
//      the lanes), its lanes on the user's items with UNROLL independent
//      entry loads in flight each, and adds v_ui * v_uj into G[j] with a
//      shared-memory integer atomicAdd (G held as int32: a native atomic,
//      where an f32 one is a compare-and-swap loop). Where I <= 65,535 and
//      the values fit 16 bits, an entry is one 4-byte word, item << 16 |
//      value (the wrapper's user_packed), half the bytes of an id and an
//      f32. Taken only when every value is an integer and every norm^2 is
//      below 2^24: every product and partial sum is an integer below 2^24,
//      exact in int32 and in its f32 conversion, so the result is
//      bit-equal to any exact summation (the JAX program's, the plain
//      version's) and the same on every run.
//    ordered (ATOMIC = false; 1,024 threads): any other values. The block
//      takes the row's users in ascending order, all threads on one user's
//      items (distinct columns, so no two threads add to one G[j]), a
//      barrier between users: each G[j] is summed in user order, the same
//      bits on every run (within 1e-5 of a dense matmul).
//    Then, in the select mode (top_n <= SELECT_MAX_N), each warp scores
//    its columns 32 E at a time (E = g / 32, g the power of two >= top_n,
//    at least 32), turns each score into the unique 64-bit composite
//    order_key(s) << 32 | ~j, and folds a chunk into its running top g in
//    registers (csrc/warp_select.cuh) only when some lane's composite
//    beats the list's last entry; the warps' lists fold pairwise through
//    shared memory and the block writes the first top_n. Composite 0 pads
//    (~j != 0 for j < 2^31): no column has it. In the scores mode (larger
//    top_n) the block writes the row's masked scores over its scratch row
//    instead, and the wrapper selects them with K2's select_kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int PASS_COLS = 57344;   // columns a pass keeps in shared memory (224 KB)
constexpr int SELECT_MAX_N = 128;  // the select mode's largest top_n: 4 composites a lane
constexpr int UNROLL = 4;          // entry loads a lane keeps in flight (atomic route)
constexpr unsigned FULL = 0xffffffffu;

// the dense stage's tiles
constexpr int DM = 128;       // output rows a block (row-chunk items)
constexpr int DN = 128;       // output columns a block (catalog items)
constexpr int DK = 64;        // heavy users (s8 bytes) a pipeline stage
constexpr int DROW = DK + 16;  // shared-memory row pitch, bytes
constexpr int DSTAGES = 3;    // cp.async ring depth
constexpr int DTHREADS = 256;  // 8 warps: 2 along M (64 rows) x 4 along N (32 columns)
constexpr int D_STAGE_BYTES = (DM + DN) * DROW;

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

__device__ __forceinline__ float masked_score(float g, int j, int row, float rn, float nj) {
  float s = __fdiv_rn(g, fmaxf(__fmul_rn(rn, nj), 1e-12f));
  if (j == row || !(nj > 0.0f) || !(rn > 0.0f)) s = -__int_as_float(0x7f800000);
  return s;
}

// -- the sparse stage ----------------------------------------------------------

template <bool ATOMIC>
struct Shape {
  static constexpr int THREADS = ATOMIC ? 512 : 1024;
  static constexpr int MIN_BLOCKS = ATOMIC ? 2 : 1;
  static constexpr int WARPS = THREADS / 32;
};

struct Args {
  const int* row_order;       // [rows] item rows of this launch, heaviest first
  const long long* item_ptr;  // [I + 1] CSC offsets (the users this stage adds)
  const int* item_users;      // [nnz'] users of each item, ascending
  const float* item_vals;     // [nnz']
  const long long* user_ptr;  // [U + 1] CSR offsets
  const int* user_items;      // [nnz] items of each user, ascending
  const float* user_vals;     // [nnz]
  const int* user_packed;     // [nnz] item << 16 | (value & 0xFFFF), or null (atomic route)
  const float* norms;         // [I] column norms
  int I, top_n, pass_cols;
  float* scratch;             // [rows, I]: the dense stage's G (init), the scores (scores mode)
  int init;                   // 1: G starts from scratch row b, else from zeros
  float* out_scores;          // [I, top_n] (select mode)
  int* out_ids;               // [I, top_n]
};

// G[x] as f32: the atomic route's integer sums are below 2^24, so exact
template <bool ATOMIC>
__device__ __forceinline__ float gram_at(const float* G, const int* Gi, int x) {
  return ATOMIC ? __int2float_rn(Gi[x]) : G[x];
}

// E: composites a lane keeps (select mode); E == 0: the scores mode.
template <int E, bool ATOMIC>
__global__ void __launch_bounds__(Shape<ATOMIC>::THREADS, Shape<ATOMIC>::MIN_BLOCKS)
cosine_topn_kernel(const Args a) {
  constexpr int THREADS = Shape<ATOMIC>::THREADS;
  constexpr int WARPS = Shape<ATOMIC>::WARPS;
  constexpr bool SCORES = E == 0;
  constexpr int EL = SCORES ? 1 : E;
  extern __shared__ __align__(16) unsigned char smem[];
  float* G = reinterpret_cast<float*>(smem);
  int* Gi = reinterpret_cast<int*>(smem);  // the atomic route's exact integer sums
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const int row = a.row_order[b];
  const float rn = a.norms[row];
  const long long p0 = a.item_ptr[row], p1 = a.item_ptr[row + 1];
  float* srow = a.scratch == nullptr ? nullptr : a.scratch + (size_t)b * a.I;
  // users a warp stages at a time: 32, fewer for a row too short to give
  // every warp a full run
  const int run = (int)min(32LL, max(1LL, (p1 - p0 + WARPS - 1) / WARPS));
  u64 best[EL];
#pragma unroll
  for (int e = 0; e < EL; ++e) best[e] = 0ull;
  for (int c0 = 0; c0 < a.I; c0 += a.pass_cols) {
    const int cw = min(a.pass_cols, a.I - c0);
    if (ATOMIC) {
      for (int x = t; x < cw; x += THREADS) Gi[x] = a.init ? __float2int_rn(srow[c0 + x]) : 0;
    } else {
      for (int x = t; x < cw; x += THREADS) G[x] = 0.0f;
    }
    __syncthreads();
    if (ATOMIC) {
      for (long long base = p0 + (long long)warp * run; base < p1;
           base += (long long)WARPS * run) {
        const int n = (int)min((long long)run, p1 - base);
        // stage: lane k holds user k of this run
        long long s_start = 0;
        int s_deg = 0, s_w = 0;
        if (lane < n) {
          const int u = a.item_users[base + lane];
          s_w = __float2int_rn(a.item_vals[base + lane]);
          s_start = a.user_ptr[u];
          s_deg = (int)(a.user_ptr[u + 1] - s_start);
        }
        for (int k = 0; k < n; ++k) {
          const long long q0 = __shfl_sync(FULL, s_start, k);
          const int d = __shfl_sync(FULL, s_deg, k);
          const int w = __shfl_sync(FULL, s_w, k);
          if (a.user_packed != nullptr) {
            const int* pk = a.user_packed + q0;
            for (int q = lane; q < d; q += 32 * UNROLL) {
              int e4[UNROLL];
#pragma unroll
              for (int e = 0; e < UNROLL; ++e) e4[e] = q + 32 * e < d ? pk[q + 32 * e] : -1;
#pragma unroll
              for (int e = 0; e < UNROLL; ++e) {  // -1: item 65,535, never < I here
                const unsigned x = ((unsigned)e4[e] >> 16) - (unsigned)c0;
                if (x < (unsigned)cw) atomicAdd(&Gi[x], w * (int)(short)(e4[e] & 0xFFFF));
              }
            }
          } else {
            for (int q = lane; q < d; q += 32 * UNROLL) {
              int jj[UNROLL];
              float vv[UNROLL];
#pragma unroll
              for (int e = 0; e < UNROLL; ++e) {
                const int qq = q + 32 * e;
                jj[e] = qq < d ? a.user_items[q0 + qq] : -1;
                vv[e] = qq < d ? a.user_vals[q0 + qq] : 0.0f;
              }
#pragma unroll
              for (int e = 0; e < UNROLL; ++e) {
                const unsigned x = (unsigned)(jj[e] - c0);  // -1 - c0 wraps past cw
                if (x < (unsigned)cw) atomicAdd(&Gi[x], w * __float2int_rn(vv[e]));
              }
            }
          }
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
    if (SCORES) {
      for (int x = t; x < cw; x += THREADS) {
        const int j = c0 + x;
        srow[j] = masked_score(gram_at<ATOMIC>(G, Gi, x), j, row, rn, a.norms[j]);
      }
    } else {
      // select: this warp's chunks of 32 E columns, folded when they beat
      // the running list's last entry
      for (int base = warp * 32 * EL; base < cw; base += WARPS * 32 * EL) {
        u64 c[EL];
        u64 top = 0ull;
#pragma unroll
        for (int e = 0; e < EL; ++e) {
          const int x = base + lane + 32 * e;
          u64 v = 0ull;
          if (x < cw) {
            const int j = c0 + x;
            v = composite(masked_score(gram_at<ATOMIC>(G, Gi, x), j, row, rn, a.norms[j]), j);
          }
          c[e] = v;
          top = max64(top, v);
        }
        const u64 last = __shfl_sync(FULL, best[EL - 1], 31);
        if (__any_sync(FULL, top > last)) {
          warp_sort<EL>(c, lane);
          warp_fold<EL>(best, c, lane);
        }
      }
    }
    __syncthreads();  // G is filled again by the next pass
  }
  if (SCORES) return;
  // fold the warps' lists pairwise through shared memory (G's space)
  u64* lists = reinterpret_cast<u64*>(smem);
#pragma unroll
  for (int e = 0; e < EL; ++e) lists[warp * 32 * EL + lane + 32 * e] = best[e];
  __syncthreads();
  for (int half = WARPS / 2; half > 0; half >>= 1) {
    if (warp < half) {
      u64 other[EL];
#pragma unroll
      for (int e = 0; e < EL; ++e) other[e] = lists[(warp + half) * 32 * EL + lane + 32 * e];
      warp_fold<EL>(best, other, lane);
#pragma unroll
      for (int e = 0; e < EL; ++e) lists[warp * 32 * EL + lane + 32 * e] = best[e];
    }
    __syncthreads();
  }
  for (int x = t; x < a.top_n; x += THREADS) {
    const u64 c = lists[x];
    a.out_ids[(size_t)row * a.top_n + x] = (int)(~(uint32_t)c);
    a.out_scores[(size_t)row * a.top_n + x] = composite_score(c);
  }
}

template <bool ATOMIC>
size_t smem_bytes(int pass_cols, int E) {
  const size_t g = (size_t)pass_cols * sizeof(float);
  const size_t lists = (size_t)Shape<ATOMIC>::WARPS * 32 * E * sizeof(u64);
  return g > lists ? g : lists;
}

template <int E, bool ATOMIC>
cudaError_t launch(const Args& a, int rows, cudaStream_t s) {
  const size_t bytes = smem_bytes<ATOMIC>(a.pass_cols, E);
  cudaError_t err = cudaFuncSetAttribute(cosine_topn_kernel<E, ATOMIC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  cosine_topn_kernel<E, ATOMIC><<<rows, Shape<ATOMIC>::THREADS, bytes, s>>>(a);
  return cudaGetLastError();
}

template <bool ATOMIC>
cudaError_t launch_e(const Args& a, int rows, cudaStream_t s) {
  if (a.top_n > SELECT_MAX_N) return launch<0, ATOMIC>(a, rows, s);
  if (a.top_n <= 32) return launch<1, ATOMIC>(a, rows, s);
  if (a.top_n <= 64) return launch<2, ATOMIC>(a, rows, s);
  return launch<4, ATOMIC>(a, rows, s);
}

// -- the dense stage -----------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(src);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C[b, j] = sum_h A[rows[b], h] * A[j, h] for b < n_rows, j < I, as f32.
// A: [I_pad, H_pad] s8, I_pad a multiple of DN, H_pad of DK. Grid: (I_pad /
// DN, ceil(n_rows / DM)).
__global__ void __launch_bounds__(DTHREADS, 2)
gram_s8_kernel(const int8_t* __restrict__ A, int H_pad, const int* __restrict__ rows,
               int n_rows, int I, float* __restrict__ C) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * DM, n0 = blockIdx.x * DN;
  const char* base = reinterpret_cast<const char*>(A);
  // this thread's copies: 16-byte chunks t and t + DTHREADS of each tile
  // (DK / 16 = 4 chunks a row); A's rows gathered through `rows`, zero
  // filled past n_rows
  const char* asrc[2];
  const char* bsrc[2];
  int abytes[2], soff[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = t + DTHREADS * i, r = c >> 2, k16 = (c & 3) * 16;
    const int m = m0 + r;
    const bool ok = m < n_rows;
    asrc[i] = base + (ok ? (size_t)rows[m] * H_pad : (size_t)0) + k16;
    abytes[i] = ok ? 16 : 0;
    bsrc[i] = base + (size_t)(n0 + r) * H_pad + k16;
    soff[i] = r * DROW + k16;
  }
  const int KT = H_pad / DK;
  auto load = [&](int slot, int kt) {
    unsigned char* As = dsmem + slot * D_STAGE_BYTES;
    unsigned char* Bs = As + DM * DROW;
    const size_t k0 = (size_t)kt * DK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cp_async16(As + soff[i], asrc[i] + k0, abytes[i]);
      cp_async16(Bs + soff[i], bsrc[i] + k0, 16);
    }
  };
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
#pragma unroll
  for (int s = 0; s < DSTAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<DSTAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and slot kt - 1 is free
    const int nk = kt + DSTAGES - 1;
    if (nk < KT) load(nk % DSTAGES, nk);
    cp_async_commit();
    const unsigned char* As = dsmem + (kt % DSTAGES) * D_STAGE_BYTES;
    const unsigned char* Bs = As + DM * DROW;
#pragma unroll
    for (int kk = 0; kk < DK / 32; ++kk) {
      unsigned af[4][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)  // a0..a3: rows +0/+8, bytes +0/+16
        ldmatrix_x4(af[i], As + (wm * 64 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DROW +
                               kk * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)  // b0, b1 of n-tile 2 jp, then of 2 jp + 1
        ldmatrix_x4(bf[jp], Bs + (wn * 32 + jp * 16 + (lane & 7) + (lane >> 4) * 8) * DROW +
                                kk * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], af[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + g + 8 * h;
      if (m >= n_rows) continue;
      float* crow = C + (size_t)m * I;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + j * 8 + tig * 2 + e;
          if (n < I) crow[n] = __int2float_rn(acc[i][j][2 * h + e]);
        }
    }
}

}  // namespace

extern "C" {

// Constants the wrapper repeats (ops/cosine_sim.py; tests hold them equal).
int pio_k6_pass_cols() { return PASS_COLS; }
int pio_k6_select_max_n() { return SELECT_MAX_N; }

// The sparse stage: one launch over `rows` item rows (row_order[0..rows)).
// top_n <= SELECT_MAX_N: writes their [top_n] scores and ids into
// out_scores / out_ids ([I, top_n]); larger top_n (up to I): writes row b's
// masked scores over scratch[b, :] (the scores mode; out_* unused). init:
// G starts from scratch[b, :] (the dense stage's). atomic: 1 for the
// integer route (see the note at the top), 0 for the ordered one.
// user_packed: the CSR entries as item << 16 | (value & 0xFFFF) (I <=
// 65,535, 16-bit integer values), read instead of user_items/user_vals on
// the atomic route; may be null.
// pass_cols in [1, PASS_COLS]. Adds 1 to *launched when the launch went
// out; returns the launch error.
int pio_k6_cosine_topn(const int* row_order, int rows, const long long* item_ptr,
                       const int* item_users, const float* item_vals,
                       const long long* user_ptr, const int* user_items,
                       const float* user_vals, const int* user_packed, const float* norms,
                       int I, int top_n,
                       int pass_cols, int atomic, float* scratch, int init,
                       float* out_scores, int* out_ids, int* launched, void* stream) {
  const bool scores = top_n > SELECT_MAX_N;
  if (rows <= 0 || I <= 0 || top_n < 1 || top_n > I || pass_cols < 1 ||
      pass_cols > PASS_COLS || launched == nullptr || ((scores || init) && scratch == nullptr) ||
      (!scores && (out_scores == nullptr || out_ids == nullptr)) ||
      (user_packed != nullptr && I > 65535))
    return (int)cudaErrorInvalidValue;
  const Args a{row_order, item_ptr, item_users, item_vals, user_ptr, user_items,
               user_vals, atomic ? user_packed : nullptr, norms, I, top_n, pass_cols,
               scratch, init ? 1 : 0, out_scores, out_ids};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = atomic ? launch_e<true>(a, rows, s) : launch_e<false>(a, rows, s);
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}

// The dense stage: C[b, j] = sum_h A[rows[b], h] * A[j, h] as f32 for b <
// n_rows, j < I. A: [I_pad, H_pad] s8 (I_pad >= I a multiple of DN, H_pad a
// multiple of DK, zeros padded); rows: [n_rows] item ids < I; C: [n_rows,
// I]. Adds 1 to *launched when the launch went out.
int pio_k6_gram_s8(const int8_t* A, int I_pad, int H_pad, const int* rows, int n_rows, int I,
                   float* C, int* launched, void* stream) {
  if (A == nullptr || rows == nullptr || C == nullptr || launched == nullptr || n_rows <= 0 ||
      I <= 0 || I_pad < I || I_pad % DN != 0 || H_pad <= 0 || H_pad % DK != 0 ||
      (n_rows + DM - 1) / DM > 65535)
    return (int)cudaErrorInvalidValue;
  const int bytes = DSTAGES * D_STAGE_BYTES;
  cudaError_t err = cudaFuncSetAttribute(gram_s8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(I_pad / DN, (n_rows + DM - 1) / DM);
  gram_s8_kernel<<<grid, DTHREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      A, H_pad, rows, n_rows, I, C);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}

}  // extern "C"
