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
// int8) against 3.35 TB/s, plus 2*B*I*D FP32 operations. The whole catalog
// fits in the 50 MB L2, so a served query (B = 1) is bound by launch
// latency, not by bytes. The summed-rows mode reads its B x L query rows
// from the same catalog and adds 2 * B * L * D operations: the same bound.
//
// Design (the simple, correct first version):
//   launch 1, score_kernel: one block per (128-item tile, 8-query tile).
//     The block stages its query rows and a slice of its item rows in
//     shared memory, 32 factor dims at a time, and each thread carries
//     its item's 8 accumulators through d = 0..D-1 in a fixed order, so a
//     row's score bits do not depend on the batch size B -- and equal the
//     plain version's, which sums in the same order. Scores go to a
//     [B, I] f32 scratch the wrapper allocates.
//   launch 2, select_kernel: one 1024-thread block per query row. A
//     4-pass 8-bit radix select over the ordered key finds the k-th key;
//     an ordered compaction (ballot scans, in index order) keeps every
//     key above it and the lowest-index keys equal to it, so exactly k
//     winners survive; winners are sorted on the 64-bit composite
//     (key << 32 | ~index) -- bitonic in shared memory up to 2048, past
//     that each winner's rank is counted against all the others.
//   Summed-rows mode adds launch 0, sum_rows_kernel: one block per query
//   row, one thread per factor dim, writing the [B, D] f32 query rows to
//   a scratch that launch 1 reads as its U (identity row indices).
//   Keeping [B, I] out of device memory (per-tile candidate merge) is
//   later work.

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
constexpr float NEG_INF = -1e30f; // ops/topk.py NEG_INF

enum DType { F32 = 0, BF16 = 1, I8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename TU, typename TV>
__global__ void __launch_bounds__(TILE_I)
score_kernel(const int* __restrict__ user_ixs, int B,
             const TU* __restrict__ U, const float* __restrict__ u_scales,
             const TV* __restrict__ V, const float* __restrict__ v_scales,
             const uint8_t* __restrict__ mask, int I, int D,
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
#pragma unroll
  for (int bb = 0; bb < TILE_B; ++bb) {
    if (bb < nb) {
      const float s = v_scales != nullptr ? acc[bb] * vs : acc[bb];
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

template <typename TU>
cudaError_t launch_score_u(int v_dtype, dim3 grid, cudaStream_t stream,
                           const int* ixs, int B, const void* U,
                           const float* us, const void* V, const float* vs,
                           const uint8_t* mask, int I, int D, float* scores) {
  const TU* u = static_cast<const TU*>(U);
  switch (v_dtype) {
    case F32:
      score_kernel<TU, float><<<grid, TILE_I, 0, stream>>>(
          ixs, B, u, us, static_cast<const float*>(V), vs, mask, I, D, scores);
      return cudaSuccess;
    case BF16:
      score_kernel<TU, __nv_bfloat16><<<grid, TILE_I, 0, stream>>>(
          ixs, B, u, us, static_cast<const __nv_bfloat16*>(V), vs, mask, I, D,
          scores);
      return cudaSuccess;
    case I8:
      score_kernel<TU, int8_t><<<grid, TILE_I, 0, stream>>>(
          ixs, B, u, us, static_cast<const int8_t*>(V), vs, mask, I, D, scores);
      return cudaSuccess;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Top-k of each row of a [B, I] f32 score matrix (launch 2 alone).
// cand: [B, k] u64 scratch. Returns cudaGetLastError().
int pio_k2_select(const float* scores, int B, int I, int k, void* cand,
                  float* out_scores, int* out_ids, void* stream) {
  if (B <= 0 || I <= 0 || k <= 0 || k > I) return (int)cudaErrorInvalidValue;
  select_kernel<<<B, SEL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      scores, I, k, static_cast<unsigned long long*>(cand), out_scores,
      out_ids);
  return (int)cudaGetLastError();
}

// The summed-rows K2 call: sum_rows_kernel into `qvec` ([B, D] f32
// scratch), score_kernel against V into `scores` ([B, I] f32 scratch),
// then select_kernel. row_ixs, row_w: [B, L]. v_scales / mask may be
// null. Returns cudaGetLastError().
int pio_k2_sum_rows_top_k(const int* row_ixs, const float* row_w, int B, int L,
                          const void* V, int v_dtype, const float* v_scales,
                          const uint8_t* mask, int I, int D, int k, float* qvec,
                          float* scores, void* cand, float* out_scores,
                          int* out_ids, void* stream) {
  if (B <= 0 || L < 0 || I <= 0 || D <= 0 || k <= 0 || k > I)
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
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((I + TILE_I - 1) / TILE_I, (B + TILE_B - 1) / TILE_B);
  err = launch_score_u<float>(v_dtype, grid, s, nullptr, B, qvec, nullptr, V,
                              v_scales, mask, I, D, scores);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return pio_k2_select(scores, B, I, k, cand, out_scores, out_ids, stream);
}

// The fused K2 call: score_kernel into `scores` ([B, I] f32 scratch), then
// select_kernel. u_scales / v_scales / mask may be null. dtype codes:
// 0 f32, 1 bf16, 2 int8. Returns cudaGetLastError().
int pio_k2_gather_top_k(const int* user_ixs, int B, const void* U, int u_dtype,
                        const float* u_scales, const void* V, int v_dtype,
                        const float* v_scales, const uint8_t* mask, int I,
                        int D, int k, float* scores, void* cand,
                        float* out_scores, int* out_ids, void* stream) {
  if (B <= 0 || I <= 0 || D <= 0 || k <= 0 || k > I)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((I + TILE_I - 1) / TILE_I, (B + TILE_B - 1) / TILE_B);
  cudaError_t err;
  switch (u_dtype) {
    case F32:
      err = launch_score_u<float>(v_dtype, grid, s, user_ixs, B, U, u_scales,
                                  V, v_scales, mask, I, D, scores);
      break;
    case BF16:
      err = launch_score_u<__nv_bfloat16>(v_dtype, grid, s, user_ixs, B, U,
                                          u_scales, V, v_scales, mask, I, D,
                                          scores);
      break;
    case I8:
      err = launch_score_u<int8_t>(v_dtype, grid, s, user_ixs, B, U, u_scales,
                                   V, v_scales, mask, I, D, scores);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return pio_k2_select(scores, B, I, k, cand, out_scores, out_ids, stream);
}

}  // extern "C"
