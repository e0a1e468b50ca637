// K3: the ranking-metrics kernel of the evaluation fast path, for Hopper
// (sm_90a).
//
// Replaces predictionio_tpu/ops/topk.py:179 ranking_metrics_batch (the
// XLA program vmap(searchsorted) -> hit prefix sums -> P@K, AP@K,
// NDCG@K), which core/fast_eval.py eval_device runs once per candidate,
// eval split and cutoff over the candidate's padded top-k id matrix.
//
// What it computes, for query row q (pred [Q, P] int32, -1 an empty
// slot; actual [Q, A] int32 sorted ascending, padded with int32 max,
// codes <= -2 for relevant ids outside the id space; counts [Q] int32):
//   hit_p   = pos < count && actual[pos] == pred_p && pred_p >= 0, where
//             pos is the first index of the row with actual[pos] >=
//             pred_p (searchsorted, side left)
//   precision = (sum_p hit_p) / k
//   ap        = (sum_p hit_p ? cum_p / (p + 1) : 0) / max(min(k, count), 1),
//               cum_p the hits at ranks 0..p
//   ndcg      = (sum_p hit_p * disc[p]) / idcg[clamp(min(count, k), 1, k) - 1]
//   valid     = count > 0
// with disc[p] = 1 / log2(p + 2) and idcg the running sum of
// 1 / log2(r + 1), r = 1..k, both computed by the wrapper in torch
// float32 (ops/topk.py _ranking_tables), so the divisors are the plain
// version's bits. Every division is a true division (__fdiv_rn): the hit
// count and the precision are exact and equal the plain version's; the
// AP and DCG sums are warp reductions, another order than the plain
// version's row sums (within 1e-6).
//
// Design: one warp a query row, 8 rows a 256-thread block. Lane l takes
// rank position p = l, l + 32, ... and binary-searches the row's actual
// ids for its predicted id; the hits' prefix count is an inclusive warp
// scan (__shfl_up_sync) plus the count carried from the earlier 32
// positions; the AP and DCG terms and the hit count are summed by
// __shfl_xor_sync reductions, and lane 0 writes the row's four outputs.
//
// What bounds it on an H100: bytes. Each row reads P + A + 1 int32 and
// writes 13 bytes, Q (P + A + 1) 4 + 13 Q in all: at an ML-1M fold (Q =
// 333,334, P = A = 1) 8.3 MB, 2.5 us at 3.35 TB/s. The binary search is
// log2(A) dependent loads a position, and a launch costs a few
// microseconds, so at the evaluation's sizes the launch is the floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // query rows a block
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
ranking_kernel(const int* __restrict__ pred, int Q, int P, const int* __restrict__ actual,
               int A, const int* __restrict__ counts, int k,
               const float* __restrict__ disc, const float* __restrict__ idcg,
               float* __restrict__ precision, float* __restrict__ ap,
               float* __restrict__ ndcg, uint8_t* __restrict__ valid) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (q >= Q) return;  // warp-uniform
  const int* a = actual + (size_t)q * A;
  const int* pr = pred + (size_t)q * P;
  const int count = counts[q];
  int carry = 0;  // hits at the positions before this group of 32
  float ap_sum = 0.0f, dcg = 0.0f;
  for (int p0 = 0; p0 < P; p0 += 32) {
    const int p = p0 + lane;
    int hit = 0;
    if (p < P) {
      const int id = pr[p];
      int lo = 0, hi = A;  // the first index with a[lo] >= id
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a[mid] < id)
          lo = mid + 1;
        else
          hi = mid;
      }
      hit = lo < count && lo < A && a[lo] == id && id >= 0;
    }
    int cum = hit;  // inclusive scan of the hits over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(FULL, cum, off);
      if (lane >= off) cum += n;
    }
    if (hit) {
      ap_sum += __fdiv_rn((float)(carry + cum), (float)(p + 1));
      dcg += disc[p];
    }
    carry += __shfl_sync(FULL, cum, 31);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ap_sum += __shfl_xor_sync(FULL, ap_sum, off);
    dcg += __shfl_xor_sync(FULL, dcg, off);
  }
  if (lane != 0) return;
  const float kf = (float)k;
  precision[q] = __fdiv_rn((float)carry, kf);
  ap[q] = __fdiv_rn(ap_sum, fmaxf(fminf(kf, (float)count), 1.0f));
  const int ideal = count < k ? (count < 1 ? 1 : count) : k;
  ndcg[q] = __fdiv_rn(dcg, idcg[ideal - 1]);
  valid[q] = count > 0;
}

}  // namespace

// K3 over Q query rows: pred [Q, P], actual [Q, A], counts [Q] int32;
// disc [P] (may be NULL when P == 0) and idcg [k] f32; outputs precision,
// ap, ndcg [Q] f32 and valid [Q] bool (one byte). Device pointers; the
// launch goes on `stream` and is not synchronised. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// refused argument.
extern "C" int pio_k3_ranking_metrics(const int* pred, int Q, int P, const int* actual,
                                      int A, const int* counts, int k, const float* disc,
                                      const float* idcg, float* precision, float* ap,
                                      float* ndcg, uint8_t* valid, void* stream) {
  if (Q < 0 || P < 0 || A < 1 || k < 1 || (P > 0 && disc == nullptr))
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  const int blocks = (Q + WARPS - 1) / WARPS;
  ranking_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      pred, Q, P, actual, A, counts, k, disc, idcg, precision, ap, ndcg, valid);
  return (int)cudaGetLastError();
}
