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
// AP and DCG sums are group reductions, another order than the plain
// version's row sums (within 1e-6).
//
// Design: lanes sized to the cutoff. A query row takes g =
// k3_group(P) lanes, the fewest (a power of two) that leave a lane at
// most K3_POSITIONS rank positions, and a warp serves 32 / g rows: at the
// evaluation's P <= 16 one thread a row, so an ML-1M fold's 333,334 rows
// are 10,417 warps, about one wave of the card, where one warp a row
// made ~40 waves of a dependent chain each. (g = next_pow2(P) lanes, one
// position a lane, measured slower than one thread a row at P = 10 on an
// H100: the waves, not the positions, set the time.) Lane j of a
// group takes rank positions p = j, j + g, ... and binary-searches the
// row's actual ids for its predicted id; the hits' prefix count is an
// inclusive scan within the group (__shfl_up_sync of width g) plus the
// count carried from the earlier g positions; the AP and DCG terms are
// summed by __shfl_xor_sync of width g, and the group's first lane writes
// the row's four outputs. The rows of a warp are neighbours, so pred,
// counts and the outputs are read and written coalesced across them.
// At g = 32 this is the earlier one-warp-a-row design operation for
// operation; chip_smoke.py times that design through group = 32 as the
// same-run baseline.
//
// What bounds it on an H100: bytes. Each row reads P + A + 1 int32 and
// writes 13 bytes, Q (P + A + 1) 4 + 13 Q in all: at an ML-1M fold (Q =
// 333,334, P = A = 1) 8.3 MB, 2.5 us at 3.35 TB/s. The binary search is
// log2(A) dependent loads a position, and a launch costs a few
// microseconds, so at the evaluation's sizes the launch is the floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int K3_MAX_GROUP = 32;  // lanes a query row takes at most (ops/topk.py K3_MAX_GROUP)
constexpr int K3_POSITIONS = 16;  // rank positions a lane takes at most, below K3_MAX_GROUP

// Lanes a query row of P rank positions takes (ops/topk.py k3_group):
// the fewest, a power of two, that leave a lane at most K3_POSITIONS
// positions, at most K3_MAX_GROUP.
int k3_group(int P) {
  return P <= 16 ? 1 : P <= 32 ? 2 : P <= 64 ? 4 : P <= 128 ? 8 : P <= 256 ? 16 : 32;
}

template <int G>
__global__ void __launch_bounds__(THREADS)
ranking_kernel(const int* __restrict__ pred, int Q, int P, const int* __restrict__ actual,
               int A, const int* __restrict__ counts, int k,
               const float* __restrict__ disc, const float* __restrict__ idcg,
               float* __restrict__ precision, float* __restrict__ ap,
               float* __restrict__ ndcg, uint8_t* __restrict__ valid) {
  const int j = threadIdx.x & (G - 1);  // lane within the row's group
  const long long row = (long long)blockIdx.x * (THREADS / G) + threadIdx.x / G;
  // a group past the last row still runs the shuffles, with no positions
  const bool live = row < Q;
  const int q = live ? (int)row : 0;
  const int* a = actual + (size_t)q * A;
  const int* pr = pred + (size_t)q * P;
  const int count = live ? counts[q] : 0;
  int carry = 0;  // hits at the positions before this group of G
  float ap_sum = 0.0f, dcg = 0.0f;
  for (int p0 = 0; p0 < P; p0 += G) {
    const int p = p0 + j;
    int hit = 0;
    if (live && p < P) {
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
    int cum = hit;  // inclusive scan of the hits over the group's lanes
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      const int n = __shfl_up_sync(FULL, cum, off, G);
      if (j >= off) cum += n;
    }
    if (hit) {
      ap_sum += __fdiv_rn((float)(carry + cum), (float)(p + 1));
      dcg += disc[p];
    }
    carry += __shfl_sync(FULL, cum, G - 1, G);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    ap_sum += __shfl_xor_sync(FULL, ap_sum, off, G);
    dcg += __shfl_xor_sync(FULL, dcg, off, G);
  }
  if (!live || j != 0) return;
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
// ap, ndcg [Q] f32 and valid [Q] bool (one byte). group: lanes a row
// takes, 0 for k3_group(P) (the port's call), or a power of two 1..32
// (32: the one-warp design, chip_smoke.py's baseline). Device pointers;
// the launch goes on `stream` and is not synchronised. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// refused argument.
extern "C" int pio_k3_ranking_metrics(const int* pred, int Q, int P, const int* actual,
                                      int A, const int* counts, int k, const float* disc,
                                      const float* idcg, float* precision, float* ap,
                                      float* ndcg, uint8_t* valid, int group, void* stream) {
  if (Q < 0 || P < 0 || A < 1 || k < 1 || (P > 0 && disc == nullptr))
    return (int)cudaErrorInvalidValue;
  if (group == 0) group = k3_group(P);
  if (group < 1 || group > K3_MAX_GROUP || (group & (group - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  const long long rows = THREADS / group;
  const int blocks = (int)((Q + rows - 1) / rows);
  cudaStream_t s = (cudaStream_t)stream;
#define PIO_K3_LAUNCH(G)                                                                \
  ranking_kernel<G><<<blocks, THREADS, 0, s>>>(pred, Q, P, actual, A, counts, k, disc, \
                                               idcg, precision, ap, ndcg, valid)
  switch (group) {
    case 1: PIO_K3_LAUNCH(1); break;
    case 2: PIO_K3_LAUNCH(2); break;
    case 4: PIO_K3_LAUNCH(4); break;
    case 8: PIO_K3_LAUNCH(8); break;
    case 16: PIO_K3_LAUNCH(16); break;
    default: PIO_K3_LAUNCH(32); break;
  }
#undef PIO_K3_LAUNCH
  return (int)cudaGetLastError();
}
