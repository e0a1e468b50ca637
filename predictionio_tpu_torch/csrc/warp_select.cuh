// Warp-wide bitonic networks over 64-bit composites held in registers,
// shared by csrc/topk.cu (K2's tile route) and csrc/retrieval.cu (K4's
// warp route). Included inside each source's anonymous namespace, after
// its `typedef unsigned long long u64;`: every function is a forceinline
// device function, so each source gets its own copy.

__device__ __forceinline__ u64 max64(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ u64 min64(u64 a, u64 b) { return a > b ? b : a; }

// Warp-wide bitonic networks over 32 * E composites held in registers:
// entry x = lane + 32 * e lives in v[e] of lane `lane`. An exchange of x
// with x ^ stride is a shuffle for stride < 32 and a swap of two of the
// lane's own registers above: no shared memory and no block barrier.
// One stage: the lower index of each pair ends with the larger entry
// where x's `size` bit is clear (a descending run), the smaller where it
// is set. (e, f) loops are unrolled, so registers are never indexed at
// run time.
template <int E>
__device__ __forceinline__ void warp_stage(u64 (&v)[E], int lane, int size, int stride) {
  if (stride >= 32) {
    const int s = stride >> 5;
#pragma unroll
    for (int e = 0; e < E; ++e) {
#pragma unroll
      for (int f = e + 1; f < E; ++f) {
        if ((e ^ f) == s) {
          const bool desc = ((lane + 32 * e) & size) == 0;
          const u64 a = v[e], b = v[f];
          v[e] = desc ? max64(a, b) : min64(a, b);
          v[f] = desc ? min64(a, b) : max64(a, b);
        }
      }
    }
  } else {
    const bool lower = (lane & stride) == 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const u64 o = __shfl_xor_sync(0xffffffffu, v[e], stride);
      const bool desc = ((lane + 32 * e) & size) == 0;
      v[e] = lower == desc ? max64(v[e], o) : min64(v[e], o);
    }
  }
}

// Sort the warp's 32 * E entries descending (a full bitonic sort).
template <int E>
__device__ __forceinline__ void warp_sort(u64 (&v)[E], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) warp_stage<E>(v, lane, size, stride);
  }
}

// Groups of g lanes (g a power of two <= 32) in each of N registers,
// each group sorted descending: the flip form of the bitonic network, in
// which every run is descending. A stage exchanges lane x with x ^ m,
// the pair member whose bit s is clear keeping the larger; the N
// registers go through each stage together, for the parallelism.
template <int N>
__device__ __forceinline__ void lane_stage(u64 (&v)[N], int lane, int m, int s) {
  const bool lower = (lane & s) == 0;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const u64 o = __shfl_xor_sync(0xffffffffu, v[e], m);
    v[e] = lower ? max64(v[e], o) : min64(v[e], o);
  }
}

// Sort each aligned group of g lanes descending.
template <int N>
__device__ __forceinline__ void sort_groups(u64 (&v)[N], int lane, int g) {
  for (int size = 2; size <= g; size <<= 1) {
    lane_stage<N>(v, lane, size - 1, size >> 1);  // the flip
    for (int s = size >> 2; s > 0; s >>= 1) lane_stage<N>(v, lane, s, s);
  }
}

// Merge each pair of adjacent sorted groups (2q, 2q + 1) of g lanes:
// afterwards the pair is sorted, group 2q holding its top g.
template <int N>
__device__ __forceinline__ void merge_pairs(u64 (&v)[N], int lane, int g) {
  lane_stage<N>(v, lane, 2 * g - 1, g);
  for (int s = g >> 1; s > 0; s >>= 1) lane_stage<N>(v, lane, s, s);
}

// After merge_pairs the even groups hold the tops: gather a's even
// groups and b's into one register (b's move up by g lanes) ...
__device__ __forceinline__ u64 pack_pairs(u64 a, u64 b, int lane, int g) {
  const u64 up = __shfl_sync(0xffffffffu, b, lane - g);
  return (lane & g) != 0 ? up : a;
}

// ... or move one register's even groups together (group q takes group
// 2q; the upper lanes are left with entries no one reads).
__device__ __forceinline__ u64 compact_pairs(u64 v, int lane, int g) {
  return __shfl_sync(0xffffffffu, v, lane + (lane & ~(g - 1)));
}

// Reduce a register of 32 / g sorted groups to its top g, in lanes
// [0, g), sorted descending.
__device__ __forceinline__ u64 top_of_groups(u64 v, int lane, int g) {
  u64 r[1] = {v};
  for (int n = 32 / g; n > 1; n >>= 1) {
    merge_pairs<1>(r, lane, g);
    if (n > 2) r[0] = compact_pairs(r[0], lane, g);
  }
  return r[0];
}

// best <- the top g of best and w (each sorted descending in lanes
// [0, g)), sorted descending in lanes [0, g): the half-cleaner against w
// reversed, then a bitonic merge of the group.
__device__ __forceinline__ u64 fold_group(u64 best, u64 w, int lane, int g) {
  u64 r[1] = {max64(best, __shfl_sync(0xffffffffu, w, g - 1 - lane))};
  for (int s = g >> 1; s > 0; s >>= 1) lane_stage<1>(r, lane, s, s);
  return r[0];
}

// best <- the top 32 * E of best and w, both sorted descending, sorted
// descending: best[x] = max(best[x], w[n-1-x]) keeps the top n of the
// two as a bitonic sequence (the half-cleaner), which a bitonic merge
// sorts (every run descending: size 64 * E). One register is
// fold_group's network on the whole warp.
template <int E>
__device__ __forceinline__ void warp_fold(u64 (&best)[E], const u64 (&w)[E], int lane) {
  if constexpr (E == 1) {
    best[0] = fold_group(best[0], w[0], lane, 32);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      best[e] = max64(best[e], __shfl_sync(0xffffffffu, w[E - 1 - e], 31 - lane));
#pragma unroll
    for (int stride = 16 * E; stride > 0; stride >>= 1) warp_stage<E>(best, lane, 64 * E, stride);
  }
}
